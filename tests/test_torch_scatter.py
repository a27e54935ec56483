"""Parity of the port's scatter-add with the JAX package's.

The plain PyTorch version (``scatter_add_accum_reference``, what CPU
tensors take) is held against ``sorted_scatter_add_pallas`` in interpret
mode on the cases of ``tests/test_ops.py::TestPallasScatter``, and the
public ``scatter_add_accum`` against the JAX package's on unsorted rows
shaped like the shell runner's (float64, rtol 1e-12: the same rows summed
in another order). The hand-written CUDA kernel is held against the
plain version on the card in test_torch_cuda.py, which shares these
cases.

Tolerances: float32 sums taken in another order differ by rounding, so
rtol 1e-6 with an atol of 1e-6 for sums that cancel to ~0 (the bar of
test_ops.py); the heavy-duplicate and non-zero-accumulator cases sum
hundreds of rows per pixel and use test_ops.py's 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from baryonification_tpu.ops.scatter_pallas import (
    scatter_add_accum as jax_scatter_add_accum, sorted_scatter_add_pallas)
from baryonification_tpu_torch.ops import scatter_cuda as sc

from test_torch_cuda import (CASES, WINDOW_CASES, scatter_case as _case,
                             window_case)

torch.set_num_threads(1)


def _pallas(npix, idx, vals, base, br, tr):
    got = sorted_scatter_add_pallas(
        tuple(jnp.asarray(b) for b in base), jnp.asarray(idx),
        tuple(jnp.asarray(v) for v in vals), block_rows=br, tile_rows=tr,
        interpret=True)
    return [np.asarray(g) for g in got]


@pytest.mark.parametrize("name", CASES)
def test_reference_matches_pallas_interpret(name):
    npix, idx, vals, base, tol, br, tr = _case(name)
    want = _pallas(npix, idx, vals, base, br, tr)
    accs = tuple(torch.tensor(b) for b in base)
    out = sc.scatter_add_accum_reference(
        accs, torch.tensor(idx), tuple(torch.tensor(v) for v in vals))
    assert all(o is a for o, a in zip(out, accs))       # in place
    for g, w in zip(accs, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=max(tol, 1e-6),
                                   atol=tol)


@pytest.mark.parametrize("name", CASES)
def test_wrapper_on_cpu_unsorted_matches_pallas(name):
    """The public wrapper on CPU tensors, rows shuffled: the plain version
    runs, the kernel's launch count does not move."""
    npix, idx, vals, base, tol, br, tr = _case(name)
    want = _pallas(npix, idx, vals, base, br, tr)
    perm = np.random.default_rng(9).permutation(idx.size)
    before = sc.LAUNCHES["scatter_add"]
    accs = tuple(torch.tensor(b) for b in base)
    sc.scatter_add_accum(accs, torch.tensor(idx[perm]),
                         tuple(torch.tensor(v[perm]) for v in vals))
    assert sc.LAUNCHES["scatter_add"] == before
    for g, w in zip(accs, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=max(tol, 1e-6),
                                   atol=tol)


@pytest.mark.parametrize("name", WINDOW_CASES)
def test_unsorted_windows_match_jax(name):
    """What the kernel has to compute, pinned on the CPU: unsorted rows
    of window-shaped chunks (sentinels mixed in, 1..3 planes, int32 and
    int64 rows, every row on one pixel, no row) through the port's
    ``scatter_add_accum`` and the JAX package's, as the CPU runs it."""
    npix, idx, vals, base = window_case(name)
    want = jax_scatter_add_accum(tuple(jnp.asarray(b) for b in base),
                                 jnp.asarray(idx),
                                 tuple(jnp.asarray(v) for v in vals))
    before = dict(sc.LAUNCHES)
    accs = tuple(torch.tensor(b) for b in base)
    out = sc.scatter_add_accum(accs, torch.tensor(idx),
                               tuple(torch.tensor(v) for v in vals))
    assert all(o is a for o, a in zip(out, accs))       # in place
    assert sc.LAUNCHES == before                        # no launch on CPU
    assert accs[0].dtype == torch.float64
    for g, w, b in zip(accs, want, base):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12)
        if idx.size:
            assert not np.array_equal(g.numpy(), b)     # something landed


def test_int64_rows_beyond_int32_are_dropped():
    """Rows at or past Npix are dropped however large their int64 index."""
    accs = (torch.zeros(10, dtype=torch.float64),)
    idx = torch.tensor([1, 2**32 + 1, 3, 2**31, -2**31 + 10])
    sc.scatter_add_accum(accs, idx[:4],
                         (torch.ones(4, dtype=torch.float64),))
    assert accs[0].tolist() == [0, 1, 0, 1, 0, 0, 0, 0, 0, 0]
    assert sc._as_int32(idx, 10).tolist() == [1, 10, 3, 10, -2**31 + 10]


def test_float64_matches_xla_scatter():
    """float64 planes (the port's CPU precision) against XLA's scatter in
    float64; the sums agree to rounding."""
    rng = np.random.default_rng(5)
    npix = 200
    idx = rng.integers(0, npix + 50, 900)
    vals = [rng.normal(size=900) for _ in range(3)]
    ok = idx < npix
    want = [np.asarray(jnp.zeros(npix, jnp.float64)
                       .at[np.where(ok, idx, 0)].add(np.where(ok, v, 0.0)))
            for v in vals]
    accs = tuple(torch.zeros(npix, dtype=torch.float64) for _ in range(3))
    sc.scatter_add_accum(accs, torch.tensor(idx),
                         tuple(torch.tensor(v) for v in vals))
    for g, w in zip(accs, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("bad", ["dtype", "channels", "shape", "device"])
def test_wrapper_rejects_bad_inputs(bad):
    accs = (torch.zeros(16), torch.zeros(16))
    idx = torch.arange(8, dtype=torch.int32)
    vals = (torch.ones(8), torch.ones(8))
    if bad == "dtype":
        vals = (torch.ones(8, dtype=torch.float64),) * 2
    elif bad == "channels":
        vals = vals[:1]
    elif bad == "shape":
        vals = (torch.ones(9), torch.ones(9))
    elif bad == "device":
        vals = (torch.ones(8, device="meta"), torch.ones(8, device="meta"))
    with pytest.raises((TypeError, ValueError)):
        sc.scatter_add_accum(accs, idx, vals)
