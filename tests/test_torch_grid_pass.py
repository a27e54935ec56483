"""The port's cell-major grid pass against the JAX package's, on the CPU.

float64. Each case of tests/_torch_grid_cases.py (a bucket with windows
that wrap the periodic edge, empty blocks, padded candidate lists, a NaN
row, -1e30 paint nodes, a 2D shear and a first block past 0) goes
through the port's ``halo_rows`` and ``grid_pass_diff`` and through the
JAX package's ``grid_offsets_pass``, ``grid_paint_pass``,
``grid_offsets_pass_2d`` and ``grid_paint_pass_2d``, which read the same
z-blended table (``table_z``) and build the rows inside. The planes agree
to 1e-11 of their largest |value|, and the VJP in ``table_z`` of a
seeded cotangent agrees with ``jax.vjp`` to 1e-10 of its largest
|value|. The JAX pass is differentiated with a static trip count
(``k_static``), as its ``process_device`` does.

The cases of larger blocks (B = 5 to 16) hold their premise, among it
(patch, slot) pairs that the kernels' cull may skip. The dispatch: CPU
tensors take the plain step loop (``_bucket_pass``) bit for bit, tensors of another device than the CPU or CUDA raise, and the
kernel entries (``ops.grid_pass_cuda``) refuse CPU tensors. The kernels
themselves are held against the step loop on the card in
tests/test_torch_cuda.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from baryonification_tpu.runners import grid_cellmajor as jgcm
from baryonification_tpu_torch.ops import grid_pass_cuda
from baryonification_tpu_torch.runners import grid_cellmajor as gcm

from _torch_grid_cases import (CASES, grid_case, patch_slots, port_bucket,
                               port_pass_args, port_rows)

torch.set_num_threads(1)

# (case, mode): every JAX pass, both offsets modes in 2D and 3D, a first
# block past 0 in each dimension, blocks of B = 8 in each dimension
JAX_CASES = [("3d", "offsets"), ("3d_block0", "offsets_rdelta"),
             ("3d", "paint"), ("2d", "offsets_rdelta"),
             ("2d_block0", "offsets"), ("2d", "paint"),
             ("3d_b8", "offsets"), ("2d_b8", "paint")]


def _cotangents(case, mode, seed=1):
    n = case["counts"].shape[0] * case["B"] ** case["dim"]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n)
            for _ in range(1 if mode == "paint" else case["dim"])]


@functools.lru_cache(maxsize=None)
def _jax_pass(name, mode):
    """(planes, VJP in table_z) of the JAX package's pass on the case."""
    c = grid_case(name, mode)
    dim, paint = c["dim"], mode == "paint"
    ncell = c["counts"].shape[0]
    f64 = lambda a: jnp.asarray(a, dtype=jnp.float64)
    zeros = [f64(np.zeros(ncell * c["B"] ** dim))]
    args = (c["B"], ncell, c["n_hi"], c["N"], c["half"],
            jnp.asarray(c["dense"].reshape(-1), dtype=jnp.int32),
            jnp.asarray(c["counts"], dtype=jnp.int32), f64(c["packed_abs"]),
            f64(c["gM"]))
    tail = (f64(c["lnr"]), c["eps_max"], c["L"], c["res"], c["bins0"])
    kw = dict(k_static=max(int(c["counts"].max()), 1), block0=c["block0"])
    if paint:
        fn = jgcm.grid_paint_pass if dim == 3 else jgcm.grid_paint_pass_2d
        f = lambda tz: (fn(*args, tz, *tail, zeros[0], **kw),)
    else:
        fn = jgcm.grid_offsets_pass if dim == 3 else \
            jgcm.grid_offsets_pass_2d
        f = lambda tz: fn(mode == "offsets_rdelta", *args, tz, *tail,
                          *(zeros * dim), **kw)
    out, vjp = jax.vjp(f, f64(c["table_z"]))
    (d_tz,) = vjp(tuple(f64(g) for g in _cotangents(c, mode)))
    return [np.asarray(o) for o in out], np.asarray(d_tz)


def _port_pass(name, mode):
    """(planes, VJP in table_z) of the port's halo_rows and grid_pass_diff
    on the case (CPU, float64)."""
    c = grid_case(name, mode)
    tz = torch.tensor(c["table_z"], requires_grad=True)
    head, tail = port_pass_args(c, mode, "cpu", torch.float64)
    out = gcm.grid_pass_diff(*head, port_rows(c, tz), *tail,
                             block0=c["block0"])
    cts = [torch.as_tensor(g) for g in _cotangents(c, mode)]
    (d_tz,) = torch.autograd.grad(out, tz, cts)
    return [o.detach().numpy() for o in out], d_tz.numpy()


def _rel(got, want):
    scale = max(np.abs(w).max() for w in want)
    assert scale > 0
    return max(np.abs(g - w).max() for g, w in zip(got, want)) / scale


@pytest.mark.parametrize("name,mode", JAX_CASES)
def test_pass_matches_jax(name, mode):
    got, _ = _port_pass(name, mode)
    want, _ = _jax_pass(name, mode)
    assert len(got) == len(want)
    assert all(np.isfinite(g).all() for g in got)
    assert _rel(got, want) < 1e-11, (name, mode)


@pytest.mark.parametrize("name,mode", JAX_CASES)
def test_vjp_matches_jax(name, mode):
    _, got = _port_pass(name, mode)
    _, want = _jax_pass(name, mode)
    assert np.isfinite(got).all()
    assert _rel([got], [want]) < 1e-10, (name, mode)


def test_cases_hold_their_premise():
    """Each case has empty blocks, padded lists, a NaN row, windows that
    wrap and slots that add; the paint table has -1e30 nodes."""
    for name in ("3d", "2d_block0"):
        for mode in ("offsets", "paint"):
            c = grid_case(name, mode)
            assert (c["counts"] == 0).any()
            assert c["dense"].shape[1] > c["counts"].max()
            rows = port_rows(c, torch.as_tensor(c["table_z"]))
            assert torch.isnan(rows).all(dim=1).sum() == 1
            assert torch.isfinite(rows).all(dim=1).sum() == rows.shape[0] - 1
            lo = c["packed"][:, c["dim"] + 3:2 * c["dim"] + 3] - c["half"]
            assert (lo < 0).any() and (lo + 2 * c["half"] > c["N"]).any()
            assert (c["table_z"] == -1e30).any() == (mode == "paint")
            census = dict(slots=0, inside=0, steps=0)
            head, tail = port_pass_args(c, mode, "cpu", torch.float64)
            gcm.grid_pass_diff(*head, rows, *tail, census=census,
                               block0=c["block0"])
            assert 0 < census["inside"] < census["slots"]


@pytest.mark.parametrize("name", list(CASES)[4:])
def test_block_cases_hold_their_premise(name):
    """The cases of larger blocks: empty blocks, padded lists, windows
    that wrap, slots that add and slots that do not in every mode, and
    listed (patch, slot) pairs of the kernels' warps where no voxel is
    live (what their cull may skip) beside pairs where one is."""
    for mode in ("offsets", "offsets_rdelta", "paint"):
        c = grid_case(name, mode)
        assert (c["counts"] == 0).any()
        assert c["dense"].shape[1] > c["counts"].max()
        lo = c["packed"][:, c["dim"] + 3:2 * c["dim"] + 3] - c["half"]
        assert (lo < 0).any()
        bk = port_bucket(c, mode, "cpu", torch.float64)
        assert bk.F > 16 and bk.ncell == (c["N"] // c["B"]) ** c["dim"]
        census = dict(slots=0, inside=0, steps=0)
        head, tail = port_pass_args(c, mode, "cpu", torch.float64)
        gcm.grid_pass_diff(*head, port_rows(c, torch.as_tensor(
            c["table_z"])), *tail, census=census, block0=c["block0"])
        assert 0 < census["inside"] < census["slots"]
        pairs, dead = patch_slots(bk)
        assert pairs == int(c["counts"].sum()) * -(-bk.F // 32)
        assert 0 < dead < pairs, (name, mode, dead, pairs)


@pytest.mark.parametrize("mode", ["offsets", "offsets_rdelta", "paint"])
@pytest.mark.parametrize("name", ["3d_block0", "2d"])
def test_cpu_dispatch_is_the_step_loop(name, mode):
    """On CPU tensors the pass is the plain step loop, bit for bit, and
    its backward the step loop's VJP, bit for bit."""
    c = grid_case(name, mode)
    bk = port_bucket(c, mode, "cpu", torch.float64)
    tz = torch.tensor(c["table_z"], requires_grad=True)
    rows = port_rows(c, tz)
    got = gcm._pass_diff(bk, rows)
    want = gcm._bucket_pass(bk, rows.detach(), gcm._zero_planes(bk, rows))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    cts = tuple(torch.as_tensor(g) for g in _cotangents(c, mode))
    (d_rows,) = torch.autograd.grad(got, rows, cts)
    with torch.no_grad():                # as in a first-order backward
        (want_d,) = gcm._bucket_vjp(bk, rows.detach(), cts)
    # bit for bit; the paint's NaN row gets NaN (0 * exp(NaN)) in both
    torch.testing.assert_close(d_rows, want_d, rtol=0, atol=0,
                               equal_nan=True)


def test_other_devices_raise():
    """A _GridBucket on a device that is neither the CPU nor CUDA raises;
    the kernel entries refuse CPU tensors (nothing runs in their
    place)."""
    c = grid_case("3d", "offsets")
    bk = port_bucket(c, "offsets", "meta", torch.float64)
    rows = torch.empty((c["packed"].shape[0], c["n_hi"]),
                       dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        gcm._pass_diff(bk, rows)
    bk = port_bucket(c, "offsets", "cpu", torch.float64)
    rows = port_rows(c, torch.as_tensor(c["table_z"]))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        grid_pass_cuda.grid_pass(*bk.kernel_args(rows), *bk.kernel_scalars())
    cts = tuple(torch.zeros(bk.ncell * bk.F, dtype=torch.float64)
                for _ in range(3))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        grid_pass_cuda.grid_vjp(*bk.kernel_args(rows), cts,
                                *bk.kernel_scalars())
    assert grid_pass_cuda.LAUNCHES == {"grid_pass": 0, "grid_vjp": 0}
