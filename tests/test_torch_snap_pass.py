"""The port's cell-major snapshot pass against the JAX package's, on the
CPU.

Each case of tests/_torch_snap_cases.py (a bucket with P of 5, 42 and
70 slots a cell, empty cells, reaches that wrap the periodic box, lists
padded past their counts and empty lists, a NaN row, Rdelta sampling
and a range of cells past cell 0) goes through the port's ``halo_rows``
and ``snapshot_pass_diff`` and through the JAX package's
``snapshot_offsets_pass``, which reads the same z-blended table
(``table_z``) and builds the rows inside. In float64 the planes and the
VJP in ``table_z`` of a seeded cotangent agree with the JAX pass and
``jax.vjp`` to 1e-12 of their largest |value|, in float32 (the JAX pass
traced without x64) to 1e-5. The JAX pass is differentiated with a
static trip count (``k_static``), as its ``process_device`` does.

The dispatch: CPU tensors take the plain step loop (``_bucket_pass``,
``_bucket_vjp``) bit for bit, tensors of another device than the CPU or
CUDA raise, and the kernel entries (``ops.snap_pass_cuda``) refuse CPU
tensors. The kernels themselves are held against the step loop on the
card in tests/test_torch_cuda.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from baryonification_tpu.runners import snapshot_cellmajor as jscm
from baryonification_tpu.utils import x64_disabled
from baryonification_tpu_torch.ops import snap_pass_cuda
from baryonification_tpu_torch.runners import grid_cellmajor as gcm
from baryonification_tpu_torch.runners import snapshot_cellmajor as scm

from _torch_snap_cases import (CASES, L_BOX, port_bucket, port_pass_args,
                               port_rows, snap_case)

torch.set_num_threads(1)

DTYPES = {"float64": (torch.float64, np.float64, 1e-12),
          "float32": (torch.float32, np.float32, 1e-5)}


def _cotangents(case, seed=1):
    n = case["counts_p"].shape[0] * case["P"]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n) for _ in range(3)]


@functools.lru_cache(maxsize=None)
def _jax_pass(name, dname):
    """(planes, VJP in table_z) of the JAX package's pass on the case."""
    c = snap_case(name)
    np_dt = DTYPES[dname][1]
    ncell = c["counts_p"].shape[0]
    arr = lambda a: jnp.asarray(np.asarray(a, dtype=np_dt))
    zeros = arr(np.zeros(ncell * c["P"]))

    def run():
        f = lambda tz: jscm.snapshot_offsets_pass(
            c["rdelta"], c["P"], ncell, c["n_hi"],
            jnp.asarray(c["dense"].reshape(-1)), jnp.asarray(c["counts_h"]),
            *(arr(p) for p in c["planes"]), jnp.asarray(c["counts_p"]),
            arr(c["packed"]), arr(c["gM"]), tz, arr(c["lnr"]),
            c["eps_max"], np_dt(c["a_scale"]), np_dt(c["L"]), zeros, zeros,
            zeros, k_static=c["dense"].shape[1])
        out, vjp = jax.vjp(f, arr(c["table_z"]))
        (d_tz,) = vjp(tuple(arr(g) for g in _cotangents(c)))
        return [np.asarray(o) for o in out], np.asarray(d_tz)

    if dname == "float32":
        with x64_disabled():
            return run()
    return run()


def _port_pass(name, dname):
    """(planes, VJP in table_z) of the port's halo_rows and
    snapshot_pass_diff on the case (CPU)."""
    c = snap_case(name)
    dt = DTYPES[dname][0]
    tz = torch.tensor(c["table_z"], dtype=dt, requires_grad=True)
    head, tail = port_pass_args(c, "cpu", dt)
    out = scm.snapshot_pass_diff(*head, port_rows(c, tz), *tail)
    cts = [torch.as_tensor(g, dtype=dt) for g in _cotangents(c)]
    (d_tz,) = torch.autograd.grad(out, tz, cts)
    return [o.detach().numpy() for o in out], d_tz.numpy()


def _rel(got, want):
    scale = max(np.abs(w).max() for w in want)
    assert scale > 0
    return max(np.abs(g - w).max() for g, w in zip(got, want)) / scale


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("name", list(CASES))
def test_pass_and_vjp_match_jax(name, dname):
    got, d_got = _port_pass(name, dname)
    want, d_want = _jax_pass(name, dname)
    bar = DTYPES[dname][2]
    assert all(np.isfinite(g).all() for g in got) and np.isfinite(d_got).all()
    assert all(g.dtype == w.dtype == DTYPES[dname][1]
               for g, w in zip(got, want))
    assert _rel(got, want) < bar, (name, dname, _rel(got, want))
    assert _rel([d_got], [d_want]) < bar, (name, dname,
                                           _rel([d_got], [d_want]))


@pytest.mark.parametrize("name", list(CASES))
def test_cases_hold_their_premise(name):
    """Each case has empty cells and full ones, padded lists and empty
    lists, a NaN row, reaches that wrap the box, slots that add and pairs
    that do not; the census counts the real slots' listed pairs."""
    c = snap_case(name)
    P = c["P"]
    assert (c["counts_p"] == 0).any() and (c["counts_p"] == P).any()
    assert (c["counts_h"] == 0).any()
    assert c["dense"].shape[1] > c["counts_h"].max()
    pos, reach = c["packed"][:, :3], c["eps_max"] * c["packed"][:, 3]
    assert ((pos - reach[:, None] < 0) | (pos + reach[:, None] > L_BOX)).any()
    rows = port_rows(c, torch.as_tensor(c["table_z"]))
    assert torch.isnan(rows).all(dim=1).sum() == 1
    census = dict(pairs=0, inside=0, steps=0)
    head, tail = port_pass_args(c, "cpu", torch.float64)
    scm.snapshot_pass_diff(*head, rows, *tail, census=census)
    assert census["pairs"] == int((c["counts_p"].astype(np.int64)
                                   * c["counts_h"]).sum())
    assert 0 < census["inside"] < census["pairs"]


@pytest.mark.parametrize("name", ["p5", "p42_rdelta_mesh"])
def test_cpu_dispatch_is_the_step_loop(name):
    """On CPU tensors the pass is the plain step loop, bit for bit, and
    its backward the step loop's VJP, bit for bit; the bucket keeps the
    registration's int32 candidates."""
    c = snap_case(name)
    bk = port_bucket(c, "cpu", torch.float64)
    assert bk.dense2.dtype == bk.counts_h.dtype == torch.int32
    tz = torch.tensor(c["table_z"], requires_grad=True)
    rows = port_rows(c, tz)
    got = gcm._pass_diff(bk, rows)
    want = gcm._bucket_pass(bk, rows.detach(), gcm._zero_planes(bk, rows))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    cts = tuple(torch.as_tensor(g) for g in _cotangents(c))
    (d_rows,) = torch.autograd.grad(got, rows, cts)
    with torch.no_grad():                # as in a first-order backward
        (want_d,) = gcm._bucket_vjp(bk, rows.detach(), cts)
    torch.testing.assert_close(d_rows, want_d, rtol=0, atol=0)


def test_other_devices_raise():
    """A _SnapBucket on a device that is neither the CPU nor CUDA raises;
    the kernel entries refuse CPU tensors (nothing runs in their
    place)."""
    c = snap_case("p5")
    bk = port_bucket(c, "meta", torch.float64)
    rows = torch.empty((c["packed"].shape[0], c["n_hi"]),
                       dtype=torch.float64, device="meta")
    launches = dict(snap_pass_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="cpu or cuda"):
        gcm._pass_diff(bk, rows)
    bk = port_bucket(c, "cpu", torch.float64)
    rows = port_rows(c, torch.as_tensor(c["table_z"]))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        bk.kernel_pass(rows)
    cts = tuple(torch.zeros(bk.ncell * bk.P, dtype=torch.float64)
                for _ in range(3))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        bk.kernel_vjp(rows, cts)
    assert snap_pass_cuda.LAUNCHES == launches
