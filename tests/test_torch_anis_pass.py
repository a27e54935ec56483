"""The port's anisotropic (density-dependent) paint pass against the JAX
package's, on the CPU.

Each case of tests/_torch_anis_cases.py (a bucket with B = 4 and B = 8
on N = 32 and 64, a half-window wider than a block, windows that wrap the
periodic edge, a halo off the mass grid, canvas pixels at v <= 0 and
values outside the rows' ranges and beyond both ends of the canvas grid,
lists padded past their counts and empty lists, a -1e30 remap node, and a
range of blocks past block 0) goes through the port's ``halo_rows`` and
``grid_anis_paint_pass_2d`` and through the JAX package's
``grid_anis_paint_pass_2d``, which reads the same remap table
(``table_q``) and builds the rows inside. In float64 the plane and the VJP
of a seeded cotangent in ``table_q`` and in the canvas agree with the JAX
pass and ``jax.vjp`` to 1e-12 of their largest |value|, in float32 (the
JAX pass traced without x64) to 1e-5. The JAX pass is differentiated with
a static trip count (``k_static``), as its ``process_device`` does.

Where a slot's exp overflows (one halo's ln Paint at 1000), the port's
plane and gradients are those of the bucket without that halo: 0 where
the JAX pass's gradient is NaN.

The dispatch: CPU tensors take the plain step loop (``_bucket_pass``,
``_bucket_vjp``) bit for bit, tensors of another device than the CPU or
CUDA raise, and the kernel entries (``ops.anis_pass_cuda``) refuse CPU
tensors. The kernels themselves are held against the step loop on the
card in tests/test_torch_cuda.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from baryonification_tpu.runners import grid_cellmajor as jgcm
from baryonification_tpu.utils import x64_disabled
from baryonification_tpu_torch.ops import anis_pass_cuda
from baryonification_tpu_torch.runners import grid_cellmajor as gcm

from _torch_anis_cases import (CASES, DEAD, WIDE, anis_case,
                               overflow_buckets, port_bucket, port_pass_args,
                               port_rows)

torch.set_num_threads(1)

DTYPES = {"float64": (torch.float64, np.float64, 1e-12),
          "float32": (torch.float32, np.float32, 1e-5)}
C_BLK = 8           # the JAX pass's blocks a chunk (divides every case's)


def _cotangent(case, seed=1):
    return np.random.default_rng(seed).standard_normal(
        case["canvas"].shape[0])


@functools.lru_cache(maxsize=None)
def _jax_pass(name, dname):
    """(plane, VJP in table_q, VJP in the canvas) of the JAX package's
    pass on the case."""
    c = anis_case(name)
    np_dt = DTYPES[dname][1]
    arr = lambda a: jnp.asarray(np.asarray(a, dtype=np_dt))

    def run():
        f = lambda tq, cv: jgcm.grid_anis_paint_pass_2d(
            c["B"], C_BLK, c["n_hi"], c["N"],
            jnp.asarray(c["dense"].reshape(-1), dtype=jnp.int32),
            jnp.asarray(c["counts"], dtype=jnp.int32), arr(c["packed"]),
            arr(c["gM"]), tq, arr(c["lnq"]), c["eps_max"], np_dt(c["L"]),
            np_dt(c["res"]), np_dt(c["bins0"]), cv,
            arr(np.zeros_like(c["canvas"])), k_static=c["dense"].shape[1],
            block0=c["block0"])
        out, vjp = jax.vjp(f, arr(c["table_q"]), arr(c["canvas"]))
        d_tq, d_cv = vjp(arr(_cotangent(c)))
        return np.asarray(out), np.asarray(d_tq), np.asarray(d_cv)

    if dname == "float32":
        with x64_disabled():
            return run()
    return run()


def _port_pass(name, dname):
    """(plane, VJP in table_q, VJP in the canvas) of the port's halo_rows
    and grid_anis_paint_pass_2d on the case (CPU)."""
    c = anis_case(name)
    dt = DTYPES[dname][0]
    tq = torch.tensor(c["table_q"], dtype=dt, requires_grad=True)
    cv = torch.tensor(c["canvas"], dtype=dt, requires_grad=True)
    rows, live_h = port_rows(c, tq)
    head, (q0, dq, eps, res) = port_pass_args(c, "cpu", dt)
    if c["block0"]:     # one mesh rank's share: its bucket built directly
        bk = gcm._AnisBucket(*head, live_h, q0, dq, eps, res,
                             block0=c["block0"])
        (out,) = gcm._pass_diff(bk, rows, None, (cv,))
    else:
        (out,) = gcm.grid_anis_paint_pass_2d(*head, rows, live_h, q0, dq,
                                             eps, res, cv)
    ct = torch.as_tensor(_cotangent(c), dtype=dt)
    d_tq, d_cv = torch.autograd.grad(out, (tq, cv), ct)
    return out.detach().numpy(), d_tq.numpy(), d_cv.numpy()


def _rel(got, want):
    scale = np.abs(want).max()
    assert scale > 0
    return np.abs(got - want).max() / scale


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("name", list(CASES))
def test_pass_and_vjp_match_jax(name, dname):
    got = _port_pass(name, dname)
    want = _jax_pass(name, dname)
    bar = DTYPES[dname][2]
    for what, g, w in zip(("plane", "d_table_q", "d_canvas"), got, want):
        assert np.isfinite(g).all() and g.dtype == w.dtype == \
            DTYPES[dname][1], (name, dname, what)
        assert _rel(g, w) < bar, (name, dname, what, _rel(g, w))


@pytest.mark.parametrize("name", list(CASES))
def test_cases_hold_their_premise(name):
    """Each case has a half-window wider than B, windows that wrap, a halo
    without a row, empty and padded lists, pixels at v <= 0, and painted
    pixels whose ln v lies below and above the canvas grid (t clamped);
    the census counts a live halo's listed slot once a pixel."""
    c = anis_case(name)
    B, N, hh, cen = c["B"], c["N"], c["hh"], c["cen"]
    assert hh[WIDE] > B and (hh < N // 2).all()
    assert ((cen - hh[:, None] < 0) | (cen + hh[:, None] > N)).any()
    assert (c["counts"] == 0).any()
    assert c["dense"].shape[1] > c["counts"].max()
    assert (c["canvas"] <= 0).any()
    bk, rows, cv = port_bucket(c, "cpu", torch.float64)
    assert not bool(bk.live_h[DEAD]) and bool(bk.live_h.sum() == len(hh) - 1)
    listed = torch.as_tensor(c["dense"])[
        torch.arange(c["dense"].shape[1])[None, :]
        < torch.as_tensor(c["counts"])[:, None]]
    assert (listed == DEAD).any()
    census = dict(slots=0, inside=0, steps=0)
    (out,) = gcm._bucket_pass(bk, rows, gcm._zero_planes(bk, rows), census,
                              (cv,))
    assert census["slots"] == int(bk.live_h[listed].sum()) * B * B
    assert 0 < census["inside"] < census["slots"]
    lnv = np.log(np.where(cv.numpy() > 0, cv.numpy(), 1.0))
    painted = out.numpy() > 0
    q = c["lnq"]
    assert (painted & (cv.numpy() > 0) & (lnv < q[0])).any()
    assert (painted & (lnv > q[-1])).any()
    assert (~painted & (cv.numpy() > 0) & (lnv > q[0])
            & (lnv < q[-1])).any()


@pytest.mark.parametrize("name", ["b4", "b4_mesh"])
def test_cpu_dispatch_is_the_step_loop(name):
    """On CPU tensors the pass is the plain step loop, bit for bit, and
    its backward the step loop's VJP in the rows and the canvas, bit for
    bit; the kernels' int32 copies are made only for a kernel."""
    c = anis_case(name)
    bk, rows, cv = port_bucket(c, "cpu", torch.float64)
    assert bk._int32 is None
    r = rows.clone().requires_grad_(True)
    v = cv.clone().requires_grad_(True)
    (got,) = gcm._pass_diff(bk, r, None, (v,))
    (want,) = gcm._bucket_pass(bk, rows, gcm._zero_planes(bk, rows),
                               extra=(cv,))
    assert torch.equal(got, want)
    ct = torch.as_tensor(_cotangent(c))
    d_r, d_v = torch.autograd.grad(got, (r, v), ct)
    with torch.no_grad():                # as in a first-order backward
        want_r, want_v = gcm._bucket_vjp(bk, rows, (ct,), (cv,))
    torch.testing.assert_close(d_r, want_r, rtol=0, atol=0)
    torch.testing.assert_close(d_v, want_v, rtol=0, atol=0)
    assert bk._int32 is None


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("name", ["b4", "b8"])
def test_overflowing_paint_is_skipped(name, dname):
    """A slot whose exp(lerp) overflows paints nothing and takes no
    gradient, as the kernels do: with one halo's ln Paint at 1000 the
    plane and the gradients in the rows and the canvas are those of the
    bucket with that halo off the mass grid, which it would have painted
    into."""
    c, dt = anis_case(name), DTYPES[dname][0]
    bk, ref, rows, cv = overflow_buckets(c, "cpu", dt)
    plain = port_bucket(c, "cpu", dt)[1]
    (was,) = gcm._pass_diff(bk, plain, None, (cv,))
    (dead,) = gcm._pass_diff(ref, rows, None, (cv,))
    assert not torch.equal(was, dead)
    ct = torch.as_tensor(_cotangent(c), dtype=dt)
    got, want = [], []
    for b, out in ((bk, got), (ref, want)):
        r = rows.clone().requires_grad_(True)
        v = cv.clone().requires_grad_(True)
        (plane,) = gcm._pass_diff(b, r, None, (v,))
        out.extend((plane.detach(),
                    *torch.autograd.grad(plane, (r, v), ct)))
    for what, g, w in zip(("plane", "d_rows", "d_canvas"), got, want):
        assert bool(torch.isfinite(g).all()), (what, name, dname)
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_other_devices_raise():
    """An _AnisBucket on a device that is neither the CPU nor CUDA raises;
    the kernel entries refuse CPU tensors (nothing runs in their
    place)."""
    c = anis_case("b4")
    bk, rows, cv = port_bucket(c, "cpu", torch.float64)
    meta = port_bucket(c, "meta", torch.float64)[0]
    launches = dict(anis_pass_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="cpu or cuda"):
        gcm._pass_diff(meta, rows.to("meta"), None, (cv.to("meta"),))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        bk.kernel_pass(rows, extra=(cv,))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        bk.kernel_vjp(rows, (torch.zeros_like(cv),), (cv,))
    assert anis_pass_cuda.LAUNCHES == launches
