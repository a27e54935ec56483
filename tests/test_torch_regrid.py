"""The port's shell regrid on the CPU against the JAX package's.

The cases of tests/_torch_regrid_cases.py (NSIDE 16 and 64, NESTED and
RING input orders, offsets of a few tenths of a pixel and of a few
pixels, the poles, z / r at the bounds of its clamp, phi at 0 and 2 pi,
a mesh slice, no pixel, a pile-up; NSIDE 8192's caps and equator only
through their ids and weights, its maps having 805M pixels), float64:

- ``regrid_shell_reference`` (and the CPU dispatch of ``regrid_shell``,
  bit for bit the same) against the JAX ``_regrid_shell``
  (``baryonification_tpu/runners/shell.py:756``) to 1e-12 of max|map|,
  the mass conserved to 1e-12;
- the closed-form adjoint ``regrid_vjp_reference`` against
  ``torch.autograd`` of the plain forward and against ``jax.vjp`` of the
  JAX function, in the offsets and the map, to 1e-10 of the largest
  gradient;
- a double backward through the autograd Function (whose backward is
  the closed form as torch ops under ``create_graph``) against autograd's
  double backward of the plain forward;
- the check entry's CPU version (ids and weights) against the JAX
  ``get_interp_weights_parts``, and the dispatch's refusals.
"""

import jax
import numpy as np
import pytest
import torch

from baryonification_tpu.runners import shell as jshell
from baryonification_tpu_torch.ops import regrid_cuda as rc
from baryonification_tpu_torch.runners import shell as tshell

from _torch_regrid_cases import CASES, LARGE_CASES, as_torch, regrid_case

torch.set_num_threads(1)

MAP_CASES = [c for c in CASES if c not in LARGE_CASES]
GRAD_CASES = [c for c in MAP_CASES if c != "empty"]


def assert_close(got, want, tol, scale):
    """NaN where ``want`` is NaN (on_axis: acos' infinite times a zero
    weight derivative), elsewhere within tol * scale."""
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    err = np.abs(got[ok] - want[ok]).max() if ok.any() else 0.0
    assert err <= tol * scale, (err, scale)


def jax_regrid(case):
    nside, vx, vy, vz, m, off = case
    return np.asarray(jshell._regrid_shell(nside, None, vx, vy, vz, m, off))


@pytest.mark.parametrize("name", MAP_CASES)
def test_forward_matches_jax(name):
    case = regrid_case(name)
    got = rc.regrid_shell_reference(*as_torch(case)).numpy()
    want = jax_regrid(case)
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= 1e-12 * scale
    m = case[4]
    assert abs(got.sum() - m.sum()) <= 1e-12 * max(m.sum(), 1.0)
    # the runner's stage C is the dispatch, bit for bit the plain version
    # on the CPU, deterministic algorithms or not
    t = as_torch(case)
    assert torch.equal(tshell._regrid_shell(*t), torch.as_tensor(got))
    torch.use_deterministic_algorithms(True)
    try:
        assert torch.equal(rc.regrid_shell(*t), torch.as_tensor(got))
    finally:
        torch.use_deterministic_algorithms(False)


def _cotangent(case, seed=1):
    nside = case[0]
    return np.random.default_rng(seed).normal(size=12 * nside * nside)


@pytest.mark.parametrize("name", GRAD_CASES)
def test_vjp_matches_autograd_and_jax(name):
    case = regrid_case(name)
    nside, vx, vy, vz, m, off = as_torch(case)
    ct = torch.as_tensor(_cotangent(case))
    (d_o, d_m) = rc.regrid_vjp_reference(nside, vx, vy, vz, m, off, ct)
    got = list(d_o) + [d_m]

    leaves = [o.clone().requires_grad_() for o in off] + [
        m.clone().requires_grad_()]
    out = rc.regrid_shell_reference(nside, vx, vy, vz, leaves[3],
                                    tuple(leaves[:3]))
    auto = torch.autograd.grad(out, leaves, ct)

    _, vjp = jax.vjp(lambda ox, oy, oz, mm: jshell._regrid_shell(
        nside, None, case[1], case[2], case[3], mm, (ox, oy, oz)),
        *case[5], case[4])
    jx = vjp(_cotangent(case))
    for want_all in ([a.numpy() for a in auto], [np.asarray(a) for a in jx]):
        scale = np.nanmax(np.abs(np.concatenate(want_all)))
        for g, w in zip(got, want_all):
            assert_close(g.numpy(), w, 1e-10, scale)


@pytest.mark.parametrize("name", ["n16_ring_large", "poles", "mesh_slice"])
def test_double_backward_through_the_function(name):
    """Reverse over reverse through the autograd Function (backward: the
    closed form under create_graph) against autograd's of the plain
    forward, in the offsets and the map."""
    case = regrid_case(name)
    nside, vx, vy, vz, m, off = as_torch(case)
    rng = np.random.default_rng(2)
    w = torch.as_tensor(rng.normal(size=12 * nside * nside))
    u = [torch.as_tensor(rng.normal(size=m.shape[0])) for _ in range(4)]

    def hvp(fn):
        leaves = [o.clone().requires_grad_() for o in off] + [
            m.clone().requires_grad_()]
        out = fn(nside, vx, vy, vz, leaves[3], tuple(leaves[:3]))
        g = torch.autograd.grad((out ** 2 * w).sum(), leaves,
                                create_graph=True)
        return torch.autograd.grad(sum((gi * ui).sum()
                                       for gi, ui in zip(g, u)), leaves)

    got, want = hvp(rc.regrid_shell), hvp(rc.regrid_shell_reference)
    scale = max(float(x.abs().max()) for x in want)
    for g, x in zip(got, want):
        assert_close(g.numpy(), x.numpy(), 1e-10, scale)


def test_function_first_order_on_cpu():
    """The Function's forward is the plain version bit for bit and its
    backward the closed form (unit vectors get the offsets' gradient)."""
    case = regrid_case("n16_nested_small")
    nside, vx, vy, vz, m, off = as_torch(case)
    ct = torch.as_tensor(_cotangent(case))
    leaves = [v.clone().requires_grad_() for v in (vx, vy, vz)] + [
        m.clone().requires_grad_()] + [o.clone().requires_grad_()
                                       for o in off]
    out = rc.regrid_shell(nside, *leaves[:4], tuple(leaves[4:]))
    assert torch.equal(out.detach(),
                       rc.regrid_shell_reference(nside, vx, vy, vz, m, off))
    g = torch.autograd.grad(out, leaves, ct)
    (d_o, d_m) = rc.regrid_vjp_reference(nside, vx, vy, vz, m, off, ct)
    for a, b in zip(g, list(d_o) + [d_m] + list(d_o)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["n64_ring_small", "poles", "phi_wrap",
                                  "n8192_caps"])
def test_parts_match_jax(name):
    """The check entry's plain version: ids exactly and weights to 1e-13
    against the JAX get_interp_weights_parts of the same angles (at NSIDE
    8192 the last ids, up to 805,306,367)."""
    from baryonification_tpu.ops import healpix as jh
    case = as_torch(regrid_case(name))
    nside, vx, vy, vz, m, off = case
    ids, w = rc._regrid_parts(nside, vx, vy, vz, off)
    x, y, z = (v + o for v, o in zip((vx, vy, vz), off))
    r = torch.sqrt(x * x + y * y + z * z)
    theta = torch.arccos(torch.clamp(z / r, -1, 1))
    phi = torch.atan2(y, x)
    phi = torch.where(phi < 0, phi + 2 * np.pi, phi)
    ps, ws = jh.get_interp_weights_parts(nside, theta.numpy(), phi.numpy())
    assert np.array_equal(ids.numpy(), np.stack([np.asarray(p) for p in ps]))
    assert np.abs(w.numpy() - np.stack([np.asarray(q) for q in ws])
                  ).max() <= 1e-13


def test_dispatch_refuses_other_devices():
    case = as_torch(regrid_case("n16_nested_small"), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        rc.regrid_shell(*case)
    with pytest.raises(ValueError, match="cpu or cuda"):
        rc.regrid_vjp(*case, torch.zeros(12 * 16 * 16, device="meta"))
