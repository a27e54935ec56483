"""Gradients of the port's ``PaintProfilesAnisGrid`` against the JAX
package's.

tests/test_grad.py's ``TestAnisGradients`` inputs (``staged_anis``, :519:
the anis_setup scene of test_torch_anis.py, cell-major), float64 on the
CPU, the JAX tables carried across with ``from_arrays``:

- d(sum map)/ds against ``jax.grad`` to 1e-8 relative, for s scaling the
  remap's ln Paint rows (the range rows untouched), scaling the canvas
  map, and s = ln theta_ej through ``build_tables_device`` ->
  ``build_remap_device`` -> ``process_device``;
- d^2(sum map)/ds^2 in the canvas scale by double backward against
  ``jax.hessian`` to 1e-8 relative (the pass's backward kept under
  ``create_graph``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import baryonification_tpu as J
import baryonification_tpu_torch as T
from baryonification_tpu.runners import PaintProfilesAnisGrid as JAnis

from test_profiles import PAR
from test_torch_anis import COSMO, METHODS, TAB, _carry, _cpu_cosmo, _inputs

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64)


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.fixture(scope="module")
def staged(cosmo):
    jp = J.TabulatedProfile(J.Gas(**PAR), cosmo)
    jp.setup_interpolator(**TAB)
    jc = J.TabulatedProfile(J.DarkMatter(**PAR), cosmo)
    jc.setup_interpolator(**TAB)
    tc = _cpu_cosmo()
    tp = _carry(jp, T.TabulatedProfile(T.Gas(**PAR), tc))
    tcv = _carry(jc, T.TabulatedProfile(T.DarkMatter(**PAR), tc))
    jcat, jgm = _inputs(J)
    tcat, tgm = _inputs(T)
    kw = dict(epsilon_max=3, method=METHODS[0], verbose=False)
    return (JAnis(jcat, jgm, Painting_model=jp, Canvas_model=jc, **kw),
            T.PaintProfilesAnisGrid(tcat, tgm, Painting_model=tp,
                                    Canvas_model=tcv, device="cpu", **kw))


def _scaled_remap(remap, s):
    nq = remap.shape[1] - 2
    if isinstance(remap, torch.Tensor):
        return torch.cat([remap[:, :nq] * s, remap[:, nq:]], dim=1)
    return remap.at[:, :nq].mul(s)


def _port_grad(f, x0, order=1):
    x = torch.tensor(x0, **F64, requires_grad=True)
    (g,) = torch.autograd.grad(f(x), x, create_graph=order > 1)
    if order == 1:
        return float(g)
    (h,) = torch.autograd.grad(g, x)
    return float(h)


def test_grad_wrt_remap_scale_matches_jax(staged):
    jr, tr = staged
    jremap, tremap = jr.build_remap_device(), tr.build_remap_device()
    want = float(jax.grad(lambda s: jnp.sum(jr.process_device(
        remap=_scaled_remap(jremap, s))))(1.0))
    got = _port_grad(lambda s: tr.process_device(
        remap=_scaled_remap(tremap, s)).sum(), 1.0)
    assert np.isfinite(got) and got != 0
    assert _rel(got, want) < 1e-8


@pytest.mark.parametrize("order", [1, 2])
def test_derivative_wrt_canvas_scale_matches_jax(staged, order):
    jr, tr = staged
    c0 = np.asarray(tr.GriddedMap.map, dtype=np.float64)
    jf = lambda s: jnp.sum(jr.process_device(canvas=jnp.asarray(c0) * s))
    want = float((jax.grad if order == 1 else jax.hessian)(jf)(1.0))
    got = _port_grad(lambda s: tr.process_device(
        canvas=torch.as_tensor(c0) * s).sum(), 1.0, order)
    assert np.isfinite(got) and got != 0
    assert _rel(got, want) < 1e-8


def test_grad_wrt_theta_ej_through_remap_build_matches_jax(staged, cosmo):
    jr, tr = staged
    zr = np.geomspace(TAB['z_min'], TAB['z_max'], TAB['N_samples_z'])
    Mr = np.geomspace(TAB['M_min'], TAB['M_max'], TAB['N_samples_Mass'])
    r = np.geomspace(TAB['R_min'], TAB['R_max'], TAB['N_samples_R'])
    tc = _cpu_cosmo()

    def jf(ln_tej):
        m = J.TabulatedProfile(J.Gas(**dict(PAR, theta_ej=jnp.exp(ln_tej))),
                               cosmo)
        _, ln2 = m.build_tables_device(zr, Mr, r)
        return jnp.sum(jr.process_device(
            remap=jr.build_remap_device(paint_table=ln2)))

    def tf(ln_tej):
        m = T.TabulatedProfile(T.Gas(**dict(PAR, theta_ej=torch.exp(
            ln_tej))), tc)
        _, ln2 = m.build_tables_device(zr, Mr, r)
        return tr.process_device(
            remap=tr.build_remap_device(paint_table=ln2)).sum()

    x0 = float(np.log(4.0))
    want = float(jax.grad(jf)(x0))
    got = _port_grad(tf, x0)
    assert np.isfinite(got) and got != 0
    assert _rel(got, want) < 1e-8
