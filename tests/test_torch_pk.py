"""The port's dP(k) analysis layer against the JAX package.

float64 on the CPU, at examples/10's cosmology and parameters:

- ``Cosmology``: ``Omega_c``, ``cosmodict``, ``H``, ``P_lin``,
  ``Omega_m_a`` and ``P_nl`` (halofit), and ``halofit_pk`` called
  directly, to 1e-10 relative;
- ``sheth_tormen_dndlnM``, ``profile_uk`` (k below and above 2 / r_max,
  the two branches) and ``pk_suppression`` at one Fig. 2 sweep point with
  few masses, to 1e-8 relative;
- ``TabulatedCorrelation3D``: the table, its clamped readout, and a
  ``TwoHalo`` profile with it injected, to 1e-10 relative;
- a reduced mock box of examples/10's Part B (6 halos, L = 50 Mpc,
  n_grid 32): ``chip_smoke.box_crosscheck`` through the port (gather
  method, float64) against the example's own ``box_crosscheck`` through
  the JAX package, measured and predicted ratios to rtol 1e-8.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import baryonification_tpu as J
import baryonification_tpu_torch as T
from baryonification_tpu.analysis import (pk_suppression as j_pk,
                                          profile_uk as j_uk,
                                          sheth_tormen_dndlnM as j_st)
from baryonification_tpu.cosmology.power import halofit_pk as j_halofit
from baryonification_tpu_torch.cosmology.power import halofit_pk

import chip_smoke as cs

torch.set_num_threads(1)

_EX10 = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "10_delta_pk_snapshot.py")


@pytest.fixture(scope="module")
def ex10():
    spec = importlib.util.spec_from_file_location("ex10", _EX10)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fig2(ex10):
    """(JAX cosmology, port cosmology, sweep parameters, JAX gas class,
    port gas class) of examples/10."""
    cj, bpar, gas_j, h = ex10.s19_fig2_config()
    ct, bpar_t, gas_t, h_t = cs.s19_fig2_config(T, "cpu")
    assert h_t == h and bpar_t.keys() == bpar.keys()
    assert ct.cosmodict == cj.cosmodict
    return cj, ct, dict(ex10.fig2_sweeps(bpar, h))["Ep2"], gas_j, gas_t


def _rel(got, want):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return np.abs(got / want - 1).max()


def test_cosmology_power_matches_jax(fig2):
    cj, ct, *_ = fig2
    assert ct.Omega_c == pytest.approx(cj.Omega_c, rel=1e-15)
    k = np.geomspace(1e-3, 30, 40)
    for a in (1.0, 0.7):
        assert _rel(ct.H(a), cj.H(a)) < 1e-12
        assert _rel(ct.Omega_m_a(a), cj.Omega_m_a(a)) < 1e-12
        assert _rel(ct.P_lin(k, a), cj.P_lin(k, a)) < 1e-10
        assert _rel(ct.P_nl(k, a), cj.P_nl(k, a)) < 1e-10
    # halofit on its own: a linear spectrum at z = 0.5 on a coarser grid
    kg = np.geomspace(1e-4, 1e3, 600)
    pk = np.asarray(cj.P_lin(kg, 1 / 1.5))
    want = j_halofit(k, kg, pk, 0.6, 0.4, -0.9)
    got = halofit_pk(torch.tensor(k), torch.tensor(kg), torch.tensor(pk),
                     0.6, 0.4, -0.9)
    assert _rel(got, want) < 1e-10
    assert (got.numpy() > np.asarray(cj.P_lin(k, 1 / 1.5)))[-10:].all()


def test_mass_function_and_profile_uk_match_jax(fig2):
    cj, ct, par, gas_j, gas_t = fig2
    M = np.geomspace(1e11, 4e15, 15)
    for a in (1.0, 0.8):
        assert _rel(T.analysis.sheth_tormen_dndlnM(ct, M, a),
                    j_st(cj, M, a)) < 1e-10
    k = np.geomspace(0.005, 30, 25)       # 2 / r_max = 0.033: both branches
    assert (k * 60 < 2).any() and (k * 60 >= 2).any()
    Ms = np.array([3e12, 4e13, 2e15])
    got = T.analysis.profile_uk(T.DarkMatter(**par), ct, Ms, 1.0, k)
    assert got.shape == (3, 25)
    assert _rel(got, j_uk(J.DarkMatter(**par), cj, Ms, 1.0, k)) < 1e-8


def test_pk_suppression_matches_jax(fig2, ex10):
    """One Fig. 2 sweep point (eta = 0.2) with few masses: the DMB
    profile (gas, stars, the TwoHalo term taken off) through
    ``profile_uk`` and the mass integrals."""
    cj, ct, par, gas_j, gas_t = fig2
    k = ex10.load_scraped_fig2(0.6711)["Ep2"][0]
    kw = dict(M_cut=10**12.8, n_M_lo=4, n_M_hi=6)
    want = j_pk(J.DarkMatter(**par),
                J.DarkMatterBaryon(**par, gas=gas_j(**par))
                - J.TwoHalo(**par), cj, k, **kw)
    got = T.analysis.pk_suppression(
        T.DarkMatter(**par),
        T.DarkMatterBaryon(**par, gas=gas_t(**par)) - T.TwoHalo(**par), ct,
        k, **kw)
    assert got.shape == k.shape
    assert 1 - got.numpy().min() > 0.05          # a suppression
    assert _rel(got, want) < 1e-8


def test_tabulated_correlation_matches_jax(fig2):
    cj, ct, par, *_ = fig2
    xj = J.TabulatedCorrelation3D(cj, R_range=(1e-2, 300), N_samples=120)
    xt = T.TabulatedCorrelation3D(ct, R_range=(1e-2, 300), N_samples=120)
    for x in (xj, xt):
        x.setup_interpolator(z_min=0, z_max=2, N_samples_z=4)
    np.testing.assert_allclose(xt.raw_input_3D, xj.raw_input_3D, rtol=1e-10)
    # inside the table and clamped past both ends of r and of z
    r = np.geomspace(1e-4, 1e3, 50)
    for a in (1.0, 0.6, 0.2):
        np.testing.assert_allclose(xt(r, a).numpy(), np.asarray(xj(r, a)),
                                   rtol=1e-10, atol=1e-14)
    r2, M = np.geomspace(0.1, 50, 30), np.array([1e13, 1e14])
    want = J.TwoHalo(**par, xi_mm=xj).real(cj, r2, M, 0.8)
    got = T.TwoHalo(**par, xi_mm=xt).real(ct, r2, M, 0.8)
    assert _rel(got, want) < 1e-10


def test_box_crosscheck_matches_jax(ex10):
    """examples/10's Part B at a reduced size: the port's measured and
    predicted ratios against the JAX package's, rtol 1e-8."""
    kw = dict(n_halo=6, L=50.0, n_grid=32, n_bins=12, seed=7,
              table_samples=(6, 120))
    k_j, meas_j, pred_j = ex10.box_crosscheck(verbose=False, **kw)
    k_t, meas_t, pred_t = cs.box_crosscheck(T, "cpu", **kw)
    np.testing.assert_allclose(k_t, k_j, rtol=1e-12)
    assert np.abs(meas_j - 1).max() > 1e-3       # the box changed
    np.testing.assert_allclose(meas_t, meas_j, rtol=1e-8)
    np.testing.assert_allclose(pred_t, pred_j, rtol=1e-8)
