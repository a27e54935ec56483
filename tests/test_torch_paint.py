"""The port's shell painting and the C_ell slice against the JAX package.

- ``TabulatedProfile(DarkMatter)`` tables: finite log entries to rtol
  1e-10 (both tabulate the same profile in float64 with the same
  eager projection grid), and -inf (zero profile) at the same nodes.
- ``PaintProfilesShell(method="scatter")`` at NSIDE 32: the painted maps
  agree to rms/mean < 1e-10, the bar of test_torch_shell.py, also with
  -inf (zero profile) nodes put into both tables.
- The C_ell slice, example 09's recipe cut to NSIDE 32 / lmax 64, 200
  halos, one theta_ej and small tables, through both packages: paint a
  DMO shell, baryonify it, take the anafast ratio. Both spectra agree to
  rtol 1e-8 and dC_ell to 1e-8 of max|dC_ell| (relative agreement of
  dC_ell itself is ill-posed where it crosses zero at low ell).

float64 on the CPU throughout.
"""

import numpy as np
import pytest
import torch

import baryonification_tpu as J
import baryonification_tpu_torch as T
from baryonification_tpu.ops.spectra import anafast as j_anafast
from baryonification_tpu_torch.ops import scatter_cuda
from baryonification_tpu_torch.ops.spectra import anafast as t_anafast

torch.set_num_threads(1)

COSMO_DICT = dict(Omega_m=0.3, Omega_b=0.05, h=0.7, sigma8=0.8, n_s=0.96,
                  w0=-1.0)
# examples/09_delta_cls_shells.py
BASE_PAR = dict(epsilon=4.0, theta_co=0.1, M_c=1e14, mu_beta=0.1,
                gamma=2.5, delta=7, eta=0.3, eta_delta=0.1, tau=-1.5,
                tau_delta=0, A=0.055, M1=3e11, epsilon_h=0.015, a=0.3,
                n=2.0, p=0.3, q=0.707, cutoff=np.inf, proj_cutoff=1000)
PAINT_GRID = dict(z_min=0.05, z_max=1.0, N_samples_z=4, M_min=1e12,
                  M_max=1e16, N_samples_Mass=8, R_min=1e-3, R_max=1e2,
                  N_samples_R=60)
DISPL_GRID = dict(z_min=0.05, z_max=1.0, N_samples_z=3, M_min=1e12,
                  M_max=1e16, N_samples_Mass=6, R_min=1e-3, R_max=1e2,
                  N_samples_R=64)
NSIDE, LMAX, N_HALO, THETA_EJ = 32, 64, 200, 8.0


@pytest.fixture(scope="module")
def cosmo_t():
    return T.Cosmology.from_dict(COSMO_DICT, device="cpu")


@pytest.fixture(scope="module")
def halos():
    """Example 09's catalog recipe (seed 4), 200 halos."""
    rng = np.random.default_rng(4)
    return dict(ra=rng.uniform(0, 360, N_HALO),
                dec=np.degrees(np.arcsin(rng.uniform(-1, 1, N_HALO))),
                M=10 ** rng.uniform(13.2, 15.0, N_HALO),
                z=rng.uniform(0.1, 0.9, N_HALO))


@pytest.fixture(scope="module")
def tabs(cosmo, cosmo_t):
    par = dict(BASE_PAR, theta_ej=4.0)
    tj = J.TabulatedProfile(J.DarkMatter(**par), cosmo)
    tj.setup_interpolator(**PAINT_GRID, verbose=False)
    tt = T.TabulatedProfile(T.DarkMatter(**par), cosmo_t)
    tt.setup_interpolator(**PAINT_GRID, verbose=False)
    return tj, tt


def _paint(pkg, halos, tab, **kw):
    cat = pkg.HaloLightConeCatalog(cosmo=COSMO_DICT, **halos)
    floor = pkg.LightconeShell(map=np.full(12 * NSIDE**2, 1e10),
                               cosmo=COSMO_DICT)
    return pkg.PaintProfilesShell(cat, floor, epsilon_max=5, model=tab,
                                  verbose=False, method="scatter",
                                  **kw).process()


@pytest.fixture(scope="module")
def painted(halos, tabs):
    tj, tt = tabs
    return (np.asarray(_paint(J, halos, tj)),
            _paint(T, halos, tt, device="cpu"))


def test_tables_match_jax(tabs):
    tj, tt = tabs
    for g_t, g_j in zip(tt._grids, tj._grids):
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-15)
    for name in ("_ln3D", "_ln2D"):
        got, want = getattr(tt, name).numpy(), np.asarray(getattr(tj, name))
        assert got.shape == want.shape == (4, 8, 60)
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        fin = np.isfinite(want)
        assert fin.any()
        np.testing.assert_array_equal(np.isfinite(got), fin)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-10)


def test_table_readout_matches_jax(tabs, cosmo, cosmo_t):
    tj, tt = tabs
    r = np.geomspace(2e-3, 50, 13)
    M = np.array([3e12, 4e13, 7e14])
    for a in (0.6, 0.8):
        np.testing.assert_allclose(
            tt.projected(cosmo_t, r, M, a).numpy(),
            np.asarray(tj.projected(cosmo, r, M, a)), rtol=1e-10)
        np.testing.assert_allclose(
            tt.real(cosmo_t, r, 2e13, a).numpy(),
            np.asarray(tj.real(cosmo, r, 2e13, a)), rtol=1e-10)


def test_paint_matches_jax(painted):
    want, got = painted
    assert got.dtype == np.float64 and got.shape == (12 * NSIDE**2,)
    assert want.sum() > 0
    rms = np.sqrt(np.mean((got - want) ** 2)) / want.mean()
    assert rms < 1e-10


def test_paint_skips_zero_profile_nodes_like_jax(halos, tabs):
    """Zero profile nodes log to -inf; readouts that touch them paint
    nothing in both packages (the isfinite sanitising of the pass). The
    outer third of the radial grid is set to -inf in both tables."""
    import copy
    tj, tt = (copy.copy(t) for t in tabs)
    tj._ln2D = tj._ln2D.at[:, :, 40:].set(-np.inf)
    tt._ln2D = tt._ln2D.clone()
    tt._ln2D[:, :, 40:] = -np.inf
    want = np.asarray(_paint(J, halos, tj))
    got = _paint(T, halos, tt, device="cpu")
    full = _paint(T, halos, tabs[1], device="cpu")
    assert np.isfinite(got).all() and 0 < got.sum() < full.sum()
    rms = np.sqrt(np.mean((got - want) ** 2)) / want.mean()
    assert rms < 1e-10


def test_paint_stages_and_launches(halos, tabs):
    """CPU tensors take the plain scatter (no kernel launch); the profile
    records the paint stages."""
    cat = T.HaloLightConeCatalog(cosmo=COSMO_DICT, **halos)
    floor = T.LightconeShell(map=np.zeros(12 * 16**2), cosmo=COSMO_DICT)
    runner = T.PaintProfilesShell(cat, floor, epsilon_max=5, model=tabs[1],
                                  verbose=False, device="cpu")
    runner.profile = True
    before = scatter_cuda.LAUNCHES["scatter_add"]
    out = runner.process()
    assert np.isfinite(out).all() and out.sum() > 0
    assert scatter_cuda.LAUNCHES["scatter_add"] == before
    assert [k for k, _ in runner.stage_times] == ["halo_arrays", "pass",
                                                  "fetch_map"]


def test_paint_empty_catalog_and_p_keys(tabs):
    cat = T.HaloLightConeCatalog(ra=[], dec=[], M=[], z=[], cosmo=COSMO_DICT)
    floor = T.LightconeShell(map=np.ones(12 * 8**2), cosmo=COSMO_DICT)
    out = T.PaintProfilesShell(cat, floor, epsilon_max=5, model=tabs[1],
                               verbose=False, device="cpu").process()
    np.testing.assert_array_equal(out, np.zeros(12 * 8**2))

    class WithProps(T.TabulatedProfile):
        p_keys = ["cdelta"]

    with pytest.raises(AssertionError, match="ParamTabulatedProfile"):
        T.PaintProfilesShell(cat, floor, epsilon_max=5,
                             model=WithProps(None, None), verbose=False,
                             device="cpu").process()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.PaintProfilesShell(cat, floor, epsilon_max=5, model=tabs[1],
                             method="gather", device="cpu")


def _delta_cl(pkg, halos, painted_map, cosmo, spectrum, **kw):
    """Example 09 after the paint: baryonify the painted shell for one
    theta_ej and return (cl0, cl1)."""
    cat = pkg.HaloLightConeCatalog(cosmo=COSMO_DICT, **halos)
    shell = pkg.LightconeShell(map=painted_map + 1e10, cosmo=COSMO_DICT)
    par = dict(BASE_PAR, theta_ej=THETA_EJ)
    model = pkg.Baryonification2D(pkg.DarkMatterOnly(**par),
                                  pkg.DarkMatterBaryon(**par), cosmo,
                                  epsilon_max=20)
    model.setup_interpolator(**DISPL_GRID, verbose=False)
    new_map = pkg.BaryonifyShell(cat, shell, epsilon_max=20, model=model,
                                 verbose=False, **kw).process()
    return spectrum(shell.map), spectrum(new_map)


def test_delta_cls_slice_matches_jax(halos, painted, cosmo, cosmo_t):
    want_map, got_map = painted
    cl0_j, cl1_j = _delta_cl(
        J, halos, want_map, cosmo,
        lambda m: np.asarray(j_anafast(m, NSIDE, LMAX)))
    cl0_t, cl1_t = _delta_cl(
        T, halos, got_map, cosmo_t,
        lambda m: t_anafast(torch.tensor(m), NSIDE, LMAX).numpy(),
        device="cpu")
    np.testing.assert_allclose(cl0_t, cl0_j, rtol=1e-8)
    np.testing.assert_allclose(cl1_t, cl1_j, rtol=1e-8)
    d_j, d_t = cl1_j / cl0_j - 1, cl1_t / cl0_t - 1
    assert np.abs(d_j).max() > 1e-3          # the baryons did something
    np.testing.assert_allclose(d_t, d_j, rtol=0,
                               atol=1e-8 * np.abs(d_j).max())
