"""Parity of the port's model layer with the JAX package.

Cosmology, FFTLog, interpolation primitives, the Schneider19 profiles and
the displacement table, fed the same inputs in float64 on the CPU.

Tolerances: the algorithms are the same in float64; only the summation
order of cumulative sums, trapezoids and FFTs differs. Distances, R200c
and xi_mm agree to rtol 1e-10; the displacement table at the ``displ2d``
grid of test_runners.py agrees to 1e-8 of max|table|.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import baryonification_tpu as J
import baryonification_tpu_torch as T
from baryonification_tpu.ops import fftlog as JF, interp as JI
from baryonification_tpu_torch.ops import fftlog as TF, interp as TI

from test_profiles import PAR

torch.set_num_threads(1)

TABLE_GRID = dict(z_min=0.05, z_max=0.6, N_samples_z=4,
                  M_min=1e13, M_max=1e15, N_samples_Mass=6,
                  R_min=1e-3, R_max=70, N_samples_R=64)


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def cosmo_t():
    return T.Cosmology(Omega_m=0.3, Omega_b=0.05, h=0.7, sigma8=0.8,
                       n_s=0.96, device="cpu")


@pytest.fixture(scope="module")
def tables(cosmo, cosmo_t):
    mj = J.Baryonification2D(J.DarkMatterOnly(**PAR),
                             J.DarkMatterBaryon(**PAR), cosmo,
                             epsilon_max=20)
    mj.setup_interpolator(**TABLE_GRID)
    mt = T.Baryonification2D(T.DarkMatterOnly(**PAR),
                             T.DarkMatterBaryon(**PAR), cosmo_t,
                             epsilon_max=20)
    mt.setup_interpolator(**TABLE_GRID)
    return mj, mt


# ----- cosmology -----

def test_distances(cosmo, cosmo_t):
    a = np.linspace(0.25, 0.99, 9)
    for name in ("angular_diameter_distance", "comoving_radial_distance",
                 "growth_factor", "E"):
        want = np.asarray(getattr(cosmo, name)(a))
        got = getattr(cosmo_t, name)(_t(a)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-10, err_msg=name)


def test_r200c(cosmo, cosmo_t):
    M = np.geomspace(1e12, 1e16, 17)
    for a in (0.5, 0.8, 1.0):
        want = np.asarray(J.MassDef(200, "critical").get_radius(cosmo, M, a))
        got = T.MassDef(200, "critical").get_radius(cosmo_t, _t(M), a)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)


def test_xi_mm_and_sigma(cosmo, cosmo_t):
    r = np.geomspace(1e-2, 50, 60)
    np.testing.assert_allclose(cosmo_t.xi_mm(_t(r), 0.7).numpy(),
                               np.asarray(cosmo.xi_mm(r, 0.7)), rtol=1e-10)
    M = np.geomspace(1e10, 1e16, 20)
    np.testing.assert_allclose(cosmo_t.sigmaM(_t(M), 0.7).numpy(),
                               np.asarray(cosmo.sigmaM(M, 0.7)), rtol=1e-10)


def test_loggamma_and_hankel():
    rng = np.random.default_rng(0)
    z = rng.uniform(-3, 3, 200) + 1j * rng.uniform(-40, 40, 200)
    np.testing.assert_allclose(TF.loggamma(_t(z)).numpy(),
                               np.asarray(JF.loggamma(z)), rtol=1e-12,
                               atol=1e-12)
    r = np.geomspace(1e-3, 1e3, 256)
    f = np.exp(-r) * r**0.5
    kj, Fj = JF.fftlog_transform(r, f, 3, 0, plaw=-1.5)
    kt, Ft = TF.fftlog_transform(_t(r), _t(f), 3, 0, plaw=-1.5)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=1e-12)
    np.testing.assert_allclose(Ft.numpy(), np.asarray(Fj), rtol=0,
                               atol=1e-10 * np.abs(np.asarray(Fj)).max())


# ----- interpolation primitives -----

def test_pchip_and_masked_compact():
    rng = np.random.default_rng(1)
    x = np.sort(rng.uniform(0, 10, 40))
    y = np.cumsum(rng.uniform(-0.2, 1.0, (5, 40)), axis=-1)
    mask = rng.uniform(size=(5, 40)) > 0.3
    xq = rng.uniform(-1, 11, 50)
    dj = jax.vmap(lambda yy: JI.pchip_derivatives(jnp.asarray(x), yy))(y)
    dt_ = TI.pchip_derivatives(_t(x), _t(y))
    np.testing.assert_allclose(dt_.numpy(), np.asarray(dj), rtol=1e-12,
                               atol=1e-12)
    for deriv in (0, 1):
        ej = jax.vmap(lambda yy, dd: JI.pchip_eval(
            jnp.asarray(xq), jnp.asarray(x), yy, dd, deriv=deriv))(y, dj)
        et = TI.pchip_eval(_t(xq), _t(x), _t(y), dt_, deriv=deriv)
        np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-12,
                                   atol=1e-12)
    cj = jax.vmap(lambda yy, mm: JI.masked_compact(jnp.asarray(x), yy,
                                                   mm))(y, mask)
    ct = TI.masked_compact(_t(x), _t(y), _t(mask))
    for a, b in zip(ct, cj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_table_readout_primitives():
    rng = np.random.default_rng(2)
    grids = [np.linspace(0, 1, 4), np.linspace(30, 35, 6),
             np.linspace(-7, 4, 16)]
    table = rng.normal(size=(4, 6, 16))
    sc = [rng.uniform(-0.1, 1.1, 30), rng.uniform(29.5, 35.5, 30)]
    lnr = rng.uniform(-8, 5, (30, 20))
    pj = jax.vmap(lambda a, b: JI.blend_table_radial(
        [jnp.asarray(g) for g in grids], jnp.asarray(table), [a, b]))(*sc)
    pt = TI.blend_table_radial([_t(g) for g in grids], _t(table),
                               [_t(s) for s in sc])
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-12,
                               atol=1e-12)
    rj = jax.vmap(lambda p, l: JI.radial_readout(p, jnp.asarray(grids[2]),
                                                 l))(pj, lnr)
    rt = TI.radial_readout(pt, _t(grids[2]), _t(lnr))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-12,
                               atol=1e-12)
    coords = [rng.uniform(-0.1, 1.1, 25), rng.uniform(29.5, 35.5, 25),
              rng.uniform(-8, 5, 25)]
    nj = JI.ndlinear_interp([jnp.asarray(g) for g in grids],
                            jnp.asarray(table), coords)
    nt = TI.ndlinear_interp([_t(g) for g in grids], _t(table),
                            [_t(c) for c in coords])
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=1e-12,
                               atol=1e-12)


# ----- profiles -----

PROFILES = ["DarkMatter", "TwoHalo", "Stars", "Gas", "CollisionlessMatter",
            "DarkMatterOnly", "DarkMatterBaryon"]


@pytest.mark.parametrize("name", PROFILES)
def test_profiles_real(name, cosmo, cosmo_t):
    """Real-space profiles to 1e-10 of each halo's peak: the relaxed
    collisionless profile is a log-derivative that cancels to ~1e-10 of
    its peak at large r, where only a relative-to-peak bar is meaningful."""
    r = np.geomspace(1e-2, 100, 50)
    M = np.geomspace(1e12, 1e15, 5)
    want = np.asarray(getattr(J, name)(**PAR).real(cosmo, r, M, 0.7))
    got = getattr(T, name)(**PAR).real(cosmo_t, _t(r), _t(M), 0.7).numpy()
    scale = np.abs(want).max(axis=-1, keepdims=True)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-10)


def test_projected_profile(cosmo, cosmo_t):
    r = np.geomspace(1e-2, 50, 20)
    M = np.geomspace(1e13, 1e15, 2)
    want = np.asarray(J.DarkMatter(**PAR).projected(cosmo, r, M, 0.6))
    got = T.DarkMatter(**PAR).projected(cosmo_t, _t(r), _t(M), 0.6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)


def test_projected_fftlog(cosmo, cosmo_t):
    """The FFTLog projection (opt-in); the two FFT chains round apart at
    ~1e-10 of the peak where Sigma is small."""
    par = dict(PAR, cutoff=1000, use_fftlog_projection=True)
    r = np.geomspace(1e-2, 20, 20)
    M = np.geomspace(1e13, 1e15, 2)
    want = np.asarray(J.DarkMatter(**par).projected(cosmo, r, M, 0.6))
    got = T.DarkMatter(**par).projected(cosmo_t, _t(r), _t(M), 0.6).numpy()
    scale = np.abs(want).max(axis=-1, keepdims=True)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-9)


def test_profile_algebra(cosmo_t):
    """Operator algebra builds the same profile as the combiner class."""
    r, M = _t(np.geomspace(1e-2, 50, 30)), _t(np.geomspace(1e13, 1e15, 3))
    dm, two = T.DarkMatter(**PAR), T.TwoHalo(**PAR)
    want = T.DarkMatterOnly(**PAR).real(cosmo_t, r, M, 0.7)
    torch.testing.assert_close((dm + two).real(cosmo_t, r, M, 0.7), want,
                               rtol=1e-14, atol=0)
    torch.testing.assert_close((2 * dm - dm + two).real(cosmo_t, r, M, 0.7),
                               want, rtol=1e-13, atol=0)
    assert str(dm + two).startswith("add[DarkMatter, TwoHalo]")


def test_baryonification3d_masses(cosmo, cosmo_t):
    """Enclosed 3D masses (the Baryonification3D path) against JAX; the
    DMB profile takes the same path and is covered by the 2D table."""
    r = np.geomspace(1e-3, 50, 32)
    M = np.geomspace(1e13, 1e15, 2)
    mj = J.Baryonification3D(J.DarkMatterOnly(**PAR),
                             J.DarkMatterBaryon(**PAR), cosmo)
    mt = T.Baryonification3D(T.DarkMatterOnly(**PAR),
                             T.DarkMatterBaryon(**PAR), cosmo_t)
    for prof in ("DMO",):
        want = np.asarray(mj.get_masses(getattr(mj, prof), r,
                                        jnp.asarray(M), 0.8))
        got = mt.get_masses(getattr(mt, prof), r, _t(M), 0.8).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-10)


# ----- displacement -----

def test_displacement_table(tables):
    mj, mt = tables
    for gj, gt in zip(mj._grids, mt._grids):
        np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    want = np.asarray(mj._table)
    np.testing.assert_allclose(mt._table.numpy(), want, rtol=0,
                               atol=1e-8 * np.abs(want).max())
    assert np.abs(want).max() > 1e-3


def test_table_carried_across(tables, tmp_path):
    """save_table of either package loads in the other; readouts agree."""
    mj, mt = tables
    mj.save_table(tmp_path / "jax.npz")
    mt2 = T.Baryonification2D(T.DarkMatterOnly(**PAR),
                              T.DarkMatterBaryon(**PAR), mt.cosmo,
                              epsilon_max=20).load_table(tmp_path / "jax.npz")
    np.testing.assert_array_equal(mt2._table.numpy(), np.asarray(mj._table))
    mt.save_table(tmp_path / "torch.npz")
    mj2 = J.Baryonification2D(J.DarkMatterOnly(**PAR),
                              J.DarkMatterBaryon(**PAR), mj.cosmo,
                              epsilon_max=20).load_table(tmp_path /
                                                         "torch.npz")
    np.testing.assert_array_equal(np.asarray(mj2._table), mt._table.numpy())
    assert mj2.p_keys == mt.p_keys == []

    r = np.geomspace(1e-2, 30, 25)
    M = np.geomspace(2e13, 8e14, 4)
    want = np.asarray(mj.displacement(r, M, 0.8))
    got = mt2.displacement(_t(r), _t(M), 0.8).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
