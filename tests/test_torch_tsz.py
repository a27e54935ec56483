"""The port's pixel-convolved tSZ table and its paint against the JAX
package.

examples/05's model, ``TabulatedProfile(ConvolvedProfile(ThermalSZ,
HealPixel(64)))``, on a small grid, built by both packages in float64 on
the CPU, then painted by ``PaintProfilesShell`` with both methods, with
the port's table and with the JAX table carried across by
``from_arrays``. Tolerances: the table to 1e-8 of max|value| (its
entries are quadratures and an FFTLog round trip), with the same
non-finite entries (the 3D table is the log of the -99 sentinel's
convolution); painted maps to rms/mean < 1e-10, the bar of the earlier
paint tests.
"""

import numpy as np
import pytest
import torch

import baryonification_tpu as J
import baryonification_tpu_torch as T

from test_torch_thermo import COSMO_DICT, PAR, NSIDE, close_of_max

torch.set_num_threads(1)

TSZ_GRID = dict(z_min=0.05, z_max=1.0, N_samples_z=2, M_min=1e12,
                M_max=1e16, N_samples_Mass=4, R_min=1e-3, R_max=1e2,
                N_samples_R=40)


@pytest.fixture(scope="module")
def cosmo_t():
    return T.Cosmology.from_dict(COSMO_DICT, device="cpu")


def _tsz(pkg, cosmo):
    return pkg.TabulatedProfile(
        pkg.ConvolvedProfile(pkg.ThermalSZ(**PAR), pkg.HealPixel(NSIDE)),
        cosmo)


@pytest.fixture(scope="module")
def tsz_tabs(cosmo, cosmo_t):
    """examples/05's pixel-convolved tSZ table at NSIDE 64, a small grid,
    built by both packages."""
    tj, tt = _tsz(J, cosmo), _tsz(T, cosmo_t)
    tj.setup_interpolator(**TSZ_GRID, verbose=False)
    tt.setup_interpolator(**TSZ_GRID, verbose=False)
    return tj, tt


def test_tsz_table(tsz_tabs):
    tj, tt = tsz_tabs
    for g_t, g_j in zip(tt._grids, tj._grids):
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-15)
    # the 3D table carries the sentinel's log: not finite anywhere
    got3, want3 = tt._ln3D.numpy(), np.asarray(tj._ln3D)
    assert got3.shape == want3.shape == (2, 4, 40)
    assert not np.isfinite(want3).any()
    np.testing.assert_array_equal(got3, want3)
    close_of_max(np.exp(tt._ln2D.numpy()), np.exp(np.asarray(tj._ln2D)))


N_HALO = 300


@pytest.fixture(scope="module")
def catalog():
    """examples/05's catalog recipe (seed 2), 300 halos."""
    rng = np.random.default_rng(2)
    return dict(ra=rng.uniform(0, 360, N_HALO),
                dec=np.degrees(np.arcsin(rng.uniform(-1, 1, N_HALO))),
                M=10 ** rng.uniform(13.5, 15.0, N_HALO),
                z=rng.uniform(0.1, 0.9, N_HALO))


def _paint(pkg, halos, tab, runner="PaintProfilesShell", **kw):
    cat = pkg.HaloLightConeCatalog(cosmo=COSMO_DICT, **halos)
    shell = pkg.LightconeShell(map=np.zeros(12 * NSIDE**2),
                               cosmo=COSMO_DICT)
    return np.asarray(getattr(pkg, runner)(cat, shell, epsilon_max=5,
                                           model=tab, verbose=False,
                                           **kw).process())


def _rms(got, want):
    assert np.isfinite(got).all() and want.sum() > 0
    return np.sqrt(np.mean((got - want) ** 2)) / want.mean()


@pytest.mark.parametrize("table", ["port-built", "jax-built"])
@pytest.mark.parametrize("method", ["scatter", "cellmajor"])
def test_tsz_paint(method, table, tsz_tabs, catalog, cosmo_t):
    """The y map of both methods against the JAX paint of the same
    method, with the port's own table and with the JAX table carried
    across by ``from_arrays``."""
    tj, tt = tsz_tabs
    if table == "jax-built":
        tt = _tsz(T, cosmo_t).from_arrays(
            [np.asarray(g) for g in tj._grids], np.asarray(tj._ln3D),
            np.asarray(tj._ln2D))
    want = _paint(J, catalog, tj, method=method)
    got = _paint(T, catalog, tt, method=method, device="cpu")
    assert got.min() >= 0 and (got > 0).sum() > 50
    assert _rms(got, want) < 1e-10


def test_paint_anis_shell_is_the_paint(tsz_tabs, catalog):
    """PaintProfilesAnisShell is an alias: the same map as
    PaintProfilesShell and as the JAX package's alias."""
    tj, tt = tsz_tabs
    assert issubclass(T.PaintProfilesAnisShell, T.PaintProfilesShell)
    got = _paint(T, catalog, tt, "PaintProfilesAnisShell", device="cpu")
    np.testing.assert_array_equal(got, _paint(T, catalog, tt, device="cpu"))
    want = _paint(J, catalog, tj, "PaintProfilesAnisShell")
    assert _rms(got, want) < 1e-10


@pytest.mark.parametrize("method", ["cellmajor", "scatter"])
def test_grid_paint_float32_disc_edges(method, cosmo_t):
    """A float32 grid paint decides the disc edge r < eps_max R as the
    float64 paint does, far from the box origin: each halo sits so that a
    pixel centre lies 2e-6 of eps_max R inside (or outside) its disc, at
    box coordinates near 970 Mpc, where a float32 coordinate is rounded
    by ~3e-5 Mpc. The runners take each halo's offset from its nearest
    bin in float64, so the two precisions paint the same pixels (a
    flat-topped profile, such as a wide pixel window's, turns each flipped
    edge pixel into an error of a whole halo's value)."""
    N, L, eps, z = 1024, 1000.0, 5.0, 0.25
    res = L / N
    tab = T.TabulatedProfile(T.Gas(**PAR), cosmo_t)
    tab.setup_interpolator(z_min=0.1, z_max=0.5, N_samples_z=3, M_min=1e13,
                           M_max=1e15, N_samples_Mass=4, R_min=1e-3,
                           R_max=1e2, N_samples_R=40)
    n = 24
    M = np.geomspace(1e14, 6e14, n)
    a = 1 / (1 + z)
    R = T.MassDef(200, "critical").get_radius(
        cosmo_t, torch.tensor(M), a).numpy() / a
    side = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)    # inside / outside
    reach = eps * R * (1 - side * 2e-6) / np.sqrt(2)
    # target pixels 40 apart (a disc spans < 20), far from the origin
    px = 1000 - 40 * (np.arange(n) % 12)
    py = 1000 - 80 * (np.arange(n) // 12)
    cat = T.HaloNDCatalog(x=(px + 0.5) * res - reach,
                          y=(py + 0.5) * res - reach, M=M, redshift=z,
                          cosmo=COSMO_DICT)
    gm = T.GriddedMap(map=np.zeros((N, N)), redshift=z,
                      bins=(np.arange(N) + 0.5) * res, cosmo=COSMO_DICT)
    maps = {p: T.PaintProfilesGrid(cat, gm, epsilon_max=eps, model=tab,
                                   verbose=False, device="cpu", method=method,
                                   precision=p).process()
            for p in ("float32", "float64")}
    y32, y64 = maps["float32"], maps["float64"]
    np.testing.assert_array_equal(y64[px, py] > 0, side > 0)
    np.testing.assert_array_equal(y32 > 0, y64 > 0)
    np.testing.assert_allclose(y32, y64, rtol=1e-4, atol=0)
