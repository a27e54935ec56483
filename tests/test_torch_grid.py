"""The port's grid runners, their cell-major parts, the CIC deposit and
``ParamTabulatedProfile``, against the JAX package.

float64 on the CPU, inputs made from numpy seeds and handed to both
packages. The tables are built by the JAX package and carried across
(``from_arrays``); the 3D displacement table and the parameter-tabulated
gas profile are also rebuilt by the port. Runners use ``n_buckets=3``
(both packages) to keep the JAX compiles few.

- Morton ids: round trip, and ``block_perm`` / ``block_perm_2d`` equal to
  the JAX ids;
- block registration and refinement: the same candidate list, in the same
  order, in every block, 2D and 3D;
- ``cic_deposit_2d`` / ``_3d`` with positions past both box edges: to
  1e-12 of max|map|;
- ``ParamTabulatedProfile`` tables to 1e-8 of max|table| (finite entries;
  the -inf entries at the same places);
- ``BaryonifyGrid``, 3D and 2D, both methods, against the JAX runner of
  the same method to rms/mean < 1e-10: a plain model (also with the
  port's own table), an ``Rdelta``-sampled model with an ``other_params``
  axis (catalog column theta_ej), and 2D ellipticity; the port's two
  methods against each other at the JAX tests' bar (atol 1e-8 of
  max|change|, rtol 1e-8; tests/test_runners.py TestGridCellMajor);
- ``PaintProfilesGrid``, 3D (``TabulatedProfile``) and 2D with
  ellipticity and a ``ParamTabulatedProfile`` axis, both methods, against
  JAX to rms/mean < 1e-10, and methods against each other at rtol 1e-8,
  atol 1e-10 of max|map|;
- ``PaintProfilesShell`` with a ``ParamTabulatedProfile``, both methods,
  against JAX to rms/mean < 1e-10;
- an empty catalog and a redshift outside the table leave the map (or
  paint zeros); 3D ellipticity is refused.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import baryonification_tpu as J
import baryonification_tpu_torch as T
from baryonification_tpu.ops import scatter as jsc
from baryonification_tpu.runners import grid_cellmajor as jgcm
from baryonification_tpu.runners import shell_cellmajor as jcm
from baryonification_tpu.tabulate import ParamTabulatedProfile as JParam
from baryonification_tpu_torch.ops import scatter as tsc
from baryonification_tpu_torch.runners import grid_cellmajor as tgcm
from baryonification_tpu_torch.runners import shell_cellmajor as tcm

from test_profiles import PAR
from test_runners import COSMO_DICT

torch.set_num_threads(1)

GRID = dict(z_min=0.05, z_max=0.6, N_samples_z=3, M_min=1e13, M_max=1e15,
            N_samples_Mass=4, R_min=1e-3, R_max=70, N_samples_R=48)
THETA = {'theta_ej': np.array([2.0, 4.0, 8.0])}
NB = 3                      # runner buckets, both packages
METHODS = ("scatter", "cellmajor")


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _rms(got, want, scale):
    return np.sqrt(np.mean((got - want) ** 2)) / scale


# ----- Morton ids, registration, refinement -----

@pytest.mark.parametrize("dim", [2, 3])
def test_morton_and_block_perm_match_jax(dim):
    rng = np.random.default_rng(0)
    c = rng.integers(0, 1024, (dim, 500))
    jm = jgcm.morton2 if dim == 2 else jgcm.morton3
    tm = tgcm.morton2 if dim == 2 else tgcm.morton3
    td = tgcm.demorton2 if dim == 2 else tgcm.demorton3
    want = np.asarray(jm(*[jnp.asarray(x, dtype=jnp.int32) for x in c]))
    got = tm(*[torch.tensor(x) for x in c])
    np.testing.assert_array_equal(got.numpy(), want)
    for x, y in zip(td(got), c):
        np.testing.assert_array_equal(x.numpy(), y)
    g = np.array(list(itertools.product(range(8), repeat=dim))).T
    ids = tm(*[torch.tensor(x) for x in g]).tolist()
    assert sorted(ids) == list(range(8 ** dim))
    jp = jgcm.block_perm_2d if dim == 2 else jgcm.block_perm
    tp = tgcm.block_perm_2d if dim == 2 else tgcm.block_perm
    with pytest.raises(TypeError):
        tp(16, 4)                       # the device is a required keyword
    for N, B in ((16, 4), (32, 8)):
        perm = tp(N, B, device="cpu")
        np.testing.assert_array_equal(perm.numpy(), np.asarray(jp(N, B)))
        assert sorted(perm.tolist()) == list(range(N ** dim))


def _block_lists(dense, counts, nc):
    dense = np.asarray(dense).reshape(nc, -1)
    counts = np.asarray(counts)
    return [dense[c, :counts[c]].tolist() for c in range(nc)]


@pytest.mark.parametrize("dim", [2, 3])
def test_registration_and_refinement_match_jax(dim):
    """Halos near the box edges and reaches of 1-12 Mpc, 8 blocks a side,
    refined to 16: the same lists, in the same order, at both levels."""
    rng = np.random.default_rng(5)
    H, L, nb, W = 30, 80.0, 8, 5
    pos = [rng.uniform(0, L, H) for _ in range(dim)]
    pos[0][:3] = [0.01, L - 0.01, L / 2]
    reach = rng.uniform(1.0, 12.0, H)
    jreg = jgcm.register_halos_grid_2d if dim == 2 \
        else jgcm.register_halos_grid
    treg = tgcm.register_halos_grid_2d if dim == 2 \
        else tgcm.register_halos_grid
    jh, js, jK = jreg(nb, W, jnp.float64(L), *map(jnp.asarray, pos),
                      jnp.asarray(reach))
    th, ts, tK = treg(nb, W, L, *map(_t, pos), _t(reach))
    nc = nb ** dim
    assert tK == int(jK) > 0
    K_pad = max(64, -(-tK // 64) * 64)
    jd, jc = jcm.dense_cell_candidates(nc, K_pad, jh, js)
    td, tc = tcm.dense_cell_candidates(nc, tK, th, ts)
    assert _block_lists(td, tc, nc) == _block_lists(jd, jc, nc)

    nb2, hb2 = 2 * nb, L / (2 * nb)
    jrec = np.zeros((H, 16))
    jrec[:, :dim] = np.stack(pos, axis=-1)
    jrec[:, 3] = reach
    jref = jgcm.refine_block_candidates_2d if dim == 2 \
        else jgcm.refine_block_candidates
    tref = tgcm.refine_block_candidates_2d if dim == 2 \
        else tgcm.refine_block_candidates
    jd2, jc2, jK2 = jref(nb2, jd, jc, jnp.asarray(jrec), jnp.float64(hb2),
                         jnp.float64(L))
    trec = _t(np.concatenate([np.stack(pos, axis=-1), reach[:, None]], -1))
    td2, tc2, tK2 = tref(nb2, td, tc, trec, hb2, L)
    assert tK2 == int(jK2) < tK
    nc2 = nb2 ** dim
    assert _block_lists(td2, tc2, nc2) == _block_lists(jd2, jc2, nc2)


@pytest.mark.parametrize("dim", [2, 3])
def test_cic_deposit_matches_jax(dim):
    """Positions past both edges of the box (periodic wrap, negative
    offsets), to 1e-12 of max|map|; the deposit conserves the total."""
    rng = np.random.default_rng(7)
    N = 16 if dim == 3 else 32
    pos = [np.arange(N ** dim) // N ** (dim - 1 - d) % N
           + rng.uniform(-2.5, 2.5, N ** dim) for d in range(dim)]
    pos[0][:4] = [-1e-9, N - 1e-12, -N - 0.5, 2 * N + 0.25]
    vals = rng.uniform(0.5, 1.5, N ** dim)
    jf = jsc.cic_deposit_2d if dim == 2 else jsc.cic_deposit_3d
    tf = tsc.cic_deposit_2d if dim == 2 else tsc.cic_deposit_3d
    want = np.asarray(jf(N, *map(jnp.asarray, pos), jnp.asarray(vals)))
    got = tf(N, *map(_t, pos), _t(vals)).numpy()
    assert got.shape == (N,) * dim
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    assert np.isclose(got.sum(), vals.sum(), rtol=1e-12)


# ----- models -----

@pytest.fixture(scope="module")
def cosmo_t():
    return T.Cosmology.from_dict(COSMO_DICT, device="cpu")


def _carry(model_j, cosmo_t, cls):
    return cls(T.DarkMatterOnly(**PAR), T.DarkMatterBaryon(**PAR), cosmo_t,
               epsilon_max=20).from_arrays(
        [np.asarray(g) for g in model_j._grids], np.asarray(model_j._table),
        model_j.Rdelta_sampling, model_j.p_keys)


@pytest.fixture(scope="module")
def models(cosmo, cosmo_t):
    """name -> (JAX model, port model carried across)."""
    plain = J.Baryonification3D(J.DarkMatterOnly(**PAR),
                                J.DarkMatterBaryon(**PAR), cosmo,
                                epsilon_max=20)
    plain.setup_interpolator(verbose=False, **GRID)
    rdp = J.Baryonification3D(J.DarkMatterOnly(**PAR),
                              J.DarkMatterBaryon(**PAR), cosmo,
                              epsilon_max=20)
    rdp.setup_interpolator(verbose=False, Rdelta_sampling=True,
                           other_params=THETA,
                           **dict(GRID, N_samples_z=2, R_min=1e-2, R_max=30))
    gas = J.TabulatedProfile(J.Gas(**PAR), cosmo)
    gas.setup_interpolator(**GRID)
    pgas = JParam(J.Gas(**PAR), cosmo)
    pgas.setup_interpolator(other_params=THETA, **GRID)
    tabs = {k: (m, cls(T.Gas(**PAR), cosmo_t).from_arrays(
                [np.asarray(g) for g in m._grids], np.asarray(m._ln3D),
                np.asarray(m._ln2D), getattr(m, 'p_keys', [])))
            for k, m, cls in (("gas", gas, T.TabulatedProfile),
                              ("pgas", pgas, T.ParamTabulatedProfile))}
    return dict(plain=(plain, _carry(plain, cosmo_t, T.Baryonification3D)),
                rdp=(rdp, _carry(rdp, cosmo_t, T.Baryonification3D)), **tabs)


@pytest.fixture(scope="module")
def rebuilt(cosmo_t):
    """The plain 3D table and the parameter-tabulated gas, built by the
    port."""
    plain = T.Baryonification3D(T.DarkMatterOnly(**PAR),
                                T.DarkMatterBaryon(**PAR), cosmo_t,
                                epsilon_max=20)
    plain.setup_interpolator(verbose=False, **GRID)
    pgas = T.ParamTabulatedProfile(T.Gas(**PAR), cosmo_t)
    pgas.setup_interpolator(other_params=THETA, **GRID)
    return dict(plain=plain, pgas=pgas)


def test_param_tables_match_jax(models, rebuilt):
    mj, mc = models["pgas"]
    mt = rebuilt["pgas"]
    assert mt.p_keys == mc.p_keys == mj.p_keys == ["theta_ej"]
    for gj, gt in zip(mj._grids, mt._grids):
        np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    for attr in ("_ln3D", "_ln2D"):
        want = np.asarray(getattr(mj, attr))
        got = getattr(mt, attr).numpy()
        assert got.shape == want.shape == (3, 4, 48, 3)
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), fin)
        np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                                   atol=1e-8 * np.abs(want[fin]).max())
    r, M = np.geomspace(0.05, 5, 7), np.array([2e13, 3e14])
    for fn in ("real", "projected"):
        np.testing.assert_allclose(
            getattr(mt, fn)(None, r, M, 0.8, theta_ej=5.0).numpy(),
            np.asarray(getattr(mj, fn)(None, r, M, 0.8, theta_ej=5.0)),
            rtol=1e-8)


# ----- runners -----

def _catalogs(dim, n, seed, props=False, ell=False):
    """(catalog kwargs, map, bins): N = 32 in 3D (L = 80), 64 in 2D
    (L = 90), masses 10^13.6-10^14.8."""
    rng = np.random.default_rng(seed)
    N, L = (32, 80.0) if dim == 3 else (64, 90.0)
    kw = dict(x=rng.uniform(0, L, n), y=rng.uniform(0, L, n),
              M=10 ** rng.uniform(13.6, 14.8, n), redshift=0.25,
              cosmo=COSMO_DICT)
    if dim == 3:
        kw['z'] = rng.uniform(0, L, n)
    if props:
        kw['theta_ej'] = rng.uniform(2.5, 7.5, n)
    if ell:
        kw['q_ell'] = rng.uniform(0.4, 0.9, n)
        kw['A_ell'] = rng.normal(size=(n, 2))
    return kw, rng.uniform(0.5, 1.5, (N,) * dim), (np.arange(N) + 0.5) * (L / N)


# case -> (dim, model, eps_max, catalog seed, props, ellipticity)
BARY = {"3d": (3, "plain", 10, 21, False, False),
        "3d_rdelta_props": (3, "rdp", 10, 23, True, False),
        "2d": (2, "plain", 15, 34, False, False),
        "2d_ell": (2, "plain", 15, 34, False, True)}
PAINT = {"3d": (3, "gas", 5, 21, False, False),
         "2d_ell_props": (2, "pgas", 5, 29, True, True)}


def _grid_run(pkg, runner, model, case, method, **kw):
    dim, _, eps, seed, props, ell = case
    cat_kw, mp, bins = _catalogs(dim, 14, seed, props, ell)
    cat = pkg.HaloNDCatalog(**cat_kw)
    gm = pkg.GriddedMap(map=mp, redshift=0.25, bins=bins, cosmo=COSMO_DICT)
    r = getattr(pkg, runner)(cat, gm, epsilon_max=eps, model=model,
                             use_ellipticity=ell, method=method,
                             verbose=False, n_buckets=NB, **kw)
    return np.asarray(r.process()), mp


@pytest.fixture(scope="module")
def bary_maps(models):
    """(case, method) -> (JAX map, port map, original map)."""
    out = {}
    for case, spec in BARY.items():
        mj, mt = models[spec[1]]
        for m in METHODS:
            want, mp = _grid_run(J, "BaryonifyGrid", mj, spec, m)
            got, _ = _grid_run(T, "BaryonifyGrid", mt, spec, m,
                               device="cpu")
            out[case, m] = want, got, mp
    return out


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case", list(BARY))
def test_baryonify_grid_matches_jax(case, method, bary_maps):
    want, got, mp = bary_maps[case, method]
    assert got.shape == mp.shape
    assert np.isclose(got.sum(), mp.sum(), rtol=1e-8)
    assert np.abs(want - mp).max() > 1e-3
    assert _rms(got, want, mp.mean()) < 1e-10


@pytest.mark.parametrize("case", list(BARY))
def test_baryonify_grid_methods_agree(case, bary_maps):
    _, cm, mp = bary_maps[case, "cellmajor"]
    _, sc, _ = bary_maps[case, "scatter"]
    scale = np.abs(sc - mp).max()
    assert scale > 0
    np.testing.assert_allclose(cm, sc, atol=1e-8 * scale, rtol=1e-8)


@pytest.mark.parametrize("method", METHODS)
def test_baryonify_grid_rebuilt_table_matches_jax(method, bary_maps,
                                                  rebuilt):
    want, _, mp = bary_maps["3d", method]
    got, _ = _grid_run(T, "BaryonifyGrid", rebuilt["plain"], BARY["3d"],
                       method, device="cpu")
    assert _rms(got, want, mp.mean()) < 1e-10


@pytest.fixture(scope="module")
def paint_maps(models):
    out = {}
    for case, spec in PAINT.items():
        mj, mt = models[spec[1]]
        for m in METHODS:
            want, _ = _grid_run(J, "PaintProfilesGrid", mj, spec, m)
            got, _ = _grid_run(T, "PaintProfilesGrid", mt, spec, m,
                               device="cpu")
            out[case, m] = want, got
    return out


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case", list(PAINT))
def test_paint_grid_matches_jax(case, method, paint_maps):
    want, got = paint_maps[case, method]
    assert got.shape == want.shape and want.sum() > 0
    assert _rms(got, want, want.mean()) < 1e-10


@pytest.mark.parametrize("case", list(PAINT))
def test_paint_grid_methods_agree(case, paint_maps):
    _, cm = paint_maps[case, "cellmajor"]
    _, sc = paint_maps[case, "scatter"]
    np.testing.assert_allclose(cm, sc, rtol=1e-8, atol=1e-10 * sc.max())


@pytest.mark.parametrize("method", METHODS)
def test_paint_shell_param_tabulated_matches_jax(method, models, rebuilt):
    """Shell painting with a per-halo theta_ej column: the JAX table
    carried across and the port's own, against the JAX runner."""
    rng = np.random.default_rng(11)
    n, nside = 25, 32
    halos = dict(ra=rng.uniform(0, 360, n),
                 dec=np.degrees(np.arcsin(rng.uniform(-0.8, 0.8, n))),
                 M=10 ** rng.uniform(13.6, 14.8, n),
                 z=rng.uniform(0.15, 0.45, n),
                 theta_ej=rng.uniform(2.5, 7.5, n))
    mj, mc = models["pgas"]

    def run(pkg, model, **kw):
        return np.asarray(pkg.PaintProfilesShell(
            pkg.HaloLightConeCatalog(cosmo=COSMO_DICT, **halos),
            pkg.LightconeShell(map=np.zeros(12 * nside ** 2),
                               cosmo=COSMO_DICT),
            epsilon_max=5, model=model, method=method,
            verbose=False, **kw).process())

    want = run(J, mj)
    assert want.sum() > 0
    for model in (mc, rebuilt["pgas"]):
        got = run(T, model, device="cpu")
        assert _rms(got, want, want.mean()) < 1e-10


@pytest.mark.parametrize("method", METHODS)
def test_grid_empty_catalog_and_redshift_outside_table(method, models):
    _, plain = models["plain"]
    _, gas = models["gas"]
    kw, mp, bins = _catalogs(3, 5, 21)
    gm = T.GriddedMap(map=mp, redshift=2.0, bins=bins, cosmo=COSMO_DICT)
    run = dict(verbose=False, method=method, device="cpu")
    far = T.HaloNDCatalog(**dict(kw, redshift=2.0))
    np.testing.assert_array_equal(
        T.BaryonifyGrid(far, gm, epsilon_max=10, model=plain,
                        **run).process(), mp)
    np.testing.assert_array_equal(
        T.PaintProfilesGrid(far, gm, epsilon_max=5, model=gas,
                            **run).process(), np.zeros(mp.shape))
    empty = T.HaloNDCatalog(x=[], y=[], z=[], M=[], redshift=0.25,
                            cosmo=COSMO_DICT)
    np.testing.assert_array_equal(
        T.BaryonifyGrid(empty, gm, epsilon_max=10, model=plain,
                        **run).process(), mp)
    np.testing.assert_array_equal(
        T.PaintProfilesGrid(empty, gm, epsilon_max=5, model=gas,
                            **run).process(), np.zeros(mp.shape))


def test_grid_refuses_3d_ellipticity(models):
    _, plain = models["plain"]
    kw, mp, bins = _catalogs(3, 2, 5, ell=True)
    cat = T.HaloNDCatalog(**kw)
    gm = T.GriddedMap(map=mp, redshift=0.25, bins=bins, cosmo=COSMO_DICT)
    with pytest.raises(NotImplementedError, match="3D"):
        T.BaryonifyGrid(cat, gm, epsilon_max=10, model=plain,
                        use_ellipticity=True, device="cpu")
    with pytest.raises(ValueError, match="3D ellipticity"):
        T.BaryonifyGrid(cat, gm, epsilon_max=10, model=plain,
                        use_ellipticity=True, method="cellmajor",
                        device="cpu")
