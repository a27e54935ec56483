"""The port's particle-snapshot runner and its parts against the JAX
package.

float64 on the CPU, inputs made from numpy seeds and handed to both
packages. The displacement tables are built once by the JAX package and
carried across (``from_arrays``): a plain 3D table, an ``Rdelta``-sampled
one with a theta_ej axis, and a 2D table. Runners use ``n_buckets=2``
(both packages) to keep the JAX compiles few.

- ``ParticleSnapshot`` and ``make_map``, 2D and 3D: the same catalog and
  the same histogram;
- ``CellList``: the same permutation, cell starts, counts and
  ``max_per_cell``;
- ``pad_particles_by_cell``: the same planes, counts and slot map;
- the plain ``snapshot_offsets_pass`` at one bucket, on the same
  candidate lists, against the JAX pass to 1e-12 of max|offset|;
- ``BaryonifySnapshot`` against the JAX runner of the same method to
  rtol 1e-10 / atol 1e-10 (the JAX tests' bar, tests/test_runners.py
  TestBaryonifySnapshot): 3D with both methods on a plain table, a
  theta_ej table with a catalog column, and an ``Rdelta``-sampled table;
  a 2D gather; the port's two methods against each other at the same bar;
- an empty catalog and a catalog redshift outside the table;
- the brute-force O(N H) neighbour loop of tests/test_runners.py
  (atol 1e-9);
- ``method="auto"`` on CPU and CUDA device types, with the 2D and
  too-many-axes warnings; ``gather`` accepted by the snapshot runner and
  refused by the shell runner.
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import baryonification_tpu as J
import baryonification_tpu_torch as T
from baryonification_tpu.runners import grid_cellmajor as jgcm
from baryonification_tpu.runners import snapshot as jsnap
from baryonification_tpu.runners import snapshot_cellmajor as jscm
from baryonification_tpu_torch.runners import snapshot as tsnap
from baryonification_tpu_torch.runners import snapshot_cellmajor as tscm
from baryonification_tpu_torch.runners._method import resolve_method

from test_profiles import PAR
from test_runners import COSMO_DICT

torch.set_num_threads(1)

GRID = dict(z_min=0.05, z_max=0.6, N_samples_z=3, M_min=1e13, M_max=1e15,
            N_samples_Mass=4, R_min=1e-3, R_max=70, N_samples_R=48)
THETA = {'theta_ej': np.array([2.0, 4.0, 8.0])}
NB = 2                      # runner buckets, both packages
METHODS = ("gather", "cellmajor")


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
    out = {}
    for name, cls_j, cls_t, kw in (
            ("plain", J.Baryonification3D, T.Baryonification3D, {}),
            ("rdp", J.Baryonification3D, T.Baryonification3D,
             dict(Rdelta_sampling=True, other_params=THETA, N_samples_z=2,
                  R_min=1e-2, R_max=30)),
            ("2d", J.Baryonification2D, T.Baryonification2D,
             dict(N_samples_z=2))):
        mj = cls_j(J.DarkMatterOnly(**PAR), J.DarkMatterBaryon(**PAR), cosmo,
                   epsilon_max=20)
        mj.setup_interpolator(verbose=False, **dict(GRID, **kw))
        out[name] = mj, _carry(mj, cosmo_t, cls_t)
    return out


def _snap_inputs(dim, n_part, n_halo, L, seed, props=False):
    """(snapshot kwargs, halo catalog kwargs): uniform particles of unit
    mass, halos of 10^13.8-10^14.7 Msun, z = 0.25."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, L, (dim, n_part))
    snap = dict(x=pos[0], y=pos[1], M=np.ones(n_part), L=L, redshift=0.25,
                cosmo=COSMO_DICT)
    cat = dict(x=rng.uniform(0, L, n_halo), y=rng.uniform(0, L, n_halo),
               M=10 ** rng.uniform(13.8, 14.7, n_halo), redshift=0.25,
               cosmo=COSMO_DICT)
    if dim == 3:
        snap['z'] = pos[2]
        cat['z'] = rng.uniform(0, L, n_halo)
    if props:
        cat['theta_ej'] = rng.uniform(2.5, 7.5, n_halo)
    return snap, cat


def _run(pkg, model, snap_kw, cat_kw, method, eps=10, **kw):
    if pkg is T:
        kw['device'] = "cpu"
    return pkg.BaryonifySnapshot(
        pkg.HaloNDCatalog(**cat_kw), pkg.ParticleSnapshot(**snap_kw),
        epsilon_max=eps, model=model, method=method, verbose=False,
        n_buckets=NB, **kw).process()


def _coords(cat, dim):
    return np.stack([cat[c] for c in 'xyz'[:dim]], axis=-1)


# ----- io, cell list, padding -----

@pytest.mark.parametrize("dim", [2, 3])
def test_particle_snapshot_and_make_map_match_jax(dim):
    snap_kw, _ = _snap_inputs(dim, 3000, 1, 50.0, 3)
    snap_kw['M'] = np.random.default_rng(4).uniform(0.5, 2.0, 3000)
    sj, st = J.ParticleSnapshot(**snap_kw), T.ParticleSnapshot(**snap_kw)
    assert st.is2D == sj.is2D == (dim == 2) and len(st) == len(sj) == 3000
    assert st.cat.dtype == sj.cat.dtype
    for name in st.cat.dtype.names:               # z is NaN in 2D
        np.testing.assert_array_equal(st.cat[name], sj.cat[name])
    got, want = st.make_map(12), sj.make_map(12)
    assert got.shape == (12,) * dim
    np.testing.assert_array_equal(got, want)
    assert np.isclose(got.sum(), snap_kw['M'].sum())


@pytest.mark.parametrize("dim,n_cells", [(2, 9), (3, 8)])
def test_cell_list_matches_jax(dim, n_cells):
    rng = np.random.default_rng(11)
    L = 30.0
    coords = rng.uniform(0, L, (4000, dim))
    coords[:3, 0] = [0.0, L - 1e-13, L]           # the box edges
    tj = jsnap.CellList(coords, L, n_cells)
    tt = tsnap.CellList(coords, L, n_cells)
    for name in ("order", "sorted_cid", "cell_start", "cell_count"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(tj, name))
    assert tt.max_per_cell == tj.max_per_cell > 0
    assert tt.h == tj.h


def test_pad_particles_by_cell_matches_jax():
    rng = np.random.default_rng(12)
    coords = rng.uniform(0, 40.0, (3000, 3))
    tree = tsnap.CellList(coords, 40.0, 8)
    P = tree.max_per_cell
    got = tscm.pad_particles_by_cell(tree, coords, P)
    want = jscm.pad_particles_by_cell(jsnap.CellList(coords, 40.0, 8),
                                      coords, P)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        tscm.np_morton3_of_rowmajor(np.arange(512), 8),
        jscm.np_morton3_of_rowmajor(np.arange(512), 8))


@pytest.mark.parametrize("model_name", ["plain", "rdp"])
def test_offsets_pass_matches_jax(model_name, models):
    """One bucket (all halos) of the plain pass against the JAX pass on
    the same candidate lists and records, to 1e-12 of max|offset|."""
    mj, mt = models[model_name]
    props = model_name == "rdp"
    snap_kw, cat_kw = _snap_inputs(3, 4000, 9, 60.0, 31, props=props)
    runner = T.BaryonifySnapshot(
        T.HaloNDCatalog(**cat_kw), T.ParticleSnapshot(**snap_kw),
        epsilon_max=10, model=mt, method="cellmajor", n_buckets=1,
        verbose=False, device="cpu")
    runner._check_caches()
    a, R_com, R_q, xh, cols = runner._halo_geom()
    idx = np.arange(len(R_q))
    dense, counts, counts_host, K = runner._cm_dense(
        0, idx, xh, float(R_q.max()), R_q, torch.float64)
    P, planes, counts_p, _ = runner._cm_staging(torch.float64)
    grids = mt._grids
    use_rdelta = mt.Rdelta_sampling
    g2 = grids[2].numpy()
    rad_max = np.log(10.0) if use_rdelta else np.log(10.0 * R_com.max())
    n_hi = runner._node_bound(g2, rad_max, len(g2))
    z = float(np.log(1.25))
    table_z, inb = tsnap.gcm.blend_table_z(mt._table, grids[0], z)
    assert inb
    table_z = torch.where(torch.isfinite(table_z), table_z, 0.0)
    packed = torch.tensor(cols)
    rows = tsnap.gcm.halo_rows(grids[1], grids[3:], table_z, packed[:, 4],
                               packed[:, 6:6 + len(grids) - 3], n_hi)
    out = tuple(torch.zeros_like(p) for p in planes)
    tscm.snapshot_offsets_pass(use_rdelta, P, n_hi, dense, counts,
                               counts_host, planes, counts_p, packed, rows,
                               float(g2[0]), float(g2[1] - g2[0]),
                               float(g2[n_hi - 1]), 10.0, a, 60.0, out)
    ncell = counts.shape[0]
    jgrids = [jnp.asarray(g) for g in mj._grids]
    jtab, _ = jgcm.blend_table_z(jnp.asarray(mj._table), jgrids[0],
                                 jnp.float64(z))
    jtab = jnp.where(jnp.isfinite(jtab), jtab, 0.0)
    zeros = jnp.zeros(ncell * P)
    want = jscm.snapshot_offsets_pass(
        use_rdelta, P, ncell, n_hi, jnp.asarray(dense.numpy()),
        jnp.asarray(counts.numpy()), *(jnp.asarray(p.numpy())
                                       for p in planes),
        jnp.asarray(counts_p.numpy()), jnp.asarray(cols), jgrids[1], jtab,
        jgrids[2], 10.0, jnp.float64(a), jnp.float64(60.0), zeros, zeros,
        zeros, gprops=tuple(jgrids[3:]))
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    assert scale > 1e-3
    for g, w in zip(out, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12 * scale)


# ----- the runner -----

# case -> (dim, model, catalog seed, property column)
CASES = {"3d": (3, "plain", 17, False),
         "3d_rdelta_props": (3, "rdp", 23, True),
         "2d": (2, "2d", 29, False)}


@pytest.fixture(scope="module")
def snap_runs(models):
    """(case, method) -> (JAX catalog, port catalog, snapshot kwargs)."""
    out = {}
    for case, (dim, name, seed, props) in CASES.items():
        mj, mt = models[name]
        n_part, L = (6000, 70.0) if dim == 3 else (3000, 40.0)
        snap_kw, cat_kw = _snap_inputs(dim, n_part, 10, L, seed, props)
        for m in METHODS if dim == 3 else ("gather",):
            want = _run(J, mj, snap_kw, cat_kw, m)
            got = _run(T, mt, snap_kw, cat_kw, m)
            out[case, m] = want, got, snap_kw
    return out


@pytest.mark.parametrize("case,method", [(c, m) for c in CASES
                                         for m in METHODS
                                         if CASES[c][0] == 3 or m == "gather"])
def test_baryonify_snapshot_matches_jax(case, method, snap_runs):
    want, got, snap_kw = snap_runs[case, method]
    dim = CASES[case][0]
    assert got.dtype == want.dtype
    g, w = _coords(got, dim), _coords(want, dim)
    np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(got['M'], want['M'])
    start = np.stack([snap_kw[c] for c in 'xyz'[:dim]], axis=-1)
    assert np.abs(w - start).max() > 1e-3          # particles moved
    assert np.all((g >= 0) & (g <= snap_kw['L']))


@pytest.mark.parametrize("case", ["3d", "3d_rdelta_props"])
def test_snapshot_methods_agree(case, snap_runs):
    _, cm, _ = snap_runs[case, "cellmajor"]
    _, ga, _ = snap_runs[case, "gather"]
    np.testing.assert_allclose(_coords(cm, 3), _coords(ga, 3), rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("method", METHODS)
def test_empty_catalog_and_redshift_out_of_table(method, models):
    """An empty catalog returns the snapshot as it was; a catalog
    redshift outside the table (z 0.05-0.6) moves no particle, as in the
    JAX package."""
    mj, mt = models["plain"]
    snap_kw, cat_kw = _snap_inputs(3, 2000, 5, 50.0, 41)
    empty = dict(cat_kw, x=[], y=[], z=[], M=[])
    got = _run(T, mt, snap_kw, empty, method)
    np.testing.assert_array_equal(got, T.ParticleSnapshot(**snap_kw).cat)
    far = dict(cat_kw, redshift=2.0)
    got = _run(T, mt, snap_kw, far, method)
    want = _run(J, mj, snap_kw, far, method)
    np.testing.assert_array_equal(_coords(got, 3), _coords(want, 3))
    np.testing.assert_array_equal(_coords(got, 3),
                                  np.stack([snap_kw[c] for c in 'xyz'], -1))


def test_matches_bruteforce(models, cosmo_t):
    """The cell-list gather equals a direct loop over every (particle,
    halo) pair with the port's own displacement readout (atol 1e-9), the
    case of tests/test_runners.py TestBaryonifySnapshot."""
    _, mt = models["plain"]
    rng = np.random.default_rng(15)
    L = 60.0
    n_part = 2000
    xyz = rng.uniform(0, L, (n_part, 3))
    snap = T.ParticleSnapshot(x=xyz[:, 0], y=xyz[:, 1], z=xyz[:, 2],
                              M=np.ones(n_part), L=L, redshift=0.25,
                              cosmo=COSMO_DICT)
    hpos = np.array([[10.0, 12.0, 8.0], [50.0, 45.0, 55.0]])
    hM = np.array([10 ** 14.5, 10 ** 14.2])
    cat = T.HaloNDCatalog(x=hpos[:, 0], y=hpos[:, 1], z=hpos[:, 2], M=hM,
                          redshift=0.25, cosmo=COSMO_DICT)
    new_cat = T.BaryonifySnapshot(cat, snap, epsilon_max=8, model=mt,
                                  verbose=False, device="cpu").process()
    a = 1 / 1.25
    tot = np.zeros((n_part, 3))
    for j in range(2):
        R = float(T.MassDef(200, 'critical').get_radius(
            cosmo_t, torch.tensor(hM[j]), a))
        dx = xyz - hpos[j]
        dx = np.where(dx > L / 2, dx - L, dx)
        dx = np.where(dx < -L / 2, dx + L, dx)
        d = np.sqrt(np.sum(dx**2, axis=1))
        sel = d < min(8 * R / a, L / 2)
        dd = mt.displacement(d[sel], hM[j], a).numpy() * a
        dd = np.where(np.isfinite(dd), dd, 0)
        tot[sel] += dd[:, None] * dx[sel] / d[sel, None]
    want = np.mod(xyz + tot, L)
    got = _coords(new_cat, 3)
    assert np.abs(tot).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


# ----- method resolution -----

class _AxesModel:
    """A stand-in model with 11 extra table axes (no table needed to
    resolve the method)."""
    p_keys = [f"p{i}" for i in range(11)]


@pytest.mark.parametrize("dim,model,device,want,warns", [
    (3, "plain", "cpu", "gather", False),
    (3, "plain", "cuda", "cellmajor", False),
    (2, "2d", "cpu", "gather", False),
    (2, "2d", "cuda", "gather", True),
    (3, "axes", "cuda", "gather", True)])
def test_auto_method(dim, model, device, want, warns, models):
    """``auto`` is gather on the CPU and cellmajor on CUDA, with a warning
    naming the reason for a 2D snapshot or more extra axes than the
    records hold; an explicit cellmajor there raises. Nothing runs, so a
    CUDA device type needs no card."""
    mdl = _AxesModel() if model == "axes" else models[model][1]
    snap_kw, cat_kw = _snap_inputs(dim, 500, 3, 20.0, 5)
    args = (T.HaloNDCatalog(**cat_kw), T.ParticleSnapshot(**snap_kw), 10,
            mdl)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        runner = T.DefaultRunnerSnapshot(*args, device=device)
    assert runner.method == want
    msgs = [str(w.message) for w in rec]
    reason = "2D snapshots" if dim == 2 else "extra parameter axes"
    assert any(reason in m for m in msgs) == warns
    if warns:
        with pytest.raises(ValueError, match=reason):
            T.DefaultRunnerSnapshot(*args, method="cellmajor", device=device)
    # the cell count: about half the cube root of the particle count,
    # rounded to a power of two for the cell-major method
    assert runner.tree.n_cells == (4 if want == "cellmajor" or dim == 3
                                   else 11)


def test_gather_is_the_snapshot_slow_method():
    """``gather`` resolves where it is the family's slow method (the
    snapshot runner) and still raises for the shell runners, whose
    pixel-major ``gather`` is not ported."""
    assert resolve_method("gather", None, "gather", "cuda") == "gather"
    assert resolve_method("auto", None, "gather", "cpu") == "gather"
    with pytest.raises(NotImplementedError, match="shell_gather"):
        resolve_method("gather", None, "scatter", "cuda")
    with pytest.raises(ValueError, match="unknown method"):
        resolve_method("scatter", None, "gather", "cpu")
    snap_kw, cat_kw = _snap_inputs(3, 500, 3, 20.0, 6)
    runner = T.BaryonifySnapshot(T.HaloNDCatalog(**cat_kw),
                                 T.ParticleSnapshot(**snap_kw), 10, None,
                                 method="gather", device="cpu")
    assert runner.method == "gather"
    shell = T.LightconeShell(map=np.ones(12 * 4**2), cosmo=COSMO_DICT)
    lc = T.HaloLightConeCatalog(ra=[10.0], dec=[5.0], M=[1e14], z=[0.2],
                                cosmo=COSMO_DICT)
    with pytest.raises(NotImplementedError, match="shell_gather"):
        T.BaryonifyShell(lc, shell, 10, None, method="gather",
                         device="cpu")
