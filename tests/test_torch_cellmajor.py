"""The port's cell-major shell method against the JAX package.

float64 on the CPU, inputs made from numpy seeds and handed to both
packages:

- NESTED <-> RING conversions: exact at nside 1, 2, 8, 64;
- the coarse registration and ``dense_cell_candidates``: the same
  candidate lists (and counts) per NESTED cell;
- ``refine_cell_candidates``: the same lists, and the brute-force
  superset check of test_runners.py::test_refine_candidates_superset;
- the plain pass (``ops.cellmajor_cuda.cellmajor_pass_reference``, what
  CPU tensors take) against ``cellmajor_offsets_pass`` on one bucket, to
  1e-12 of max|offset|, with and without ``use_rdelta``, and against
  ``cellmajor_paint_pass`` on a table with -inf nodes and a halo outside
  the table's grid, to rtol 1e-10;
- ``BaryonifyShell(method="cellmajor")`` on the ``shell_setup`` inputs of
  test_runners.py: rms/mean < 1e-10 against the JAX cell-major run (the
  port's own table and the JAX table carried across), and the JAX tests'
  bar (atol 1e-6 max|change|, rtol 1e-6) against the port's scatter run;
  forced refinement and ``low_memory`` as in test_runners.py;
- ``PaintProfilesShell(method="cellmajor")`` against JAX to rtol 1e-10;
- ``cellmajor_pass`` refuses bad inputs on the CPU, where it runs the
  plain version and counts no launch.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import baryonification_tpu as J
import baryonification_tpu_torch as T
from baryonification_tpu.ops import healpix as jhpx
from baryonification_tpu.runners import shell_cellmajor as jcm
from baryonification_tpu.runners import shell_gather as jsg
from baryonification_tpu.runners.shell import _pack_from_angles as j_pack
from baryonification_tpu_torch.ops import cellmajor_cuda
from baryonification_tpu_torch.ops import healpix as thpx
from baryonification_tpu_torch.runners import shell_cellmajor as tcm
from baryonification_tpu_torch.runners.shell import DefaultRunner

from test_profiles import PAR
from test_runners import COSMO_DICT

torch.set_num_threads(1)

TABLE_GRID = dict(z_min=0.05, z_max=0.6, N_samples_z=4,
                  M_min=1e13, M_max=1e15, N_samples_Mass=6,
                  R_min=1e-3, R_max=70, N_samples_R=64)
EPS = 20.0


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _cell_lists(dense, counts, nc):
    dense = np.asarray(dense).reshape(nc, -1)
    counts = np.asarray(counts)
    return [dense[c, :counts[c]].tolist() for c in range(nc)]


# ----- pixel ids -----

@pytest.mark.parametrize("nside", [1, 2, 8, 64])
def test_nest_ring_conversions_exact(nside):
    p = np.arange(jhpx.npix(nside))
    np.testing.assert_array_equal(
        thpx.nest2ring(nside, torch.tensor(p)).numpy(),
        jhpx.nest2ring(nside, p))
    np.testing.assert_array_equal(
        thpx.ring2nest(nside, torch.tensor(p)).numpy(),
        jhpx.ring2nest(nside, p))
    np.testing.assert_array_equal(thpx.nest2ring_all(nside, "cpu").numpy(),
                                  np.asarray(jhpx.nest2ring_all(nside)))
    assert thpx.nside2resol(nside) == jhpx.nside2resol(nside)


# ----- registration and candidate lists -----

@pytest.fixture(scope="module")
def discs():
    """40 discs of radius 0.05-0.25 rad (test_refine_candidates_superset)."""
    rng = np.random.default_rng(3)
    H = 40
    return (np.arccos(rng.uniform(-1, 1, H)), rng.uniform(0, 2 * np.pi, H),
            rng.uniform(0.05, 0.25, H))


def _jax_registration(nsc, theta, phi, radius):
    cmap = jnp.asarray(jhpx.ring2nest(nsc, np.arange(jhpx.npix(nsc))),
                       dtype=jnp.int32)
    hids, cell_start, K = jsg.coarse_halo_index(
        nsc, jnp.asarray(theta), jnp.asarray(phi), jnp.asarray(radius),
        dtype=jnp.float64, r_max=float(radius.max()), cell_map=cmap)
    K_pad = max(64, -(-int(K) // 64) * 64)
    dense, counts = jcm.dense_cell_candidates(jhpx.npix(nsc), K_pad, hids,
                                              cell_start)
    return dense, counts, int(K)


def _port_registration(nsc, theta, phi, radius):
    hids, cell_start, K = tcm.coarse_halo_index(
        nsc, _t(theta), _t(phi), _t(radius), r_max=float(radius.max()),
        cell_map=thpx.ring2nest(nsc, torch.arange(thpx.npix(nsc))))
    dense, counts = tcm.dense_cell_candidates(thpx.npix(nsc), max(K, 1),
                                              hids, cell_start)
    return dense, counts, K


@pytest.mark.parametrize("nsc", [2, 4])
def test_registration_matches_jax(nsc, discs):
    """The same candidate list, in the same order, in every NESTED cell."""
    want_d, want_c, want_K = _jax_registration(nsc, *discs)
    got_d, got_c, got_K = _port_registration(nsc, *discs)
    assert got_K == want_K > 0
    assert got_d.dtype == got_c.dtype == torch.int32
    nc = thpx.npix(nsc)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert _cell_lists(got_d, got_c, nc) == _cell_lists(want_d, want_c, nc)


def _hrec(theta, phi, radius, nsc):
    st = np.sin(theta)
    reach = radius + jsg.MARGIN * jhpx.nside2resol(nsc)
    return np.stack([st * np.cos(phi), st * np.sin(phi), np.cos(theta),
                     np.cos(reach)], axis=-1)


def test_refine_candidates_match_jax_and_superset(discs):
    """Refined child lists: the same as the JAX package's, and supersets
    of the halos that reach any fine pixel of the child cell."""
    theta, phi, radius = discs
    nside, nsc_p, nsc_c = 64, 4, 8
    jd, jc, _ = _jax_registration(nsc_p, *discs)
    td, tc, _ = _port_registration(nsc_p, *discs)
    rt = jhpx.RingTables(nsc_c, dtype=jnp.float64)
    cv = jhpx.pixel_planes_device(nsc_c, rt.z, rt.start, rt.npr, rt.shift,
                                  p=jhpx.nest2ring_all(nsc_c))
    hrec = _hrec(theta, phi, radius, nsc_c)
    jd_c, jc_c, jK = jcm.refine_cell_candidates(
        jhpx.npix(nsc_c), jd, jc, *cv,
        jnp.asarray(np.concatenate([hrec, np.zeros((len(theta), 4))], 1)))
    # a small chunk budget: the port's chunk loop is walked too
    td_c, tc_c, tK = tcm.refine_cell_candidates(
        thpx.npix(nsc_c), td, tc, *(_t(v) for v in cv), _t(hrec),
        cell_budget=64 * 8)
    nc = thpx.npix(nsc_c)
    assert tK == int(jK)
    np.testing.assert_array_equal(tc_c.numpy(), np.asarray(jc_c))
    got = _cell_lists(td_c, tc_c, nc)
    assert got == _cell_lists(jd_c, jc_c, nc)

    f = nside // nsc_c
    n2r_f = np.asarray(jhpx.nest2ring_all(nside))
    th_f, ph_f = map(np.asarray,
                     jhpx.pix2ang(nside, jnp.arange(jhpx.npix(nside))))
    vf = np.stack([np.sin(th_f) * np.cos(ph_f), np.sin(th_f) * np.sin(ph_f),
                   np.cos(th_f)], axis=-1)
    missing = 0
    for c in range(nc):
        fine = vf[n2r_f[c * f * f:(c + 1) * f * f]]
        reach_h = np.where((fine @ hrec[:, :3].T
                            >= np.cos(radius)[None, :]).any(axis=0))[0]
        missing += len(set(reach_h.tolist()) - set(got[c]))
    assert missing == 0


# ----- the pass on one bucket -----

@pytest.fixture(scope="module")
def shell_inputs():
    """The shell_setup recipe of test_runners.py (NSIDE 32, 25 halos),
    plus one halo at z = 0.9, outside the tables' z range."""
    nside = 32
    rng = np.random.default_rng(11)
    n_halo = 25
    ra = rng.uniform(0, 360, n_halo)
    dec = np.degrees(np.arcsin(rng.uniform(-0.8, 0.8, n_halo)))
    M = 10 ** rng.uniform(13.6, 14.8, n_halo)
    z = rng.uniform(0.15, 0.45, n_halo)
    mass_map = rng.uniform(0.5, 1.5, jhpx.npix(nside))
    halos = dict(ra=ra, dec=dec, M=M, z=z)
    extra = dict(ra=np.append(ra, 40.0), dec=np.append(dec, 10.0),
                 M=np.append(M, 3e14), z=np.append(z, 0.9))
    return halos, extra, mass_map


@pytest.fixture(scope="module")
def jax_model(cosmo):
    model = J.Baryonification2D(J.DarkMatterOnly(**PAR),
                                J.DarkMatterBaryon(**PAR), cosmo,
                                epsilon_max=EPS)
    model.setup_interpolator(**TABLE_GRID)
    return model


@pytest.fixture(scope="module")
def bucket(shell_inputs, cosmo):
    """One bucket at NSIDE 32 on NESTED cells of nside_c 8 (F = 16): the
    halos (with the one outside the grid), their packed records, the
    JAX package's candidate lists and the NESTED pixel planes."""
    nside, nsc = 32, 8
    _, h, _ = shell_inputs
    theta, phi = map(np.asarray, jhpx.radec2ang(h['ra'], h['dec']))
    a = 1.0 / (1.0 + h['z'])
    mdef = J.MassDef(200, 'critical')
    R = np.asarray(mdef.get_radius(cosmo, h['M'], a))
    D = np.asarray(cosmo.angular_diameter_distance(a))
    radius = EPS * R / D
    packed = np.asarray(j_pack(jnp.asarray(theta), jnp.asarray(phi),
                               jnp.asarray(D), jnp.asarray(a),
                               jnp.asarray(R / a), jnp.asarray(h['M']),
                               jnp.zeros((len(a), 0))))
    dense, counts, K = _jax_registration(nsc, theta, phi, radius)
    rt = jhpx.RingTables(nside, dtype=jnp.float64)
    pix = jhpx.pixel_planes_device(nside, rt.z, rt.start, rt.npr, rt.shift,
                                   p=jhpx.nest2ring_all(nside))
    assert int(np.asarray(counts).max()) == K > 1
    return dict(nside=nside, F=(nside // nsc) ** 2, packed=packed,
                dense=dense, counts=counts, pix=pix,
                rcm_max=float((R / a).max()))


def _port_pass(mode, bucket, grids, table, fill, n_hi, n_planes):
    """The plain pass of the port on the bucket's inputs (the table
    sanitised as the runners do)."""
    tg = tuple(_t(g) for g in grids)
    tt = _t(table)
    tt = torch.where(torch.isfinite(tt), tt, fill)
    packed = _t(bucket['packed'])
    planes = tuple(torch.zeros(len(bucket['pix'][0]), dtype=torch.float64)
                   for _ in range(n_planes))
    g2 = tg[2]
    before = cellmajor_cuda.LAUNCHES["cellmajor_pass"]
    cellmajor_cuda.cellmajor_pass(
        mode, planes, tuple(_t(p) for p in bucket['pix']),
        _t(bucket['dense'], torch.int32), _t(bucket['counts'], torch.int32),
        bucket['F'], tcm.slot_records(packed, EPS),
        tcm.halo_rows(tg, tt, packed, n_hi), float(g2[0]),
        float(g2[1] - g2[0]), float(g2[n_hi - 1]))
    # CPU tensors take the plain version, never the kernel
    assert cellmajor_cuda.LAUNCHES["cellmajor_pass"] == before
    return [p.numpy() for p in planes]


@pytest.mark.parametrize("use_rdelta", [False, True])
def test_offsets_pass_matches_jax(use_rdelta, bucket, jax_model):
    grids, table = jax_model._grids, jax_model._table
    g2 = np.asarray(grids[2])
    rad_max = np.log(EPS) if use_rdelta else np.log(EPS * bucket['rcm_max'])
    n_hi = DefaultRunner._node_bound(g2, rad_max, len(g2))
    z = jnp.zeros(len(bucket['pix'][0]))
    want = jcm.cellmajor_offsets_pass(
        use_rdelta, bucket['F'], 64, n_hi, *bucket['pix'], bucket['dense'],
        bucket['counts'], jnp.asarray(bucket['packed']), grids[0], grids[1],
        table, grids[2], EPS, z, z, z)
    got = _port_pass("offsets_rdelta" if use_rdelta else "offsets", bucket,
                     grids, table, 0.0, n_hi, 3)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    assert scale > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                   atol=1e-12 * scale)


def test_paint_pass_matches_jax(bucket):
    """A smooth log-profile table with -inf nodes (zero profile) at the
    outer radii of two mass rows, and a halo outside the z range: both
    packages paint the same, and the -inf nodes paint less."""
    nz, nm, nr = 4, 6, 48
    gz = np.log1p(np.linspace(0.05, 0.6, nz))
    gm = np.log(np.geomspace(1e13, 1e15, nm))
    gr = np.linspace(np.log(1e-3), np.log(70.0), nr)
    table = (0.5 * (gm[None, :, None] - 30.0) - 0.3 * gz[:, None, None]
             - 2.0 * np.log1p(np.exp(gr)[None, None, :] / 0.3))
    table_inf = table.copy()
    table_inf[:, 2:4, 30:] = -np.inf
    g2 = gr
    n_hi = DefaultRunner._node_bound(g2, np.log(EPS * bucket['rcm_max']),
                                     nr)
    jgrids = tuple(jnp.asarray(g) for g in (gz, gm, gr))
    out = {}
    for name, tab in (("full", table), ("inf", table_inf)):
        want = np.asarray(jcm.cellmajor_paint_pass(
            bucket['F'], 64, n_hi, *bucket['pix'], bucket['dense'],
            bucket['counts'], jnp.asarray(bucket['packed']), *jgrids[:2],
            jnp.asarray(tab), jgrids[2], EPS,
            jnp.zeros(len(bucket['pix'][0]))))
        got, = _port_pass("paint", bucket, (gz, gm, gr), tab, -1e30, n_hi, 1)
        assert np.isfinite(got).all() and got.max() > 0
        np.testing.assert_allclose(got, want, rtol=1e-10,
                                   atol=1e-10 * want.max())
        out[name] = got
    assert out["inf"].sum() < out["full"].sum()


def test_halo_outside_grid_adds_nothing(bucket, jax_model):
    """The halo outside the table's z range has NaN rows (no JAX
    in-bounds flag is needed): dropping it from the candidate lists
    leaves the offsets unchanged."""
    grids, table = jax_model._grids, jax_model._table
    g2 = np.asarray(grids[2])
    n_hi = DefaultRunner._node_bound(g2, np.log(EPS * bucket['rcm_max']),
                                     len(g2))
    out_id = len(bucket['packed']) - 1
    rows = tcm.halo_rows(tuple(_t(g) for g in grids), _t(table),
                         _t(bucket['packed']), n_hi)
    assert torch.isnan(rows[out_id]).all() and torch.isfinite(
        rows[:out_id]).all()
    dense = np.asarray(bucket['dense']).reshape(len(bucket['counts']), -1)
    counts = np.asarray(bucket['counts'])
    assert (dense == out_id).any()
    kept = [[h for h in row[:c] if h != out_id]
            for row, c in zip(dense, counts)]
    dense2 = np.zeros_like(dense)
    for c, ids in enumerate(kept):
        dense2[c, :len(ids)] = ids
    b2 = dict(bucket, dense=dense2.reshape(-1),
              counts=np.array([len(k) for k in kept], np.int32))
    got = _port_pass("offsets", bucket, grids, table, 0.0, n_hi, 3)
    want = _port_pass("offsets", b2, grids, table, 0.0, n_hi, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ----- the runners -----

def _runner(pkg, halos, mass_map, model, **kw):
    cat = pkg.HaloLightConeCatalog(cosmo=COSMO_DICT, **halos)
    shell = pkg.LightconeShell(map=mass_map, cosmo=COSMO_DICT)
    return pkg.BaryonifyShell(cat, shell, epsilon_max=EPS, model=model,
                              verbose=False, **kw)


def _rms(got, want, mass_map):
    return np.sqrt(np.mean((got - want) ** 2)) / mass_map.mean()


def _agree(got, want, mass_map):
    """The JAX tests' bar between two methods (test_runners.py:140-151)."""
    assert np.isclose(got.sum(), mass_map.sum(), rtol=1e-8)
    scale = np.abs(want - mass_map).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, atol=1e-6 * scale, rtol=1e-6)


def _port_model(carry, jax_model):
    model = T.Baryonification2D(
        T.DarkMatterOnly(**PAR), T.DarkMatterBaryon(**PAR),
        T.Cosmology.from_dict(COSMO_DICT, device="cpu"), epsilon_max=EPS)
    if carry == "own":
        return model.setup_interpolator(**TABLE_GRID) or model
    return model.from_arrays([np.asarray(g) for g in jax_model._grids],
                             np.asarray(jax_model._table),
                             jax_model.Rdelta_sampling, jax_model.p_keys)


@pytest.fixture(scope="module")
def jax_cellmajor_map(shell_inputs, jax_model):
    halos, _, mass_map = shell_inputs
    return np.asarray(_runner(J, halos, mass_map, jax_model,
                              method="cellmajor").process())


@pytest.fixture(scope="module")
def port_scatter_map(shell_inputs, jax_model):
    halos, _, mass_map = shell_inputs
    return _runner(T, halos, mass_map, _port_model("carried", jax_model),
                   device="cpu", method="scatter").process()


@pytest.mark.parametrize("carry", ["own", "carried"])
def test_baryonify_cellmajor_matches_jax(carry, shell_inputs, jax_model,
                                         jax_cellmajor_map,
                                         port_scatter_map):
    halos, _, mass_map = shell_inputs
    runner = _runner(T, halos, mass_map, _port_model(carry, jax_model),
                     device="cpu", method="cellmajor")
    assert runner.method == "cellmajor" and runner.dtype == torch.float64
    runner.profile = True
    got = runner.process()
    assert _rms(got, jax_cellmajor_map, mass_map) < 1e-10
    _agree(got, port_scatter_map, mass_map)
    labels = [k.split("[")[0] for k, _ in runner.stage_times]
    assert labels == ["halo_arrays", "packed_records", "pixels_nested",
                      "reg", "pass", "regrid", "fetch_map"]


def test_baryonify_rdelta_cellmajor_matches_jax_and_scatter(shell_inputs,
                                                            cosmo):
    """A table on the r / R_Delta axis (Rdelta_sampling) carried across:
    the cell-major run subtracts ln R_com in the pass."""
    halos, _, mass_map = shell_inputs
    jm = J.Baryonification2D(J.DarkMatterOnly(**PAR),
                             J.DarkMatterBaryon(**PAR), cosmo,
                             epsilon_max=EPS)
    jm.setup_interpolator(z_min=0.1, z_max=0.6, N_samples_z=2, M_min=1e13,
                          M_max=1e15, N_samples_Mass=4, R_min=1e-2, R_max=30,
                          N_samples_R=48, Rdelta_sampling=True)
    want = np.asarray(_runner(J, halos, mass_map, jm,
                              method="cellmajor").process())
    tm = _port_model("carried", jm)
    assert tm.Rdelta_sampling
    got = _runner(T, halos, mass_map, tm, device="cpu",
                  method="cellmajor").process()
    assert _rms(got, want, mass_map) < 1e-10
    _agree(got, _runner(T, halos, mass_map, tm, device="cpu",
                        method="scatter").process(), mass_map)


def _clustered_shell(nside, seed):
    rng = np.random.default_rng(seed)
    n_halo = 30 if seed == 5 else 25
    halos = dict(ra=rng.uniform(0, 360, n_halo),
                 dec=np.degrees(np.arcsin(rng.uniform(-0.9, 0.9, n_halo))),
                 M=10 ** rng.uniform(14.5, 14.95, n_halo),
                 z=rng.uniform(0.06, 0.15, n_halo))
    return halos, rng.uniform(0.5, 1.5, thpx.npix(nside))


def test_refined_cellmajor_matches_scatter(jax_model):
    """Forced refinement (refine_k_min = 1) at NSIDE 128: some bucket
    runs finer than its registration, and the map still agrees with the
    scatter method (test_baryonify_cellmajor_refined_agrees)."""
    halos, mass_map = _clustered_shell(128, 5)
    model = _port_model("carried", jax_model)
    runner = _runner(T, halos, mass_map, model, device="cpu",
                     method="cellmajor")
    runner.refine_k_min = 1
    got = runner.process()
    assert any(nsc_eff > nsc for (_, nsc, _), (_, _, _, nsc_eff)
               in runner._dense_cache.items())
    _agree(got, _runner(T, halos, mass_map, model, device="cpu",
                        method="scatter").process(), mass_map)


def test_low_memory_is_bit_identical(jax_model):
    """low_memory with a 0-byte threshold caches no candidate matrix and
    gives the same bits as the default, over two calls."""
    halos, mass_map = _clustered_shell(64, 11)
    model = _port_model("carried", jax_model)
    r_def = _runner(T, halos, mass_map, model, device="cpu",
                    method="cellmajor")
    m_def = r_def.process()
    r_lm = _runner(T, halos, mass_map, model, device="cpu",
                   method="cellmajor")
    r_lm.low_memory = True
    r_lm.low_memory_bytes = 0
    m_lm = r_lm.process()
    assert len(r_lm._dense_cache) == 0 and len(r_def._dense_cache) > 0
    np.testing.assert_array_equal(m_lm, m_def)
    np.testing.assert_array_equal(r_lm.process(), m_def)


@pytest.fixture(scope="module")
def gas_tables(cosmo):
    """TabulatedProfile(Gas) of test_paint_cellmajor_agrees, built by the
    JAX package and carried into the port's TabulatedProfile."""
    gas = J.TabulatedProfile(J.Gas(**PAR), cosmo)
    gas.setup_interpolator(z_min=0.05, z_max=0.6, N_samples_z=4,
                           M_min=1e13, M_max=1e15, N_samples_Mass=6,
                           R_min=1e-3, R_max=70, N_samples_R=48)
    tt = T.TabulatedProfile(T.Gas(**PAR),
                            T.Cosmology.from_dict(COSMO_DICT, device="cpu"))
    tt._grids = tuple(_t(g) for g in gas._grids)
    tt._ln2D = _t(gas._ln2D)
    return gas, tt


def test_paint_cellmajor_matches_jax(shell_inputs, gas_tables):
    halos, _, mass_map = shell_inputs
    gj, gt = gas_tables

    def paint(pkg, tab, **kw):
        cat = pkg.HaloLightConeCatalog(cosmo=COSMO_DICT, **halos)
        shell = pkg.LightconeShell(map=mass_map, cosmo=COSMO_DICT)
        return pkg.PaintProfilesShell(cat, shell, epsilon_max=5, model=tab,
                                      verbose=False, **kw)

    want = np.asarray(paint(J, gj, method="cellmajor").process())
    runner = paint(T, gt, method="cellmajor", device="cpu")
    runner.profile = True
    got = runner.process()
    assert got.max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10 * want.max())
    labels = [k.split("[")[0] for k, _ in runner.stage_times]
    assert labels == ["halo_arrays", "packed_records", "pixels_nested",
                      "reg", "pass", "n2r", "fetch_map"]
    p_sc = paint(T, gt, method="scatter", device="cpu").process()
    np.testing.assert_allclose(got, p_sc, rtol=1e-6, atol=1e-9 * p_sc.max())


# ----- the wrapper's checks, on the CPU -----

def _tiny_bucket():
    """One bucket on NSIDE 2 pixels (12 cells of F = 4), 3 halos listed
    in every cell, rows of 8 nodes: (planes, pix, dense, counts, F, recs,
    rows, g0, dg, rad_hi) for ``cellmajor_pass`` in paint mode."""
    rng = np.random.default_rng(5)
    v = rng.normal(size=(48, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    recs = np.concatenate([v[:3], np.full((3, 1), 0.5), np.ones((3, 2)),
                           np.full((3, 1), 1e30), np.zeros((3, 1))], axis=1)
    return ((_t(np.zeros(48)),), tuple(_t(v[:, i]) for i in range(3)),
            _t(np.tile(np.arange(3), 12), torch.int32),
            _t(np.full(12, 3), torch.int32), 4, _t(recs),
            _t(rng.normal(size=(3, 8))), -3.0, 0.5, 0.5)


BAD_INPUTS = {
    "mode": (lambda a: ("bogus",) + a[1:], ValueError, "mode must be"),
    "planes": (lambda a: ("offsets",) + a[1:], ValueError, "output planes"),
    "dtype": (lambda a: ("paint", (a[1][0].half(),)) + a[2:], TypeError,
              "float32 or float64"),
    "dense": (lambda a: a[:3] + (a[3].long(),) + a[4:], TypeError, "int32"),
    "F": (lambda a: a[:5] + (8,) + a[6:], ValueError, "cells of F"),
    "recs": (lambda a: a[:6] + (a[6][:, :7],) + a[7:], ValueError,
             "recs must be"),
    "rows": (lambda a: a[:7] + (a[7][:2],) + a[8:], ValueError,
             "rows must be"),
}


@pytest.mark.parametrize("bad", list(BAD_INPUTS))
def test_cellmajor_pass_refuses_bad_inputs_on_cpu(bad):
    """The wrapper's argument checks hold on the CPU too (the card's are
    test_torch_cuda.py::test_cellmajor_refuses_bad_inputs); a refused
    call adds nothing and counts no launch, and the same call with good
    inputs runs the plain version in place, counting no launch."""
    good = ("paint",) + _tiny_bucket()
    edit, err, match = BAD_INPUTS[bad]
    before = cellmajor_cuda.LAUNCHES["cellmajor_pass"]
    with pytest.raises(err, match=match):
        cellmajor_cuda.cellmajor_pass(*edit(good))
    assert float(good[1][0].abs().max()) == 0.0
    out = cellmajor_cuda.cellmajor_pass(*good)
    assert out[0] is good[1][0] and float(out[0].max()) > 0
    assert cellmajor_cuda.LAUNCHES["cellmajor_pass"] == before
