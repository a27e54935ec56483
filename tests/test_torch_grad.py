"""The port's differentiable shell path against the JAX package's.

float64 on the CPU, TestEndToEndGradients' and TestPaintGradients'
staged inputs (tests/test_grad.py:64, :151: NSIDE 32, 25 halos), with
example 14's table grid (3 z x 6 M x 48 r) so that the staged runner
also serves the ln M_c chain; the JAX tables are carried across with
``from_arrays``, so both packages read the same tables:

- ``BaryonifyShell.process_device`` equals ``process()`` bit for bit,
  and JAX's ``process_device`` to rms/mean < 1e-10 (the paint runner's
  likewise);
- d(sum map^2)/d(table scale) against ``jax.grad`` to 1e-8 relative;
- d(chi^2)/d(ln M_c) through ``build_table_device`` and the map
  (example 14's chain) against ``jax.grad`` to 1e-8;
- d(sum paint)/d(ln theta_ej) through ``build_tables_device`` and the
  painted map against ``jax.grad`` to 1e-8;
- the plain adjoint of the cell-major pass (the autograd of
  ``cellmajor_pass_reference``, both modes) by the dot-product test
  <J z, g> = <z, J^T g>, with J z from forward-mode autodiff, to 1e-12;
- the autograd Functions around the pass (what the card runs, with the
  plain entries here) against plain double backward: Hessian-vector
  products through them to 1e-12, and no NaN from the rows of a halo
  outside the table's grid.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import baryonification_tpu as J
import baryonification_tpu_torch as T
from baryonification_tpu.ops import healpix as jhpx
from baryonification_tpu_torch.ops import cellmajor_cuda as cmc
from baryonification_tpu_torch.runners import shell_cellmajor as tcm

from test_profiles import PAR

torch.set_num_threads(1)

COSMO = dict(Omega_m=0.3, Omega_b=0.05, h=0.7, sigma8=0.8, n_s=0.96,
             w0=-1.0)
Z3 = np.geomspace(0.1, 0.5, 3)
M6 = np.geomspace(1e13, 1e15, 6)
R48 = np.geomspace(1e-3, 70, 48)
GRID = dict(z_min=Z3[0], z_max=Z3[-1], N_samples_z=3, M_min=M6[0],
            M_max=M6[-1], N_samples_Mass=6, R_min=R48[0], R_max=R48[-1],
            N_samples_R=48)
PAINT_GRID = dict(z_min=0.05, z_max=0.6, N_samples_z=4, M_min=1e13,
                  M_max=1e15, N_samples_Mass=6, R_min=1e-3, R_max=70,
                  N_samples_R=48)
LN_MC = float(np.log(10 ** 14.1))
LN_MC_TRUE = float(np.log(10 ** 13.8))


def t64(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _catalogs(pkg, nside=32, n=25, seed=11, extra=False):
    rng = np.random.default_rng(seed)
    h = dict(ra=rng.uniform(0, 360, n),
             dec=np.degrees(np.arcsin(rng.uniform(-0.8, 0.8, n))),
             M=10 ** rng.uniform(13.6, 14.8, n), z=rng.uniform(0.15, 0.45, n))
    mass_map = rng.uniform(0.5, 1.5, jhpx.npix(nside))
    if extra:        # one halo at z = 0.9, outside the tables' z range
        h = {k: np.append(v, w) for (k, v), w in
             zip(h.items(), (40.0, 10.0, 3e14, 0.9))}
    return (pkg.HaloLightConeCatalog(cosmo=COSMO, **h),
            pkg.LightconeShell(map=mass_map, cosmo=COSMO))


def _jax_model(cosmo, par=PAR):
    m = J.Baryonification2D(J.DarkMatterOnly(**par), J.DarkMatterBaryon(**par),
                            cosmo, epsilon_max=20)
    m.setup_interpolator(**GRID)
    return m


def _port_model(jm):
    m = T.Baryonification2D(T.DarkMatterOnly(**PAR),
                            T.DarkMatterBaryon(**PAR),
                            T.Cosmology(**COSMO, device="cpu"),
                            epsilon_max=20)
    return m.from_arrays([np.asarray(g) for g in jm._grids],
                         np.asarray(jm._table), jm.Rdelta_sampling,
                         jm.p_keys)


@pytest.fixture(scope="module")
def staged(cosmo):
    jm = _jax_model(cosmo)
    tm = _port_model(jm)
    jr = J.BaryonifyShell(*_catalogs(J), epsilon_max=20, model=jm,
                          method="cellmajor", verbose=False)
    tr = T.BaryonifyShell(*_catalogs(T), epsilon_max=20, model=tm,
                          method="cellmajor", verbose=False, device="cpu")
    return jr, tr, jm, tm


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_process_device_matches_process_and_jax(staged):
    jr, tr, _, _ = staged
    got = tr.process_device()
    assert got.dtype == torch.float64 and not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), tr.process())
    want = np.asarray(jr.process_device())
    mass_map = tr.LightconeShell.map
    rms = np.sqrt(np.mean((got.numpy() - want) ** 2)) / mass_map.mean()
    assert rms < 1e-10


def test_process_device_refuses_scatter(staged):
    _, tr, _, tm = staged
    r = T.BaryonifyShell(tr.HaloLightConeCatalog, tr.LightconeShell,
                         epsilon_max=20, model=tm, verbose=False,
                         device="cpu")
    assert r.method == "scatter"
    with pytest.raises(ValueError, match="cell-major"):
        r.process_device()


def test_grad_wrt_table_scale_matches_jax(staged):
    jr, tr, jm, tm = staged
    jtab = jm._table
    jg = float(jax.grad(lambda s: jnp.sum(jr.process_device(jtab * s)
                                          ** 2))(1.0))
    s = t64(1.0).requires_grad_(True)
    (tg,) = torch.autograd.grad(
        torch.sum(tr.process_device(tm._table * s) ** 2), s)
    assert np.isfinite(float(tg)) and float(tg) != 0
    assert _rel(float(tg), jg) < 1e-8


def test_grad_wrt_lnMc_through_table_build_matches_jax(staged, cosmo):
    """Example 14's chain: chi^2 of the map against a mock at the
    truth, differentiated in ln M_c at a point 0.3 ln10 off."""
    jr, tr, _, _ = staged

    def j_table(lnMc):
        par = dict(PAR)
        par['M_c'] = jnp.exp(lnMc)
        m = J.Baryonification2D(J.DarkMatterOnly(**par),
                                J.DarkMatterBaryon(**par), cosmo,
                                epsilon_max=20)
        return m.build_table_device(Z3, M6, R48).reshape(3, 6, 48)

    tcosmo = T.Cosmology(**COSMO, device="cpu")

    def t_table(lnMc):
        par = dict(PAR)
        par['M_c'] = torch.exp(lnMc)
        m = T.Baryonification2D(T.DarkMatterOnly(**par),
                                T.DarkMatterBaryon(**par), tcosmo,
                                epsilon_max=20)
        return m.build_table_device(Z3, M6, R48).reshape(3, 6, 48)

    j_target = jax.lax.stop_gradient(jr.process_device(
        j_table(jnp.asarray(LN_MC_TRUE))))
    t_target = tr.process_device(t_table(t64(LN_MC_TRUE))).detach()
    jv, jg = jax.value_and_grad(lambda x: jnp.sum(
        (jr.process_device(j_table(x)) - j_target) ** 2) * 1e6)(
            jnp.asarray(LN_MC))
    x = t64(LN_MC).requires_grad_(True)
    tv = torch.sum((tr.process_device(t_table(x)) - t_target) ** 2) * 1e6
    (tg,) = torch.autograd.grad(tv, x)
    assert np.isfinite(float(tg)) and float(tg) != 0
    assert _rel(float(tv.detach()), float(jv)) < 1e-8
    assert _rel(float(tg), float(jg)) < 1e-8


@pytest.fixture(scope="module")
def staged_paint(cosmo):
    from baryonification_tpu.profiles import Gas as JGas
    jgas = J.TabulatedProfile(JGas(**PAR), cosmo)
    jgas.setup_interpolator(**PAINT_GRID)
    tgas = T.TabulatedProfile(T.Gas(**PAR), T.Cosmology(**COSMO,
                                                        device="cpu"))
    tgas.from_arrays([np.asarray(g) for g in jgas._grids],
                     np.asarray(jgas._ln3D), np.asarray(jgas._ln2D))
    jr = J.PaintProfilesShell(*_catalogs(J), epsilon_max=5, model=jgas,
                              method="cellmajor", verbose=False)
    tr = T.PaintProfilesShell(*_catalogs(T), epsilon_max=5, model=tgas,
                              method="cellmajor", verbose=False,
                              device="cpu")
    return jr, tr


def test_paint_device_matches_process_and_jax(staged_paint):
    jr, tr = staged_paint
    got = tr.process_device().numpy()
    np.testing.assert_array_equal(got, tr.process())
    np.testing.assert_allclose(got, np.asarray(jr.process_device()),
                               rtol=1e-10, atol=1e-10 * got.max())


def test_paint_grad_through_build_tables_matches_jax(staged_paint, cosmo):
    """d(sum paint)/d(ln theta_ej) through the projected-profile
    quadrature, the table build and the paint pass's adjoint."""
    from baryonification_tpu.profiles import Gas as JGas
    jr, tr = staged_paint
    zr = np.geomspace(0.05, 0.6, 4)
    Mr = np.geomspace(1e13, 1e15, 6)
    r = np.geomspace(1e-3, 70, 48)

    def jf(ln_tej):
        par = dict(PAR)
        par['theta_ej'] = jnp.exp(ln_tej)
        _, ln2 = J.TabulatedProfile(JGas(**par), cosmo).build_tables_device(
            zr, Mr, r)
        return jnp.sum(jr.process_device(ln2))

    tcosmo = T.Cosmology(**COSMO, device="cpu")

    def tf(ln_tej):
        par = dict(PAR)
        par['theta_ej'] = torch.exp(ln_tej)
        _, ln2 = T.TabulatedProfile(T.Gas(**par),
                                    tcosmo).build_tables_device(zr, Mr, r)
        return torch.sum(tr.process_device(ln2))

    x0 = float(np.log(4.0))
    jv, jg = jax.value_and_grad(jf)(jnp.asarray(x0))
    x = t64(x0).requires_grad_(True)
    tv = tf(x)
    (tg,) = torch.autograd.grad(tv, x)
    assert np.isfinite(float(tg)) and float(tg) != 0
    assert _rel(float(tv.detach()), float(jv)) < 1e-8
    assert _rel(float(tg), float(jg)) < 1e-8


# ----- the pass and its adjoint, on one bucket -----

@pytest.fixture(scope="module")
def bucket(staged):
    """The inputs of the staged runner's buckets, as process() makes
    them, with the halo outside the grid added (its rows are NaN)."""
    _, _, _, tm = staged
    r = T.BaryonifyShell(*_catalogs(T, extra=True), epsilon_max=20,
                         model=tm, method="cellmajor", verbose=False,
                         device="cpu")
    dt = r.dtype
    arrs = r._halo_arrays(T.Cosmology(**COSMO, device="cpu"))
    packed_all = r._packed_records(arrs, dt)
    grids = tm._grids
    g2 = grids[2].numpy()
    out = []
    for bi, (nside_c, jidx, r_b, rcm_max) in enumerate(
            r._cm_groups(arrs, 32)):
        dense, counts, K, nsc = r._dense_candidates(
            bi, nside_c, lambda jidx=jidx: {
                k: arrs[k][jidx] for k in ('theta', 'phi', 'radius')}, r_b)
        packed = packed_all[jidx]
        n_hi = r._node_bound(g2, np.log(20 * rcm_max), len(g2))
        out.append(dict(pix=r._pixels_nested(32, dt), dense=dense,
                        counts=counts, F=(32 // nsc) ** 2,
                        recs=tcm.slot_records(packed, 20.0),
                        packed=packed, n_hi=n_hi, g0=float(grids[2][0]),
                        dg=float(grids[2][1] - grids[2][0]),
                        rad_hi=float(grids[2][n_hi - 1])))
    assert any(torch.isnan(tcm.halo_rows(grids, tm._table, b['packed'],
                                         b['n_hi'])).any() for b in out)
    return out, tm


def _rows(b, tm, mode):
    table = tm._table if mode != "paint" else torch.log(
        tm._table.abs() + 1e-3) - 3.0
    return tcm.halo_rows(tm._grids, table, b['packed'], b['n_hi'])


def _args(b, rows):
    return (b['pix'], b['dense'], b['counts'], b['F'], b['recs'], rows,
            b['g0'], b['dg'], b['rad_hi'])


@pytest.mark.parametrize("mode", ["offsets", "paint"])
def test_plain_adjoint_dot_product(bucket, mode):
    buckets, tm = bucket
    rng = np.random.default_rng(5)
    for b in buckets:
        rows = _rows(b, tm, mode)
        npl = 1 if mode == "paint" else 3
        zeros = tuple(torch.zeros_like(b['pix'][0]) for _ in range(npl))
        g = tuple(t64(rng.normal(size=b['pix'][0].shape)) for _ in
                  range(npl))
        zeta = t64(rng.normal(size=rows.shape))

        def F(r):
            return cmc.cellmajor_pass_reference(
                mode, tuple(z.clone() for z in zeros), *_args(b, r)[:5], r,
                *_args(b, r)[6:])

        _, jz = torch.func.jvp(F, (rows,), (zeta,))
        vjp = cmc.cellmajor_vjp(mode, g, *_args(b, rows))
        assert bool(torch.isfinite(vjp).all())
        lhs = sum(float((a * c).sum()) for a, c in zip(jz, g))
        rhs = float((zeta * vjp).sum())
        assert abs(lhs - rhs) <= 1e-12 * max(abs(rhs), 1e-300), (lhs, rhs)


@pytest.mark.parametrize("mode", ["offsets", "paint"])
def test_pass_functions_match_plain_double_backward(bucket, mode):
    """Hessian-vector products of L = sum_c <w_c, out_c^2> through
    ``cellmajor_pass_diff`` (the autograd Functions, whose entries are the
    plain versions on the CPU) against plain double backward of
    ``cellmajor_pass_reference``; the incoming planes' gradient passes
    through; no NaN reaches the rows' gradients."""
    buckets, tm = bucket
    rng = np.random.default_rng(6)
    for b in buckets:
        base = _rows(b, tm, mode).detach()
        npl = 1 if mode == "paint" else 3
        w = tuple(t64(rng.normal(size=b['pix'][0].shape)) for _ in
                  range(npl))
        v = t64(rng.normal(size=base.shape))
        res = []
        for fn in (cmc.cellmajor_pass_diff, cmc.cellmajor_pass_reference):
            rows = base.clone().requires_grad_(True)
            pin = tuple(torch.full_like(b['pix'][0], 0.5).requires_grad_(True)
                        for _ in range(npl))
            planes = pin if fn is cmc.cellmajor_pass_diff else tuple(
                p.clone() for p in pin)
            out = fn(mode, planes, *_args(b, rows))
            L = sum((wi * o ** 2).sum() for wi, o in zip(w, out))
            gr, *gp = torch.autograd.grad(L, (rows,) + pin,
                                          create_graph=True)
            (hv,) = torch.autograd.grad((gr * v).sum(), rows)
            res.append((gr.detach(), [x.detach() for x in gp], hv))
        (g1, p1, h1), (g2, p2, h2) = res
        assert bool(torch.isfinite(g1).all()) and bool(
            torch.isfinite(h1).all())
        for a, c in ((g1, g2), (h1, h2)) + tuple(zip(p1, p2)):
            assert float((a - c).abs().max()) <= 1e-12 * max(
                float(c.abs().max()), 1e-300)


@pytest.mark.parametrize("mode", ["offsets", "paint"])
def test_plain_adjoint_ranges_add_up(bucket, mode, monkeypatch):
    """The plain adjoint entries take one graph a range of cells; with
    ranges of 64 pixels they give what one range over the whole bucket
    gives."""
    buckets, tm = bucket
    rng = np.random.default_rng(7)
    for b in buckets:
        rows = _rows(b, tm, mode)
        npl = 1 if mode == "paint" else 3
        g = tuple(t64(rng.normal(size=b['pix'][0].shape)) for _ in
                  range(npl))
        u = t64(rng.normal(size=rows.shape))
        whole = (cmc.cellmajor_vjp_reference(mode, g, *_args(b, rows)),
                 cmc.cellmajor_vjp2_reference(mode, g, u, *_args(b, rows)))
        monkeypatch.setattr(cmc, "_GRAD_CHUNK_PIXELS", 64)
        parts = (cmc.cellmajor_vjp_reference(mode, g, *_args(b, rows)),
                 cmc.cellmajor_vjp2_reference(mode, g, u, *_args(b, rows)))
        monkeypatch.undo()
        (d1, (j1, e1)), (d2, (j2, e2)) = whole, parts
        for a, c in ((d1, d2), (e1, e2)) + tuple(zip(j1, j2)):
            assert float(c.abs().max()) > 0
            torch.testing.assert_close(a, c, rtol=1e-12, atol=1e-14)
