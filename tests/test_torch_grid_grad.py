"""The port's differentiable grid path against the JAX package's.

float64 on the CPU. The JAX tables are carried across with
``from_arrays``, so both packages read the same tables; the inputs are
those of tests/test_grad.py's ``TestGridGradients`` (:297; 3D: 8 halos
on 32^3, 2D: 10 halos on 48^2) and ``TestGridPaintGradients`` (:445),
drawn from the same numpy seeds. The JAX values are computed once per
module. This file holds ``BaryonifyGrid`` in 3D, test_torch_grid2d_grad.py
in 2D, test_torch_paint_grad.py ``PaintProfilesGrid`` (each file alone
stays short).

- the scatter-add's backward: the plain version against
  ``_sorted_scatter_bwd`` called directly, sentinel rows included,
  exactly; the autograd of ``scatter_add_accum`` against ``jax.vjp`` of
  the JAX package's; ``jax.vjp`` of ``cic_deposit_2d`` / ``_3d`` in the
  values and the positions to 1e-12 relative;
- ``BaryonifyGrid`` and ``PaintProfilesGrid.process_device``, 2D and 3D,
  both methods: equal to the port's ``process()`` bit for bit, to JAX's
  ``process_device`` to rms/mean < 1e-10 (paint: rms/max), and
  d(sum map^2)/d(table scale) (paint: d(sum map)) against ``jax.grad``
  to 1e-8 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import baryonification_tpu as J
import baryonification_tpu_torch as T
from baryonification_tpu.ops import scatter as jsc
from baryonification_tpu.ops import scatter_pallas as jsp
from baryonification_tpu_torch.ops import scatter as tsc
from baryonification_tpu_torch.ops import scatter_cuda as sc

from test_profiles import PAR

torch.set_num_threads(1)

COSMO = dict(Omega_m=0.3, Omega_b=0.05, h=0.7, sigma8=0.8, n_s=0.96,
             w0=-1.0)
METHODS = ("cellmajor", "scatter")
GRID3 = dict(z_min=0.05, z_max=0.6, N_samples_z=4, M_min=1e13, M_max=1e15,
             N_samples_Mass=6, R_min=1e-3, R_max=70, N_samples_R=64)
PAINT_GRID = dict(GRID3, N_samples_R=48)
Z3 = np.geomspace(0.1, 0.5, 3)
M6 = np.geomspace(1e13, 1e15, 6)
R48 = np.geomspace(1e-3, 70, 48)
GRID2 = dict(z_min=Z3[0], z_max=Z3[-1], N_samples_z=3, M_min=M6[0],
             M_max=M6[-1], N_samples_Mass=6, R_min=R48[0], R_max=R48[-1],
             N_samples_R=48)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _rel(a, b):
    return abs(a - b) / abs(b)


# ----- the scatter-add's backward -----

def _rows(C, npix=300, n=2000, seed=0):
    """Unsorted rows with sentinel rows (idx == npix and beyond), C
    cotangent planes."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, npix, n).astype(np.int32)
    idx[rng.random(n) < 0.15] = npix
    idx[:5] = npix + np.arange(5)
    cts = [rng.normal(size=npix) for _ in range(C)]
    vals = [rng.normal(size=n) for _ in range(C)]
    return npix, idx, cts, vals


@pytest.mark.parametrize("C", [1, 2, 3])
def test_scatter_vjp_matches_sorted_scatter_bwd(C):
    npix, idx, cts, _ = _rows(C, seed=C)
    order = np.argsort(idx, kind="stable")
    idx_s = idx[order]
    ct_acc, _, want = jsp._sorted_scatter_bwd(
        1024, 1024, jnp.asarray(idx_s), tuple(jnp.asarray(g) for g in cts))
    ti = torch.tensor(idx_s)
    got = sc.scatter_add_vjp_reference(tuple(_t(g) for g in cts), ti)
    got_fn = sc.scatter_add_vjp(tuple(_t(g) for g in cts), ti)
    for g, gf, w in zip(got, got_fn, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(gf.numpy(), np.asarray(w))
    for a, g in zip(ct_acc, cts):          # the accumulators pass through
        np.testing.assert_array_equal(np.asarray(a), g)
    assert sc.LAUNCHES["scatter_add_vjp"] == 0


@pytest.mark.parametrize("C", [1, 3])
def test_scatter_add_autograd_matches_jax_vjp(C):
    """Gradients of scatter_add_accum into fresh accumulators (which
    require grad) and the values, against jax.vjp of the JAX package's
    scatter_add_accum; the port's accumulators are updated in place."""
    npix, idx, cts, vals = _rows(C, seed=10 + C)
    rng = np.random.default_rng(C)
    base = [rng.normal(size=npix) for _ in range(C)]
    _, vjp = jax.vjp(
        lambda a, v: jsp.scatter_add_accum(a, jnp.asarray(idx), v),
        tuple(jnp.asarray(b) for b in base),
        tuple(jnp.asarray(v) for v in vals))
    want_a, want_v = vjp(tuple(jnp.asarray(g) for g in cts))
    a_leaf = [_t(b).requires_grad_(True) for b in base]
    v_leaf = [_t(v).requires_grad_(True) for v in vals]
    accs = tuple(a * 1.0 for a in a_leaf)
    out = sc.scatter_add_accum(accs, torch.tensor(idx), tuple(v_leaf))
    assert all(o is a for o, a in zip(out, accs))
    got = torch.autograd.grad(out, a_leaf + v_leaf,
                              tuple(_t(g) for g in cts))
    for g, w in zip(got, list(want_a) + list(want_v)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dim", [2, 3])
def test_cic_deposit_vjp_matches_jax(dim):
    """jax.vjp of cic_deposit_{2d,3d} in the values and the positions
    (positions past both box edges) against the port's autograd, to
    1e-12 of the largest value."""
    rng = np.random.default_rng(dim)
    N, n = 12, 400
    pos = [rng.uniform(-3.0, N + 3.0, n) for _ in range(dim)]
    vals = rng.uniform(0.5, 1.5, n)
    ct = rng.normal(size=(N,) * dim)
    jfn = jsc.cic_deposit_2d if dim == 2 else jsc.cic_deposit_3d
    tfn = tsc.cic_deposit_2d if dim == 2 else tsc.cic_deposit_3d
    jmap, vjp = jax.vjp(lambda v, *p: jfn(N, *p, v), jnp.asarray(vals),
                        *map(jnp.asarray, pos))
    want = vjp(jnp.asarray(ct))
    leaves = [_t(vals).requires_grad_(True)] + [
        _t(p).requires_grad_(True) for p in pos]
    tmap = tfn(N, *leaves[1:], leaves[0])
    np.testing.assert_allclose(tmap.detach().numpy(), np.asarray(jmap),
                               rtol=0, atol=1e-12 * np.abs(jmap).max())
    got = torch.autograd.grad(tmap, leaves, _t(ct))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-12 * np.abs(w).max())


# ----- the runners -----

def _nd(pkg, dim, n_halo, N, L, seed, lgM_hi):
    """TestGridGradients' catalog and uniform(0.5, 1.5) mass map, drawn
    in its order from one generator."""
    rng = np.random.default_rng(seed)
    pos = {c: rng.uniform(0, L, n_halo) for c in "xyz"[:dim]}
    cat = pkg.HaloNDCatalog(M=10 ** rng.uniform(13.9, lgM_hi, n_halo),
                            redshift=0.25, cosmo=COSMO, **pos)
    gm = pkg.GriddedMap(map=rng.uniform(0.5, 1.5, (N,) * dim),
                        redshift=0.25, bins=(np.arange(N) + 0.5) * (L / N),
                        cosmo=COSMO)
    return cat, gm


def _paint_inputs(pkg):
    """TestGridPaintGradients' two catalogs and empty maps, drawn in its
    order from one generator."""
    rng = np.random.default_rng(17)
    L, N = 70.0, 32
    bins = (np.arange(N) + 0.5) * (L / N)
    out = {}
    for dim in (3, 2):
        pos = {c: rng.uniform(0, L, 8) for c in "xyz"[:dim]}
        cat = pkg.HaloNDCatalog(M=10 ** rng.uniform(13.9, 14.7, 8),
                                redshift=0.25, cosmo=COSMO, **pos)
        gm = pkg.GriddedMap(map=np.zeros((N,) * dim), redshift=0.25,
                            bins=bins, cosmo=COSMO)
        out[dim] = (cat, gm)
    return out


def _case(kind, dim, cosmo):
    """(JAX runner maker, port runner maker, JAX table, port table, the
    original map) of one staged case."""
    tc = T.Cosmology(**COSMO, device="cpu")
    if kind == "paint":
        jm = J.TabulatedProfile(J.Gas(**PAR), cosmo)
        jm.setup_interpolator(**PAINT_GRID)
        tm = T.TabulatedProfile(T.Gas(**PAR), tc).from_arrays(
            [np.asarray(g) for g in jm._grids], np.asarray(jm._ln3D),
            np.asarray(jm._ln2D))
        jc, tcat = _paint_inputs(J)[dim], _paint_inputs(T)[dim]
        eps, attr = 5, ('_ln2D' if dim == 2 else '_ln3D')
        cls = "PaintProfilesGrid"
    else:
        if dim == 3:
            mk = lambda pkg: pkg.Baryonification3D(
                pkg.DarkMatterOnly(**PAR), pkg.DarkMatterBaryon(**PAR),
                cosmo if pkg is J else tc, epsilon_max=10)
            grid, eps, args = GRID3, 10, (3, 8, 32, 70.0, 31, 14.7)
        else:
            mk = lambda pkg: pkg.Baryonification2D(
                pkg.DarkMatterOnly(**PAR), pkg.DarkMatterBaryon(**PAR),
                cosmo if pkg is J else tc, epsilon_max=20)
            grid, eps, args = GRID2, 20, (2, 10, 48, 100.0, 13, 14.8)
        jm = mk(J)
        jm.setup_interpolator(**grid)
        tm = mk(T).from_arrays([np.asarray(g) for g in jm._grids],
                               np.asarray(jm._table), jm.Rdelta_sampling,
                               jm.p_keys)
        jc, tcat = _nd(J, *args), _nd(T, *args)
        attr, cls = '_table', "BaryonifyGrid"
    jr = lambda method: getattr(J, cls)(*jc, epsilon_max=eps, model=jm,
                                        method=method, verbose=False)
    tr = lambda method: getattr(T, cls)(*tcat, epsilon_max=eps, model=tm,
                                        method=method, verbose=False,
                                        device="cpu")
    return jr, tr, getattr(jm, attr), getattr(tm, attr), tcat[1].map


def _loss(kind):
    """(the scalar of a map, its derivative in the map)."""
    if kind == "paint":
        # scaling the LOG table: p -> p^s, smooth in s
        return (lambda m: m.sum()), (lambda m: jnp.ones_like(m))
    return (lambda m: (m ** 2).sum()), (lambda m: 2.0 * m)


def stage(cosmo, kind, dims):
    """Each case of ``kind`` ('baryonify' or 'paint') and dimension in
    ``dims``, by (dim, method): the port's runner and table, the original
    map, and the JAX package's map and gradient (one jax.vjp)."""
    out = {}
    for dim in dims:
        jr, tr, jtab, ttab, base = _case(kind, dim, cosmo)
        for method in METHODS:
            r = jr(method)
            jmap, vjp = jax.vjp(lambda s: r.process_device(jtab * s), 1.0)
            (jg,) = vjp(_loss(kind)[1](jmap))
            out[dim, method] = dict(tr=tr(method), ttab=ttab, base=base,
                                    jmap=np.asarray(jmap), jg=float(jg))
    return out


def check_process_device(c, kind):
    """process_device() is process() bit for bit and JAX's to 1e-10."""
    tr = c["tr"]
    got = tr.process_device()
    assert got.dtype == torch.float64 and not got.requires_grad
    assert got.shape == c["jmap"].shape
    np.testing.assert_array_equal(got.numpy(), tr.process())
    if kind == "paint":
        assert float(got.sum()) > 0
        rms = np.sqrt(np.mean((got.numpy() - c["jmap"]) ** 2)) \
            / np.abs(c["jmap"]).max()
    else:
        rms = np.sqrt(np.mean((got.numpy() - c["jmap"]) ** 2)) \
            / c["base"].mean()
    assert rms < 1e-10


def check_grad(c, kind):
    """d(loss)/d(table scale) against jax.grad to 1e-8 relative."""
    s = _t(1.0).requires_grad_(True)
    loss = _loss(kind)[0](c["tr"].process_device(c["ttab"] * s))
    (g,) = torch.autograd.grad(loss, s)
    assert np.isfinite(float(g)) and float(g) != 0
    assert _rel(float(g), c["jg"]) < 1e-8


@pytest.fixture(scope="module")
def staged(cosmo):
    return stage(cosmo, "baryonify", (3,))


@pytest.mark.parametrize("method", METHODS)
def test_process_device_matches_process_and_jax_3d(staged, method):
    check_process_device(staged[3, method], "baryonify")


@pytest.mark.parametrize("method", METHODS)
def test_grad_wrt_table_scale_matches_jax_3d(staged, method):
    check_grad(staged[3, method], "baryonify")
