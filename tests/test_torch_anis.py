"""The port's ``PaintProfilesAnisGrid`` against the JAX package's.

float64 on the CPU. tests/test_runners.py's ``anis_setup`` inputs (:1068:
32^2 pixels, L = 60, 8 halos, seed 7, a TabulatedProfile(Gas) painted on a
TabulatedProfile(DarkMatter) canvas, 12 mass nodes), the JAX tables
carried across with ``from_arrays``; the JAX values are computed once per
module.

- the host remap table: JAX's sentinel pattern (degenerate nodes at
  -1e30 / +1e30), then the other entries to 1e-10. Both sort each node's
  points by ln Canvas (the port stably, with masked points sorted last and
  exact ties broken by 1e-12 steps); with no tied canvas values in these
  profiles the two agree to rounding;
- ``process()`` of each method against JAX's same method: the same
  touched pixels and rms/max < 1e-10;
- the port's two methods against each other at the JAX tests' bars:
  masses on the nodes (the same touched set, < 1e-3), blended masses
  (< 2e-2 max, < 5e-3 rms), and 24 halos in 2 buckets (no pixel painted
  outside a halo's own cutout);
- ``process_device()`` equal to the cell-major ``process()`` bit for bit,
  with the defaults and with explicit remap and canvas;
- ``build_remap_device`` against JAX's (the same sentinels, 1e-8), and
  through the pass within 1e-7 of the map's max of ``process()``;
- the identity remap (Paint == Canvas), an empty catalog, a
  ParamTabulatedProfile with one prop axis against JAX's cell-major map,
  and the refusal of more prop axes than the packed records hold.
"""

import numpy as np
import pytest
import torch

import baryonification_tpu as J
import baryonification_tpu_torch as T
from baryonification_tpu.runners import PaintProfilesAnisGrid as JAnis

from test_profiles import PAR

torch.set_num_threads(1)

COSMO = dict(Omega_m=0.3, Omega_b=0.05, h=0.7, sigma8=0.8, n_s=0.96,
             w0=-1.0)
TAB = dict(z_min=0.05, z_max=0.6, N_samples_z=4, M_min=1e13, M_max=1e15,
           N_samples_Mass=12, R_min=1e-3, R_max=70, N_samples_R=48)
METHODS = ("cellmajor", "scatter")
A_SCALE = 1.0 / 1.25


def _cpu_cosmo():
    return T.Cosmology(**COSMO, device="cpu")


def _carry(jm, tmodel, p_keys=None):
    """The JAX table ``jm`` installed in the port's ``tmodel``."""
    args = ([np.asarray(g) for g in jm._grids], np.asarray(jm._ln3D),
            np.asarray(jm._ln2D))
    return (tmodel.from_arrays(*args) if p_keys is None
            else tmodel.from_arrays(*args, p_keys))


def _inputs(pkg, seed=7, n_h=8, lo=5.0, hi=55.0, lgM=(13.5, 14.8), M=None,
            **cols):
    """anis_setup's catalog and canvas map, drawn in its order."""
    rng = np.random.default_rng(seed)
    N, L = 32, 60.0
    bins = (np.arange(N) + 0.5) * (L / N)
    x, y = rng.uniform(lo, hi, n_h), rng.uniform(lo, hi, n_h)
    Ms = 10 ** rng.uniform(*lgM, n_h) if M is None else M
    cat = pkg.HaloNDCatalog(x=x, y=y, z=np.zeros(n_h), M=Ms, redshift=0.25,
                            cosmo=COSMO, **cols)
    gm = pkg.GriddedMap(map=10 ** rng.uniform(12.0, 14.0, (N, N)),
                        redshift=0.25, bins=bins, cosmo=COSMO)
    return cat, gm


@pytest.fixture(scope="module")
def models(cosmo):
    jp = J.TabulatedProfile(J.Gas(**PAR), cosmo)
    jp.setup_interpolator(**TAB)
    jc = J.TabulatedProfile(J.DarkMatter(**PAR), cosmo)
    jc.setup_interpolator(**TAB)
    tc = _cpu_cosmo()
    return dict(jp=jp, jc=jc,
                tp=_carry(jp, T.TabulatedProfile(T.Gas(**PAR), tc)),
                tc=_carry(jc, T.TabulatedProfile(T.DarkMatter(**PAR), tc)))


def _runners(models, method, **kw):
    """(JAX runner, port runner) on anis_setup's inputs (or ``kw``'s)."""
    inp = {k: kw.pop(k) for k in ("seed", "n_h", "lo", "hi", "lgM", "M")
           if k in kw}
    jcat, jgm = _inputs(J, **inp)
    tcat, tgm = _inputs(T, **inp)
    args = dict(epsilon_max=3, verbose=False, method=method, **kw)
    return (JAnis(jcat, jgm, Painting_model=models["jp"],
                  Canvas_model=models["jc"], **args),
            T.PaintProfilesAnisGrid(tcat, tgm, Painting_model=models["tp"],
                                    Canvas_model=models["tc"], device="cpu",
                                    **args))


@pytest.fixture(scope="module")
def staged(models):
    """Every method's JAX and port runners and maps, on anis_setup."""
    out = {}
    for method in METHODS:
        jr, tr = _runners(models, method)
        out[method] = (jr, tr, np.asarray(jr.process()), tr.process())
    return out


def _sentinels_then(want, got, atol):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape
    np.testing.assert_array_equal(want <= -1e29, got <= -1e29)
    np.testing.assert_array_equal(want >= 1e29, got >= 1e29)
    ok = (want > -1e29) & (want < 1e29)
    assert ok.sum() > 100
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=atol)


def _rms_max(a, b):
    return np.sqrt(np.mean((a - b) ** 2)) / np.abs(b).max()


def test_remap_table_matches_jax(staged):
    jr, tr, _, _ = staged["cellmajor"]
    j = jr._anis_remap_table(J.Cosmology.from_dict(jr.cosmo), A_SCALE)
    t = tr._anis_remap_table(_cpu_cosmo(), A_SCALE)
    for w, g in zip(j[:2], t[:2]):           # the lnq grid and mass nodes
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-12)
    _sentinels_then(j[3], t[3].numpy(), 1e-10)


@pytest.mark.parametrize("method", METHODS)
def test_process_matches_jax(staged, method):
    _, tr, jm, tm = staged[method]
    assert tr.method == method and tm.dtype == np.float64
    assert (jm != 0).sum() > 20
    np.testing.assert_array_equal(jm != 0, tm != 0)
    assert _rms_max(tm, jm) < 1e-10


def _methods(models, **kw):
    maps = []
    for method in METHODS:
        _, tr = _runners(models, method, **kw)
        maps.append(tr.process())
    cm, host = maps
    b_h, b_c = host != 0, cm != 0
    rel = np.abs(cm[b_h] / host[b_h] - 1)
    return b_h, b_c, rel


def test_methods_agree_at_mass_nodes(models):
    """Masses on the remap's nodes: no mass blend, so the two methods
    differ only by the ln Canvas resampling."""
    gM = models["tp"]._grids[1].numpy()
    M = np.exp(gM[np.random.default_rng(0).integers(3, 9, 8)])
    b_h, b_c, rel = _methods(models, M=M)
    assert b_h.sum() > 20
    np.testing.assert_array_equal(b_h, b_c)
    assert rel.max() < 1e-3


def test_methods_agree_blended(models):
    b_h, b_c, rel = _methods(models)
    np.testing.assert_array_equal(b_h, b_c)
    assert rel.max() < 2e-2
    assert np.sqrt((rel ** 2).mean()) < 5e-3


def test_methods_agree_shared_buckets(models):
    """24 halos in 2 buckets: each halo paints only its own cutout window,
    not its bucket's largest."""
    b_h, b_c, rel = _methods(models, seed=11, n_h=24, lo=2.0, hi=58.0,
                             lgM=(13.2, 14.8), n_buckets=2)
    assert b_h.sum() > 50
    assert (b_c & ~b_h).sum() == 0, "pixels painted outside the cutouts"
    np.testing.assert_array_equal(b_h, b_c)
    assert rel.max() < 2e-2
    assert np.sqrt((rel ** 2).mean()) < 5e-3


def test_process_device_matches_process(staged):
    _, tr, _, cm = staged["cellmajor"]
    dev = tr.process_device()
    assert dev.dtype == torch.float64 and dev.shape == cm.shape
    np.testing.assert_array_equal(dev.numpy(), cm)
    remap = tr._anis_remap_table(_cpu_cosmo(), A_SCALE)[3]
    dev2 = tr.process_device(remap=remap.clone(), canvas=torch.as_tensor(
        tr.GriddedMap.map))
    np.testing.assert_array_equal(dev2.numpy(), cm)


def test_build_remap_device_matches_jax(staged):
    jr, tr, _, cm = staged["cellmajor"]
    dev = tr.build_remap_device()
    _sentinels_then(jr.build_remap_device(), dev.numpy(), 1e-8)
    out = tr.process_device(remap=dev).numpy()
    np.testing.assert_allclose(out, cm, rtol=0, atol=1e-7 * np.abs(cm).max())


def test_identity_remap(models):
    """Paint == Canvas: the remap is the identity, so every touched pixel
    of the loop's map holds the map value times the number of cutouts
    covering it (to 1e-6). The cell-major map touches the same pixels and
    reads rows that are clamped at each node's canvas range, on a grid of
    ln Canvas in steps dq: within one step of a range's end it lerps
    between the clamped end and the next node, at most dq/4 off in ln,
    which is its bar. The halo masses sit on the table's mass nodes
    (between two nodes the blend of their rows is the identity only where
    ln v lies inside both nodes' ranges)."""
    rng = np.random.default_rng(12)
    N, L = 64, 100.0
    gM = models["tp"]._grids[1].numpy()
    cat = T.HaloNDCatalog(x=rng.uniform(0, L, 15), y=rng.uniform(0, L, 15),
                          M=np.exp(gM[rng.integers(4, 10, 15)]),
                          redshift=0.25, cosmo=COSMO)
    rng = np.random.default_rng(3)
    gm = T.GriddedMap(map=10 ** rng.uniform(12.5, 13.5, (N, N)),
                      redshift=0.25, bins=(np.arange(N) + 0.5) * (L / N),
                      cosmo=COSMO)
    touched = None
    for method in ("scatter", "cellmajor"):
        r = T.PaintProfilesAnisGrid(
            cat, gm, epsilon_max=3, Painting_model=models["tp"],
            Canvas_model=models["tp"], verbose=False, method=method,
            device="cpu")
        painted = r.process()
        rtol = 1e-6
        if method == "cellmajor":
            lnq = r._anis_remap_table(_cpu_cosmo(), A_SCALE)[0]
            rtol = np.expm1((lnq[1] - lnq[0]) / 4)
        if touched is None:
            touched = painted != 0
            assert touched.sum() > 20
        np.testing.assert_array_equal(painted != 0, touched)
        ratio = painted[touched] / gm.map[touched]
        k = np.round(ratio).astype(int)
        assert np.all(k >= 1)
        np.testing.assert_allclose(ratio, k, rtol=rtol)


def test_empty_catalog(models):
    _, gm = _inputs(T)
    cat = T.HaloNDCatalog(x=np.zeros(0), y=np.zeros(0), M=np.zeros(0),
                          redshift=0.25, cosmo=COSMO)
    for method in METHODS:
        r = T.PaintProfilesAnisGrid(cat, gm, epsilon_max=3,
                                    Painting_model=models["tp"],
                                    Canvas_model=models["tc"], verbose=False,
                                    method=method, device="cpu")
        np.testing.assert_array_equal(r.process(), np.zeros((32, 32)))
        dev = r.process_device()
        assert dev.shape == (32, 32) and not dev.any()


def test_param_tabulated_one_prop_matches_jax(cosmo):
    """A ParamTabulatedProfile paint and canvas with a theta_ej axis, the
    catalog carrying theta_ej: the cell-major map against JAX's."""
    grid = dict(TAB, N_samples_Mass=6, N_samples_R=32,
                other_params={'theta_ej': np.array([2.0, 4.0, 8.0])})
    tc = _cpu_cosmo()
    ms = []
    for cls in ("Gas", "DarkMatter"):
        jm = J.ParamTabulatedProfile(getattr(J, cls)(**PAR), cosmo)
        jm.setup_interpolator(**grid)
        ms.append((jm, _carry(jm, T.ParamTabulatedProfile(
            getattr(T, cls)(**PAR), tc), jm.p_keys)))
    tej = np.random.default_rng(5).uniform(2.5, 7.5, 8)
    maps = []
    for pkg, k in ((J, 0), (T, 1)):
        cat, gm = _inputs(pkg, theta_ej=tej)
        cls = JAnis if pkg is J else T.PaintProfilesAnisGrid
        kw = {} if pkg is J else dict(device="cpu")
        maps.append(np.asarray(cls(
            cat, gm, epsilon_max=3, Painting_model=ms[0][k],
            Canvas_model=ms[1][k], verbose=False, method="cellmajor",
            **kw).process()))
    jm_, tm_ = maps
    assert (jm_ != 0).sum() > 20
    np.testing.assert_array_equal(jm_ != 0, tm_ != 0)
    assert _rms_max(tm_, jm_) < 1e-10


def test_too_many_prop_axes_raise(models):
    """Five prop axes leave no packed column for the half-window: the
    cell-major method refuses them, as the JAX package's does."""
    tc = _cpu_cosmo()
    g = [m.numpy() for m in models["tp"]._grids]
    keys = [f"p{i}" for i in range(T.runners.grid_cellmajor.MAX_PROPS_ANIS_2D
                                   + 1)]
    shape = tuple(len(x) for x in g) + (2,) * len(keys)
    tab = np.zeros(shape)
    model = T.ParamTabulatedProfile(T.Gas(**PAR), tc).from_arrays(
        g + [np.array([0.0, 1.0])] * len(keys), tab, tab, keys)
    cat, gm = _inputs(T, **{k: np.full(8, 0.5) for k in keys})
    r = T.PaintProfilesAnisGrid(cat, gm, epsilon_max=3, Painting_model=model,
                                Canvas_model=model, verbose=False,
                                method="cellmajor", device="cpu")
    with pytest.raises(AssertionError, match="extra parameter axes"):
        r.process()
