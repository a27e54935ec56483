"""The port's ``parallel.py`` against ``baryonification_tpu.parallel``.

- The helpers (``cell_chunk``, ``pad_cells_for_mesh``, ``pad_rows``,
  ``min_coarse_nside`` with its ``ValueError``) against the JAX ones over
  a grid of (ncell, ranks, F).
- ``SimpleParallel`` keeps the caller's order; ``SplitJoinParallel``
  sums to one runner's paint, rejects the Baryonify* runners, and its
  shards stage their own catalogs.
- ``mesh=`` on every runner family (``BaryonifyShell`` on a multi-bucket
  catalog, ``PaintProfilesShell``, ``BaryonifyGrid`` and
  ``PaintProfilesGrid`` in 3D and 2D with ellipticity,
  ``BaryonifySnapshot``, ``PaintProfilesAnisGrid``) over 2 and over 3
  gloo ranks on the CPU: ``process()`` and ``process_device()`` against
  the JAX package's single-device ``process()`` on the stub models of
  tests/test_parallel.py (float64, rtol 1e-12, atol 1e-12, its bar), and
  the gradient of a fixed weighting of the output (in the table; for the
  anisotropic paint in the remap and the canvas) against ``jax.grad`` of
  the JAX package's single-device ``process_device`` (rtol 1e-10, atol
  1e-10 max|g|), which is not world-size times it.

The ranks run in processes of their own (``tests/_torch_mesh_ranks.py``,
which imports no JAX), spawned once per world size for the whole file.
"""

import functools

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp

import baryonification_tpu as J
from baryonification_tpu import parallel as JP
import baryonification_tpu_torch as T
from baryonification_tpu_torch import parallel as TP

import _torch_mesh_ranks as MR

torch.set_num_threads(1)

GRAD_CASES = [c for c, (_, _, g) in MR.CASES.items() if g]


# ----- the helpers -----

@pytest.mark.parametrize("ncell,n_dev,F", [
    (64, 3, 512), (512, 5, 64), (7, 6, 8), (4096, 7, 4096), (1, 3, 16),
    (12, 2, 1024), (768, 4, 256), (49152, 3, 16)])
def test_helpers_match_jax(ncell, n_dev, F):
    assert TP.pad_cells_for_mesh(ncell, n_dev, F) == \
        JP.pad_cells_for_mesh(ncell, n_dev, F)
    assert TP.cell_chunk(ncell, F) == JP.cell_chunk(ncell, F)
    ncell_pad, _ = TP.pad_cells_for_mesh(ncell, n_dev, F)
    x = np.arange(ncell * 2, dtype=np.float64).reshape(ncell, 2)
    want = np.asarray(JP.pad_rows(jnp.asarray(x), ncell_pad))
    np.testing.assert_array_equal(TP.pad_rows(x, ncell_pad), want)
    np.testing.assert_array_equal(
        TP.pad_rows(torch.tensor(x), ncell_pad).numpy(), want)


def test_min_coarse_nside_matches_jax():
    for n in (1, 2, 3, 4, 6, 8, 12, 16, 24, 64):
        assert TP.min_coarse_nside(n) == JP.min_coarse_nside(n)
    for mod in (TP, JP):
        with pytest.raises(ValueError, match="power-of-two"):
            mod.min_coarse_nside(5)


def test_simple_parallel_order():
    class FakeRunner:
        def __init__(self, v):
            self.v = v

        def process(self):
            return self.v

    assert T.SimpleParallel([FakeRunner(i) for i in range(5)]).process() \
        == [0, 1, 2, 3, 4]


def test_split_join_matches_one_runner():
    """Four shards of PaintProfilesShell sum to one runner's map; each
    shard registers its own catalog, none reads the parent's caches."""
    single = MR.port_runner(T, "shell_paint")
    want = single.process()          # fills the parent's catalog caches
    par = T.SplitJoinParallel(single, njobs=4)
    sizes = [r.HaloLightConeCatalog.cat.size for r in par.runner_list]
    assert len(par.runner_list) == 4 and sum(sizes) == \
        single.HaloLightConeCatalog.cat.size
    for r in par.runner_list:
        for name in single._CATALOG_CACHES:
            assert name not in r.__dict__
    np.testing.assert_allclose(par.process(), want, rtol=1e-9, atol=1e-9)
    for r in par.runner_list:
        groups = r._groups_cache[(32, 1)]
        assert sum(len(idx) for _, idx, _, _ in groups) == \
            r.HaloLightConeCatalog.cat.size


def test_split_join_rejects_baryonify():
    for case in ("shell", "grid3d", "snap"):
        with pytest.raises(AssertionError, match="PaintProfiles"):
            T.SplitJoinParallel(MR.port_runner(T, case), njobs=2)


class _MeshStandIn:
    """What a runner reads of a mesh before it runs: its dimension
    names."""
    mesh_dim_names = ("cells",)


def test_mesh_rejects_non_cellmajor():
    for case in ("shell", "grid3d", "snap"):
        r = MR.port_runner(T, case)
        for method in ("scatter" if case != "snap" else "gather",):
            with pytest.raises(ValueError, match="cell-major"):
                type(r)(*_ctor_args(r), mesh=_MeshStandIn(),
                        method=method, device="cpu")
        auto = type(r)(*_ctor_args(r), mesh=_MeshStandIn(), device="cpu")
        assert auto.method == "cellmajor" and auto.mesh_axis == "cells"


def _ctor_args(r):
    if hasattr(r, 'LightconeShell'):
        return (r.HaloLightConeCatalog, r.LightconeShell, 10.0, r.model)
    if hasattr(r, 'ParticleSnapshot'):
        return (r.HaloNDCatalog, r.ParticleSnapshot, 10, r.model)
    return (r.HaloNDCatalog, r.GriddedMap, 10, r.model)


# ----- the mesh runs -----

@pytest.fixture(scope="module", params=[2, 3], ids=lambda n: f"{n}ranks")
def ranks(request, tmp_path_factory):
    """Every case on ``n`` gloo ranks: (n, [each rank's results])."""
    n = request.param
    d = tmp_path_factory.mktemp(f"mesh{n}")
    mp.start_processes(MR.run, args=(n, str(d / "store"), str(d),
                                     list(MR.CASES)),
                       nprocs=n, join=True, start_method="spawn")
    return n, [torch.load(d / f"rank{r}.pt", weights_only=False)
               for r in range(n)]


class _JStubDisp:
    p_keys = []
    Rdelta_sampling = False

    def __init__(self):
        self._table = jnp.asarray(MR.stub_disp_table())
        self._grids = tuple(map(jnp.asarray, (MR.ZG, MR.MG, MR.RG)))


class _JStubPaint:
    p_keys = []

    def __init__(self):
        self._ln2D = jnp.asarray(MR.stub_paint_table())
        self._ln3D = self._ln2D
        self._grids = tuple(map(jnp.asarray, (MR.ZG, MR.MG, MR.RG)))


def _jax_runner(case):
    """The JAX package's single-device runner of ``case`` (cell-major,
    float64), on the same numpy scene and stub tables as the ranks'."""
    family, scene, _ = MR.CASES[case]
    s = scene()
    kw = dict(verbose=False, method="cellmajor")
    C = MR.COSMO
    if family in ("BaryonifyShell", "PaintProfilesShell"):
        cat = J.HaloLightConeCatalog(cosmo=C, **s['cat'])
        shell = J.LightconeShell(map=s['map'], cosmo=C)
        model = _JStubDisp() if family == "BaryonifyShell" else _JStubPaint()
        return getattr(J, family)(cat, shell, epsilon_max=10.0, model=model,
                                  **kw)
    if family == "BaryonifySnapshot":
        snap = J.ParticleSnapshot(M=np.ones(len(s['part']['x'])), L=s['L'],
                                  redshift=0.25, cosmo=C, **s['part'])
        cat = J.HaloNDCatalog(redshift=0.25, cosmo=C, **s['cat'])
        return J.BaryonifySnapshot(cat, snap, epsilon_max=10,
                                   model=_JStubDisp(), **kw)
    cat = J.HaloNDCatalog(redshift=0.25, cosmo=C, **s['cat'])
    gm = J.GriddedMap(map=s['map'], redshift=0.25, bins=s['bins'], cosmo=C)
    if family == "PaintProfilesAnisGrid":
        cosmo = J.Cosmology.from_dict(C)
        models = []
        for tab in (MR.stub_paint_table(-1.2, 0.8, 3.0),
                    MR.stub_paint_table(-2.0, 0.5, 4.0)):
            m = J.TabulatedProfile(J.Gas(), cosmo)
            m._grids = tuple(map(jnp.asarray, (MR.ZG, MR.MG, MR.RG)))
            m._ln3D = m._ln2D = jnp.asarray(tab)
            models.append(m)
        return J.PaintProfilesAnisGrid(cat, gm, epsilon_max=3,
                                       Painting_model=models[0],
                                       Canvas_model=models[1], **kw)
    if family == "BaryonifyGrid":
        return J.BaryonifyGrid(cat, gm, epsilon_max=10, model=_JStubDisp(),
                               use_ellipticity='q_ell' in s['cat'], **kw)
    return J.PaintProfilesGrid(cat, gm, epsilon_max=5, model=_JStubPaint(),
                               **kw)


@functools.lru_cache(maxsize=None)
def _jax_map(case):
    r = _jax_runner(case)
    new = r.process()
    if MR.CASES[case][0] == "BaryonifySnapshot":
        return np.stack([new[c] for c in 'xyz'])
    return np.asarray(new)


@functools.lru_cache(maxsize=None)
def _jax_grad(case):
    """(loss value, its gradients) of the JAX package's single-device
    process_device under the case's weighting."""
    r = _jax_runner(case)
    family = MR.CASES[case][0]
    w = jnp.asarray(MR.weights(case, _jax_map(case).shape))
    if family == "PaintProfilesAnisGrid":
        remap0 = r.build_remap_device()
        canvas0 = jnp.asarray(np.asarray(r.GriddedMap.map, np.float64))
        val, g = jax.value_and_grad(
            lambda t, c: jnp.sum(w * r.process_device(remap=t, canvas=c)),
            argnums=(0, 1))(remap0, canvas0)
        return float(val), tuple(np.asarray(x) for x in g)
    tab = (r.model._table if hasattr(r.model, '_table')
           else r.model._ln2D)
    if family == "BaryonifySnapshot":
        loss = lambda t: jnp.sum(w * jnp.stack(r.process_device(table=t)))
    else:
        loss = lambda t: jnp.sum(w * r.process_device(table=t))
    val, g = jax.value_and_grad(loss)(tab)
    return float(val), (np.asarray(g),)


@pytest.mark.parametrize("case", list(MR.CASES))
def test_mesh_matches_jax(ranks, case):
    """process() and process_device() with mesh= equal the JAX package's
    single-device process(), on every rank alike."""
    n, res = ranks
    want = _jax_map(case)
    for r in range(n):
        for key in ("map", "dev"):
            got = res[r][case][key]
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(res[r][case]["map"],
                                      res[0][case]["map"])
    scene = MR.CASES[case][1]()
    before = (np.stack([scene['part'][c] for c in 'xyz'])
              if 'part' in scene else scene['map'])
    assert np.abs(want).max() > 0 and not np.allclose(want, before)


def test_mesh_cellmajor_shell(ranks):
    """One bucket's sharded offsets pass and summed regrid equal the
    single-device pass and regrid, and conserve the mass."""
    n, res = ranks
    for r in range(n):
        single, got, ring = res[r]["_one_bucket"]
        np.testing.assert_allclose(got, single, rtol=1e-12, atol=1e-12)
        assert np.isclose(got.sum(), ring.sum())
        assert not np.allclose(got, ring)


def test_mesh_shard_halos(ranks):
    """Each rank's contiguous share of every column, as np.array_split
    makes them; scalars stay as they are."""
    n, res = ranks
    shares = [res[r]["_shard"] for r in range(n)]
    for key, want in (("M", np.arange(16.0)), ("theta", np.arange(16.0))):
        parts = [np.asarray(s[key]) for s in shares]
        assert [len(p) for p in parts] == [
            len(p) for p in np.array_split(want, n)]
        np.testing.assert_array_equal(np.concatenate(parts), want)
    assert isinstance(shares[0]["theta"], torch.Tensor)
    assert all(s["a"] == 0.5 for s in shares)


@pytest.mark.parametrize("case", GRAD_CASES)
def test_mesh_grad_matches_jax(ranks, case):
    """The gradient through the mesh equals jax.grad of the
    single-device run on every rank, and is not world-size times it."""
    n, res = ranks
    val, grads = _jax_grad(case)
    for r in range(n):
        got = res[r][case]
        np.testing.assert_allclose(got["val"], val, rtol=1e-12)
        for g_m, g_s in zip(got["grad"], grads):
            scale = np.abs(g_s).max()
            assert scale > 0
            np.testing.assert_allclose(g_m, g_s, rtol=1e-10,
                                       atol=1e-10 * scale)
            assert np.abs(g_m - n * g_s).max() > 0.5 * (n - 1) * scale


def test_mesh_shell_is_multibucket():
    """The mesh shell case has at least two coarse levels (so its
    multi-bucket claim is not vacuous), under the mesh's level floor."""
    r = MR.port_runner(T, "shell")
    r.process()
    assert TP.min_coarse_nside(3) == TP.min_coarse_nside(2) == 1
    assert len(r._groups_cache[(32, 1)]) >= 2
