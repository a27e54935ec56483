"""Models with extra table axes (``other_params``) in the port, against
the JAX package.

float64 on the CPU, the ``shell_setup`` catalog of test_runners.py (NSIDE
32, 25 halos) with per-halo property columns made from numpy seeds, and
the grids of test_runners.py::TestCellmajorProps (z 3 nodes, or 2 with two
axes; M 4; R 48):

- the ``Baryonification3D`` table with one axis (theta_ej) and with two
  (theta_ej, eta), against the JAX table to test_displacement_table's bar
  (1e-8 of max|table|);
- ``BaryonifyShell`` with ``method="scatter"`` and ``"cellmajor"``, the
  table carried across from JAX and rebuilt by the port, against the JAX
  runner of the same method to rms/mean < 1e-10;
- the port's cellmajor against its scatter at the JAX tests' bar (atol
  1e-6 max|change|, rtol 1e-6);
- the property axis is live: a constant-column catalog gives another map.
"""

import numpy as np
import pytest
import torch

import baryonification_tpu as J
import baryonification_tpu_torch as T

from test_profiles import PAR
from test_runners import COSMO_DICT

torch.set_num_threads(1)

EPS = 20.0
AXES = {
    "one": (dict(z_min=0.05, z_max=0.6, N_samples_z=3, M_min=1e13,
                 M_max=1e15, N_samples_Mass=4, R_min=1e-3, R_max=70,
                 N_samples_R=48),
            {'theta_ej': np.array([2.0, 4.0, 8.0])}),
    "two": (dict(z_min=0.05, z_max=0.6, N_samples_z=2, M_min=1e13,
                 M_max=1e15, N_samples_Mass=4, R_min=1e-3, R_max=70,
                 N_samples_R=48),
            {'theta_ej': np.array([2.0, 4.0, 8.0]),
             'eta': np.array([0.1, 0.3])}),
}


@pytest.fixture(scope="module")
def props_shell():
    """shell_setup's halos and map, with theta_ej and eta columns."""
    nside, n_halo = 32, 25
    rng = np.random.default_rng(11)
    halos = dict(ra=rng.uniform(0, 360, n_halo),
                 dec=np.degrees(np.arcsin(rng.uniform(-0.8, 0.8, n_halo))),
                 M=10 ** rng.uniform(13.6, 14.8, n_halo),
                 z=rng.uniform(0.15, 0.45, n_halo))
    mass_map = rng.uniform(0.5, 1.5, 12 * nside**2)
    rng = np.random.default_rng(42)
    cols = dict(theta_ej=rng.uniform(2.5, 7.5, n_halo),
                eta=rng.uniform(0.12, 0.28, n_halo))
    return halos, cols, mass_map


@pytest.fixture(scope="module")
def models(cosmo):
    """axes -> (JAX model, port model rebuilt, port model carried)."""
    cosmo_t = T.Cosmology.from_dict(COSMO_DICT, device="cpu")
    out = {}
    for axes, (grid, other) in AXES.items():
        mj = J.Baryonification3D(J.DarkMatterOnly(**PAR),
                                 J.DarkMatterBaryon(**PAR), cosmo,
                                 epsilon_max=EPS)
        mj.setup_interpolator(other_params=other, verbose=False, **grid)
        mt = T.Baryonification3D(T.DarkMatterOnly(**PAR),
                                 T.DarkMatterBaryon(**PAR), cosmo_t,
                                 epsilon_max=EPS)
        mt.setup_interpolator(other_params=other, verbose=False, **grid)
        mc = T.Baryonification3D(T.DarkMatterOnly(**PAR),
                                 T.DarkMatterBaryon(**PAR), cosmo_t,
                                 epsilon_max=EPS).from_arrays(
            [np.asarray(g) for g in mj._grids], np.asarray(mj._table),
            mj.Rdelta_sampling, mj.p_keys)
        out[axes] = mj, mt, mc
    return out


def _run(pkg, halos, cols, mass_map, model, method, **kw):
    props = {k: cols[k] for k in model.p_keys}
    cat = pkg.HaloLightConeCatalog(cosmo=COSMO_DICT, **halos, **props)
    shell = pkg.LightconeShell(map=mass_map, cosmo=COSMO_DICT)
    runner = pkg.BaryonifyShell(cat, shell, epsilon_max=EPS, model=model,
                                verbose=False, method=method, **kw)
    return np.asarray(runner.process())


@pytest.fixture(scope="module")
def jax_maps(props_shell, models):
    """(axes, method) -> the JAX runner's map."""
    halos, cols, mass_map = props_shell
    return {(axes, method): _run(J, halos, cols, mass_map, models[axes][0],
                                 method)
            for axes in AXES for method in ("scatter", "cellmajor")}


@pytest.fixture(scope="module")
def port_maps(props_shell, models):
    """(axes, method, carry) -> the port's map on the CPU."""
    halos, cols, mass_map = props_shell
    return {(axes, method, carry): _run(
                T, halos, cols, mass_map,
                models[axes][1 if carry == "rebuilt" else 2], method,
                device="cpu")
            for axes in AXES for method in ("scatter", "cellmajor")
            for carry in ("rebuilt", "carried")}


@pytest.mark.parametrize("axes", list(AXES))
def test_props_table_matches_jax(axes, models):
    mj, mt, _ = models[axes]
    assert mt.p_keys == mj.p_keys == list(AXES[axes][1])
    for gj, gt in zip(mj._grids, mt._grids):
        np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    want = np.asarray(mj._table)
    assert mt._table.shape == want.shape and want.ndim == 3 + len(mj.p_keys)
    np.testing.assert_allclose(mt._table.numpy(), want, rtol=0,
                               atol=1e-8 * np.abs(want).max())
    assert np.abs(want).max() > 1e-3


@pytest.mark.parametrize("carry", ["rebuilt", "carried"])
@pytest.mark.parametrize("method", ["scatter", "cellmajor"])
@pytest.mark.parametrize("axes", list(AXES))
def test_props_shell_matches_jax(axes, method, carry, props_shell, jax_maps,
                                 port_maps):
    _, _, mass_map = props_shell
    got, want = port_maps[axes, method, carry], jax_maps[axes, method]
    assert np.isclose(got.sum(), mass_map.sum(), rtol=1e-8)
    assert np.abs(want - mass_map).max() > 0
    rms = np.sqrt(np.mean((got - want) ** 2)) / mass_map.mean()
    assert rms < 1e-10, rms


@pytest.mark.parametrize("carry", ["rebuilt", "carried"])
@pytest.mark.parametrize("axes", list(AXES))
def test_props_cellmajor_matches_scatter(axes, carry, props_shell,
                                         port_maps):
    """The JAX tests' bar between the two methods (TestCellmajorProps)."""
    _, _, mass_map = props_shell
    cm = port_maps[axes, "cellmajor", carry]
    sc = port_maps[axes, "scatter", carry]
    scale = np.abs(sc - mass_map).max()
    assert scale > 0
    np.testing.assert_allclose(cm, sc, atol=1e-6 * scale, rtol=1e-6)


@pytest.mark.parametrize("method", ["scatter", "cellmajor"])
@pytest.mark.parametrize("axes", list(AXES))
def test_props_axis_is_live(axes, method, props_shell, models, port_maps):
    """Every property column held at its grid's first node moves the
    map away from the run with the catalog's own columns."""
    halos, cols, mass_map = props_shell
    _, _, mc = models[axes]
    const = {k: np.full(len(halos['ra']), float(AXES[axes][1][k][0]))
             for k in mc.p_keys}
    got = _run(T, halos, const, mass_map, mc, method, device="cpu")
    assert np.isclose(got.sum(), mass_map.sum(), rtol=1e-8)
    assert not np.allclose(got, port_maps[axes, method, "carried"])
