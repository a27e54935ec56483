"""Displacement tables and grid runs of the Arico20 and Mead20 families,
the port against the JAX package.

For each family (APAR, Params_TAGN_7p8): a small ``Baryonification3D``
table built by both packages in float64 on the CPU, held to 1e-8 of
max|table| (quadratures, the relaxation and the mass inversion); and a
small 3D ``BaryonifyGrid`` run, both methods, the port with its own
table against the JAX runner of the same method with the JAX table, to
rms/mean < 1e-10, with mass conserved and the map changed. The JAX
Arico20 build runs with halo grids that end at R_i exactly, as the
port's do (test_torch_arico.py, ROADMAP C).
"""

import numpy as np
import pytest
import torch

import baryonification_tpu as J
import baryonification_tpu_torch as T
from baryonification_tpu.profiles import arico20 as JA, mead20 as JM
from baryonification_tpu_torch.profiles import arico20 as TA, mead20 as TM

from test_torch_arico import _ExactEndNumpy
from test_torch_families import APAR, MPAR
from test_torch_thermo import COSMO_DICT

torch.set_num_threads(1)

GRID = dict(z_min=0.1, z_max=0.5, N_samples_z=2, M_min=1e13, M_max=1e15,
            N_samples_Mass=4, R_min=1e-3, R_max=50, N_samples_R=32)
FAMILIES = {"Arico20": (JA, TA, APAR), "Mead20": (JM, TM, MPAR)}
N, L, N_HALO, EPS = 16, 60.0, 12, 10.0


@pytest.fixture(scope="module")
def tables(cosmo):
    """family -> (JAX model, port model), each built by its package."""
    cosmo_t = T.Cosmology.from_dict(COSMO_DICT, device="cpu")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JA, "jnp", _ExactEndNumpy())
        for fam, (jm, tm, par) in FAMILIES.items():
            mj = J.Baryonification3D(jm.DarkMatterOnly(**par),
                                     jm.DarkMatterBaryon(**par), cosmo,
                                     epsilon_max=EPS)
            mj.setup_interpolator(verbose=False, **GRID)
            mt = T.Baryonification3D(tm.DarkMatterOnly(**par),
                                     tm.DarkMatterBaryon(**par), cosmo_t,
                                     epsilon_max=EPS)
            mt.setup_interpolator(verbose=False, **GRID)
            out[fam] = mj, mt
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_table(family, tables):
    mj, mt = tables[family]
    want, got = np.asarray(mj._table), mt._table.numpy()
    assert got.shape == want.shape == (2, 4, 32)
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-8 * np.abs(want).max())


def _grid_run(pkg, model, method, **kw):
    rng = np.random.default_rng(17)
    cat = pkg.HaloNDCatalog(x=rng.uniform(0, L, N_HALO),
                            y=rng.uniform(0, L, N_HALO),
                            z=rng.uniform(0, L, N_HALO),
                            M=10 ** rng.uniform(13.5, 14.8, N_HALO),
                            redshift=0.25, cosmo=COSMO_DICT)
    mp = rng.uniform(0.5, 1.5, (N,) * 3)
    gm = pkg.GriddedMap(map=mp, redshift=0.25,
                        bins=(np.arange(N) + 0.5) * (L / N), cosmo=COSMO_DICT)
    out = pkg.BaryonifyGrid(cat, gm, epsilon_max=EPS, model=model,
                            method=method, verbose=False, n_buckets=3,
                            **kw).process()
    return np.asarray(out), mp


@pytest.mark.parametrize("method", ["scatter", "cellmajor"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_grid(family, method, tables):
    mj, mt = tables[family]
    want, mp = _grid_run(J, mj, method)
    got, _ = _grid_run(T, mt, method, device="cpu")
    assert np.isclose(got.sum(), mp.sum(), rtol=1e-8)
    assert np.abs(got - mp).max() > 1e-3
    assert np.sqrt(np.mean((got - want) ** 2)) / mp.mean() < 1e-10
