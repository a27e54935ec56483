"""Example 18's Fisher matrix through the port against the JAX package.

examples/18_cosmo_baryon_fisher.py prices (sigma8, ln M_c) through
``cosmology_device`` -> ``build_table_device`` -> the cell-major
``process_device`` of an NSIDE-16 shell with 15 halos, and takes the
Laplace covariance of chi^2 = 1e8 sum (map - map_truth)^2 at the truth.
There the residual is 0, so the Hessian is 2e8 J^T J with J the map's
derivatives. Here (float64, CPU):

- J from the JAX package's maps by central differences (forward runs
  only: ``jax.hessian`` through ``cosmology_device`` compiles for tens of
  minutes), against the port's exact Hessian (reverse over reverse,
  ``laplace_covariance``): the covariance to 1e-3 (the differences'
  truncation), the correlation to 1e-3;
- both read a correlation of -0.189: the example's own assert
  |corr| > 0.3 does not hold in the JAX package either (ROADMAP C5), so
  ``chip_smoke.py`` holds the port to this reference value instead.
"""

import numpy as np
import pytest
import torch

import baryonification_tpu as J
import baryonification_tpu_torch as T
from baryonification_tpu.cosmology import cosmology_device as j_cd
from baryonification_tpu.ops import healpix as jhpx

torch.set_num_threads(1)

COSMO = dict(Omega_m=0.3, Omega_b=0.05, h=0.7, sigma8=0.8, n_s=0.96,
             w0=-1.0)
Z = np.geomspace(0.1, 0.5, 2)
M = np.geomspace(1e13, 1e15, 5)
R = np.geomspace(1e-3, 70, 44)
GRID = dict(z_min=Z[0], z_max=Z[-1], N_samples_z=2, M_min=M[0],
            M_max=M[-1], N_samples_Mass=5, R_min=R[0], R_max=R[-1],
            N_samples_R=44)
TRUTH = {"ln_Mc": float(np.log(10 ** 13.8)), "sigma8": 0.8}


def _runner(pkg, **kw):
    """Example 18's staged runner and profile parameters."""
    par = pkg.default_params()
    rng = np.random.default_rng(12)
    n = 15
    cat = pkg.HaloLightConeCatalog(
        ra=rng.uniform(0, 360, n),
        dec=np.degrees(np.arcsin(rng.uniform(-0.85, 0.85, n))),
        M=10 ** rng.uniform(13.8, 14.9, n), z=rng.uniform(0.15, 0.45, n),
        cosmo=COSMO)
    shell = pkg.LightconeShell(map=rng.uniform(0.5, 1.5, jhpx.npix(16)),
                               cosmo=COSMO)
    m0 = pkg.Baryonification2D(pkg.DarkMatterOnly(**par),
                               pkg.DarkMatterBaryon(**par),
                               pkg.Cosmology.from_dict(COSMO, **kw),
                               epsilon_max=20)
    m0.setup_interpolator(**GRID)
    return pkg.BaryonifyShell(cat, shell, epsilon_max=20, model=m0,
                              method="cellmajor", verbose=False,
                              **kw), par


@pytest.fixture(scope="module")
def jax_cov():
    runner, par = _runner(J)

    def m(s8, lnMc):
        p = dict(par, M_c=float(np.exp(lnMc)))
        b = J.Baryonification2D(J.DarkMatterOnly(**p),
                                J.DarkMatterBaryon(**p),
                                j_cd({**COSMO, "sigma8": s8}),
                                epsilon_max=20)
        return np.asarray(runner.process_device(
            b.build_table_device(Z, M, R).reshape(2, 5, 44)))

    s0, l0 = TRUTH["sigma8"], TRUTH["ln_Mc"]
    jm = (m(s0, l0 + 1e-3) - m(s0, l0 - 1e-3)) / 2e-3
    js = (m(s0 + 2e-4, l0) - m(s0 - 2e-4, l0)) / 4e-4
    H = 2e8 * np.array([[jm @ jm, jm @ js], [js @ jm, js @ js]])
    return 2.0 * np.linalg.inv(H)


def test_example18_fisher_matches_jax(jax_cov):
    runner, par = _runner(T, device="cpu")

    def map_of(p):
        q = dict(par, M_c=torch.exp(p["ln_Mc"]))
        b = T.Baryonification2D(
            T.DarkMatterOnly(**q), T.DarkMatterBaryon(**q),
            T.cosmology_device({**COSMO, "sigma8": p["sigma8"]},
                               device="cpu"), epsilon_max=20)
        return runner.process_device(
            b.build_table_device(Z, M, R).reshape(2, 5, 44))

    at = {k: torch.tensor(v, dtype=torch.float64) for k, v in TRUTH.items()}
    with torch.no_grad():
        target = map_of(at)
    cov, _ = T.laplace_covariance(
        lambda p: ((map_of(p) - target) ** 2).sum() * 1e8, at)
    corr = cov[0, 1] / np.sqrt(cov[0, 0] * cov[1, 1])
    j_corr = jax_cov[0, 1] / np.sqrt(jax_cov[0, 0] * jax_cov[1, 1])
    np.testing.assert_allclose(cov, jax_cov, rtol=1e-3)
    assert abs(corr - j_corr) < 1e-3
    assert abs(j_corr) < 0.3 and abs(corr) < 0.3      # see the docstring
