"""The port's differentiable snapshot path against the JAX package's.

float64 on the CPU, the JAX tables carried across with ``from_arrays``,
the JAX values computed once per module.

tests/test_grad.py's ``TestSnapshotGradients`` inputs (:229; 4000
particles, 8 halos, L = 70): ``BaryonifySnapshot.process_device`` equal
to the port's ``process()`` bit for bit, to JAX's ``process_device`` to
1e-10 of the rms offset, and d(displacement second moment)/d(table
scale) against ``jax.grad`` to 1e-8 relative; ``process_device`` refuses
the gather method, as the JAX package's does. Example 15's chain is
test_torch_ex15.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import baryonification_tpu as J
import baryonification_tpu_torch as T

from test_profiles import PAR

torch.set_num_threads(1)

COSMO = dict(Omega_m=0.3, Omega_b=0.05, h=0.7, sigma8=0.8, n_s=0.96,
             w0=-1.0)
GRID = dict(z_min=0.05, z_max=0.6, N_samples_z=4, M_min=1e13, M_max=1e15,
            N_samples_Mass=6, R_min=1e-3, R_max=70, N_samples_R=64)
L = 70.0


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _rel(a, b):
    return abs(a - b) / abs(b)


def _inputs(pkg):
    """TestSnapshotGradients' snapshot and catalog, drawn in its order."""
    rng = np.random.default_rng(23)
    snap = pkg.ParticleSnapshot(x=rng.uniform(0, L, 4000),
                                y=rng.uniform(0, L, 4000),
                                z=rng.uniform(0, L, 4000), M=np.ones(4000),
                                L=L, redshift=0.25, cosmo=COSMO)
    cat = pkg.HaloNDCatalog(x=rng.uniform(0, L, 8), y=rng.uniform(0, L, 8),
                            z=rng.uniform(0, L, 8),
                            M=10 ** rng.uniform(13.9, 14.7, 8),
                            redshift=0.25, cosmo=COSMO)
    return cat, snap


def _moment(x, x0, np_=jnp):
    """The displacement second moment of TestSnapshotGradients (x only,
    minimum image)."""
    d = x - x0
    d = np_.where(d > 35.0, d - 70.0, d)
    d = np_.where(d < -35.0, d + 70.0, d)
    return (d * d).sum()


@pytest.fixture(scope="module")
def staged(cosmo):
    jm = J.Baryonification3D(J.DarkMatterOnly(**PAR),
                             J.DarkMatterBaryon(**PAR), cosmo,
                             epsilon_max=10)
    jm.setup_interpolator(**GRID)
    tm = T.Baryonification3D(
        T.DarkMatterOnly(**PAR), T.DarkMatterBaryon(**PAR),
        T.Cosmology(**COSMO, device="cpu"), epsilon_max=10).from_arrays(
            [np.asarray(g) for g in jm._grids], np.asarray(jm._table),
            jm.Rdelta_sampling, jm.p_keys)
    jr = J.BaryonifySnapshot(*_inputs(J), epsilon_max=10, model=jm,
                             method="cellmajor", verbose=False)
    tr = T.BaryonifySnapshot(*_inputs(T), epsilon_max=10, model=tm,
                             method="cellmajor", verbose=False, device="cpu")
    jtab = jm._table
    x0 = jnp.asarray(tr.ParticleSnapshot.cat['x'])
    jpos, vjp = jax.vjp(lambda s: jr.process_device(jtab * s), 1.0)
    d = jpos[0] - x0
    d = jnp.where(d > 35.0, d - 70.0, d)
    d = jnp.where(d < -35.0, d + 70.0, d)
    (jg,) = vjp((2.0 * d, jnp.zeros_like(d), jnp.zeros_like(d)))
    return tr, tm, [np.asarray(p) for p in jpos], float(jg)


def test_process_device_matches_process_and_jax(staged):
    tr, _, jpos, _ = staged
    got = tr.process_device()
    want = tr.process()
    snap = tr.ParticleSnapshot.cat
    for c, g, j in zip("xyz", got, jpos):
        assert g.dtype == torch.float64 and not g.requires_grad
        np.testing.assert_array_equal(g.numpy(), want[c])
        off = j - snap[c]
        off = off - L * np.round(off / L)
        assert np.abs(off).max() > 0
        rms = np.sqrt(np.mean((g.numpy() - j) ** 2) / np.mean(off ** 2))
        assert rms < 1e-10


def test_process_device_refuses_gather(staged):
    tr, tm, _, _ = staged
    r = T.BaryonifySnapshot(tr.HaloNDCatalog, tr.ParticleSnapshot,
                            epsilon_max=10, model=tm, verbose=False,
                            device="cpu")
    assert r.method == "gather"
    with pytest.raises(ValueError, match="cell-major"):
        r.process_device()


def test_grad_wrt_table_scale_matches_jax(staged):
    tr, tm, _, jg = staged
    x0 = _t(tr.ParticleSnapshot.cat['x'])
    s = _t(1.0).requires_grad_(True)
    x, _, _ = tr.process_device(tm._table * s)
    (g,) = torch.autograd.grad(_moment(x, x0, torch), s)
    assert np.isfinite(float(g)) and float(g) != 0
    assert _rel(float(g), jg) < 1e-8
