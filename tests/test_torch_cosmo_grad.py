"""The port's ``cosmology_device`` against the JAX package's.

float64 on the CPU:

- the forward values of every table-backed quantity of
  TestCosmologyGradients' scalar (growth, chi, sigma(M), xi_mm, P_lin,
  P_nl), at the default table resolution, against JAX's
  ``cosmology_device`` built from the same floats, to 1e-10;
- the autograd gradient of that scalar with respect to each of the six
  parameters against the port's own central finite difference, at the
  JAX test's step and 1e-4 bar (tests/test_grad.py:620);
- d(table)/d(sigma8, Omega_m) through ``build_table_device`` with a
  device cosmology, against the port's central FD at the JAX test's
  step and 2e-3 bar;
- the same scalar's gradient against ``jax.grad`` at a reduced table
  resolution (_n_a = _n_k = 256, _n_m = 64), where the JAX trace
  compiles in seconds, to 1e-9.
No ``jax.grad`` runs at the default resolution: that compile is what
holds tests/test_grad.py's TestCosmologyGradients at minutes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import baryonification_tpu_torch as T
from baryonification_tpu.cosmology import cosmology_device as j_cd
from baryonification_tpu_torch.cosmology import cosmology_device

from test_profiles import PAR

torch.set_num_threads(1)

COSMO = dict(Omega_m=0.3, Omega_b=0.05, h=0.7, sigma8=0.8, n_s=0.96,
             w0=-1.0)
KEYS = ("Omega_m", "Omega_b", "h", "sigma8", "n_s", "w0")
REDUCED = dict(_n_a=256, _n_k=256, _n_m=64)


def t64(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def quantities(c, arr):
    """The six table-backed terms of TestCosmologyGradients' scalar."""
    return (c.growth_factor(0.5), c.comoving_radial_distance(0.5),
            c.sigmaM(arr([1e13, 1e14]), 0.8), c.xi_mm(arr([1.0, 10.0]), 0.9),
            c.P_lin(arr([0.1, 1.0]), 0.7), c.P_nl(arr([0.5]), 0.8))


def scalar_t(c):
    g, chi, s, xi, pl, pn = quantities(c, t64)
    return (g + 1e-3 * chi + s.sum() + xi.sum() + torch.log(pl).sum()
            + torch.log(pn).sum())


def scalar_j(c):
    g, chi, s, xi, pl, pn = quantities(c, jnp.asarray)
    return (g + 1e-3 * chi + jnp.sum(s) + jnp.sum(xi)
            + jnp.sum(jnp.log(pl)) + jnp.sum(jnp.log(pn)))


def test_forward_values_match_jax():
    got = quantities(cosmology_device(COSMO, device="cpu"), t64)
    want = quantities(j_cd(COSMO), jnp.asarray)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g.detach()), np.asarray(w),
                                   rtol=1e-10)


def test_device_class_keeps_the_graph():
    s8 = t64(0.8).requires_grad_(True)
    c = cosmology_device(COSMO, sigma8=s8, device="cpu")
    assert isinstance(c, T.CosmologyDevice) and c.sigma8.requires_grad
    assert c.sigmaM(t64([1e14]), 1.0).requires_grad
    with pytest.raises(TypeError):
        cosmology_device(COSMO, Omega_k=0.1, device="cpu")


@pytest.mark.parametrize("key", KEYS)
def test_scalar_grad_matches_fd(key):
    base = COSMO[key]
    x = t64(base).requires_grad_(True)
    (ad,) = torch.autograd.grad(
        scalar_t(cosmology_device({**COSMO, key: x}, device="cpu")), x)
    eps = 1e-5 * max(abs(base), 0.1)
    fd = (float(scalar_t(cosmology_device({**COSMO, key: base + eps},
                                          device="cpu")))
          - float(scalar_t(cosmology_device({**COSMO, key: base - eps},
                                            device="cpu")))) / (2 * eps)
    assert np.isfinite(float(ad))
    assert abs(float(ad) - fd) <= 1e-4 * max(abs(fd), 1e-8), (key, ad, fd)


@pytest.mark.parametrize("key", ["sigma8", "Omega_m"])
def test_displacement_table_grad_matches_fd(key):
    Z = np.geomspace(0.1, 0.5, 2)
    M = np.geomspace(1e13, 1e15, 4)
    R = np.geomspace(1e-3, 70, 40)

    def f(v):
        c = cosmology_device({**COSMO, key: v}, device="cpu")
        m = T.Baryonification2D(T.DarkMatterOnly(**PAR),
                                T.DarkMatterBaryon(**PAR), c,
                                epsilon_max=20)
        return torch.sum(torch.abs(m.build_table_device(Z, M, R)))

    base = COSMO[key]
    x = t64(base).requires_grad_(True)
    (ad,) = torch.autograd.grad(f(x), x)
    eps = 3e-4 * abs(base)
    fd = (float(f(base + eps)) - float(f(base - eps))) / (2 * eps)
    assert np.isfinite(float(ad)) and float(ad) != 0.0
    assert abs(float(ad) - fd) <= 2e-3 * abs(fd), (key, float(ad), fd)


def test_scalar_grad_matches_jax_at_reduced_resolution():
    """All six gradients at once against jax.grad (tables of 256 x 256
    x 64, whose JAX trace compiles in seconds)."""
    jg = jax.grad(lambda p: scalar_j(j_cd({**COSMO, **p}, **REDUCED)))(
        {k: jnp.asarray(v) for k, v in COSMO.items()})
    xs = {k: t64(v).requires_grad_(True) for k, v in COSMO.items()}
    val = scalar_t(cosmology_device(xs, device="cpu", **REDUCED))
    tg = torch.autograd.grad(val, [xs[k] for k in KEYS])
    for k, g in zip(KEYS, tg):
        np.testing.assert_allclose(float(g), float(jg[k]), rtol=1e-9,
                                   err_msg=k)
