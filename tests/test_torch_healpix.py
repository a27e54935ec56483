"""Parity of the port's HEALPix subset with ``baryonification_tpu.ops.healpix``.

Same inputs (numpy, fixed seeds) through both packages in float64 on the
CPU. Pixel ids must be equal; angles, vectors and weights agree to 1e-12
(both evaluate the same closed forms; only libm rounding differs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from baryonification_tpu.ops import healpix as J
from baryonification_tpu_torch.ops import healpix as T

torch.set_num_threads(1)
f64 = torch.float64


def _t(x):
    return torch.tensor(np.asarray(x))


def _random_angles(n, seed):
    rng = np.random.default_rng(seed)
    theta = np.arccos(rng.uniform(-1, 1, n))
    phi = rng.uniform(0, 2 * np.pi, n)
    # include the poles' neighbourhoods and the cap/belt boundaries
    theta[:4] = [1e-6, np.pi - 1e-6, np.arccos(2 / 3), np.arccos(-2 / 3)]
    return theta, phi


@pytest.mark.parametrize("nside", [1, 2, 8, 64])
def test_pix2ang_pix2vec(nside):
    p = np.arange(J.npix(nside))
    th_j, ph_j = (np.asarray(x) for x in J.pix2ang(nside, p))
    th_t, ph_t = T.pix2ang(nside, _t(p))
    np.testing.assert_allclose(th_t.numpy(), th_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ph_t.numpy(), ph_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(T.pix2vec(nside, _t(p)).numpy(),
                               np.asarray(J.pix2vec(nside, p)), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("nside", [4, 32])
def test_ring_info(nside):
    rings = np.arange(1, 4 * nside)
    zj, sj, nj, hj = (np.asarray(x) for x in J.ring_info(nside, rings))
    zt, st, nt, ht = T.ring_info(nside, _t(rings))
    np.testing.assert_array_equal(st.numpy(), sj)
    np.testing.assert_array_equal(nt.numpy(), nj)
    np.testing.assert_allclose(zt.numpy(), zj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ht.numpy(), hj, rtol=0, atol=1e-12)


@pytest.mark.parametrize("nside", [4, 32])
def test_z_to_ring(nside):
    z = np.random.default_rng(1).uniform(-1, 1, 5000)
    np.testing.assert_array_equal(T.z_to_ring(nside, _t(z)).numpy(),
                                  np.asarray(J.z_to_ring(nside, z)))


def test_angle_vector_conversions():
    rng = np.random.default_rng(2)
    ra, dec = rng.uniform(-30, 400, 500), rng.uniform(-90, 90, 500)
    for a, b in zip(T.radec2ang(_t(ra), _t(dec)), J.radec2ang(ra, dec)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)
    vec = rng.normal(size=(500, 3))
    for a, b in zip(T.vec2ang(_t(vec)), J.vec2ang(jnp.asarray(vec))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("nside", [4, 32])
def test_interp_weights_closed_form(nside):
    theta, phi = _random_angles(4000, 3)
    pj, wj = J.get_interp_weights(nside, jnp.asarray(theta),
                                  jnp.asarray(phi))
    pt, wt = T.get_interp_weights(nside, _t(theta), _t(phi))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0,
                               atol=1e-12)
    ps, ws = T.get_interp_weights_parts(nside, _t(theta), _t(phi))
    np.testing.assert_array_equal(torch.stack(ps, -1).numpy(),
                                  np.asarray(pj))


@pytest.mark.parametrize("nside", [4, 8, 64])
def test_pixel_planes_device(nside):
    rj = J.RingTables(nside, dtype=jnp.float64)
    want = J.pixel_planes_device(nside, rj.z, rj.start, rj.npr, rj.shift)
    rt = T.RingTables(nside, dtype=f64, device="cpu")
    got = T.pixel_planes_device(nside, rt.z, rt.start, rt.npr, rt.shift)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)
    # a subset / reordering through p=
    p = np.random.default_rng(4).permutation(J.npix(nside))[:100]
    sub = T.pixel_planes_device(nside, rt.z, rt.start, rt.npr, rt.shift,
                                p=_t(p))
    for g, w in zip(sub, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[p], rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("nside", [8, 32])
def test_interp_weights_tab(nside):
    theta, phi = _random_angles(3000, 5)
    rj = J.RingTables(nside, dtype=jnp.float64)
    rt = T.RingTables(nside, dtype=f64, device="cpu")
    pj, wj = J.get_interp_weights_tab(rj, jnp.asarray(theta),
                                      jnp.asarray(phi))
    pt, wt = T.get_interp_weights_tab(rt, _t(theta), _t(phi))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("nside,radius", [(16, 0.15), (32, 0.2), (8, 0.9)])
def test_disc_window_mask_tab(nside, radius):
    """Batched windows (H halos at once) against the JAX window of each
    halo: same valid set, same pixel ids where valid."""
    theta, phi = _random_angles(40, 6)
    rad = np.full(40, radius) * np.random.default_rng(7).uniform(0.3, 1, 40)
    n_rings, n_phi = 40, 64
    rj = J.RingTables(nside, dtype=jnp.float64)
    rt = T.RingTables(nside, dtype=f64, device="cpu")
    pix_t, val_t = T.disc_window_mask_tab(rt, _t(theta), _t(phi), _t(rad),
                                          n_rings, n_phi)
    win = jax.vmap(lambda t, p, r: J.disc_window_mask_tab(
        rj, t, p, r, n_rings, n_phi))
    pix_j, val_j = (np.asarray(x) for x in win(jnp.asarray(theta),
                                               jnp.asarray(phi),
                                               jnp.asarray(rad)))
    np.testing.assert_array_equal(val_t.numpy(), val_j)
    np.testing.assert_array_equal(np.where(val_j, pix_t.numpy(), -1),
                                  np.where(val_j, pix_j, -1))
    assert val_j.sum() > 40
