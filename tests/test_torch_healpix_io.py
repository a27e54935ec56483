"""The port's HEALPix remainder, interpolation helpers, FITS io and misc
utilities against the JAX package's.

- ``ang2pix`` on random angles and on the poles, the ring boundaries
  (z = +-2/3 and the cap rings) and the face edges (phi a multiple of
  pi/2), exactly; ``vec2pix`` on their unit vectors exactly where the two
  packages' ``vec2ang`` agree bit for bit (their arccos differs by an ulp
  at some points, which then may fall on either side of a pixel edge),
  and equal to ``ang2pix`` of the port's ``vec2ang`` everywhere;
  ``disc_window``'s ``pix`` and ``valid`` exactly, polar and equatorial
  discs;
- ``ud_grade`` down and up with power 0 and -2, exactly (the sum kept at
  power -2), an integer map promoted to float;
- ``pchip_interp`` and ``searchsorted_interp`` to 1e-12;
- FITS files written by one package and read by the other, RING and
  NESTED, ``.gz``, a two-column table read by ``field=``, the refusal of
  INDXSCHM=EXPLICIT, and ``LightconeShell(path=...)``;
- ``build_cosmodict``, ``log_time``, ``generate_operator_method``,
  ``destory_Pk`` and ``trace``, one case each.
"""

import gzip
import json
import operator

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import baryonification_tpu as J
import baryonification_tpu_torch as T
from baryonification_tpu import io as jio
from baryonification_tpu.ops import healpix as jh
from baryonification_tpu.ops import interp as jinterp
from baryonification_tpu_torch import io as tio
from baryonification_tpu_torch.ops import healpix as th
from baryonification_tpu_torch.ops import interp as tinterp

from test_profiles import PAR

COSMO = dict(Omega_m=0.3, Omega_b=0.05, h=0.7, sigma8=0.8, n_s=0.96,
             w0=-1.0)


def _angles(nside, n=4000, seed=0):
    """Random angles, the poles, every ring's z (the cap/belt boundaries
    at +-2/3 among them) and the face edges phi = k pi/2."""
    rng = np.random.default_rng(seed)
    theta = [np.arccos(rng.uniform(-1, 1, n)), [0.0, np.pi],
             np.arccos([2 / 3, -2 / 3])]
    phi = [rng.uniform(0, 2 * np.pi, n), [0.0, 0.0], [0.0, np.pi]]
    ring_z = np.asarray(jh.ring_info(nside, np.arange(1, 4 * nside))[0])
    theta.append(np.arccos(ring_z))
    phi.append(np.full(ring_z.size, np.pi / 2))
    edges = np.arange(8) * np.pi / 2
    theta.append(np.full(8, np.pi / 3))
    phi.append(edges)
    return np.concatenate(theta), np.concatenate(phi)


@pytest.mark.parametrize("nside", [1, 2, 16, 1024])
def test_ang2pix_vec2pix_match_jax(nside):
    theta, phi = _angles(nside, seed=nside)
    want = np.asarray(jh.ang2pix(nside, jnp.asarray(theta),
                                 jnp.asarray(phi)))
    got = th.ang2pix(nside, torch.as_tensor(theta), torch.as_tensor(phi))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # vec2pix is ang2pix of vec2ang, whose arccos rounds by an ulp apart
    # in the two packages' math libraries now and then: a point on a pixel
    # edge may then fall on either side. Exact where the angles agree
    st = np.sin(theta)
    xyz = (st * np.cos(phi), st * np.sin(phi), np.cos(theta))
    want_v = np.asarray(jh.vec2pix(nside, *map(jnp.asarray, xyz)))
    vec = torch.stack(list(map(torch.as_tensor, xyz)), dim=-1)
    got_v = th.vec2pix(nside, *vec.unbind(-1)).numpy()
    ang = th.vec2ang(vec)
    np.testing.assert_array_equal(got_v, th.ang2pix(nside, *ang).numpy())
    same = np.ones(theta.size, bool)
    for w, g in zip(jh.vec2ang(jnp.asarray(vec.numpy())), ang):
        same &= np.asarray(w) == g.numpy()
    assert same.mean() > 0.8
    np.testing.assert_array_equal(got_v[same], want_v[same])
    # every pixel centre maps to itself
    pix = torch.arange(th.npix(nside)) if nside <= 16 else torch.arange(
        0, th.npix(nside), 997)
    np.testing.assert_array_equal(
        th.ang2pix(nside, *th.pix2ang(nside, pix)).numpy(), pix.numpy())


@pytest.mark.parametrize("nside,theta0,radius", [
    (16, [0.02, 1.1, 2.0, np.pi - 0.05], [0.3, 0.12, 0.05, 0.2]),
    (64, [0.7, 1.5707963, 2.9], [0.04, 0.03, 0.1])])
def test_disc_window_matches_jax(nside, theta0, radius):
    phi0 = np.linspace(0.1, 6.0, len(theta0))
    args = [np.asarray(theta0), phi0, np.asarray(radius)]
    n_rings, n_phi = 24, 48
    wp, wv = jh.disc_window(nside, *map(jnp.asarray, args), n_rings, n_phi)
    gp, gv = th.disc_window(nside, *map(torch.as_tensor, args), n_rings,
                            n_phi)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    wv = np.asarray(wv)
    assert wv.sum() > 20
    np.testing.assert_array_equal(gp.numpy()[wv], np.asarray(wp)[wv])
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))


@pytest.mark.parametrize("nside_in,nside_out", [(16, 4), (8, 32)])
@pytest.mark.parametrize("power", [0.0, -2.0])
def test_ud_grade_matches_jax(nside_in, nside_out, power):
    m = np.random.default_rng(nside_in).uniform(0.5, 1.5, 12 * nside_in ** 2)
    want = np.asarray(jh.ud_grade(jnp.asarray(m), nside_out, power=power))
    got = th.ud_grade(torch.as_tensor(m), nside_out, power=power)
    np.testing.assert_array_equal(got.numpy(), want)
    if power == -2.0:
        np.testing.assert_allclose(got.sum().item(), m.sum(), rtol=1e-13)
    ints = th.ud_grade(torch.arange(12 * nside_in ** 2), nside_out)
    assert ints.is_floating_point()
    np.testing.assert_array_equal(ints.numpy(), np.asarray(jh.ud_grade(
        jnp.arange(12 * nside_in ** 2), nside_out)))


def test_interp_helpers_match_jax():
    rng = np.random.default_rng(1)
    x = np.sort(rng.uniform(0, 10, 40))
    y = np.cumsum(rng.uniform(0, 1, 40))
    xq = np.concatenate([np.linspace(-1.0, 11.0, 500), x])
    for extrapolate in (True, False):
        want = np.asarray(jinterp.pchip_interp(xq, x, y,
                                               extrapolate=extrapolate))
        got = tinterp.pchip_interp(torch.as_tensor(xq), torch.as_tensor(x),
                                   torch.as_tensor(y),
                                   extrapolate=extrapolate).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=1e-12,
                                   atol=1e-12)
    want = np.asarray(jinterp.searchsorted_interp(xq, x, y))
    got = tinterp.searchsorted_interp(torch.as_tensor(xq), torch.as_tensor(x),
                                      torch.as_tensor(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("nest", [False, True])
@pytest.mark.parametrize("suffix", [".fits", ".fits.gz"])
def test_fits_both_ways(tmp_path, nest, suffix):
    m = np.random.default_rng(7).normal(size=th.npix(16))
    for k, (write, read) in enumerate(
            ((tio.write_healpix_fits, jio.read_healpix_fits),
             (jio.write_healpix_fits, tio.read_healpix_fits))):
        p = tmp_path / f"map{k}{suffix}"
        write(p, m, nest=nest)
        if suffix.endswith(".gz"):
            assert p.read_bytes()[:2] == b"\x1f\x8b"
        np.testing.assert_array_equal(np.asarray(read(p)), m)
    raw = [(tmp_path / f"map{k}{suffix}").read_bytes() for k in (0, 1)]
    if suffix.endswith(".gz"):            # the gzip header names the file
        raw = [gzip.decompress(b) for b in raw]
    assert raw[0] == raw[1]
    tio.write_healpix_fits(tmp_path / "t.fits", torch.as_tensor(m))
    np.testing.assert_array_equal(tio.read_healpix_fits(tmp_path / "t.fits"),
                                  m)


def _card(key, val):
    v = (f"'{val}'".ljust(20) if isinstance(val, str)
         else ('T'.rjust(20) if val is True else str(val).rjust(20)))
    return f"{key:8s}= {v} /".ljust(80)[:80]


def _block(cards):
    txt = ''.join(cards + ['END'.ljust(80)])
    return txt.ljust(-(-len(txt) // 2880) * 2880).encode()


def test_fits_field_and_explicit(tmp_path):
    """A float32 table with a leading int32 column (healpy's layout in
    rows of 1024), read column by column; INDXSCHM=EXPLICIT refused."""
    nside, rep = 16, 1024
    npix = th.npix(nside)
    nrow = npix // rep
    m = np.random.default_rng(9).normal(size=npix).astype(np.float32)
    extra = np.arange(npix, dtype=np.int32)
    primary = _block([_card('SIMPLE', True), _card('BITPIX', 8),
                      _card('NAXIS', 0), _card('EXTEND', True)])
    cards = [_card('XTENSION', 'BINTABLE'), _card('BITPIX', 8),
             _card('NAXIS', 2), _card('NAXIS1', 8 * rep),
             _card('NAXIS2', nrow), _card('PCOUNT', 0), _card('GCOUNT', 1),
             _card('TFIELDS', 2), _card('TFORM1', f'{rep}J'),
             _card('TFORM2', f'{rep}E'), _card('ORDERING', 'RING'),
             _card('NSIDE', nside)]
    rows = np.zeros(nrow, dtype=[('a', '>i4', (rep,)), ('b', '>f4', (rep,))])
    rows['a'] = extra.reshape(nrow, rep)
    rows['b'] = m.reshape(nrow, rep)
    data = rows.tobytes()
    pad = b'\x00' * ((-len(data)) % 2880)
    p = tmp_path / "hand.fits"
    p.write_bytes(primary + _block(cards) + data + pad)
    for field, want in ((0, extra), (1, m)):
        got = tio.read_healpix_fits(p, field=field)
        np.testing.assert_array_equal(got, want.astype(np.float64))
        np.testing.assert_array_equal(got, jio.read_healpix_fits(p, field))
    q = tmp_path / "explicit.fits"
    q.write_bytes(primary + _block(cards + [_card('INDXSCHM', 'EXPLICIT')])
                  + data + pad)
    for read in (tio.read_healpix_fits, jio.read_healpix_fits):
        with pytest.raises(NotImplementedError, match="EXPLICIT"):
            read(q)
    bad = tmp_path / "bad.fits"
    bad.write_bytes(primary)
    with pytest.raises(ValueError, match="BINTABLE"):
        tio.read_healpix_fits(bad)


@pytest.mark.parametrize("suffix", [".fits", ".fits.gz"])
def test_lightcone_shell_from_fits(tmp_path, suffix):
    m = np.random.default_rng(11).uniform(0.5, 1.5, th.npix(8))
    p = tmp_path / f"shell{suffix}"
    jio.write_healpix_fits(p, m, nest=True)
    want = J.LightconeShell(path=str(p), cosmo=COSMO)
    got = T.LightconeShell(path=str(p), cosmo=COSMO)
    assert got.NSIDE == want.NSIDE == 8
    np.testing.assert_array_equal(got.map, np.asarray(want.map))
    np.testing.assert_array_equal(got.map, m)
    np.save(tmp_path / "shell.npy", m)
    np.testing.assert_array_equal(
        T.LightconeShell(path=str(tmp_path / "shell.npy")).map, m)


def test_misc_utils(tmp_path, capsys):
    tc = T.Cosmology(**COSMO, device="cpu")
    assert T.build_cosmodict(tc) == J.build_cosmodict(J.Cosmology(**COSMO))
    assert T.destory_Pk(tc) is tc

    @T.log_time
    def twice(v):
        return 2 * v

    assert twice(3) == 6
    assert "[log_time]" in capsys.readouterr().out and \
        twice.__name__ == "twice"
    dm = T.DarkMatter(**PAR)
    T.DarkMatter.__rsub__ = T.generate_operator_method(operator.sub,
                                                       reflected=True)
    try:
        r = torch.linspace(0.1, 2.0, 5, dtype=torch.float64)
        comb = 1.0 - dm
        np.testing.assert_allclose(comb.real(tc, r, 1e14, 1.0).numpy(),
                                   1.0 - dm.real(tc, r, 1e14, 1.0).numpy(),
                                   rtol=1e-14)
        neg = T.generate_operator_method(operator.neg)(dm)
        np.testing.assert_allclose(neg.real(tc, r, 1e14, 1.0).numpy(),
                                   -dm.real(tc, r, 1e14, 1.0).numpy(),
                                   rtol=1e-14)
    finally:
        del T.DarkMatter.__rsub__
    with T.utils.trace(tmp_path / "prof"):
        torch.ones(8).sum()
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
