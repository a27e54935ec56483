"""Summary statistics in PyTorch: 3D/2D power spectra and HEALPix SHTs.

The port of ``baryonification_tpu.ops.spectra`` (without the per-m
oracle ``anafast_direct``, which stays in the JAX package):

- P(k): ``torch.fft.rfftn`` and ``index_add_`` radial binning.
- C_ell and a_lm (``anafast``, ``map2alm``) and maps (``alm2map``,
  ``synfast``, ``smoothing``): a ring-FFT spherical-harmonic transform in
  two stages, as in the JAX package:

  1. per-ring Fourier coefficients, belt/cap split: the 2*nside+1
     equatorial belt rings (4*nside pixels each, contiguous in RING
     order) take one batched power-of-two FFT; the polar-cap rings take
     batched Bluestein DFTs sharing one power-of-two length. These stay
     ``torch.fft``, as the JAX package leaves them to XLA.
  2. the scaled Legendre recurrence over ell on the equator-folded
     northern half (``ops.legendre_cuda``): a hand-written CUDA kernel
     on the card, its plain PyTorch version on the CPU.

Devices and precision: a tensor input stays on its own device; a numpy
input goes to ``device`` (default the card; without a GPU that raises,
so pass ``device="cpu"``). The SHT runs in float64 on the CPU and float32
on CUDA, as the JAX package runs f64 on the CPU and f32 on accelerators;
the sectoral seeds are always computed in float64 on the host. Results
are tensors on the input's device.
"""

import math
from functools import lru_cache

import numpy as np
import torch

from . import healpix as hpx
from .legendre_cuda import legendre_alm, legendre_synth
from ..utils import resolve_device

__all__ = ["power_spectrum_3d", "power_spectrum_2d", "anafast", "map2alm",
           "alm2map", "alm2cl", "synalm", "synfast", "gauss_beam",
           "smoothing"]


# ----- power spectra -----

def _as_field(delta, device):
    """A tensor stays as it is; anything else becomes float64 on
    ``device``."""
    if torch.is_tensor(delta):
        return delta
    return torch.as_tensor(np.asarray(delta), dtype=torch.float64,
                           device=resolve_device(device))


def _radial_bins(pk, kmag, w, kf, n_bins):
    """Weighted radial averages of P(k) and |k| in n_bins shells of width
    kf centred on kf, 2 kf, ...; returns (k_centers, P, counts)."""
    dt, dev = pk.dtype, pk.device
    k_edges = torch.linspace(kf * 0.5, kf * (n_bins + 0.5), n_bins + 1,
                             dtype=dt, device=dev)
    kflat = kmag.reshape(-1).contiguous()
    idx = torch.clamp(torch.searchsorted(k_edges, kflat) - 1, 0, n_bins - 1)
    inb = (kflat >= k_edges[0]) & (kflat < k_edges[-1])
    wf = torch.where(inb, w.reshape(-1), 0.0)

    def binned(v):
        return torch.zeros(n_bins, dtype=dt, device=dev).index_add_(0, idx, v)

    counts = binned(wf)
    psum = binned(wf * pk.reshape(-1))
    ksum = binned(wf * kflat)
    pk_b = torch.where(counts > 0, psum / torch.clamp(counts, min=1), 0.0)
    kc = torch.where(counts > 0, ksum / torch.clamp(counts, min=1), 0.0)
    return kc, pk_b, counts


def _rfft_weights(shape, N, dt, dev):
    """rfft double-count weights: every plane but the zero (and, for even
    N, the Nyquist) plane of the last axis stands for two modes."""
    w = torch.ones(shape, dtype=dt, device=dev)
    w[..., 1:] = 2.0
    if N % 2 == 0:
        w[..., -1] = 1.0
    return w


def power_spectrum_3d(delta, L, n_bins=None, subtract_shot=0.0, *,
                      device="cuda"):
    """Isotropic P(k) of a 3D field in a periodic box of size L.

    delta : (N, N, N) real field (e.g. rho/rho_mean - 1)
    Returns (k_centers, P(k), counts). Units: k in 1/L-units, P in L^3.
    """
    delta = _as_field(delta, device)
    N = delta.shape[0]
    if n_bins is None:
        n_bins = N // 2
    dt, dev = delta.dtype, delta.device
    fk = torch.fft.rfftn(delta) * (L / N) ** 3
    pk3 = fk.abs() ** 2 / L**3

    kf = 2 * math.pi / L
    kx = torch.fft.fftfreq(N, d=1.0 / N, dtype=dt, device=dev) * kf
    kz = torch.fft.rfftfreq(N, d=1.0 / N, dtype=dt, device=dev) * kf
    kmag = torch.sqrt(kx[:, None, None] ** 2 + kx[None, :, None] ** 2
                      + kz[None, None, :] ** 2)
    w = _rfft_weights(pk3.shape, N, dt, dev)
    kc, pk, counts = _radial_bins(pk3, kmag, w, kf, n_bins)
    return kc, pk - subtract_shot, counts


def power_spectrum_2d(delta, L, n_bins=None, *, device="cuda"):
    """Isotropic P(k) of a 2D periodic field (flat-sky maps)."""
    delta = _as_field(delta, device)
    N = delta.shape[0]
    if n_bins is None:
        n_bins = N // 2
    dt, dev = delta.dtype, delta.device
    fk = torch.fft.rfftn(delta) * (L / N) ** 2
    pk2 = fk.abs() ** 2 / L**2

    kf = 2 * math.pi / L
    kx = torch.fft.fftfreq(N, d=1.0 / N, dtype=dt, device=dev) * kf
    ky = torch.fft.rfftfreq(N, d=1.0 / N, dtype=dt, device=dev) * kf
    kmag = torch.sqrt(kx[:, None] ** 2 + ky[None, :] ** 2)
    w = _rfft_weights(pk2.shape, N, dt, dev)
    return _radial_bins(pk2, kmag, w, kf, n_bins)


# ----- SHT stage 1: ring DFTs -----

def _ring_dfts(vals, npr, M, sign=-1):
    """Native-length DFT of every padded ring row via batched Bluestein.

    vals : (nring, maxn) real or complex ring samples, zero beyond npr[r]
    npr  : (nring,) int64 ring lengths (all <= maxn)
    M    : convolution length, a power of two >= 2 * maxn
    sign : -1 (analysis) or +1 (synthesis) exponent sign

    Returns complex D[r, k] = sum_j vals[r, j] e^{sign 2 pi i j k / npr[r]}
    for k < npr[r] (zero beyond): one circular convolution of length M
    with the chirp w_j = e^{-sign i pi j^2 / n}, shared by every ring.
    Chirp phases use j^2 mod 2n, exact in integers, so float32 keeps its
    accuracy at j ~ 4 * nside.
    """
    nring, maxn = vals.shape
    dev = vals.device
    dt = vals.real.dtype if vals.is_complex() else vals.dtype
    n = npr[:, None]
    j = torch.arange(maxn, device=dev)[None, :]
    jsq = (j * j) % (2 * n)
    theta = float(-sign) * (math.pi * jsq.to(dt)) / n.to(dt)
    w = torch.exp(1j * theta)                       # (nring, maxn)
    a = torch.where(j < n, vals, 0.0) * torch.conj(w)
    A = torch.fft.fft(a, n=M, dim=1)

    jj = torch.arange(M, device=dev)[None, :]
    s = torch.minimum(jj, M - jj)                   # wrapped |offset|
    ssq = (s * s) % (2 * n)
    b = torch.where(s < n,
                    torch.exp(1j * float(-sign)
                              * (math.pi * ssq.to(dt)) / n.to(dt)),
                    0.0)
    conv = torch.fft.ifft(A * torch.fft.fft(b, dim=1), dim=1)[:, :maxn]
    D = torch.conj(w) * conv
    return torch.where(j < n, D, 0.0)


def _ring_analysis(hmap, nside, lmax, M, start, npr):
    """Ring DFT coefficients D[m, r] = D_r[m mod npr_r] of every ring of a
    RING-ordered map, (lmax+1, nring) complex in north-to-south ring
    order: the belt is a reshape and one rfft (a slice of it, or a
    conjugate-alias gather for lmax > 2*nside); the caps take the padded
    gather and the batched Bluestein DFTs."""
    L = lmax + 1
    nc = nside - 1                       # rings per polar cap
    nb = 2 * nside + 1                   # belt rings
    nbf = 4 * nside                      # belt ring length
    belt0 = 2 * nside * (nside - 1)      # first belt pixel (RING order)
    dev = hmap.device

    belt = hmap[belt0:belt0 + nb * nbf].reshape(nb, nbf)
    Rb = torch.fft.rfft(belt, dim=1)                  # (nb, 2*nside+1)
    if lmax <= 2 * nside:
        Dgb = Rb[:, :L]
    else:
        k = torch.arange(L, device=dev) % nbf
        k2 = torch.minimum(k, nbf - k)
        Dgb = torch.where((k <= nbf // 2)[None, :], Rb[:, k2],
                          torch.conj(Rb[:, k2]))
    if nc == 0:
        return Dgb.T

    maxn_cap = 4 * nc
    startc = torch.cat([start[:nc], start[3 * nside:]])
    nprc = torch.cat([npr[:nc], npr[3 * nside:]])
    jc = torch.arange(maxn_cap, device=dev)
    pixc = startc[:, None] + torch.minimum(jc[None, :], nprc[:, None] - 1)
    valsc = torch.where(jc[None, :] < nprc[:, None], hmap[pixc], 0.0)
    Dc = _ring_dfts(valsc, nprc, M)                   # (2*nc, maxn_cap)
    kkc = torch.arange(L, device=dev)[None, :] % nprc[:, None]
    Dgc = torch.gather(Dc, 1, kkc)                    # (2*nc, L)
    return torch.cat([Dgc[:nc], Dgb, Dgc[nc:]], dim=0).T


# ----- seeds and geometry -----

def _anafast_seeds(nside, lmax, log_fold):
    """Host-side (float64 numpy) ring geometry and scaled sectoral seeds.

    Returns (z, start, npr, shift, p_mm, sc0) for the 4*nside-1 rings,
    with lambda_mm(x_r) = p_mm[m, r] * FOLD^(-sc0[m, r]) and p_mm in
    (1/FOLD, O(1)]: float64 keeps the m*log(sin theta) exponents exact
    even where the recurrence runs in float32."""
    rings = torch.arange(1, 4 * nside, dtype=torch.int64)
    z, start, npr, shift = (v.numpy() for v in hpx.ring_info(nside, rings))
    sx = np.sqrt(np.maximum(1.0 - z * z, 0.0))    # > 0 on every ring
    m = np.arange(lmax + 1, dtype=np.float64)
    k = np.arange(1, lmax + 1, dtype=np.float64)
    logdd = np.cumsum(np.log((2 * k - 1.0) / (2 * k)))
    log_pref = 0.5 * (np.log((2 * m + 1) / (4 * np.pi))
                      + np.concatenate([[0.0], logdd]))
    logp = log_pref[:, None] + m[:, None] * np.log(sx)[None, :]
    sc0 = np.maximum(np.floor(-logp / log_fold), 0.0)
    sign = 1.0 - 2.0 * (np.arange(lmax + 1) % 2)
    p_mm = sign[:, None] * np.exp(logp + sc0 * log_fold)
    return (z, start.astype(np.int64), npr.astype(np.int64), shift,
            p_mm, sc0.astype(np.int32))


@lru_cache(maxsize=4)
def _seed_consts(nside, lmax, dtype, device):
    """Map-independent constants on the device, cached per (nside, lmax,
    dtype, device) (~70 MB at NSIDE 1024): the ring geometry (z, start,
    npr, shift) and, for the northern half, the seeds p_mm and sc0 and
    x = z, each contiguous."""
    log_fold = math.log(1e40 if dtype == torch.float64 else 1e20)
    z, start, npr, shift, p_mm, sc0 = _anafast_seeds(nside, lmax, log_fold)
    n_north = 2 * nside

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    return dict(z=t(z), start=t(start, torch.int64),
                npr=t(npr, torch.int64), shift=t(shift),
                p_mm=t(p_mm[:, :n_north]), sc0=t(sc0[:, :n_north],
                                                 torch.int32),
                x=t(z[:n_north]))


def _bluestein_len(nside):
    """The smallest power of two >= 2 * maxn = 8 * nside."""
    M = 1
    while M < 8 * nside:
        M *= 2
    return M


def _ring_phase(consts, L, dt):
    """Ring phase angle m * phi0(r), reduced exactly in integers:
    ((m * 2 shift) mod 2 npr) * pi / npr, shift in {0, 1/2}. In float32
    the raw product reaches ~2e3 rad on polar rings and loses 3-4
    digits."""
    npr = consts["npr"]
    mi = torch.arange(L, device=npr.device)
    s2 = torch.round(2.0 * consts["shift"]).to(torch.int64)   # 0 or 1
    k2 = (mi[:, None] * s2[None, :]) % (2 * npr[None, :])
    return math.pi * k2.to(dt) / npr[None, :].to(dt)


# ----- SHT cores -----

def _analysis_folds(hmap, nside, lmax, M, consts):
    """Stage 1 of the analysis and the equator fold: the (L, 2*nside)
    planes (Ger, Gor, Gei, Goi) that ``legendre_alm`` takes, in the map's
    dtype and device. ``consts`` from :func:`_seed_consts`."""
    dt = hmap.dtype
    L = lmax + 1
    dOmega = 4 * math.pi / hpx.npix(nside)

    # stage 1: G[m, r] = dOmega e^{-i m phi0(r)} D[r, m mod npr]
    Dg = _ring_analysis(hmap, nside, lmax, M, consts["start"],
                        consts["npr"])
    G = dOmega * torch.exp(-1j * _ring_phase(consts, L, dt)) * Dg
    Gr, Gi = G.real, G.imag

    # stage 2 on the northern half: ring r pairs with nring-1-r at -z,
    # and lambda_lm(-z) = (-1)^(l+m) lambda_lm(z), so the even and odd
    # folds G_n +/- G_s carry the whole sphere; the equator (the last
    # northern ring) pairs with itself and is counted once
    n_north = 2 * nside
    is_eq = (torch.arange(n_north, device=hmap.device) == n_north - 1)[None]
    Gr_s = torch.where(is_eq, 0.0, torch.flip(Gr, [1])[:, :n_north])
    Gi_s = torch.where(is_eq, 0.0, torch.flip(Gi, [1])[:, :n_north])
    Gr_n, Gi_n = Gr[:, :n_north], Gi[:, :n_north]
    return tuple(f.contiguous() for f in (Gr_n + Gr_s, Gr_n - Gr_s,
                                           Gi_n + Gi_s, Gi_n - Gi_s))


def _anafast_core(hmap, nside, lmax, M, consts, want_alm=False):
    """Analysis: C_ell (or the a_lm planes with ``want_alm``) of a map in
    its own dtype and device. ``consts`` from :func:`_seed_consts`."""
    Ar, Ai = legendre_alm(*_analysis_folds(hmap, nside, lmax, M, consts),
                          consts["p_mm"], consts["sc0"], consts["x"])
    if want_alm:
        return Ar, Ai
    return alm2cl(Ar, Ai)


def _synth_rings(Br, Bi, nside, lmax, M, consts):
    """Stages 2-3 of the synthesis: fold B[m, r] (all 4*nside-1 rings)
    into each ring's native frequency bins with the exact phi0 phase and
    the real-field weight w_m, and evaluate every ring: the belt by one
    inverse FFT and a reshape, the caps by a scatter-add fold, inverse
    Bluestein DFTs and a pixel scatter."""
    dt, dev = Br.dtype, Br.device
    L = lmax + 1
    nc = nside - 1                       # rings per polar cap
    nb = 2 * nside + 1                   # belt rings
    nbf = 4 * nside                      # belt ring length
    belt0 = 2 * nside * (nside - 1)      # first belt pixel (RING order)
    npr, start = consts["npr"], consts["start"]
    mi = torch.arange(L, device=dev)
    wm = torch.where(mi == 0, 1.0, 2.0).to(dt)[:, None]
    Bc = (wm * torch.complex(Br, Bi)) \
        * torch.exp(1j * _ring_phase(consts, L, dt))     # (L, nring)

    # belt: pixel j of ring r gets Re sum_k C[r, k] e^{+2 pi i k j / n}
    Bb = Bc[:, nc:nc + nb].T                           # (nb, L)
    if lmax < nbf:
        Cb = torch.cat([Bb, torch.zeros((nb, nbf - L), dtype=Bb.dtype,
                                        device=dev)], dim=1)
    else:
        Cb = torch.zeros((nb, nbf), dtype=Bb.dtype,
                         device=dev).index_add_(1, mi % nbf, Bb)
    vals_b = torch.fft.ifft(Cb, dim=1).real * float(nbf)
    if nc == 0:
        return vals_b.reshape(-1)

    # caps
    maxn_cap = 4 * nc
    Bcap = torch.cat([Bc[:, :nc], Bc[:, nc + nb:]], dim=1)
    nprc = torch.cat([npr[:nc], npr[3 * nside:]])
    kkc = mi[:, None] % nprc[None, :]                  # (L, 2*nc)
    flat = (torch.arange(2 * nc, device=dev)[None, :] * maxn_cap
            + kkc).reshape(-1)

    def fold(v):
        return torch.zeros(2 * nc * maxn_cap, dtype=dt, device=dev) \
            .index_add_(0, flat, v.reshape(-1)).reshape(2 * nc, maxn_cap)

    Fc = _ring_dfts(torch.complex(fold(Bcap.real), fold(Bcap.imag)), nprc,
                    M, sign=+1)
    vals_c = Fc.real                                   # (2*nc, maxn_cap)

    # pixel writeback: the north cap is [0, belt0), the belt follows, the
    # south cap is the last belt0 pixels
    jc = torch.arange(maxn_cap, device=dev)
    validc = jc[None, :] < nprc[:, None]
    startc = torch.cat([start[:nc], start[3 * nside:]])
    vals_c = torch.where(validc, vals_c, 0.0)
    pix_n = startc[:nc, None] + torch.minimum(jc[None, :],
                                              nprc[:nc, None] - 1)
    north = torch.zeros(belt0, dtype=dt, device=dev).index_add_(
        0, pix_n.reshape(-1), vals_c[:nc].reshape(-1))
    off = belt0 + nb * nbf
    pix_s = (startc[nc:, None] - off
             + torch.minimum(jc[None, :], nprc[nc:, None] - 1))
    south = torch.zeros(belt0, dtype=dt, device=dev).index_add_(
        0, pix_s.reshape(-1), vals_c[nc:].reshape(-1))
    return torch.cat([north, vals_b.reshape(-1), south])


def _alm2map_core(alm_re, alm_im, nside, lmax, M, consts):
    """Synthesis: f = sum_{l, m>=0} w_m Re(a_lm Y_lm) in the a_lm's dtype
    and device: the parity folds of B[m, r] = sum_l a_lm lambda_lm(x_r)
    on the northern rings (``legendre_synth``), unfolded onto the whole
    sphere, then :func:`_synth_rings`."""
    folds = legendre_synth(alm_re.contiguous(), alm_im.contiguous(),
                           consts["p_mm"], consts["sc0"], consts["x"])
    return _synth_from_folds(*folds, nside, lmax, M, consts)


def _synth_from_folds(Ber, Bor, Bei, Boi, nside, lmax, M, consts):
    """The map from the northern parity folds of ``legendre_synth``."""
    n_north = 2 * nside
    # ring r < n_north is northern; ring nring-1-r is its southern mirror
    # (the equator, r = n_north-1, pairs with itself and appears once)
    Br = torch.cat([Ber + Bor,
                    torch.flip((Ber - Bor)[:, :n_north - 1], [1])], dim=1)
    Bi = torch.cat([Bei + Boi,
                    torch.flip((Bei - Boi)[:, :n_north - 1], [1])], dim=1)
    return _synth_rings(Br, Bi, nside, lmax, M, consts)


# ----- public SHT -----

def _sht_dtype(dev):
    """float64 on the CPU, float32 on the card."""
    return torch.float64 if dev.type == "cpu" else torch.float32


def _sht_input(a, device):
    """A tensor stays on its device; anything else goes to ``device``;
    both in the SHT dtype of that device."""
    if not torch.is_tensor(a):
        a = torch.as_tensor(np.asarray(a), device=resolve_device(device))
    return a.to(_sht_dtype(a.device)).contiguous()


def anafast(hmap, nside, lmax, iter=0, *, device="cuda"):
    """Angular power spectrum C_ell of a RING-ordered HEALPix map
    (healpy.anafast without pixel-window deconvolution).

    iter : Jacobi quadrature-refinement rounds as in healpy (0 keeps the
    single-pass estimator; see :func:`map2alm`).
    Returns (lmax+1,) on the map's device."""
    if iter:
        return alm2cl(*map2alm(hmap, nside, lmax, iter=iter, device=device))
    hmap = _sht_input(hmap, device)
    return _anafast_core(hmap, nside, lmax, _bluestein_len(nside),
                         _seed_consts(nside, lmax, hmap.dtype, hmap.device))


def map2alm(hmap, nside, lmax, iter=0, *, device="cuda"):
    """Harmonic coefficients of a RING-ordered map (healpy.map2alm).

    Returns (alm_re, alm_im), each (lmax+1, lmax+1) indexed [l, m] with
    the m > l triangle zero: the positive-m storage of a real field that
    :func:`alm2map` takes. iter : rounds of Jacobi refinement against the
    pixel-centre quadrature error, ``a += analysis(map - synthesis(a))``
    (healpy defaults to 3)."""
    hmap = _sht_input(hmap, device)
    consts = _seed_consts(nside, lmax, hmap.dtype, hmap.device)
    M = _bluestein_len(nside)
    are, aim = _anafast_core(hmap, nside, lmax, M, consts, want_alm=True)
    for _ in range(iter):
        resid = hmap - _alm2map_core(are, aim, nside, lmax, M, consts)
        dre, dim = _anafast_core(resid, nside, lmax, M, consts,
                                 want_alm=True)
        are = are + dre
        aim = aim + dim
    return are, aim


def alm2cl(alm_re, alm_im):
    """C_ell from positive-m [l, m] a_lm storage (healpy.alm2cl):
    ``C_l = sum_m w_m |a_lm|^2 / (2l+1)``, w_0 = 1, w_m = 2."""
    L = alm_re.shape[0]
    dt, dev = alm_re.dtype, alm_re.device
    wm = torch.where(torch.arange(L, device=dev) == 0, 1.0, 2.0).to(dt)
    ell = torch.arange(L, dtype=dt, device=dev)
    return ((wm[None, :] * (alm_re**2 + alm_im**2)).sum(dim=1)
            / (2.0 * ell + 1.0))


def gauss_beam(fwhm, lmax, *, device="cuda"):
    """Gaussian beam window b_l = exp(-l(l+1) sigma^2 / 2),
    sigma = fwhm / sqrt(8 ln 2), fwhm in radians (healpy.gauss_beam);
    float64 on ``device``."""
    sigma = fwhm / math.sqrt(8.0 * math.log(2.0))
    l = torch.arange(lmax + 1, dtype=torch.float64,
                     device=resolve_device(device))
    return torch.exp(-0.5 * l * (l + 1) * sigma**2)


def smoothing(hmap, nside, lmax, fwhm=None, beam=None, iter=0, *,
              device="cuda"):
    """Convolve a RING-ordered map with an isotropic beam
    (healpy.smoothing): map2alm -> a_lm * b_l -> alm2map.

    fwhm : Gaussian beam FWHM in radians, or
    beam : (lmax+1,) explicit window b_l (overrides fwhm).
    iter : Jacobi refinement rounds of the analysis (see map2alm)."""
    if beam is None and fwhm is None:
        raise ValueError("smoothing: give fwhm or beam")
    alm_re, alm_im = map2alm(hmap, nside, lmax, iter=iter, device=device)
    if beam is None:
        beam = gauss_beam(fwhm, lmax, device=alm_re.device)
    beam = torch.as_tensor(beam, dtype=alm_re.dtype,
                           device=alm_re.device)[:, None]
    return alm2map(alm_re * beam, alm_im * beam, nside, lmax)


def alm2map(alm_re, alm_im, nside, lmax, *, device="cuda"):
    """RING-ordered HEALPix map from harmonic coefficients (healpy.alm2map).

    alm_re/alm_im : (lmax+1, lmax+1) [l, m], the m > l triangle ignored;
    conventions as :func:`anafast`, so anafast(alm2map(a)) recovers
    sum_m w_m |a_lm|^2 / (2l+1) up to HEALPix quadrature error."""
    alm_re = _sht_input(alm_re, device)
    alm_im = _sht_input(alm_im, alm_re.device).to(alm_re.device)
    return _alm2map_core(alm_re, alm_im, nside, lmax, _bluestein_len(nside),
                         _seed_consts(nside, lmax, alm_re.dtype,
                                      alm_re.device))


def synalm(cl, lmax, generator, *, device="cuda"):
    """Gaussian a_lm with spectrum C_ell (healpy.synalm).

    generator : a ``torch.Generator``; the draws are made on its device
    (``device`` names it only when ``cl`` is not a tensor and must then
    match it). Returns (alm_re, alm_im), each (lmax+1, lmax+1) [l, m]:
    m = 0 modes real ~ N(0, C_l), m > 0 re/im ~ N(0, C_l / 2), so
    E[sum_m w_m |a_lm|^2] = (2l+1) C_l."""
    cl = _sht_input(cl, device)
    dt, dev = cl.dtype, cl.device
    L = lmax + 1
    l = torch.arange(L, device=dev)[:, None]
    m = torch.arange(L, device=dev)[None, :]
    std = torch.sqrt(torch.clamp(cl, min=0.0))[:, None]
    fac = torch.where(m == 0, 1.0, math.sqrt(0.5)).to(dt) * std * (m <= l)
    alm_re = torch.randn((L, L), generator=generator, dtype=dt,
                         device=dev) * fac
    alm_im = torch.randn((L, L), generator=generator, dtype=dt,
                         device=dev) * fac * (m > 0)
    return alm_re, alm_im


def synfast(cl, nside, lmax, generator, *, device="cuda"):
    """Gaussian random RING-ordered map with spectrum C_ell
    (healpy.synfast): alm2map(synalm(cl))."""
    alm_re, alm_im = synalm(cl, lmax, generator, device=device)
    return alm2map(alm_re, alm_im, nside, lmax)
