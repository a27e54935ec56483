"""HEALPix RING-scheme geometry in PyTorch.

The port of ``baryonification_tpu.ops.healpix``: pixel/angle conversions
(both ways), ring bookkeeping, bilinear interpolation weights (closed
form and table based), per-ring tables, on-device pixel-centre planes,
the fixed-shape disc windows that replace healpy's ``query_disc``
(``disc_window`` by pixel-centre vectors, ``disc_window_mask_tab`` by a
per-ring test), the NESTED <-> RING conversions and ``ud_grade``.

Conventions match HEALPix: theta = colatitude in [0, pi], phi in [0, 2pi),
ring index i = 1..4n-1 (Gorski et al. 2005). Closed-form functions
compute in the dtype of their float inputs (``dtype`` where the input is
an integer) on the inputs' device; pixel ids are int64.
"""

import math
from functools import lru_cache

import torch

__all__ = ["npix", "nside2resol", "ang2vec", "vec2ang", "radec2ang",
           "pix2ang", "pix2vec", "ang2pix", "vec2pix", "ring_info",
           "z_to_ring", "disc_window", "ud_grade",
           "get_interp_weights", "get_interp_weights_parts", "interp_terms",
           "RingTables",
           "pixel_planes_device", "ring_above_tab",
           "get_interp_weights_parts_tab", "get_interp_weights_tab",
           "disc_window_mask_tab", "nest2ring", "ring2nest",
           "nest2ring_all"]


def npix(nside):
    return 12 * nside * nside


def nside2resol(nside):
    """Mean pixel spacing in radians (healpy parity)."""
    return math.sqrt(4.0 * math.pi / npix(nside))


def ang2vec(theta, phi):
    st = torch.sin(theta)
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi),
                        torch.cos(theta)], dim=-1)


def vec2ang(vec):
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    r = torch.sqrt(x * x + y * y + z * z)
    theta = torch.arccos(torch.clamp(z / r, -1.0, 1.0))
    phi = torch.atan2(y, x)
    phi = torch.where(phi < 0, phi + 2 * math.pi, phi)
    return theta, phi


def radec2ang(ra_deg, dec_deg):
    """(ra, dec) in degrees -> (theta, phi) HEALPix angles (healpy's
    lonlat=True convention)."""
    theta = torch.deg2rad(90.0 - dec_deg)
    phi = torch.deg2rad(torch.remainder(ra_deg, 360.0))
    return theta, phi


# ----- pixel <-> angle -----

def pix2ang(nside, ipix, dtype=torch.float64):
    """RING pixel index tensor -> (theta, phi) in ``dtype``."""
    n = nside
    p = ipix.to(torch.int64)
    Np = 12 * n * n
    ncap = 2 * n * (n - 1)

    # north cap: rings i = 1..n-1 with 4i pixels
    ph = (p + 1).to(dtype) * 0.5
    i_cap = (torch.floor(torch.sqrt(torch.clamp(
        ph - torch.sqrt(torch.floor(ph)), min=0.0))) + 1).to(torch.int64)
    j_cap = p - 2 * i_cap * (i_cap - 1)          # 0-based in ring
    z_n = 1.0 - i_cap.to(dtype) ** 2 / (3.0 * n * n)
    phi_n = (math.pi / (2.0 * i_cap.to(dtype))) * (j_cap.to(dtype) + 0.5)

    # equatorial belt: rings i = n..3n, 4n pixels each
    pe = p - ncap
    i_eq = torch.div(pe, 4 * n, rounding_mode="floor") + n
    j_eq = torch.remainder(pe, 4 * n)
    s = torch.remainder(i_eq - n + 1, 2)          # phase shift
    z_e = 4.0 / 3.0 - 2.0 * i_eq.to(dtype) / (3.0 * n)
    phi_e = (math.pi / (2.0 * n)) * (j_eq.to(dtype) + s.to(dtype) * 0.5)

    # south cap (mirror of north)
    q = Np - 1 - p
    qh = (q + 1).to(dtype) * 0.5
    i_s = (torch.floor(torch.sqrt(torch.clamp(
        qh - torch.sqrt(torch.floor(qh)), min=0.0))) + 1).to(torch.int64)
    j_s = q - 2 * i_s * (i_s - 1)
    z_s = -(1.0 - i_s.to(dtype) ** 2 / (3.0 * n * n))
    phi_s = (math.pi / (2.0 * i_s.to(dtype))) \
        * ((4 * i_s - 1 - j_s).to(dtype) + 0.5)

    north = p < ncap
    south = p >= Np - ncap
    z = torch.where(north, z_n, torch.where(south, z_s, z_e))
    phi = torch.where(north, phi_n, torch.where(south, phi_s, phi_e))
    return torch.arccos(torch.clamp(z, -1.0, 1.0)), phi


def pix2vec(nside, ipix, dtype=torch.float64):
    theta, phi = pix2ang(nside, ipix, dtype)
    return ang2vec(theta, phi)


def ang2pix(nside, theta, phi):
    """(theta, phi) tensors -> RING pixel ids (int64; healpy's
    algorithm)."""
    n = nside
    z = torch.cos(theta)
    za = z.abs()
    tt = torch.remainder(phi, 2 * math.pi) / (0.5 * math.pi)   # in [0, 4)

    # equatorial: |z| <= 2/3
    temp1 = n * (0.5 + tt)
    temp2 = n * (z * 0.75)
    jp = torch.floor(temp1 - temp2).to(torch.int64)
    jm = torch.floor(temp1 + temp2).to(torch.int64)
    ir = n + 1 + jp - jm          # ring counted from z = 2/3: 1..2n+1
    kshift = 1 - (ir & 1)
    ip = torch.remainder(_floordiv(jp + jm - n + kshift + 1, 2), 4 * n)
    pix_eq = 2 * n * (n - 1) + 4 * n * (ir - 1) + ip

    # polar caps
    tp = tt - torch.floor(tt)
    tmp = n * torch.sqrt(torch.clamp(3.0 * (1.0 - za), min=0.0))
    jp_c = torch.floor(tp * tmp).to(torch.int64)
    jm_c = torch.floor((1.0 - tp) * tmp).to(torch.int64)
    ir_c = jp_c + jm_c + 1
    ip_c = torch.remainder(torch.floor(tt * ir_c).to(torch.int64), 4 * ir_c)
    pix_n = 2 * ir_c * (ir_c - 1) + ip_c
    pix_s = 12 * n * n - 2 * ir_c * (ir_c + 1) + ip_c

    pix_polar = torch.where(z > 0, pix_n, pix_s)
    return torch.where(za <= 2.0 / 3.0, pix_eq, pix_polar)


def vec2pix(nside, x, y, z):
    """Unit vector components -> RING pixel ids (healpy.vec2pix)."""
    return ang2pix(nside, *vec2ang(torch.stack([x, y, z], dim=-1)))


# ----- ring bookkeeping -----

def ring_info(nside, i, dtype=torch.float64):
    """For ring index tensor i (1..4n-1): (z, start_pixel, npix_in_ring,
    shift), z and shift in ``dtype``. shift=0.5 means pixel centres are
    offset by half a spacing in phi."""
    n = nside
    i = i.to(torch.int64)
    in_ncap = i < n
    in_scap = i > 3 * n

    # north cap
    z_n = 1.0 - i.to(dtype) ** 2 / (3.0 * n * n)
    start_n = 2 * i * (i - 1)
    npr_n = 4 * i

    # equatorial
    z_e = 4.0 / 3.0 - 2.0 * i.to(dtype) / (3.0 * n)
    start_e = 2 * n * (n - 1) + 4 * n * (i - n)
    npr_e = torch.full_like(i, 4 * n)
    shift_e = torch.remainder(i - n + 1, 2).to(dtype) * 0.5

    # south cap: mirror ring i' = 4n - i
    i_m = 4 * n - i
    z_s = -(1.0 - i_m.to(dtype) ** 2 / (3.0 * n * n))
    start_s = 12 * n * n - 2 * i_m * (i_m + 1)
    npr_s = 4 * i_m

    z = torch.where(in_ncap, z_n, torch.where(in_scap, z_s, z_e))
    start = torch.where(in_ncap, start_n,
                        torch.where(in_scap, start_s, start_e))
    npr = torch.where(in_ncap, npr_n, torch.where(in_scap, npr_s, npr_e))
    shift = torch.where(in_ncap | in_scap, 0.5, shift_e)
    return z, start, npr, shift


def z_to_ring(nside, z):
    """Ring index of the ring at-or-above z (0 = above the first ring)."""
    n = nside
    # equatorial inverse: i = 2n - 1.5 n z  (from z = 4/3 - 2i/(3n))
    i_eq = torch.floor(n * (2.0 - 1.5 * z)).to(torch.int64)
    # caps: i = n sqrt(3 (1 -| z|))
    i_n = torch.floor(n * torch.sqrt(torch.clamp(3.0 * (1.0 - z), min=0.0))
                      ).to(torch.int64)
    i_s = 4 * n - 1 - torch.floor(
        n * torch.sqrt(torch.clamp(3.0 * (1.0 + z), min=0.0))).to(torch.int64)
    ring = torch.where(z > 2.0 / 3.0, i_n,
                       torch.where(z < -2.0 / 3.0, i_s, i_eq))
    return torch.clamp(ring, 0, 4 * n - 1)


# ----- bilinear interpolation weights (healpy get_interp_weights) -----

def interp_terms(nside, theta, phi):
    """The terms of :func:`get_interp_weights_parts` that its derivative
    needs: a dict of the ids ``p`` (p11, p12, p21, p22), the phi
    fractions ``f1``, ``f2`` and phi steps ``dphi1``, ``dphi2`` of the
    rings above and below, ``th1`` and ``denom`` (the theta weight is
    (theta - th1) / denom), that weight before its clamp (``wt0``) and
    after the clamp and the pole rows (``wt``), and the pole masks
    ``npole``, ``spole``. The ring index, floor and mod are piecewise
    constant in (theta, phi)."""
    n = nside
    dt = theta.dtype
    z = torch.cos(theta)
    r1 = z_to_ring(n, z)
    r2 = r1 + 1
    at_npole = r1 < 1
    at_spole = r2 > 4 * n - 1
    r1c = torch.clamp(r1, 1, 4 * n - 1)
    r2c = torch.clamp(r2, 1, 4 * n - 1)

    def ring_neighbors(ring):
        zr, start, npr, shift = ring_info(n, ring, dt)
        dphi = 2.0 * math.pi / npr.to(dt)
        t = phi / dphi - shift
        j1 = torch.floor(t).to(torch.int64)
        frac = t - j1.to(dt)
        p1 = start + torch.remainder(j1, npr)
        p2 = start + torch.remainder(j1 + 1, npr)
        th_r = torch.arccos(torch.clamp(zr, -1.0, 1.0))
        return p1, p2, frac, th_r, dphi

    p11, p12, f1, th1, dphi1 = ring_neighbors(r1c)
    p21, p22, f2, th2, dphi2 = ring_neighbors(r2c)

    # theta-weight toward ring 2 (healpy interpolates in theta)
    denom = torch.where(th2 > th1, th2 - th1, 1.0)
    wt0 = (theta - th1) / denom
    wt = torch.clamp(wt0, 0.0, 1.0)
    wt = torch.where(at_npole, 0.0, torch.where(at_spole, 1.0, wt))
    return dict(p=(p11, p12, p21, p22), f1=f1, f2=f2, dphi1=dphi1,
                dphi2=dphi2, th1=th1, denom=denom, wt0=wt0, wt=wt,
                npole=at_npole, spole=at_spole)


def get_interp_weights_parts(nside, theta, phi):
    """Closed-form 4-neighbour bilinear weights as component tuples
    ((p1..p4), (w1..w4)); the weights sum to 1 (healpy
    get_interp_weights parity; the pole rows split the weight within the
    nearest ring)."""
    t = interp_terms(nside, theta, phi)
    wt, f1, f2 = t["wt"], t["f1"], t["f2"]
    return (t["p"],
            ((1 - wt) * (1 - f1), (1 - wt) * f1,
             wt * (1 - f2), wt * f2))


def get_interp_weights(nside, theta, phi):
    """4 neighbour pixels + bilinear weights, stacked: (pix, w) of shape
    (..., 4)."""
    ps, ws = get_interp_weights_parts(nside, theta, phi)
    return torch.stack(ps, dim=-1), torch.stack(ws, dim=-1)


# ----- per-ring tables (for the runner's batched window kernels) -----

class RingTables:
    """Per-ring tables of one NSIDE: z, theta and phi shift in ``dtype``,
    start pixel and ring length as int64, on ``device``. Built from the
    float64 closed forms, then cast."""

    def __init__(self, nside, dtype=torch.float32, *, device):
        rings = torch.arange(1, 4 * nside, device=device)
        z, start, npr, shift = ring_info(nside, rings, torch.float64)
        self.nside = nside
        self.dtype = dtype
        self.z = z.to(dtype)
        self.neg_z = -self.z                      # ascending, for searches
        self.theta = torch.arccos(torch.clamp(z, -1, 1)).to(dtype)
        self.start = start
        self.npr = npr
        self.shift = shift.to(dtype)


def pixel_planes_device(nside, z_tab, start_tab, npr_tab, shift_tab,
                        p=None):
    """(vx, vy, vz) pixel-centre unit-vector planes, built on the tables'
    device in the tables' dtype: ring id by searchsorted over the ring
    starts, then phi = (j + shift) * 2 pi / npr. ``p`` optionally selects
    or reorders the pixels."""
    if p is None:
        p = torch.arange(npix(nside), device=z_tab.device)
    dt = z_tab.dtype
    ring = torch.searchsorted(start_tab, p.to(start_tab.dtype),
                              right=True) - 1
    j = (p - start_tab[ring]).to(dt)
    dphi = (2.0 * math.pi) / npr_tab[ring].to(dt)
    phi = (j + shift_tab[ring]) * dphi
    z = z_tab[ring]
    st = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return st * torch.cos(phi), st * torch.sin(phi), z


def ring_above_tab(tables, z):
    """Number of rings with z_ring >= z (0 = above the first ring)."""
    return torch.searchsorted(tables.neg_z, (-z).contiguous(), right=True)


def _ring_phi_neighbors_tab(tables, ring, phi):
    """Two pixels bracketing phi in ring ``ring`` (1-based) + fraction."""
    k = ring - 1
    start = tables.start[k]
    npr = tables.npr[k]
    dphi = 2.0 * math.pi / npr.to(tables.dtype)
    t = phi / dphi - tables.shift[k]
    j1 = torch.floor(t).to(torch.int64)
    frac = t - j1.to(tables.dtype)
    p1 = start + torch.remainder(j1, npr)
    p2 = start + torch.remainder(j1 + 1, npr)
    return p1, p2, frac, tables.theta[k]


def get_interp_weights_parts_tab(tables, theta, phi):
    """Table-based 4-neighbour bilinear weights as component tuples
    ((p1..p4), (w1..w4)); same semantics as the closed form."""
    n = tables.nside
    z = torch.cos(theta)
    r1 = ring_above_tab(tables, z)
    r2 = r1 + 1
    at_npole = r1 < 1
    at_spole = r2 > 4 * n - 1
    r1c = torch.clamp(r1, 1, 4 * n - 1)
    r2c = torch.clamp(r2, 1, 4 * n - 1)

    p11, p12, f1, th1 = _ring_phi_neighbors_tab(tables, r1c, phi)
    p21, p22, f2, th2 = _ring_phi_neighbors_tab(tables, r2c, phi)

    denom = torch.where(th2 > th1, th2 - th1, 1.0)
    wt = torch.clamp((theta - th1) / denom, 0.0, 1.0)
    wt = torch.where(at_npole, 0.0, torch.where(at_spole, 1.0, wt))

    return ((p11, p12, p21, p22),
            ((1 - wt) * (1 - f1), (1 - wt) * f1,
             wt * (1 - f2), wt * f2))


def get_interp_weights_tab(tables, theta, phi):
    """Table-based 4-neighbour weights, stacked (..., 4)."""
    ps, ws = get_interp_weights_parts_tab(tables, theta, phi)
    return torch.stack(ps, dim=-1), torch.stack(ws, dim=-1)


def disc_window_mask_tab(tables, theta0, phi0, radius, n_rings, n_phi):
    """Fixed-shape pixel window around each of H discs (query_disc
    replacement, pixel-centre-inside semantics).

    theta0, phi0, radius : (H,). Returns (pix, valid) of shape
    (H, n_rings, n_phi): RING pixel ids and a mask of the pixels whose
    centres lie inside the disc. The in-disc test is analytic per ring:
    cos(dist) = z cos(theta0) + sin(theta) sin(theta0) cos(dphi) >=
    cos(radius). ``n_rings``/``n_phi`` bound the largest disc of the batch.
    """
    n = tables.nside
    dt = tables.dtype
    cos_r = torch.cos(radius)

    z_hi = torch.cos(torch.clamp(theta0 - radius, min=0.0))
    ring_lo = torch.clamp(ring_above_tab(tables, z_hi), 1, 4 * n - 1)
    k = torch.arange(n_rings, device=theta0.device)
    rings_raw = ring_lo[..., None] + k
    ring_ok = rings_raw <= 4 * n - 1
    kk = torch.clamp(rings_raw, 1, 4 * n - 1) - 1

    z = tables.z[kk]
    start = tables.start[kk]
    npr = tables.npr[kk]
    shift = tables.shift[kk]
    dphi_pix = 2.0 * math.pi / npr.to(dt)

    st0 = torch.sin(theta0)[..., None]
    ct0 = torch.cos(theta0)[..., None]
    st = torch.sqrt(torch.clamp(1.0 - z * z, min=1e-30))
    # in-disc iff cos(phi_pix - phi0) >= cosdphi_thresh on this ring
    cosdphi_thresh = (cos_r[..., None] - z * ct0) / (st * st0 + 1e-30)

    t = phi0[..., None] / dphi_pix - shift
    j_center = torch.round(t).to(torch.int64)
    m = torch.arange(n_phi, device=theta0.device) - (n_phi // 2)
    j = j_center[..., None] + m
    pix = start[..., None] + torch.remainder(j, npr[..., None])

    # actual pixel phi (unwrapped j is fine under cos)
    dphi = ((j.to(dt) + shift[..., None]) * dphi_pix[..., None]
            - phi0[..., None, None])
    inside = torch.cos(dphi) >= cosdphi_thresh[..., None]
    valid = inside & ring_ok[..., None]
    # mask candidate slots that alias the same pixel (ring shorter than NP)
    span = torch.clamp(npr[..., None], max=n_phi)
    slot_ok = (m >= -torch.div(span, 2, rounding_mode="floor")) \
        & (m < span - torch.div(span, 2, rounding_mode="floor"))
    return pix, valid & slot_ok


def disc_window(nside, theta0, phi0, radius, n_rings, n_phi):
    """Fixed-shape pixel window around each disc of angular ``radius``
    about (theta0, phi0) (tensors of one shape): (pix, valid) of shape
    (..., n_rings, n_phi), RING pixel ids and a mask of the pixels whose
    centres lie inside the disc (healpy query_disc, inclusive=False),
    tested by the dot product of the pixel-centre and disc-centre unit
    vectors. ``n_rings`` / ``n_phi`` bound the largest disc of the
    batch. ``disc_window_mask_tab`` is the runners' per-ring form."""
    n = nside
    dt = theta0.dtype
    cos_r = torch.cos(radius)
    v0 = ang2vec(theta0, phi0)

    # candidate rings from the first at or below the top of the disc
    z_hi = torch.cos(torch.clamp(theta0 - radius, min=0.0))
    ring_lo = torch.clamp(z_to_ring(n, z_hi), 1, 4 * n - 1)
    k = torch.arange(n_rings, device=theta0.device)
    rings_raw = ring_lo[..., None] + k
    ring_ok = rings_raw <= 4 * n - 1      # the clamped last ring once
    rings = torch.clamp(rings_raw, 1, 4 * n - 1)

    z, start, npr, shift = ring_info(n, rings, dt)
    dphi_pix = 2.0 * math.pi / npr.to(dt)

    # the disc's phi half-width on each ring
    st0 = torch.sin(theta0)[..., None]
    ct0 = torch.cos(theta0)[..., None]
    st = torch.sqrt(torch.clamp(1.0 - z * z, min=1e-30))
    cosdphi = (cos_r[..., None] - z * ct0) / (st * st0 + 1e-30)
    no_overlap = cosdphi > 1.0

    # the pixel nearest the centre in each ring and symmetric offsets
    t = phi0[..., None] / dphi_pix - shift
    j_center = torch.round(t).to(torch.int64)
    m = torch.arange(n_phi, device=theta0.device) - (n_phi // 2)
    j = j_center[..., None] + m                     # (..., NR, NP)
    pix = start[..., None] + torch.remainder(j, npr[..., None])

    inside = (pix2vec(n, pix, dt) * v0[..., None, None, :]).sum(-1) \
        >= cos_r[..., None, None]
    valid = inside & ~no_overlap[..., None] & ring_ok[..., None]
    # candidate slots that alias the same pixel (a ring shorter than NP)
    span = torch.clamp(npr[..., None], max=n_phi)
    half = _floordiv(span, 2)
    return pix, valid & (m >= -half) & (m < span - half)


# ----- NESTED ordering -----
#
# The cell-major pass wants the fine pixels of any coarse cell contiguous
# in memory, which is the NESTED hierarchy: fine nested pixel p at nside
# belongs to coarse nested cell p >> 2k at nside >> k. The conversions
# follow the HEALPix (face, x, y) decomposition (Gorski et al. 2005), as
# int64 bit arithmetic on the ids' device.

_JRLL = (2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4)
_JPLL = (1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7)


def _face_table(table, face):
    return torch.tensor(table, dtype=torch.int64, device=face.device)[face]


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _compress_bits(v):
    """Keep the even-position bits of v (int64, >= 0) and pack them."""
    v = v & 0x5555555555555555
    v = (v | (v >> 1)) & 0x3333333333333333
    v = (v | (v >> 2)) & 0x0F0F0F0F0F0F0F0F
    v = (v | (v >> 4)) & 0x00FF00FF00FF00FF
    v = (v | (v >> 8)) & 0x0000FFFF0000FFFF
    v = (v | (v >> 16)) & 0x00000000FFFFFFFF
    return v


def _spread_bits(v):
    """Inverse of _compress_bits: spread the bits to even positions."""
    v = v & 0x00000000FFFFFFFF
    v = (v | (v << 16)) & 0x0000FFFF0000FFFF
    v = (v | (v << 8)) & 0x00FF00FF00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0F
    v = (v | (v << 2)) & 0x3333333333333333
    v = (v | (v << 1)) & 0x5555555555555555
    return v


def nest2ring(nside, ipnest):
    """NESTED -> RING pixel ids (int64 tensor on the ids' device)."""
    n = int(nside)
    p = ipnest.to(torch.int64)
    face = _floordiv(p, n * n)
    rem = p - face * n * n
    x = _compress_bits(rem)
    y = _compress_bits(rem >> 1)

    jr = _face_table(_JRLL, face) * n - x - y - 1      # ring 1..4n-1
    npx = 12 * n * n
    ncap = 2 * n * (n - 1)
    north = jr < n
    south = jr > 3 * n
    nr = torch.where(north, jr, torch.where(south, 4 * n - jr, n))
    start = torch.where(north, 2 * nr * (nr - 1),
                        torch.where(south, npx - 2 * nr * (nr + 1),
                                    ncap + (jr - n) * 4 * n))
    kshift = torch.where(north | south, 0, (jr - n) & 1)
    jp = _floordiv(_face_table(_JPLL, face) * nr + x - y + 1 + kshift, 2)
    jp = torch.where(jp > 4 * nr, jp - 4 * nr, jp)
    jp = torch.where(jp < 1, jp + 4 * nr, jp)
    return start + jp - 1


def ring2nest(nside, ipring):
    """RING -> NESTED pixel ids (int64 tensor on the ids' device). The
    cap ring number takes a square root, in float64: exact for every
    NSIDE up to 8192."""
    n = int(nside)
    p = ipring.to(torch.int64)
    npx = 12 * n * n
    ncap = 2 * n * (n - 1)
    north = p < ncap
    south = p >= npx - ncap

    def cap_ring(q):
        qh = (q + 1).to(torch.float64) * 0.5
        return (torch.floor(torch.sqrt(torch.clamp(
            qh - torch.sqrt(torch.floor(qh)), min=0.0))) + 1).to(torch.int64)

    i_n = cap_ring(p)
    i_s = cap_ring(npx - 1 - p)
    jr = torch.where(north, i_n, torch.where(
        south, 4 * n - i_s, _floordiv(p - ncap, 4 * n) + n))
    nr = torch.where(north, i_n, torch.where(south, i_s, n))
    start = torch.where(north, 2 * nr * (nr - 1),
                        torch.where(south, npx - 2 * nr * (nr + 1),
                                    ncap + (jr - n) * 4 * n))
    jp = p - start + 1
    kshift = torch.where(north | south, 0, (jr - n) & 1)

    # face from the ring coordinates
    ire = jr - n + 1                          # 1..2n+1 in the equator
    irm = 2 * n + 2 - ire
    ifm = _floordiv(jp - _floordiv(ire, 2) + n - 1, n)
    ifp = _floordiv(jp - _floordiv(irm, 2) + n - 1, n)
    face_eq = torch.where(ifp == ifm, (ifp & 3) + 4,
                          torch.where(ifp < ifm, ifp & 3, (ifm & 3) + 8))
    nr_safe = torch.clamp(nr, min=1)
    face_n = _floordiv(jp - 1, nr_safe)       # north cap: faces 0..3
    face_s = 8 + _floordiv(jp - 1, nr_safe)
    face = torch.where(north, face_n, torch.where(south, face_s, face_eq))

    irt = jr - _face_table(_JRLL, face) * n + 1      # -n+1 .. 0
    ipt = 2 * jp - _face_table(_JPLL, face) * nr - kshift - 1
    ipt = torch.where(ipt >= 2 * n, ipt - 8 * n, ipt)
    x = _floordiv(ipt - irt, 2)
    y = _floordiv(-ipt - irt, 2)
    return face * n * n + (_spread_bits(x) | (_spread_bits(y) << 1))


def nest2ring_all(nside, device):
    """RING id of every NESTED pixel, in NESTED order (int64 on
    ``device``)."""
    return nest2ring(nside, torch.arange(npix(nside), device=device))


@lru_cache(maxsize=8)
def _udgrade_index(nside_in, nside_out, device):
    """RING id of every NESTED pixel at both resolutions (int64 on
    ``device``), cached per NSIDE pair and device."""
    return nest2ring_all(nside_in, device), nest2ring_all(nside_out, device)


def ud_grade(hmap, nside_out, power=0.0):
    """Up- or downgrade a RING map (healpy.ud_grade, on the map's device):
    degrading averages each output pixel's NESTED children (summed in
    order), upgrading
    copies the parent into its children. The result is divided by
    (nside_in / nside_out) ** power: power = -2 keeps the map's sum (mass
    maps), 0 its mean. Integer maps are promoted to float (an average of
    children is no integer). Bad pixels (UNSEEN) are not treated apart.
    """
    if not (hmap.is_floating_point() or hmap.is_complex()):
        hmap = hmap.to(torch.promote_types(hmap.dtype, torch.float32))
    npix_in = hmap.shape[-1]
    nside_in = int(round(math.sqrt(npix_in / 12)))
    if 12 * nside_in ** 2 != npix_in:
        raise ValueError(f"ud_grade: invalid map size {npix_in}")
    nside_out = int(nside_out)
    r_in, r_out = _udgrade_index(nside_in, nside_out, hmap.device)
    lead = hmap.shape[:-1]
    if nside_out <= nside_in:
        k = (nside_in // nside_out) ** 2
        # the children summed in NESTED order (a scan's last element: a
        # sequential sum on the CPU, as XLA's), then divided by their count
        vals = hmap[..., r_in].reshape(lead + (-1, k)).cumsum(dim=-1)[
            ..., -1] / k
    else:
        k = (nside_out // nside_in) ** 2
        vals = torch.repeat_interleave(hmap[..., r_in], k, dim=-1)
    out = torch.zeros(lead + (12 * nside_out ** 2,), dtype=hmap.dtype,
                      device=hmap.device)
    out[..., r_out] = vals
    if power:
        out = out / torch.tensor((nside_in / nside_out) ** power,
                                 dtype=hmap.dtype, device=hmap.device)
    return out
