"""Interpolation primitives on batched tensors.

The port of ``baryonification_tpu.ops.interp``. Where the JAX package
writes a function for one curve and ``vmap``s it, these functions take
the batch as leading dimensions: ``(..., N)`` curves, with the knots
``x`` either shared ``(N,)`` or per curve ``(..., N)``.

- ``pchip_*``: Fritsch-Carlson monotone cubic (scipy
  ``PchipInterpolator``), used by every mass-profile inversion;
- ``searchsorted_interp``: linear with the end values clamped
  (``jnp.interp``);
- ``masked_compact``: fixed-shape compaction of masked curves;
- ``ndlinear_interp``: multilinear interpolation, NaN outside the grid;
- ``blend_table_radial`` (``blend_rows``) + ``radial_readout``: the
  runners' per-halo table readout.
"""

import math

import torch

from ..utils import interp

__all__ = ["pchip_derivatives", "pchip_eval", "pchip_interp",
           "searchsorted_interp", "masked_compact",
           "ndlinear_interp", "blend_table_radial", "blend_rows",
           "radial_readout"]


def pchip_derivatives(x, y):
    """Fritsch-Carlson endpoint-corrected derivatives for monotone cubics.

    x : (N,) or (..., N) strictly increasing; y : (..., N). Returns d with
    y's shape (scipy PchipInterpolator's derivative choices).
    """
    h = torch.diff(x, dim=-1)            # (N-1,) or (..., N-1)
    m = torch.diff(y, dim=-1) / h        # slopes, (..., N-1)

    hk = h[..., 1:]                      # h_k,   k = 1..N-2
    hkm1 = h[..., :-1]                   # h_{k-1}
    mk = m[..., 1:]
    mkm1 = m[..., :-1]
    w1 = 2.0 * hk + hkm1
    w2 = hk + 2.0 * hkm1
    # harmonic-weighted mean where slopes agree in sign, else 0
    denom = (w1 / torch.where(mkm1 == 0.0, 1.0, mkm1)
             + w2 / torch.where(mk == 0.0, 1.0, mk))
    d_int = torch.where(torch.sign(mkm1) * torch.sign(mk) > 0.0,
                        (w1 + w2) / denom, 0.0)

    def _edge(h0, h1, m0, m1):
        d = ((2.0 * h0 + h1) * m0 - h0 * m1) / (h0 + h1)
        d = torch.where(torch.sign(d) != torch.sign(m0), 0.0, d)
        d = torch.where((torch.sign(m0) != torch.sign(m1))
                        & (d.abs() > 3.0 * m0.abs()), 3.0 * m0, d)
        return d

    d0 = _edge(h[..., 0], h[..., 1], m[..., 0], m[..., 1])
    dN = _edge(h[..., -1], h[..., -2], m[..., -1], m[..., -2])
    return torch.cat([d0[..., None], d_int, dN[..., None]], dim=-1)


def pchip_eval(xq, x, y, d, extrapolate=True, deriv=0):
    """Evaluate the cubic Hermite defined by (x, y, d) at xq.

    x : (N,) shared or (..., N) per curve; y, d : (..., N);
    xq : (..., Q) or (Q,), broadcast against the curves' leading dims.
    Returns (..., Q). With extrapolate=True the end cubics are extended
    (scipy behaviour); otherwise out-of-range queries return NaN.
    ``deriv=1`` evaluates the first derivative instead.
    """
    N = x.shape[-1]
    lead = y.shape[:-1]
    xq = torch.broadcast_to(xq, lead + xq.shape[-1:]).contiguous()
    if x.dim() == 1:
        i = torch.clamp(torch.searchsorted(x, xq, right=True) - 1, 0, N - 2)
        x_i, x_i1 = x[i], x[i + 1]
        x0, xN = x[0], x[-1]
    else:
        x = torch.broadcast_to(x, lead + (N,)).contiguous()
        i = torch.clamp(torch.searchsorted(x, xq, right=True) - 1, 0, N - 2)
        x_i = torch.gather(x, -1, i)
        x_i1 = torch.gather(x, -1, i + 1)
        x0, xN = x[..., :1], x[..., -1:]
    y_i, y_i1 = torch.gather(y, -1, i), torch.gather(y, -1, i + 1)
    d_i, d_i1 = torch.gather(d, -1, i), torch.gather(d, -1, i + 1)
    hi = x_i1 - x_i
    t = (xq - x_i) / hi
    t2 = t * t
    if deriv == 0:
        t3 = t2 * t
        h00 = 2.0 * t3 - 3.0 * t2 + 1.0
        h10 = t3 - 2.0 * t2 + t
        h01 = -2.0 * t3 + 3.0 * t2
        h11 = t3 - t2
        out = h00 * y_i + h10 * hi * d_i + h01 * y_i1 + h11 * hi * d_i1
    elif deriv == 1:
        g00 = (6.0 * t2 - 6.0 * t) / hi
        g10 = 3.0 * t2 - 4.0 * t + 1.0
        g01 = (-6.0 * t2 + 6.0 * t) / hi
        g11 = 3.0 * t2 - 2.0 * t
        out = g00 * y_i + g10 * d_i + g01 * y_i1 + g11 * d_i1
    else:
        raise ValueError("deriv must be 0 or 1")
    if not extrapolate:
        out = torch.where((xq < x0) | (xq > xN), math.nan, out)
    return out


def pchip_interp(xq, x, y, extrapolate=True):
    """One-shot monotone cubic interpolation of the curves (x, y) at xq
    (shapes as :func:`pchip_eval`)."""
    return pchip_eval(xq, x, y, pchip_derivatives(x, y),
                      extrapolate=extrapolate)


def searchsorted_interp(xq, x, y):
    """Linear interpolation with the end values clamped (``jnp.interp``;
    ``utils.interp``)."""
    return interp(xq, x, y)


def masked_compact(x, y, mask, pad_dx=1.0):
    """Compact the valid points of masked curves to the array front.

    Fixed-shape replacement for ``x[mask], y[mask]`` on each curve: valid
    entries keep their order at the front; the tail is filled with a
    monotone x continuation and constant y so a pchip stays well defined.
    x, y : (N,) or (..., N); mask : (..., N). Returns (xc, yc, x_hi), where
    x_hi (...,) is the largest valid x of each curve.
    """
    lead = mask.shape[:-1]
    N = mask.shape[-1]
    x = torch.broadcast_to(x, lead + (N,))
    y = torch.broadcast_to(y, lead + (N,))
    key = torch.where(mask, 0, 1)
    order = torch.sort(key, dim=-1, stable=True).indices
    xc = torch.gather(x, -1, order)
    yc = torch.gather(y, -1, order)
    last = torch.clamp(mask.sum(dim=-1) - 1, min=0)[..., None]
    x_hi = torch.gather(xc, -1, last)
    y_hi = torch.gather(yc, -1, last)
    j = torch.arange(N, device=mask.device)
    tail = j > last
    xc = torch.where(tail, x_hi + (j - last).to(xc.dtype) * pad_dx, xc)
    yc = torch.where(tail, y_hi, yc)
    return xc, yc, x_hi[..., 0]


def _bracket(g, c):
    """Cell index and fraction of c on the increasing grid g (clamped to
    the end cells), and whether c lies inside [g0, gN]."""
    i = torch.clamp(torch.searchsorted(g, c.contiguous(), right=True) - 1,
                    0, g.shape[0] - 2)
    t = (c - g[i]) / (g[i + 1] - g[i])
    return i, t, (c >= g[0]) & (c <= g[-1])


def blend_table_radial(grids, table, scalar_coords):
    """Blend a (z, M, r [, props...]) table down to one radial profile
    per halo.

    ``scalar_coords`` are (H,) per-halo coordinates for every axis except
    r (axis 2). Returns the (H, Nr) profiles, NaN outside the non-r
    bounds. With :func:`radial_readout` this turns a 2^D-corner readout
    per pixel into a 1-D lerp per pixel.
    """
    other_axes = [0, 1] + list(range(3, len(grids)))
    return blend_rows([grids[ax] for ax in other_axes],
                      table.movedim(2, -1), scalar_coords)


def blend_rows(grids, table_r, coords):
    """Multilinear blend of ``table_r`` (len(g) for g in grids..., Nr)
    over its leading axes at (H,) per-row coordinates ``coords``, one per
    grid: the (H, Nr) rows, NaN where a coordinate lies outside its
    grid."""
    idxs, ws = [], []
    inb = True
    for g, c in zip(grids, coords):
        i, t, ok = _bracket(g, c)
        inb = inb & ok
        idxs.append(i)
        ws.append(t)

    prof = 0.0
    for corner in range(2 ** len(grids)):
        w = 1.0
        ind = []
        for d in range(len(grids)):
            b = (corner >> d) & 1
            ind.append(idxs[d] + b)
            w = w * (ws[d] if b else 1.0 - ws[d])
        prof = prof + w[:, None] * table_r[tuple(ind)]
    return torch.where(inb[:, None], prof, math.nan)


def radial_readout(prof, lnr_grid, lnr):
    """Linear interpolation of (H, Nr) radial profiles on their uniform
    log grid at (H, P) points, NaN outside the range."""
    g0 = lnr_grid[0]
    dg = lnr_grid[1] - lnr_grid[0]
    t = (lnr - g0) / dg
    i = torch.clamp(torch.floor(t).to(torch.int64), 0,
                    lnr_grid.shape[0] - 2)
    w = t - i
    out = (1.0 - w) * torch.gather(prof, -1, i) \
        + w * torch.gather(prof, -1, i + 1)
    inb = (lnr >= g0) & (lnr <= lnr_grid[-1])
    return torch.where(inb, out, math.nan)


def ndlinear_interp(grids, values, coords, fill_value=math.nan):
    """Multilinear interpolation on a rectilinear N-D grid.

    grids  : tuple of D strictly-increasing 1-D tensors
    values : tensor of shape (len(g) for g in grids)
    coords : tuple of D broadcastable query tensors
    Out-of-bounds queries return ``fill_value`` (scipy
    RegularGridInterpolator with bounds_error=False semantics).
    """
    coords = torch.broadcast_tensors(*coords)
    idx, frac = [], []
    inb = torch.ones(coords[0].shape, dtype=torch.bool,
                     device=values.device)
    for g, c in zip(grids, coords):
        i, t, ok = _bracket(g, c)
        inb = inb & ok
        idx.append(i)
        frac.append(t)

    acc = torch.zeros(coords[0].shape, dtype=values.dtype,
                      device=values.device)
    for corner in range(2 ** len(grids)):
        w = 1.0
        ind = []
        for dim in range(len(grids)):
            b = (corner >> dim) & 1
            ind.append(idx[dim] + b)
            w = w * (frac[dim] if b else 1.0 - frac[dim])
        acc = acc + values[tuple(ind)] * w
    return torch.where(inb, acc, fill_value)
