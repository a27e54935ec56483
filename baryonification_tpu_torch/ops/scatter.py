"""Conservative scatter-add redeposits (regridding).

The port of ``baryonification_tpu.ops.scatter``, on top of
``ops.scatter_cuda.scatter_add_accum``: on CUDA tensors every deposit is
one launch of the hand-written kernel ``csrc/scatter_add.cu`` (unsorted
rows, no sort); on CPU tensors it is that kernel's plain version.

- ``regrid_healpix``: each displaced pixel's value spread over its 4
  neighbour pixels with given weights;
- ``cic_deposit_2d`` / ``cic_deposit_3d``: unit pixels (cells) redeposited
  at displaced fractional positions on a periodic grid. The exact overlap
  of a shifted unit pixel with the grid is the 2^d-corner cloud-in-cell
  hat, so the deposit is one CIC scatter-add of 2^d rows per pixel.

The deposits accumulate in float64 by default: the mass-conservation
check after a regrid needs sums better than float32's at millions of
pixels. The runners pass their hot-path dtype.
"""

import torch

from .scatter_cuda import scatter_add_accum

__all__ = ["scatter_add_1d", "regrid_healpix", "cic_deposit_2d",
           "cic_deposit_3d"]


def scatter_add_1d(size, idx, vals, dtype=None):
    """``out[idx] += vals`` into a fresh zeros(size) tensor; rows with
    idx >= size are dropped."""
    dtype = dtype or vals.dtype
    out = torch.zeros(size, dtype=dtype, device=vals.device)
    (out,) = scatter_add_accum((out,), idx.reshape(-1),
                               (vals.reshape(-1).to(dtype),))
    return out


def regrid_healpix(npix_out, parent_vals, child_pix, child_weights,
                   dtype=torch.float64):
    """Spread each parent value over its 4 neighbour pixels.

    parent_vals : (N,) values of the displaced pixels
    child_pix : (N, 4) destination pixel ids
    child_weights : (N, 4) weights (summing to 1 per row)
    """
    contrib = (child_weights * parent_vals[:, None]).reshape(-1)
    return scatter_add_1d(npix_out, child_pix.reshape(-1).to(torch.int32),
                          contrib, dtype=dtype)


def _cic_rows(N, pos, vals, dtype):
    """Flat destination ids and values of the 2^d CIC corner rows of
    every position (corner-major, as the JAX package orders them).
    ``torch.remainder`` wraps negative positions as ``jnp.mod`` does (a
    value that rounds up to N wraps to index 0 with weight 1 there)."""
    x = [torch.remainder(p, N) for p in pos]
    x0 = [torch.floor(c).to(torch.int32) for c in x]
    frac = [c - c0 for c, c0 in zip(x, x0)]
    v = vals.to(dtype)
    dim = len(pos)
    idx_rows, val_rows = [], []
    for corner in range(2 ** dim):
        flat, w = 0, v
        for d in range(dim):
            b = (corner >> (dim - 1 - d)) & 1
            flat = flat * N + torch.remainder(x0[d] + b, N)
            w = w * (frac[d] if b else 1.0 - frac[d])
        idx_rows.append(flat)
        val_rows.append(w)
    return torch.cat(idx_rows), torch.cat(val_rows)


def cic_deposit_2d(N, pos_x, pos_y, vals, dtype=torch.float64):
    """Deposit unit squares centred on (pos_x, pos_y) (in pixel units)
    onto an (N, N) periodic grid, axis order grid[ix, iy]."""
    idx, val = _cic_rows(N, (pos_x, pos_y), vals, dtype)
    return scatter_add_1d(N * N, idx, val, dtype=dtype).reshape(N, N)


def cic_deposit_3d(N, pos_x, pos_y, pos_z, vals, dtype=torch.float64):
    """3D version of :func:`cic_deposit_2d` onto an (N, N, N) periodic
    grid, axis order grid[ix, iy, iz]. The kernel takes fewer than 2^31
    rows, so 8 N^3 < 2^31: N <= 645."""
    idx, val = _cic_rows(N, (pos_x, pos_y, pos_z), vals, dtype)
    return scatter_add_1d(N ** 3, idx, val, dtype=dtype).reshape(N, N, N)
