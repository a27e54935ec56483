"""Conservative scatter-add redeposits (regridding).

The port of ``baryonification_tpu.ops.scatter``, on top of
``ops.scatter_cuda.scatter_add_accum``: on CUDA tensors every scatter-add
is a launch of the hand-written kernel ``csrc/scatter_add.cu`` (unsorted
rows, no sort); on CPU tensors it is that kernel's plain version.

- ``regrid_healpix``: each displaced pixel's value spread over its 4
  neighbour pixels with given weights;
- ``cic_deposit_2d`` / ``cic_deposit_3d``: unit pixels (cells) redeposited
  at displaced fractional positions on a periodic grid. The exact overlap
  of a shifted unit pixel with the grid is the 2^d-corner cloud-in-cell
  hat, so the deposit adds 2^d rows per pixel, one scatter-add a
  corner.

The deposits accumulate in float64 by default: the mass-conservation
check after a regrid needs sums better than float32's at millions of
pixels. The runners pass their hot-path dtype.

Every deposit is differentiable, as in the JAX package: the scatter-add's
backward (``scatter_cuda.scatter_add_vjp``, a kernel on the card) gives
the gradient in the values, and through the CIC weights the gradient
reaches the positions (the floor of a position is piecewise constant, so
only the weights carry it). A deposit takes up to 2^31 - 1 destination
pixels (the JAX package's int32 flat index) and scatters one CIC corner
at a time, N^d rows a call, so its memory grows as the positions' and
one corner's rows, not as all 2^d N^d rows at once.
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


def _cic_corners(N, pos, vals, dtype):
    """Yield the (flat destination ids, values) of the N^d rows of each
    of the 2^d CIC corners in turn, corners in the JAX package's order.
    ``torch.remainder`` wraps negative positions as ``jnp.mod`` does (a
    value that rounds up to N wraps to index 0 with weight 1 there)."""
    x = [torch.remainder(p, N) for p in pos]
    x0 = [torch.floor(c).to(torch.int32) for c in x]
    frac = [c - c0 for c, c0 in zip(x, x0)]
    v = vals.to(dtype)
    dim = len(pos)
    for corner in range(2 ** dim):
        flat, w = 0, v
        for d in range(dim):
            b = (corner >> (dim - 1 - d)) & 1
            flat = flat * N + torch.remainder(x0[d] + b, N)
            w = w * (frac[d] if b else 1.0 - frac[d])
        yield flat.reshape(-1), w.reshape(-1)


def _cic_deposit(N, pos, vals, dtype):
    """Deposit ``vals`` at ``pos`` (pixel units, one tensor an axis) onto
    the flat periodic N^d grid: one scatter-add a CIC corner, so only one
    corner's rows exist at a time. On the CPU the sum is the JAX
    package's, bit for bit: ``index_add_`` adds the rows in order, and
    the JAX package's rows are these, corner-major, in one call."""
    out = torch.zeros(N ** len(pos), dtype=dtype, device=vals.device)
    for idx, w in _cic_corners(N, pos, vals, dtype):
        (out,) = scatter_add_accum((out,), idx, (w,))
    return out


def cic_deposit_2d(N, pos_x, pos_y, vals, dtype=torch.float64):
    """Deposit unit squares centred on (pos_x, pos_y) (in pixel units)
    onto an (N, N) periodic grid, axis order grid[ix, iy]."""
    return _cic_deposit(N, (pos_x, pos_y), vals, dtype).reshape(N, N)


def cic_deposit_3d(N, pos_x, pos_y, pos_z, vals, dtype=torch.float64):
    """3D version of :func:`cic_deposit_2d` onto an (N, N, N) periodic
    grid, axis order grid[ix, iy, iz]."""
    return _cic_deposit(N, (pos_x, pos_y, pos_z), vals, dtype).reshape(
        N, N, N)
