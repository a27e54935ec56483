"""Sorted scatter-add: the hand-written Hopper kernel and its plain version.

``accs[c][idx] += vals[c]`` for C = 1..3 value planes, in place, with rows
whose index is >= Npix dropped (the runners' padding sentinel). This is
the port of ``baryonification_tpu.ops.scatter_pallas``: the kernel
(``csrc/sorted_scatter_add.cu``) replaces the Pallas kernel
``sorted_scatter_add_pallas``.

Dispatch is by the device of the tensors: CPU tensors take the plain
PyTorch version (``scatter_add_accum_reference``); CUDA tensors take the
kernel, which is built at first use, or the call raises. There is no
fallback from one to the other.

``LAUNCHES`` counts kernel launches by kernel name; only a launch of the
CUDA kernel adds to it.
"""

import ctypes

import torch

from .._cuda_build import load_library

__all__ = ["scatter_add_accum", "sorted_scatter_add",
           "scatter_add_accum_reference", "LAUNCHES", "BLOCK_PIX"]

#: kernel launches by kernel name (read and reset by callers)
LAUNCHES = {"sorted_scatter_add": 0}

#: destination pixels per CTA: C=3 float64 planes fill 48 KB of shared
#: memory
BLOCK_PIX = 2048

_FUNCS = {}


def _kernel(dtype):
    if dtype not in _FUNCS:
        lib = load_library("sorted_scatter_add")
        name = {torch.float32: "sorted_scatter_add_f32",
                torch.float64: "sorted_scatter_add_f64"}[dtype]
        fn = getattr(lib, name)
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, I, I, I, I, P, P, P, P, P, P, P]
        fn.restype = I
        _FUNCS[dtype] = fn
    return _FUNCS[dtype]


def _check(accs, idx, vals):
    accs, vals = tuple(accs), tuple(vals)
    if not 1 <= len(accs) <= 3 or len(vals) != len(accs):
        raise ValueError(f"need 1..3 accumulator planes and as many value "
                         f"planes, got {len(accs)} and {len(vals)}")
    a0 = accs[0]
    if a0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"accumulators must be float32 or float64, "
                        f"got {a0.dtype}")
    if idx.dtype not in (torch.int32, torch.int64) or idx.dim() != 1:
        raise TypeError(f"idx must be a 1-D int32/int64 tensor, got "
                        f"{idx.dtype} of shape {tuple(idx.shape)}")
    for t in accs + vals + (idx,):
        if t.device != a0.device:
            raise ValueError(f"all tensors must be on {a0.device}, "
                             f"found one on {t.device}")
    for a in accs:
        if a.dtype != a0.dtype or a.shape != a0.shape or a.dim() != 1:
            raise ValueError("accumulator planes must be 1-D, of one shape "
                             "and dtype")
        if not a.is_contiguous():
            raise ValueError("accumulator planes must be contiguous")
    for v in vals:
        if v.dtype != a0.dtype or v.shape != idx.shape:
            raise ValueError(f"value planes must be {a0.dtype} of shape "
                             f"{tuple(idx.shape)}")
    return accs, vals


def _as_int32(idx, npix):
    """int32 row indices for the kernel; int64 indices are clamped at the
    sentinel Npix first, so none wraps into the valid range."""
    if idx.dtype == torch.int32:
        return idx
    return torch.clamp(idx, max=npix).to(torch.int32)


def scatter_add_accum_reference(accs, idx, vals):
    """Plain PyTorch version: mask the sentinel rows (idx >= Npix), then
    ``index_add_`` each plane in place. Returns ``accs``."""
    accs, vals = _check(accs, idx, vals)
    ok = idx < accs[0].shape[0]
    keep = idx[ok].to(torch.int64)
    for a, v in zip(accs, vals):
        a.index_add_(0, keep, v[ok])
    return accs


def sorted_scatter_add(accs, idx_sorted, vals_sorted, block_pix=BLOCK_PIX):
    """``accs[c][idx_sorted] += vals_sorted[c]`` in place for rows sorted
    ascending by destination. CUDA tensors launch the kernel; CPU tensors
    take the plain version. Returns ``accs``."""
    accs, vals = _check(accs, idx_sorted, vals_sorted)
    dev = accs[0].device
    if dev.type == "cpu":
        return scatter_add_accum_reference(accs, idx_sorted, vals)
    if dev.type != "cuda":
        raise ValueError(f"sorted_scatter_add runs on cpu or cuda, not {dev}")
    npix = accs[0].shape[0]
    n_rows = idx_sorted.shape[0]
    if npix >= 2**31 or n_rows >= 2**31:
        raise ValueError("sorted_scatter_add takes fewer than 2^31 pixels "
                         "and rows")
    if n_rows == 0:
        return accs
    idx32 = _as_int32(idx_sorted, npix).contiguous()
    vals = tuple(v.contiguous() for v in vals)
    n_blocks = -(-npix // block_pix)
    # first row of each destination block; the last edge is Npix, so the
    # sentinel rows (>= Npix) fall after every block's range
    edges = torch.clamp(torch.arange(n_blocks + 1, device=dev,
                                     dtype=torch.int32) * block_pix,
                        max=npix)
    row_start = torch.searchsorted(idx32, edges, out_int32=True)
    # the launch is asynchronous; idx32, row_start and the contiguous
    # copies may be freed on return because the caching allocator hands
    # their memory only to later work on this same stream
    ptrs = [v.data_ptr() for v in vals] + [None] * (3 - len(vals))
    aptrs = [a.data_ptr() for a in accs] + [None] * (3 - len(accs))
    err = _kernel(accs[0].dtype)(
        idx32.data_ptr(), row_start.data_ptr(), n_blocks, block_pix, npix,
        len(accs), *ptrs, *aptrs, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sorted_scatter_add launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["sorted_scatter_add"] += 1
    return accs


def scatter_add_accum(accs, idx, vals):
    """``accs[c][idx] += vals[c]`` in place for unsorted rows; rows with
    idx >= Npix are dropped. CUDA tensors are sorted by destination and
    go through the kernel; CPU tensors take the plain version. Returns
    ``accs``."""
    accs, vals = _check(accs, idx, vals)
    if accs[0].device.type == "cpu":
        return scatter_add_accum_reference(accs, idx, vals)
    idx_s, order = torch.sort(_as_int32(idx, accs[0].shape[0]))
    return sorted_scatter_add(accs, idx_s, tuple(v[order] for v in vals))
