"""Scatter-add: the hand-written Hopper kernel and its plain version.

``accs[c][idx] += vals[c]`` for C = 1..3 value planes, in place, with rows
whose index is >= Npix dropped (the runners' padding sentinel). This is
the port of ``baryonification_tpu.ops.scatter_pallas``: the kernel
(``csrc/scatter_add.cu``) replaces the Pallas kernel
``sorted_scatter_add_pallas``. The TPU kernel needs its rows sorted by
destination; this one adds in the card's L2 cache and takes the rows as
the runners make them, so a scatter on the card is one launch and no
sort.

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
           "scatter_add_accum_reference", "LAUNCHES"]

#: kernel launches by kernel name (read and reset by callers)
LAUNCHES = {"scatter_add": 0}

_FUNCS = {}


def _kernel(dtype):
    if dtype not in _FUNCS:
        lib = load_library("scatter_add")
        name = {torch.float32: "scatter_add_f32",
                torch.float64: "scatter_add_f64"}[dtype]
        fn = getattr(lib, name)
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, I, I, P, P, P, P, P, P, P]
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


def scatter_add_accum(accs, idx, vals):
    """``accs[c][idx] += vals[c]`` in place, rows in any order; rows with
    idx >= Npix are dropped. CUDA tensors go through the kernel in one
    launch (no sort); CPU tensors take the plain version. Returns
    ``accs``."""
    accs, vals = _check(accs, idx, vals)
    dev = accs[0].device
    if dev.type == "cpu":
        return scatter_add_accum_reference(accs, idx, vals)
    if dev.type != "cuda":
        raise ValueError(f"scatter_add_accum runs on cpu or cuda, not {dev}")
    npix = accs[0].shape[0]
    n_rows = idx.shape[0]
    if npix >= 2**31 or n_rows >= 2**31:
        raise ValueError("scatter_add_accum takes fewer than 2^31 pixels "
                         "and rows")
    if n_rows == 0:
        return accs
    # contiguous int32 rows and contiguous planes are passed as they are.
    # The launch is asynchronous; a copy made here may be freed on return
    # because the caching allocator hands its memory only to later work
    # on this same stream
    idx32 = _as_int32(idx, npix).contiguous()
    vals = tuple(v.contiguous() for v in vals)
    ptrs = [v.data_ptr() for v in vals] + [None] * (3 - len(vals))
    aptrs = [a.data_ptr() for a in accs] + [None] * (3 - len(accs))
    err = _kernel(accs[0].dtype)(
        idx32.data_ptr(), n_rows, npix, len(accs), *ptrs, *aptrs,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"scatter_add launch failed: CUDA error {err}")
    LAUNCHES["scatter_add"] += 1
    return accs


def sorted_scatter_add(accs, idx_sorted, vals_sorted):
    """:func:`scatter_add_accum` for rows sorted ascending by destination
    (the counterpart of the JAX package's ``sorted_scatter_add_pallas``).
    The same kernel runs: it sums each run of equal destinations inside a
    warp and adds once per run. Returns ``accs``."""
    return scatter_add_accum(accs, idx_sorted, vals_sorted)
