"""Scatter-add: the hand-written Hopper kernel and its plain version.

``accs[c][idx] += vals[c]`` for C = 1..3 value planes, in place, with rows
whose index is >= Npix dropped (the runners' padding sentinel). This is
the port of ``baryonification_tpu.ops.scatter_pallas``: the kernel
(``csrc/scatter_add.cu``) replaces the Pallas kernel
``sorted_scatter_add_pallas``. The TPU kernel needs its rows sorted by
destination; this one adds in the card's L2 cache and takes the rows as
the runners make them, so a scatter on the card is one launch and no
sort.

The scatter-add is differentiable, as the JAX package's
``_sorted_scatter_diff`` is: its VJP (``_sorted_scatter_bwd``) passes the
accumulators' cotangent through unchanged and gives each value row the
masked gather ``ct[c][idx[i]]`` (0 for a dropped row); the index gets no
gradient. :func:`scatter_add_accum` adds in place: under autograd it
goes through a ``torch.autograd.Function`` that marks the accumulators
dirty (``ctx.mark_dirty``), so the runners go on adding into planes that
carry a graph. The backward is :func:`scatter_add_vjp`: on CUDA tensors
the kernel ``scatter_add_vjp`` of the same source, on CPU tensors its
plain version (a masked gather); it is differentiable once more (its
VJP is the scatter-add), so Hessians pass through.

Dispatch is by the device of the tensors: CPU tensors take the plain
PyTorch versions (``scatter_add_accum_reference``,
``scatter_add_vjp_reference``); CUDA tensors take the kernels, which are
built at first use, or the call raises. There is no fallback from one to
the other. Both kernels take fewer than 2^31 rows a launch: longer inputs
go in chunks of ``CHUNK_ROWS`` rows, one launch each (the kernels take
rows in any order, so the chunks add the same as one launch would).

``LAUNCHES`` counts kernel launches by kernel name; only a launch of a
CUDA kernel adds to it.
"""

import ctypes

import torch

from .._cuda_build import load_library

__all__ = ["scatter_add_accum", "sorted_scatter_add",
           "scatter_add_accum_reference", "scatter_add_vjp",
           "scatter_add_vjp_reference", "LAUNCHES", "CHUNK_ROWS"]

#: kernel launches by kernel name (read and reset by callers)
LAUNCHES = {"scatter_add": 0, "scatter_add_vjp": 0}

#: rows a launch at most (the kernels count rows in an int)
CHUNK_ROWS = 1 << 30

_FUNCS = {}


def _kernel(dtype, entry="scatter_add"):
    key = (dtype, entry)
    if key not in _FUNCS:
        lib = load_library("scatter_add")
        suffix = {torch.float32: "_f32", torch.float64: "_f64"}[dtype]
        fn = getattr(lib, entry + suffix)
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, I, I, P, P, P, P, P, P, P]
        fn.restype = I
        _FUNCS[key] = fn
    return _FUNCS[key]


def _launch_chunks(entry, idx32, npix, srcs, dsts):
    """Launch kernel ``entry`` over the rows of ``idx32`` in chunks of at
    most CHUNK_ROWS rows. ``srcs`` / ``dsts`` are the value and
    accumulator planes (forward) or the cotangent and value-cotangent
    planes (backward); the per-row planes are cut with the rows."""
    n_rows = idx32.shape[0]
    per_row = srcs if entry == "scatter_add" else dsts
    fn = _kernel(srcs[0].dtype, entry)
    stream = torch.cuda.current_stream(idx32.device).cuda_stream
    pad = [None] * (3 - len(srcs))
    for r0 in range(0, n_rows, CHUNK_ROWS):
        n = min(CHUNK_ROWS, n_rows - r0)
        rows = [t.narrow(0, r0, n) for t in per_row]
        s = rows if entry == "scatter_add" else srcs
        d = dsts if entry == "scatter_add" else rows
        err = fn(idx32.narrow(0, r0, n).data_ptr(), n, npix, len(srcs),
                 *[t.data_ptr() for t in s], *pad,
                 *[t.data_ptr() for t in d], *pad, stream)
        if err != 0:
            raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
        LAUNCHES[entry] += 1


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


def _on_card(name, dev, npix):
    """True for CUDA tensors, False for CPU ones; raises otherwise or for
    a map of 2^31 pixels or more (the JAX package's int32 flat-index
    bound)."""
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    if npix >= 2**31:
        raise ValueError(f"{name} takes fewer than 2^31 pixels")
    return True


def _scatter_add_raw(accs, idx, vals):
    """The forward, in place, with no autograd (checked arguments)."""
    if not _on_card("scatter_add_accum", accs[0].device, accs[0].shape[0]):
        return scatter_add_accum_reference(accs, idx, vals)
    if idx.shape[0] == 0:
        return accs
    # contiguous int32 rows and contiguous planes are passed as they are.
    # The launch is asynchronous; a copy made here may be freed on return
    # because the caching allocator hands its memory only to later work
    # on this same stream
    npix = accs[0].shape[0]
    _launch_chunks("scatter_add", _as_int32(idx, npix).contiguous(), npix,
                   tuple(v.contiguous() for v in vals), accs)
    return accs


def scatter_add_vjp_reference(cts, idx):
    """Plain PyTorch version of the backward: per cotangent plane ``ct``
    (Npix), ``torch.where(idx < Npix, ct[idx], 0)`` (N rows)."""
    cts = tuple(cts)
    ok = idx < cts[0].shape[0]
    safe = torch.where(ok, idx, 0).to(torch.int64)
    return tuple(torch.where(ok, g.index_select(0, safe), 0.0) for g in cts)


def _check_vjp(cts, idx):
    cts = tuple(cts)
    if not 1 <= len(cts) <= 3:
        raise ValueError(f"need 1..3 cotangent planes, got {len(cts)}")
    g0 = cts[0]
    if g0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"cotangents must be float32 or float64, got "
                        f"{g0.dtype}")
    if idx.dtype not in (torch.int32, torch.int64) or idx.dim() != 1:
        raise TypeError(f"idx must be a 1-D int32/int64 tensor, got "
                        f"{idx.dtype} of shape {tuple(idx.shape)}")
    for g in cts + (idx,):
        if g.device != g0.device:
            raise ValueError(f"all tensors must be on {g0.device}, found "
                             f"one on {g.device}")
    for g in cts:
        if g.dtype != g0.dtype or g.shape != g0.shape or g.dim() != 1:
            raise ValueError("cotangent planes must be 1-D, of one shape "
                             "and dtype")
    return cts


def _scatter_add_vjp_raw(cts, idx):
    cts = _check_vjp(cts, idx)
    npix = cts[0].shape[0]
    if not _on_card("scatter_add_vjp", cts[0].device, npix):
        return scatter_add_vjp_reference(cts, idx)
    cts = tuple(g.contiguous() for g in cts)
    out = tuple(torch.empty(idx.shape[0], dtype=cts[0].dtype,
                            device=cts[0].device) for _ in cts)
    if idx.shape[0]:
        _launch_chunks("scatter_add_vjp", _as_int32(idx, npix).contiguous(),
                       npix, cts, out)
    return out


class _ScatterAddFn(torch.autograd.Function):
    """accs[c][idx] += vals[c] in place (the accumulators marked dirty);
    differentiable in the accumulators and the values."""

    @staticmethod
    def forward(ctx, idx, n_acc, *planes):
        accs, vals = planes[:n_acc], planes[n_acc:]
        _scatter_add_raw(accs, idx, vals)
        ctx.mark_dirty(*accs)
        ctx.save_for_backward(idx)
        return accs

    @staticmethod
    def backward(ctx, *cts):
        (idx,) = ctx.saved_tensors
        n = len(cts)
        need = ctx.needs_input_grad[2:]
        d_vals = (_VjpFn.apply(idx, *cts) if any(need[n:])
                  else (None,) * n)
        return ((None, None) + tuple(g if k else None
                                     for g, k in zip(cts, need[:n]))
                + tuple(d if k else None for d, k in zip(d_vals, need[n:])))


class _VjpFn(torch.autograd.Function):
    """The masked gather d[c] = where(idx < Npix, ct[c][idx], 0); its own
    VJP is the scatter-add of the incoming rows."""

    @staticmethod
    def forward(ctx, idx, *cts):
        ctx.save_for_backward(idx)
        ctx.npix = cts[0].shape[0]
        return _scatter_add_vjp_raw(cts, idx)

    @staticmethod
    def backward(ctx, *d):
        (idx,) = ctx.saved_tensors
        accs = tuple(torch.zeros(ctx.npix, dtype=g.dtype, device=g.device)
                     for g in d)
        return (None,) + scatter_add_accum(accs, idx, d)


def scatter_add_vjp(cts, idx):
    """The scatter-add's backward for the values: per cotangent plane
    ``ct`` (Npix), ``ct[idx]`` at rows with idx < Npix and 0 at the
    dropped rows. CUDA tensors go through the kernel (one launch a
    CHUNK_ROWS rows, 1-3 planes a launch); CPU tensors take the plain
    version. Differentiable in ``cts``. Returns a tuple of (N,) planes."""
    return _VjpFn.apply(idx, *tuple(cts))


def scatter_add_accum(accs, idx, vals):
    """``accs[c][idx] += vals[c]`` in place, rows in any order; rows with
    idx >= Npix are dropped. CUDA tensors go through the kernel (one
    launch a CHUNK_ROWS rows, no sort); CPU tensors take the plain
    version. Where an accumulator or a value plane requires grad (and
    grad mode is on), the call is recorded for autograd: the
    accumulators' version moves as for any in-place op, and their
    gradient history becomes this scatter's. Returns ``accs``."""
    accs, vals = _check(accs, idx, vals)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in accs + vals):
        return _ScatterAddFn.apply(idx, len(accs), *accs, *vals)
    return _scatter_add_raw(accs, idx, vals)


def sorted_scatter_add(accs, idx_sorted, vals_sorted):
    """:func:`scatter_add_accum` for rows sorted ascending by destination
    (the counterpart of the JAX package's ``sorted_scatter_add_pallas``).
    The same kernel runs: it sums each run of equal destinations inside a
    warp and adds once per run. Returns ``accs``."""
    return scatter_add_accum(accs, idx_sorted, vals_sorted)
