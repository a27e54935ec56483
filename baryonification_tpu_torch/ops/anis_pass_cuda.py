"""Anisotropic (density-dependent) 2D paint pass: the hand-written Hopper
kernels.

For one bucket of halos, every pixel of a block-major N^2 map (pixel
c B^2 + f of Morton block block0 + c) reads the remap rows of its block's
first ``counts[c]`` candidates at the log of the canvas value there and
paints exp of the lerp of two nodes where the pixel lies in the halo's
cutout window, within its reach of the window's centre, and the canvas
value in the row's range. :func:`anis_pass` writes the new plane;
:func:`anis_vjp` is the pass's VJP with respect to the rows and the
canvas for a cotangent plane. Both are kernels of ``csrc/anis_pass.cu``
and replace the candidate loop of the JAX package's
``grid_anis_paint_pass_2d``
(``baryonification_tpu/runners/grid_cellmajor.py:722``; XLA there) and the
first order of its autodiff.

The inputs are a ``runners.grid_cellmajor._AnisBucket``'s (its
``kernel_args``): the block size ``B``, the map's ``N``, the first block
``block0``, the candidates ``dense`` (ncell, K) and ``counts`` (ncell,),
each halo's half-window ``hh`` (H,), window start ``lo`` (H, 2), all int32,
its reach (H,) and ``live_h`` (H,) bool, the ``rows`` (H, n_hi + 2) (ln
Paint on the uniform ln Canvas grid from ``q0`` in steps ``dq``, then the
row's canvas range) and the block-major ``canvas`` (ncell B^2,); ``res`` is
the pixel size. The plain version of both entries is the step loop of
``runners.grid_cellmajor`` (``_bucket_pass``, ``_bucket_vjp``) on that
bucket, which the runners take for CPU tensors. These entries take CUDA
tensors only: any other device raises, and nothing runs in their place. A
build or launch error raises.

One thread a pixel: its canvas terms are taken once, its slots walked in
slot order and summed in registers, and it is written once (no atomics:
the pass is deterministic). The adjoint writes the canvas gradient the
same way and adds the rows' with atomic adds (in no fixed order), merged
over a warp's lanes that land on the same nodes. Pixel and row indices
are 32-bit: ``ncell * B^2`` and ``H * (n_hi + 2)`` past 2^31 - 1 raise.

``LAUNCHES`` counts kernel launches by entry. A ``tally`` (a (3,) int64
CUDA tensor, for a runner's census, the tests and ``chip_smoke.py``) gets
the launch's counts of :data:`TALLY` added to it: pixel-slots listed (a
live halo's slot, once a pixel of its block), pixel-slots inside (those
that pass the geometry's tests), and the adjoint's global atomic adds.
"""

import ctypes

import torch

from .._cuda_build import load_library

__all__ = ["anis_pass", "anis_vjp", "LAUNCHES", "TALLY"]

#: kernel launches by entry name (read and reset by callers)
LAUNCHES = {"anis_pass": 0, "anis_vjp": 0}

#: the counts of a ``tally``
TALLY = ("slots", "inside", "atomics")

_FUNCS = {}
_I32_MAX = 2 ** 31 - 1


def _kernel(dtype, entry="anis_pass"):
    """The ctypes function of ``entry`` (anis_pass or anis_vjp) for
    ``dtype``, building the library at first use."""
    key = (entry, dtype)
    if key not in _FUNCS:
        lib = load_library("anis_pass")
        sfx = {torch.float32: "_f32", torch.float64: "_f64"}[dtype]
        fn = getattr(lib, entry + sfx)
        P, I, L, D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_double)
        fn.argtypes = [P] * 11 + [L] * 3 + [I] * 3 + [L] + [D] * 3 + [P, P]
        fn.restype = I
        _FUNCS[key] = fn
    return _FUNCS[key]


def _check(entry, B, N, block0, dense, counts, hh, lo, reach, live_h, rows,
           canvas, tally):
    """Argument checks of both entries; returns ncell."""
    dt, dev = rows.dtype, rows.device
    if dev.type != "cuda":
        raise ValueError(f"{entry} runs on CUDA tensors only, not on {dev} "
                         f"(the plain version is runners.grid_cellmajor."
                         f"_bucket_pass / _bucket_vjp on an _AnisBucket)")
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"rows must be float32 or float64, got {dt}")
    if rows.dim() != 2 or rows.shape[1] < 4:
        raise ValueError("rows must be (H, n_hi + 2) with n_hi >= 2")
    H, S = rows.shape
    ncell = counts.shape[0] if counts.dim() == 1 else -1
    if any(t.dtype != torch.int32 for t in (dense, counts, hh, lo)) \
            or counts.dim() != 1 or dense.dim() != 2 \
            or dense.shape[0] != ncell or hh.shape != (H,) \
            or lo.shape != (H, 2):
        raise ValueError(f"dense (ncell, K), counts (ncell,), hh ({H},) and "
                         f"lo ({H}, 2) must be int32")
    if reach.dtype != dt or reach.shape != (H,) \
            or live_h.dtype != torch.bool or live_h.shape != (H,):
        raise ValueError(f"reach must be {dt} and live_h bool, both ({H},)")
    F = B * B
    if canvas.dtype != dt or canvas.shape != (ncell * F,):
        raise ValueError(f"canvas must be {dt} of shape ({ncell * F},)")
    if B < 1 or N < 1 or block0 < 0 or ncell * F > _I32_MAX \
            or H * S > _I32_MAX or block0 + ncell > 2 ** 32 - 1:
        raise ValueError(f"B = {B}, N = {N}, ncell * B^2 = {ncell * F} and "
                         f"H * (n_hi + 2) = {H * S} must lie in [1, 2^31), "
                         f"block0 = {block0} in [0, 2^32 - ncell): the "
                         f"kernels' pixel and row indices are 32-bit")
    if tally is not None and (tally.dtype != torch.int64
                              or tally.shape != (len(TALLY),)):
        raise ValueError(f"tally must be {len(TALLY)} int64")
    for t in (dense, counts, hh, lo, reach, live_h, rows, canvas) + (
            () if tally is None else (tally,)):
        if t.device != dev:
            raise ValueError(f"all tensors must be on {dev}, found one on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{entry} takes contiguous tensors")
    return ncell


def _launch(entry, B, N, block0, dense, counts, hh, lo, reach, live_h, rows,
            canvas, ct, out, d_rows, q0, dq, res, tally):
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _kernel(rows.dtype, entry)(
        dense.data_ptr(), counts.data_ptr(), hh.data_ptr(), lo.data_ptr(),
        reach.data_ptr(), live_h.data_ptr(), rows.data_ptr(),
        canvas.data_ptr(), ptr(ct), ptr(out), ptr(d_rows), counts.shape[0],
        dense.shape[1], rows.shape[0], rows.shape[1], B, N, block0,
        float(q0), float(dq), float(res), ptr(tally),
        torch.cuda.current_stream(rows.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    LAUNCHES[entry] += 1


def anis_pass(B, N, block0, dense, counts, hh, lo, reach, live_h, rows,
              canvas, q0, dq, res, tally=None):
    """One bucket's pass in one launch: returns the new block-major plane
    (ncell B^2 elements), each pixel written once (blocks without
    candidates 0). See the module docstring."""
    ncell = _check("anis_pass", B, N, block0, dense, counts, hh, lo, reach,
                   live_h, rows, canvas, tally)
    out = torch.empty(ncell * B * B, dtype=rows.dtype, device=rows.device)
    if ncell:
        _launch("anis_pass", B, N, block0, dense, counts, hh, lo, reach,
                live_h, rows, canvas, None, out, None, q0, dq, res, tally)
    return out


def anis_vjp(B, N, block0, dense, counts, hh, lo, reach, live_h, rows,
             canvas, ct, q0, dq, res, needs=(True, True), tally=None):
    """The VJP of :func:`anis_pass` for the cotangent plane ``ct``, in one
    launch: returns (d_rows (H, n_hi + 2), summed with atomic adds in no
    fixed order of the shares merged over each warp, its range nodes 0;
    d_canvas (ncell B^2,), each pixel written once), each None where
    ``needs`` (rows, canvas) says it is not wanted."""
    ncell = _check("anis_vjp", B, N, block0, dense, counts, hh, lo, reach,
                   live_h, rows, canvas, tally)
    if ct.dtype != rows.dtype or ct.device != rows.device \
            or ct.shape != canvas.shape:
        raise ValueError(f"anis_vjp takes a cotangent plane of {rows.dtype},"
                         f" shape {tuple(canvas.shape)}, on {rows.device}")
    ct = ct.contiguous()
    d_rows = torch.zeros_like(rows) if needs[0] else None
    d_canvas = torch.empty_like(canvas) if needs[1] else None
    if ncell and (d_rows is not None or d_canvas is not None):
        _launch("anis_vjp", B, N, block0, dense, counts, hh, lo, reach,
                live_h, rows, canvas, ct, d_canvas, d_rows, q0, dq, res,
                tally)
    return d_rows, d_canvas
