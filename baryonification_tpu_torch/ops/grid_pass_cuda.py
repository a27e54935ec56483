"""Cell-major grid pass: the hand-written Hopper kernels.

For one bucket of halos, every voxel (3D) or pixel (2D) of the bucket's
Morton blocks, in block-major order, sums the contributions of its
block's first ``counts[c]`` candidate halos: the displacement pushed
along the voxel's offset from the halo (``offsets``, ``offsets_rdelta``:
``dim`` planes in pixel units) or exp of the log profile (``paint``: one
plane), both read from the halo's radial row at ln r. :func:`grid_pass`
writes new planes; :func:`grid_vjp` is the pass's VJP with respect to
the rows for cotangent planes. Both are kernels of ``csrc/grid_pass.cu``
and replace the candidate loop of the JAX package's ``grid_offsets_pass``,
``grid_paint_pass``, ``grid_offsets_pass_2d`` and ``grid_paint_pass_2d``
(``baryonification_tpu/runners/grid_cellmajor.py:317``, ``:408``, ``:638``,
``:820``; XLA there) and the first order of their autodiff.

The inputs are a ``runners.grid_cellmajor._GridBucket``'s (its
``kernel_args``): ``hrec`` (H, hcols) per-halo columns (each halo's
offset from its nearest bin centre on every axis, its reach eps_max
R_com, ln R_com in ``offsets_rdelta``, the 2D shear matrix), ``lo`` (H,
dim) int64 window starts, ``dense`` (ncell, K) int64 candidates, ``counts``
(ncell,) int64, ``rows`` (H, n_hi) on the uniform log grid from ``g0`` in
steps ``dg`` up to node ``rad_hi``. The plain version of both entries is
that module's step loop (``_bucket_pass``, ``_bucket_vjp``), which the
runners take for CPU tensors. These entries take CUDA tensors only: any
other device raises, and nothing runs in their place. A build or launch
error raises.

The kernels take a warp's voxels of one block (a patch: a tile of 4 x 8
or 1 x 4 x 8 voxels where B is a multiple of 8, two whole blocks a warp
where a block has 16 voxels) through their block's candidates a
few slots at a time: one lane a (patch, slot) stages the slot's per-axis
terms in shared memory once and tests whether any voxel of the patch can
be inside the halo's window and reach; slots that none can reach are
skipped for the patch (the cull), the others walked in slot order, each
voxel summing in registers. The cull is conservative bit for bit:
``cull=False`` (for the tests and ``chip_smoke.py``; the runners never
pass it) walks every listed slot and gives the same planes and counts of
slots and inside. The adjoint merges the shares that a warp's lanes add
to the same nodes before its atomic adds. :func:`launch_shape` gives a
launch's shape (patch size, slots a stage, shared memory).

``LAUNCHES`` counts kernel launches by entry. A ``tally`` (a (4,) int64
CUDA tensor, for a runner's census, the tests and ``chip_smoke.py``)
gets the launch's counts of :data:`TALLY` added to it: voxel-slots
listed, voxel-slots inside (those that pass every test of the geometry),
the adjoint's global atomic adds issued and the (patch, slot) pairs that
the cull skipped.
"""

import ctypes

import torch

from .._cuda_build import load_library

__all__ = ["grid_pass", "grid_vjp", "launch_shape", "LAUNCHES", "MODES",
           "TALLY"]

#: kernel launches by entry name (read and reset by callers)
LAUNCHES = {"grid_pass": 0, "grid_vjp": 0}

#: mode name -> the kernel's mode number
MODES = {"offsets": 0, "offsets_rdelta": 1, "paint": 2}

#: the counts of a ``tally``
TALLY = ("slots", "inside", "atomics", "culled")

#: the fields of :func:`launch_shape`
SHAPE = ("L", "patches_a_warp", "slots_a_stage", "row_stride",
         "warps_a_cta", "smem_bytes")

_FUNCS = {}


def _kernel(dtype, entry="grid_pass"):
    """The ctypes function of ``entry`` (grid_pass or grid_vjp) for
    ``dtype``, building the library at first use."""
    key = (entry, dtype)
    if key not in _FUNCS:
        lib = load_library("grid_pass")
        sfx = {torch.float32: "_f32", torch.float64: "_f64"}[dtype]
        fn = getattr(lib, entry + sfx)
        P, I, L, D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_double)
        fn.argtypes = ([I, I] + [P] * 11 + [L, L, L] + [I] * 5 + [D] * 4
                       + [P, I, P])
        fn.restype = I
        _FUNCS[key] = fn
    return _FUNCS[key]


def launch_shape(mode, dim, B, dtype):
    """The shape of a launch of either entry for blocks of edge ``B``:
    dict over :data:`SHAPE` (the padded patch size L, patches a warp, slots
    a stage, the staged rows' stride in terms, warps a CTA and the CTA's
    dynamic shared memory in bytes). Builds the library at first use."""
    fn = load_library("grid_pass").grid_launch_shape
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * len(SHAPE))()
    err = fn(MODES[mode], dim, B, int(dtype == torch.float64),
             ctypes.addressof(out))
    if err != 0:
        raise ValueError(f"no launch shape for mode {mode!r}, dim {dim}, "
                         f"B {B}: error {err}")
    return dict(zip(SHAPE, out))


def _hcols(mode, dim):
    return dim + 1 + (mode == "offsets_rdelta") + (4 if dim == 2 else 0)


def _check(entry, mode, dim, B, N, half, hrec, lo, dense, counts, rows,
           tally):
    """Argument checks of both entries; returns (ncell, F)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    if dim not in (2, 3):
        raise ValueError(f"dim must be 2 or 3, got {dim}")
    dt, dev = rows.dtype, rows.device
    if dev.type != "cuda":
        raise ValueError(f"{entry} runs on CUDA tensors only, not on {dev} "
                         f"(the plain version is runners.grid_cellmajor."
                         f"_bucket_pass / _bucket_vjp)")
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"rows must be float32 or float64, got {dt}")
    H = rows.shape[0]
    if rows.dim() != 2 or rows.shape[1] < 2:
        raise ValueError("rows must be (H, n_hi >= 2)")
    if hrec.dtype != dt or hrec.shape != (H, _hcols(mode, dim)):
        raise ValueError(f"hrec must be {dt} of shape "
                         f"({H}, {_hcols(mode, dim)}) in mode {mode!r}")
    if lo.dtype != torch.int64 or lo.shape != (H, dim):
        raise ValueError(f"lo must be int64 of shape ({H}, {dim})")
    if dense.dtype != torch.int64 or counts.dtype != torch.int64 \
            or dense.dim() != 2 or counts.dim() != 1 \
            or dense.shape[0] != counts.shape[0]:
        raise ValueError("dense must be (ncell, K) and counts (ncell,), "
                         "both int64")
    if tally is not None and (tally.dtype != torch.int64
                              or tally.shape != (len(TALLY),)):
        raise ValueError(f"tally must be {len(TALLY)} int64")
    for t in (hrec, lo, dense, counts, rows) + (
            () if tally is None else (tally,)):
        if t.device != dev:
            raise ValueError(f"all tensors must be on {dev}, found one on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{entry} takes contiguous tensors")
    F = B ** dim
    ncell = counts.shape[0]
    if B < 1 or N < 1 or half < 0 or F >= 2 ** 30:
        raise ValueError(f"bad block edge {B}, grid {N} or half {half}")
    return ncell, F


def _launch(entry, mode, dim, B, N, half, block0, hrec, lo, dense, counts,
            rows, cts, outs, g0, dg, rad_hi, res, tally, cull):
    ptr = lambda ts: [t.data_ptr() for t in ts] + [None] * (3 - len(ts))
    err = _kernel(rows.dtype, entry)(
        MODES[mode], dim, hrec.data_ptr(), lo.data_ptr(), dense.data_ptr(),
        counts.data_ptr(), rows.data_ptr(), *ptr(cts), *ptr(outs),
        counts.shape[0], dense.shape[1], int(block0), B, N, half,
        rows.shape[1], hrec.shape[1], float(res), float(g0), float(dg),
        float(rad_hi), None if tally is None else tally.data_ptr(),
        int(bool(cull)), torch.cuda.current_stream(rows.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    LAUNCHES[entry] += 1


def grid_pass(mode, dim, B, N, half, block0, hrec, lo, dense, counts, rows,
              g0, dg, rad_hi, res, tally=None, cull=True):
    """One bucket's pass in one launch: returns new block-major planes
    (``dim`` offset planes in pixel units, or one paint plane; ncell B^dim
    elements each), each element written once. ``cull=False`` walks every
    slot (the same planes, bit for bit). See the module docstring."""
    ncell, F = _check("grid_pass", mode, dim, B, N, half, hrec, lo, dense,
                      counts, rows, tally)
    outs = tuple(torch.empty(ncell * F, dtype=rows.dtype, device=rows.device)
                 for _ in range(1 if mode == "paint" else dim))
    if ncell:
        _launch("grid_pass", mode, dim, B, N, half, block0, hrec, lo, dense,
                counts, rows, (), outs, g0, dg, rad_hi, res, tally, cull)
    return outs


def grid_vjp(mode, dim, B, N, half, block0, hrec, lo, dense, counts, rows,
             cts, g0, dg, rad_hi, res, tally=None, cull=True):
    """The VJP of :func:`grid_pass` with respect to ``rows`` for the
    cotangent planes ``cts`` (one a plane of the pass), in one launch:
    returns the (H, n_hi) d_rows, summed with atomic adds (in no fixed
    order) of the shares merged over each warp. ``cull=False`` walks every
    slot."""
    ncell, F = _check("grid_vjp", mode, dim, B, N, half, hrec, lo, dense,
                      counts, rows, tally)
    cts = tuple(cts)
    n_planes = 1 if mode == "paint" else dim
    if len(cts) != n_planes or any(
            c.dtype != rows.dtype or c.device != rows.device
            or c.shape != (ncell * F,) for c in cts):
        raise ValueError(f"mode {mode!r} takes {n_planes} cotangent planes "
                         f"of {rows.dtype}, shape ({ncell * F},), on "
                         f"{rows.device}")
    cts = tuple(c.contiguous() for c in cts)
    d_rows = torch.zeros_like(rows)
    if ncell:
        _launch("grid_vjp", mode, dim, B, N, half, block0, hrec, lo, dense,
                counts, rows, cts, (d_rows,), g0, dg, rad_hi, res, tally,
                cull)
    return d_rows
