"""Cell-major particle-snapshot pass: the hand-written Hopper kernels.

For one bucket of halos, every padded particle slot of the bucket's
cell-list cells (slot p of cell c at c P + p of three position planes)
sums, over its cell's first ``counts_h[c]`` candidate halos, the halo's
radial displacement read at ln r (ln r / R_com under Rdelta sampling) and
pushed along the slot's minimum-image offset from the halo.
:func:`snap_pass` writes three new offset planes; :func:`snap_vjp` is the
pass's VJP with respect to the rows for three cotangent planes. Both are
kernels of ``csrc/snap_pass.cu`` and replace the candidate loop of the JAX
package's ``snapshot_offsets_pass``
(``baryonification_tpu/runners/snapshot_cellmajor.py:89``; XLA there) and
the first order of its autodiff.

The inputs are a ``runners.snapshot_cellmajor._SnapBucket``'s (its
``kernel_args``): the padded particle planes and ``counts_p`` (ncell,)
int32 of the real slots a cell, the candidates ``dense`` (ncell, K) and
``counts_h`` (ncell,), both int32 as the registration stores them,
``hrec`` (H, 4 | 5) per-halo columns (the wrapped position, the reach
eps_max R_com, ln R_com under Rdelta), ``rows`` (H, n_hi) on the uniform
log grid from ``g0`` in steps ``dg`` up to node ``rad_hi``; ``a_scale``
scales the table's displacement to the snapshot's and ``L`` is the box.
The plain version of both entries is the step loop of
``runners.grid_cellmajor`` (``_bucket_pass``, ``_bucket_vjp``) on that
bucket, which the runners take for CPU tensors. These entries take CUDA
tensors only: any other device raises, and nothing runs in their place.
A build or launch error raises.

A warp owns one cell and its lanes the cell's slots, 32 at a time, so the
lanes read one halo at a time; each slot sums its pairs in registers and
is written once (no atomics: a launch is deterministic). The adjoint
merges the shares that a warp's lanes add to the same nodes before its
atomic adds. Slot and row indices are 32-bit: ``ncell * P`` and
``H * n_hi`` past 2^31 - 1 raise.

``LAUNCHES`` counts kernel launches by entry. A ``tally`` (a (3,) int64
CUDA tensor, for a runner's census, the tests and ``chip_smoke.py``)
gets the launch's counts of :data:`TALLY` added to it: (particle, halo)
pairs listed (real slots times listed candidates), pairs inside (those
that pass every test of the geometry), and the adjoint's global atomic
adds issued.
"""

import ctypes

import torch

from .._cuda_build import load_library

__all__ = ["snap_pass", "snap_vjp", "LAUNCHES", "TALLY"]

#: kernel launches by entry name (read and reset by callers)
LAUNCHES = {"snap_pass": 0, "snap_vjp": 0}

#: the counts of a ``tally``
TALLY = ("pairs", "inside", "atomics")

_FUNCS = {}
_I32_MAX = 2 ** 31 - 1


def _kernel(dtype, entry="snap_pass"):
    """The ctypes function of ``entry`` (snap_pass or snap_vjp) for
    ``dtype``, building the library at first use."""
    key = (entry, dtype)
    if key not in _FUNCS:
        lib = load_library("snap_pass")
        sfx = {torch.float32: "_f32", torch.float64: "_f64"}[dtype]
        fn = getattr(lib, entry + sfx)
        P, I, L, D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_double)
        fn.argtypes = [I] + [P] * 14 + [L] * 4 + [I] * 2 + [D] * 5 + [P, P]
        fn.restype = I
        _FUNCS[key] = fn
    return _FUNCS[key]


def _check(entry, rdelta, P, planes, counts_p, dense, counts_h, hrec, rows,
           tally):
    """Argument checks of both entries; returns ncell."""
    dt, dev = rows.dtype, rows.device
    if dev.type != "cuda":
        raise ValueError(f"{entry} runs on CUDA tensors only, not on {dev} "
                         f"(the plain version is runners.grid_cellmajor."
                         f"_bucket_pass / _bucket_vjp on a _SnapBucket)")
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"rows must be float32 or float64, got {dt}")
    if rows.dim() != 2 or rows.shape[1] < 2:
        raise ValueError("rows must be (H, n_hi >= 2)")
    H, n_hi = rows.shape
    hcols = 4 + bool(rdelta)
    if hrec.dtype != dt or hrec.shape != (H, hcols):
        raise ValueError(f"hrec must be {dt} of shape ({H}, {hcols})"
                         f"{' under rdelta' if rdelta else ''}")
    ncell = counts_p.shape[0] if counts_p.dim() == 1 else -1
    if any(t.dtype != torch.int32 for t in (counts_p, dense, counts_h)) \
            or counts_p.dim() != 1 or counts_h.shape != (ncell,) \
            or dense.dim() != 2 or dense.shape[0] != ncell:
        raise ValueError("counts_p and counts_h must be (ncell,) and dense "
                         "(ncell, K), all int32")
    planes = tuple(planes)
    if len(planes) != 3 or any(p.dtype != dt or p.shape != (ncell * P,)
                               for p in planes):
        raise ValueError(f"planes must be three {dt} of shape "
                         f"({ncell * P},)")
    if P < 1 or ncell * P > _I32_MAX or H * n_hi > _I32_MAX:
        raise ValueError(f"P = {P}, ncell * P = {ncell * P} and H * n_hi = "
                         f"{H * n_hi} must lie in [1, 2^31): the kernels' "
                         f"slot and row indices are 32-bit")
    if tally is not None and (tally.dtype != torch.int64
                              or tally.shape != (len(TALLY),)):
        raise ValueError(f"tally must be {len(TALLY)} int64")
    for t in planes + (counts_p, dense, counts_h, hrec, rows) + (
            () if tally is None else (tally,)):
        if t.device != dev:
            raise ValueError(f"all tensors must be on {dev}, found one on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{entry} takes contiguous tensors")
    return ncell


def _launch(entry, rdelta, P, planes, counts_p, dense, counts_h, hrec, rows,
            cts, outs, g0, dg, rad_hi, a_scale, L, tally):
    ptr = lambda ts: [t.data_ptr() for t in ts] + [None] * (3 - len(ts))
    err = _kernel(rows.dtype, entry)(
        int(bool(rdelta)), *ptr(planes), counts_p.data_ptr(),
        dense.data_ptr(), counts_h.data_ptr(), hrec.data_ptr(),
        rows.data_ptr(), *ptr(cts), *ptr(outs), counts_p.shape[0],
        dense.shape[1], P, rows.shape[0], rows.shape[1], hrec.shape[1],
        float(g0), float(dg), float(rad_hi), float(a_scale), float(L),
        None if tally is None else tally.data_ptr(),
        torch.cuda.current_stream(rows.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    LAUNCHES[entry] += 1


def snap_pass(rdelta, P, planes, counts_p, dense, counts_h, hrec, rows, g0,
              dg, rad_hi, a_scale, L, tally=None):
    """One bucket's pass in one launch: returns three new padded offset
    planes (ncell P elements each), each element written once (pad slots
    and cells without candidates 0). See the module docstring."""
    ncell = _check("snap_pass", rdelta, P, planes, counts_p, dense, counts_h,
                   hrec, rows, tally)
    outs = tuple(torch.empty(ncell * P, dtype=rows.dtype, device=rows.device)
                 for _ in range(3))
    if ncell:
        _launch("snap_pass", rdelta, P, planes, counts_p, dense, counts_h,
                hrec, rows, (), outs, g0, dg, rad_hi, a_scale, L, tally)
    return outs


def snap_vjp(rdelta, P, planes, counts_p, dense, counts_h, hrec, rows, cts,
             g0, dg, rad_hi, a_scale, L, tally=None):
    """The VJP of :func:`snap_pass` with respect to ``rows`` for the three
    cotangent planes ``cts``, in one launch: returns the (H, n_hi) d_rows,
    summed with atomic adds (in no fixed order) of the shares merged over
    each warp."""
    ncell = _check("snap_vjp", rdelta, P, planes, counts_p, dense, counts_h,
                   hrec, rows, tally)
    cts = tuple(cts)
    if len(cts) != 3 or any(
            c.dtype != rows.dtype or c.device != rows.device
            or c.shape != (ncell * P,) for c in cts):
        raise ValueError(f"snap_vjp takes 3 cotangent planes of "
                         f"{rows.dtype}, shape ({ncell * P},), on "
                         f"{rows.device}")
    cts = tuple(c.contiguous() for c in cts)
    d_rows = torch.zeros_like(rows)
    if ncell:
        _launch("snap_vjp", rdelta, P, planes, counts_p, dense, counts_h,
                hrec, rows, cts, (d_rows,), g0, dg, rad_hi, a_scale, L,
                tally)
    return d_rows
