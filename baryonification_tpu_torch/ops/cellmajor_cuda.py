"""Cell-major shell pass: the hand-written Hopper kernel and its plain
version.

For one bucket of halos, every pixel p of the sky (NESTED order, cell
c = p // F) adds the contributions of the first ``counts[c]`` candidate
halos of its cell to its output plane(s), in place:

- ``offsets`` mode (3 planes): the cancellation-stable unit-vector delta
  of the pixel moved by the halo's displacement, read from the halo's
  radial row at ln r (ln r - ln R_com with ``use_rdelta``);
- ``paint`` mode (1 plane): exp of the log profile read at ln r.

This replaces the per-cell candidate loop of the JAX package's
``cellmajor_offsets_pass`` and ``cellmajor_paint_pass``
(``baryonification_tpu/runners/shell_cellmajor.py:255``, ``:372``; XLA
there). The kernel is ``csrc/cellmajor_pass.cu``.

Inputs (see ``runners/shell_cellmajor.py``): ``pix`` the three NESTED
pixel planes; ``dense`` (ncell * K_pad,) int32 candidate ids and
``counts`` (ncell,) int32; ``recs`` (H, 8) per-halo slot records
(``slot_records``); ``rows`` (H, n_hi) radial rows (``halo_rows``), on
the uniform log grid starting at ``g0`` with step ``dg``; ``rad_hi`` the
grid's node n_hi - 1.

Dispatch is by the device of the tensors: CPU tensors take the plain
PyTorch version (``cellmajor_pass_reference``); CUDA tensors take the
kernel, built at first use, or the call raises. There is no fallback from
one to the other. ``LAUNCHES`` counts kernel launches; only a launch of
the CUDA kernel adds to it.

Where F is a multiple of 32 the kernel skips, for a patch of 32
neighbouring pixels at once, the slots whose disc cannot reach any of
them; what it skips adds nothing in the plain version either.
``_cellmajor_pass_raw`` is the wrapper with two more arguments, for the
tests and ``chip_smoke.py``: ``cull=False`` runs the kernel without that
test (bit for bit the same result), and ``kept`` counts the (patch, slot)
pairs that the patches walk.
"""

import ctypes

import torch

from .._cuda_build import load_library

__all__ = ["cellmajor_pass", "cellmajor_pass_reference", "LAUNCHES",
           "MODES", "REC_COLS"]

#: kernel launches by kernel name (read and reset by callers)
LAUNCHES = {"cellmajor_pass": 0}

#: mode name -> the kernel's mode number
MODES = {"offsets": 0, "offsets_rdelta": 1, "paint": 2}

#: values in a slot record (``runners.shell_cellmajor.slot_records``)
REC_COLS = 8

_FUNCS = {}

# pixels a chunk of the plain version (whole cells): bounds its temporaries
_CHUNK_PIXELS = 1 << 20


def _kernel(dtype):
    if dtype not in _FUNCS:
        lib = load_library("cellmajor_pass")
        name = {torch.float32: "cellmajor_pass_f32",
                torch.float64: "cellmajor_pass_f64"}[dtype]
        fn = getattr(lib, name)
        P, I, L, D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_double)
        fn.argtypes = [I, P, P, P, P, P, P, P, P, P, P, L, L, I, I, D, D, D,
                       I, P, P]
        fn.restype = I
        _FUNCS[dtype] = fn
    return _FUNCS[dtype]


def _check(mode, planes, pix, dense, counts, F, recs, rows):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    planes, pix = tuple(planes), tuple(pix)
    n_out = 1 if mode == "paint" else 3
    if len(planes) != n_out or len(pix) != 3:
        raise ValueError(f"mode {mode!r} takes {n_out} output planes and 3 "
                         f"pixel planes, got {len(planes)} and {len(pix)}")
    dt, dev = planes[0].dtype, planes[0].device
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"planes must be float32 or float64, got {dt}")
    npix = planes[0].shape[0]
    for t in planes + pix:
        if t.dtype != dt or t.shape != (npix,):
            raise ValueError(f"output and pixel planes must be {dt} of "
                             f"shape ({npix},)")
    if dense.dtype != torch.int32 or counts.dtype != torch.int32 \
            or dense.dim() != 1 or counts.dim() != 1:
        raise TypeError("dense and counts must be 1-D int32 tensors")
    ncell = counts.shape[0]
    if F < 1 or ncell * F != npix or dense.shape[0] % max(ncell, 1):
        raise ValueError(f"{ncell} cells of F={F} pixels do not make "
                         f"{npix} pixels, or dense ({dense.shape[0]}) is "
                         f"not ncell * K_pad")
    if recs.dtype != dt or recs.dim() != 2 or recs.shape[1] != REC_COLS:
        raise ValueError(f"recs must be {dt} of shape (H, {REC_COLS})")
    if rows.dtype != dt or rows.dim() != 2 or rows.shape[0] != recs.shape[0] \
            or rows.shape[1] < 2:
        raise ValueError(f"rows must be {dt} of shape (H, n_hi >= 2)")
    for t in planes + pix + (dense, counts, recs, rows):
        if t.device != dev:
            raise ValueError(f"all tensors must be on {dev}, found one on "
                             f"{t.device}")
    return planes, pix


def cellmajor_pass_reference(mode, planes, pix, dense, counts, F, recs, rows,
                             g0, dg, rad_hi):
    """Plain PyTorch version: chunks of whole cells (about 2^20 pixels),
    and in each a loop over the slots up to the chunk's largest
    count, reading the rows by a gather-based lerp. The same operations in
    the same order as the kernel. Returns ``planes``."""
    planes, pix = _check(mode, planes, pix, dense, counts, F, recs, rows)
    paint = mode == "paint"
    rdelta = mode == "offsets_rdelta"
    ncell = counts.shape[0]
    if ncell == 0:
        return planes
    K_pad = dense.shape[0] // ncell
    n_hi = rows.shape[1]
    inv_dg = 1.0 / dg
    dense2d = dense.reshape(ncell, K_pad)
    C = max(1, _CHUNK_PIXELS // F)
    for c0 in range(0, ncell, C):
        c1 = min(c0 + C, ncell)
        cnt = counts[c0:c1]
        k_max = int(cnt.max())
        if k_max == 0:
            continue
        sl = slice(c0 * F, c1 * F)
        px, py, pz = (v[sl].reshape(c1 - c0, F) for v in pix)
        acc = [torch.zeros_like(px) for _ in planes]
        for k in range(k_max):
            hid = dense2d[c0:c1, k].to(torch.int64)
            rec = recs[hid]
            hvx, hvy, hvz, cosr, hD, ha, hReps, hlnR = (
                rec[:, j, None] for j in range(8))
            dx = (px - hvx) * hD
            dy = (py - hvy) * hD
            dz = (pz - hvz) * hD
            r_sep = torch.sqrt(dx * dx + dy * dy + dz * dz)
            if paint:
                r_com = torch.clamp(r_sep / ha, min=1e-30)
                rad = torch.log(r_com)
            else:
                r_com = r_sep / ha
                rad = torch.log(torch.clamp(r_com, min=1e-30))
                if rdelta:
                    rad = rad - hlnR
            cosang = px * hvx + py * hvy + pz * hvz
            inside = ((rad >= g0) & (rad <= rad_hi) & (r_com < hReps)
                      & (cosang >= cosr) & (k < cnt)[:, None])
            t = (rad - g0) * inv_dg
            tc = torch.clamp(t, 0.0, float(n_hi - 1))
            i = torch.clamp(torch.floor(tc).to(torch.int64), 0, n_hi - 2)
            w = tc - i.to(tc.dtype)
            row = rows[hid]
            v = (1.0 - w) * torch.gather(row, 1, i) \
                + w * torch.gather(row, 1, i + 1)
            if paint:
                p = torch.exp(v)
                acc[0] += torch.where(inside & torch.isfinite(p), p, 0.0)
                continue
            d = torch.where(inside & torch.isfinite(v), v, 0.0) * ha
            scale = d / torch.clamp(r_sep, min=1e-30)
            ofx = scale * dx
            ofy = scale * dy
            ofz = scale * dz
            nwx = px * hD + ofx
            nwy = py * hD + ofy
            nwz = pz * hD + ofz
            nw_norm = torch.sqrt(nwx * nwx + nwy * nwy + nwz * nwz)
            pdo = hD * (px * ofx + py * ofy + pz * ofz)
            osq = ofx * ofx + ofy * ofy + ofz * ofz
            sft = (2.0 * pdo + osq) / (nw_norm + hD)
            inv_nw = 1.0 / nw_norm
            dxn = (ofx - px * sft) * inv_nw
            dyn = (ofy - py * sft) * inv_nw
            dzn = (ofz - pz * sft) * inv_nw
            good = (torch.isfinite(dxn) & torch.isfinite(dyn)
                    & torch.isfinite(dzn))
            for a, dn in zip(acc, (dxn, dyn, dzn)):
                a += torch.where(good, dn, 0.0)
        for o, a in zip(planes, acc):
            o[sl] += a.reshape(-1)
    return planes


def cellmajor_pass(mode, planes, pix, dense, counts, F, recs, rows, g0, dg,
                   rad_hi):
    """Add one bucket's contributions to ``planes`` in place (see the
    module docstring). CUDA tensors go through the kernel in one launch;
    CPU tensors take the plain version. Returns ``planes``."""
    return _cellmajor_pass_raw(mode, planes, pix, dense, counts, F, recs,
                               rows, g0, dg, rad_hi)


def _cellmajor_pass_raw(mode, planes, pix, dense, counts, F, recs, rows, g0,
                        dg, rad_hi, cull=True, kept=None):
    """``cellmajor_pass`` with the kernel's two measurement arguments (the
    CPU's plain version ignores them): ``cull=False`` runs the kernel
    without its patch cull, and ``kept`` (a (1,) int64 CUDA tensor) gets
    the number of (patch, slot) pairs that the patches walk added to it
    (F a multiple of 32). Returns ``planes``."""
    planes, pix = _check(mode, planes, pix, dense, counts, F, recs, rows)
    dev = planes[0].device
    if dev.type == "cpu":
        return cellmajor_pass_reference(mode, planes, pix, dense, counts, F,
                                        recs, rows, g0, dg, rad_hi)
    if dev.type != "cuda":
        raise ValueError(f"cellmajor_pass runs on cpu or cuda, not {dev}")
    npix = planes[0].shape[0]
    ncell = counts.shape[0]
    if npix == 0:
        return planes
    if recs.shape[0] >= 2**31:
        raise ValueError("cellmajor_pass takes fewer than 2^31 halos")
    for t in planes:
        if not t.is_contiguous():
            raise ValueError("output planes must be contiguous")
    # the launch is asynchronous; copies made here may be freed on return,
    # as the caching allocator hands their memory only to later work on
    # this same stream
    pix = tuple(v.contiguous() for v in pix)
    dense, counts = dense.contiguous(), counts.contiguous()
    recs, rows = recs.contiguous(), rows.contiguous()
    if recs.data_ptr() % 16:           # the kernel reads 16-byte records
        recs = recs.clone()
    if kept is not None and (kept.dtype != torch.int64 or kept.device != dev
                             or kept.numel() != 1):
        raise ValueError(f"kept must be one int64 on {dev}")
    outs = [o.data_ptr() for o in planes] + [None] * (3 - len(planes))
    err = _kernel(planes[0].dtype)(
        MODES[mode], *(v.data_ptr() for v in pix), dense.data_ptr(),
        counts.data_ptr(), recs.data_ptr(), rows.data_ptr(), *outs, npix, F,
        dense.shape[0] // ncell, rows.shape[1], float(g0), float(dg),
        float(rad_hi), int(bool(cull)),
        None if kept is None else kept.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cellmajor_pass launch failed: CUDA error {err}")
    LAUNCHES["cellmajor_pass"] += 1
    return planes
