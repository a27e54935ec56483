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

Gradients: :func:`cellmajor_pass_diff` is the pass as a
``torch.autograd.Function`` of the rows and the incoming planes (it
returns new planes; the planes' cotangent passes through unchanged). Its
backward is the adjoint entry :func:`cellmajor_vjp` (the VJP with
respect to the rows, itself an ``autograd.Function``), whose backward is
the second-order entry :func:`cellmajor_vjp2`, so reverse-over-reverse
autograd gives exact Hessians through the pass. On the card both are
kernels of ``csrc/cellmajor_pass.cu``; their plain versions
(``cellmajor_vjp_reference``, ``cellmajor_vjp2_reference``) are the
autograd of ``cellmajor_pass_reference`` and its double backward. In the
JAX package the gradient of the pass is XLA autodiff of the same loop.
``_launch_adjoint`` takes a measurement argument, ``tally``, that counts
the slot-pixels that add to the rows and the global atomics made.
"""

import ctypes

import torch

from .._cuda_build import load_library

__all__ = ["cellmajor_pass", "cellmajor_pass_reference", "cellmajor_pass_diff",
           "cellmajor_vjp", "cellmajor_vjp_reference", "cellmajor_vjp2",
           "cellmajor_vjp2_reference", "LAUNCHES", "MODES", "REC_COLS"]

#: kernel launches by kernel name (read and reset by callers)
LAUNCHES = {"cellmajor_pass": 0, "cellmajor_vjp": 0, "cellmajor_vjp2": 0}

#: mode name -> the kernel's mode number
MODES = {"offsets": 0, "offsets_rdelta": 1, "paint": 2}

#: values in a slot record (``runners.shell_cellmajor.slot_records``)
REC_COLS = 8

_FUNCS = {}

# pixels a chunk of the plain version (whole cells): bounds its temporaries
_CHUNK_PIXELS = 1 << 20
# pixels a range of the plain adjoint versions (whole cells): bounds the
# graph they hold at once
_GRAD_CHUNK_PIXELS = 1 << 18
#: the counts of the adjoint kernels' ``tally`` (``_launch_adjoint``)
TALLY = ("adds", "atomics")


def _kernel(dtype, entry="cellmajor_pass"):
    """The ctypes function of ``entry`` (cellmajor_pass, cellmajor_vjp or
    cellmajor_vjp2) for ``dtype``, building the library at first use."""
    key = (entry, dtype)
    if key not in _FUNCS:
        lib = load_library("cellmajor_pass")
        sfx = {torch.float32: "_f32", torch.float64: "_f64"}[dtype]
        fn = getattr(lib, entry + sfx)
        P, I, L, D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_double)
        # mode, pixel planes, dense, counts, recs, rows, then per entry
        head = [I, P, P, P, P, P, P, P]
        tail = [L, L, I, I, D, D, D]
        fn.argtypes = {
            "cellmajor_pass": head + [P, P, P] + tail + [I, P, P],
            "cellmajor_vjp": head + [P, P, P, P] + tail + [P, P],
            "cellmajor_vjp2": head + [P] * 8 + tail + [P, P],
        }[entry]
        fn.restype = I
        _FUNCS[key] = fn
    return _FUNCS[key]


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
                # the slot's test reads exp(v); the value goes through a
                # second where, so that the backward of a skipped slot is
                # an exact 0 and not 0 * exp(NaN)
                ok = inside & torch.isfinite(torch.exp(v.detach()))
                acc[0] += torch.where(ok, torch.exp(torch.where(ok, v, 0.0)),
                                      0.0)
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


# ----- gradients -----

def _zero_planes(mode, like):
    return tuple(torch.zeros_like(like) for _ in
                 range(1 if mode == "paint" else 3))


def _cell_chunks(dense, counts, F, pix):
    """Contiguous ranges of whole cells, about 2^18 pixels each: (the
    range's pixel slice, its pixel planes, dense and counts). The pass
    is a sum over cells, so its derivatives add over these ranges; the
    plain versions below take one graph a range, which bounds their
    memory at any bucket size."""
    ncell = counts.shape[0]
    if ncell == 0:
        return
    K_pad = dense.shape[0] // ncell
    C = max(1, _GRAD_CHUNK_PIXELS // F)
    for c0 in range(0, ncell, C):
        c1 = min(c0 + C, ncell)
        if int(counts[c0:c1].max()) == 0:
            continue
        sl = slice(c0 * F, c1 * F)
        yield (sl, tuple(v[sl] for v in pix), dense[c0 * K_pad:c1 * K_pad],
               counts[c0:c1])


def cellmajor_vjp_reference(mode, grads, pix, dense, counts, F, recs, rows,
                            g0, dg, rad_hi):
    """Plain version of the adjoint: the autograd of
    :func:`cellmajor_pass_reference` with respect to ``rows`` for the
    cotangent planes ``grads``, a range of cells at a time. Returns the
    (H, n_hi) d_rows."""
    d_rows = torch.zeros_like(rows)
    for sl, px, dn, cn in _cell_chunks(dense, counts, F, pix):
        with torch.enable_grad():
            r = rows.detach().requires_grad_(True)
            out = cellmajor_pass_reference(mode, _zero_planes(mode, px[0]),
                                           px, dn, cn, F, recs, r, g0, dg,
                                           rad_hi)
            live = [(o, g[sl]) for o, g in zip(out, grads)
                    if o.requires_grad]
            if live:
                (d,) = torch.autograd.grad([o for o, _ in live], r,
                                           [g for _, g in live])
                d_rows += d
    return d_rows


def cellmajor_vjp2_reference(mode, grads, u, pix, dense, counts, F, recs,
                             rows, g0, dg, rad_hi):
    """Plain version of the second-order entry: the double backward of
    :func:`cellmajor_pass_reference`, i.e. the derivative of
    <u, VJP(grads, rows)> with respect to the cotangent planes (the JVP
    planes) and to the rows, a range of cells at a time. Returns (JVP
    planes, (H, n_hi) d2_rows)."""
    jvp = _zero_planes(mode, pix[0])
    d2 = torch.zeros_like(rows)
    for sl, px, dn, cn in _cell_chunks(dense, counts, F, pix):
        with torch.enable_grad():
            r = rows.detach().requires_grad_(True)
            g = tuple(x[sl].detach().requires_grad_(True) for x in grads)
            out = cellmajor_pass_reference(mode, _zero_planes(mode, px[0]),
                                           px, dn, cn, F, recs, r, g0, dg,
                                           rad_hi)
            live = [(o, gi) for o, gi in zip(out, g) if o.requires_grad]
            if not live:
                continue
            (d,) = torch.autograd.grad([o for o, _ in live], r,
                                       [gi for _, gi in live],
                                       create_graph=True)
            res = torch.autograd.grad(d, g + (r,), u, allow_unused=True)
        for j, x in zip(jvp, res[:-1]):
            if x is not None:
                j[sl] += x
        if res[-1] is not None:
            d2 += res[-1]
    return jvp, d2


def _launch_adjoint(entry, mode, grads, u, pix, dense, counts, F, recs, rows,
                    g0, dg, rad_hi, tally=None):
    """One launch of the adjoint (``u`` None) or second-order entry on
    CUDA tensors; returns d_rows, or (JVP planes, d2_rows). ``tally`` (a
    (2,) int64 CUDA tensor, for the tests and ``chip_smoke.py``) gets the
    launch's counts of :data:`TALLY` added to it: the slot-pixels that add
    to the rows and the global atomics made."""
    npix, ncell = pix[0].shape[0], counts.shape[0]
    d_rows = torch.zeros_like(rows)
    jvp = _zero_planes(mode, pix[0]) if u is not None else ()
    if npix == 0:
        return d_rows if u is None else (jvp, d_rows)
    if recs.shape[0] >= 2**31:
        raise ValueError(f"{entry} takes fewer than 2^31 halos")
    pix = tuple(v.contiguous() for v in pix)
    grads = tuple(v.contiguous() for v in grads)
    dense, counts = dense.contiguous(), counts.contiguous()
    recs, rows = recs.contiguous(), rows.contiguous()
    if recs.data_ptr() % 16:           # the kernel reads 16-byte records
        recs = recs.clone()
    if tally is not None and (tally.dtype != torch.int64
                              or tally.device != rows.device
                              or tally.shape != (len(TALLY),)):
        raise ValueError(f"tally must be {len(TALLY)} int64 on "
                         f"{rows.device}")
    gp = [g.data_ptr() for g in grads] + [None] * (3 - len(grads))
    extra = ([] if u is None else
             [u.contiguous().data_ptr(), d_rows.data_ptr()]
             + [j.data_ptr() for j in jvp] + [None] * (3 - len(jvp)))
    err = _kernel(rows.dtype, entry)(
        MODES[mode], *(v.data_ptr() for v in pix), dense.data_ptr(),
        counts.data_ptr(), recs.data_ptr(), rows.data_ptr(), *gp,
        *([d_rows.data_ptr()] if u is None else extra), npix, F,
        dense.shape[0] // ncell, rows.shape[1], float(g0), float(dg),
        float(rad_hi), None if tally is None else tally.data_ptr(),
        torch.cuda.current_stream(rows.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    LAUNCHES[entry] += 1
    return d_rows if u is None else (jvp, d_rows)


def _dispatch(entry, mode, grads, u, pix, dense, counts, F, recs, rows, g0,
              dg, rad_hi):
    grads = tuple(grads)
    _, pix = _check(mode, grads, pix, dense, counts, F, recs, rows)
    if u is not None and (u.dtype != rows.dtype or u.shape != rows.shape
                          or u.device != rows.device):
        raise ValueError(f"u must be {rows.dtype} of shape "
                         f"{tuple(rows.shape)} on {rows.device}")
    dev = rows.device
    if dev.type == "cpu":
        if u is None:
            return cellmajor_vjp_reference(mode, grads, pix, dense, counts,
                                           F, recs, rows, g0, dg, rad_hi)
        return cellmajor_vjp2_reference(mode, grads, u, pix, dense, counts,
                                        F, recs, rows, g0, dg, rad_hi)
    if dev.type != "cuda":
        raise ValueError(f"{entry} runs on cpu or cuda, not {dev}")
    return _launch_adjoint(entry, mode, grads, u, pix, dense, counts, F,
                           recs, rows, g0, dg, rad_hi)


def cellmajor_vjp(mode, grads, pix, dense, counts, F, recs, rows, g0, dg,
                  rad_hi):
    """The adjoint of one bucket's pass with respect to its rows: the
    (H, n_hi) VJP for the cotangent planes ``grads`` (one in paint mode,
    three in the offsets modes). CUDA tensors go through the kernel in
    one launch (the rows are summed with atomics, in no fixed order); CPU
    tensors take the plain version."""
    return _dispatch("cellmajor_vjp", mode, grads, None, pix, dense, counts,
                     F, recs, rows, g0, dg, rad_hi)


def cellmajor_vjp2(mode, grads, u, pix, dense, counts, F, recs, rows, g0,
                   dg, rad_hi):
    """The second-order entry: the derivative of <u, cellmajor_vjp(grads,
    rows)> with respect to ``grads`` (the JVP planes, sum over slots of
    f'(v) lerp(u)) and to ``rows`` (the lerp weights times sum_c g_c
    f_c''(v) lerp(u)). Returns (JVP planes, d2_rows). CUDA tensors go
    through the kernel in one launch; CPU tensors take the plain
    version."""
    return _dispatch("cellmajor_vjp2", mode, grads, u, pix, dense, counts,
                     F, recs, rows, g0, dg, rad_hi)


class _PassFn(torch.autograd.Function):
    """planes_out = planes_in + pass(rows); differentiable in ``rows``
    and the incoming planes. ``geom`` holds the constant inputs."""

    @staticmethod
    def forward(ctx, mode, geom, rows, *planes):
        outs = tuple(p.clone(memory_format=torch.contiguous_format)
                     for p in planes)
        pix, dense, counts, F, recs, g0, dg, rad_hi = geom
        _cellmajor_pass_raw(mode, outs, pix, dense, counts, F, recs, rows,
                            g0, dg, rad_hi)
        ctx.mode, ctx.geom = mode, geom
        ctx.save_for_backward(rows)
        return outs

    @staticmethod
    def backward(ctx, *g):
        (rows,) = ctx.saved_tensors
        d_rows = (_VjpFn.apply(ctx.mode, ctx.geom, rows, *g)
                  if ctx.needs_input_grad[2] else None)
        return (None, None, d_rows) + tuple(
            gi if ctx.needs_input_grad[3 + j] else None
            for j, gi in enumerate(g))


class _VjpFn(torch.autograd.Function):
    """d_rows = VJP(grads, rows), differentiable once more (the
    second-order entry) for reverse-over-reverse Hessians."""

    @staticmethod
    def forward(ctx, mode, geom, rows, *grads):
        ctx.mode, ctx.geom = mode, geom
        ctx.save_for_backward(rows, *grads)
        pix, dense, counts, F, recs, g0, dg, rad_hi = geom
        return cellmajor_vjp(mode, grads, pix, dense, counts, F, recs, rows,
                             g0, dg, rad_hi)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, u):
        rows, *grads = ctx.saved_tensors
        pix, dense, counts, F, recs, g0, dg, rad_hi = ctx.geom
        jvp, d2 = cellmajor_vjp2(ctx.mode, grads, u, pix, dense, counts, F,
                                 recs, rows, g0, dg, rad_hi)
        return (None, None, d2 if ctx.needs_input_grad[2] else None) + tuple(
            j if ctx.needs_input_grad[3 + k] else None
            for k, j in enumerate(jvp))


def cellmajor_pass_diff(mode, planes, pix, dense, counts, F, recs, rows, g0,
                        dg, rad_hi):
    """One bucket's pass as a differentiable function: returns new planes
    ``planes + pass(rows)`` (the inputs are not modified), with gradients
    to ``rows`` and ``planes`` (see the module docstring). The values are
    those of :func:`cellmajor_pass`, bit for bit; on the card the forward,
    the adjoint and the second-order entry are kernels, on the CPU their
    plain versions."""
    planes, pix = _check(mode, planes, pix, dense, counts, F, recs, rows)
    geom = (pix, dense, counts, F, recs, g0, dg, rad_hi)
    return _PassFn.apply(mode, geom, rows, *planes)
