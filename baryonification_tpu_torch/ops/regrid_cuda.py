"""The shell regrid: the hand-written Hopper kernels and their plain
versions.

Stage C of shell baryonify: every input pixel's unit vector (vx, vy, vz)
moved by its offset (ox, oy, oz) redeposits the pixel's mass m into the
four RING pixels around the moved direction, with the bilinear weights of
``ops.healpix.get_interp_weights_parts``, into a new full-sky RING map.
Inputs come in any order of pixels: NESTED on the cell-major path, RING
on the scatter path, one rank's slice on the mesh path. This is the port
of the JAX package's ``_regrid_shell``
(``baryonification_tpu/runners/shell.py:756``; XLA there, no TPU kernel).
The kernels are ``csrc/regrid.cu``:

- ``regrid_rings``: fills the ring table that the others read, a row a
  ring (its first pixel, length, theta, phi step and shift, the step's
  reciprocal), once per (NSIDE, dtype, device): :func:`_ring_table`
  caches it in ``_RING_TABLES``;
- ``regrid``: one thread a pixel computes its four ids and weights in
  registers (the ring terms from the table, 32-bit integers); a warp
  merges its 128 rows by destination (four rounds of
  ``__match_any_sync``) and adds each sum to the zeroed map with one
  global add (no 4 x npix temporaries); the sums arrive in no fixed
  order. Its ``tally`` counts the global adds issued (for the tests and
  ``chip_smoke.py``);
- the deterministic route, taken where
  ``torch.are_deterministic_algorithms_enabled()``: a count kernel, a
  scan of the counts (``torch.cumsum``), a fill kernel and a segment
  kernel that sums each destination's rows in the order of their keys
  (4 i + k), so the map is the same bit for bit from run to run;
- ``regrid_vjp``: the adjoint, one thread a pixel gathering the map's
  cotangent at its four ids and writing its gradients once.

Every operation of the kernels that gives an id or a weight rounds as the
plain version's PyTorch op does on the card (``_cuda_build`` builds the
source with ``--fmad=false``); :func:`_regrid_parts` launches the check
entry, which writes each pixel's four ids and four weights instead of
adding them, and :func:`_ring_fields` reads the ring table (for the tests
and ``chip_smoke.py`` only).

Dispatch is by the device of the tensors: CPU tensors take the plain
versions (:func:`regrid_shell_reference`, :func:`regrid_vjp_reference`);
CUDA tensors take the kernels, built at first use, or the call raises.
There is no fallback from one to the other.

Gradients: :func:`regrid_shell` goes through a
``torch.autograd.Function`` where an input requires grad. Its backward is
:func:`regrid_vjp` (the kernel on the card), except under
``create_graph`` (reverse over reverse, e.g. ``inference.
laplace_covariance``): there the backward is
:func:`regrid_vjp_reference` as differentiable torch ops, on the card too
(no second-order regrid kernel yet). That is the one route on which a
plain version runs on the card.

``LAUNCHES`` counts launches: ``regrid`` and ``regrid_vjp`` a kernel
launch each, ``regrid_det`` a call of the deterministic route (its count,
fill and segment kernels), ``regrid_rings`` a fill of a ring table.
"""

import ctypes

import numpy as np
import torch

from .._cuda_build import load_library
from . import healpix as hpx

__all__ = ["regrid_shell", "regrid_shell_reference", "regrid_vjp",
           "regrid_vjp_reference", "LAUNCHES", "MAX_NSIDE"]

#: launches by name (read and reset by callers)
LAUNCHES = {"regrid": 0, "regrid_det": 0, "regrid_vjp": 0, "regrid_rings": 0}

#: the largest NSIDE the kernels take (ids and keys in 32 bits)
MAX_NSIDE = 8192

_FUNCS = {}
# (nside, dtype, device) -> the ring table the kernels read
_RING_TABLES = {}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {"regrid_ring_bytes": [],
             "regrid_rings": [_I, _P, _P],
             "regrid": [_I, _L, _P, _P, _P, _P, _P],
             "regrid_parts": [_I, _L, _P, _P, _P, _P, _P],
             "regrid_vjp": [_I, _L, _P, _P, _P, _P, _P, _P, _P, _P],
             "regrid_count": [_I, _L, _P, _P, _P, _P],
             "regrid_fill": [_I, _L, _P, _P, _P, _P, _P, _P],
             "regrid_sum": [_L, _P, _P, _P, _P, _P, _P, _P, _P]}


def _kernel(dtype, entry="regrid"):
    """The ctypes function of ``entry`` for ``dtype``, building the
    library at first use."""
    key = (entry, dtype)
    if key not in _FUNCS:
        lib = load_library("regrid")
        sfx = {torch.float32: "_f32", torch.float64: "_f64"}[dtype]
        fn = getattr(lib, entry + sfx)
        fn.argtypes = _ARGTYPES[entry]
        fn.restype = _I
        _FUNCS[key] = fn
    return _FUNCS[key]


def _call(entry, dtype, *args):
    err = _kernel(dtype, entry)(*args)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")


def _ring_table(nside, T, device):
    """The ring table of NSIDE ``nside`` in dtype ``T`` on ``device``: a
    row a ring index (0 .. 4 nside - 1; row 0 is never read) of the ring's
    first pixel and length (int32) and its theta, phi step, phi shift and
    the step's reciprocal (``T``), as bytes. Filled by the kernel
    ``regrid_rings`` at first use (counted in ``LAUNCHES``) and cached."""
    key = (nside, T, device)
    tab = _RING_TABLES.get(key)
    if tab is None:
        row = _kernel(T, "regrid_ring_bytes")()
        tab = torch.empty((4 * nside, row), dtype=torch.uint8, device=device)
        _call("regrid_rings", T, nside, tab.data_ptr(), _stream(tab))
        LAUNCHES["regrid_rings"] += 1
        _RING_TABLES[key] = tab
    return tab


def _ring_fields(nside, T, device):
    """The ring table's columns as tensors (views): ``start``, ``npr``
    (int32) and ``theta``, ``dphi``, ``shift``, ``inv_dphi`` (``T``). For
    the tests and ``chip_smoke.py``."""
    tab = _ring_table(nside, T, device)
    ints, vals = tab.view(torch.int32), tab.view(T)
    t = vals.element_size()
    names = ("theta", "dphi", "shift", "inv_dphi")
    return dict(start=ints[:, 0], npr=ints[:, 1],
                **{k: vals[:, (8 + j * t) // t] for j, k in enumerate(names)})


def regrid_shell_reference(nside, vx, vy, vz, orig_map, offsets):
    """Plain PyTorch version: displace every pixel's unit vector and
    redeposit the original mass with bilinear weights; ``offsets`` is the
    (ox, oy, oz) plane tuple. The deposit is ``index_add_`` (XLA's scatter
    in the JAX package)."""
    ox, oy, oz = offsets
    x = vx.to(ox.dtype) + ox
    y = vy.to(ox.dtype) + oy
    z = vz.to(ox.dtype) + oz
    r = torch.sqrt(x * x + y * y + z * z)
    theta = torch.arccos(torch.clamp(z / r, -1.0, 1.0))
    phi = torch.atan2(y, x)
    phi = torch.where(phi < 0, phi + 2 * np.pi, phi)
    ps, ws = hpx.get_interp_weights_parts(nside, theta, phi)
    idx = torch.cat(ps)
    contrib = torch.cat([w.to(orig_map.dtype) * orig_map for w in ws])
    out = torch.zeros(hpx.npix(nside), dtype=orig_map.dtype,
                      device=orig_map.device)
    return out.index_add_(0, idx, contrib)


def _moved(vx, vy, vz, offsets):
    """The plain version's moved vectors and their angles, in the
    offsets' dtype: (x, y, z, r, z / r, its clamp c, theta, phi)."""
    T = offsets[0].dtype
    x, y, z = (v.to(T) + o for v, o in zip((vx, vy, vz), offsets))
    r = torch.sqrt(x * x + y * y + z * z)
    c0 = z / r
    c = torch.clamp(c0, -1.0, 1.0)
    phi = torch.atan2(y, x)
    phi = torch.where(phi < 0, phi + 2 * np.pi, phi)
    return x, y, z, r, c0, c, torch.arccos(c), phi


def regrid_vjp_reference(nside, vx, vy, vz, orig_map, offsets, ct,
                         need_map=True):
    """Plain PyTorch version of the adjoint, in closed form (not
    autograd), differentiable as torch ops: for the map's cotangent
    ``ct`` (npix,), returns ((d_ox, d_oy, d_oz), d_map), d_map None
    unless ``need_map``. With g_k = ct[p_k]: d_map = sum_k w_k g_k; the
    weights' derivatives in wt, f1, f2 give d_theta (inside wt's clamp,
    inclusive, and at neither pole) and d_phi; acos (where z / r is
    inside its clamp, inclusive), atan2 and the norm take them to
    d(x, y, z) = d_o."""
    T = offsets[0].dtype
    x, y, z, r, c0, c, theta, phi = _moved(vx, vy, vz, offsets)
    t = hpx.interp_terms(nside, theta, phi)
    f1, f2, wt = t["f1"], t["f2"], t["wt"]
    g = [ct[p] for p in t["p"]]
    d_map = None
    if need_map:
        ws = ((1 - wt) * (1 - f1), (1 - wt) * f1, wt * (1 - f2), wt * f2)
        d_map = sum(w.to(orig_map.dtype) * gk for w, gk in zip(ws, g))
    dw = [(orig_map * gk).to(T) for gk in g]
    d_wt = -(1 - f1) * dw[0] - f1 * dw[1] + (1 - f2) * dw[2] + f2 * dw[3]
    d_f1 = (1 - wt) * (dw[1] - dw[0])
    d_f2 = wt * (dw[3] - dw[2])
    inside = ((t["wt0"] >= 0) & (t["wt0"] <= 1) & ~t["npole"]
              & ~t["spole"])
    d_th = torch.where(inside, d_wt / t["denom"], 0.0)
    d_phi = d_f1 / t["dphi1"] + d_f2 / t["dphi2"]
    d_c0 = torch.where((c0 >= -1) & (c0 <= 1),
                       d_th * -(1 / torch.sqrt(1 - c * c)), 0.0)
    r3 = r * r * r
    rho2 = x * x + y * y
    d_x = d_c0 * (-z * x / r3) + d_phi * (-y / rho2)
    d_y = d_c0 * (-z * y / r3) + d_phi * (x / rho2)
    d_z = d_c0 * (1 / r - z * z / r3)
    return (d_x, d_y, d_z), d_map


def _on_card(name, dev, nside, n_in):
    """True for CUDA tensors, False for CPU ones; raises for another
    device or sizes the kernels do not take."""
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    if not 1 <= nside <= MAX_NSIDE:
        raise ValueError(f"{name} takes NSIDE 1..{MAX_NSIDE}, not {nside}")
    if n_in >= 2 ** 30:
        raise ValueError(f"{name} takes fewer than 2^30 input pixels")
    return True


def _planes(name, vx, vy, vz, orig_map, offsets):
    """The seven input planes (vx, vy, vz, ox, oy, oz, m) for a kernel:
    checked, the unit vectors cast to the offsets' dtype (as the plain
    version casts them), contiguous. Returns (planes, dtype, n)."""
    ox = offsets[0]
    T, n = ox.dtype, ox.shape[0]
    if T not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: offsets must be float32 or float64, "
                        f"got {T}")
    if orig_map.dtype != T:
        raise TypeError(f"{name} on the card takes the map in the offsets' "
                        f"dtype {T}, got {orig_map.dtype}")
    planes = (vx.to(T), vy.to(T), vz.to(T)) + tuple(offsets) + (orig_map,)
    for p in planes:
        if p.dim() != 1 or p.shape[0] != n or p.dtype != T:
            raise ValueError(f"{name}: every plane must be 1-D of {n} "
                             f"{T} values")
        if p.device != ox.device:
            raise ValueError(f"{name}: all tensors must be on {ox.device}, "
                             f"found one on {p.device}")
    return tuple(p.contiguous() for p in planes), T, n


def _ptrs(planes):
    return (ctypes.c_void_p * len(planes))(*[p.data_ptr() for p in planes])


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _regrid_atomic(nside, planes, T, n, tally=None):
    """The atomic kernel into a zeroed map; ``tally`` (an int64 tensor of
    one element on the card, or None) gets the global adds the kernel
    issued added to it (for the tests and ``chip_smoke.py``)."""
    dev = planes[0].device
    out = torch.zeros(hpx.npix(nside), dtype=T, device=dev)
    if n:
        _call("regrid", T, nside, n, _ptrs(planes),
              _ring_table(nside, T, dev).data_ptr(), out.data_ptr(),
              None if tally is None else tally.data_ptr(), _stream(out))
        LAUNCHES["regrid"] += 1
    return out


def _segment_counts(nside, planes, T, n):
    """The deterministic route's first kernel: each destination's count of
    (pixel, corner) rows with a nonzero value (int32, npix)."""
    dev = planes[0].device
    count = torch.zeros(hpx.npix(nside), dtype=torch.int32, device=dev)
    if n:
        _call("regrid_count", T, nside, n, _ptrs(planes),
              _ring_table(nside, T, dev).data_ptr(), count.data_ptr(),
              _stream(count))
    return count


def _regrid_det(nside, planes, T, n):
    """The deterministic route: count, scan, fill, sorted segment sums."""
    dev = planes[0].device
    npix = hpx.npix(nside)
    if not n:
        return torch.zeros(npix, dtype=T, device=dev)
    count = _segment_counts(nside, planes, T, n)
    cursor = torch.cumsum(count, 0) - count           # int64 segment starts
    keys = torch.empty(4 * n, dtype=torch.int32, device=dev)
    vals = torch.empty(4 * n, dtype=T, device=dev)
    _call("regrid_fill", T, nside, n, _ptrs(planes),
          _ring_table(nside, T, dev).data_ptr(), cursor.data_ptr(),
          keys.data_ptr(), vals.data_ptr(), _stream(count))
    # cursor now holds each segment's end; a segment of more than 16 rows
    # goes to the long list (at most 4 n / 17 of them)
    long_list = torch.empty(4 * n // 17 + 1, dtype=torch.int32, device=dev)
    n_long = torch.zeros(1, dtype=torch.int32, device=dev)
    out = torch.empty(npix, dtype=T, device=dev)
    _call("regrid_sum", T, npix, count.data_ptr(), cursor.data_ptr(),
          keys.data_ptr(), vals.data_ptr(), long_list.data_ptr(),
          n_long.data_ptr(), out.data_ptr(), _stream(count))
    LAUNCHES["regrid_det"] += 1
    return out


def _regrid_raw(nside, vx, vy, vz, orig_map, offsets):
    """The forward with no autograd: the plain version on the CPU, on the
    card the atomic kernel or, under deterministic algorithms, the
    deterministic route."""
    offsets = tuple(offsets)
    if not _on_card("regrid_shell", offsets[0].device, nside,
                    offsets[0].shape[0]):
        return regrid_shell_reference(nside, vx, vy, vz, orig_map, offsets)
    planes, T, n = _planes("regrid_shell", vx, vy, vz, orig_map, offsets)
    if torch.are_deterministic_algorithms_enabled():
        return _regrid_det(nside, planes, T, n)
    return _regrid_atomic(nside, planes, T, n)


def _regrid_parts(nside, vx, vy, vz, offsets):
    """Each pixel's four RING ids (int64) and four weights (the offsets'
    dtype) as (4, n) tensors: on the card the check entry of the kernels'
    source, on the CPU ``hpx.get_interp_weights_parts`` of the plain
    version's angles. For the tests and ``chip_smoke.py``."""
    offsets = tuple(offsets)
    ox = offsets[0]
    if not _on_card("regrid_parts", ox.device, nside, ox.shape[0]):
        theta, phi = _moved(vx, vy, vz, offsets)[-2:]
        ps, ws = hpx.get_interp_weights_parts(nside, theta, phi)
        return torch.stack(ps), torch.stack(ws)
    planes, T, n = _planes("regrid_parts", vx, vy, vz, ox, offsets)
    ids = torch.empty((4, n), dtype=torch.int64, device=ox.device)
    w = torch.empty((4, n), dtype=T, device=ox.device)
    if n:
        _call("regrid_parts", T, nside, n, _ptrs(planes),
              _ring_table(nside, T, ox.device).data_ptr(), ids.data_ptr(),
              w.data_ptr(), _stream(ox))
    return ids, w


def regrid_vjp(nside, vx, vy, vz, orig_map, offsets, ct, need_map=True):
    """The adjoint of the regrid for the map's cotangent ``ct`` (npix,):
    ((d_ox, d_oy, d_oz), d_map), d_map None unless ``need_map``. CUDA
    tensors go through the kernel in one launch (each gradient written
    once, no atomics); CPU tensors take :func:`regrid_vjp_reference`."""
    offsets = tuple(offsets)
    ox = offsets[0]
    if not _on_card("regrid_vjp", ox.device, nside, ox.shape[0]):
        return regrid_vjp_reference(nside, vx, vy, vz, orig_map, offsets,
                                    ct, need_map)
    planes, T, n = _planes("regrid_vjp", vx, vy, vz, orig_map, offsets)
    if ct.dtype != T or ct.shape != (hpx.npix(nside),) \
            or ct.device != ox.device:
        raise ValueError(f"regrid_vjp: ct must be {T} of shape "
                         f"({hpx.npix(nside)},) on {ox.device}")
    ct = ct.contiguous()
    d = tuple(torch.empty(n, dtype=T, device=ox.device) for _ in range(3))
    d_map = torch.empty(n, dtype=T, device=ox.device) if need_map else None
    if n:
        _call("regrid_vjp", T, nside, n, _ptrs(planes),
              _ring_table(nside, T, ox.device).data_ptr(), ct.data_ptr(),
              *(t.data_ptr() for t in d),
              None if d_map is None else d_map.data_ptr(), _stream(ct))
        LAUNCHES["regrid_vjp"] += 1
    return d, d_map


class _RegridFn(torch.autograd.Function):
    """The regrid, differentiable in the offsets, the map and the unit
    vectors (whose gradient is the offsets')."""

    @staticmethod
    def forward(ctx, nside, vx, vy, vz, orig_map, ox, oy, oz):
        ctx.nside = nside
        ctx.save_for_backward(vx, vy, vz, orig_map, ox, oy, oz)
        return _regrid_raw(nside, vx, vy, vz, orig_map, (ox, oy, oz))

    @staticmethod
    def backward(ctx, ct):
        vx, vy, vz, m, ox, oy, oz = ctx.saved_tensors
        need = ctx.needs_input_grad
        args = (ctx.nside, vx, vy, vz, m, (ox, oy, oz), ct, need[4])
        # under create_graph the closed form as torch ops (differentiable
        # once more), on the card too; otherwise the kernel on the card
        d_o, d_m = (regrid_vjp_reference(*args) if torch.is_grad_enabled()
                    else regrid_vjp(*args))
        d_v = tuple(d.to(v.dtype) if k else None
                    for d, v, k in zip(d_o, (vx, vy, vz), need[1:4]))
        return ((None,) + d_v + (d_m if need[4] else None,)
                + tuple(d if k else None for d, k in zip(d_o, need[5:])))


def regrid_shell(nside, vx, vy, vz, orig_map, offsets):
    """The regrid of stage C into a new full-sky RING map of the map's
    dtype (see the module docstring). Where an input requires grad (and
    grad mode is on) the call is recorded for autograd."""
    offsets = tuple(offsets)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (vx, vy, vz, orig_map) + offsets):
        return _RegridFn.apply(nside, vx, vy, vz, orig_map, *offsets)
    return _regrid_raw(nside, vx, vy, vz, orig_map, offsets)
