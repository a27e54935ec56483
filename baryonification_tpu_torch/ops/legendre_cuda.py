"""Scaled Legendre recurrences of the SHT: hand-written Hopper kernels and
their plain versions.

Both functions run the normalised associated-Legendre recurrence over
ell for every m on the equator-folded northern half of a HEALPix map
(R = 2 * nside rings, ring R-1 the equator), with the libsharp-style
scaled representation lambda_lm = p * FOLD^-sc of the JAX package:

- ``legendre_alm`` (analysis, the port of ``_legendre_alm_pallas``):
  ``A[l, m] = sum_r lambda_lm(x_r) * G_fold[m, r]``, with the even fold
  (Ger, Gei) where l + m is even and the odd fold (Gor, Goi) where it is
  odd. Returns (Ar, Ai), each (L, L) indexed [l, m], zero where m > l.
- ``legendre_synth`` (synthesis, the port of ``_legendre_synth_pallas``):
  the parity folds of ``B[m, r] = sum_{l>=m} a_lm * lambda_lm(x_r)``,
  split by l + m even (Ber, Bei) or odd (Bor, Boi). Returns four (L, R)
  planes indexed [m, r].

Inputs: the folds or a_lm planes, the sectoral seeds ``p_mm`` (L, R) and
their scale counters ``sc0`` (L, R) int32, and x = cos(theta) of the R
northern rings, all contiguous on one device in one float dtype (int32
for ``sc0``).

Dispatch is by the device of the tensors: CPU tensors take the plain
PyTorch version (``*_reference``, a Python loop over ell of whole-plane
ops); CUDA tensors launch the kernel of ``csrc/legendre_sht.cu``, built at
first use, or the call raises. ``LAUNCHES`` counts kernel launches.
"""

import ctypes

import torch

from .._cuda_build import load_library

__all__ = ["legendre_alm", "legendre_synth", "legendre_alm_reference",
           "legendre_synth_reference", "LAUNCHES"]

#: kernel launches by kernel name (read and reset by callers)
LAUNCHES = {"legendre_alm": 0, "legendre_synth": 0}

#: most northern rings the kernels take (16 per thread, 256 threads)
MAX_RINGS = 4096

_FUNCS = {}


def _fold_big(dtype):
    """(FOLD, BIG) of the scaled recurrence: a lane whose |p| exceeds BIG
    while its scale counter is positive is divided by FOLD."""
    return (1e40, 1e20) if dtype == torch.float64 else (1e20, 1e10)


def _kernel(name, dtype):
    key = (name, dtype)
    if key not in _FUNCS:
        lib = load_library("legendre_sht")
        suffix = "f64" if dtype == torch.float64 else "f32"
        fn = getattr(lib, f"{name}_{suffix}")
        P, I = ctypes.c_void_p, ctypes.c_int
        # both take 9 tensor pointers (inputs, then outputs), L, R, stream
        fn.argtypes = [P] * 9 + [I, I, P]
        fn.restype = I
        _FUNCS[key] = fn
    return _FUNCS[key]


def synth_chunk():
    """ell steps between two votes of a warp of the synthesis kernel on its
    slots, as built (for whoever models the kernel's control flow)."""
    fn = load_library("legendre_sht").legendre_synth_chunk
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def _check(planes, planes_shape, p_mm, sc0, x):
    """Validate the inputs; returns (L, R)."""
    dt = p_mm.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"float32 or float64 inputs expected, got {dt}")
    L, R = p_mm.shape if p_mm.dim() == 2 else (None, None)
    if L is None or x.shape != (R,) or sc0.shape != (L, R):
        raise ValueError(f"need p_mm and sc0 of shape (L, R) and x of shape "
                         f"(R,), got {tuple(p_mm.shape)}, "
                         f"{tuple(sc0.shape)}, {tuple(x.shape)}")
    if sc0.dtype != torch.int32:
        raise TypeError(f"sc0 must be int32, got {sc0.dtype}")
    for t in planes:
        if t.shape != planes_shape(L, R):
            raise ValueError(f"planes must be of shape {planes_shape(L, R)}, "
                             f"got {tuple(t.shape)}")
    for t in planes + (p_mm, x):
        if t.dtype != dt:
            raise TypeError(f"all float inputs must be {dt}, got {t.dtype}")
    for t in planes + (p_mm, sc0, x):
        if t.device != p_mm.device:
            raise ValueError(f"all inputs must be on {p_mm.device}, found "
                             f"one on {t.device}")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    return L, R


def _recurrence_step(l, k, x, p1, p2, sc, p_mm, sc0, FOLD, BIG):
    """One ell step of the scaled recurrence on rows m = 0..k-1 (k = l+1,
    the rows with m <= l). Updates p1, p2, sc in place; returns lambda
    (k, R) and the (k, 1) even-parity mask of l + m."""
    dt = x.dtype
    mf = torch.arange(k, device=x.device, dtype=dt)[:, None]
    lf = float(l)
    # factored (l-m)(l+m) forms and clamps exactly as the JAX package's
    al = torch.sqrt(max((2 * lf - 1) * (2 * lf + 1), 0.5)
                    / torch.clamp((lf - mf) * (lf + mf), min=0.5))
    al1 = torch.sqrt(max((2 * lf - 3) * (2 * lf - 1), 0.5)
                     / torch.clamp((lf - 1 - mf) * (lf - 1 + mf), min=0.5))
    q1, q2, s = p1[:k], p2[:k], sc[:k]
    p = al * (x * q1 - q2 * (1.0 / al1))
    # the row m = l seeds here; rows m < l continue the recurrence
    p[l] = p_mm[l]
    s[l] = sc0[l]
    grow = (p.abs() > BIG) & (s > 0)
    p = torch.where(grow, p * (1.0 / FOLD), p)
    new_p2 = torch.where(grow, q1 * (1.0 / FOLD), q1)
    new_p2[l] = 0.0
    s -= grow.to(torch.int32)
    q2.copy_(new_p2)
    q1.copy_(p)
    lam = torch.where(s == 0, p, 0.0)
    even = (torch.arange(k, device=x.device)[:, None] + l) % 2 == 0
    return lam, even


def legendre_alm_reference(Ger, Gor, Gei, Goi, p_mm, sc0, x):
    """Plain PyTorch version of :func:`legendre_alm`."""
    L, R = p_mm.shape
    FOLD, BIG = _fold_big(p_mm.dtype)
    p1, p2 = torch.zeros_like(p_mm), torch.zeros_like(p_mm)
    sc = torch.zeros_like(sc0)
    Ar = torch.zeros((L, L), dtype=p_mm.dtype, device=p_mm.device)
    Ai = torch.zeros_like(Ar)
    for l in range(L):
        k = l + 1
        lam, even = _recurrence_step(l, k, x, p1, p2, sc, p_mm, sc0, FOLD,
                                     BIG)
        Ar[l, :k] = (torch.where(even, Ger[:k], Gor[:k]) * lam).sum(dim=1)
        Ai[l, :k] = (torch.where(even, Gei[:k], Goi[:k]) * lam).sum(dim=1)
    return Ar, Ai


def legendre_synth_reference(ar, ai, p_mm, sc0, x):
    """Plain PyTorch version of :func:`legendre_synth`."""
    L, R = p_mm.shape
    FOLD, BIG = _fold_big(p_mm.dtype)
    p1, p2 = torch.zeros_like(p_mm), torch.zeros_like(p_mm)
    sc = torch.zeros_like(sc0)
    Ber, Bor, Bei, Boi = (torch.zeros_like(p_mm) for _ in range(4))
    for l in range(L):
        k = l + 1
        lam, even = _recurrence_step(l, k, x, p1, p2, sc, p_mm, sc0, FOLD,
                                     BIG)
        cr = ar[l, :k, None] * lam
        ci = ai[l, :k, None] * lam
        Ber[:k] += torch.where(even, cr, 0.0)
        Bor[:k] += torch.where(even, 0.0, cr)
        Bei[:k] += torch.where(even, ci, 0.0)
        Boi[:k] += torch.where(even, 0.0, ci)
    return Ber, Bor, Bei, Boi


def _launch(name, ins, outs, L, R, dev):
    err = _kernel(name, ins[0].dtype)(
        *(t.data_ptr() for t in ins + outs), L, R,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _on_cuda(name, dev, R):
    """Whether the call launches the kernel (CUDA) or takes the plain
    version (CPU); raises for other devices and for more rings than the
    kernel's 16 per thread x 256 threads."""
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    if R > MAX_RINGS:
        raise ValueError(f"{name} takes at most {MAX_RINGS} rings "
                         f"(NSIDE <= {MAX_RINGS // 2}), got {R}")
    return True


def legendre_alm(Ger, Gor, Gei, Goi, p_mm, sc0, x):
    """Analysis recurrence; returns (Ar, Ai), each (L, L) [l, m]. CUDA
    tensors launch the kernel; CPU tensors take the plain version."""
    L, R = _check((Ger, Gor, Gei, Goi), lambda L, R: (L, R), p_mm, sc0, x)
    if not _on_cuda("legendre_alm", p_mm.device, R):
        return legendre_alm_reference(Ger, Gor, Gei, Goi, p_mm, sc0, x)
    # zeros: the kernel leaves the m > l triangle alone
    outs = tuple(torch.zeros((L, L), dtype=p_mm.dtype, device=p_mm.device)
                 for _ in range(2))
    _launch("legendre_alm", (Ger, Gor, Gei, Goi, p_mm, x, sc0), outs, L, R,
            p_mm.device)
    return outs


def legendre_synth(ar, ai, p_mm, sc0, x):
    """Synthesis recurrence; returns (Ber, Bor, Bei, Boi), each (L, R)
    [m, r]. CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    L, R = _check((ar, ai), lambda L, R: (L, L), p_mm, sc0, x)
    if not _on_cuda("legendre_synth", p_mm.device, R):
        return legendre_synth_reference(ar, ai, p_mm, sc0, x)
    # the kernel writes every [m, r]
    outs = tuple(torch.empty((L, R), dtype=p_mm.dtype, device=p_mm.device)
                 for _ in range(4))
    _launch("legendre_synth", (ar, ai, p_mm, x, sc0), outs, L, R,
            p_mm.device)
    return outs
