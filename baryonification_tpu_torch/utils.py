"""Small tensor helpers shared by the port's modules.

``safe_log`` is the counterpart of ``baryonification_tpu.utils.safe_log``;
the rest are the numpy/jnp conveniences PyTorch lacks (``interp``,
``geomspace``), written to follow ``jnp``'s definitions so the two
packages agree to rounding, and ``resolve_device``, which every entry
point that makes tensors uses for its ``device`` argument.
"""

import math

import torch

__all__ = ["safe_log", "interp", "interp_rows", "geomspace",
           "resolve_device"]


def resolve_device(device):
    """``torch.device(device)``, refusing a CUDA device when none exists.

    The port's entry points run on the card unless the caller asks for
    the CPU, so a call that left ``device`` at its default on a machine
    without a GPU stops here instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but no CUDA device is available: the "
            f"port runs on the GPU by default; pass device=\"cpu\" to run "
            f"on the CPU")
    return dev


def safe_log(m):
    """log(m) for m > 0, -inf otherwise.

    The double ``where`` keeps the backward pass NaN-free: the gradient
    of a non-positive entry is an exact 0 instead of 0 * inf."""
    pos = m > 0
    return torch.where(pos, torch.log(torch.where(pos, m, 1.0)), -math.inf)


def geomspace(start, stop, num, *, device, dtype=torch.float64):
    """``jnp.geomspace`` for positive endpoints: 10 ** linspace(log10)."""
    lo = math.log10(float(start))
    hi = math.log10(float(stop))
    return torch.pow(10.0, torch.linspace(lo, hi, int(num), dtype=dtype,
                                          device=device))


def _interp_from_index(x, xp_lo, xp_hi, fp_lo, fp_hi, xp0, xpN, fp0, fpN):
    """The ``jnp.interp`` formula once the bracketing points are known."""
    dx = xp_hi - xp_lo
    eps = float(torch.finfo(x.dtype).eps)
    dx0 = dx.abs() <= math.ulp(eps)
    f = torch.where(dx0, fp_lo,
                    fp_lo + ((x - xp_lo) / torch.where(dx0, 1.0, dx))
                    * (fp_hi - fp_lo))
    f = torch.where(x < xp0, fp0, f)
    return torch.where(x > xpN, fpN, f)


def interp(x, xp, fp):
    """``jnp.interp``: piecewise-linear, clamped to the end values.

    ``xp`` is (N,) increasing; ``fp`` is (N,) or (..., N). With a batched
    ``fp`` every row is read at every query: the result has shape
    ``fp.shape[:-1] + x.shape``."""
    N = xp.shape[-1]
    shape = x.shape
    x = x.reshape(-1).contiguous()
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, N - 1)
    out = _interp_from_index(x, xp[i - 1], xp[i], fp[..., i - 1],
                             fp[..., i], xp[0], xp[-1], fp[..., :1],
                             fp[..., -1:])
    return out.reshape(fp.shape[:-1] + shape)


def interp_rows(x, xp, fp):
    """Row-paired ``jnp.interp`` (the port of ``vmap(jnp.interp)``).

    ``fp`` is (..., N); ``x`` is (..., Q) with the same leading dims;
    ``xp`` is (N,) shared or (..., N) per row. Row k of ``x`` is read
    against row k of ``(xp, fp)``; returns (..., Q)."""
    N = fp.shape[-1]
    lead = fp.shape[:-1]
    x = torch.broadcast_to(x, lead + x.shape[-1:]).contiguous()
    if xp.dim() == 1:
        i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, N - 1)
        xp_lo, xp_hi = xp[i - 1], xp[i]
        xp0, xpN = xp[0], xp[-1]
    else:
        xp = torch.broadcast_to(xp, lead + (N,)).contiguous()
        i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, N - 1)
        xp_lo = torch.gather(xp, -1, i - 1)
        xp_hi = torch.gather(xp, -1, i)
        xp0, xpN = xp[..., :1], xp[..., -1:]
    return _interp_from_index(x, xp_lo, xp_hi, torch.gather(fp, -1, i - 1),
                              torch.gather(fp, -1, i), xp0, xpN,
                              fp[..., :1], fp[..., -1:])
