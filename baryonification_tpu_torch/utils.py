"""Small helpers shared by the port's modules, and the reference's misc
utilities.

``safe_log`` is the counterpart of ``baryonification_tpu.utils.safe_log``;
``interp``, ``interp_rows`` and ``geomspace`` are the numpy/jnp
conveniences PyTorch lacks, written to follow ``jnp``'s definitions so the
two packages agree to rounding; ``resolve_device`` is what every entry
point that makes tensors uses for its ``device`` argument. The
reference's ``build_cosmodict``, ``log_time``, ``generate_operator_method``
and ``destory_Pk`` (its spelling) keep their names, and ``trace`` records
a ``torch.profiler`` trace.
"""

import math
import time
from contextlib import contextmanager
from functools import wraps
from pathlib import Path

import torch

__all__ = ["safe_log", "interp", "interp_rows", "geomspace",
           "resolve_device", "build_cosmodict", "log_time",
           "generate_operator_method", "destory_Pk", "trace"]


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


def build_cosmodict(cosmo):
    """The plain dict of cosmological parameters that the io objects take,
    from a :class:`~baryonification_tpu_torch.cosmology.Cosmology`."""
    return cosmo.cosmodict


def log_time(fn):
    """Decorator that prints the wall time of each call."""

    @wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        print(f"[log_time] {fn.__qualname__}: "
              f"{time.perf_counter() - t0:.3f}s")
        return out

    return wrapper


def generate_operator_method(op, reflected=False):
    """A profile-algebra dunder method for the ``operator`` function
    ``op``: it returns a
    :class:`~baryonification_tpu_torch.profiles.base.CombinedProfile` of
    the operands (``reflected``: the other operand first). Unary ``abs``,
    ``neg`` and ``pos`` take no other operand."""
    import operator as _operator
    from .profiles.base import CombinedProfile
    name = getattr(op, '__name__', 'op')
    if op in (_operator.abs, _operator.neg, _operator.pos):
        def method(self):
            return CombinedProfile(lambda a, b: op(a), self, None, name)
    elif reflected:
        def method(self, other):
            return CombinedProfile(lambda a, b: op(b, a), self, other, name)
    else:
        def method(self, other):
            return CombinedProfile(lambda a, b: op(a, b), self, other, name)
    return method


def destory_Pk(cosmo):
    """Returns ``cosmo``. The reference strips unpicklable P(k) handles
    from its cosmology before sending it to worker processes; the port's
    Cosmology holds tensors and pickles as it is. The name keeps the
    reference's spelling."""
    return cosmo


@contextmanager
def trace(log_dir):
    """Record the block with ``torch.profiler`` (the host, and the card
    where there is one) and write its Chrome trace into ``log_dir``
    (created if missing) as ``trace.json``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))
