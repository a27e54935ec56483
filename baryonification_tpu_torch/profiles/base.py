"""Halo-profile base class: evaluation contract, projection, algebra.

The port of ``baryonification_tpu.profiles.base``. Evaluation contract
(mirrors CCL): ``real(cosmo, r, M, a)`` returns shape (M, r); scalar r
and/or M axes are squeezed away. Profiles compute on ``cosmo``'s device
in its dtype (float64); ``a`` is a Python float.
"""

import math
import operator

import torch

from ..cosmology.massdef import MassDef
from ..utils import geomspace, interp

__all__ = ["HaloProfile", "CombinedProfile", "default_fftlog_params"]


def default_fftlog_params():
    """FFTLog precision knobs, mirroring CCL's ``precision_fftlog`` dict."""
    return dict(padding_lo_fftlog=1e-2, padding_hi_fftlog=1e2,
                padding_lo_extra=1e-4, padding_hi_extra=1e4,
                n_per_decade=100, plaw_fourier=-2.0)


def _is_scalar(x):
    return torch.as_tensor(x).dim() == 0


class HaloProfile:
    """Base class for all halo profiles."""

    #: parameter vocabulary; subclasses override
    model_param_names = []

    def __init__(self, mass_def=None,
                 use_fftlog_projection=False,
                 padding_lo_proj=0.1, padding_hi_proj=10.0,
                 n_per_decade_proj=10,
                 xi_mm=None,
                 proj_chunk=4096,
                 **kwargs):
        if mass_def is None:
            mass_def = MassDef(200, "critical")
        self.mass_def = mass_def
        self.xi_mm = xi_mm

        # parameter auto-defaulting: missing mu_/nu_/zeta_ slopes -> 0,
        # M_* normalizations -> 1e14, else None
        for m in self.model_param_names:
            if m in kwargs:
                setattr(self, m, kwargs[m])
            elif ("mu_" in m) or ("nu_" in m) or ("zeta_" in m):
                setattr(self, m, 0)
            elif "M_" in m:
                setattr(self, m, 1e14)
            else:
                setattr(self, m, None)

        self.padding_lo_proj = padding_lo_proj
        self.padding_hi_proj = padding_hi_proj
        self.n_per_decade_proj = n_per_decade_proj
        self.proj_chunk = proj_chunk

        # cutoff: sigmoid truncation scale in comoving Mpc (1 Gpc
        # default); proj_cutoff bounds the projection integral
        self.cutoff = kwargs.get("cutoff", 1e3)
        self.proj_cutoff = kwargs.get("proj_cutoff", self.cutoff)

        self.use_fftlog_projection = use_fftlog_projection
        if use_fftlog_projection:
            assert self.cutoff == self.proj_cutoff, (
                "Set the same cutoff for the 3D profile and the projection "
                "to use the fftlog projection.")

        self.precision_fftlog = default_fftlog_params()

    # ----- parameter plumbing -----
    def update_precision_fftlog(self, **kwargs):
        self.precision_fftlog.update(kwargs)

    @property
    def model_params(self):
        return {k: v for k, v in vars(self).items()
                if k in self.model_param_names}

    def set_parameter(self, key, value):
        """Recursively set ``key`` on this profile and nested sub-profiles."""
        _set_parameter(self, key, value)

    # ----- evaluation -----
    def _real(self, cosmo, r, M, a):
        raise NotImplementedError

    def real(self, cosmo, r, M, a):
        r_use = torch.atleast_1d(cosmo.tensor(r))
        M_use = torch.atleast_1d(cosmo.tensor(M))
        prof = self._real(cosmo, r_use, M_use, a)
        if _is_scalar(r):
            prof = prof.squeeze(-1)
        if _is_scalar(M):
            prof = prof.squeeze(0)
        return prof

    #: subclasses with a native projected implementation set this;
    #: otherwise the real-space or fftlog integral is used
    _projected = None

    def projected(self, cosmo, r, M, a, n_decades=None):
        """Projected (surface) density, shape (M, r).

        ``n_decades`` fixes the decade count of the real-space projection
        grid (default: the decades the radii span, as an eager call of the
        JAX package computes it)."""
        r_use = torch.atleast_1d(cosmo.tensor(r))
        M_use = torch.atleast_1d(cosmo.tensor(M))
        if self._projected is not None:
            prof = self._projected(cosmo, r_use, M_use, a)
        elif self.use_fftlog_projection:
            prof = self._projected_fftlog(cosmo, r_use, M_use, a)
        else:
            prof = self._projected_realspace(cosmo, r_use, M_use, a,
                                             n_decades)
        if _is_scalar(r):
            prof = prof.squeeze(-1)
        if _is_scalar(M):
            prof = prof.squeeze(0)
        return prof

    def _projected_realspace(self, cosmo, r_use, M_use, a, n_decades=None):
        """Abel projection with a hard upper cutoff, as a chunked batched
        integral: Sigma(rp) = 2 int rho(sqrt(l^2 + rp^2)) dl with the
        substitution l -> r_integral, on n_per_decade_proj points per
        decade."""
        int_min = self.padding_lo_proj * float(r_use.min())
        int_max = self.padding_hi_proj * float(r_use.max())
        n_dec = (math.log10(int_max / int_min) if n_decades is None
                 else n_decades)
        if self.proj_cutoff is not None:
            int_max = self.proj_cutoff
        int_N = max(int(self.n_per_decade_proj * int(n_dec)), 32)
        r_integral = geomspace(int_min, int_max, int_N, device=cosmo.device,
                               dtype=cosmo.dtype)

        prof = self._real(cosmo, r_integral, M_use, a)  # (M, Nint)

        # The integral is linear in the tabulated profile: for each chunk
        # of rp, build the (chunk, Nint) weights of "interpolate at
        # sqrt(l^2 + rp^2), then trapezoid over l" once, and apply them to
        # every mass with one matmul. The interpolation clamps at the ends
        # (np.interp semantics) like the JAX package's.
        N = int_N
        dl = torch.diff(r_integral)
        trap = 0.5 * (torch.cat([dl, dl[-1:] * 0]) + torch.cat([dl[:1] * 0,
                                                               dl]))
        out = []
        for rp in torch.split(r_use, self.proj_chunk):
            rr = torch.sqrt(r_integral[None, :] ** 2 + rp[:, None] ** 2)
            i = torch.clamp(torch.searchsorted(r_integral, rr, right=True),
                            1, N - 1)
            lo, hi = r_integral[i - 1], r_integral[i]
            w = torch.where(rr < r_integral[0], 0.0,
                            torch.where(rr > r_integral[-1], 1.0,
                                        (rr - lo) / (hi - lo)))
            K = torch.zeros((rp.shape[0], N), dtype=prof.dtype,
                            device=prof.device)
            K.scatter_add_(1, i - 1, (1.0 - w) * trap)
            K.scatter_add_(1, i, w * trap)
            out.append(2.0 * prof @ K.T)                 # (M, chunk)
        return torch.cat(out, dim=-1)

    def _projected_fftlog(self, cosmo, r_use, M_use, a):
        """FFTLog-based projection (CCL default path, opt-in here)."""
        from ..ops.fftlog import fftlog_transform
        par = self.precision_fftlog
        r_min = min(float(r_use.min()) * par["padding_lo_fftlog"], 1e-8)
        r_max = max(float(r_use.max()) * par["padding_hi_fftlog"], 1e3)
        n = int(par["n_per_decade"] * 12)
        r_fft = geomspace(r_min, r_max, n, device=cosmo.device,
                          dtype=cosmo.dtype)
        prof = self._real(cosmo, r_fft, M_use, a)
        # projection theorem: Sigma = (2 pi)^3 T2[T3[rho]]
        k, Pk = fftlog_transform(r_fft, prof, 3, 0, par["plaw_fourier"])
        rp, sig = fftlog_transform(k, Pk, 2, 0, par["plaw_fourier"] + 1)
        sig = sig * (2.0 * math.pi) ** 3
        return interp(torch.log(r_use), torch.log(rp), sig)

    # ----- misc -----
    def __str_par__(self):
        s = "("
        for m in self.model_param_names:
            s += f"{m} = {getattr(self, m)}, "
        return s[:-2] + ")"

    def __str_prf__(self):
        return self.__class__.__name__

    def __str__(self):
        return self.__str_prf__() + self.__str_par__()

    __repr__ = __str__

    # ----- profile algebra -----
    def __add__(self, other):
        return CombinedProfile(operator.add, self, other, "add")

    def __radd__(self, other):
        return CombinedProfile(operator.add, other, self, "add")

    def __sub__(self, other):
        return CombinedProfile(operator.sub, self, other, "sub")

    def __rsub__(self, other):
        return CombinedProfile(operator.sub, other, self, "sub")

    def __mul__(self, other):
        return CombinedProfile(operator.mul, self, other, "mul")

    def __rmul__(self, other):
        return CombinedProfile(operator.mul, other, self, "mul")

    def __truediv__(self, other):
        return CombinedProfile(operator.truediv, self, other, "truediv")

    def __rtruediv__(self, other):
        return CombinedProfile(operator.truediv, other, self, "truediv")

    def __pow__(self, other):
        return CombinedProfile(operator.pow, self, other, "pow")

    def __neg__(self):
        return CombinedProfile(lambda a, b: -a, self, None, "neg")

    def __pos__(self):
        return self

    def __abs__(self):
        return CombinedProfile(lambda a, b: abs(a), self, None, "abs")


class CombinedProfile(HaloProfile):
    """Pointwise arithmetic combination of profiles and/or scalars.

    The combined ``_real`` applies ``op`` to the operand evaluations; the
    projected profile integrates the combined 3D profile like any other.
    """

    def __init__(self, op, left, right, opname="op"):
        self.op = op
        self.left = left
        self.right = right
        self.opname = opname
        # inherit evaluation configuration from the first profile operand
        proto = left if isinstance(left, HaloProfile) else right
        super().__init__(mass_def=proto.mass_def,
                         padding_lo_proj=proto.padding_lo_proj,
                         padding_hi_proj=proto.padding_hi_proj,
                         n_per_decade_proj=proto.n_per_decade_proj,
                         xi_mm=proto.xi_mm,
                         cutoff=proto.cutoff,
                         proj_cutoff=proto.proj_cutoff)
        self.precision_fftlog = dict(proto.precision_fftlog)

    def _operand(self, o, cosmo, r, M, a):
        if isinstance(o, HaloProfile):
            return o._real(cosmo, r, M, a)
        return o  # scalar or None

    def _real(self, cosmo, r, M, a):
        lv = self._operand(self.left, cosmo, r, M, a)
        rv = self._operand(self.right, cosmo, r, M, a)
        return self.op(lv, rv)

    def __str_prf__(self):
        parts = []
        for o in (self.left, self.right):
            if isinstance(o, HaloProfile):
                parts.append(o.__str_prf__())
            elif o is not None:
                parts.append(str(o))
        return f"{self.opname}[" + ", ".join(parts) + "]"


def _set_parameter(obj, key, value):
    """Recursive attribute setter descending into nested HaloProfiles."""
    for k in list(vars(obj).keys()):
        if k == key:
            setattr(obj, key, value)
        elif isinstance(getattr(obj, k), HaloProfile):
            _set_parameter(getattr(obj, k), key, value)
