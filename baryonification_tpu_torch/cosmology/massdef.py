"""Spherical-overdensity mass definitions (ccl.halos.massdef parity).

The port of ``baryonification_tpu.cosmology.massdef``: ``MassDef`` and
``mass_translator``, the NFW-shape mass translation between overdensity
definitions that the Green+20 non-thermal fractions use.
"""

import math
from dataclasses import dataclass

import torch

__all__ = ["MassDef", "mass_translator"]


@dataclass(frozen=True, eq=True)
class MassDef:
    """Overdensity Delta w.r.t. critical or mean-matter density."""

    Delta: float = 200.0
    rho_type: str = "critical"  # 'critical' | 'matter'

    def get_Delta(self, cosmo=None, a=None):
        return self.Delta

    def get_radius(self, cosmo, M, a):
        """R_Delta in **physical** Mpc (callers divide by a for comoving).

        ``M`` and ``a`` are floats or tensors; tensors stay on their
        device, and arrays go to ``cosmo``'s device in float64."""
        rho = cosmo.rho_x(a, species=self.rho_type, is_comoving=False)
        M = cosmo.tensor(M)
        return (3.0 * M / (4.0 * math.pi * self.Delta * rho)) ** (1.0 / 3.0)

    def get_mass(self, cosmo, R, a):
        """Inverse of get_radius; R in physical Mpc."""
        rho = cosmo.rho_x(a, species=self.rho_type, is_comoving=False)
        return 4.0 / 3.0 * math.pi * self.Delta * rho * cosmo.tensor(R) ** 3


def _nfw_mu(x):
    return torch.log(1.0 + x) - x / (1.0 + x)


def mass_translator(cosmo, M, a, mass_def_in, mass_def_out, concentration,
                    n_iter=60):
    """Translate halo mass between overdensity definitions via an NFW shape.

    Solves for x2 = R2/r_s with Delta2 rho2 x2^3 / mu(x2) =
    Delta1 rho1 c1^3 / mu(c1) by bisection in log space, a fixed
    ``n_iter`` steps on all masses at once, as the JAX package does."""
    M = cosmo.tensor(M)
    c1 = concentration(cosmo, M, a)
    rho1 = cosmo.rho_x(a, species=mass_def_in.rho_type, is_comoving=False)
    rho2 = cosmo.rho_x(a, species=mass_def_out.rho_type, is_comoving=False)
    K = (mass_def_in.Delta * rho1 * c1**3 / _nfw_mu(c1)
         / (mass_def_out.Delta * rho2))

    lo = torch.full_like(K, 1e-3)
    hi = torch.full_like(K, 1e3)
    for _ in range(n_iter):
        mid = torch.sqrt(lo * hi)
        gt = mid**3 / _nfw_mu(mid) - K > 0.0
        hi = torch.where(gt, mid, hi)
        lo = torch.where(gt, lo, mid)
    x2 = torch.sqrt(lo * hi)
    return M * _nfw_mu(x2) / _nfw_mu(c1)
