"""Spherical-overdensity mass definitions (ccl.halos.massdef parity).

The port of ``baryonification_tpu.cosmology.massdef.MassDef``.
"""

import math
from dataclasses import dataclass

__all__ = ["MassDef"]


@dataclass(frozen=True, eq=True)
class MassDef:
    """Overdensity Delta w.r.t. critical or mean-matter density."""

    Delta: float = 200.0
    rho_type: str = "critical"  # 'critical' | 'matter'

    def get_radius(self, cosmo, M, a):
        """R_Delta in **physical** Mpc (callers divide by a for comoving).

        ``M`` and ``a`` are floats or tensors; tensors stay on their
        device, and arrays go to ``cosmo``'s device in float64."""
        rho = cosmo.rho_x(a, species=self.rho_type, is_comoving=False)
        M = cosmo.tensor(M)
        return (3.0 * M / (4.0 * math.pi * self.Delta * rho)) ** (1.0 / 3.0)
