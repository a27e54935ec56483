"""Concentration-mass relations (ccl.halos.concentration parity).

The port of the three relations the profile families use:
``ConcentrationDiemer15`` (the Schneider19 and Arico20 default),
``ConcentrationDuffy08`` (the Mead20 default) and
``ConcentrationConstant`` (a user-given ``cdelta``).
"""

import math
from dataclasses import dataclass

import torch

from ..constants import DELTA_COLLAPSE
from .massdef import MassDef

__all__ = ["ConcentrationConstant", "ConcentrationDiemer15",
           "ConcentrationDuffy08"]


@dataclass(frozen=True)
class ConcentrationConstant:
    c: float = 7.0
    mass_def: MassDef = MassDef(200, "critical")

    def __call__(self, cosmo, M, a):
        return torch.full_like(cosmo.tensor(M), float(self.c))


@dataclass(frozen=True)
class ConcentrationDiemer15:
    """Diemer & Kravtsov 2015 (ApJ 799, 108) median c200c(nu, n) relation.

    c = 0.5 c_min [ (nu/nu_min)^-alpha + (nu/nu_min)^beta ],
    c_min = phi0 + phi1 n,  nu_min = eta0 + eta1 n,
    n = dlnP/dlnk at k = kappa 2pi / R_L  (median calibration).
    """

    mass_def: MassDef = MassDef(200, "critical")
    kappa: float = 0.69
    phi0: float = 6.58
    phi1: float = 1.37
    eta0: float = 6.82
    eta1: float = 1.42
    alpha: float = 1.12
    beta: float = 1.69

    def __call__(self, cosmo, M, a):
        M = cosmo.tensor(M)
        R_L = cosmo.lagrangian_R(M)
        n = cosmo.dlnP_dlnk(self.kappa * 2.0 * math.pi / R_L)
        nu = DELTA_COLLAPSE / cosmo.sigmaM(M, a)
        c_min = self.phi0 + self.phi1 * n
        nu_min = self.eta0 + self.eta1 * n
        return 0.5 * c_min * ((nu / nu_min) ** -self.alpha
                              + (nu / nu_min) ** self.beta)


_DUFFY_PARAMS = {
    (200.0, "critical"): (5.71, -0.084, -0.47),
    (200.0, "matter"): (10.14, -0.081, -1.01),
}


@dataclass(frozen=True)
class ConcentrationDuffy08:
    """Duffy et al. 2008 power-law c(M, z) (full-sample NFW fits)."""

    mass_def: MassDef = MassDef(200, "critical")

    def __call__(self, cosmo, M, a):
        key = (float(self.mass_def.Delta), self.mass_def.rho_type)
        A, B, C = _DUFFY_PARAMS[key]
        M_pivot = 2e12 / cosmo.h
        return A * (cosmo.tensor(M) / M_pivot) ** B * cosmo.tensor(a) ** (-C)
