"""Concentration-mass relations (ccl.halos.concentration parity).

The port of the two relations the Schneider19 family uses:
``ConcentrationDiemer15`` (its default) and ``ConcentrationConstant`` (a
user-given ``cdelta``).
"""

import math
from dataclasses import dataclass

import torch

from ..constants import DELTA_COLLAPSE
from .massdef import MassDef

__all__ = ["ConcentrationConstant", "ConcentrationDiemer15"]


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
