"""Battaglia+12 GNFW pressure and gas-density profiles.

The port of ``baryonification_tpu.profiles.battaglia``: the three published
pressure calibrations ('200_AGN', '500_AGN', '500_SH') with the
self-similar P_Delta amplitude, the electron-pressure variant, and the two
gas-density calibrations ('200_AGN', '200_SH'). CGS output conventions
are the JAX package's. Closed forms on (M, r) tensors.
"""

import torch

from .. import constants as const
from ..cosmology.massdef import MassDef
from .base import HaloProfile
from .thermodynamic import G, Pth_to_Pe

__all__ = ['Pressure', 'ElectronPressure', 'GasDensity']

_PRESSURE_CALIBRATIONS = {
    '200_AGN': dict(Delta=200, P0=(18.1, 0.154, -0.758),
                    xc=(0.497, -0.00865, 0.731), beta=(4.35, 0.0393, 0.415)),
    '500_AGN': dict(Delta=500, P0=(7.49, 0.226, -0.957),
                    xc=(0.710, -0.0833, 0.853), beta=(4.19, 0.0480, 0.615)),
    '500_SH': dict(Delta=500, P0=(20.7, -0.074, -0.743),
                   xc=(0.428, 0.011, 1.01), beta=(3.82, 0.0375, 0.535)),
}

_DENSITY_CALIBRATIONS = {
    '200_AGN': dict(rho0=(4e3, 0.29, -0.66), alpha=(0.88, -0.03, 0.19),
                    beta=(3.83, 0.04, -0.025)),
    '200_SH': dict(rho0=(1.9e4, 0.09, -0.95), alpha=(0.70, -0.017, 0.27),
                   beta=(4.43, 0.005, 0.037)),
}


def _scaling(par, M, z):
    A, mu, nu = par
    return A * (M / 1e14) ** mu * (1 + z) ** nu


class Pressure(HaloProfile):
    """Battaglia+12 GNFW thermal pressure in CGS (barye).

    P(x) = P_Delta P_0 (x/x_c)^gamma (1 + (x/x_c)^alpha)^-beta with
    alpha=1, gamma=-0.3 and the self-similar amplitude
    P_Delta = Delta rho_crit(z) f_b G M / (2 R_phys).
    """

    def __init__(self, Model_def, truncate=False):
        if Model_def not in _PRESSURE_CALIBRATIONS:
            raise ValueError("Input Model_def not valid. Select one of: "
                             "200_AGN, 500_AGN, 500_SH")
        cal = _PRESSURE_CALIBRATIONS[Model_def]
        self.Model_def = Model_def
        self.truncate = truncate
        super().__init__(mass_def=MassDef(cal['Delta'], 'critical'))
        self.mdef = self.mass_def
        self.update_precision_fftlog(plaw_fourier=-2,
                                     padding_lo_fftlog=1e-4,
                                     padding_hi_fftlog=1e4)

    def _real(self, cosmo, r, M, a):
        z = 1 / a - 1
        cal = _PRESSURE_CALIBRATIONS[self.Model_def]
        P_0 = _scaling(cal['P0'], M, z)[:, None]
        x_c = _scaling(cal['xc'], M, z)[:, None]
        beta = _scaling(cal['beta'], M, z)[:, None]

        R = self.mass_def.get_radius(cosmo, M, a) / a  # comoving
        x = r[None, :] / R[:, None]

        Delta = self.mass_def.Delta
        fb = cosmo.Omega_b / cosmo.Omega_m
        rho_crit = cosmo.rho_crit(a)  # physical Msun/Mpc^3

        # self-similar amplitude; R*a converts comoving -> physical
        P_delta = (Delta * rho_crit * fb * G * M / (2 * R * a))[:, None]
        alpha, gamma = 1.0, -0.3
        prof = P_delta * P_0 * (x / x_c) ** gamma \
            * (1 + (x / x_c) ** alpha) ** -beta
        prof = prof * const.MSUN_G / const.MPC_CM  # -> CGS
        if self.truncate:
            prof = torch.where(x > self.truncate, 0.0, prof)
        return prof


class ElectronPressure(Pressure):
    """P_e = Pth_to_Pe x P_gas."""

    def _real(self, cosmo, r, M, a):
        return Pth_to_Pe * super()._real(cosmo, r, M, a)


class GasDensity(HaloProfile):
    """Battaglia+12 gas density in Msun/Mpc^3 (physical), mass definition
    forced to 200c."""

    def __init__(self, Model_def, truncate=False):
        if Model_def not in _DENSITY_CALIBRATIONS:
            raise ValueError("Input Model_def not valid. Select one of: "
                             "200_AGN, 200_SH")
        self.Model_def = Model_def
        self.truncate = truncate
        super().__init__(mass_def=MassDef(200, 'critical'))
        self.mdef = self.mass_def
        self.update_precision_fftlog(plaw_fourier=-2,
                                     padding_lo_fftlog=1e-4,
                                     padding_hi_fftlog=1e4)

    def _real(self, cosmo, r, M, a):
        z = 1 / a - 1
        cal = _DENSITY_CALIBRATIONS[self.Model_def]
        x_c, gamma = 0.5, -0.2
        rho_0 = _scaling(cal['rho0'], M, z)[:, None]
        alpha = _scaling(cal['alpha'], M, z)[:, None]
        beta = _scaling(cal['beta'], M, z)[:, None]

        R = self.mass_def.get_radius(cosmo, M, a) / a
        x = r[None, :] / R[:, None]
        fb = cosmo.Omega_b / cosmo.Omega_m
        rho_crit = cosmo.rho_crit(a)

        prof = rho_crit * fb * rho_0 * (x / x_c) ** gamma \
            * (1 + (x / x_c) ** alpha) ** -((beta - gamma) / alpha)
        if self.truncate:
            prof = torch.where(x > self.truncate, 0.0, prof)
        return prof
