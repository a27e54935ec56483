"""Thermodynamic profiles: pressure, temperature, gas density, Compton-y.

The port of ``baryonification_tpu.profiles.thermodynamic``: hydrostatic
pressure (the inward cumulative integral of dP/dr = -G M(<r) rho_gas /
r^2), the Pandey+25 and Green+20 non-thermal fractions, electron
pressure, gas number density, ideal-gas temperature and the Compton-y
(tSZ) projection, in the JAX package's CGS output conventions. Every
profile evaluates as an (M, r) tensor on the cosmology's device.
"""

import math

import torch

from .. import constants as const
from ..cosmology.concentration import ConcentrationDiemer15
from ..cosmology.massdef import MassDef, mass_translator
from ..ops.interp import pchip_derivatives, pchip_eval
from .base import HaloProfile
from .schneider19 import (SchneiderProfiles, Gas, DarkMatterBaryon, TwoHalo,
                          model_params, sigmoid_cutoff, _grid)

__all__ = ['Pressure', 'NonThermalFrac', 'NonThermalFracGreen20',
           'Temperature', 'ThermalSZ', 'ElectronPressure', 'GasNumberDensity',
           'XrayLuminosity']

G = const.G_SI / const.MPC_M**3 * const.MSUN_KG     # Mpc^3 / (Msun s^2)
kb_cgs = const.K_BOLTZMANN                          # erg / K
Pth_to_Pe = const.PTH_TO_PE
Pressure_at_infinity = const.PRESSURE_AT_INFINITY
m_p_Msun = const.M_PROTON_G / const.MSUN_G          # proton mass in Msun


class BaseThermodynamicProfile(SchneiderProfiles):
    """Thermodynamic base: the SchneiderProfiles vocabulary, but missing
    parameters default to None (no mu/nu/zeta/M_* defaults)."""

    model_param_names = model_params

    def __init__(self, mass_def=None, **kwargs):
        known = {m: kwargs[m] for m in self.model_param_names if m in kwargs}
        extra = {k: v for k, v in kwargs.items()
                 if k not in self.model_param_names}
        HaloProfile.__init__(self, mass_def=mass_def, **extra)
        for m in self.model_param_names:
            setattr(self, m, known.get(m, None))
        self.cutoff = kwargs.get('cutoff', 1e3)
        self.proj_cutoff = kwargs.get('proj_cutoff', self.cutoff)


class Pressure(BaseThermodynamicProfile):
    """Hydrostatic-equilibrium total gas pressure in CGS (barye).

    dP/dr = -G M_tot(<r) rho_gas / r^2, integrated inward from r -> inf
    (a reversed cumulative sum). The default mass profile is the one-halo
    DMB: DarkMatterBaryon - TwoHalo.
    """

    def __init__(self, gas=None, darkmatterbaryon=None, **kwargs):
        self.Gas = gas if gas is not None else Gas(**kwargs)
        if darkmatterbaryon is None:
            darkmatterbaryon = DarkMatterBaryon(**kwargs) - TwoHalo(**kwargs)
        self.DarkMatterBaryon = darkmatterbaryon
        self.Gas.set_parameter('cutoff', 1000)
        self.DarkMatterBaryon.set_parameter('cutoff', 1000)
        super().__init__(**kwargs)

    def _real(self, cosmo, r, M, a):
        r_int = _grid(cosmo, 1e-6, 1000, 500)
        lnr_int = torch.log(r_int)
        dlnr = lnr_int[1] - lnr_int[0]

        rho_total = self.DarkMatterBaryon._real(cosmo, r_int, M, a)
        rho_gas = self.Gas._real(cosmo, r_int, M, a)

        M_total = 4 * math.pi * torch.cumsum(r_int**3 * rho_total * dlnr,
                                             dim=-1)
        dP_dr = -G * M_total * rho_gas / r_int**2

        # inward integral with P(inf) = 0: a reversed cumulative sum
        integ = (dP_dr * r_int).flip(-1) * dlnr
        prof = -torch.cumsum(integ, dim=-1).flip(-1)

        lnP = torch.log(prof + Pressure_at_infinity)
        d = pchip_derivatives(lnr_int, lnP)
        out = pchip_eval(torch.log(r), lnr_int, lnP, d, extrapolate=False)
        out = torch.exp(out) - Pressure_at_infinity
        out = torch.where(torch.isfinite(out), out, 0.0)

        # [Msun Mpc^-1 s^-2] -> CGS barye
        out = out * const.MSUN_G / const.MPC_CM
        return out * sigmoid_cutoff(r[None, :], self.cutoff)


class NonThermalFrac(BaseThermodynamicProfile):
    """Pandey+25 non-thermal fraction: f_nt = alpha f(z) (r/R)^gamma,
    clipped to [0, 1]. Multiply into Pressure:
    ``Pressure(**kw) * (1 - NonThermalFrac(**kw))``."""

    def __init__(self, alpha_nt, nu_nt, gamma_nt, **kwargs):
        super().__init__(**kwargs)
        self.alpha_nt = alpha_nt
        self.nu_nt = nu_nt
        self.gamma_nt = gamma_nt

    def _real(self, cosmo, r, M, a):
        z = 1 / a - 1
        R = self.mass_def.get_radius(cosmo, M, a) / a
        f_max = 6.0 ** -self.gamma_nt / self.alpha_nt
        f_z = min((1 + z) ** self.nu_nt,
                  (f_max - 1) * math.tanh(self.nu_nt * z) + 1)
        f_nt = (self.alpha_nt * f_z
                * (r[None, :] / R[:, None]) ** self.gamma_nt)
        return torch.clamp(f_nt, 0.0, 1.0)


class NonThermalFracGreen20(BaseThermodynamicProfile):
    """Green+20 fixed-parameter non-thermal fraction against r/R200m and
    peak height. No free parameters."""

    def __init__(self, concentration=None, **kwargs):
        super().__init__(**kwargs)
        self.concentration = (concentration if concentration is not None
                              else ConcentrationDiemer15(self.mass_def))

    def _real(self, cosmo, r, M, a):
        mdef_m = MassDef(200, 'matter')
        M200m = mass_translator(cosmo, M, a, self.mass_def, mdef_m,
                                self.concentration)
        # as the JAX package (and the code it re-implements): R200m from
        # the *input* mass
        R200m = mdef_m.get_radius(cosmo, M, a) / a
        x = r[None, :] / R200m[:, None]
        pa, pb, pc, pd, pe, pf = 0.495, 0.719, 1.417, -0.166, 0.265, -2.116
        nu_M = (const.DELTA_COLLAPSE / cosmo.sigmaM(M200m, a))[:, None]
        return 1 - pa * (1 + torch.exp(-((x / pb) ** pc))) \
            * (nu_M / 4.1) ** (pd / (1 + (x / pe) ** pf))


class ElectronPressure(Pressure):
    """P_e = Pth_to_Pe * P_gas."""

    def _real(self, cosmo, r, M, a):
        return Pth_to_Pe * super()._real(cosmo, r, M, a)


class GasNumberDensity(BaseThermodynamicProfile):
    """n_gas = rho_gas / (mu m_p), per cm^3."""

    def __init__(self, gas=None, mean_molecular_weight=1.15, **kwargs):
        self.Gas = gas if gas is not None else Gas(**kwargs)
        super().__init__(**kwargs)
        self.mean_molecular_weight = mean_molecular_weight

    def _real(self, cosmo, r, M, a):
        rho = self.Gas._real(cosmo, r, M, a)
        return rho / (self.mean_molecular_weight * m_p_Msun) / const.MPC_CM**3


def _ideal_gas_T(P, n):
    """T = P / (n k_B), 0 where n is 0."""
    return torch.where(n == 0, 0.0, P / torch.where(n == 0, 1.0, n) / kb_cgs)


class Temperature(BaseThermodynamicProfile):
    """Ideal-gas temperature T = P / (n k_B) in Kelvin. The input pressure
    must be the *thermal* pressure (non-thermal fraction applied)."""

    def __init__(self, pressure=None, gasnumberdensity=None, **kwargs):
        if pressure is None:
            pressure = Pressure(**kwargs) * (1 - NonThermalFrac(**kwargs))
        self.Pressure = pressure
        self.GasNumberDensity = (gasnumberdensity if gasnumberdensity
                                 is not None else GasNumberDensity(**kwargs))
        super().__init__(**kwargs)

    def _real(self, cosmo, r, M, a):
        return _ideal_gas_T(self.Pressure._real(cosmo, r, M, a),
                            self.GasNumberDensity._real(cosmo, r, M, a))

    def projected(self, cosmo, r, M, a):
        """Line-of-sight average temperature: the ratio of projected P
        and n."""
        return _ideal_gas_T(self.Pressure.projected(cosmo, r, M, a),
                            self.GasNumberDensity.projected(cosmo, r, M, a))


class ThermalSZ(BaseThermodynamicProfile):
    """Compton-y: projected pressure * a * Mpc->cm * sigma_T/(m_e c^2) *
    Pgas_to_Pe. ``real()`` returns the -99 sentinel, so the profile can
    ride through TabulatedProfile (whose 3D table is then not finite, as
    in the JAX package)."""

    def __init__(self, pressure=None, **kwargs):
        self.pressure = pressure if pressure is not None else Pressure(**kwargs)
        super().__init__(**kwargs)

    def Pgas_to_Pe(self, cosmo, r, M, a):
        return Pth_to_Pe

    def projected(self, cosmo, r, M, a):
        r_use = torch.atleast_1d(cosmo.tensor(r))
        M_use = torch.atleast_1d(cosmo.tensor(M))
        prof = self.pressure.projected(cosmo, r_use, M_use, a)
        prof = prof * a * const.MPC_CM
        prof = prof * const.SIGMA_THOMSON / (const.M_ELECTRON_G
                                             * const.C_LIGHT_CGS**2)
        prof = prof * self.Pgas_to_Pe(cosmo, r_use, M_use, a)
        if torch.as_tensor(r).dim() == 0:
            prof = prof.squeeze(-1)
        if torch.as_tensor(M).dim() == 0:
            prof = prof.squeeze(0)
        return prof

    def real(self, cosmo, r, M, a):
        r_use = torch.atleast_1d(cosmo.tensor(r))
        M_use = torch.atleast_1d(cosmo.tensor(M))
        return torch.full((M_use.numel(), r_use.numel()), -99.0,
                          dtype=cosmo.dtype, device=cosmo.device)

    def _real(self, cosmo, r, M, a):
        return math.nan


class XrayLuminosity(BaseThermodynamicProfile):
    """n^2 T (X-ray-like emissivity). Raises NotImplementedError, as the
    JAX package does: the cooling-function calibration is missing."""

    def __init__(self, temperature=None, gasnumberdensity=None, **kwargs):
        raise NotImplementedError(
            "XrayLuminosity is not calibrated (missing cooling factors); "
            "the JAX package raises here too.")
