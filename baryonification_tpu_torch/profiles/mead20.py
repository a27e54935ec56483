"""Mead+20 (HMx-calibrated) halo-profile family.

The port of ``baryonification_tpu.profiles.mead20``: Gaussian-in-log10M
stellar fractions with a central/satellite split, Duffy08-concentration
NFW, Komatsu-Seljak-like bound gas, ejected gas with the Schneider &
Teyssier escape-radius equation solved by a local monotone root find, a
feedback-modified-concentration collisionless matter (no iteration),
analytic virial temperature, and the two-phase (bound + warm-ejected)
pressure; with the three BAHAMAS-calibrated parameter dicts of Mead+20
Table 2. The per-halo functions the JAX package ``vmap``s run on all
halos at once.
"""

import math

import torch

from .. import constants as const
from ..cosmology.concentration import (ConcentrationConstant,
                                       ConcentrationDuffy08)
from . import schneider19 as S19
from . import arico20 as A20
from .arico20 import pchip_local_root, row_geomspace, _rows
from .schneider19 import sigmoid_cutoff, _grid
from .thermodynamic import G, kb_cgs, m_p_Msun

__all__ = ['model_params', 'MeadProfiles', 'DarkMatter', 'TwoHalo',
           'Stars', 'BoundGas', 'EjectedGas', 'Gas', 'CollisionlessMatter',
           'DarkMatterOnly', 'DarkMatterBaryon', 'DarkMatterOnlywithLSS',
           'DarkMatterBaryonwithLSS', 'Temperature', 'Pressure',
           'Params_TAGN_7p6', 'Params_TAGN_7p8', 'Params_TAGN_8p0']


model_params = [
    'cdelta', 'eps1', 'nu_eps1', 'eps2',      # DM / feedback-concentration
    'cutoff', 'proj_cutoff',
    'p', 'q',                                 # two-halo
    'M_0', 'beta', 'Gamma', 'nu_Gamma', 'eta_b',   # gas
    'A_star', 'nu_A_star', 'M_star', 'nu_M_star', 'sigma_star',
    'epsilon_h', 'eta',                       # stars
    'T_w', 'nu_T_w',                          # ejected-gas temperature
    'mean_molecular_weight',
]


class MeadProfiles(A20.AricoProfiles):
    """Family base: the Mead vocabulary and stellar fractions."""

    model_param_names = model_params

    def _concentration(self, cosmo, M, a):
        if self.cdelta is None:
            return ConcentrationDuffy08(self.mass_def)(cosmo, M, a)
        return ConcentrationConstant(self.cdelta, self.mass_def)(cosmo, M, a)

    def _get_fstar(self, M, a):
        """Gaussian-in-log10M stellar fraction with z evolution and a
        central/satellite split by (M/M*)^eta."""
        z = 1 / a - 1
        Astr = self.A_star + self.nu_A_star * z
        Mstr = self.M_star * math.exp(z * self.nu_M_star)
        f_str = Astr * torch.exp(-(torch.log10(M / Mstr) / self.sigma_star)
                                 ** 2 / 2)
        f_str = torch.where(M > Mstr, torch.clamp(f_str, min=Astr / 3),
                            f_str)
        f_cen = f_str * torch.where(M < Mstr, 1.0,
                                    torch.pow(M / Mstr, self.eta))
        f_sat = f_str * torch.where(M < Mstr, 0.0,
                                    1 - torch.pow(M / Mstr, self.eta))
        return f_str, f_cen, f_sat

    def _f_bnd(self, cosmo, M, a):
        f_str, _, _ = self._get_fstar(M, a)
        f_bar = cosmo.Omega_b / cosmo.Omega_m
        x = torch.pow(self.M_0 / M, self.beta)
        return (f_bar - f_str) * x / (1 + x)


class DarkMatter(MeadProfiles):
    """NFW hard-truncated at R, Duffy08 c(M)."""

    def _real(self, cosmo, r, M, a):
        c = self._concentration(cosmo, M, a)
        return A20._nfw_truncated(self, cosmo, r, M, a, c)


class TwoHalo(S19.TwoHalo, MeadProfiles):
    """S19 two-halo term with the Mead vocabulary."""


class Stars(MeadProfiles):
    """Central-galaxy Gaussian (the S19 form with f_cen)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.update_precision_fftlog(padding_lo_fftlog=1e-5,
                                     padding_hi_fftlog=1e5)

    def _real(self, cosmo, r, M, a):
        rr = _rows(r)
        R = self.mass_def.get_radius(cosmo, M, a) / a
        _, f_cen, _ = self._get_fstar(M, a)
        R_h = (self.epsilon_h * R)[:, None]
        return (f_cen[:, None] * M[:, None] / (4 * math.pi**1.5 * R_h)
                / rr**2 * torch.exp(-((rr / (2 * R_h)) ** 2)))


class BoundGas(MeadProfiles):
    """Komatsu-Seljak-like (ln(1+x)/x)^(1/(Gamma-1)), normalised per halo
    over [1e-6, R_i], hard cut at R."""

    def _real(self, cosmo, r, M, a):
        rr = _rows(r)
        z = 1 / a - 1
        c = self._concentration(cosmo, M, a)
        R = self.mass_def.get_radius(cosmo, M, a) / a
        r_s = (R / c)[:, None]
        Geff = self.Gamma + self.nu_Gamma * z
        f_bnd = self._f_bnd(cosmo, M, a)[:, None]

        r_int = row_geomspace(1e-6, R, 500)                  # (M, 500)
        x = r_int / r_s
        shape = torch.pow(torch.log(1 + x) / x, 1 / (Geff - 1))
        norm = torch.trapezoid(4 * math.pi * r_int**2 * shape, r_int,
                               dim=-1)[:, None]

        x = rr / r_s
        kfac = sigmoid_cutoff(rr, self.cutoff)
        prof = torch.pow(torch.log(1 + x) / x, 1 / (Geff - 1)) * kfac
        prof = torch.where(rr <= R[:, None], prof, 0.0)
        return prof * f_bnd * M[:, None] / norm


class EjectedGas(MeadProfiles):
    """Gaussian ejected gas with R_ej solved from the Schneider & Teyssier
    15 / Omori+23 erf equation."""

    def _real(self, cosmo, r, M, a):
        rr = _rows(r)
        R = self.mass_def.get_radius(cosmo, M, a) / a
        f_str, _, _ = self._get_fstar(M, a)
        f_bar = cosmo.Omega_b / cosmo.Omega_m
        f_bnd = self._f_bnd(cosmo, M, a)
        f_ej = ((f_bar - f_str) - f_bnd)[:, None]

        R_esc = 0.5 * math.sqrt(200.0) * R[:, None]
        rgrid = _grid(cosmo, 1e-2, 100, 100)
        t1 = 1 - torch.special.erf(self.eta_b * R_esc / math.sqrt(2.0)
                                   / rgrid)
        t2 = (math.sqrt(2 / math.pi) * self.eta_b * R_esc / rgrid
              * torch.exp(-((self.eta_b * R_esc / rgrid) ** 2) / 2))
        diff = t1 + t2 - f_ej / f_bar

        R_ej = torch.exp(pchip_local_root(diff, torch.log(rgrid)))[:, None]

        kfac = sigmoid_cutoff(rr, self.cutoff)
        return (f_ej * M[:, None] / torch.pow(2 * math.pi * R_ej**2, 1.5)
                * torch.exp(-(rr / R_ej) ** 2 / 2) * kfac)


class Gas(A20._Delegating, MeadProfiles):
    """BoundGas + EjectedGas, with attribute delegation."""

    def __init__(self, **kwargs):
        self.myprof = BoundGas(**kwargs) + EjectedGas(**kwargs)


class CollisionlessMatter(MeadProfiles):
    """NFW with the feedback-modified concentration
    c -> c (1 + eps1 + (eps2 - eps1) f_bnd/f_bar) and the density
    rescaled by (1 - f_bar + f_sat); no iteration."""

    def _modify_concentration(self, cosmo, c, M, a):
        z = 1 / a - 1
        f_bar = cosmo.Omega_b / cosmo.Omega_m
        x = torch.pow(self.M_0 / M, self.beta)
        f_bnd = f_bar * x / (1 + x)
        eps1 = self.eps1 + z * self.nu_eps1
        return c * (1 + eps1 + (self.eps2 - eps1) * f_bnd / f_bar)

    def _real(self, cosmo, r, M, a):
        rr = _rows(r)
        c = self._concentration(cosmo, M, a)
        c = self._modify_concentration(cosmo, c, M, a)
        R = self.mass_def.get_radius(cosmo, M, a) / a
        r_s = R / c
        norm = 4 * math.pi * r_s**3 * (torch.log(1 + c) - c / (1 + c))
        rho_c = M / norm
        _, _, f_sat = self._get_fstar(M, a)
        f_bar = cosmo.Omega_b / cosmo.Omega_m
        rho_c = (rho_c * (1 - f_bar + f_sat))[:, None]
        r_s = r_s[:, None]

        kfac = sigmoid_cutoff(rr, self.cutoff)
        prof = rho_c / (rr / r_s * (1 + rr / r_s) ** 2) * kfac
        return torch.where(rr <= R[:, None], prof, 0.0)


class DarkMatterOnly(DarkMatter):
    """Just the NFW profile: no two-halo term."""


class DarkMatterBaryon(S19.DarkMatterBaryon, MeadProfiles):
    """CLM + Stars + Gas renormalized to the DMO mass, no two-halo term."""

    def __init__(self, gas=None, stars=None, collisionlessmatter=None,
                 darkmatter=None, **kwargs):
        self.Gas = gas if gas is not None else Gas(**kwargs)
        self.Stars = stars if stars is not None else Stars(**kwargs)
        self.TwoHalo = TwoHalo(**kwargs) * 0
        self.DarkMatter = (darkmatter if darkmatter is not None
                           else DarkMatter(**kwargs))
        self.CollisionlessMatter = (
            collisionlessmatter if collisionlessmatter is not None
            else CollisionlessMatter(**kwargs))
        MeadProfiles.__init__(self, **kwargs)


class DarkMatterOnlywithLSS(S19.DarkMatterOnly, MeadProfiles):
    """NFW + two-halo term."""

    def __init__(self, darkmatter=None, twohalo=None, **kwargs):
        self.DarkMatter = (darkmatter if darkmatter is not None
                           else DarkMatter(**kwargs))
        self.TwoHalo = twohalo if twohalo is not None else TwoHalo(**kwargs)
        MeadProfiles.__init__(self, **kwargs)


class DarkMatterBaryonwithLSS(S19.DarkMatterBaryon, MeadProfiles):
    """DarkMatterBaryon + two-halo term."""

    def __init__(self, gas=None, stars=None, collisionlessmatter=None,
                 darkmatter=None, twohalo=None, **kwargs):
        self.Gas = gas if gas is not None else Gas(**kwargs)
        self.Stars = stars if stars is not None else Stars(**kwargs)
        self.TwoHalo = twohalo if twohalo is not None else TwoHalo(**kwargs)
        self.DarkMatter = (darkmatter if darkmatter is not None
                           else DarkMatter(**kwargs))
        self.CollisionlessMatter = (
            collisionlessmatter if collisionlessmatter is not None
            else CollisionlessMatter(**kwargs))
        MeadProfiles.__init__(self, **kwargs)


class Temperature(MeadProfiles):
    """Analytic virial temperature T0 ln(1+x)/x in Kelvin; ``projected``
    divides the line-of-sight integral by 2 r_max to give an average
    temperature."""

    def _real(self, cosmo, r, M, a):
        c = self._concentration(cosmo, M, a)
        R = self.mass_def.get_radius(cosmo, M, a) / a
        r_s = (R / c)[:, None]
        E0 = (G * M * m_p_Msun * self.mean_molecular_weight / (a * R)
              * const.MSUN_G * const.MPC_CM**2)
        T0 = E0 / (1.5 * kb_cgs)
        x = _rows(r) / r_s
        return T0[:, None] * torch.log(1 + x) / x

    def projected(self, cosmo, r, M, a, n_decades=None):
        r_max = self.padding_hi_proj * float(torch.as_tensor(r).max())
        if self.proj_cutoff is not None:
            r_max = self.proj_cutoff
        return super().projected(cosmo, r, M, a, n_decades) / (2 * r_max)


class Pressure(MeadProfiles):
    """Two-phase pressure P = n_bnd T_bnd k_B + n_ej T_w(z) k_B in CGS."""

    def __init__(self, boundgas=None, ejectedgas=None, temperature=None,
                 **kwargs):
        self.BoundGas = (boundgas if boundgas is not None
                         else BoundGas(**kwargs))
        self.EjectedGas = (ejectedgas if ejectedgas is not None
                           else EjectedGas(**kwargs))
        self.Temperature = (temperature if temperature is not None
                            else Temperature(**kwargs))
        super().__init__(**kwargs)

    def _n_gas(self, rho):
        return rho / (self.mean_molecular_weight * m_p_Msun) / const.MPC_CM**3

    def _real(self, cosmo, r, M, a):
        z = 1 / a - 1
        T = self.Temperature._real(cosmo, r, M, a)
        n = self._n_gas(self.BoundGas._real(cosmo, r, M, a))
        P1 = T * n * kb_cgs
        T_w = self.T_w * math.exp(self.nu_T_w * z)
        n2 = self._n_gas(self.EjectedGas._real(cosmo, r, M, a))
        P2 = T_w * n2 * kb_cgs
        return P1 + P2


# BAHAMAS-calibrated parameter dicts (Mead+20 Table 2)
Params_TAGN_7p6 = {
    'A_star': 0.0346, 'nu_A_star': -0.0092, 'M_star': 10 ** 12.5506,
    'nu_M_star': -0.4615, 'eta': -0.4970, 'eps1': 0.4021,
    'nu_eps1': 0.0435, 'Gamma': 1.2763, 'nu_Gamma': -0.0554,
    'M_0': 10 ** 13.0978, 'T_w': 10 ** 6.6762, 'nu_T_w': -0.5566,
    'eps2': 0, 'mean_molecular_weight': 0.59, 'eta_b': 0.5,
    'sigma_star': 1.2, 'beta': 0.6, 'epsilon_h': 0.015, 'p': 0.3,
    'q': 0.707}

Params_TAGN_7p8 = {
    'A_star': 0.0342, 'nu_A_star': -0.0105, 'M_star': 10 ** 12.3715,
    'nu_M_star': 0.0149, 'eta': -0.4052, 'eps1': 0.1236,
    'nu_eps1': -0.0187, 'Gamma': 1.2956, 'nu_Gamma': -0.0937,
    'M_0': 10 ** 13.4854, 'T_w': 10 ** 6.6545, 'nu_T_w': -0.3652,
    'eps2': 0, 'mean_molecular_weight': 0.59, 'eta_b': 0.5,
    'sigma_star': 1.2, 'beta': 0.6, 'epsilon_h': 0.015, 'p': 0.3,
    'q': 0.707}

Params_TAGN_8p0 = {
    'A_star': 0.0321, 'nu_A_star': -0.0094, 'M_star': 10 ** 12.3032,
    'nu_M_star': -0.0817, 'eta': -0.3443, 'eps1': -0.1158,
    'nu_eps1': 0.1408, 'Gamma': 1.2861, 'nu_Gamma': -0.1382,
    'M_0': 10 ** 14.1254, 'T_w': 10 ** 6.6615, 'nu_T_w': -0.0617,
    'eps2': 0, 'mean_molecular_weight': 0.59, 'eta_b': 0.5,
    'sigma_star': 1.2, 'beta': 0.6, 'epsilon_h': 0.015, 'p': 0.3,
    'q': 0.707}
