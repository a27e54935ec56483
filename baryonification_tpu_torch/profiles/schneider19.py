"""Schneider+19 halo-profile family (DMO/DMB decomposition).

The port of ``baryonification_tpu.profiles.schneider19``: truncated-NFW
dark matter, the Sheth-Tormen-biased two-halo term, exponential stars,
GNFW gas, shocked gas, adiabatically relaxed collisionless matter, and the
DarkMatterOnly / DarkMatterBaryon combiners. Every component evaluates as
an (M, r) tensor; the relaxation's fixed-point update runs a fixed
``max_iter`` times over all halos at once.
"""

import math

import torch

from ..constants import DELTA_COLLAPSE
from ..cosmology.concentration import (ConcentrationConstant,
                                       ConcentrationDiemer15)
from ..ops.interp import pchip_derivatives, pchip_eval
from ..utils import geomspace, interp_rows
from .base import HaloProfile

__all__ = ["model_params", "SchneiderProfiles", "DarkMatter", "TwoHalo",
           "Stars", "Gas", "ShockedGas", "CollisionlessMatter",
           "DarkMatterOnly", "DarkMatterBaryon"]


model_params = [
    'cdelta', 'epsilon', 'a', 'n',                      # DM profile params
    'q', 'p',                                           # relaxation params
    'cutoff', 'proj_cutoff',                            # numerical cutoffs
    'theta_ej', 'theta_co', 'M_c', 'gamma', 'delta',    # gas GNFW shape
    'mu_theta_ej', 'mu_theta_co', 'mu_beta', 'mu_gamma', 'mu_delta',
    'M_theta_ej', 'M_theta_co', 'M_gamma', 'M_delta',
    'nu_theta_ej', 'nu_theta_co', 'nu_M_c', 'nu_gamma', 'nu_delta',
    'zeta_theta_ej', 'zeta_theta_co', 'zeta_M_c', 'zeta_gamma', 'zeta_delta',
    'A', 'M1', 'eta', 'eta_delta', 'tau', 'tau_delta', 'epsilon_h',  # stars
    'alpha_nt', 'nu_nt', 'gamma_nt', 'mean_molecular_weight',
]


def sigmoid_cutoff(r, cutoff):
    """kfac = 1/(1 + e^{2(r - cutoff)}) with an overflow guard that
    substitutes the argument before exp and the value after, so no inf
    enters the graph."""
    arg = r - cutoff
    big = arg > 30.0
    val = 1.0 / (1.0 + torch.exp(2.0 * torch.where(big, 30.0, arg)))
    return torch.where(big, 0.0, val)


def _grid(cosmo, lo, hi, n):
    return geomspace(lo, hi, n, device=cosmo.device, dtype=cosmo.dtype)


class SchneiderProfiles(HaloProfile):
    """Family base: parameter vocabulary + gas-parameter scalings."""

    model_param_names = model_params

    def _concentration(self, cosmo, M, a):
        if self.cdelta is None:
            return ConcentrationDiemer15(self.mass_def)(cosmo, M, a)
        return ConcentrationConstant(self.cdelta, self.mass_def)(cosmo, M, a)

    def _get_gas_params(self, M, z):
        """Mass/redshift/concentration power-law scalings of the GNFW gas
        parameters. Returns (M, 1) columns."""
        cdelta = 1.0 if self.cdelta is None else self.cdelta
        M_c = self.M_c * (1 + z) ** self.nu_M_c * cdelta ** self.zeta_M_c
        beta = 3 * (M / M_c) ** self.mu_beta / (1 + (M / M_c) ** self.mu_beta)
        theta_ej = (self.theta_ej * (M / self.M_theta_ej) ** self.mu_theta_ej
                    * (1 + z) ** self.nu_theta_ej * cdelta ** self.zeta_theta_ej)
        theta_co = (self.theta_co * (M / self.M_theta_co) ** self.mu_theta_co
                    * (1 + z) ** self.nu_theta_co * cdelta ** self.zeta_theta_co)
        delta = (self.delta * (M / self.M_delta) ** self.mu_delta
                 * (1 + z) ** self.nu_delta * cdelta ** self.zeta_delta)
        gamma = (self.gamma * (M / self.M_gamma) ** self.mu_gamma
                 * (1 + z) ** self.nu_gamma * cdelta ** self.zeta_gamma)
        return (beta[:, None], theta_ej[:, None], theta_co[:, None],
                delta[:, None], gamma[:, None])

    def _star_fractions(self, M):
        """f_star and f_cga double power laws."""
        eta_cga = self.eta + self.eta_delta
        tau_cga = self.tau + self.tau_delta
        f_star = 2 * self.A * ((M / self.M1) ** self.tau
                               + (M / self.M1) ** self.eta) ** -1
        f_cga = 2 * self.A * ((M / self.M1) ** tau_cga
                              + (M / self.M1) ** eta_cga) ** -1
        return f_star, f_cga


class DarkMatter(SchneiderProfiles):
    """Truncated NFW: rho_c / [(r/rs)(1+r/rs)^2 (1+(r/rt)^2)^2], rt = eps R,
    numerically normalized so M(<R) = M."""

    def _real(self, cosmo, r, M, a):
        c = self._concentration(cosmo, M, a)
        R = self.mass_def.get_radius(cosmo, M, a) / a  # comoving Mpc
        r_s = (R / c)[:, None]
        r_t = (R * self.epsilon)[:, None]

        # numerical normalization on a fixed log grid
        r_int = _grid(cosmo, 1e-6, 1e3, 500)
        shape_int = (1.0 / (r_int / r_s * (1 + r_int / r_s) ** 2)
                     * 1.0 / (1 + (r_int / r_t) ** 2) ** 2)
        dM = 4 * math.pi * r_int ** 3 * shape_int  # integrand in dlnr
        lnr_int = torch.log(r_int)
        Mcum = torch.cat([
            torch.zeros(shape_int.shape[:-1] + (1,), dtype=dM.dtype,
                        device=dM.device),
            torch.cumsum(0.5 * (dM[..., 1:] + dM[..., :-1])
                         * torch.diff(lnr_int), dim=-1)], dim=-1)
        norm = interp_rows(torch.log(R)[:, None], lnr_int, Mcum)[:, 0]
        rho_c = (M / norm)[:, None]

        kfac = sigmoid_cutoff(r[None, :], self.cutoff)
        return (rho_c / (r / r_s * (1 + r / r_s) ** 2)
                / (1 + (r / r_t) ** 2) ** 2 * kfac)


class TwoHalo(SchneiderProfiles):
    """(1 + b(M) xi_mm(r)) rho_m with Sheth-Tormen bias."""

    def _real(self, cosmo, r, M, a):
        if self.xi_mm is None:
            xi = cosmo.xi_mm(r, a)
        else:
            xi = self.xi_mm(r, a)
        delta_c = DELTA_COLLAPSE / cosmo.growth_factor(a)
        nu_M = delta_c / cosmo.sigmaM(M, a)
        bias = (1 + (self.q * nu_M**2 - 1) / delta_c
                + 2 * self.p / delta_c / (1 + (self.q * nu_M**2) ** self.p))
        prof = ((1 + bias[:, None] * xi[None, :])
                * cosmo.rho_x(a, "matter", is_comoving=True))
        return prof * sigmoid_cutoff(r[None, :], self.cutoff)


class Stars(SchneiderProfiles):
    """Exponential central-galaxy profile
    f_cga M_tot/(4 pi^{3/2} R_h r^2) exp(-r^2/4R_h^2)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        # prevents ringing in convolution paths
        self.update_precision_fftlog(padding_lo_fftlog=1e-5,
                                     padding_hi_fftlog=1e5)

    def _real(self, cosmo, r, M, a):
        R = self.mass_def.get_radius(cosmo, M, a) / a
        _, f_cga = self._star_fractions(M)
        R_h = (self.epsilon_h * R)[:, None]
        f_cga = f_cga[:, None]

        r_int = _grid(cosmo, 1e-6, 1e3, 500)
        DM = DarkMatter(**self.model_params)
        DM.cutoff = 1e3
        rho = DM._real(cosmo, r_int, M, a)
        M_tot = torch.trapezoid(4 * math.pi * r_int**2 * rho, r_int,
                                dim=-1)[:, None]

        kfac = sigmoid_cutoff(r[None, :], self.cutoff)
        return (f_cga * M_tot / (4 * math.pi ** 1.5 * R_h) / r**2
                * torch.exp(-((r / (2 * R_h)) ** 2)) * kfac)


class Gas(SchneiderProfiles):
    """GNFW gas: f_gas M_tot/N / (1+r/R_co)^beta / (1+(r/R_ej)^gamma)^
    ((delta-beta)/gamma)."""

    def _real(self, cosmo, r, M, a):
        z = 1 / a - 1
        R = self.mass_def.get_radius(cosmo, M, a) / a

        f_star, _ = self._star_fractions(M)
        f_bar = cosmo.Omega_b / cosmo.Omega_m
        f_gas = (f_bar - f_star)[:, None]

        beta, theta_ej, theta_co, delta, gamma = self._get_gas_params(M, z)
        R_co = theta_co * R[:, None]
        R_ej = theta_ej * R[:, None]

        r_int = _grid(cosmo, 1e-6, 1e3, 500)
        u_i = r_int / R_co
        v_i = r_int / R_ej
        shape_int = ((1 + u_i) ** -beta
                     / (1 + v_i**gamma) ** ((delta - beta) / gamma))
        norm = torch.trapezoid(4 * math.pi * r_int**2 * shape_int, r_int,
                               dim=-1)[:, None]

        DM = DarkMatter(**self.model_params)
        DM.cutoff = 1e3
        rho = DM._real(cosmo, r_int, M, a)
        M_tot = torch.trapezoid(4 * math.pi * r_int**2 * rho, r_int,
                                dim=-1)[:, None]

        u = r / R_co
        v = r / R_ej
        kfac = sigmoid_cutoff(r[None, :], self.cutoff)
        prof = ((1 + u) ** -beta / (1 + v**gamma) ** ((delta - beta) / gamma)
                * kfac)
        return prof * f_gas * M_tot / norm


class ShockedGas(Gas):
    """Gas suppressed by a logistic shock factor down to 0.25 (the
    Rankine-Hugoniot maximum density drop)."""

    def __init__(self, epsilon_shock, width_shock, **kwargs):
        self.epsilon_shock = epsilon_shock
        self.width_shock = width_shock
        super().__init__(**kwargs)

    def _real(self, cosmo, r, M, a):
        R = self.mass_def.get_radius(cosmo, M, a) / a
        rho_gas = super()._real(cosmo, r, M, a)
        g_arg = (torch.log(r)[None, :]
                 - torch.log(self.epsilon_shock * R)[:, None]) \
            / self.width_shock
        # the overflow guard of sigmoid_cutoff: an exact 0.25 floor beyond
        # the shock, no inf in the graph
        big = g_arg > 1e2
        factor = ((1 - 0.25) / (1 + torch.exp(torch.where(big, 1e2, g_arg)))
                  + 0.25)
        return rho_gas * torch.where(big, 0.25, factor)


class CollisionlessMatter(SchneiderProfiles):
    """Adiabatic relaxation of the collisionless component: cumulative
    masses on a log grid, monotone (pchip) log-log mass interpolants, a
    fixed-point zeta update iterated ``max_iter`` times over all halos at
    once, and the density from the log-derivative of the relaxed mass
    profile.
    """

    def __init__(self, gas=None, stars=None, darkmatter=None, max_iter=10,
                 reltol=1e-2, r_min_int=1e-8, r_max_int=1e5, r_steps=5000,
                 **kwargs):
        self.Gas = gas if gas is not None else Gas(**kwargs)
        self.Stars = stars if stars is not None else Stars(**kwargs)
        self.DarkMatter = (darkmatter if darkmatter is not None
                           else DarkMatter(**kwargs))
        # no artificial cutoffs during relaxation
        self.Gas.set_parameter('cutoff', 1000)
        self.Stars.set_parameter('cutoff', 1000)
        self.DarkMatter.set_parameter('cutoff', 1000)

        self.max_iter = max_iter
        self.reltol = reltol
        self.r_min_int = r_min_int
        self.r_max_int = r_max_int
        self.r_steps = r_steps
        super().__init__(**kwargs)

    def _real(self, cosmo, r, M, a):
        r_int = _grid(cosmo, self.r_min_int, self.r_max_int, self.r_steps)
        lnr_int = torch.log(r_int)

        f_star, f_cga = self._star_fractions(M)
        f_sga = (f_star - f_cga)[:, None]
        f_clm = 1 - cosmo.Omega_b / cosmo.Omega_m + f_sga      # (M, 1)

        rho_i = self.DarkMatter._real(cosmo, r_int, M, a)
        rho_cga = self.Stars._real(cosmo, r_int, M, a)
        rho_gas = self.Gas._real(cosmo, r_int, M, a)

        dlnr = lnr_int[1] - lnr_int[0]
        M_i = 4 * math.pi * torch.cumsum(r_int**3 * rho_i * dlnr, dim=-1)
        M_cga = 4 * math.pi * torch.cumsum(r_int**3 * rho_cga * dlnr, dim=-1)
        M_gas = 4 * math.pi * torch.cumsum(r_int**3 * rho_gas * dlnr, dim=-1)

        ln_M_i = torch.log(M_i)
        ln_cga_t, ln_gas_t = torch.log(M_cga), torch.log(M_gas)
        d_nfw = pchip_derivatives(lnr_int, ln_M_i)
        d_cga = pchip_derivatives(lnr_int, ln_cga_t)
        d_gas = pchip_derivatives(lnr_int, ln_gas_t)

        a_rel, n_rel = self.a, self.n
        zeta = torch.ones_like(M_i)
        for _ in range(self.max_iter):
            lnrf = lnr_int + torch.log(zeta)
            # a cubic-Hermite extrapolation beyond the top node can
            # exceed 709 (exp = inf); clamp the log-mass instead
            ln_cga = torch.clamp(pchip_eval(lnrf, lnr_int, ln_cga_t, d_cga),
                                 max=700.0)
            ln_gas = torch.clamp(pchip_eval(lnrf, lnr_int, ln_gas_t, d_gas),
                                 max=700.0)
            Mf = f_clm * M_i + torch.exp(ln_cga) + torch.exp(ln_gas)
            zeta = a_rel * ((M_i / Mf) ** n_rel - 1) + 1

        # M_clm(r) = f_clm * M_nfw(r / zeta(r)); density from the
        # log-derivative of a monotone interpolant of ln M_clm(ln r)
        ln_M_clm = torch.log(f_clm) + pchip_eval(lnr_int - torch.log(zeta),
                                                 lnr_int, ln_M_i, d_nfw)
        d_clm = pchip_derivatives(lnr_int, ln_M_clm)
        lnr_q = torch.log(r)
        log_der = pchip_eval(lnr_q, lnr_int, ln_M_clm, d_clm, deriv=1)
        lnM_q = pchip_eval(lnr_q, lnr_int, ln_M_clm, d_clm, extrapolate=False)
        lin_der = log_der * torch.exp(lnM_q) / r
        prof = lin_der / (4 * math.pi * r**2)

        kfac = sigmoid_cutoff(r[None, :], self.cutoff)
        return torch.where(torch.isnan(prof), 0.0, prof) * kfac


class DarkMatterOnly(SchneiderProfiles):
    """NFW one-halo + two-halo."""

    def __init__(self, darkmatter=None, twohalo=None, **kwargs):
        self.DarkMatter = (darkmatter if darkmatter is not None
                           else DarkMatter(**kwargs))
        self.TwoHalo = twohalo if twohalo is not None else TwoHalo(**kwargs)
        super().__init__(**kwargs)

    def _real(self, cosmo, r, M, a):
        return (self.DarkMatter._real(cosmo, r, M, a)
                + self.TwoHalo._real(cosmo, r, M, a))


class DarkMatterBaryon(SchneiderProfiles):
    """(CLM + Stars + Gas) * M_DMO/M_DMB + TwoHalo, with the one-halo mass
    matched to DMO at large radii."""

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
        super().__init__(**kwargs)

    def _real(self, cosmo, r, M, a):
        r_int = _grid(cosmo, 1e-5, 100, 500)

        rho = self.DarkMatter._real(cosmo, r_int, M, a)
        M_tot = torch.trapezoid(4 * math.pi * r_int**2 * rho, r_int, dim=-1)

        rho = (self.CollisionlessMatter._real(cosmo, r_int, M, a)
               + self.Stars._real(cosmo, r_int, M, a)
               + self.Gas._real(cosmo, r_int, M, a))
        M_tot_dmb = torch.trapezoid(4 * math.pi * r_int**2 * rho, r_int,
                                    dim=-1)

        factor = (M_tot / M_tot_dmb)[:, None]
        return (self.CollisionlessMatter._real(cosmo, r, M, a) * factor
                + self.Stars._real(cosmo, r, M, a) * factor
                + self.Gas._real(cosmo, r, M, a) * factor
                + self.TwoHalo._real(cosmo, r, M, a))
