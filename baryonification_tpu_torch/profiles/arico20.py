"""Arico+20 (BACCO) halo-profile family.

The port of ``baryonification_tpu.profiles.arico20``: hard-truncated
NFW, Behroozi+13-style stellar fractions, the BoundGas / EjectedGas /
ReaccretedGas decomposition with its gas-fraction bookkeeping,
ModifiedDarkMatter (eq. A10 of Arico+19, solved by a local monotone root
find), adiabatic relaxation on halo-scaled grids, polytropic pressure
(Arico+24 eq. 5), a Green20-style non-thermal fraction with a free
amplitude, and temperature.

Where the JAX package ``vmap``s a function of one halo, the port runs all
halos at once: the halo-scaled radial grids are (M, n) tensors, and the
components that the relaxation evaluates on them (DarkMatter, Stars, the
gas profiles, ModifiedDarkMatter) take ``r`` either as (n,) radii shared
by every halo or as (M, n) rows, one per halo.
"""

import math

import torch

from .. import constants as const
from ..cosmology.concentration import ConcentrationDiemer15
from ..ops.interp import pchip_derivatives, pchip_eval
from ..utils import interp_rows
from . import schneider19 as S19
from .schneider19 import sigmoid_cutoff, _grid
from .thermodynamic import G, m_p_Msun, _ideal_gas_T

__all__ = ['model_params', 'AricoProfiles',
           'DarkMatter', 'TwoHalo', 'Stars', 'Gas', 'BoundGas',
           'EjectedGas', 'ReaccretedGas', 'ModifiedDarkMatter',
           'CollisionlessMatter', 'DarkMatterOnly', 'DarkMatterBaryon',
           'DarkMatterOnlywithLSS', 'DarkMatterBaryonwithLSS',
           'Pressure', 'NonThermalFrac', 'Temperature',
           'ExtendedBoundGas', 'BoundGasDeprecated']


model_params = [
    'cdelta', 'a', 'n',                       # DM + relaxation
    'q', 'p',                                 # two-halo
    'cutoff', 'proj_cutoff',                  # numerical cutoffs
    'theta_out', 'theta_inn', 'M_inn', 'M_c', 'mu', 'beta',
    'M_r', 'beta_r', 'eta', 'theta_rg', 'sigma_rg', 'epsilon_hydro',
    'alpha_sat', 'M1_0', 'alpha_g', 'epsilon_h',   # stars
    'A_nt', 'alpha_nt',                       # pressure
    'mean_molecular_weight',
]


def _rows(r):
    """Radii as (1, n) shared by every halo, or the (M, n) rows as given."""
    return r[None, :] if r.dim() == 1 else r


def row_geomspace(lo, hi, n):
    """(M, n) geometric grids from ``lo`` (float) to each of ``hi`` (M,):
    10 ** linspace(log10), ending at ``hi`` itself as numpy's geomspace
    does. The end node is each halo's R, where the profiles' hard cuts
    (``r <= R``, ``r < R``) sit, so it must be R to the last bit: a node
    an ulp off would fall on either side of the cut by rounding (the JAX
    package's ``jnp.geomspace`` ends an ulp off R for about one halo in
    seven; ROADMAP C)."""
    step = torch.arange(n - 1, dtype=hi.dtype, device=hi.device) / (n - 1)
    l0 = math.log10(lo)
    l1 = torch.log10(hi)[:, None]
    return torch.cat([torch.pow(10.0, l0 * (1 - step) + l1 * step),
                      hi[:, None]], dim=-1)


def pchip_local_root(x, lny):
    """Zero of each row of the curve x(lny) by monotone interpolation of
    a 10-point window around its sign change.

    x : (..., N) rows; lny : (N,) shared or (..., N). Returns (...,). The
    batched form of the JAX package's function of one row (a gather of
    each row's window where it takes a dynamic slice)."""
    N = x.shape[-1]
    lny = torch.broadcast_to(lny, x.shape)
    i0 = torch.clamp(torch.argmin(x.abs(), dim=-1), 5, N - 6)
    idx = (i0 - 5)[..., None] + torch.arange(10, device=x.device)
    xw = torch.gather(x, -1, idx)
    yw = torch.gather(lny, -1, idx)
    # enforce increasing x for the monotone interpolation
    xw = xw * torch.sign(xw[..., -1:] - xw[..., :1])
    order = torch.argsort(xw, dim=-1, stable=True)
    xw, yw = torch.gather(xw, -1, order), torch.gather(yw, -1, order)
    d = pchip_derivatives(xw, yw)
    zero = torch.zeros(xw.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    return pchip_eval(zero, xw, yw, d)[..., 0]


class AricoProfiles(S19.SchneiderProfiles):
    """Family base: own parameter vocabulary (every unset parameter is
    None), gas parameter scalings and Behroozi-style star fractions."""

    model_param_names = model_params

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        for m in self.model_param_names:
            setattr(self, m, kwargs.get(m, None))
        self.cutoff = kwargs.get('cutoff', 1e3)
        self.proj_cutoff = kwargs.get('proj_cutoff', self.cutoff)

    def _get_gas_params(self, M, z):
        """beta = 3 - (M_inn/M)^mu; constant theta_out/theta_inn.
        Returns (M, 1) columns."""
        beta = 3.0 - torch.pow(self.M_inn / M, self.mu) * torch.ones_like(M)
        theta_out = self.theta_out * torch.ones_like(M)
        theta_inn = self.theta_inn * torch.ones_like(M)
        return beta[:, None], theta_out[:, None], theta_inn[:, None]

    def _get_star_frac(self, M, z, satellite=False):
        """Behroozi+13 fitting function with Kravtsov+18 values
        (eq. A16-17 of Arico+19)."""
        M1_a, M1_z = -1.793, -0.251
        eps_0, eps_a, eps_a2 = math.log10(0.023), -0.006, -0.119
        alpha_0, alpha_a = -1.779, 0.731
        delta_0, delta_a, delta_z = 4.394, 2.608, -0.043
        gamma_0, gamma_a, gamma_z = 0.547, 1.319, 0.279

        a = 1.0 / (1.0 + z)
        nu = math.exp(-4.0 * a**2)
        M1 = self.M1_0 * 10.0 ** ((M1_a * (a - 1) + M1_z * z) * nu)
        eps = 10.0 ** (eps_0 + nu * (eps_a * (a - 1)) + eps_a2 * (a - 1))
        alpha = alpha_0 + nu * (alpha_a * (a - 1))
        delta = delta_0 + nu * (delta_a * (a - 1) + delta_z * z)
        gamma = gamma_0 + nu * (gamma_a * (a - 1) + gamma_z * z)

        if satellite:
            M1 = M1 ** self.alpha_sat
            eps = eps ** self.alpha_sat
            alpha = alpha * self.alpha_sat
            delta = delta * self.alpha_sat
            gamma = gamma * self.alpha_sat

        x = torch.log10(M / M1)
        g_x = (-torch.log10(10.0 ** (alpha * x) + 1)
               + delta * torch.log10(1 + torch.exp(x)) ** gamma
               / (1 + torch.exp(10.0 ** (-x))))
        g_0 = (-math.log10(2.0)
               + delta * math.log10(2.0) ** gamma / (1 + math.e))
        return eps * (M1 / M) * 10.0 ** (g_x - g_0)

    def _gas_fractions(self, cosmo, M, z):
        """The f_hg / f_rg / f_bg / f_eg bookkeeping."""
        f_cg = self._get_star_frac(M, z)
        f_sg = self._get_star_frac(M, z, satellite=True)
        f_bar = cosmo.Omega_b / cosmo.Omega_m
        f_hg = (f_bar - f_cg - f_sg) / (1 + torch.pow(self.M_c / M,
                                                      self.beta))
        f_rg = (f_bar - f_cg - f_sg - f_hg) / (1 + torch.pow(self.M_r / M,
                                                             self.beta_r))
        f_bg = f_hg - f_rg
        f_eg = f_bar - f_cg - f_sg - f_hg
        return dict(f_cg=f_cg, f_sg=f_sg, f_bar=f_bar, f_hg=f_hg,
                    f_rg=f_rg, f_bg=f_bg, f_eg=f_eg)


def _nfw_truncated(prof_self, cosmo, r, M, a, c):
    """NFW of concentration ``c``, analytically normalised to M(<R) = M,
    cut at R (shared by the Arico and Mead dark-matter profiles)."""
    rr = _rows(r)
    R = prof_self.mass_def.get_radius(cosmo, M, a) / a
    r_s = R / c
    norm = 4 * math.pi * r_s**3 * (torch.log(1 + c) - c / (1 + c))
    rho_c = (M / norm)[:, None]
    r_s = r_s[:, None]
    kfac = sigmoid_cutoff(rr, prof_self.cutoff)
    prof = rho_c / (rr / r_s * (1 + rr / r_s) ** 2) * kfac
    return torch.where(rr <= R[:, None], prof, 0.0)


class DarkMatter(AricoProfiles):
    """NFW truncated *at R* with analytic normalization."""

    def _real(self, cosmo, r, M, a):
        c = self._concentration(cosmo, M, a)
        return _nfw_truncated(self, cosmo, r, M, a, c)


class TwoHalo(S19.TwoHalo, AricoProfiles):
    """S19 two-halo term with the Arico parameter vocabulary."""


class Stars(AricoProfiles):
    """Power-law x Gaussian: r^-alpha_g exp(-(r/2R_h)^2), normalised
    numerically over [1e-6, 5] Mpc."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.update_precision_fftlog(padding_lo_fftlog=1e-5,
                                     padding_hi_fftlog=1e5)

    def _real(self, cosmo, r, M, a):
        rr = _rows(r)
        z = 1 / a - 1
        R = self.mass_def.get_radius(cosmo, M, a) / a
        f_cga = self._get_star_frac(M, z)[:, None]
        R_h = (self.epsilon_h * R)[:, None]

        r_int = _grid(cosmo, 1e-6, 5, 500)
        shape_int = (1.0 / R_h / torch.pow(r_int, self.alpha_g)
                     * torch.exp(-((r_int / (2 * R_h)) ** 2)))
        norm = torch.trapezoid(4 * math.pi * r_int**2 * shape_int, r_int,
                               dim=-1)[:, None]
        return (f_cga * M[:, None] / R_h / torch.pow(rr, self.alpha_g)
                * torch.exp(-((rr / (2 * R_h)) ** 2)) / norm)


class BoundGas(AricoProfiles):
    """(1 + r/R_co)^-beta (1 + (r/R_ej)^2)^-2 with a per-halo
    normalization over [1e-6, R_i]. Unlike the density itself the
    normalization integral is hard-cut at R."""

    def _real(self, cosmo, r, M, a):
        rr = _rows(r)
        z = 1 / a - 1
        R = self.mass_def.get_radius(cosmo, M, a) / a
        fr = self._gas_fractions(cosmo, M, z)
        beta, theta_out, theta_inn = self._get_gas_params(M, z)
        R_co = theta_inn * R[:, None]
        R_ej = theta_out * R[:, None]

        r_int = row_geomspace(1e-6, R, 500)                  # (M, 500)
        shape = (1 + r_int / R_co) ** -beta / (1 + (r_int / R_ej) ** 2) ** 2
        shape = torch.where(r_int < R[:, None], shape, 0.0)
        norm = torch.trapezoid(4 * math.pi * r_int**2 * shape, r_int,
                               dim=-1)[:, None]

        kfac = sigmoid_cutoff(rr, self.cutoff)
        prof = (1 + rr / R_co) ** -beta / (1 + (rr / R_ej) ** 2) ** 2 * kfac
        return prof * fr['f_bg'][:, None] * M[:, None] / norm


class EjectedGas(AricoProfiles):
    """Gaussian with R_ej = eta * 0.75 * R_esc, R_esc = (sqrt(Delta)/2) R;
    needs a critical-overdensity mass definition."""

    def _real(self, cosmo, r, M, a):
        assert self.mass_def.rho_type == 'critical', (
            f"Escape radius cannot be calculated for mass_def = "
            f"{self.mass_def}. Use critical overdensity.")
        rr = _rows(r)
        z = 1 / a - 1
        R = self.mass_def.get_radius(cosmo, M, a) / a
        fr = self._gas_fractions(cosmo, M, z)
        f_eg = fr['f_eg'][:, None]

        R_esc = 0.5 * math.sqrt(self.mass_def.Delta) * R
        R_ej = (self.eta * 0.75 * R_esc)[:, None]

        kfac = sigmoid_cutoff(rr, self.cutoff)
        return (f_eg * M[:, None] / torch.pow(2 * math.pi * R_ej**2, 1.5)
                * torch.exp(-(rr / R_ej) ** 2 / 2) * kfac)


class ReaccretedGas(AricoProfiles):
    """Gaussian shell at theta_rg R of width sigma_rg R with an analytic
    erf normalization, zero beyond R."""

    def _real(self, cosmo, r, M, a):
        rr = _rows(r)
        z = 1 / a - 1
        R = self.mass_def.get_radius(cosmo, M, a) / a
        fr = self._gas_fractions(cosmo, M, z)
        R_rg = self.theta_rg * R[:, None]
        S_rg = self.sigma_rg * R[:, None]
        f_rg = fr['f_rg'][:, None]
        Rc = R[:, None]
        erf = torch.special.erf

        t1 = 2 * math.sqrt(2 * math.pi) * (
            torch.exp(-R_rg**2 / (2 * S_rg**2)) * R_rg
            - torch.exp(-((R_rg - Rc) ** 2) / (2 * S_rg**2)) * (R_rg + Rc))
        t2 = 2 * math.pi * (R_rg**2 + S_rg**2) * erf(
            R_rg / (math.sqrt(2.0) * S_rg))
        t3 = -2 * math.pi * (R_rg**2 + S_rg**2) * erf(
            (R_rg - Rc) / (math.sqrt(2.0) * S_rg))
        norm = t1 * S_rg + t2 + t3

        kfac = sigmoid_cutoff(rr, self.cutoff)
        prof = (1.0 / torch.sqrt(2 * math.pi * S_rg**2)
                * torch.exp(-(((rr - R_rg) / S_rg) ** 2) / 2))
        prof = prof * f_rg * M[:, None] / norm * kfac
        return torch.where(rr <= Rc, prof, 0.0)


class _Delegating:
    """A profile that is the sum ``myprof`` of its components, with every
    attribute not its own taken from that sum."""

    def __getattr__(self, name):
        try:
            mp = self.__dict__['myprof']
        except KeyError:
            raise AttributeError(name) from None
        return getattr(mp, name)

    def __getstate__(self):
        return self.__dict__.copy()

    def __setstate__(self, state):
        self.__dict__.update(state)

    def _real(self, cosmo, r, M, a):
        return self.myprof._real(cosmo, r, M, a)

    def real(self, cosmo, r, M, a):
        return self.myprof.real(cosmo, r, M, a)

    def projected(self, cosmo, r, M, a, n_decades=None):
        return self.myprof.projected(cosmo, r, M, a, n_decades)


class Gas(_Delegating, AricoProfiles):
    """BoundGas + EjectedGas + ReaccretedGas by profile algebra, with
    attribute delegation."""

    def __init__(self, **kwargs):
        self.myprof = (BoundGas(**kwargs) + EjectedGas(**kwargs)
                       + ReaccretedGas(**kwargs))


class ModifiedDarkMatter(AricoProfiles):
    """NFW inside r_p, (rho_GravityOnly - rho_BoundGas) outside; r_p from
    eq. A10 of Arico+19 by a local monotone root find."""

    def __init__(self, gas=None, gravityonly=None, **kwargs):
        self.Gas = gas if gas is not None else BoundGas(**kwargs)
        self.GravityOnly = (gravityonly if gravityonly is not None
                            else DarkMatter(**kwargs))
        super().__init__(**kwargs)

    def _real(self, cosmo, r, M, a):
        rr = _rows(r)
        c = self._concentration(cosmo, M, a)
        R = self.mass_def.get_radius(cosmo, M, a) / a
        r_s = (R / c)[:, None]
        fDM = 1 - cosmo.Omega_b / cosmo.Omega_m

        rp_grid = _grid(cosmo, 1e-6, 10, 500)
        # rho_GravityOnly(R) and rho_BG(R), each halo at its own R
        pGro = self.GravityOnly._real(cosmo, R[:, None], M, a)
        pBG = self.Gas._real(cosmo, R[:, None], M, a)

        dp = pGro - pBG                                      # (M, 1)
        LHS = (rp_grid * torch.pow(rp_grid + r_s, 2) * dp
               * (torch.log(1 + rp_grid / r_s) - 1 / (1 + r_s / rp_grid))
               + dp / 3 * (R[:, None] ** 3 - rp_grid**3))
        RHS = (fDM * M / (4 * math.pi))[:, None]

        rp = torch.exp(pchip_local_root(LHS - RHS,
                                        torch.log(rp_grid)))[:, None]
        rho_c = dp * (rp / r_s) * torch.pow(1 + rp / r_s, 2)

        prof = rho_c / (rr / r_s) / torch.pow(1 + rr / r_s, 2)
        prof = torch.where(rr < rp, prof, dp)
        prof = prof * sigmoid_cutoff(rr, self.cutoff)
        return torch.where(rr <= R[:, None], prof, 0.0)


class CollisionlessMatter(AricoProfiles):
    """Relaxation on each halo's own [r_min, R_i] grid, zeta normalized to
    1 at R, mass pinned to f_clm M at R. All halos at once; the
    fixed-point update runs ``max_iter`` times."""

    def __init__(self, gas=None, stars=None, darkmatter=None, max_iter=10,
                 reltol=1e-2, r_min_int=1e-8, r_max_int=1e1, r_steps=5000,
                 **kwargs):
        self.Gas = gas if gas is not None else Gas(**kwargs)
        self.Stars = stars if stars is not None else Stars(**kwargs)
        self.DarkMatter = (darkmatter if darkmatter is not None
                           else ModifiedDarkMatter(**kwargs))
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
        rr = _rows(r)
        z = 1 / a - 1
        R = self.mass_def.get_radius(cosmo, M, a) / a
        f_sg = self._get_star_frac(M, z, satellite=True)
        fc = (1 - cosmo.Omega_b / cosmo.Omega_m + f_sg)[:, None]
        a_rel, n_rel = self.a, self.n

        r_int = row_geomspace(self.r_min_int, R, self.r_steps)   # (M, n)
        lnr_int = torch.log(r_int)
        dlnr = lnr_int[:, 1:2] - lnr_int[:, :1]

        rho_i = self.DarkMatter._real(cosmo, r_int, M, a)
        rho_cga = self.Stars._real(cosmo, r_int, M, a)
        rho_gas = self.Gas._real(cosmo, r_int, M, a)

        M_i = 4 * math.pi * torch.cumsum(r_int**3 * rho_i * dlnr, dim=-1)
        M_cga = 4 * math.pi * torch.cumsum(r_int**3 * rho_cga * dlnr, dim=-1)
        M_gas = 4 * math.pi * torch.cumsum(r_int**3 * rho_gas * dlnr, dim=-1)

        lnM_nfw = torch.log(M_i)
        lnM_cga = torch.log(M_cga)
        lnM_gas = torch.log(M_gas)
        d_nfw = pchip_derivatives(lnr_int, lnM_nfw)
        d_cga = pchip_derivatives(lnr_int, lnM_cga)
        d_gas = pchip_derivatives(lnr_int, lnM_gas)

        def rd(lnq, y, d):
            v = pchip_eval(lnq, lnr_int, y, d, extrapolate=False)
            return torch.where(torch.isfinite(v), torch.exp(v),
                               torch.exp(y[:, -1:]))

        zeta = torch.ones_like(r_int)
        for _ in range(self.max_iter):
            lnrf = lnr_int + torch.log(zeta)
            M_f = (fc * M_i + rd(lnrf, lnM_cga, d_cga)
                   + rd(lnrf, lnM_gas, d_gas))
            znew = 1 + a_rel * (torch.pow(M_i / M_f, n_rel) - 1)
            # normalize so zeta(R) = 1
            zeta = znew / interp_rows(R[:, None], r_int, znew)

        lnM_clm = torch.log(fc) + pchip_eval(lnr_int - torch.log(zeta),
                                             lnr_int, lnM_nfw, d_nfw)
        # pin M_clm(R) = f_clm * M
        lnM_clm = lnM_clm + (torch.log(fc * M[:, None])
                             - interp_rows(torch.log(R)[:, None], lnr_int,
                                           lnM_clm))

        d_clm = pchip_derivatives(lnr_int, lnM_clm)
        log_der = pchip_eval(lnr_int, lnr_int, lnM_clm, d_clm, deriv=1)
        rho = (log_der * torch.exp(lnM_clm) / r_int
               / (4 * math.pi * r_int**2))
        d_rho = pchip_derivatives(lnr_int, rho)
        out = pchip_eval(torch.log(rr), lnr_int, rho, d_rho,
                         extrapolate=False)
        out = torch.where(torch.isnan(out), 0.0, out)
        out = out * sigmoid_cutoff(rr, self.cutoff)
        return torch.where(rr <= R[:, None], out, 0.0)


class DarkMatterOnly(S19.DarkMatterOnly, AricoProfiles):
    """DarkMatter with the two-halo term zeroed."""

    def __init__(self, darkmatter=None, **kwargs):
        self.DarkMatter = (darkmatter if darkmatter is not None
                           else DarkMatter(**kwargs))
        self.TwoHalo = TwoHalo(**kwargs) * 0
        AricoProfiles.__init__(self, **kwargs)


class DarkMatterBaryon(S19.DarkMatterBaryon, AricoProfiles):
    """CLM + Stars + Gas (renormalized), no two-halo term."""

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
        AricoProfiles.__init__(self, **kwargs)


class DarkMatterOnlywithLSS(S19.DarkMatterOnly, AricoProfiles):
    """DarkMatterOnly with the two-halo term kept."""

    def __init__(self, darkmatter=None, twohalo=None, **kwargs):
        self.DarkMatter = (darkmatter if darkmatter is not None
                           else DarkMatter(**kwargs))
        self.TwoHalo = twohalo if twohalo is not None else TwoHalo(**kwargs)
        AricoProfiles.__init__(self, **kwargs)


class DarkMatterBaryonwithLSS(S19.DarkMatterBaryon, AricoProfiles):
    """DarkMatterBaryon with the two-halo term kept."""

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
        AricoProfiles.__init__(self, **kwargs)


class Pressure(AricoProfiles):
    """Polytropic pressure P = P0 rho_BG^Geff in CGS, with Geff from the
    concentration and P0 from eq. 5 of Arico+24."""

    def __init__(self, gas=None, **kwargs):
        self.Gas = gas if gas is not None else BoundGas(**kwargs)
        super().__init__(**kwargs)

    def _real(self, cosmo, r, M, a):
        c = self._concentration(cosmo, M, a)[:, None]
        R = self.mass_def.get_radius(cosmo, M, a) / a
        r_s = R[:, None] / c
        norm = 4 * math.pi * r_s**3 * (torch.log(1 + c) - c / (1 + c))
        rhoc = M[:, None] / norm
        xp = c * self.theta_out
        Geff = 1 + (((1 + xp) * torch.log(1 + xp) - xp)
                    / ((1 + 3 * xp) * torch.log(1 + xp)))

        rho0 = self.Gas._real(cosmo, torch.zeros_like(M[:1]), M, a)
        P0 = (4 * math.pi * G * (rhoc * r_s**2)
              / torch.pow(rho0, Geff - 1) * (1 - 1 / Geff))
        P0 = P0 * const.MSUN_G / const.MPC_CM  # -> CGS

        rhoBG = self.Gas._real(cosmo, r, M, a)
        prof = P0 * torch.pow(rhoBG, Geff)
        return prof * sigmoid_cutoff(_rows(r), self.cutoff)


class NonThermalFrac(AricoProfiles):
    """Green+20 non-thermal fraction with a free amplitude
    A_nt (1+z)^alpha_nt, the peak height at the true scale factor (as in
    the JAX package)."""

    def __init__(self, concentration=None, **kwargs):
        super().__init__(**kwargs)
        self.concentration = (concentration if concentration is not None
                              else ConcentrationDiemer15(self.mass_def))

    def _real(self, cosmo, r, M, a):
        from ..cosmology.massdef import MassDef, mass_translator
        z = 1 / a - 1
        mdef_m = MassDef(200, 'matter')
        M200m = mass_translator(cosmo, M, a, self.mass_def, mdef_m,
                                self.concentration)
        R200m = mdef_m.get_radius(cosmo, M, a) / a
        x = _rows(r) / R200m[:, None]
        pb, pc, pd, pe, pf = 0.719, 1.417, -0.166, 0.265, -2.116
        amp = self.A_nt * (1 + z) ** self.alpha_nt
        nu_M = (const.DELTA_COLLAPSE / cosmo.sigmaM(M200m, a))[:, None]
        return 1 - amp * (1 + torch.exp(-((x / pb) ** pc))) \
            * (nu_M / 4.1) ** (pd / (1 + (x / pe) ** pf))


class Temperature(AricoProfiles):
    """Ideal-gas temperature from the polytropic (thermal) pressure and
    the BoundGas number density."""

    def __init__(self, pressure=None, gas=None, **kwargs):
        if pressure is None:
            pressure = Pressure(**kwargs) * (1 - NonThermalFrac(**kwargs))
        self.Pressure = pressure
        self.Gas = gas if gas is not None else BoundGas(**kwargs)
        super().__init__(**kwargs)

    def _n_gas(self, rho):
        return rho / (self.mean_molecular_weight * m_p_Msun) / const.MPC_CM**3

    def _real(self, cosmo, r, M, a):
        return _ideal_gas_T(self.Pressure._real(cosmo, r, M, a),
                            self._n_gas(self.Gas._real(cosmo, r, M, a)))

    def projected(self, cosmo, r, M, a):
        return _ideal_gas_T(self.Pressure.projected(cosmo, r, M, a),
                            self._n_gas(self.Gas.projected(cosmo, r, M, a)))


class ExtendedBoundGas(AricoProfiles):
    """BoundGas matched onto an NFW tail beyond R_out with the continuity
    factor y1."""

    def _real(self, cosmo, r, M, a):
        rr = _rows(r)
        z = 1 / a - 1
        R = self.mass_def.get_radius(cosmo, M, a) / a
        fr = self._gas_fractions(cosmo, M, z)
        beta, theta_out, theta_inn = self._get_gas_params(M, z)
        R_inn = theta_inn * R[:, None]
        R_out = theta_out * R[:, None]

        c = self._concentration(cosmo, M, a)
        r_s = (R / c)[:, None]
        x = rr / r_s
        y1 = (torch.pow(1 + R_out / R_inn, -beta) / 4 * (R_out / r_s)
              * torch.pow(1 + R_out / r_s, 2))

        r_int = _grid(cosmo, 1e-6, 10, 500)
        shape = ((1 + r_int / R_inn) ** -beta
                 / (1 + (r_int / R_out) ** 2) ** 2)
        shape = torch.where(r_int[None, :] < R[:, None], shape, 0.0)
        norm = torch.trapezoid(4 * math.pi * r_int**2 * shape, r_int,
                               dim=-1)[:, None]

        v = rr / R_out
        prof = (1 + rr / R_inn) ** -beta / (1 + v**2) ** 2
        nfw = y1 / x / torch.pow(1 + x, 2)
        prof = torch.where(v <= 1, prof, nfw) / norm
        prof = prof * fr['f_bg'][:, None] * M[:, None]
        return prof * sigmoid_cutoff(rr, self.cutoff)


class BoundGasDeprecated(AricoProfiles):
    """The original Arico+20 two-regime bound gas: Komatsu-Seljak-like
    inside R/eps_hydro, NFW-like outside, cut at R."""

    def _real(self, cosmo, r, M, a):
        rr = _rows(r)
        z = 1 / a - 1
        R = self.mass_def.get_radius(cosmo, M, a) / a
        f_cg = self._get_star_frac(M, z)
        f_bar = cosmo.Omega_b / cosmo.Omega_m
        f_bg = ((f_bar - f_cg)
                / (1 + torch.pow(self.M_c / M, self.beta)))[:, None]

        c = self._concentration(cosmo, M, a)
        r_s = (R / c)[:, None]
        eps = self.epsilon_hydro
        e5 = c[:, None] / eps
        Geff = ((1 + 3 * c / eps) * torch.log(1 + c / eps)
                / ((1 + c / eps) * torch.log(1 + c / eps) - c / eps))[:, None]
        y1 = torch.pow(torch.log(1 + e5) / e5, Geff) * (e5 * (1 + e5) ** 2)

        r_int = _grid(cosmo, 1e-6, 10, 500)
        x_i = r_int / r_s
        u_i = torch.pow(torch.log(1 + x_i) / x_i, Geff)
        v_i = y1 * torch.pow(1 + x_i, -2) / x_i
        y_i = torch.where(r_int[None, :] < R[:, None] / eps, u_i, v_i)
        y_i = torch.where(r_int[None, :] > R[:, None], 0.0, y_i)
        norm = torch.trapezoid(4 * math.pi * r_int**2 * y_i, r_int,
                               dim=-1)[:, None]

        x = rr / r_s
        u = torch.pow(torch.log(1 + x) / x, Geff)
        v = y1 * torch.pow(1 + x, -2) / x
        prof = torch.where(rr < R[:, None] / eps, u, v)
        prof = torch.where(rr > R[:, None], 0.0, prof)
        prof = f_bg * M[:, None] * prof / norm
        return prof * sigmoid_cutoff(rr, self.cutoff)
