"""Halo-model analysis: mass function, profile Fourier transforms, and the
baryonic power-spectrum suppression prediction.

The port of ``baryonification_tpu.analysis``. Baryonifying an N-body box
changes only the one-halo term of the halos it moves, so the suppression
P_baryonified(k) / P_DMO(k) is predicted by

    S(k) = 1 + [P_1h^DMB(k; M > M_cut) - P_1h^DMO(k; M > M_cut)]
               / (P_2h(k) + P_1h^DMO(k; all M))

with P_1h(k) = int dlnM dn/dlnM |rho_hat(k|M)|^2 / rho_m^2 and
P_2h = P_lin. ``examples/10_delta_pk_snapshot.py`` holds this prediction
against the 15 scraped Schneider+19 Fig. 2 curves.

Everything computes in float64 on the cosmology's device.
"""

import math

import torch

from .constants import DELTA_COLLAPSE
from .ops.fftlog import fftlog_transform
from .utils import geomspace, interp

__all__ = ["sheth_tormen_dndlnM", "profile_uk", "pk_suppression"]


def sheth_tormen_dndlnM(cosmo, M, a=1.0, A=0.3222, a_st=0.707, p_st=0.3):
    """Sheth-Tormen halo mass function dn/dlnM [1/Mpc^3 comoving] at the
    (increasing) masses ``M``.

    nu = delta_c / sigma(M, a); f(nu) = A sqrt(2 a/pi) (1 + (a nu^2)^-p)
    nu exp(-a nu^2 / 2); dn/dlnM = rho_m/M f(nu) |dln sigma/dlnM|, the
    derivative by finite differences over ``M`` (one-sided at the ends).
    """
    M = cosmo.tensor(M)
    lnM = torch.log(M)
    sig = cosmo.sigmaM(M, a)
    dlnsig = torch.gradient(torch.log(sig))[0] / torch.gradient(lnM)[0]
    nu = DELTA_COLLAPSE / sig
    fnu = (A * math.sqrt(2.0 * a_st / math.pi)
           * (1.0 + (a_st * nu**2) ** -p_st)
           * nu * torch.exp(-a_st * nu**2 / 2.0))
    rho_m = cosmo.rho_x(a, "matter", is_comoving=True)
    return rho_m / M * fnu * torch.abs(dlnsig)


def profile_uk(profile, cosmo, M, a, k_eval, r_min=1e-3, r_max=60.0,
               n_r=1024):
    """rho_hat(k|M): 3D Fourier transform of a halo profile [Msun], shape
    (n_M, n_k).

    FFTLog of rho(r) (clipped non-negative: combined profiles can ring
    slightly negative at truncation), read at ``k_eval``. Below
    k ~ 2/r_max the FFTLog cannot resolve the transform, so there the
    moment expansion rho_hat(k) = M0 - k^2/6 int 4 pi rho r^4 dr is used.
    """
    dev = cosmo.device
    r = geomspace(r_min, r_max, n_r, device=dev)
    M = torch.atleast_1d(cosmo.tensor(M))
    rho = torch.clamp(torch.atleast_2d(profile.real(cosmo, r, M, a)),
                      min=0.0)
    kf, F = fftlog_transform(r, rho, 3, 0, plaw=-2.0)
    F = F * (2.0 * math.pi) ** 3
    k_eval = cosmo.tensor(k_eval)

    M0 = torch.trapezoid(4.0 * math.pi * rho * r**2, r, dim=-1)
    M2 = torch.trapezoid(4.0 * math.pi * rho * r**4, r, dim=-1)
    small = k_eval * r_max < 2.0
    fft_branch = interp(torch.log(k_eval), torch.log(kf), F)   # (n_M, n_k)
    taylor = M0[:, None] - k_eval**2 / 6.0 * M2[:, None]
    return torch.where(small, taylor, fft_branch)


def pk_suppression(dmo_profile, dmb_profile, cosmo, k, a=1.0,
                   M_cut=10**12.8, M_min=1e11, M_max=4e15,
                   n_M_lo=20, n_M_hi=40, uk_kwargs=None):
    """Predicted P_baryonified(k) / P_DMO(k) of an N-body box whose halos
    above ``M_cut`` (the halo catalog's mass floor) are baryonified:
    those halos swap their DMO one-halo term for the DMB one (displacing
    DMO by d(r) gives the DMB profile by construction), the others keep
    theirs. ``k`` in comoving 1/Mpc.
    """
    uk_kwargs = uk_kwargs or {}
    dev = cosmo.device
    k = cosmo.tensor(k)
    M_lo = geomspace(M_min, M_cut, n_M_lo, device=dev)
    M_hi = geomspace(M_cut, M_max, n_M_hi, device=dev)
    rho_m = cosmo.rho_x(a, "matter", is_comoving=True)

    dn_lo = sheth_tormen_dndlnM(cosmo, M_lo, a)
    dn_hi = sheth_tormen_dndlnM(cosmo, M_hi, a)

    uD_lo = profile_uk(dmo_profile, cosmo, M_lo, a, k, **uk_kwargs)
    uD_hi = profile_uk(dmo_profile, cosmo, M_hi, a, k, **uk_kwargs)
    uB_hi = profile_uk(dmb_profile, cosmo, M_hi, a, k, **uk_kwargs)

    def p1h(dn, u2, lnM):
        return torch.trapezoid(dn[:, None] / rho_m**2 * u2, lnM, dim=0)

    P1h_D = (p1h(dn_lo, uD_lo**2, torch.log(M_lo))
             + p1h(dn_hi, uD_hi**2, torch.log(M_hi)))
    dP1h = p1h(dn_hi, uB_hi**2 - uD_hi**2, torch.log(M_hi))
    P2h = cosmo.P_lin(k, a)
    return 1.0 + dP1h / (P2h + P1h_D)
