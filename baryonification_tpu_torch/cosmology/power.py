"""Matter power spectra: the Eisenstein & Hu (1998) transfer function and
halofit.

The port of ``baryonification_tpu.cosmology.power`` (EH98, ApJ 496, 605,
eqs. 2-24; halofit, Takahashi+ 2012, ApJ 761, 152, eqs. A1-A13; k in
1/Mpc, no h). Scalars derived from the cosmological parameters are Python
floats, or 0-dim tensors where the parameters are (``cosmology_device``,
whose gradients flow through them); ``k`` and ``R`` are float64 tensors.
"""

import math

import torch

from ..utils import interp

__all__ = ["eh98_transfer", "tophat_w", "sigma_tophat", "halofit_pk"]


def _sqrt(x):
    return torch.sqrt(x) if torch.is_tensor(x) else math.sqrt(x)


def _log(x):
    return torch.log(x) if torch.is_tensor(x) else math.log(x)


def eh98_transfer(k, Omega_m, Omega_b, h, T_CMB=2.725):
    """EH98 transfer function T(k) with baryon acoustic oscillations.

    k : wavenumber tensor in 1/Mpc. Returns T(k), dimensionless, T->1 as
    k->0.
    """
    theta = T_CMB / 2.7
    om = Omega_m * h * h
    ob = Omega_b * h * h
    fb = Omega_b / Omega_m
    fc = (Omega_m - Omega_b) / Omega_m

    z_eq = 2.50e4 * om / theta**4
    k_eq = 7.46e-2 * om / theta**2  # 1/Mpc

    b1 = 0.313 * om**-0.419 * (1.0 + 0.607 * om**0.674)
    b2 = 0.238 * om**0.223
    z_d = 1291.0 * om**0.251 / (1.0 + 0.659 * om**0.828) * (1.0 + b1 * ob**b2)

    R_d = 31.5 * ob / theta**4 / (z_d / 1.0e3)
    R_eq = 31.5 * ob / theta**4 / (z_eq / 1.0e3)

    s = (2.0 / (3.0 * k_eq) * _sqrt(6.0 / R_eq)
         * _log((_sqrt(1.0 + R_d) + _sqrt(R_d + R_eq))
                / (1.0 + _sqrt(R_eq))))

    k_silk = 1.6 * ob**0.52 * om**0.73 * (1.0 + (10.4 * om) ** -0.95)

    q = k / (13.41 * k_eq)

    a1 = (46.9 * om) ** 0.670 * (1.0 + (32.1 * om) ** -0.532)
    a2 = (12.0 * om) ** 0.424 * (1.0 + (45.0 * om) ** -0.582)
    alpha_c = a1 ** (-fb) * a2 ** (-(fb**3))

    bb1 = 0.944 / (1.0 + (458.0 * om) ** -0.708)
    bb2 = (0.395 * om) ** -0.0266
    beta_c = 1.0 / (1.0 + bb1 * (fc**bb2 - 1.0))

    def T0(q, alpha, beta):
        C = 14.2 / alpha + 386.0 / (1.0 + 69.9 * q**1.08)
        L = torch.log(math.e + 1.8 * beta * q)
        return L / (L + C * q * q)

    f = 1.0 / (1.0 + (k * s / 5.4) ** 4)
    Tc = f * T0(q, 1.0, beta_c) + (1.0 - f) * T0(q, alpha_c, beta_c)

    y = (1.0 + z_eq) / (1.0 + z_d)
    sq = _sqrt(1.0 + y)
    Gy = y * (-6.0 * sq + (2.0 + 3.0 * y) * _log((sq + 1.0) / (sq - 1.0)))
    alpha_b = 2.07 * k_eq * s * (1.0 + R_d) ** -0.75 * Gy
    beta_b = 0.5 + fb + (3.0 - 2.0 * fb) * _sqrt((17.2 * om) ** 2 + 1.0)
    beta_node = 8.41 * om**0.435
    s_tilde = s / (1.0 + (beta_node / (k * s)) ** 3) ** (1.0 / 3.0)

    x = k * s_tilde
    big = x > 1e-8
    sinc = torch.where(big, torch.sin(x) / torch.where(big, x, 1.0), 1.0)
    Tb = (T0(q, 1.0, 1.0) / (1.0 + (k * s / 5.2) ** 2)
          + alpha_b / (1.0 + (beta_b / (k * s)) ** 3)
          * torch.exp(-((k / k_silk) ** 1.4))) * sinc

    return fb * Tb + fc * Tc


def tophat_w(x):
    """Fourier transform of a 3D spherical tophat, W(x)=3(sin x - x cos x)/x^3."""
    small = x < 1e-3
    xs = torch.where(small, 1.0, x)
    w = 3.0 * (torch.sin(xs) - xs * torch.cos(xs)) / xs**3
    # series: 1 - x^2/10
    return torch.where(small, 1.0 - x * x / 10.0, w)


def sigma_tophat(k, pk, R):
    """sigma(R) = sqrt( 1/(2 pi^2) int dlnk k^3 P(k) W(kR)^2 ).

    k, pk : (Nk,) log-spaced samples; R : (...,) tensor or float.
    """
    R = torch.as_tensor(R, dtype=k.dtype, device=k.device)
    x = R[..., None] * k
    integ = k**3 * pk * tophat_w(x) ** 2
    var = torch.trapezoid(integ, torch.log(k), dim=-1) / (2.0 * math.pi**2)
    return torch.sqrt(var)


def halofit_pk(k_eval, k_grid, pk_lin, Omega_m_z, Omega_de_z, w=-1.0):
    """Nonlinear matter power spectrum: halofit, Takahashi+ (2012).

    k_eval : (..,) wavenumbers [1/Mpc] at which to return P_NL.
    k_grid, pk_lin : log-spaced linear P(k) samples AT the target redshift
        (already scaled by D(a)^2); the grid must span the nonlinear scale
        (sigma_G = 1) and the k_eval range.
    Omega_m_z, Omega_de_z : matter / dark-energy density parameters at the
        target redshift (floats or 0-d tensors).
    w : dark-energy equation of state (constant w0).
    """
    k = k_grid
    dev, dt = k.device, k.dtype
    lnk = torch.log(k)
    d2_lin_grid = k**3 * pk_lin / (2.0 * math.pi**2)

    # Gaussian-window variance sigma_G^2(R) on a log-R grid; the nonlinear
    # scale R_sigma solves sigma_G(R_sigma) = 1 (eq. A4), the effective
    # index and curvature are the log-derivatives there (eq. A5)
    lnR = torch.linspace(math.log(1e-3), math.log(1e2), 256, dtype=dt,
                         device=dev)
    R = torch.exp(lnR)
    gauss = torch.exp(-(R[:, None] * k[None, :]) ** 2)
    ln_s2 = torch.log(torch.trapezoid(d2_lin_grid * gauss, lnk, dim=-1))
    dlnR = lnR[1] - lnR[0]
    d1 = torch.gradient(ln_s2)[0] / dlnR
    d2 = torch.gradient(d1)[0] / dlnR
    # ln sigma^2 decreases monotonically with R: invert by interpolation
    # on the increasing -ln sigma^2
    lnR_sig = interp(torch.zeros((), dtype=dt, device=dev), -ln_s2, lnR)
    neff = -3.0 - interp(lnR_sig, lnR, d1)
    C = -interp(lnR_sig, lnR, d2)
    k_sigma = torch.exp(-lnR_sig)

    n = neff
    ow = Omega_de_z * (1.0 + w)
    a_n = 10.0 ** (1.5222 + 2.8553 * n + 2.3706 * n**2 + 0.9903 * n**3
                   + 0.2250 * n**4 - 0.6038 * C + 0.1749 * ow)
    b_n = 10.0 ** (-0.5642 + 0.5864 * n + 0.5716 * n**2 - 1.5474 * C
                   + 0.2279 * ow)
    c_n = 10.0 ** (0.3698 + 2.0404 * n + 0.8161 * n**2 + 0.5869 * C)
    gamma_n = 0.1971 - 0.0843 * n + 0.8460 * C
    alpha_n = torch.abs(6.0835 + 1.3373 * n - 0.1959 * n**2 - 5.5274 * C)
    beta_n = (2.0379 - 0.7354 * n + 0.3157 * n**2 + 1.2490 * n**3
              + 0.3980 * n**4 - 0.1682 * C)
    nu_n = 10.0 ** (5.2105 + 3.6902 * n)

    f1 = Omega_m_z ** -0.0307
    f2 = Omega_m_z ** -0.0585
    f3 = Omega_m_z ** 0.0743

    d2_lin = torch.exp(interp(torch.log(k_eval), lnk,
                              torch.log(d2_lin_grid)))
    y = k_eval / k_sigma
    fy = y / 4.0 + y**2 / 8.0

    d2_q = (d2_lin * ((1.0 + d2_lin) ** beta_n / (1.0 + alpha_n * d2_lin))
            * torch.exp(-fy))
    d2_hp = (a_n * y ** (3.0 * f1)
             / (1.0 + b_n * y**f2 + (c_n * f3 * y) ** (3.0 - gamma_n)))
    d2_h = d2_hp / (1.0 + nu_n / y**2)     # mu_n = 0 in the 2012 revision

    return (d2_q + d2_h) * 2.0 * math.pi**2 / k_eval**3
