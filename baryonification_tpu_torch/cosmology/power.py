"""Linear matter power spectrum: Eisenstein & Hu (1998) transfer function.

The port of ``baryonification_tpu.cosmology.power`` (EH98, ApJ 496, 605,
eqs. 2-24; k in 1/Mpc, no h). Scalars derived from the cosmological
parameters are Python floats; ``k`` and ``R`` are float64 tensors.
"""

import math

import torch

__all__ = ["eh98_transfer", "tophat_w", "sigma_tophat"]


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

    s = (2.0 / (3.0 * k_eq) * math.sqrt(6.0 / R_eq)
         * math.log((math.sqrt(1.0 + R_d) + math.sqrt(R_d + R_eq))
                    / (1.0 + math.sqrt(R_eq))))

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
    sq = math.sqrt(1.0 + y)
    Gy = y * (-6.0 * sq + (2.0 + 3.0 * y) * math.log((sq + 1.0) / (sq - 1.0)))
    alpha_b = 2.07 * k_eq * s * (1.0 + R_d) ** -0.75 * Gy
    beta_b = 0.5 + fb + (3.0 - 2.0 * fb) * math.sqrt((17.2 * om) ** 2 + 1.0)
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
