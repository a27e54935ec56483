"""FFTLog Hankel transforms in PyTorch.

The port of ``baryonification_tpu.ops.fftlog``: the Talman/Hamilton FFTLog
(power-law decomposition by an FFT in ln r, the analytic Mellin transform
of the Bessel kernel, an FFT back on the reflected log grid), in CCL's
``_fftlog_transform(r, f, dim, ell, plaw)`` conventions:

  dim=3, ell=0:  T3[f](k) = 1/(2 pi^2) * int dr r^2 j_0(kr) f(r)
  dim=2, ell=0:  T2[f](k) = 1/(2 pi)   * int dr r   J_0(kr) f(r)

Inputs are real float64 tensors; the FFTs run in complex128 on the
tensors' device.
"""

import math

import torch

__all__ = ["loggamma", "fftlog_transform", "hankel_transform"]


# Lanczos approximation (g=7, n=9) for the log-gamma function of a complex
# argument: torch.lgamma takes real arguments only.
_LANCZOS_G = 7.0
_LANCZOS_COEFS = (
    0.99999999999980993,
    676.5203681218851,
    -1259.1392167224028,
    771.32342877765313,
    -176.61502916214059,
    12.507343278686905,
    -0.13857109526572012,
    9.9843695780195716e-6,
    1.5056327351493116e-7,
)


def _loggamma_positive(z):
    """log Gamma(z) for Re(z) > 0 (complex), via Lanczos."""
    z = z - 1.0
    x = torch.full_like(z, _LANCZOS_COEFS[0])
    for i in range(1, len(_LANCZOS_COEFS)):
        x = x + _LANCZOS_COEFS[i] / (z + i)
    t = z + _LANCZOS_G + 0.5
    return (0.5 * math.log(2.0 * math.pi) + (z + 0.5) * torch.log(t) - t
            + torch.log(x))


def loggamma(z):
    """log Gamma(z) for a complex128 tensor, reflected for Re(z) < 0.5."""
    z = z.to(torch.complex128)
    reflect = z.real < 0.5
    z_safe = torch.where(reflect, 1.0 - z, z)
    lg = _loggamma_positive(z_safe)
    # reflection: Gamma(z) Gamma(1-z) = pi / sin(pi z)
    refl = torch.log(math.pi / torch.sin(math.pi * z))
    return torch.where(reflect, refl - lg, lg)


def _mellin_bessel(mu, s):
    """T_mu(s) = int_0^inf t^(s+1) J_mu(t) dt = 2^(s+1) G(1+(mu+s)/2)/G((mu-s)/2)."""
    num = loggamma(1.0 + 0.5 * (mu + s))
    den = loggamma(0.5 * (mu - s))
    return torch.exp((s + 1.0) * math.log(2.0) + num - den)


def hankel_transform(x, f, mu, q=0.0):
    """F(y) = int_0^inf f(x) J_mu(x y) x dx on a reflected log grid.

    x : (N,) log-spaced, strictly increasing float64 samples.
    f : (..., N) samples of f(x); leading axes are batch axes.
    Returns (y, F): the (N,) output grid with pivot y_c = 1/x_c and the
    (..., N) transform on it.
    """
    N = x.shape[-1]
    dlnx = torch.log(x[1] / x[0])
    n0 = 0.5 * (N - 1)
    lnx0 = 0.5 * (torch.log(x[0]) + torch.log(x[-1]))  # grid-centre pivot

    # output grid: y_n = y0 * exp((n - n0) dlnx), y0 = 1/x0
    n = torch.arange(N, dtype=x.dtype, device=x.device)
    lny = -lnx0 + (n - n0) * dlnx
    y = torch.exp(lny)

    # f(x) = sum_m c_m (x/x0)^(q + i eta_m); the grid is centred at x0, so
    # c_m = fft(a)_m / N * e^{+i 2pi m n0 / N}
    xf = torch.exp(torch.log(x) - lnx0)
    a = f * xf ** (-q)
    c = torch.fft.fft(a.to(torch.complex128), dim=-1) / N
    m = torch.fft.fftfreq(N, d=1.0 / N, dtype=x.dtype, device=x.device)
    eta = 2.0 * math.pi * m / (N * dlnx)
    s = torch.complex(torch.full_like(eta, q), eta)

    T = _mellin_bessel(mu, s)
    # the decomposition and output re-centring phases combine to
    # e^{+i 2pi m (2 n0)/N}
    phase = torch.polar(torch.ones_like(m), 2.0 * math.pi * m * (2.0 * n0) / N)
    d = c * T * phase
    # sum_m d_m e^{-i 2pi m n/N} = conj(ifft(conj(d))) * N
    ssum = torch.conj(torch.fft.ifft(torch.conj(d), dim=-1)) * N
    F = ssum.real * y ** (-2.0) * torch.exp(-q * (n - n0) * dlnx)
    return y, F


def fftlog_transform(r, f, dim, ell, plaw=0.0):
    """CCL-convention FFTLog transform (see module docstring).

    dim=3: T3[f](k) = 4 pi/(2 pi)^3 int r^2 j_ell(kr) f dr
    dim=2: T2[f](k) = 2 pi/(2 pi)^2 int r J_ell(kr) f dr

    Returns (k, F) with F having the same leading axes as f.
    """
    if dim == 3:
        # j_ell(x) = sqrt(pi/(2x)) J_{ell+1/2}(x)
        mu = ell + 0.5
        k, H = hankel_transform(r, f * torch.sqrt(r), mu, q=plaw + 0.5)
        F = (1.0 / (2.0 * math.pi ** 2)) * math.sqrt(math.pi / 2.0) * H \
            / torch.sqrt(k)
    elif dim == 2:
        mu = float(ell)
        k, H = hankel_transform(r, f, mu, q=plaw)
        F = H / (2.0 * math.pi)
    else:
        raise ValueError(f"dim must be 2 or 3, got {dim}")
    return k, F
