"""Pixel window functions and window-convolved profiles.

The port of ``baryonification_tpu.pixels``: ``ConvolvedProfile`` runs a
profile through an FFTLog round trip with the pixel window applied in
Fourier (or harmonic) space; ``GridPixelApprox`` approximates a square or
cubic pixel by an area- or volume-equivalent tophat beam; ``HealPixel``
approximates the HEALPix pixel window by a Gaussian beam; ``NoPix`` is
the identity window. Profiles compute on the cosmology's device in
float64.
"""

import math

import numpy as np
import torch

from .ops.fftlog import fftlog_transform
from .ops.interp import pchip_derivatives, pchip_eval
from .utils import geomspace

__all__ = ['ConvolvedProfile', 'GridPixelApprox', 'HealPixel', 'NoPix']


def _nside2resol(NSIDE):
    """HEALPix mean pixel spacing in radians: sqrt(4 pi / (12 NSIDE^2))
    (healpy.nside2resol)."""
    return np.sqrt(4.0 * np.pi / (12.0 * NSIDE * NSIDE))


class ConvolvedProfile:
    """Wrap (Profile, Pixel) and expose the same real/projected API with
    the pixel window applied.

    real:       rho -> T3 -> x W(k) -> T3 -> x (2 pi)^3
    projected:  Sigma -> T2 -> x W(k or ell) -> T2 -> x (2 pi)^2
    with r below pixel_size/5 clipped to suppress ringing, and the
    harmonic branch mapping r -> theta = r / D_A (comoving). Any other
    attribute is the wrapped profile's.
    """

    def __init__(self, Profile, Pixel):
        self.Profile = Profile
        self.Pixel = Pixel
        self.fft_par = Profile.precision_fftlog
        self.isHarmonic = Pixel.isHarmonic

    def __getattr__(self, name):
        # only reached for names not found the normal way; the guard keeps
        # a half-built instance (unpickling) from recursing
        try:
            prof = self.__dict__['Profile']
        except KeyError:
            raise AttributeError(name) from None
        return getattr(prof, name)

    def __getstate__(self):
        return self.__dict__.copy()

    def __setstate__(self, state):
        self.__dict__.update(state)

    def _fft_grid(self, cosmo, r):
        """The FFTLog grid: its ends and size on the host, in the JAX
        package's float arithmetic, so both packages take the same n."""
        par = self.fft_par
        r_min = min(float(r.min()) * par['padding_lo_fftlog'], 1e-8)
        r_max = max(float(r.max()) * par['padding_hi_fftlog'], 1e3)
        n = int(par['n_per_decade'] * np.log10(r_max / r_min))
        return geomspace(r_min, r_max, n, device=cosmo.device,
                         dtype=cosmo.dtype)

    @staticmethod
    def _interp_back(r_out, prof, r_query):
        """Monotone cubic of prof(log r_out) at log r_query, row by row;
        0 outside the range."""
        lnro = torch.log(r_out)
        d = pchip_derivatives(lnro, prof)
        q = pchip_eval(torch.log(r_query), lnro, prof, d, extrapolate=False)
        return torch.where(torch.isnan(q), 0.0, q)

    def real(self, cosmo, r, M, a):
        r = torch.atleast_1d(cosmo.tensor(r))
        r_fft = self._fft_grid(cosmo, r)
        prof = self.Profile.real(cosmo, r_fft, M, a)

        plaw = self.fft_par['plaw_fourier']
        k_out, Pk = fftlog_transform(r_fft, prof, 3, 0, plaw)
        r_out, prof = fftlog_transform(k_out, Pk * self.Pixel.real(k_out),
                                       3, 0, plaw + 1)

        r_q = torch.clamp(r, min=self.Pixel.size / 5)
        return self._interp_back(r_out, prof, r_q) * (2 * math.pi) ** 3

    def projected(self, cosmo, r, M, a):
        r = torch.atleast_1d(cosmo.tensor(r))
        if self.isHarmonic:
            assert a < 1, ("You cannot set a = 1, z = 0 when computing "
                           "harmonic sky projections")
            D_A = cosmo.comoving_angular_distance(a)

        r_fft = self._fft_grid(cosmo, r)
        prof = self.Profile.projected(cosmo, r_fft, M, a)
        if self.isHarmonic:
            r_fft = r_fft / D_A

        plaw = self.fft_par['plaw_fourier'] + 1
        k_out, Pk = fftlog_transform(r_fft, prof, 2, 0, plaw)
        r_out, prof = fftlog_transform(k_out,
                                       Pk * self.Pixel.projected(k_out),
                                       2, 0, plaw)

        if self.isHarmonic:
            r_out = r_out * D_A
            r_q = torch.maximum(r, self.Pixel.size / 5 * D_A)
        else:
            r_q = torch.clamp(r, min=self.Pixel.size / 5)
        return self._interp_back(r_out, prof, r_q) * (2 * math.pi) ** 2


class GridPixelApprox:
    """Square/cubic pixel approximated by a circular/spherical tophat beam
    3 j1(kd)/(kd), d = 2R, with the volume-equivalent R for ``real`` and
    the area-equivalent R for ``projected``."""

    isHarmonic = False

    def __init__(self, size):
        self.size = size

    def beam(self, k, R):
        kr = k * (2.0 * R)
        small = kr < 1e-2
        kr_safe = torch.where(small, 1.0, kr)
        # 3 j1(x)/x = 3 (sin x - x cos x)/x^3; the series below 1e-2
        # avoids the cancellation at small x
        exact = 3.0 * (torch.sin(kr_safe)
                       - kr_safe * torch.cos(kr_safe)) / kr_safe**3
        series = 1.0 - kr * kr / 10.0
        return torch.where(small, series, exact)

    def real(self, k):
        R = np.cbrt(self.size**3 / (4.0 / 3.0 * np.pi))
        return self.beam(k, R)

    def projected(self, k):
        R = np.sqrt(self.size**2 / np.pi)
        return self.beam(k, R)


class HealPixel:
    """HEALPix pixel window as a Gaussian beam
    exp(-k(k+1) sigma^2 / 2), sigma = resol/sqrt(8 ln 2)/sqrt(2).
    ``real()`` is 0: the window has no 3D meaning."""

    isHarmonic = True

    def __init__(self, NSIDE):
        self.NSIDE = NSIDE
        self.size = _nside2resol(NSIDE)

    def real(self, k):
        return torch.zeros_like(k)

    def projected(self, k):
        sig = self.size / np.sqrt(8 * np.log(2)) / np.sqrt(2)
        return torch.exp(-k * (1 + k) / 2 * sig**2)


class NoPix:
    """Identity window (for tests)."""

    isHarmonic = False
    size = 0.0

    def real(self, k):
        return torch.ones_like(k)

    def projected(self, k):
        return torch.ones_like(k)
