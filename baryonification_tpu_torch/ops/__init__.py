"""Tensor operations: FFTLog, interpolation, HEALPix geometry, the
spectra (power spectra and SHT), and the hand-written kernels
(scatter-add, Legendre recurrences)."""

from . import fftlog, healpix, interp, legendre_cuda, scatter_cuda, spectra

__all__ = ["fftlog", "healpix", "interp", "legendre_cuda", "scatter_cuda",
           "spectra"]
