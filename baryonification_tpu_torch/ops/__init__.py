"""Tensor operations: FFTLog, interpolation, HEALPix geometry and the
hand-written scatter-add kernel."""

from . import fftlog, healpix, interp, scatter_cuda

__all__ = ["fftlog", "healpix", "interp", "scatter_cuda"]
