"""Tensor operations: FFTLog, interpolation, HEALPix geometry, the
spectra (power spectra and SHT), the CIC and HEALPix redeposits, and the
hand-written kernels (scatter-add, Legendre recurrences, the cell-major
shell and grid passes, the shell regrid)."""

from . import (cellmajor_cuda, fftlog, grid_pass_cuda, healpix, interp,
               legendre_cuda, regrid_cuda, scatter, scatter_cuda, spectra)

__all__ = ["cellmajor_cuda", "fftlog", "grid_pass_cuda", "healpix", "interp",
           "legendre_cuda", "regrid_cuda", "scatter", "scatter_cuda",
           "spectra"]
