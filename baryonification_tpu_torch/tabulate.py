"""Tabulated halo profiles on the device.

The port of ``baryonification_tpu.tabulate.TabulatedProfile``: the real
and projected profiles of a model are computed once on a
(log(1+z), log M, log r) grid, in float64 on the cosmology's device, and
read out by multilinear interpolation in log space. ``projected`` tables
store ``projected * a`` (comoving -> physical). Zero profile values log
to -inf, as in the JAX package; the paint pass treats readouts that are
not finite as painting nothing.

``ParamTabulatedProfile`` and ``TabulatedCorrelation3D`` are not ported
yet (ROADMAP items A8 and A13).
"""

import numpy as np
import torch

from .cosmology.massdef import MassDef
from .ops.interp import ndlinear_interp
from .profiles.base import HaloProfile

__all__ = ['TabulatedProfile']


class TabulatedProfile(HaloProfile):
    """Tabulated (z, M, r) wrapper around any profile model."""

    def __init__(self, model, cosmo, mass_def=None):
        self.model = model
        self.cosmo = cosmo
        super().__init__(mass_def=mass_def if mass_def is not None
                         else MassDef(200, 'critical'))

    def setup_interpolator(self, z_min=1e-2, z_max=5, N_samples_z=30,
                           z_linear_sampling=False,
                           M_min=1e12, M_max=1e16, N_samples_Mass=30,
                           R_min=1e-3, R_max=1e2, N_samples_R=100,
                           other_params={}, verbose=True):
        if other_params:
            raise ValueError(
                "TabulatedProfile has no extra parameter axes; "
                f"other_params={sorted(other_params)} needs "
                "ParamTabulatedProfile (not ported yet, ROADMAP A8)")
        # the grids are made with numpy, as in the JAX package, so both
        # tabulate at the same radii to the last bit
        M_range = np.geomspace(M_min, M_max, N_samples_Mass)
        r = np.geomspace(R_min, R_max, N_samples_R)
        z_range = (np.linspace(z_min, z_max, N_samples_z)
                   if z_linear_sampling
                   else np.geomspace(z_min, z_max, N_samples_z))
        t = self.cosmo.tensor
        real, proj = [], []
        for z_j in z_range:
            a_j = 1.0 / (1.0 + float(z_j))
            real.append(self.model.real(self.cosmo, t(r), t(M_range), a_j))
            # eager projection: the decades the radii span, as the JAX
            # package's eager table build uses (n_decades=None)
            proj.append(self.model.projected(self.cosmo, t(r), t(M_range),
                                             a_j) * a_j)
        self._grids = (t(np.log(1 + z_range)), t(np.log(M_range)),
                       t(np.log(r)))
        self._ln3D = torch.log(torch.stack(real))
        self._ln2D = torch.log(torch.stack(proj))

    def _check_built(self):
        if not hasattr(self, '_ln3D'):
            raise NameError(
                "No Table created. Run setup_interpolator() method first")

    def _readout(self, r, M, a, table):
        """exp of the table read at every (M, r) pair: shape (M, r)."""
        lnr = torch.log(r)[None, :]
        lnM = torch.log(M)[:, None]
        ln_z = torch.log(1.0 / torch.as_tensor(a, dtype=r.dtype,
                                               device=r.device))
        coords = torch.broadcast_tensors(ln_z * torch.ones_like(lnr), lnM,
                                         lnr)
        return torch.exp(ndlinear_interp(self._grids, table, coords))

    def _real(self, cosmo, r, M, a):
        self._check_built()
        return self._readout(r, M, a, self._ln3D)

    def _projected(self, cosmo, r, M, a):
        self._check_built()
        return self._readout(r, M, a, self._ln2D)
