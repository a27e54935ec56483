"""Tabulated halo profiles on the device.

The port of ``baryonification_tpu.tabulate``'s ``TabulatedProfile`` and
``ParamTabulatedProfile``: the real and projected profiles of a model are
computed once on a (log(1+z), log M, log r [, extra parameters...]) grid,
in float64 on the cosmology's device, and read out by multilinear
interpolation in log space. ``projected`` tables store ``projected * a``
(comoving -> physical). Zero profile values log to -inf, as in the JAX
package; the paint passes treat readouts that are not finite as painting
nothing. ``from_arrays`` installs tables made elsewhere (the JAX
package's ``_grids``, ``_ln3D`` and ``_ln2D``).

``TabulatedCorrelation3D`` tabulates xi_mm(r, z) for injection into
``TwoHalo`` (``xi_mm=``), read with its ends clamped.
"""

import inspect

import numpy as np
import torch

from .cosmology.massdef import MassDef
from .ops.interp import ndlinear_interp
from .profiles.base import HaloProfile, _set_parameter
from .utils import safe_log

__all__ = ['TabulatedProfile', 'ParamTabulatedProfile',
           'TabulatedCorrelation3D']


def _grid_ranges(z_min, z_max, N_samples_z, z_linear_sampling, M_min, M_max,
                 N_samples_Mass, R_min, R_max, N_samples_R):
    """The (z, M, r) sample points, made with numpy as in the JAX package
    so that both tabulate at the same points to the last bit."""
    M_range = np.geomspace(M_min, M_max, N_samples_Mass)
    r = np.geomspace(R_min, R_max, N_samples_R)
    z_range = (np.linspace(z_min, z_max, N_samples_z) if z_linear_sampling
               else np.geomspace(z_min, z_max, N_samples_z))
    return z_range, M_range, r


def _install(obj, grids, ln3D, ln2D, device, dtype):
    """Put the grids and log tables on ``device`` as ``dtype``."""
    device = (obj.cosmo.device if device is None else torch.device(device))
    as_t = lambda x: (x.to(device=device, dtype=dtype) if torch.is_tensor(x)
                      else torch.tensor(np.asarray(x), dtype=dtype,
                                        device=device))
    obj._grids = tuple(as_t(g) for g in grids)
    obj._ln3D = as_t(ln3D)
    obj._ln2D = as_t(ln2D)
    return obj


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
                "ParamTabulatedProfile")
        z_range, M_range, r = _grid_ranges(
            z_min, z_max, N_samples_z, z_linear_sampling, M_min, M_max,
            N_samples_Mass, R_min, R_max, N_samples_R)
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

    def build_tables_device(self, z_range, M_range, r):
        """The (ln3D, ln2D) log tables of ``model`` as (Nz, NM, NR)
        float64 tensors on the cosmology's device, with no cast to host
        numbers (the port of the JAX package's ``build_tables_device``).

        Differentiable: profile parameters set on ``model`` as 0-dim
        tensors that require grad carry their graph into the tables; with
        ``PaintProfilesShell.process_device`` this closes the chain from,
        e.g., gas parameters to a painted map. Zero profile values log to
        -inf through ``safe_log``, so their backward is an exact 0. A
        real-space projection integrates over the fixed 12 decades of the
        JAX package's jitted build (models whose ``projected`` takes no
        ``n_decades`` project as they do eagerly)."""
        t = self.cosmo.tensor
        r_t, M_t = t(np.asarray(r)), t(np.asarray(M_range))
        kw = ({"n_decades": 12} if "n_decades" in inspect.signature(
            self.model.projected).parameters else {})
        real, proj = [], []
        for z_j in np.asarray(z_range):
            a_j = 1.0 / (1.0 + float(z_j))
            real.append(self.model.real(self.cosmo, r_t, M_t, a_j))
            proj.append(self.model.projected(self.cosmo, r_t, M_t, a_j,
                                             **kw) * a_j)
        return safe_log(torch.stack(real)), safe_log(torch.stack(proj))

    def from_arrays(self, grids, ln3D, ln2D, p_keys=(), *, device=None,
                    dtype=torch.float64):
        """Install tables from arrays: ``grids`` the axis coordinates
        (log(1+z), log M, log r), ``ln3D`` and ``ln2D`` the (z, M, r) log
        tables. This is what ``baryonification_tpu``'s ``_grids``,
        ``_ln3D`` and ``_ln2D`` hold, so a table built by either package
        paints in the other. The tensors go to ``device`` (default: the
        cosmology's) as ``dtype``. Returns ``self``."""
        if len(p_keys):
            raise ValueError(f"TabulatedProfile has no extra parameter axes "
                             f"(got {list(p_keys)}); use "
                             f"ParamTabulatedProfile")
        return _install(self, grids, ln3D, ln2D, device, dtype)

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


class ParamTabulatedProfile:
    """Tabulated profile with extra parameter axes: the profiles of
    ``model`` on a (log(1+z), log M, log r, p_1, ..., p_n) grid, one axis
    per key of ``other_params``, for runners whose catalogs carry those
    parameters per halo (e.g. ``cdelta``). ``real`` and ``projected``
    take the parameters as keyword arguments."""

    def __init__(self, model, cosmo, mass_def=None):
        assert not isinstance(model, TabulatedProfile), \
            "Input model cannot be 'TabulatedProfile' object."
        self.model = model
        self.cosmo = cosmo
        self.mass_def = (mass_def if mass_def is not None
                         else MassDef(200, 'critical'))

    def setup_interpolator(self, z_min=1e-2, z_max=5, N_samples_z=30,
                           z_linear_sampling=False,
                           M_min=1e12, M_max=1e16, N_samples_Mass=30,
                           R_min=1e-3, R_max=1e2, N_samples_R=100,
                           other_params={}, verbose=True):
        z_range, M_range, r = _grid_ranges(
            z_min, z_max, N_samples_z, z_linear_sampling, M_min, M_max,
            N_samples_Mass, R_min, R_max, N_samples_R)
        p_keys = list(other_params.keys())
        p_vals = [np.asarray(other_params[k]) for k in p_keys]
        p_sizes = tuple(len(v) for v in p_vals)
        combos = (np.stack([g.ravel() for g in
                            np.meshgrid(*p_vals, indexing="ij")], axis=-1)
                  if p_keys else np.zeros((1, 0)))
        t = self.cosmo.tensor
        real, proj = [], []
        saved = {k: getattr(self.model, k, None) for k in p_keys}
        try:
            for z_j in z_range:
                a_j = 1.0 / (1.0 + float(z_j))
                for pv in combos:
                    for key, v in zip(p_keys, pv):
                        _set_parameter(self.model, key, float(v))
                    real.append(self.model.real(self.cosmo, t(r),
                                                t(M_range), a_j))
                    proj.append(self.model.projected(
                        self.cosmo, t(r), t(M_range), a_j) * a_j)
        finally:
            for k, v in saved.items():
                _set_parameter(self.model, k, v)
        # (z, p..., M, r) -> (z, M, r, p...)
        shape = (len(z_range),) + p_sizes + (len(M_range), len(r))
        nP = len(p_keys)
        tables = [torch.stack(x).reshape(shape).movedim(
            tuple(range(1, 1 + nP)), tuple(range(3, 3 + nP)))
            for x in (real, proj)]
        self._grids = tuple([t(np.log(1 + z_range)), t(np.log(M_range)),
                             t(np.log(r))] + [t(v) for v in p_vals])
        self._ln3D, self._ln2D = (torch.log(x) for x in tables)
        self.p_keys = p_keys

    def from_arrays(self, grids, ln3D, ln2D, p_keys, *, device=None,
                    dtype=torch.float64):
        """Install tables from arrays: ``grids`` the axis coordinates
        (log(1+z), log M, log r, then one per parameter), ``ln3D`` and
        ``ln2D`` the (z, M, r, p...) log tables, ``p_keys`` the parameter
        names, as ``baryonification_tpu``'s ParamTabulatedProfile holds
        them. The tensors go to ``device`` (default: the cosmology's) as
        ``dtype``. Returns ``self``."""
        self.p_keys = [str(k) for k in p_keys]
        return _install(self, grids, ln3D, ln2D, device, dtype)

    def _check_built(self):
        if not hasattr(self, '_ln3D'):
            raise NameError(
                "No Table created. Run setup_interpolator() method first")

    def _readout(self, r, M, a, table, **kwargs):
        """exp of the table read at every (M, r) pair and the given
        parameter values: shape (M, r)."""
        t = self.cosmo.tensor
        r_use, M_use = torch.atleast_1d(t(r)), torch.atleast_1d(t(M))
        lnr = torch.log(r_use)[None, :]
        lnM = torch.log(M_use)[:, None]
        ln_z = torch.full_like(lnr, float(np.log(1.0 / a)))
        coords = torch.broadcast_tensors(
            ln_z, lnM, lnr, *[t(kwargs[k]) * torch.ones_like(lnr)
                              for k in self.p_keys])
        prof = torch.exp(ndlinear_interp(self._grids, table, coords))
        if np.ndim(r) == 0:
            prof = prof[:, 0]
        if np.ndim(M) == 0:
            prof = prof[0]
        return prof

    def real(self, cosmo, r, M, a, **kwargs):
        self._check_built()
        for k in self.p_keys:
            assert k in kwargs, ("Need to provide %s as input into `real'. "
                                 "Table was built with this." % k)
        return self._readout(r, M, a, self._ln3D, **kwargs)

    def projected(self, cosmo, r, M, a, **kwargs):
        self._check_built()
        for k in self.p_keys:
            assert k in kwargs, ("Need to provide %s as input into "
                                 "`projected'. Table was built with this." % k)
        return self._readout(r, M, a, self._ln2D, **kwargs)


class TabulatedCorrelation3D:
    """Tabulated xi_mm(r, z) on the cosmology's device, callable as
    xi(r, a) for injection into ``TwoHalo``."""

    def __init__(self, cosmo, R_range=(1e-3, 1e3), N_samples=500):
        self.cosmo = cosmo
        self.R_range = R_range
        self.N_samples = N_samples

    def setup_interpolator(self, z_min=0, z_max=5, N_samples_z=10,
                           verbose=False):
        r = np.geomspace(self.R_range[0], self.R_range[1], self.N_samples)
        z_range = np.linspace(z_min, z_max, N_samples_z)
        table = torch.stack([self.cosmo.xi_mm(r, 1.0 / (1.0 + z_j))
                             for z_j in z_range])

        self.raw_input_3D = table.cpu().numpy()
        self.raw_input_z_range = np.log(1 + z_range)
        self.raw_input_r_range = np.log(r)
        self._grids = (self.cosmo.tensor(np.log(1 + z_range)),
                       self.cosmo.tensor(np.log(r)))
        # xi can be negative beyond the BAO scale: interpolate linearly
        self._xi = table

    def __call__(self, r, a):
        r_use = torch.atleast_1d(self.cosmo.tensor(r))
        # clamp to the table's ends instead of a NaN fill: displacement
        # tables evaluate TwoHalo on quadrature grids wider than R_range,
        # and a NaN there would spoil the enclosed-mass sums
        gz, gr = self._grids
        z_in = torch.clamp(torch.full_like(r_use, float(np.log(1.0 / a))),
                           gz[0], gz[-1])
        lnr = torch.clamp(torch.log(r_use), gr[0], gr[-1])
        return ndlinear_interp(self._grids, self._xi, (z_in, lnr))
