"""Displacement-function models (baryonification proper).

The port of ``baryonification_tpu.displacement``: build enclosed DMO/DMB
mass profiles, invert M_DMB, and tabulate the displacement

    d(r | M, z, params) = M_DMB^{-1}(M_DMO(r)) - r

on a (log(1+z), logM, logr [, extra-param]) grid, then read it out with a
multilinear interpolation.

The build loops over redshift (and extra-parameter combinations) in
Python with all masses at once, then inverts every (z, M) profile in one
batch. It runs in float64 on the cosmology's device: on CUDA that is the
card, which has native float64 (the JAX package pins this work to the
host only because a TPU has none).

Halos whose mass profiles are too broken to invert get d = 0.
"""

import numpy as np
import torch

from .cosmology.massdef import MassDef
from .ops.interp import (pchip_derivatives, pchip_eval, masked_compact,
                         ndlinear_interp)
from .profiles.base import _set_parameter
from .utils import geomspace, interp_rows, safe_log

__all__ = ["BaryonificationClass", "Baryonification3D", "Baryonification2D"]


def _prev_valid(values, mask, fill=0.0):
    """For each i, the value of the latest valid entry j < i (else
    ``fill``), for every curve of the (..., N) batch.

    The JAX package scans over i; here the latest valid index is a running
    maximum over the masked positions, which selects the same entries."""
    N = values.shape[-1]
    pos = torch.arange(N, device=values.device)
    last = torch.cummax(torch.where(mask, pos, -1), dim=-1).values
    prev_idx = torch.cat([torch.full_like(last[..., :1], -1),
                          last[..., :-1]], dim=-1)
    prev = torch.gather(values, -1, prev_idx.clamp(min=0))
    return torch.where(prev_idx >= 0, prev, fill)


def _invert_mass_profile(lnr, ln_DMO, ln_DMB, n_mask_iter=30):
    """d(r) = exp(pchip_DMB(pchip_DMO(ln r))) - r with the iterative
    monotonicity/validity masking of the reference, for a (..., N) batch
    of profiles on the shared (N,) grid ``lnr``. Returns (offset, ok).

    The masks are computed from the raw log-masses; the numerics run on
    copies whose non-finite entries are replaced by 0, so every value that
    reaches the pchip arithmetic is finite.
    """
    lno_r = ln_DMO.detach()
    lnb_r = ln_DMB.detach()
    ln_DMO = torch.where(torch.isfinite(lno_r), ln_DMO, 0.0)
    ln_DMB = torch.where(torch.isfinite(lnb_r), ln_DMB, 0.0)

    # iterative DMB mask: monotone-increasing (vs the previous valid
    # point), separated from DMO, finite; index 0 forced valid each round
    sep_ok = ((lnb_r - lno_r).abs() > 1e-6) | torch.isnan(lno_r)
    fin_ok = torch.isfinite(lnb_r)
    diff_mask = torch.ones_like(lnb_r, dtype=torch.bool)
    for _ in range(n_mask_iter):
        diff_ok = (lnb_r - _prev_valid(lnb_r, diff_mask)) > 1e-5
        diff_mask = diff_mask & diff_ok & sep_ok & fin_ok
        diff_mask[..., 0] = True
    ok = diff_mask.sum(dim=-1) > 5

    # single-shot DMO mask (x-axis is radius, so laxer requirements)
    prev_dmo = torch.cat([torch.zeros_like(lno_r[..., :1]),
                          lno_r[..., :-1]], dim=-1)
    fini_mask = ((lno_r - prev_dmo > 1e-5)
                 & (((lnb_r - lno_r).abs() > 1e-6) | torch.isnan(lnb_r))
                 & torch.isfinite(lno_r))

    # DMO: ln r -> ln M_DMO, on the compacted valid points
    x1, y1, x1_hi = masked_compact(lnr, ln_DMO, fini_mask)
    d1 = pchip_derivatives(x1, y1)
    q1 = pchip_eval(lnr, x1, y1, d1)
    in1 = (lnr >= x1[..., :1]) & (lnr <= x1_hi[..., None])

    # DMB inverse: ln M_DMB -> ln r
    x2, y2, x2_hi = masked_compact(ln_DMB, lnr, diff_mask)
    d2 = pchip_derivatives(x2, y2)
    # clamp the query into the valid x2 span: out-of-span entries are
    # masked out below, and the edge cubic far outside its interval
    # explodes
    lo, hi = x2[..., :1], x2_hi[..., None]
    q1s = torch.minimum(torch.maximum(q1, lo), hi)
    q2 = pchip_eval(q1s, x2, y2, d2)
    in2 = in1 & (q1 >= lo) & (q1 <= hi)

    offset = torch.exp(q2) - torch.exp(lnr)
    offset = torch.where(in2 & torch.isfinite(offset), offset, 0.0)
    offset = torch.where(ok[..., None], offset, 0.0)
    return offset, ok


class BaryonificationClass:
    """Base displacement model: holds DMO+DMB profiles, builds the table.

    Forces ``cutoff = 1000`` on both profiles (the user-facing cutoffs are
    applied in the runners) and stores epsilon_max and the mass
    definition. Tables are built and kept on ``cosmo.device``.
    """

    def __init__(self, DMO, DMB, cosmo, epsilon_max=20, mass_def=None):
        self.DMO = DMO
        self.DMB = DMB
        self.DMO.set_parameter('cutoff', 1000)
        self.DMB.set_parameter('cutoff', 1000)
        self.cosmo = cosmo
        self.epsilon_max = epsilon_max
        self.mass_def = mass_def if mass_def is not None else MassDef(200, 'critical')

    def get_masses(self, model, r, M, a):
        raise NotImplementedError("Implement a get_masses() method first")

    def build_table(self, z_range, M_range, r, rdelta_range=None,
                    combos=None, p_keys=(), Rdelta_sampling=False):
        """The displacement table as a (z*C, M, R) float64 tensor on the
        cosmology's device (the port of ``build_table_device``).

        Enclosed masses are computed one redshift (and extra-parameter
        combination) at a time for all masses; the inversion then runs
        once over the whole (z*C*M) batch.

        Differentiable: profile parameters set on ``DMO``/``DMB`` as 0-dim
        tensors that require grad (e.g. ``M_c=torch.exp(lnMc)`` at
        construction), and the parameters of a ``cosmology_device``,
        carry their graph into the table; the masks of the inversion are
        taken from detached values, as the JAX package's
        ``stop_gradient`` takes them. With ``BaryonifyShell.
        process_device`` this closes the chain from baryon and
        cosmological parameters to the baryonified map.
        """
        cosmo = self.cosmo
        if combos is None:
            combos = np.zeros((1, 0))
        r = np.asarray(r)
        if rdelta_range is None:
            rdelta_range = r
        p_keys = list(p_keys)
        lnr = cosmo.tensor(np.log(r))
        M_dev = cosmo.tensor(M_range)

        dmo, dmb, avals = [], [], []
        for z_j in np.asarray(z_range):
            a_j = 1.0 / (1.0 + float(z_j))
            for pvals in combos:
                for ki, key in enumerate(p_keys):
                    _set_parameter(self.DMO, key, float(pvals[ki]))
                    _set_parameter(self.DMB, key, float(pvals[ki]))
                dmo.append(self.get_masses(self.DMO, r, M_dev, a_j))
                dmb.append(self.get_masses(self.DMB, r, M_dev, a_j))
                avals.append(a_j)
        offsets, _ = _invert_mass_profile(lnr, safe_log(torch.stack(dmo)),
                                          safe_log(torch.stack(dmb)))

        if Rdelta_sampling:
            a_t = cosmo.tensor(avals)[:, None]
            Rdelta = (self.mass_def.get_radius(cosmo, M_dev[None, :], a_t)
                      / a_t)                                  # (zC, M)
            offsets = interp_rows(
                cosmo.tensor(rdelta_range).expand(offsets.shape),
                torch.exp(lnr) / Rdelta[..., None], offsets)
        return offsets

    #: the JAX package's name for the table build
    build_table_device = build_table

    def setup_interpolator(self,
                           z_min=1e-2, z_max=5, N_samples_z=30,
                           z_linear_sampling=False,
                           M_min=1e12, M_max=1e16, N_samples_Mass=30,
                           R_min=1e-3, R_max=1e2, N_samples_R=100,
                           Rdelta_min=1e-3, Rdelta_max=10,
                           Rdelta_sampling=False,
                           other_params={}, verbose=True):
        """Tabulate d(log(1+z), logM, logr [, extra params]) in float64 on
        the cosmology's device (same sampling as the JAX package)."""
        if z_min <= 0:
            assert z_linear_sampling, (
                f"Geometric series not possible for {z_min} < z < {z_max}. "
                "Set z_linear_sampling = True, or z_min > 0")

        M_range = np.geomspace(M_min, M_max, N_samples_Mass)
        r = np.geomspace(R_min, R_max, N_samples_R)
        z_range = (np.linspace(z_min, z_max, N_samples_z) if z_linear_sampling
                   else np.geomspace(z_min, z_max, N_samples_z))
        p_keys = list(other_params.keys())
        rdelta_range = np.geomspace(Rdelta_min, Rdelta_max, N_samples_R)

        # outer product over the extra-parameter values
        if p_keys:
            grids = np.meshgrid(*[np.asarray(other_params[k]) for k in p_keys],
                                indexing="ij")
            combos = np.stack([g.ravel() for g in grids], axis=-1)  # (C, P)
        else:
            combos = np.zeros((1, 0))

        # restore the profile parameters the sweep mutates
        saved = [{k: getattr(prof, k, None) for k in p_keys}
                 for prof in (self.DMO, self.DMB)]
        try:
            table = self.build_table(z_range, M_range, r,
                                     rdelta_range=rdelta_range,
                                     combos=combos, p_keys=p_keys,
                                     Rdelta_sampling=Rdelta_sampling)
        finally:
            for prof, sv in zip((self.DMO, self.DMB), saved):
                for k, v in sv.items():
                    prof.set_parameter(k, v)

        # (z*C, M, r) -> (z, M, r, p1, p2, ...)
        table = table.reshape(
            (z_range.size,) + tuple(len(other_params[k]) for k in p_keys)
            + (M_range.size, N_samples_R))
        nP = len(p_keys)
        table = torch.movedim(table, tuple(range(1, 1 + nP)),
                              tuple(range(table.dim() - nP, table.dim())))
        input_rad = np.log(rdelta_range) if Rdelta_sampling else np.log(r)
        grids = [np.log(1 + z_range), np.log(M_range), input_rad]
        grids += [np.asarray(other_params[k], dtype=np.float64)
                  for k in p_keys]
        return self.from_arrays(grids, table, Rdelta_sampling, p_keys)

    # ----- carrying tables across -----
    def from_arrays(self, grids, table, rdelta, p_keys, *, device=None,
                    dtype=torch.float64):
        """Install a table from arrays: ``grids`` the axis coordinates
        (log(1+z), log M, log r or log r/R_Delta, extra-parameter values),
        ``table`` of shape (z, M, r, props...), ``rdelta`` whether the
        radial axis is r/R_Delta, ``p_keys`` the extra-parameter names.
        This is what ``baryonification_tpu``'s ``_grids``/``_table`` hold,
        so a table built by either package runs in the other. The tensors
        go to ``device`` (default: the cosmology's) as ``dtype``."""
        device = self.cosmo.device if device is None else torch.device(device)
        as_t = lambda x: (x.to(device=device, dtype=dtype)
                          if torch.is_tensor(x) else
                          torch.tensor(np.asarray(x), dtype=dtype,
                                       device=device))
        self._grids = tuple(as_t(g) for g in grids)
        self._table = as_t(table)
        self.Rdelta_sampling = bool(rdelta)
        self.p_keys = [str(k) for k in p_keys]
        return self

    def save_table(self, path):
        """Write the table in the npz layout of
        ``baryonification_tpu``'s ``save_table``."""
        if not hasattr(self, '_table'):
            raise NameError("No Table created. Run setup_interpolator() first")
        np.savez(path, table=self._table.cpu().numpy(),
                 n_grids=len(self._grids),
                 rdelta=int(self.Rdelta_sampling),
                 p_keys=np.asarray(self.p_keys, dtype=object),
                 **{f"grid{i}": g.cpu().numpy()
                    for i, g in enumerate(self._grids)})

    def load_table(self, path, *, device=None, dtype=torch.float64):
        """Read a table written by either package's ``save_table``."""
        dat = np.load(path, allow_pickle=True)
        grids = [dat[f"grid{i}"] for i in range(int(dat["n_grids"]))]
        return self.from_arrays(grids, dat["table"], bool(dat["rdelta"]),
                                list(dat["p_keys"]), device=device,
                                dtype=dtype)

    # ----- readout -----
    def _readout(self, r, M, a, **kwargs):
        cosmo = self.cosmo
        r_use = torch.atleast_1d(cosmo.tensor(r))
        M_use = torch.atleast_1d(cosmo.tensor(M))
        R = self.mass_def.get_radius(cosmo, M_use, a) / a   # comoving

        shape = (M_use.shape[0], r_use.shape[0])
        z_in = torch.full(shape, float(np.log(1.0 / a)), dtype=cosmo.dtype,
                          device=cosmo.device)
        lnr = torch.log(r_use)[None, :]
        rad = lnr - torch.log(R)[:, None] if self.Rdelta_sampling else lnr
        coords = [z_in, torch.log(M_use)[:, None], rad]
        coords += [cosmo.tensor(kwargs[k]) for k in self.p_keys]
        d = ndlinear_interp(self._grids, self._table,
                            [c.expand(shape) for c in coords])
        displ = torch.where(r_use[None, :] < self.epsilon_max * R[:, None],
                            d, 0.0)
        if torch.as_tensor(r).dim() == 0:
            displ = displ.squeeze(-1)
        if torch.as_tensor(M).dim() == 0:
            displ = displ.squeeze(0)
        return displ

    def displacement(self, r, M, a, **kwargs):
        """Displacement in comoving Mpc (table readout only); ``a`` is a
        float."""
        if not hasattr(self, '_table'):
            raise NameError("No Table created. Run setup_interpolator() first")
        for k in self.p_keys:
            assert k in kwargs, (
                "Need to provide %s as input into `displacement'. "
                "Table was built with this." % k)
        return self._readout(r, M, a, **kwargs)


def _enclosed_mass_interp(r_int, dens, M_enc, r):
    """log-log pchip of the enclosed masses (M, Nint) at the radii r,
    NaN outside the valid span."""
    lnr_int = torch.log(r_int)
    lnr_q = torch.log(torch.as_tensor(r, dtype=r_int.dtype,
                                      device=r_int.device))
    mask = (dens > 0) & torch.isfinite(M_enc)
    xc, yc, x_hi = masked_compact(lnr_int, torch.log(M_enc), mask)
    d = pchip_derivatives(xc, yc)
    q = pchip_eval(lnr_q, xc, yc, d)
    q = torch.where((lnr_q >= xc[..., :1]) & (lnr_q <= x_hi[..., None]), q,
                    float("nan"))
    return torch.exp(q)


class Baryonification3D(BaryonificationClass):
    """3D displacement: enclosed mass from the spherical density profile."""

    def get_masses(self, model, r, M, a):
        r_min = min(float(np.min(r)), 1e-6)
        r_max = max(float(np.max(r)), 1000.0)
        r_int = geomspace(r_min / 1.2, r_max * 1.2, 50_000,
                          device=self.cosmo.device, dtype=self.cosmo.dtype)
        dlnr = torch.log(r_int[1] / r_int[0])

        rho = model._real(self.cosmo, r_int,
                          torch.atleast_1d(self.cosmo.tensor(M)), a)
        rho = torch.where(rho < 0, 0.0, rho)
        M_enc = torch.cumsum(4 * np.pi * r_int**3 * rho * dlnr, dim=-1)
        return _enclosed_mass_interp(r_int, rho, M_enc, r)


class Baryonification2D(BaryonificationClass):
    """2D (projected) displacement: enclosed mass from the surface density,
    with the comoving->physical ``a`` factor on Sigma."""

    def get_masses(self, model, r, M, a):
        r_min = min(float(np.min(r)), 1e-6)
        r_max = max(float(np.max(r)), 1000.0)
        r_int = geomspace(r_min / 1.5, r_max * 1.5, 50_000,
                          device=self.cosmo.device, dtype=self.cosmo.dtype)
        dlnr = torch.log(r_int[1] / r_int[0])

        # the JAX package builds its table under jit, where the projection
        # cannot read its radii and integrates over its static 12 decades;
        # the port pins the same grid so both tables agree
        Sigma = model.projected(self.cosmo, r_int,
                                torch.atleast_1d(self.cosmo.tensor(M)), a,
                                n_decades=12) * a
        Sigma = torch.where(Sigma < 0, 0.0, Sigma)
        M_enc = torch.cumsum(2 * np.pi * r_int**2 * Sigma * dlnr, dim=-1)
        return _enclosed_mass_interp(r_int, Sigma, M_enc, r)
