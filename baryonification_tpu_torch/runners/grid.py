"""2D/3D grid runners: baryonify and paint profiles on periodic maps.

The port of ``baryonification_tpu.runners.grid`` for ``BaryonifyGrid``
and ``PaintProfilesGrid``, both methods, 2D (flat-sky maps) and 3D.
Halos are bucketed by cutout size (``Nsize``); each bucket has one cutout
half-window, ``half``, and a halo only reaches the cells of the
[cen - half, cen + half) window around its nearest bin on every axis
(periodic), as in the reference's per-halo cutouts.

- ``method="cellmajor"`` (what ``"auto"`` takes on the card): candidate
  lists per Morton block and one dense pass a bucket
  (``runners/grid_cellmajor.py``; on the card one launch of the
  hand-written kernel ``grid_pass`` a bucket, on the CPU plain PyTorch
  ops; XLA in the JAX package);
- ``method="scatter"`` (the reference semantics, ``"auto"`` on the CPU):
  per-halo windowed cutouts, chunks of halos, one scatter-add of the
  offsets (or painted values) a chunk (``ops.scatter_cuda``, the
  hand-written CUDA kernel on a GPU).

``BaryonifyGrid.process`` ends both methods in the CIC redeposit of the
original map at the displaced cell positions (``ops.scatter``: one
launch of the scatter kernel a CIC corner, N^d rows each, on the card),
then the mass-conservation check. 2D runs support the reference's
ellipticity (a galsim-style shear of the radius grid, :func:`build_Rmat`);
3D ellipticity raises, as in the reference.

``process_device(table=None)`` of both runners is the differentiable
core, both methods, 2D and 3D: the map as a device tensor in the hot
dtype, with gradients into the table. The cell-major passes go through
``grid_cellmajor.grid_pass_diff`` (on the card the ``grid_pass`` kernel,
its backward the ``grid_vjp`` kernel; on the CPU the plain-op pass under
no_grad, its backward recomputed a step at a time, so memory stays that
of one step);
the windowed scatters and the CIC redeposit through the scatter-add's
autograd (``ops.scatter_cuda``: the backward is the hand-written
``scatter_add_vjp`` kernel on the card). Registration, candidates,
packed records and the CIC coordinate planes are cached per catalog, so
a warm call registers nothing.

Precision: ``precision="auto"`` is float64 on the CPU and float32 on
CUDA, as in the JAX package. The per-halo preprocessing (radii, buckets,
nearest bins) runs in float64 on the host, as there.

``PaintProfilesAnisGrid`` paints a profile as a function of an existing
2D map (y(delta) in place of y(r)): ``scatter`` is the reference's loop
over halos, ``cellmajor`` reads a remap table ln Paint(ln Canvas) per mass
node in one block-major pass a bucket
(``grid_cellmajor.grid_anis_paint_pass_2d``); its ``process_device`` is
differentiable in the remap and in the canvas map.

``mesh=`` (a ``torch.distributed`` ``DeviceMesh``; cell-major only)
shards every runner's passes over the ranks of one mesh dimension: each
bucket's Morton blocks split into contiguous ranges
(``parallel.pad_cells_for_mesh``), each rank adds its blocks' output into
a full-size partial map, and sums over the mesh join them: for
``BaryonifyGrid`` the offsets (before the CIC, which each rank then
deposits for its own row-major range of cells) and the CIC's partial
maps, for the paints the painted maps. Every rank returns the whole map.
"""

from itertools import product

import numpy as np
import torch

from ..cosmology import Cosmology, MassDef
from ..ops.interp import blend_table_radial, ndlinear_interp, radial_readout
from ..ops.scatter import cic_deposit_2d, cic_deposit_3d
from ..ops.scatter_cuda import scatter_add_accum
from ..parallel import (mesh_grad_sum, mesh_grid_anis_paint_bucket,
                        mesh_grid_cic, mesh_grid_offsets_bucket,
                        mesh_grid_paint_bucket, mesh_sum)
from ..utils import interp, interp_rows, resolve_device
from . import grid_cellmajor as gcm
from ._method import resolve_method
from .shell import DefaultRunner, _mesh_args
from .shell_cellmajor import dense_cell_candidates

__all__ = ['build_Rmat', 'DefaultRunnerGrid', 'BaryonifyGrid',
           'PaintProfilesGrid', 'PaintProfilesAnisGrid']


def build_Rmat(A, q):
    """2D shear matrix mapping grid coordinates to the elliptical-radius
    frame of a halo with axis vector A and axis ratio q (galsim Shear
    conventions, in closed form: |g| = (1 - q)/(1 + q) and the position
    angle beta = arccos(A_x) in [0, pi] enters only through cos/sin(2
    beta), so the sign of A_y is dropped, as in the reference). The
    matrix is area-preserving: coordinates along A are stretched by
    q^(-1/2), perpendicular ones shrunk by q^(1/2)."""
    ax, ay = np.asarray(A, dtype=np.float64) / np.linalg.norm(A)
    gmod = (1.0 - q) / (1.0 + q)
    g1 = gmod * (2.0 * ax * ax - 1.0)        # |g| cos(2 beta)
    g2 = gmod * (2.0 * ax * abs(ay))         # |g| sin(2 beta)
    det = np.sqrt(1.0 - gmod * gmod)
    return np.array([[1.0 + g1, g2], [g2, 1.0 - g1]]) / det


class DefaultRunnerGrid:
    """Shared configuration for the grid runners.

    ``device`` is where the runner computes: the card unless the caller
    asks for the CPU. ``precision`` is its hot-path dtype ("auto":
    float64 on the CPU, float32 on CUDA). ``method``: see
    :func:`runners._method.resolve_method` ("auto" is "cellmajor" on CUDA
    and "scatter" on the CPU; "scatter" with a warning for 3D
    ellipticity or a model with more extra table axes than the packed
    records hold). ``mesh`` and ``mesh_axis`` shard the cell-major
    method over one mesh dimension's ranks, as the shell runners' do.
    """

    _stage = DefaultRunner._stage
    _stage_t0 = DefaultRunner._stage_t0
    #: the caches built from the halo catalog (dropped when it changes)
    _CATALOG_CACHES = ('_gpacked_cache', '_gdense_cache',
                       '_anis_remap_cache', '_gcache_cat')

    def __init__(self, HaloNDCatalog, GriddedMap, epsilon_max, model,
                 use_ellipticity=False, mass_def=None, verbose=True,
                 halo_chunk=64, n_buckets=8, precision="auto",
                 method="auto", mesh=None, mesh_axis=None, *,
                 device="cuda"):
        self.HaloNDCatalog = HaloNDCatalog
        self.GriddedMap = GriddedMap
        self.cosmo = HaloNDCatalog.cosmology
        self.model = model
        self.epsilon_max = epsilon_max
        self.mass_def = mass_def if mass_def is not None else MassDef(200, 'critical')
        self.verbose = verbose
        self.halo_chunk = halo_chunk
        self.n_buckets = n_buckets
        self.use_ellipticity = use_ellipticity
        self.device = torch.device(device)
        if precision == "auto":
            precision = ("float64" if self.device.type == "cpu"
                         else "float32")
        self.dtype = getattr(torch, precision) if isinstance(precision, str) \
            else precision
        self.mesh, self.mesh_axis, method = _mesh_args(mesh, mesh_axis,
                                                       method)
        p_keys = getattr(model, 'p_keys', []) or []
        max_props = gcm.MAX_PROPS_2D if GriddedMap.is2D else gcm.MAX_PROPS_3D
        why_not = None
        if not GriddedMap.is2D and use_ellipticity:
            why_not = "3D ellipticity has no cell-major formulation"
        elif len(p_keys) > max_props:
            why_not = (f"model has {len(p_keys)} extra parameter axes; "
                       f"the packed records fit at most {max_props}")
        self.method = resolve_method(method, why_not, "scatter",
                                     self.device.type)
        if use_ellipticity:
            names = HaloNDCatalog.cat.dtype.names
            assert 'q_ell' in names, ("The 'q_ell' column is missing, but "
                                      "you set use_ellipticity = True")
            if not GriddedMap.is2D:
                raise NotImplementedError(
                    "use_ellipticity is not implemented for 3D maps, as in "
                    "the reference")
            assert 'A_ell' in names, ("The 'A_ell' column is missing, but "
                                      "you set use_ellipticity = True")

    def _halo_arrays(self, cosmo, comoving_R=False):
        """(a, per-halo float64 numpy arrays): positions, M, R_Delta
        (physical, or comoving with ``comoving_R``), the shear matrices
        and their largest stretch ``qfac``, and the property columns."""
        cat = self.HaloNDCatalog.cat
        a = 1.0 / (1.0 + self.HaloNDCatalog.redshift)
        R = self.mass_def.get_radius(
            cosmo, torch.as_tensor(cat['M'], dtype=torch.float64,
                                   device=cosmo.device), a).cpu().numpy()
        if comoving_R:
            R = R / a
        out = dict(x=cat['x'].copy(), y=cat['y'].copy(), M=cat['M'].copy(),
                   R=R)
        if not self.GriddedMap.is2D:
            out['z'] = cat['z'].copy()
        if self.use_ellipticity:
            out['Rmat'] = np.stack([build_Rmat(Av, qv) for Av, qv in
                                    zip(cat['A_ell'], cat['q_ell'])])
            # the eps_max * R cutoff on the ELLIPTICAL radius reaches
            # q^(-1/2) farther in circular distance (registration bound)
            q = np.asarray(cat['q_ell'], dtype=np.float64)
            out['qfac'] = np.sqrt(np.maximum(q, 1.0 / np.maximum(q, 1e-8)))
        else:
            out['Rmat'] = np.tile(np.eye(2), (cat.size, 1, 1))
            out['qfac'] = np.ones(cat.size)
        p_keys = getattr(self.model, 'p_keys', []) or []
        out['props'] = (np.stack([cat[k] for k in p_keys], axis=-1)
                        if p_keys else np.zeros((cat.size, 0)))
        return a, out

    def _tensor(self, x, dt):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=self.device)

    # ----- cell-major staging (cached per catalog) -----
    def _check_gcaches(self):
        """Drop the per-catalog caches if the catalog object was swapped."""
        if getattr(self, '_gcache_cat', None) is not self.HaloNDCatalog:
            for attr in self._CATALOG_CACHES:
                self.__dict__.pop(attr, None)
            self._gcache_cat = self.HaloNDCatalog

    _node_bound = staticmethod(DefaultRunner._node_bound)

    def _nearest_bins(self, x):
        """Nearest-bin index per halo per axis, as argmin(|bins - x|)
        (ties -> the lower index)."""
        gm = self.GriddedMap
        bins = np.asarray(gm.bins, dtype=np.float64)
        N = len(bins)
        cand = np.clip(np.floor((x - bins[0]) / gm.res).astype(np.int64),
                       0, N - 2)
        lo = np.abs(bins[cand] - x)
        hi = np.abs(bins[cand + 1] - x)
        return (cand + (hi < lo)).astype(np.int64)

    def _grid_packed(self, arrs, R_com, dt):
        """(H, 16) packed records of the catalog on the device, cached per
        dtype: 3D [dx, dy, dz, R_com, lnM, lnRc, cen_x, cen_y, cen_z |
        props], 2D [dx, dy, R_com, lnM, lnRc, cen_x, cen_y, Rm00, Rm01,
        Rm10, Rm11 | props], with cen_* each halo's nearest bin and d* its
        offset from that bin's centre, taken in float64 (see
        ``grid_cellmajor``)."""
        cache = self.__dict__.setdefault('_gpacked_cache', {})
        if dt not in cache:
            gm = self.GriddedMap
            bins = np.asarray(gm.bins, dtype=np.float64)
            pos = [arrs[c] for c in ('x', 'y', 'z')[:2 if gm.is2D else 3]]
            cen = [self._nearest_bins(p) for p in pos]
            cols = ([p - bins[c] for p, c in zip(pos, cen)]
                    + [R_com, np.log(arrs['M']), np.log(R_com)] + cen)
            if gm.is2D:
                cols += list(arrs['Rmat'].reshape(-1, 4).T)
            props = arrs['props']
            cols = np.stack(cols + list(props.T), axis=-1)
            cache[dt] = self._tensor(np.pad(cols, ((0, 0),
                                                   (0, 16 - cols.shape[1]))),
                                     dt)
        return cache[dt]

    def _grid_dense(self, bi, B, sel, arrs, reach, R_q_sel, dt):
        """Block candidates of bucket ``bi`` (cached per catalog):
        (dense, counts, counts on the host, K, B_eff). Each halo's reach
        is min(bucket window, eps_max * R): the radial cutoff zeroes
        everything beyond it. While K is long the lists are refined to
        blocks half the edge (:func:`grid_cellmajor.refine_block_
        candidates`): the pass's work is N^d * K."""
        cache = self.__dict__.setdefault('_gdense_cache', {})
        key = (bi, B, dt)
        if key not in cache:
            gm = self.GriddedMap
            dim = 2 if gm.is2D else 3
            N = gm.Npix
            nb = N // B
            L = float(N * gm.res)
            hb = L / nb
            # every block whose centre can be within reach + hb/2 (per
            # axis) of a halo anywhere in its block
            W = min(2 * int(np.ceil(reach / hb + 1.0)) + 1, nb)
            rr = np.minimum(reach, np.asarray(R_q_sel))
            x0 = np.asarray(gm.bins)[0] - gm.res / 2
            pos = [np.mod(arrs[c][sel] - x0, L)
                   for c in ('x', 'y', 'z')[:dim]]
            pos_d = [self._tensor(p, dt) for p in pos]
            rr_d = self._tensor(rr, dt)
            register = (gcm.register_halos_grid_2d if gm.is2D
                        else gcm.register_halos_grid)
            hids, cell_start, K = register(nb, W, L, *pos_d, rr_d)
            dense, counts = dense_cell_candidates(nb ** dim, max(K, 1),
                                                  hids, cell_start)
            hrec = torch.stack(pos_d + [rr_d], dim=-1)
            refine = (gcm.refine_block_candidates_2d if gm.is2D
                      else gcm.refine_block_candidates)
            B_eff = B
            k_min = getattr(self, 'refine_k_min', 48)
            while K >= k_min and B_eff % 2 == 0 and B_eff // 2 >= 4:
                B_eff //= 2
                nb2 = N // B_eff
                dense2d, counts, K = refine(nb2, dense, counts, hrec,
                                            L / nb2, L)
                dense = dense2d[:, :max(K, 1)].reshape(-1).contiguous()
            cache[key] = (dense, counts, counts.cpu().numpy(), K, B_eff)
        return cache[key]

    def _grid_perms(self, N, B):
        """(block-major position -> row-major voxel/pixel id, and its
        inverse, to unsort the pass outputs), cached per (N, B)."""
        cache = self.__dict__.setdefault('_gperm_cache', {})
        dim = 2 if self.GriddedMap.is2D else 3
        if (N, B, dim) not in cache:
            perm = (gcm.block_perm_2d(N, B, device=self.device) if dim == 2
                    else gcm.block_perm(N, B, device=self.device))
            inv = torch.empty_like(perm)
            inv[perm] = torch.arange(N ** dim, device=self.device)
            cache[(N, B, dim)] = (perm, inv)
        return cache[(N, B, dim)]

    def _grid_inv_perm(self, N, B):
        return self._grid_perms(N, B)[1]

    def _cic_coords(self, N, dim, dt):
        """Row-major integer cell-coordinate planes on the device, cached
        per (N, dim, dtype)."""
        cache = self.__dict__.setdefault('_ccoord_cache', {})
        key = (N, dim, dt)
        if key not in cache:
            i = torch.arange(N ** dim, device=self.device)
            cache[key] = tuple(((i // N ** (dim - 1 - d)) % N).to(dt)
                               for d in range(dim))
        return cache[key]

    def _cic_offsets(self, gm, offsets, vals, dt):
        """CIC redeposit of the original map ``vals`` (flat, on the
        device) at the displaced cell positions."""
        N = gm.Npix
        planes = self._cic_coords(N, 2 if gm.is2D else 3, dt)
        pos = [o + c for o, c in zip(offsets, planes)]
        deposit = cic_deposit_2d if gm.is2D else cic_deposit_3d
        return deposit(N, *pos, vals, dtype=dt)

    def _block_buckets(self, arrs, R_com, Nsize, idx_all, dt):
        """The cell-major buckets of the halos ``idx_all``, by cutout size:
        yields (bucket, its halos, their cutout half-window, (B, dense,
        counts, counts on the host, K, B_eff)), each registered in blocks
        (:meth:`_grid_dense`; stage reg[...])."""
        N, res = self.GriddedMap.Npix, self.GriddedMap.res
        eps = float(self.epsilon_max)
        for bi, idx in enumerate(_nsize_buckets(Nsize[idx_all],
                                                self.n_buckets)):
            sel = idx_all[idx]
            half = int(Nsize[sel].max() // 2)
            B = gcm.pick_block_size(N, max(half, 4))
            t0 = self._stage_t0()
            blocks = self._grid_dense(bi, B, sel, arrs, (half + 1) * res,
                                      eps * R_com[sel] * arrs['qfac'][sel],
                                      dt)
            self._stage(f"reg[b{bi} B{B}->{blocks[-1]} H{len(sel)}]", t0,
                        blocks[1])
            yield bi, sel, half, (B,) + blocks

    def _census_entry(self, label, bi, sel, B, B_eff, K, n_hi):
        """Print a bucket's line (``verbose``); where ``self.census`` is a
        list, append the bucket's census dict to it and return it (the
        pass fills its counts), else None."""
        F = B_eff ** (2 if self.GriddedMap.is2D else 3)
        if self.verbose:
            print(f"{label}: bucket {bi + 1} ({len(sel)} halos, "
                  f"B={B}->{B_eff}, K={K}, F={F}, n_hi={n_hi})")
        if getattr(self, 'census', None) is None:
            return None
        census = dict(bucket=bi, H=len(sel), B=B, B_eff=B_eff, K=K, F=F,
                      n_hi=n_hi, slots=0, inside=0, steps=0)
        self.census.append(census)
        return census

    def _cellmajor_buckets(self, gm, arrs, R_com, Nsize, idx_all, grids,
                           table_z, mode, planes, label):
        """The cell-major pass of every bucket, added to the row-major
        ``planes`` (in place). ``table_z`` is the z-blended table with
        finite nodes only. Stages: packed_records, then reg[...] and
        pass[...] a bucket. A list in ``self.census`` gets each bucket's
        counts (see ``grid_cellmajor._bucket_pass``; for measurement only:
        it synchronises once a step). With a mesh each rank adds its own
        blocks' output only."""
        dt = self.dtype
        dim = 2 if gm.is2D else 3
        N, res = gm.Npix, gm.res
        eps = float(self.epsilon_max)
        g2_np = self.model._grids[2].cpu().numpy()
        # the radial grid's nodes as the hot dtype holds them
        g_hot = g2_np.astype(str(dt).split('.')[-1])
        g0, dg = float(g_hot[0]), float(g_hot[1] - g_hot[0])
        p0 = gcm.PROP_COL0_2D if gm.is2D else gcm.PROP_COL0_3D
        n_props = len(grids) - 3
        lnM_col = 3 if gm.is2D else 4
        t0 = self._stage_t0()
        packed = self._grid_packed(arrs, R_com, dt)
        self._stage("packed_records", t0, packed)
        for bi, sel, half, (B, dense, counts, counts_host, K, B_eff) in \
                self._block_buckets(arrs, R_com, Nsize, idx_all, dt):
            rad_max = (np.log(eps) if mode == "offsets_rdelta"
                       else np.log(eps * R_com[sel].max()))
            n_hi = self._node_bound(g2_np, rad_max, len(g2_np))
            census = self._census_entry(label, bi, sel, B, B_eff, K, n_hi)
            t0 = self._stage_t0()
            pk = packed[torch.as_tensor(sel, device=self.device)]
            rows = gcm.halo_rows(grids[1], grids[3:], table_z, pk[:, lnM_col],
                                 pk[:, p0:p0 + n_props], n_hi)
            # the bucket's block-major planes: the plain pass, or, where
            # the rows carry a graph, its Function with the step-wise
            # adjoint
            args = (dim, B_eff, n_hi, N, half, dense, counts, counts_host,
                    pk, rows, g0, dg, float(g_hot[n_hi - 1]), eps, res)
            if self.mesh is None:
                out_bm = gcm.grid_pass_diff(mode, *args, census=census)
                inv = self._grid_inv_perm(N, B_eff)
                for p, o in zip(planes, out_bm):
                    _permute_add(p, o, inv)
            else:
                if mode == "paint":
                    start, out_bm = mesh_grid_paint_bucket(
                        self.mesh, self.mesh_axis, *args, census=census)
                else:
                    start, out_bm = mesh_grid_offsets_bucket(
                        self.mesh, self.mesh_axis, mode == "offsets_rdelta",
                        *args, census=census)
                perm = self._grid_perms(N, B_eff)[0]
                _place_add(planes, out_bm, perm, start)
            self._stage(f"pass[b{bi} B{B_eff} K{K} n_hi{n_hi}]", t0,
                        planes[0])
        return planes

    def _windowed(self, gm, a, arrs, R_com, Nsize, idx_all, grids, table,
                  use_rdelta, planes, label):
        """The scatter method: the bucketed windowed cutouts of every halo
        in ``idx_all``, one scatter-add a chunk into ``planes`` (the dim
        offset planes, or one paint plane when ``use_rdelta`` is None)."""
        dt = self.dtype
        paint = use_rdelta is None
        bins = np.asarray(gm.bins, dtype=np.float64)
        n_props = len(grids) - 3
        for bi, idx in enumerate(_nsize_buckets(Nsize[idx_all],
                                                self.n_buckets)):
            sel = idx_all[idx]
            half = int(Nsize[sel].max() // 2)
            chunk = min(self.halo_chunk, len(sel))
            if self.verbose:
                print(f"{label}: bucket {bi + 1} ({len(sel)} halos, window "
                      f"{2 * half}, chunk {chunk})")
            cols = {k: self._tensor(arrs[k][sel], dt)
                    for k in ('M', 'Rmat', 'props') if k in arrs}
            cols['R'] = self._tensor(R_com[sel], dt)
            # per axis each halo's nearest bin and its offset from that
            # bin's centre, taken in float64 (see grid_cellmajor)
            axes = [k for k in ('x', 'y', 'z') if k in arrs]
            for k in axes:
                cen = self._nearest_bins(arrs[k][sel])
                cols['cen' + k] = torch.as_tensor(cen, device=self.device)
                cols['off' + k] = self._tensor(bins[cen] - arrs[k][sel], dt)
            for c0 in range(0, len(sel), chunk):
                c = {k: v[c0:c0 + chunk] for k, v in cols.items()}
                args = (gm.Npix, half, n_props, gm.is2D, grids, table,
                        float(self.epsilon_max), a, gm.res,
                        [(c['cen' + k], c['off' + k]) for k in axes],
                        c['M'], c['R'], c['Rmat'], c['props'], planes)
                if paint:
                    _accumulate_grid_paint(*args)
                else:
                    _accumulate_grid_offsets(*args, use_rdelta=use_rdelta)
        return planes

    def _prepare(self, table):
        """(cosmology, grids and table in the hot dtype) on the device."""
        dev, dt = resolve_device(self.device), self.dtype
        cosmo = Cosmology.from_dict(self.cosmo, device=dev)
        grids = tuple(g.to(device=dev, dtype=dt) for g in self.model._grids)
        return cosmo, grids, table.to(device=dev, dtype=dt)


def _cutout_coords(cen, off, half, res, Npix):
    """Periodic cutout indices and each cell's coordinate relative to the
    halo, along one axis, for a batch of halos with nearest bins ``cen``
    and offsets ``off`` (bin centre less halo): ((H, 2 half) int64,
    (H, 2 half)). The cutout starts half cells below the nearest bin."""
    ar = torch.arange(2 * half, device=cen.device) - half
    inds = torch.remainder(cen[:, None] + ar, Npix)
    return inds, ar.to(off.dtype) * res + off[:, None]


def _window_geometry(Npix, half, is2D, res, axes, Rmats):
    """Flat cell ids, circular offsets (gx, gy[, gz]) and the readout
    radius (elliptical in 2D) of every cutout cell of a chunk of halos,
    each (H, W^d); ``axes`` holds per axis the halos' (nearest bins,
    offsets from them)."""
    H = axes[0][0].shape[0]
    xi, rx = _cutout_coords(*axes[0], half, res, Npix)
    yi, ry = _cutout_coords(*axes[1], half, res, Npix)
    if is2D:
        # rows vary x, columns y; the flat id follows the map's [x, y]
        gx, gy = rx[:, :, None], ry[:, None, :]
        ex = Rmats[:, 0, 0, None, None] * gx + Rmats[:, 1, 0, None, None] * gy
        ey = Rmats[:, 0, 1, None, None] * gx + Rmats[:, 1, 1, None, None] * gy
        r = torch.sqrt(ex * ex + ey * ey)
        flat = xi[:, :, None] * Npix + yi[:, None, :]
        g = (gx, gy)
    else:
        zi, rz = _cutout_coords(*axes[2], half, res, Npix)
        gx, gy, gz = rx[:, :, None, None], ry[:, None, :, None], \
            rz[:, None, None, :]
        r = torch.sqrt(gx * gx + gy * gy + gz * gz)
        flat = (xi[:, :, None, None] * Npix * Npix
                + yi[:, None, :, None] * Npix + zi[:, None, None, :])
        g = (gx, gy, gz)
    shape = r.shape
    return (flat.reshape(H, -1),
            tuple(c.expand(shape).reshape(H, -1) for c in g),
            r.reshape(H, -1))


def _halo_profiles(grids, table, a_scale, Ms, props, n_props):
    """(H, Nr) radial rows of a chunk's halos at (ln(1/a), ln M,
    props...)."""
    lnz = torch.full_like(Ms, float(np.log(1.0 / a_scale)))
    return blend_table_radial(grids, table, [lnz, torch.log(Ms)] + [
        props[:, j] for j in range(n_props)])


def _accumulate_grid_offsets(Npix, half, n_props, is2D, grids, table,
                             eps_max, a_scale, res, axes, Ms, Rs, Rmats,
                             props, offsets, use_rdelta=False):
    """Add the displacement offsets (pixel units) of one chunk of halos to
    the row-major ``offsets`` planes (in place): each halo's cutout read
    at the (elliptical) radius (over R_com with ``use_rdelta``), pushed
    along the circular unit vector."""
    flat, g, r = _window_geometry(Npix, half, is2D, res, axes, Rmats)
    lnr = torch.log(torch.clamp(r, min=1e-30))
    rad = lnr - torch.log(Rs)[:, None] if use_rdelta else lnr
    prof = _halo_profiles(grids, table, a_scale, Ms, props, n_props)
    d = radial_readout(prof, grids[2], rad)
    d = torch.where(r < eps_max * Rs[:, None], d, 0.0)
    d = torch.where(torch.isfinite(d), d, 0.0) / res
    r_c = torch.sqrt(sum(c * c for c in g)) if is2D else r
    r_c = torch.clamp(r_c, min=1e-30)
    return scatter_add_accum(offsets, flat.reshape(-1).to(torch.int32),
                             tuple((d * (c / r_c)).reshape(-1) for c in g))


def _accumulate_grid_paint(Npix, half, n_props, is2D, grids, table, eps_max,
                           a_scale, res, axes, Ms, Rs, Rmats, props,
                           new_map):
    """Add the tabulated profile of one chunk of halos to ``new_map``
    (a one-plane tuple, in place); readouts that are not finite paint
    nothing."""
    flat, _, r = _window_geometry(Npix, half, is2D, res, axes, Rmats)
    prof = _halo_profiles(grids, table, a_scale, Ms, props, n_props)
    paint = torch.exp(radial_readout(prof, grids[2],
                                     torch.log(torch.clamp(r, min=1e-30))))
    paint = torch.where((r < eps_max * Rs[:, None]) & torch.isfinite(paint),
                        paint, 0.0)
    return scatter_add_accum(new_map, flat.reshape(-1).to(torch.int32),
                             (paint.reshape(-1),))


def _nsize_buckets(Nsizes, n_buckets):
    order = np.argsort(Nsizes)
    return [s for s in np.array_split(order, n_buckets) if s.size > 0]


def _permute_add(acc_rm, plane_bm, inv):
    """acc_rm[i] += plane_bm[inv[i]]: unsort one bucket's block-major
    output into the row-major accumulator (in place)."""
    return acc_rm.add_(plane_bm[inv])


def _place_add(planes_rm, share_bm, perm, start):
    """Add a rank's block-major share (its elements from block-major
    position ``start`` on) into the row-major accumulators (in place;
    ``perm`` maps block-major positions to row-major ids, so each target
    is hit once)."""
    for p, o in zip(planes_rm, share_bm):
        p.index_add_(0, perm[start:start + o.shape[0]], o)


class BaryonifyGrid(DefaultRunnerGrid):
    """Baryonify a 2D/3D mass grid. The input grid must be a MASS grid
    (empty cells = 0)."""

    def _device_map(self, table):
        """The baryonified map of ``table`` on the device, in the hot
        dtype, (N,)*dim: the offsets of every bucket (either method), then
        the CIC redeposit of the original map."""
        model = self.model
        gm = self.GriddedMap
        cosmo, grids, table = self._prepare(table)
        dt, dev = self.dtype, cosmo.device
        t0 = self._stage_t0()
        a, arrs = self._halo_arrays(cosmo, comoving_R=False)
        self._stage("halo_arrays", t0)
        # query radius in comoving Mpc, clipped to half the box
        R_q = np.clip(self.epsilon_max * arrs['R'] / a, 0,
                      np.max(gm.bins) / 2)
        Nsize = (2 * R_q / gm.res).astype(np.int64) // 2 * 2
        idx_all = np.where(Nsize >= 2)[0]       # tiny halos move nothing
        use_rdelta = bool(getattr(model, 'Rdelta_sampling', False))
        dim = 2 if gm.is2D else 3
        R_com = arrs['R'] / a                   # table masking radius
        offsets = tuple(torch.zeros(gm.Npix ** dim, dtype=dt, device=dev)
                        for _ in range(dim))
        if self.mesh is not None:
            table = mesh_grad_sum(self.mesh, self.mesh_axis, table)
        if self.method == "cellmajor":
            self._check_gcaches()
            table_z, inb_z = gcm.blend_table_z(
                table, grids[0], float(np.log(1.0 / a)))
            if inb_z and idx_all.size:
                self._cellmajor_buckets(
                    gm, arrs, R_com, Nsize, idx_all, grids,
                    torch.where(torch.isfinite(table_z), table_z, 0.0),
                    "offsets_rdelta" if use_rdelta else "offsets", offsets,
                    "Baryonifying matter")
            if self.mesh is not None:
                # each rank deposits its own range of cells in the CIC, at
                # offsets from every rank's blocks
                t0 = self._stage_t0()
                offsets = tuple(mesh_sum(self.mesh, self.mesh_axis, o,
                                         replicated=False) for o in offsets)
                self._stage("join", t0, offsets[0])
        else:
            t0 = self._stage_t0()
            self._windowed(gm, a, arrs, R_com, Nsize, idx_all, grids, table,
                           use_rdelta, offsets, "Baryonifying matter")
            self._stage("pass", t0, offsets[0])
        t0 = self._stage_t0()
        offsets = tuple(torch.where(torch.isfinite(o), o, 0.0)
                        for o in offsets)
        orig = self._tensor(np.asarray(gm.map, dtype=np.float64).reshape(-1),
                            dt)
        if self.mesh is None:
            new_map = self._cic_offsets(gm, offsets, orig, dt)
        else:
            new_map = mesh_grid_cic(self.mesh, self.mesh_axis, gm.Npix, orig,
                                    offsets).reshape((gm.Npix,) * dim)
        self._stage("cic", t0, new_map)
        return new_map

    def process(self):
        model = self.model
        if not hasattr(model, '_table'):
            raise NameError("Displacement model has no table. Run "
                            "setup_interpolator() first")
        orig_map = np.asarray(self.GriddedMap.map, dtype=np.float64)
        if self.HaloNDCatalog.cat.size == 0:
            # an empty catalog leaves the map untouched
            return orig_map.copy()
        new_map = self._device_map(model._table)
        t0 = self._stage_t0()
        new_map = new_map.to(torch.float64).cpu().numpy()
        self._stage("fetch_map", t0)
        new_sum, old_sum = new_map.sum(), orig_map.sum()
        assert np.isclose(new_sum, old_sum), (
            "ERROR in pixel regridding, sum(new_map) [%0.14e] != "
            "sum(oldmap) [%0.14e]" % (new_sum, old_sum))
        return new_map

    def process_device(self, table=None):
        """Differentiable baryonification (the port of the JAX package's
        ``BaryonifyGrid.process_device``), both methods, 2D and 3D.

        Runs the computation of :meth:`process` and returns the new map
        as a tensor on the device, in the hot-path dtype and of the map's
        shape, with no host copy and no conservation check. ``table``
        (default ``model._table``) may carry a graph (e.g. from
        ``build_table_device`` of parameters that require grad):
        gradients flow from any scalar of the map through the CIC
        redeposit (the scatter-add's backward, a kernel on the card, and
        the CIC weights' derivative in the offsets), then through the
        cell-major passes (``grid_cellmajor.grid_pass_diff``: the
        ``grid_vjp`` kernel on the card, a step-wise recomputed adjoint
        on the CPU) or the windowed scatters, and the row blend into the
        table. The geometry (registration,
        candidates, packed records, CIC coordinate planes) depends only on
        halo positions and the epsilon_max * R reach: it is staged once in
        the runner's caches and held constant, so a fit registers only on
        its first call. The values equal :meth:`process`'s: bit for bit
        on the CPU; on the card up to the order in which the CIC's atomic
        adds land (rounding)."""
        model = self.model
        if table is None:
            if not hasattr(model, '_table'):
                raise NameError("Displacement model has no table. Run "
                                "setup_interpolator() first")
            table = model._table
        gm = self.GriddedMap
        if self.HaloNDCatalog.cat.size == 0:
            return self._tensor(np.asarray(gm.map, dtype=np.float64),
                                self.dtype)
        return self._device_map(table)


class PaintProfilesGrid(DefaultRunnerGrid):
    """Paint profiles onto a 2D/3D grid: 2D grids read the projected
    table (``_ln2D``), 3D grids the real-space one (``_ln3D``).
    ``process()`` returns the painted-only map (float64 numpy)."""

    def _table_attr(self):
        model = self.model
        p_keys = getattr(model, 'p_keys', []) or []
        if len(p_keys) > 0:
            from ..tabulate import ParamTabulatedProfile
            assert isinstance(model, ParamTabulatedProfile), (
                f"You asked to use {p_keys} properties in painting. You "
                f"must pass a ParamTabulatedProfile as the model.")
        attr = '_ln2D' if self.GriddedMap.is2D else '_ln3D'
        if not hasattr(model, attr):
            raise NameError(
                "PaintProfilesGrid requires a tabulated model "
                "(TabulatedProfile / ParamTabulatedProfile).")
        return attr

    def _device_map(self, table):
        """The painted map of the log-profile ``table`` on the device, in
        the hot dtype, (N,)*dim."""
        gm = self.GriddedMap
        dim = 2 if gm.is2D else 3
        cosmo, grids, table = self._prepare(table)
        dt, dev = self.dtype, cosmo.device
        t0 = self._stage_t0()
        a, arrs = self._halo_arrays(cosmo, comoving_R=True)
        self._stage("halo_arrays", t0)
        R_com = arrs['R']
        Nsize = (2 * self.epsilon_max * R_com / gm.res).astype(np.int64)
        Nsize = np.clip(Nsize // 2 * 2, 2, len(gm.bins) // 2)
        idx_all = np.arange(len(R_com))
        new_map = torch.zeros(gm.Npix ** dim, dtype=dt, device=dev)
        if self.mesh is not None:
            table = mesh_grad_sum(self.mesh, self.mesh_axis, table)
        if self.method == "cellmajor":
            self._check_gcaches()
            table_z, inb_z = gcm.blend_table_z(
                table, grids[0], float(np.log(1.0 / a)))
            if inb_z:
                # log-profile tables carry -inf where the profile is 0: a
                # large negative finite stand-in keeps the blend NaN-free
                # and still paints exp(...) = 0 there
                self._cellmajor_buckets(
                    gm, arrs, R_com, Nsize, idx_all, grids,
                    torch.where(torch.isfinite(table_z), table_z, -1e30),
                    "paint", (new_map,), "Painting Profile")
            if self.mesh is not None:
                new_map = mesh_sum(self.mesh, self.mesh_axis, new_map)
        else:
            t0 = self._stage_t0()
            self._windowed(gm, a, arrs, R_com, Nsize, idx_all, grids, table,
                           None, (new_map,), "Painting Profile")
            self._stage("pass", t0, new_map)
        return new_map.reshape((gm.Npix,) * dim)

    def process(self):
        gm = self.GriddedMap
        attr = self._table_attr()
        shape = (gm.Npix,) * (2 if gm.is2D else 3)
        if self.HaloNDCatalog.cat.size == 0:
            # an empty catalog paints nothing
            return np.zeros(shape, dtype=np.float64)
        new_map = self._device_map(getattr(self.model, attr))
        t0 = self._stage_t0()
        out = new_map.to(torch.float64).cpu().numpy()
        self._stage("fetch_map", t0)
        return out

    def process_device(self, table=None):
        """Differentiable painting (the port of the JAX package's
        ``PaintProfilesGrid.process_device``), both methods, 2D and 3D:
        the painted map as a tensor on the device, in the hot-path dtype
        and of the map's shape. ``table`` (default ``model._ln2D`` for 2D
        maps, ``_ln3D`` for 3D: the LOG profile table) may carry a graph,
        e.g. from ``TabulatedProfile.build_tables_device``; gradients flow
        through the paint mode of the cell-major pass's adjoint or the
        windowed scatters. Geometry is staged in the runner's caches and
        held constant, as in :meth:`BaryonifyGrid.process_device`; the
        values equal :meth:`process`'s bit for bit (on the card, the
        scatter method's up to the order of its atomic adds)."""
        gm = self.GriddedMap
        if table is None:
            table = getattr(self.model, self._table_attr())
        if self.HaloNDCatalog.cat.size == 0:
            return torch.zeros((gm.Npix,) * (2 if gm.is2D else 3),
                               dtype=self.dtype,
                               device=resolve_device(self.device))
        return self._device_map(table)


def _remap_rows(lnP, lnC, good, lnq):
    """Remap rows of R curves (R, Nb) of ln Paint and ln Canvas taken at
    the same radii, ``good`` (R, Nb) marking the valid points: (R, Nq + 2)
    ln Paint at the (Nq,) ``lnq`` over each curve's valid points sorted by
    ln Canvas (the queries clipped to the curve's range, so the ends are
    clamped), then the curve's canvas range lo and hi. A curve with fewer
    than two valid points gets sentinels: rows of -1e30, lo = 1e30 and hi
    = -1e30, an empty range. Masked points sort past every valid one (1e15
    + j; the sort is stable), and exact ties among the sorted points are
    broken by steps of 1e-12, so the interpolation never divides by 0 and
    its gradient stays finite. Differentiable in lnP and lnC."""
    j = torch.arange(lnC.shape[-1], dtype=lnC.dtype, device=lnC.device)
    xs, s = torch.sort(torch.where(good, lnC, 1e15 + j), dim=-1, stable=True)
    tie = torch.cat([torch.zeros_like(xs[:, :1], dtype=torch.bool),
                     xs[:, 1:] <= xs[:, :-1]], dim=-1)
    xs = xs + torch.cumsum(tie.to(xs.dtype), dim=-1) * 1e-12
    ys = torch.gather(torch.where(good, lnP, 0.0), -1, s)
    lo = torch.where(good, lnC, 1e30).amin(dim=-1)
    hi = torch.where(good, lnC, -1e30).amax(dim=-1)
    q = torch.minimum(torch.maximum(lnq, lo[:, None]), hi[:, None])
    ok = good.sum(dim=-1) >= 2
    return torch.cat([torch.where(ok[:, None], interp_rows(q, xs, ys), -1e30),
                      torch.where(ok, lo, 1e30)[:, None],
                      torch.where(ok, hi, -1e30)[:, None]], dim=-1)


class PaintProfilesAnisGrid(DefaultRunnerGrid):
    """Density-dependent painting on a 2D map: for each halo, the radial
    (Paint, Canvas) profile pair gives a monotone Canvas -> Paint mapping,
    read at the existing map values inside the halo's cutout, so the map
    is painted y(delta) in place of y(r). 2D only.

    - ``method="scatter"`` (what ``"auto"`` takes on the CPU): the
      reference's loop over halos, one at a time: the exact profile pair
      on the halo's own radius grid (``Nbin_interp`` points) and a
      log-log interpolation read on its cutout, NaN (painting nothing)
      outside the pair's canvas range; each halo's cutout is added by the
      scatter-add (the kernel on the card). Where a cutout wraps past the
      map (2 half > N) the reference's ``new_map[flat] +=`` keeps one of
      the repeated pixels' writes; here each adds.
    - ``method="cellmajor"`` (``"auto"`` on the card): the remap ln
      Paint(ln Canvas) is tabulated once per (M [, prop...]) node on a
      uniform grid of ``Nq_interp`` ln Canvas values at the catalog
      redshift, then one block-major pass a bucket reads it, blended at
      each halo's mass and props, at the log of the canvas value
      (``grid_cellmajor.grid_anis_paint_pass_2d``). The cutout window is
      clipped to the map.

    ``process_device(remap=None, canvas=None)`` is the cell-major method
    as a differentiable function of the remap table (e.g. from
    :meth:`build_remap_device` of tables that carry a graph) and of the
    canvas map (e.g. ``BaryonifyGrid.process_device``'s output).
    """

    def __init__(self, HaloNDCatalog, GriddedMap, epsilon_max,
                 Painting_model=None, Canvas_model=None, Nbin_interp=1000,
                 Nq_interp=96, mass_def=None, verbose=True, halo_chunk=64,
                 n_buckets=8, precision="auto", method="auto", mesh=None,
                 mesh_axis=None, *, device="cuda"):
        super().__init__(HaloNDCatalog, GriddedMap, epsilon_max,
                         Painting_model, mass_def=mass_def, verbose=verbose,
                         halo_chunk=halo_chunk, n_buckets=n_buckets,
                         precision=precision, method=method, mesh=mesh,
                         mesh_axis=mesh_axis, device=device)
        self.Canvas_model = Canvas_model
        self.Nbin_interp = Nbin_interp
        self.Nq_interp = Nq_interp

    # ----- the remap table -----
    def _node_radii(self, cosmo, a, M_nodes):
        """(NM, Nbin_interp) radii of each node: the loop's radius domain
        for a halo of that mass, [1e-6, sqrt(2) half res] with half its
        cutout half-window (at least 1)."""
        gm = self.GriddedMap
        R = self.mass_def.get_radius(cosmo, torch.as_tensor(
            M_nodes, dtype=torch.float64, device=cosmo.device), a)
        R = np.atleast_1d(R.cpu().numpy()) / a
        Nsize = (2 * self.epsilon_max * R / gm.res).astype(np.int64) // 2 * 2
        r_hi = np.sqrt(2.0) * np.maximum(Nsize // 2, 1) * gm.res
        return np.stack([np.geomspace(1e-6, max(h, 2e-6), self.Nbin_interp)
                         for h in r_hi])

    def _profile_pair(self, cosmo, r, M, a, props):
        """The (Paint, Canvas) projected profiles at the float64 numpy
        radii ``r`` of one mass, on the runner's device. A tabulated model
        reads its tables with the cosmology they were built with (on
        their device), any other model computes with the runner's."""
        out = []
        for m in (self.model, self.Canvas_model):
            mc = m.cosmo if hasattr(m, '_grids') else cosmo
            prof = m.projected(mc, torch.as_tensor(
                r, dtype=torch.float64, device=mc.device), M, a, **props)
            out.append(prof.to(cosmo.device))
        return out

    def _anis_remap_table(self, cosmo, a):
        """Cached :meth:`_anis_remap_table_impl`: the remap depends only on
        the models, a, epsilon_max, the grid and the interpolation sizes,
        all fixed for the runner's lifetime. Cleared on a catalog swap
        (the mass nodes of an untabulated model come from the catalog)."""
        gm = self.GriddedMap
        key = (id(self.model), id(self.Canvas_model), float(a),
               float(self.epsilon_max), float(gm.res), gm.Npix,
               float(np.asarray(gm.bins)[0]), self.Nq_interp,
               self.Nbin_interp)
        self._check_gcaches()
        cached = getattr(self, '_anis_remap_cache', None)
        if cached is None or cached[0] != key:
            self._anis_remap_cache = (key, self._anis_remap_table_impl(
                cosmo, a))
        return self._anis_remap_cache[1]

    def _anis_remap_table_impl(self, cosmo, a):
        """ln Paint on a uniform ln Canvas grid, per (M [, prop...]) node,
        in float64 on the runner's device.

        Each node's (Paint, Canvas) pair is evaluated on the radius domain
        the loop uses for a halo of the node's mass (:meth:`_node_radii`),
        so its valid canvas range is the loop's interpolation domain. The
        range rides in two extra rows (Nq, Nq + 1) that the pass blends
        with the profile rows. Returns (lnq (Nq,) numpy, gM (NM,) numpy,
        the prop grids (numpy), remap (NM, Nq + 2 [, P...]) tensor);
        degenerate nodes carry the sentinels of :func:`_remap_rows`."""
        Paint = self.model
        p_keys = getattr(Paint, 'p_keys', []) or []
        if p_keys:
            from ..tabulate import ParamTabulatedProfile
            assert isinstance(Paint, ParamTabulatedProfile), (
                "per-halo properties on the cell-major anis path need a "
                "ParamTabulatedProfile Painting_model (its prop grids "
                "define the table axes)")
            assert len(p_keys) <= gcm.MAX_PROPS_ANIS_2D, (
                f"the cell-major anis path fits at most "
                f"{gcm.MAX_PROPS_ANIS_2D} extra parameter axes (the last "
                f"packed column carries the per-halo window half); got "
                f"{len(p_keys)} - use method='scatter'")
            gprops = tuple(g.cpu().numpy().astype(np.float64)
                           for g in Paint._grids[3:])
        else:
            gprops = ()
        if hasattr(Paint, '_grids'):
            gM = Paint._grids[1].cpu().numpy().astype(np.float64)
        else:
            lnM = np.log(self.HaloNDCatalog.cat['M'].astype(np.float64))
            pad = max(0.05 * (lnM.max() - lnM.min()), 1e-3)
            gM = np.linspace(lnM.min() - pad, lnM.max() + pad, 33)
        M_nodes = np.exp(gM)
        r_nodes = self._node_radii(cosmo, a, M_nodes)
        combos = list(product(*[range(len(g)) for g in gprops]))
        pairs = [self._profile_pair(cosmo, r, float(M_i), a, {
            k: float(gprops[i][combo[i]]) for i, k in enumerate(p_keys)})
            for M_i, r in zip(M_nodes, r_nodes) for combo in combos]
        P, C = (torch.stack(x) for x in zip(*pairs))
        good = torch.isfinite(P) & torch.isfinite(C) & (P > 0) & (C > 0)
        if not bool(good.any()):
            raise ValueError("anis remap: no valid (Paint, Canvas) profile "
                             "points at any table node")
        lnP = torch.log(torch.where(good, P, 1.0))
        lnC = torch.log(torch.where(good, C, 1.0))
        lnq = np.linspace(float(lnC[good].min()), float(lnC[good].max()),
                          self.Nq_interp)
        rows = _remap_rows(lnP, lnC, good, torch.as_tensor(
            lnq, dtype=torch.float64, device=cosmo.device))
        NM, Q = len(M_nodes), self.Nq_interp + 2
        remap = rows.reshape(NM, len(combos), Q).transpose(1, 2).reshape(
            (NM, Q) + tuple(len(g) for g in gprops))
        return lnq, gM, gprops, remap

    def build_remap_device(self, paint_table=None, canvas_table=None):
        """The remap table of :meth:`_anis_remap_table_impl` as a
        differentiable function of the models' projected log tables
        (``paint_table`` / ``canvas_table``, default ``._ln2D``), which
        may carry a graph, e.g. from ``TabulatedProfile.
        build_tables_device`` of parameters that require grad: gradients
        then flow from profile parameters through the tables and the remap
        into the map of :meth:`process_device`. TabulatedProfile models
        only (no extra parameter axes).

        Node for node the host build's: the same radius domains, lnq
        grid and mass nodes (taken from it), the same valid points (a
        positive exp of the log readouts; radii off the table read NaN and
        drop out), the same clamped resampling and sentinels
        (:func:`_remap_rows`, all nodes at once). Returns the (NM, Nq + 2)
        remap in float64 on the runner's device."""
        Paint, Canvas = self.model, self.Canvas_model
        assert not (getattr(Paint, 'p_keys', []) or []), (
            "build_remap_device supports TabulatedProfile models only (no "
            "extra parameter axes); per-halo-property remaps use the host "
            "build")
        for m, name in ((Paint, "Painting_model"), (Canvas, "Canvas_model")):
            if not hasattr(m, '_grids'):
                raise NameError(f"{name} has no table - run "
                                "setup_interpolator() first")
        dev = resolve_device(self.device)
        f64 = dict(dtype=torch.float64, device=dev)
        cosmo = Cosmology.from_dict(self.cosmo, device=dev)
        a = 1.0 / (1.0 + self.HaloNDCatalog.redshift)
        lnq, gM, _, _ = self._anis_remap_table(cosmo, a)
        lnr = torch.as_tensor(np.log(self._node_radii(cosmo, a, np.exp(gM))),
                              **f64)
        coords = (torch.full_like(lnr, float(np.log(1.0 / a))),
                  torch.as_tensor(gM, **f64)[:, None], lnr)
        ln = []
        for m, tab in ((Paint, paint_table), (Canvas, canvas_table)):
            tab = (m._ln2D if tab is None else tab).to(**f64)
            # non-finite nodes -> an inert finite stand-in (exp -> 0), so
            # the readout and its gradient stay NaN-free
            tab = torch.where(torch.isfinite(tab), tab, -1e30)
            ln.append(ndlinear_interp(tuple(g.to(**f64) for g in m._grids),
                                      tab, coords))
        good = (torch.exp(ln[0]) > 0.0) & (torch.exp(ln[1]) > 0.0)
        return _remap_rows(ln[0], ln[1], good, torch.as_tensor(lnq, **f64))

    # ----- the two methods -----
    def _anis_setup(self):
        """(cosmology, a, the halo arrays, Nsize) of a call, or None for an
        empty catalog; checks the map and the models."""
        gm = self.GriddedMap
        assert gm.is2D, ("Can only paint tSZ on 2D maps. You have passed a "
                         "3D Map")
        assert (list(getattr(self.model, 'p_keys', []) or [])
                == list(getattr(self.Canvas_model, 'p_keys', []) or []))
        if self.HaloNDCatalog.cat.size == 0:
            return None
        cosmo = Cosmology.from_dict(self.cosmo,
                                    device=resolve_device(self.device))
        t0 = self._stage_t0()
        a, arrs = self._halo_arrays(cosmo, comoving_R=True)
        self._stage("halo_arrays", t0)
        Nsize = (2 * self.epsilon_max * arrs['R'] / gm.res).astype(np.int64)
        return cosmo, a, arrs, Nsize // 2 * 2

    def _paint_anis_cellmajor(self, cosmo, a, arrs, Nsize, remap=None,
                              canvas=None):
        """The cell-major paint of the halos with ``Nsize`` >= 2, their
        cutout windows clipped to the map, as a device tensor (N, N) in the
        hot dtype, differentiable in ``remap`` (default: the host build's)
        and ``canvas`` (default: the map). The lnq grid, mass nodes and
        prop grids are always the host build's. Stages: remap, packed_records, then reg[...] and
        pass[...] a bucket. A list in ``self.census`` gets each bucket's
        counts (for measurement only)."""
        gm = self.GriddedMap
        dt, dev = self.dtype, cosmo.device
        N, res = gm.Npix, gm.res
        eps = float(self.epsilon_max)
        R_com = arrs['R']
        t0 = self._stage_t0()
        lnq, gM, gprops, remap_host = self._anis_remap_table(cosmo, a)
        self._stage("remap", t0, remap_host)
        n_hi = self.Nq_interp
        # the canvas grid's nodes as the hot dtype holds them
        q_hot = lnq.astype(str(dt).split('.')[-1])
        q0, dq = float(q_hot[0]), float(q_hot[1] - q_hot[0])
        table_q = (remap_host if remap is None else remap).to(device=dev,
                                                              dtype=dt)
        table_q = torch.where(torch.isfinite(table_q), table_q, -1e30)
        mesh = self.mesh
        gM_t = self._tensor(gM, dt)
        gprops_t = tuple(self._tensor(g, dt) for g in gprops)
        p0 = gcm.PROP_COL0_2D
        t0 = self._stage_t0()
        packed = self._grid_packed(arrs, R_com, dt)
        self._stage("packed_records", t0, packed)
        canvas_rm = (self._tensor(np.asarray(gm.map, dtype=np.float64)
                                  .reshape(-1), dt) if canvas is None
                     else canvas.reshape(-1).to(device=dev, dtype=dt))
        if mesh is not None:
            table_q, canvas_rm = (mesh_grad_sum(mesh, self.mesh_axis, x)
                                  for x in (table_q, canvas_rm))
        new_map = torch.zeros(N * N, dtype=dt, device=dev)
        Nsize = np.clip(Nsize, 0, N)
        for bi, sel, _, (B, dense, counts, counts_host, K, B_eff) in \
                self._block_buckets(arrs, R_com, Nsize,
                                    np.where(Nsize >= 2)[0], dt):
            census = self._census_entry("Anis Painting", bi, sel, B, B_eff,
                                        K, n_hi)
            t0 = self._stage_t0()
            pk = packed[torch.as_tensor(sel, device=dev)]
            # each halo's own cutout half-window: a shared bucket window
            # would paint outside the smaller halos' cutouts
            pk[:, gcm.ANIS_HALF_COL_2D] = self._tensor(Nsize[sel] // 2, dt)
            rows = gcm.halo_rows(gM_t, gprops_t, table_q, pk[:, 3],
                                 pk[:, p0:p0 + len(gprops_t)], n_hi + 2)
            # halos off the mass (or prop) grid have no row: they paint
            # nothing, and a finite stand-in keeps the gradients NaN-free
            live_h = torch.isfinite(rows).all(dim=1)
            rows = torch.where(live_h[:, None], rows, 0.0)
            perm, inv = self._grid_perms(N, B_eff)
            args = (B_eff, n_hi, N, dense, counts, counts_host, pk, rows,
                    live_h, q0, dq, eps, res, canvas_rm[perm])
            if mesh is None:
                (out_bm,) = gcm.grid_anis_paint_pass_2d(*args, census=census)
                _permute_add(new_map, out_bm, inv)
            else:
                start, out_bm = mesh_grid_anis_paint_bucket(
                    mesh, self.mesh_axis, *args, census=census)
                _place_add((new_map,), out_bm, perm, start)
            self._stage(f"pass[b{bi} B{B_eff} K{K} n_hi{n_hi}]", t0, new_map)
        if mesh is not None:
            new_map = mesh_sum(mesh, self.mesh_axis, new_map)
        return new_map.reshape(N, N)

    def _paint_anis_loop(self, cosmo, a, arrs, Nsize):
        """The reference's loop over halos (float64, on the runner's
        device): a flat (N^2,) map."""
        gm = self.GriddedMap
        N, res = gm.Npix, gm.res
        dev = cosmo.device
        f64 = dict(dtype=torch.float64, device=dev)
        cat = self.HaloNDCatalog.cat
        p_keys = getattr(self.model, 'p_keys', []) or []
        R_com = arrs['R']
        orig = torch.as_tensor(np.asarray(gm.map, dtype=np.float64)
                               .reshape(-1), **f64)
        new_map = torch.zeros_like(orig)
        cen_x, cen_y = (self._nearest_bins(arrs[c]) for c in ('x', 'y'))
        for j in np.where(Nsize >= 2)[0]:
            half = int(Nsize[j] // 2)
            ar = np.arange(2 * half)
            x_inds = np.mod(ar + cen_x[j] - half, N)
            y_inds = np.mod(ar + cen_y[j] - half, N)
            xx = (ar - half) * res
            r_grid = np.sqrt(xx[:, None] ** 2 + xx[None, :] ** 2).reshape(-1)
            flat = torch.as_tensor((x_inds[:, None] * N + y_inds[None, :])
                                   .reshape(-1), device=dev)
            P, C = self._profile_pair(
                cosmo, np.geomspace(max(r_grid.min(), 1e-6), r_grid.max(),
                                    self.Nbin_interp),
                float(cat['M'][j]), a, {k: float(cat[k][j]) for k in p_keys})
            good = torch.isfinite(P) & torch.isfinite(C) & (P > 0) & (C > 0)
            if int(good.sum()) < 2:
                continue
            P, C = P[good], C[good]
            s = torch.argsort(C, stable=True)
            lnC, lnP = torch.log(C[s]), torch.log(P[s])
            vals = orig[flat]
            lnv = torch.where(vals > 0, torch.log(torch.clamp(vals,
                                                              min=1e-300)),
                              np.nan)
            # np.interp(..., left=nan, right=nan)
            painted = torch.exp(torch.where(
                (lnv < lnC[0]) | (lnv > lnC[-1]), np.nan,
                interp(lnv, lnC, lnP)))
            keep = torch.isfinite(painted) & (torch.as_tensor(
                r_grid, **f64) < R_com[j] * self.epsilon_max)
            scatter_add_accum((new_map,), flat.to(torch.int32),
                              (torch.where(keep, painted, 0.0),))
        return new_map

    def process(self):
        """The painted-only map (float64 numpy, (N, N))."""
        N = self.GriddedMap.Npix
        setup = self._anis_setup()
        if setup is None:                  # an empty catalog paints nothing
            return np.zeros((N, N), dtype=np.float64)
        cosmo, a, arrs, Nsize = setup
        if self.method == "cellmajor":
            new_map = self._paint_anis_cellmajor(cosmo, a, arrs, Nsize)
        else:
            t0 = self._stage_t0()
            new_map = self._paint_anis_loop(cosmo, a, arrs, Nsize)
            self._stage("pass", t0, new_map)
        t0 = self._stage_t0()
        out = new_map.to(torch.float64).cpu().numpy().reshape(N, N)
        self._stage("fetch_map", t0)
        return out

    def process_device(self, remap=None, canvas=None):
        """Differentiable density-dependent painting (the port of the JAX
        package's ``PaintProfilesAnisGrid.process_device``): the cell-major
        method whatever ``method`` is, the map as an (N, N) tensor on the
        device in the hot dtype. ``remap`` is the (NM, Nq + 2 [, P...])
        remap table (default the host build's; e.g. from
        :meth:`build_remap_device`), ``canvas`` the existing (N, N) map
        (default ``GriddedMap.map``; e.g. ``BaryonifyGrid.process_device``'s
        output, to paint after a differentiable baryonification); either
        may carry a graph. The lnq grid, mass nodes and prop grids stay the
        host build's, and the geometry is cached per catalog. With the
        default inputs the values equal :meth:`process`'s (cell-major) bit
        for bit."""
        N = self.GriddedMap.Npix
        setup = self._anis_setup()
        if setup is None:
            return torch.zeros((N, N), dtype=self.dtype,
                               device=resolve_device(self.device))
        cosmo, a, arrs, Nsize = setup
        return self._paint_anis_cellmajor(cosmo, a, arrs, Nsize, remap,
                                          canvas)
