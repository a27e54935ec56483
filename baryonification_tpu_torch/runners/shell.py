"""Full-sky HEALPix shell baryonification and painting in PyTorch.

The port of ``baryonification_tpu.runners.shell`` for its two main
methods. ``method="cellmajor"`` (what ``"auto"`` takes on the card)
groups the halos by coarse-cell level, lists for every coarse cell the
halos that can reach it, and runs one dense pass per group over all
pixels in NESTED order (``runners/shell_cellmajor.py``; the pass is the
hand-written CUDA kernel ``ops.cellmajor_cuda`` on a GPU). ``method=
"scatter"`` (the reference semantics, ``"auto"`` on the CPU) runs:

  (A) per-halo gather: fixed-shape disc windows, bucketed by angular size
      so the padding stays tight, batched over chunks of halos;
  (B) displacement-table readout and unit-vector offset accumulation into
      three full-sky offset planes, one scatter-add per chunk (the
      hand-written CUDA kernel on a GPU, ``ops.scatter_cuda``); offsets
      from overlapping halos add before the regrid.

``BaryonifyShell.process`` ends both methods in (C) one regrid: 4-neighbour
bilinear weights for every displaced pixel, a scatter-add of the original
mass (on a GPU the hand-written kernel ``ops.regrid_cuda``), then the
mass-conservation check (the cell-major method regrids in NESTED order;
the deposit targets are RING ids either way).
``PaintProfilesShell.process`` adds the tabulated projected profile
instead and has no regrid. ``process_device`` of both runners is the
cell-major method as a differentiable function of the table: the map
stays on the device and carries a graph through the pass's adjoint
(``ops.cellmajor_cuda.cellmajor_pass_diff``) and the regrid.

``mesh=`` (a ``torch.distributed`` ``DeviceMesh``; cell-major only) runs
``process()`` and ``process_device()`` over the ranks of one mesh
dimension: each rank owns the NESTED pixels [r npix / n, (r + 1) npix / n)
in every bucket (the coarse levels are floored at
``parallel.min_coarse_nside(n)``), keeps its offsets or paint local until
the end, and one sum over the mesh joins the ranks' partial maps
(``parallel.py``). Every rank returns the whole map.

Precision: ``precision="auto"`` is float64 on the CPU and float32 on
CUDA, as in the JAX package. The per-halo preprocessing runs in float64
on the runner's device (the JAX package keeps it on the host CPU to avoid
a remote-TPU round trip).
"""

import time

import numpy as np
import torch

from ..cosmology import Cosmology, MassDef
from ..ops import healpix as hpx
from ..ops.cellmajor_cuda import cellmajor_pass, cellmajor_pass_diff
from ..ops import regrid_cuda
from ..ops.interp import blend_table_radial, radial_readout
from ..ops.scatter_cuda import scatter_add_accum
from ..parallel import (mesh_grad_sum, mesh_offsets_bucket,
                        mesh_paint_bucket, mesh_place, mesh_rank,
                        mesh_regrid_shell, mesh_share, min_coarse_nside)
from ..utils import resolve_device
from . import shell_cellmajor as cm
from ._method import resolve_method

__all__ = ['DefaultRunner', 'BaryonifyShell', 'PaintProfilesShell',
           'PaintProfilesAnisShell']


def _pack_from_angles(theta, phi, D, a, R_com, M, props):
    """The cell-major packed halo records (``props`` is the (H, n_props)
    extra-table-axis coordinate matrix, possibly zero-width)."""
    st = torch.sin(theta)
    return cm.pack_halo_records(st * torch.cos(phi), st * torch.sin(phi),
                                torch.cos(theta), D, a, R_com,
                                torch.log(R_com), torch.log(1.0 / a),
                                torch.log(M), props=props)


def _buckets_by_nsidec(radii, nside, nside_c_min=1):
    """Group halos by their coarse-cell level (host-side numpy): the
    nside_c whose cell size matches the disc radius, clipped to
    [nside_c_min, nside]. One dense pass per level; returns
    [(nside_c, index array)] from fine to coarse."""
    radii = np.asarray(radii)
    t = np.sqrt(np.pi / 3.0) / np.maximum(radii, 1e-4)
    n_c = np.clip(2.0 ** np.round(np.log2(t)), nside_c_min,
                  nside).astype(np.int64)
    out = []
    for val in np.unique(n_c)[::-1]:          # fine -> coarse
        idx = np.where(n_c == val)[0]
        if idx.size:
            out.append((int(val), idx))
    return out


def _bucket_edges(radii, n_buckets):
    """Split halos into geometric angular-radius buckets (host-side numpy).

    Each bucket spans at most a factor ~2 in radius, so the fixed-shape
    window padding wastes at most ~4x work within a bucket. Returns a list
    of index arrays.
    """
    radii = np.asarray(radii)
    r_max = radii.max()
    r_min = max(radii.min(), r_max / 2 ** n_buckets, 1e-12)
    edges = np.geomspace(r_min, r_max, n_buckets + 1)
    edges[0], edges[-1] = 0.0, np.inf
    out = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        idx = np.where((radii > lo) & (radii <= hi))[0]
        if idx.size:
            out.append(idx)
    return out


def _chunk_for(n_rings, n_phi, halo_chunk, budget=4_000_000):
    """Halo-chunk size bounded by a per-chunk gathered-pixel budget."""
    per_halo = n_rings * n_phi + 4
    return max(1, min(halo_chunk, budget // per_halo))


def _quantize_dim(x):
    """Round a window dimension up onto a coarse ladder (the window sizes,
    and so the chunking, of the JAX package)."""
    if x <= 64:
        return int(-(-x // 8) * 8)
    if x <= 512:
        return int(-(-x // 64) * 64)
    return int(-(-x // 256) * 256)


def _window_dims(nside, radius_max):
    """Static (n_rings, n_phi) bounds for discs up to ``radius_max``."""
    ring_h = np.pi / (4 * nside)            # ring spacing
    n_rings = int(np.ceil(2 * radius_max / ring_h)) + 4
    # worst-case phi width: a disc at colatitude ~radius from the pole
    # has dphi ~ pi; bound via radius/sin(theta_min) with theta_min ~ radius
    n_phi = int(np.ceil(2.5 * radius_max * 4 * nside / np.pi)) + 8
    n_phi = min(_quantize_dim(n_phi), 4 * nside)
    n_rings = min(_quantize_dim(n_rings), 4 * nside - 1)
    return n_rings, n_phi


def _pad_to(arrs, n, chunk):
    """Pad (n,) / (n, k) halo tensors to a multiple of ``chunk``. Padded
    halos get a tiny radius and unit mass/scale factor, so they displace
    nothing: their window is empty and the <4-pixel fallback reads d = 0."""
    n_pad = (-n) % chunk
    if not n_pad:
        return dict(arrs)
    out = {}
    for k, v in arrs.items():
        fill = 1.0 if (v.dim() == 1 and k in ('a', 'D', 'M', 'R_com')) \
            else 0.0
        out[k] = torch.cat([v, v.new_full((n_pad,) + v.shape[1:], fill)])
    out['R_com'][-n_pad:] = 1e-10
    out['radius'][-n_pad:] = 0.0
    return out


class DefaultRunner:
    """Shared configuration for the shell runners.

    ``device`` is where the runner computes: the card unless the caller
    asks for the CPU (without a GPU, ``process()`` on the default
    raises). ``precision`` is its hot-path dtype ("auto": float64 on the
    CPU, float32 on CUDA). ``method``: see
    :func:`runners._method.resolve_method` ("auto" is "cellmajor" on
    CUDA and "scatter" on the CPU). ``mesh`` (a ``DeviceMesh``) and
    ``mesh_axis`` (one of its dimensions, default the first) shard the
    cell-major method over that dimension's ranks (module docstring);
    with a mesh ``method="auto"`` is "cellmajor" and any other method
    raises.
    """

    #: the caches built from the halo catalog (dropped when it changes)
    _CATALOG_CACHES = ('_halo_arrays_cache', '_packed_cache', '_dense_cache',
                       '_groups_cache', '_cache_cat')

    def __init__(self, HaloLightConeCatalog, LightconeShell, epsilon_max,
                 model, use_ellipticity=False, mass_def=None, verbose=True,
                 halo_chunk=256, n_buckets=8, precision="auto",
                 method="auto", mesh=None, mesh_axis=None, *,
                 device="cuda"):
        self.HaloLightConeCatalog = HaloLightConeCatalog
        self.LightconeShell = LightconeShell
        self.cosmo = HaloLightConeCatalog.cosmology
        self.model = model
        self.epsilon_max = epsilon_max
        self.mass_def = mass_def if mass_def is not None else MassDef(200, 'critical')
        self.verbose = verbose
        self.halo_chunk = halo_chunk
        self.n_buckets = n_buckets
        self.use_ellipticity = use_ellipticity
        self.device = torch.device(device)
        # float32 on the card: the regrid weights sum to one by
        # construction and the offset delta uses a cancellation-stable
        # form, so f32 is accurate at the 0.1%-map level
        if precision == "auto":
            precision = ("float64" if self.device.type == "cpu"
                         else "float32")
        self.dtype = getattr(torch, precision) if isinstance(precision, str) \
            else precision
        self.mesh, self.mesh_axis, method = _mesh_args(mesh, mesh_axis,
                                                       method)
        n_props = len(getattr(model, 'p_keys', []) or [])
        why_not = None
        if n_props > cm.MAX_PROPS:
            why_not = (f"model has {n_props} extra parameter axes; "
                       f"the packed records fit at most {cm.MAX_PROPS}")
        self.method = resolve_method(method, why_not, "scatter",
                                     self.device.type)
        if use_ellipticity:
            raise NotImplementedError(
                "use_ellipticity = True is not implemented for the "
                "curved-sky runner.")

    # ----- stage profiling -----
    def _stage(self, label, t0, sync=None):
        """Record a wall-clock stage time when ``self.profile`` is set.

        ``sync`` (a tensor) makes the stage wait for its device work. The
        results accumulate in ``self.stage_times`` as (label, seconds);
        the syncs serialise the pipeline, so use them for attribution,
        not as the headline number."""
        if not getattr(self, 'profile', False):
            return
        if sync is not None and sync.is_cuda:
            torch.cuda.synchronize(sync.device)
        self.stage_times.append((label, time.perf_counter() - t0))

    def _stage_t0(self):
        if not getattr(self, 'profile', False):
            return 0.0
        if not hasattr(self, 'stage_times'):
            self.stage_times = []
        return time.perf_counter()

    def _ring_tables(self, nside, dt):
        """Per-ring tables and the RING-order pixel-centre planes, built
        on the device and cached per dtype."""
        cache = self.__dict__.setdefault('_rt_cache', {})
        key = (nside, dt)
        if key not in cache:
            rt = hpx.RingTables(nside, dtype=dt, device=self.device)
            planes = hpx.pixel_planes_device(nside, rt.z, rt.start, rt.npr,
                                             rt.shift)
            cache[key] = (rt, planes)
        return cache[key]

    def _check_catalog_caches(self):
        """Drop catalog-derived caches if the catalog object was swapped."""
        if getattr(self, '_cache_cat', None) is not self.HaloLightConeCatalog:
            for attr in self._CATALOG_CACHES:
                self.__dict__.pop(attr, None)
            self._cache_cat = self.HaloLightConeCatalog

    # ----- cell-major helpers -----
    def _mesh_floor(self, nside):
        """The coarsest level whose cells split evenly over the mesh's
        ranks (1 without a mesh)."""
        if self.mesh is None:
            return 1
        n = mesh_rank(self.mesh, self.mesh_axis)[2]
        nsc_min = min_coarse_nside(n)
        if nsc_min > nside:
            raise ValueError(f"nside={nside} is too small to shard over {n} "
                             f"ranks (needs nside >= {nsc_min})")
        return nsc_min

    def _cm_groups(self, arrs, nside):
        """Cell-major bucket grouping, cached per catalog: [(nside_c, (H,)
        halo ids on the device, max disc radius, max R_com)].

        The pass level is floored at ``min_f_pixels`` pixels per cell
        (default 4, i.e. nside_c <= nside / 2): with one pixel a cell the
        per-slot work is amortised over one pixel only, so that level
        merges into its parent. With a mesh the levels are floored at
        :meth:`_mesh_floor`."""
        cache = self.__dict__.setdefault('_groups_cache', {})
        nsc_min = self._mesh_floor(nside)
        key = (nside, nsc_min)
        if key not in cache:
            f_min = int(getattr(self, 'min_f_pixels', 4))
            nsc_cap = max(nsc_min, nside // max(1, int(f_min ** 0.5)))
            radius = arrs['radius'].cpu().numpy()
            r_com = arrs['R_com'].cpu().numpy()
            dev = arrs['theta'].device
            cache[key] = [
                (nsc, torch.as_tensor(idx, device=dev),
                 float(radius[idx].max()), float(r_com[idx].max()))
                for nsc, idx in _buckets_by_nsidec(radius, nsc_cap,
                                                   nsc_min)]
        return cache[key]

    def _npix_local(self, nside):
        """Pixels of this rank's share (all of them without a mesh)."""
        if self.mesh is None:
            return hpx.npix(nside)
        lo, hi = mesh_share(self.mesh, self.mesh_axis, hpx.npix(nside))
        return hi - lo

    def _dense_candidates(self, bi, nside_c, sub, r_b):
        """Dense NESTED-cell candidate matrix of bucket ``bi``, cached
        (``sub`` is a zero-argument callable giving the bucket's theta,
        phi and radius in the hot-path dtype; called on a cache miss).

        Returns (dense, counts, K, nside_c_eff): while K is large, the
        lists are refined one level finer at a time
        (:func:`shell_cellmajor.refine_cell_candidates`), since the pass's
        work is npix * K and the registration margin inflates K ~2x. K_pad
        (the dense matrix's row length) is K itself: the JAX package's
        coarser ladder only shares TPU compiles."""
        cache = self.__dict__.setdefault('_dense_cache', {})
        dt = self.dtype
        key = (bi, nside_c, dt)
        if key in cache:
            return cache[key]
        sub = sub()
        hids, cell_start, K = cm.coarse_halo_index(
            nside_c, sub['theta'], sub['phi'], sub['radius'], r_max=r_b,
            cell_map=self._cell_map_nested(nside_c))
        dense, counts = cm.dense_cell_candidates(hpx.npix(nside_c), max(K, 1),
                                                 hids, cell_start)
        nside = self.LightconeShell.NSIDE
        nsc = nside_c
        # refine while K is margin-dominated, the child level stays within
        # the margin's validated range (<= 512), and enough pixels per
        # cell remain to amortise the per-slot work
        k_min = getattr(self, 'refine_k_min', 48)
        while (K >= k_min and 2 * nsc <= 512 and 2 * nsc <= nside
               and (nside // (2 * nsc)) ** 2 >= 64):
            nsc *= 2
            cvx, cvy, cvz = self._cell_centers_nested(nsc, dt)
            th, ph = sub['theta'], sub['phi']
            st = torch.sin(th)
            hrec = torch.stack([st * torch.cos(ph), st * torch.sin(ph),
                                torch.cos(th),
                                cm.cell_reach_cos(sub['radius'], nsc)],
                               dim=-1)
            dense2d, counts, K = cm.refine_cell_candidates(
                hpx.npix(nsc), dense, counts, cvx, cvy, cvz, hrec)
            dense = dense2d[:, :max(K, 1)].reshape(-1).contiguous()
        out = (dense, counts, K, nsc)
        if (getattr(self, 'low_memory', False)
                and dense.numel() * dense.element_size()
                > getattr(self, 'low_memory_bytes', 256 << 20)):
            return out
        cache[key] = out
        return out

    def _cell_centers_nested(self, nside_c, dt):
        """NESTED-order cell-centre unit-vector planes at a coarse nside,
        cached."""
        cache = self.__dict__.setdefault('_ctr_cache', {})
        key = (nside_c, dt)
        if key not in cache:
            rt = hpx.RingTables(nside_c, dtype=dt, device=self.device)
            n2r = hpx.nest2ring_all(nside_c, self.device)
            cache[key] = hpx.pixel_planes_device(nside_c, rt.z, rt.start,
                                                 rt.npr, rt.shift, p=n2r)
        return cache[key]

    def _cell_map_nested(self, nside_c):
        """(nc,) RING -> NESTED cell-id lookup, cached."""
        cache = self.__dict__.setdefault('_cmap_cache', {})
        if nside_c not in cache:
            cache[nside_c] = hpx.ring2nest(
                nside_c, torch.arange(hpx.npix(nside_c), device=self.device))
        return cache[nside_c]

    def _nested_maps(self, nside):
        """(n2r, r2n): the RING id of each NESTED position and the NESTED
        position of each RING id, int64 on the device, cached."""
        cache = self.__dict__.setdefault('_nest_maps', {})
        if nside not in cache:
            n2r = hpx.nest2ring_all(nside, self.device)
            r2n = torch.empty_like(n2r)
            r2n[n2r] = torch.arange(n2r.shape[0], device=n2r.device)
            cache[nside] = (n2r, r2n)
        return cache[nside]

    def _orig_map_nested(self, orig_map, n2r, dt):
        """NESTED-order copy of the shell's mass map on the device, cached
        on the runner for parameter sweeps over one shell; keyed on the
        map object's identity and its total, so an in-place edit of the
        same array invalidates it."""
        key = (id(self.LightconeShell.map), dt, orig_map.shape[0],
               float(orig_map.sum()))
        cache = getattr(self, '_omap_cache', None)
        if cache is None or cache[0] != key:
            host = torch.as_tensor(np.ascontiguousarray(orig_map), dtype=dt)
            self._omap_cache = (key, host.to(n2r.device)[n2r])
        return self._omap_cache[1]

    def _packed_records(self, arrs, dt):
        """(H, 16) packed halo records of the catalog, cached per dtype."""
        cache = self.__dict__.setdefault('_packed_cache', {})
        if dt not in cache:
            c = {k: arrs[k].to(dt) for k in ('theta', 'phi', 'D', 'a',
                                             'R_com', 'M', 'props')}
            cache[dt] = _pack_from_angles(c['theta'], c['phi'], c['D'],
                                          c['a'], c['R_com'], c['M'],
                                          c['props'])
        return cache[dt]

    def _pixels_nested(self, nside, dt):
        """NESTED-order pixel unit-vector planes, built on the device and
        cached per dtype."""
        cache = self.__dict__.setdefault('_pixn_cache', {})
        key = (nside, dt)
        if key not in cache:
            n2r, _ = self._nested_maps(nside)
            rt, _ = self._ring_tables(nside, dt)
            cache[key] = hpx.pixel_planes_device(nside, rt.z, rt.start,
                                                 rt.npr, rt.shift, p=n2r)
        return cache[key]

    @staticmethod
    def _node_bound(g2, rad_max, Nr):
        """Radial-node bound of a bucket: nodes above the largest
        reachable ln r (the eps_max * R cutoff) contribute nothing;
        rounded up to a multiple of 32 as in the JAX package."""
        n_hi = int(np.floor((rad_max - g2[0]) / (g2[1] - g2[0]))) + 2
        return min(Nr, max(32, -(-n_hi // 32) * 32))

    def _cellmajor_buckets(self, arrs, nside, grids, table, g2, mode,
                           planes, label, tag, diff=False):
        """Run the cell-major pass of every bucket onto the NESTED
        ``planes`` (in place): ``mode`` as in ``ops.cellmajor_cuda``,
        ``table`` in the hot-path dtype with finite nodes only, ``g2``
        the radial grid on the host in float64. Stages: packed_records,
        pixels_nested, then reg[...] and pass[...] per bucket. With
        ``diff`` each bucket's pass is the differentiable one
        (``cellmajor_pass_diff``: new planes, gradients to ``table``
        through the rows); returns the planes. With a mesh ``planes`` are
        this rank's share and each pass runs on its cells only."""
        dt, eps = self.dtype, float(self.epsilon_max)
        t0 = self._stage_t0()
        packed_all = self._packed_records(arrs, dt)
        self._stage("packed_records", t0, packed_all)
        t0 = self._stage_t0()
        pix = self._pixels_nested(nside, dt)
        self._stage("pixels_nested", t0, pix[2])
        g_host = grids[2].cpu()
        g0, dg = float(g_host[0]), float(g_host[1] - g_host[0])
        for bi, (nside_c, jidx, r_b, rcm_max) in enumerate(
                self._cm_groups(arrs, nside)):
            H = jidx.shape[0]
            rad_max = (np.log(eps) if mode == "offsets_rdelta"
                       else np.log(eps * rcm_max))
            n_hi = self._node_bound(g2, rad_max, len(g2))
            t0 = self._stage_t0()
            dense, counts, K, nsc_eff = self._dense_candidates(
                bi, nside_c, lambda jidx=jidx: {
                    k: arrs[k][jidx].to(dt)
                    for k in ('theta', 'phi', 'radius')}, r_b)
            self._stage(f"reg[b{bi} nc{nside_c} {tag}{H}]", t0, counts)
            F = (nside // nsc_eff) ** 2
            if self.verbose:
                print(f"{label}: bucket {bi + 1} ({H} halos, "
                      f"nside_c={nside_c}->{nsc_eff}, K={K}, F={F}, "
                      f"n_hi={n_hi})")
            t0 = self._stage_t0()
            packed = packed_all[jidx]
            args = (planes, pix, dense, counts, F,
                    cm.slot_records(packed, eps),
                    cm.halo_rows(grids, table, packed, n_hi),
                    g0, dg, float(g_host[n_hi - 1]))
            if self.mesh is None:
                planes = (cellmajor_pass_diff if diff else cellmajor_pass)(
                    mode, *args)
            elif mode == "paint":
                planes = mesh_paint_bucket(self.mesh, self.mesh_axis, F,
                                           *args[:4], *args[5:], diff=diff)
            else:
                planes = mesh_offsets_bucket(
                    self.mesh, self.mesh_axis, mode == "offsets_rdelta", F,
                    *args[:4], *args[5:], diff=diff)
            self._stage(f"pass[b{bi} nc{nsc_eff} K{K} n_hi{n_hi}]", t0,
                        planes[0])
        return planes

    def _halo_chunks(self, arrs, nside, label):
        """Walk the halos by angular-size bucket and fixed-size chunk.

        Yields ``(n_rings, n_phi, chunk)``: the bucket's static window
        dims and a dict of (H,) tensors in the hot-path dtype, the last
        chunk of a bucket padded with inert halos (see :func:`_pad_to`)."""
        dev, dt = arrs['theta'].device, self.dtype
        radius = arrs['radius'].cpu().numpy()
        buckets = _bucket_edges(radius, self.n_buckets)
        for bi, idx in enumerate(buckets):
            sub = {k: v[torch.as_tensor(idx, device=dev)]
                   for k, v in arrs.items()}
            n_rings, n_phi = _window_dims(nside, float(radius[idx].max()))
            if self.verbose:
                print(f"{label}: bucket {bi + 1}/{len(buckets)} "
                      f"({len(idx)} halos, window {n_rings}x{n_phi})")
            chunk = _chunk_for(n_rings, n_phi, self.halo_chunk)
            sub = {k: v.to(dt)
                   for k, v in _pad_to(sub, len(idx), chunk).items()}
            for c0 in range(0, sub['theta'].shape[0], chunk):
                yield n_rings, n_phi, {k: v[c0:c0 + chunk]
                                       for k, v in sub.items()}

    # ----- shared halo preprocessing -----
    def _halo_arrays(self, cosmo):
        """Catalog-derived per-halo float64 tensors, cached on the runner."""
        self._check_catalog_caches()
        cached = getattr(self, '_halo_arrays_cache', None)
        if cached is not None:
            return cached
        out = self._halo_arrays_impl(cosmo)
        self._halo_arrays_cache = out
        return out

    def _halo_arrays_impl(self, cosmo):
        cat = self.HaloLightConeCatalog.cat
        f64 = dict(dtype=torch.float64, device=self.device)
        z = torch.as_tensor(cat['z'], **f64)
        M = torch.as_tensor(cat['M'], **f64)
        a = 1.0 / (1.0 + z)
        theta, phi = hpx.radec2ang(torch.as_tensor(cat['ra'], **f64),
                                   torch.as_tensor(cat['dec'], **f64))
        R_phys = self.mass_def.get_radius(cosmo, M, a)
        D = cosmo.angular_diameter_distance(a)
        p_keys = getattr(self.model, 'p_keys', []) or []
        props = (torch.stack([torch.as_tensor(cat[k], **f64)
                              for k in p_keys], dim=-1)
                 if p_keys else torch.zeros((cat.size, 0), **f64))
        return dict(theta=theta, phi=phi, M=M, a=a, R_com=R_phys / a, D=D,
                    radius=self.epsilon_max * R_phys / D, props=props)


# ----- stage A+B: windowed displacement accumulation -----

def _accumulate_shell_offsets(nside, n_rings, n_phi, n_props, use_rdelta,
                              tables, vx, vy, vz, grids, table,
                              eps_max, theta, phi, M, a, R_com, D, props,
                              offsets):
    """Accumulate per-pixel offset components of one chunk of H halos
    into the three ``offsets`` planes (in place).

    Per halo: query the window pixels, compute physical separations, read
    the displacement (comoving in, comoving out, x a both ways), move the
    pixel on the unit sphere and add the unit-vector delta. A disc that
    resolves fewer than 4 pixels uses the 4 bilinear neighbours instead.
    Geometry runs through the ring/pixel tables in the compute dtype.
    """
    H = theta.shape[0]
    npx = hpx.npix(nside)
    radius = eps_max * (R_com * a) / D
    pix, valid = hpx.disc_window_mask_tab(tables, theta, phi, radius,
                                          n_rings, n_phi)
    pix = pix.reshape(H, -1)
    valid = valid.reshape(H, -1)

    # <4-pixel fallback: replace the window by the 4 interp neighbours
    fb_pix, _ = hpx.get_interp_weights_tab(tables, theta, phi)
    use_fb = (valid.sum(dim=-1) < 4)[:, None]
    valid = torch.cat([valid & ~use_fb, use_fb.expand(H, 4)], dim=-1)
    pix = torch.cat([pix, fb_pix], dim=-1)

    px, py, pz = vx[pix], vy[pix], vz[pix]
    st0 = torch.sin(theta)
    v0x = (st0 * torch.cos(phi))[:, None]
    v0y = (st0 * torch.sin(phi))[:, None]
    v0z = torch.cos(theta)[:, None]
    D_h, a_h, Rc_h = D[:, None], a[:, None], R_com[:, None]
    # physical separation components: (pvec - v0) * D
    dx = (px - v0x) * D_h
    dy = (py - v0y) * D_h
    dz = (pz - v0z) * D_h
    r_sep = torch.sqrt(dx * dx + dy * dy + dz * dz)

    # displacement readout (comoving): d(r/a, M, a) * a. The (z, M, props)
    # axes are blended once per halo; per pixel only the 1-D radial lerp
    # remains.
    r_com = r_sep / a_h
    lnr = torch.log(torch.clamp(r_com, min=1e-30))
    rad = lnr - torch.log(Rc_h) if use_rdelta else lnr
    scalars = [torch.log(1.0 / a), torch.log(M)] \
        + [props[:, i] for i in range(n_props)]
    prof_h = blend_table_radial(grids, table, scalars)
    d = radial_readout(prof_h, grids[2], rad)
    d = torch.where(r_com < eps_max * Rc_h, d, 0.0)
    d = torch.where(torch.isfinite(d), d, 0.0) * a_h      # physical

    scale = d / torch.clamp(r_sep, min=1e-30)
    ofx = scale * dx
    ofy = scale * dy
    ofz = scale * dz
    # delta = normalize(pos + offset) - pvec (pos = pvec * D), computed
    # without the catastrophic cancellation of the naive difference (the
    # float32 path needs it): with s = |pos+off| - D,
    # delta = (off - pvec * s) / |pos+off|
    nwx = px * D_h + ofx
    nwy = py * D_h + ofy
    nwz = pz * D_h + ofz
    nw_norm = torch.sqrt(nwx * nwx + nwy * nwy + nwz * nwz)
    pos_dot_off = D_h * (px * ofx + py * ofy + pz * ofz)
    off_sq = ofx * ofx + ofy * ofy + ofz * ofz
    s = (2.0 * pos_dot_off + off_sq) / (nw_norm + D_h)
    dxn = (ofx - px * s) / nw_norm
    dyn = (ofy - py * s) / nw_norm
    dzn = (ofz - pz * s) / nw_norm
    good = (valid & torch.isfinite(dxn) & torch.isfinite(dyn)
            & torch.isfinite(dzn))
    # invalid window rows go to the out-of-range sentinel Npix, which the
    # scatter drops (the JAX package sends them to pixel 0 with value 0:
    # the sums are identical, and no kernel block receives billions of
    # zero rows aimed at one address)
    idx = torch.where(valid, pix, npx).reshape(-1).to(torch.int32)
    dt = offsets[0].dtype
    vals = tuple(torch.where(good, v, 0.0).reshape(-1).to(dt)
                 for v in (dxn, dyn, dzn))
    return scatter_add_accum(offsets, idx, vals)


def _accumulate_shell_paint(nside, n_rings, n_phi, n_props, tables, vx, vy,
                            vz, grids, table, eps_max, theta, phi, M, a,
                            R_com, D, props, new_map):
    """Add the tabulated projected profile of one chunk of H halos to the
    single ``new_map`` plane (in place).

    Per halo: query the window pixels, compute the physical separation,
    read the log projected profile at the comoving separation (and the
    halo's ``props``, its n_props extra-axis coordinates) and add its
    exponential. ``table`` holds log profiles, so zero profile nodes
    are -inf; readouts that are not finite (those nodes, or a halo
    outside the table) paint nothing, as in the JAX package.
    """
    H = theta.shape[0]
    npx = hpx.npix(nside)
    radius = eps_max * (R_com * a) / D
    pix, valid = hpx.disc_window_mask_tab(tables, theta, phi, radius,
                                          n_rings, n_phi)
    pix = pix.reshape(H, -1)
    valid = valid.reshape(H, -1)
    st0 = torch.sin(theta)
    D_h, a_h = D[:, None], a[:, None]
    dx = (vx[pix] - (st0 * torch.cos(phi))[:, None]) * D_h
    dy = (vy[pix] - (st0 * torch.sin(phi))[:, None]) * D_h
    dz = (vz[pix] - torch.cos(theta)[:, None]) * D_h
    r_sep = torch.sqrt(dx * dx + dy * dy + dz * dz)

    r_com = torch.clamp(r_sep / a_h, min=1e-30)
    prof_h = blend_table_radial(grids, table,             # log-profile
                                [torch.log(1.0 / a), torch.log(M)]
                                + [props[:, i] for i in range(n_props)])
    paint = torch.exp(radial_readout(prof_h, grids[2], torch.log(r_com)))
    paint = torch.where(torch.isfinite(paint) & valid, paint, 0.0)
    # invalid window rows go to the sentinel Npix (see
    # _accumulate_shell_offsets)
    idx = torch.where(valid, pix, npx).reshape(-1).to(torch.int32)
    return scatter_add_accum((new_map,), idx,
                             (paint.reshape(-1).to(new_map.dtype),))


def _regrid_shell(nside, vx, vy, vz, orig_map, offsets):
    """Stage C: displace every pixel's unit vector and redeposit the
    original mass with bilinear weights into a new RING map. ``offsets``
    is the (ox, oy, oz) plane tuple. ``ops.regrid_cuda.regrid_shell``: on
    the card the kernels of ``csrc/regrid.cu`` (the deterministic route
    under deterministic algorithms), on the CPU the plain version (the
    ``index_add_`` deposit, XLA's scatter in the JAX package);
    differentiable, its backward the adjoint kernel on the card."""
    return regrid_cuda.regrid_shell(nside, vx, vy, vz, orig_map, offsets)


class BaryonifyShell(DefaultRunner):
    """Baryonify a HEALPix mass shell.

    The input map must be a MASS map (empty pixels = 0)."""

    def _cellmajor_map(self, arrs, nside, table, orig_map, diff=False):
        """The cell-major method from the offset passes to the regridded
        RING map (in the hot-path dtype, on the device). ``table`` is the
        displacement table on the device in the hot-path dtype; with
        ``diff`` the passes are differentiable and the map carries a
        graph to ``table``."""
        dt, dev = self.dtype, table.device
        use_rdelta = bool(getattr(self.model, 'Rdelta_sampling', False))
        grids = tuple(g.to(device=dev, dtype=dt) for g in self.model._grids)
        if self.mesh is not None:
            table = mesh_grad_sum(self.mesh, self.mesh_axis, table)
        offsets = tuple(torch.zeros(self._npix_local(nside), dtype=dt,
                                    device=dev) for _ in range(3))
        # non-finite table nodes become 0 before the blend (a 0-weight
        # corner would otherwise turn the halo's whole row into NaN)
        offsets = self._cellmajor_buckets(
            arrs, nside, grids, torch.where(torch.isfinite(table), table,
                                            0.0),
            self.model._grids[2].cpu().numpy(),
            "offsets_rdelta" if use_rdelta else "offsets", offsets,
            "Baryonifying matter", "H", diff=diff)
        # the regrid is order-agnostic given consistent (vector, offset,
        # mass) triples: it runs in NESTED order and deposits into RING ids
        t0 = self._stage_t0()
        n2r, _ = self._nested_maps(nside)
        pix = self._pixels_nested(nside, dt)
        omap = self._orig_map_nested(orig_map, n2r, dt)
        if self.mesh is None:
            new_map = _regrid_shell(nside, *pix, omap, offsets)
        else:
            new_map = mesh_regrid_shell(self.mesh, self.mesh_axis, nside,
                                        pix, omap, offsets)
        self._stage("regrid", t0, new_map)
        return new_map

    def process_device(self, table=None):
        """Differentiable cell-major baryonification (the port of the JAX
        package's ``BaryonifyShell.process_device``).

        Runs the computation of :meth:`process` under the cell-major
        method and returns the new RING-order map as a tensor on the
        device, in the hot-path dtype, with no host copy and no
        conservation check. ``table`` (default ``model._table``) may
        carry a graph (e.g. from ``build_table_device`` of parameters
        that require grad): gradients flow from any scalar of the map
        through the regrid, the cell-major passes (on the card the
        adjoint kernel of ``csrc/cellmajor_pass.cu``) and the row blend
        into the table. The geometry (registration, candidates, packed
        records, pixel planes) depends only on halo positions and the
        epsilon_max * R reach: it is staged once in the runner's caches
        and held constant, so a fit registers only on its first call.
        The values equal :meth:`process`'s bit for bit."""
        if self.method != "cellmajor":
            raise ValueError(f"process_device runs the cell-major method "
                             f"only; this runner's method is {self.method!r}")
        dev, dt = resolve_device(self.device), self.dtype
        model = self.model
        if table is None:
            if not hasattr(model, '_table'):
                raise NameError("Displacement model has no table. Run "
                                "setup_interpolator() first")
            table = model._table
        nside = self.LightconeShell.NSIDE
        orig_map = np.asarray(self.LightconeShell.map, dtype=np.float64)
        if self.HaloLightConeCatalog.cat.size == 0:
            return torch.as_tensor(orig_map, dtype=dt, device=dev)
        arrs = self._halo_arrays(Cosmology.from_dict(self.cosmo, device=dev))
        return self._cellmajor_map(arrs, nside,
                                   table.to(device=dev, dtype=dt), orig_map,
                                   diff=True)

    def process(self):
        dev, dt = resolve_device(self.device), self.dtype
        cosmo = Cosmology.from_dict(self.cosmo, device=dev)
        model = self.model
        if not hasattr(model, '_table'):
            raise NameError("Displacement model has no table. Run "
                            "setup_interpolator() first")

        nside = self.LightconeShell.NSIDE
        orig_map = np.asarray(self.LightconeShell.map, dtype=np.float64)

        if self.HaloLightConeCatalog.cat.size == 0:
            # an empty catalog leaves the map untouched
            return orig_map.copy()

        t0 = self._stage_t0()
        arrs = self._halo_arrays(cosmo)
        self._stage("halo_arrays", t0)
        table = model._table.to(device=dev, dtype=dt)
        if self.method == "cellmajor":
            new_map = self._cellmajor_map(arrs, nside, table, orig_map)
        else:
            n_props = len(getattr(model, 'p_keys', []) or [])
            use_rdelta = bool(getattr(model, 'Rdelta_sampling', False))
            grids = tuple(g.to(device=dev, dtype=dt) for g in model._grids)
            offsets = tuple(torch.zeros(hpx.npix(nside), dtype=dt,
                                        device=dev) for _ in range(3))
            tables, (vx, vy, vz) = self._ring_tables(nside, dt)
            t0 = self._stage_t0()
            for n_rings, n_phi, c in self._halo_chunks(
                    arrs, nside, "Baryonifying matter"):
                _accumulate_shell_offsets(
                    nside, n_rings, n_phi, n_props, use_rdelta, tables,
                    vx, vy, vz, grids, table, float(self.epsilon_max),
                    c['theta'], c['phi'], c['M'], c['a'], c['R_com'],
                    c['D'], c['props'], offsets)
            self._stage("pass", t0, offsets[0])

            t0 = self._stage_t0()
            new_map = _regrid_shell(nside, vx, vy, vz,
                                    torch.as_tensor(orig_map, dtype=dt,
                                                    device=dev), offsets)
            self._stage("regrid", t0, new_map)
        t0 = self._stage_t0()
        new_map = new_map.to(torch.float64).cpu().numpy()
        self._stage("fetch_map", t0)

        new_sum, old_sum = new_map.sum(), orig_map.sum()
        assert np.isclose(new_sum, old_sum), (
            "ERROR in pixel regridding, sum(new_map) [%0.14e] != "
            "sum(oldmap) [%0.14e]" % (new_sum, old_sum))
        return new_map


class PaintProfilesShell(DefaultRunner):
    """Paint a tabulated projected profile onto a shell.

    ``model`` is a :class:`~baryonification_tpu_torch.tabulate.
    TabulatedProfile`, or a ``ParamTabulatedProfile`` whose extra axes
    the catalog carries as columns, with its table set up. ``process()``
    returns the painted-only map (float64 numpy, RING order); the
    ``LightconeShell`` supplies NSIDE and the cosmology only."""

    def _cellmajor_paint(self, arrs, nside, table, diff=False):
        """The cell-major paint as a RING map (hot-path dtype, on the
        device) from the log table ``table`` on the device in the
        hot-path dtype; with ``diff`` the map carries a graph to it."""
        dt, dev = self.dtype, table.device
        grids = tuple(g.to(device=dev, dtype=dt) for g in self.model._grids)
        if self.mesh is not None:
            table = mesh_grad_sum(self.mesh, self.mesh_axis, table)
        new_map = torch.zeros(self._npix_local(nside), dtype=dt, device=dev)
        # log-profile tables carry -inf where the profile is 0: a large
        # negative finite stand-in keeps the blend NaN-free and still
        # paints exp(...) = 0 wherever such a node is touched
        (new_map,) = self._cellmajor_buckets(
            arrs, nside, grids, torch.where(torch.isfinite(table), table,
                                            -1e30),
            self.model._grids[2].cpu().numpy(), "paint", (new_map,),
            "Painting Profile", "h", diff=diff)
        t0 = self._stage_t0()
        if self.mesh is not None:
            npix = hpx.npix(nside)
            new_map = mesh_place(self.mesh, self.mesh_axis, new_map,
                                 mesh_share(self.mesh, self.mesh_axis,
                                            npix)[0], npix)
        _, r2n = self._nested_maps(nside)
        new_map = new_map[r2n]
        self._stage("n2r", t0, new_map)
        return new_map

    def process_device(self, table=None):
        """Differentiable cell-major painting (the port of the JAX
        package's ``PaintProfilesShell.process_device``): the painted
        RING-order map as a tensor on the device, in the hot-path dtype.
        ``table`` (default ``model._ln2D``, the LOG projected-profile
        table) may carry a graph, e.g. from ``TabulatedProfile.
        build_tables_device``; gradients flow through the paint mode of
        the cell-major pass's adjoint. Geometry is staged from the
        runner's caches and held constant, as in
        ``BaryonifyShell.process_device``; the values equal
        :meth:`process`'s bit for bit."""
        if self.method != "cellmajor":
            raise ValueError(f"process_device runs the cell-major method "
                             f"only; this runner's method is {self.method!r}")
        dev, dt = resolve_device(self.device), self.dtype
        model = self.model
        if model is None or not hasattr(model, '_ln2D'):
            raise NameError("PaintProfilesShell.process_device needs a "
                            "TabulatedProfile with its table set up")
        if table is None:
            table = model._ln2D
        nside = self.LightconeShell.NSIDE
        if self.HaloLightConeCatalog.cat.size == 0:
            return torch.zeros(hpx.npix(nside), dtype=dt, device=dev)
        arrs = self._halo_arrays(Cosmology.from_dict(self.cosmo, device=dev))
        return self._cellmajor_paint(arrs, nside,
                                     table.to(device=dev, dtype=dt),
                                     diff=True)

    def process(self):
        dev, dt = resolve_device(self.device), self.dtype
        cosmo = Cosmology.from_dict(self.cosmo, device=dev)
        model = self.model
        if model is None:
            raise ValueError("You must provide a model")
        p_keys = getattr(model, 'p_keys', []) or []
        if p_keys:
            from ..tabulate import ParamTabulatedProfile
            assert isinstance(model, ParamTabulatedProfile), (
                f"You asked to use {p_keys} properties in painting. You "
                f"must pass a ParamTabulatedProfile as the model. You have "
                f"passed {type(model)} instead")
        if not hasattr(model, '_ln2D'):
            raise NameError(
                "PaintProfilesShell requires a TabulatedProfile with "
                "setup_interpolator() run: the projected profile is read "
                "from its table.")

        nside = self.LightconeShell.NSIDE
        if self.HaloLightConeCatalog.cat.size == 0:
            # an empty catalog paints nothing
            return np.zeros(hpx.npix(nside), dtype=np.float64)

        t0 = self._stage_t0()
        arrs = self._halo_arrays(cosmo)
        self._stage("halo_arrays", t0)
        table = model._ln2D.to(device=dev, dtype=dt)
        if self.method == "cellmajor":
            new_map = self._cellmajor_paint(arrs, nside, table)
        else:
            grids = tuple(g.to(device=dev, dtype=dt) for g in model._grids)
            new_map = torch.zeros(hpx.npix(nside), dtype=dt, device=dev)
            tables, (vx, vy, vz) = self._ring_tables(nside, dt)
            t0 = self._stage_t0()
            for n_rings, n_phi, c in self._halo_chunks(arrs, nside,
                                                       "Painting Profile"):
                _accumulate_shell_paint(
                    nside, n_rings, n_phi, len(p_keys), tables, vx, vy, vz,
                    grids, table, float(self.epsilon_max), c['theta'],
                    c['phi'], c['M'], c['a'], c['R_com'], c['D'],
                    c['props'], new_map)
            self._stage("pass", t0, new_map)
        t0 = self._stage_t0()
        out = new_map.to(torch.float64).cpu().numpy()
        self._stage("fetch_map", t0)
        return out


class PaintProfilesAnisShell(PaintProfilesShell):
    """Alias of PaintProfilesShell, as in the JAX package."""


def _mesh_args(mesh, mesh_axis, method):
    """(mesh, its dimension's name or index, method) of a runner: with a
    mesh, ``mesh_axis`` defaults to the mesh's first dimension and
    ``method="auto"`` is "cellmajor"; another method raises."""
    if mesh is None:
        return None, None, method
    if mesh_axis is None:
        mesh_axis = mesh.mesh_dim_names[0] if mesh.mesh_dim_names else 0
    if method == "auto":
        method = "cellmajor"
    if method != "cellmajor":
        raise ValueError(f"mesh= is only supported with the cell-major "
                         f"method (the cell axis is what shards); got "
                         f"method={method!r}")
    return mesh, mesh_axis, method
