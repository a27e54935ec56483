"""Particle-snapshot runner: baryonify raw particle positions.

The port of ``baryonification_tpu.runners.snapshot`` (``CellList``,
``DefaultRunnerSnapshot``, ``BaryonifySnapshot.process``). A periodic
uniform-grid cell list is built once on the host (particles sorted by
cell id, a stable sort), and halos are bucketed by their query radius
R_q = eps_max * R_com (clipped to L/2). Two methods:

- ``method="cellmajor"`` (what ``"auto"`` takes on the card, 3D only):
  particles padded per cell in Morton order, halos registered in every
  cell they can reach, one dense pass a bucket
  (``runners/snapshot_cellmajor.py``; plain PyTorch ops, XLA in the JAX
  package). ``n_cells`` is rounded to a power of two.
- ``method="gather"`` (the reference semantics, ``"auto"`` on the CPU and
  the only method for 2D snapshots): each halo takes the K^dim block of
  cells around its own, P padded slots a cell, chunks of ``halo_chunk``
  halos, and one scatter-add of the offsets a chunk
  (``ops.scatter_cuda``: the hand-written CUDA kernel on a GPU).

The offsets are the comoving table readout times a, pushed along the
unit vector from the halo; overlapping halos add. They stay in the hot
dtype on the device; on the host they are added to the float64 positions,
which are wrapped back into [0, L]. An empty catalog moves nothing, and
under ``cellmajor`` a catalog redshift outside the table moves nothing.

``process_device`` is the differentiable core (cell-major only, as in
the JAX package): the displaced positions as device tensors, with
gradients into the table through the passes' step-wise adjoint.

Precision: ``precision="auto"`` is float64 on the CPU and float32 on
CUDA, as in the JAX package.

``mesh=`` (a ``torch.distributed`` ``DeviceMesh``; cell-major only)
shards the passes over the ranks of one mesh dimension: each rank runs
every bucket on its own contiguous range of cell-list cells
(``parallel.mesh_snap_cells``), and one sum over the mesh gathers the
ranks' offsets. Every rank returns the whole catalog.
"""

import numpy as np
import torch

from ..cosmology import Cosmology, MassDef
from ..ops.interp import blend_table_radial, radial_readout
from ..ops.scatter_cuda import scatter_add_accum
from ..parallel import (mesh_grad_sum, mesh_place, mesh_snap_cells,
                        mesh_snap_offsets_bucket)
from ..utils import resolve_device
from . import grid_cellmajor as gcm
from . import snapshot_cellmajor as scm
from ._method import resolve_method
from .grid import DefaultRunnerGrid
from .shell import DefaultRunner, _mesh_args
from .shell_cellmajor import dense_cell_candidates

__all__ = ['CellList', 'DefaultRunnerSnapshot', 'BaryonifySnapshot']


class CellList:
    """Periodic uniform-grid spatial index over particle positions (host
    numpy): ``order`` sorts the particles by row-major cell id (stable),
    ``cell_start`` / ``cell_count`` give each cell's run in that order."""

    def __init__(self, coords, L, n_cells):
        self.L = float(L)
        self.n_cells = int(n_cells)
        self.dim = coords.shape[1]
        h = self.L / self.n_cells
        cell = np.floor(np.mod(coords, self.L) / h).astype(np.int64)
        cell = np.clip(cell, 0, self.n_cells - 1)
        cid = cell[:, 0]
        for d in range(1, self.dim):
            cid = cid * self.n_cells + cell[:, d]
        order = np.argsort(cid, kind='stable')
        self.order = order                       # particle permutation
        self.sorted_cid = cid[order]
        ncid = self.n_cells ** self.dim
        self.cell_start = np.searchsorted(self.sorted_cid,
                                          np.arange(ncid), side='left')
        self.cell_count = np.diff(np.append(self.cell_start,
                                            len(cid))).astype(np.int64)
        self.max_per_cell = int(self.cell_count.max()) if len(cid) else 0
        self.h = h


class DefaultRunnerSnapshot:
    """Shared configuration of the snapshot runner.

    ``device`` is where the runner computes: the card unless the caller
    asks for the CPU. ``precision`` is its hot-path dtype ("auto":
    float64 on the CPU, float32 on CUDA). ``method``: see
    :func:`runners._method.resolve_method` ("auto" is "cellmajor" on CUDA
    and "gather" on the CPU; "gather" with a warning for a 2D snapshot or
    a model with more extra table axes than the packed records hold).
    ``n_cells`` (cells per axis of the cell list) defaults to about half
    the cube root of the particle count, in [4, 512]. ``mesh`` and
    ``mesh_axis`` shard the cell-major method over one mesh dimension's
    ranks, as the shell runners' do.
    """

    _stage = DefaultRunner._stage
    _stage_t0 = DefaultRunner._stage_t0
    _node_bound = staticmethod(DefaultRunner._node_bound)

    def __init__(self, HaloNDCatalog, ParticleSnapshot, epsilon_max, model,
                 mass_def=None, verbose=True, halo_chunk=32, n_buckets=4,
                 n_cells=None, precision="auto", method="auto", mesh=None,
                 mesh_axis=None, *, device="cuda"):
        self.HaloNDCatalog = HaloNDCatalog
        self.ParticleSnapshot = ParticleSnapshot
        self.epsilon_max = epsilon_max
        self.cosmo = HaloNDCatalog.cosmology
        self.model = model
        self.mass_def = mass_def if mass_def is not None else MassDef(200, 'critical')
        self.verbose = verbose
        self.halo_chunk = halo_chunk
        self.n_buckets = n_buckets
        self.device = torch.device(device)
        if precision == "auto":
            precision = ("float64" if self.device.type == "cpu"
                         else "float32")
        self.dtype = getattr(torch, precision) if isinstance(precision, str) \
            else precision
        self.mesh, self.mesh_axis, method = _mesh_args(mesh, mesh_axis,
                                                       method)
        p_keys = getattr(model, 'p_keys', []) or []
        why_not = None
        if ParticleSnapshot.is2D:
            why_not = "2D snapshots have no cell-major formulation"
        elif len(p_keys) > gcm.MAX_PROPS_SNAP:
            why_not = (f"model has {len(p_keys)} extra parameter axes; "
                       f"the packed records fit at most {gcm.MAX_PROPS_SNAP}")
        self.method = resolve_method(method, why_not, "gather",
                                     self.device.type)

        coords = (['x', 'y'] if ParticleSnapshot.is2D else ['x', 'y', 'z'])
        self._coords = np.stack([ParticleSnapshot.cat[c] for c in coords],
                                axis=-1)
        if n_cells is None:
            # a few particles a cell, capped for memory
            npart = len(self._coords)
            n_cells = int(np.clip(round(npart ** (1 / len(coords)) / 2),
                                  4, 512))
        if self.method == "cellmajor":
            # Morton cell ids need a power-of-two cell count
            n_cells = int(2 ** np.clip(round(np.log2(n_cells)), 2, 9))
        self.tree = CellList(self._coords, ParticleSnapshot.L, n_cells)

    _tensor = DefaultRunnerGrid._tensor


def _accumulate_particle_offsets(K, P, n_cells, n_props, use_rdelta, grids,
                                 table, eps_max, L, a, sorted_pos,
                                 cell_start, cell_count, xh, Mh, Rh, props,
                                 offsets):
    """Add the offsets of one chunk of halos to the cell-list-order
    ``offsets`` planes (in place): each halo reads the K^dim block of
    cells around its own, P padded particle slots a cell, and the rows
    go to one scatter-add (empty slots aimed at the dropped sentinel).

    sorted_pos : (Np, dim) particle positions in cell-list order
    xh : (H, dim) halo positions; Mh, Rh : (H,) masses, comoving radii
    """
    H, dim = xh.shape
    Np = sorted_pos.shape[0]
    dev = xh.device
    h_cell = L / n_cells
    k_off = torch.arange(K, device=dev) - K // 2
    c0 = torch.floor(torch.remainder(xh, L) / h_cell).to(torch.int64)
    grids_k = torch.meshgrid(*([k_off] * dim), indexing='ij')
    cid = 0
    for d in range(dim):
        cid = cid * n_cells + torch.remainder(
            c0[:, d, None] + grids_k[d].reshape(-1)[None, :], n_cells)
    start = cell_start[cid]                                   # (H, K^dim)
    count = cell_count[cid]
    slot = torch.arange(P, device=dev)
    pidx = start[..., None] + slot                            # (H, C, P)
    pvalid = slot < count[..., None]
    pidx = torch.where(pvalid, pidx, 0)

    pos = sorted_pos[pidx]                                    # (H, C, P, dim)
    dxv = pos - xh[:, None, None, :]
    dxv = torch.where(dxv > L / 2, dxv - L, dxv)
    dxv = torch.where(dxv < -L / 2, dxv + L, dxv)
    r = torch.sqrt(torch.sum(dxv * dxv, dim=-1))

    lnr = torch.log(torch.clamp(r, min=1e-30))
    rad = lnr - torch.log(Rh)[:, None, None] if use_rdelta else lnr
    lnz = torch.full_like(Mh, float(np.log(1.0 / a)))
    prof = blend_table_radial(grids, table, [lnz, torch.log(Mh)]
                              + [props[:, j] for j in range(n_props)])
    d = radial_readout(prof, grids[2], rad.reshape(H, -1)).reshape(r.shape)
    d = torch.where(r < eps_max * Rh[:, None, None], d, 0.0)
    # the comoving table readout times a: the snapshot's coordinates
    d = torch.where(torch.isfinite(d), d, 0.0) * a
    off = d[..., None] * dxv / torch.clamp(r, min=1e-30)[..., None]
    idx = torch.where(pvalid, pidx, Np).reshape(-1).to(torch.int32)
    return scatter_add_accum(offsets, idx,
                             tuple(off[..., c].reshape(-1)
                                   for c in range(dim)))


class BaryonifySnapshot(DefaultRunnerSnapshot):
    """Displace particles radially around halos. ``process()`` returns
    the new structured catalog (float64 positions in [0, L])."""

    def process(self):
        model = self.model
        if not hasattr(model, '_table'):
            raise NameError("Displacement model has no table. Run "
                            "setup_interpolator() first")
        snap = self.ParticleSnapshot
        L = float(snap.L)
        cat = self.HaloNDCatalog.cat
        if cat.size == 0:
            # no halos: no particle moves
            return snap.cat.copy()
        self._check_caches()
        t0 = self._stage_t0()
        a, R_com, R_q, xh, cols = self._halo_geom()
        self._stage("halo_geom", t0)
        use_rdelta = bool(getattr(model, 'Rdelta_sampling', False))
        if self.method == "cellmajor":
            planes, src = self._process_cellmajor(a, R_com, R_q, xh, cols,
                                                  use_rdelta)
        else:
            planes, src = self._process_gather(a, R_com, R_q, xh,
                                               use_rdelta)
        # the offsets in the original particle order (one gather a plane
        # on the device) go to the host in the hot dtype; the positions
        # are updated in float64
        t0 = self._stage_t0()
        off = torch.stack([p[src] for p in planes], dim=-1).cpu().numpy()
        self._stage("fetch_offsets", t0)
        t0 = self._stage_t0()
        coords = ['x', 'y'] if snap.is2D else ['x', 'y', 'z']
        new_cat = snap.cat.copy()
        for d, cname in enumerate(coords):
            pos = new_cat[cname] + off[:, d]
            pos[pos > L] -= L
            pos[pos < 0] += L
            new_cat[cname] = pos
        self._stage("positions", t0)
        return new_cat

    # ----- per-catalog staging (cached) -----
    def _check_caches(self):
        """Drop the catalog caches if the halo catalog object was
        swapped."""
        if getattr(self, '_cache_cat', None) is not self.HaloNDCatalog:
            for attr in ('_geom_cache', '_cmdense_cache'):
                self.__dict__.pop(attr, None)
            self._cache_cat = self.HaloNDCatalog

    def _halo_geom(self):
        """(a, R_com, R_q, halo positions, packed record columns (H, 16)
        [x y z R lnM lnR | props], positions wrapped into [0, L)), float64
        on the host, cached per catalog."""
        if getattr(self, '_geom_cache', None) is None:
            cosmo = Cosmology.from_dict(self.cosmo,
                                        device=resolve_device(self.device))
            cat = self.HaloNDCatalog.cat
            snap = self.ParticleSnapshot
            a = 1.0 / (1.0 + self.HaloNDCatalog.redshift)
            L = float(snap.L)
            R_phys = self.mass_def.get_radius(
                cosmo, torch.as_tensor(cat['M'], dtype=torch.float64,
                                       device=cosmo.device), a).cpu().numpy()
            R_com = R_phys / a
            R_q = np.clip(self.epsilon_max * R_com, 0, L / 2)
            xh = np.stack([cat[c] for c in (['x', 'y'] if snap.is2D
                                            else ['x', 'y', 'z'])], axis=-1)
            cols = None
            if not snap.is2D:
                cols = np.zeros((cat.size, 16))
                cols[:, :3] = np.mod(xh, L)
                cols[:, 3] = R_com
                cols[:, 4] = np.log(cat['M'])
                cols[:, 5] = np.log(R_com)
                p_keys = getattr(self.model, 'p_keys', []) or []
                for j, k in enumerate(p_keys):
                    cols[:, gcm.PROP_COL0_SNAP + j] = cat[k]
            self._geom_cache = (a, R_com, R_q, xh, cols)
        return self._geom_cache

    def _rank(self):
        """(Np,) the cell-list (sorted) index of each particle, on the
        host, cached."""
        if getattr(self, '_rank_cache', None) is None:
            order = self.tree.order
            rank = np.empty_like(order)
            rank[order] = np.arange(len(order))
            self._rank_cache = rank
        return self._rank_cache

    def _buckets(self, R_q):
        order = np.argsort(R_q)
        return [s for s in np.array_split(order, self.n_buckets)
                if s.size > 0]

    def _prepare(self, table=None):
        """(grids, table) in the hot dtype on the device; ``table``
        defaults to the model's."""
        dev, dt = resolve_device(self.device), self.dtype
        table = self.model._table if table is None else table
        return (tuple(g.to(device=dev, dtype=dt) for g in self.model._grids),
                table.to(device=dev, dtype=dt))

    # ----- gather method -----
    def _process_gather(self, a, R_com, R_q, xh, use_rdelta):
        """The per-halo cell-block method; returns (the offset planes in
        cell-list order, the plane index of each particle)."""
        dt = self.dtype
        tree = self.tree
        snap = self.ParticleSnapshot
        L = float(snap.L)
        grids, table = self._prepare()
        cat = self.HaloNDCatalog.cat
        p_keys = getattr(self.model, 'p_keys', []) or []
        props = (np.stack([cat[k] for k in p_keys], axis=-1)
                 if p_keys else np.zeros((cat.size, 0)))
        t0 = self._stage_t0()
        sorted_pos = self._tensor(self._coords[tree.order], dt)
        cell_start = torch.as_tensor(tree.cell_start, device=self.device)
        cell_count = torch.as_tensor(tree.cell_count, device=self.device)
        src = torch.as_tensor(self._rank(), device=self.device)
        self._stage("staging", t0, sorted_pos)
        offsets = tuple(torch.zeros(len(self._coords), dtype=dt,
                                    device=self.device)
                        for _ in range(self._coords.shape[1]))
        t0 = self._stage_t0()
        for bi, idx in enumerate(self._buckets(R_q)):
            Rmax = float(R_q[idx].max())
            K = min(2 * int(np.ceil(Rmax / tree.h)) + 1, tree.n_cells)
            P = tree.max_per_cell
            chunk = min(self.halo_chunk, len(idx))
            if self.verbose:
                print(f"Baryonifying matter: bucket {bi + 1} ({len(idx)} "
                      f"halos, K={K}, P={P}, chunk {chunk})")
            cols = dict(xh=self._tensor(xh[idx], dt),
                        M=self._tensor(cat['M'][idx], dt),
                        R=self._tensor(R_com[idx], dt),
                        props=self._tensor(props[idx], dt))
            for c0 in range(0, len(idx), chunk):
                c = {k: v[c0:c0 + chunk] for k, v in cols.items()}
                _accumulate_particle_offsets(
                    K, P, tree.n_cells, len(p_keys), use_rdelta, grids,
                    table, float(self.epsilon_max), L, a, sorted_pos,
                    cell_start, cell_count, c['xh'], c['M'], c['R'],
                    c['props'], offsets)
        self._stage("pass", t0, offsets[0])
        return offsets, src

    # ----- cell-major method -----
    def _cm_staging(self, dt):
        """(P_pad, padded position planes, per-cell counts, the padded
        slot of each particle in its original order) on the device, cached
        per dtype."""
        cache = self.__dict__.setdefault('_cmstage_cache', {})
        if dt not in cache:
            tree = self.tree
            P_pad = max(tree.max_per_cell, 1)
            planes, counts_p, pad_idx = scm.pad_particles_by_cell(
                tree, self._coords, P_pad)
            cache[dt] = (P_pad, tuple(self._tensor(p, dt) for p in planes),
                         torch.as_tensor(counts_p, device=self.device),
                         torch.as_tensor(pad_idx[self._rank()],
                                         device=self.device))
        return cache[dt]

    def _cm_dense(self, bi, sel, xh, reach, R_q_sel, dt):
        """Cell candidates of bucket ``bi`` (cached per catalog): (dense,
        counts, counts on the host, K). A wide reach registers at a
        coarser level (2x, 4x or 8x the cell edge) while the per-halo
        window would pass 9 cells a side, then the lists are refined back
        to the cell level (``grid_cellmajor.refine_block_candidates``)."""
        cache = self.__dict__.setdefault('_cmdense_cache', {})
        key = (bi, dt)
        if key not in cache:
            tree = self.tree
            nb, L = tree.n_cells, tree.L
            levels, nb_reg = 0, nb
            while (2 * int(np.ceil(reach / (L / nb_reg) + 1.0)) + 1 > 9
                   and nb_reg % 2 == 0 and nb_reg > 8 and levels < 3):
                nb_reg //= 2
                levels += 1
            W = min(2 * int(np.ceil(reach / (L / nb_reg) + 1.0)) + 1,
                    nb_reg)
            xm = np.mod(xh[sel], L)
            pos = [self._tensor(xm[:, d], dt) for d in range(3)]
            rr = self._tensor(np.minimum(reach, np.asarray(R_q_sel)), dt)
            hids, cell_start, K = gcm.register_halos_grid(nb_reg, W, L, *pos,
                                                          rr)
            dense, counts = dense_cell_candidates(nb_reg ** 3, max(K, 1),
                                                  hids, cell_start)
            hrec = torch.stack(pos + [rr], dim=-1)
            while nb_reg < nb:
                nb_reg *= 2
                dense2d, counts, K = gcm.refine_block_candidates(
                    nb_reg, dense, counts, hrec, L / nb_reg, L)
                dense = dense2d[:, :max(K, 1)].reshape(-1).contiguous()
            cache[key] = (dense, counts, counts.cpu().numpy(), K)
        return cache[key]

    def _process_cellmajor(self, a, R_com, R_q, xh, cols, use_rdelta,
                           table=None):
        """The dense pass of every bucket; returns (the padded offset
        planes, in the hot dtype on the device, the padded slot of each
        particle). ``table`` (default the model's) may carry a graph: the
        passes are then recorded with their step-wise adjoint. A list in
        ``self.census`` gets each bucket's counts (see
        ``snapshot_cellmajor.snapshot_offsets_pass``; for measurement
        only: it synchronises once a step). With a mesh each rank runs its
        own cells, and the planes are gathered over the mesh."""
        dt = self.dtype
        tree = self.tree
        nb = tree.n_cells
        L = float(self.ParticleSnapshot.L)
        eps = float(self.epsilon_max)
        grids, table = self._prepare(table)
        mesh = self.mesh
        if mesh is not None:
            table = mesh_grad_sum(mesh, self.mesh_axis, table)
        t0 = self._stage_t0()
        table_z, inb_z = gcm.blend_table_z(
            table, grids[0], float(np.log(1.0 + self.HaloNDCatalog.redshift)))
        table_z = torch.where(torch.isfinite(table_z), table_z, 0.0)
        P_pad, planes, counts_p, slot_of = self._cm_staging(dt)
        packed = self._tensor(cols, dt)
        self._stage("staging", t0, packed)
        g2_np = self.model._grids[2].cpu().numpy()
        # the radial grid's nodes as the hot dtype holds them
        g_hot = g2_np.astype(str(dt).split('.')[-1])
        g0, dg = float(g_hot[0]), float(g_hot[1] - g_hot[0])
        n_props = len(grids) - 3
        p0 = gcm.PROP_COL0_SNAP
        lo, hi = ((0, nb ** 3) if mesh is None else
                  mesh_snap_cells(mesh, self.mesh_axis, nb ** 3, P_pad))
        out = tuple(torch.zeros((hi - lo) * P_pad, dtype=dt,
                                device=self.device) for _ in range(3))
        # a catalog redshift outside the table moves nothing
        for bi, idx in enumerate(self._buckets(R_q) if inb_z else []):
            reach = float(R_q[idx].max())
            t0 = self._stage_t0()
            dense, counts, counts_host, K = self._cm_dense(
                bi, idx, xh, reach, R_q[idx], dt)
            self._stage(f"reg[b{bi} H{len(idx)}]", t0, counts)
            rad_max = (np.log(eps) if use_rdelta
                       else np.log(eps * R_com[idx].max()))
            n_hi = self._node_bound(g2_np, rad_max, len(g2_np))
            if self.verbose:
                print(f"Baryonifying matter: bucket {bi + 1} ({len(idx)} "
                      f"halos, n_cells={nb}, K={K}, P={P_pad}, "
                      f"n_hi={n_hi})")
            t0 = self._stage_t0()
            pk = packed[torch.as_tensor(idx, device=self.device)]
            rows = gcm.halo_rows(grids[1], grids[3:], table_z, pk[:, 4],
                                 pk[:, p0:p0 + n_props], n_hi)
            census = None
            if getattr(self, 'census', None) is not None:
                census = dict(bucket=bi, H=len(idx), K=K, P=P_pad,
                              n_hi=n_hi, pairs=0, inside=0, steps=0)
                self.census.append(census)
            args = (use_rdelta, P_pad, n_hi, dense, counts, counts_host,
                    planes, counts_p, pk, rows, g0, dg,
                    float(g_hot[n_hi - 1]), eps, a, L)
            bucket = (scm.snapshot_pass_diff(*args, census=census)
                      if mesh is None else mesh_snap_offsets_bucket(
                          mesh, self.mesh_axis, *args, census=census))
            for o, b in zip(out, bucket):
                o += b
            self._stage(f"pass[b{bi} K{K} n_hi{n_hi}]", t0, out[0])
        if mesh is not None:
            out = tuple(mesh_place(mesh, self.mesh_axis, o, lo * P_pad,
                                   nb ** 3 * P_pad) for o in out)
        return out, slot_of

    def _positions(self, dt):
        """The original (x, y, z) particle positions on the device in the
        hot dtype, cached per dtype."""
        cache = self.__dict__.setdefault('_pos_cache', {})
        if dt not in cache:
            cat = self.ParticleSnapshot.cat
            cache[dt] = tuple(self._tensor(cat[c], dt) for c in 'xyz')
        return cache[dt]

    def process_device(self, table=None):
        """Differentiable displacement (the port of the JAX package's
        ``BaryonifySnapshot.process_device``), cell-major only, as there.

        Returns the displaced (x, y, z) positions in the original particle
        order as tensors on the device, in the hot-path dtype: each
        original position plus its offset, wrapped back into [0, L] on the
        device, as the JAX package does. ``table`` (default
        ``model._table``) may carry a graph (e.g. from
        ``build_table_device``): gradients flow from any scalar of the
        positions (e.g. a P(k) band of their CIC density) through the
        passes' step-wise adjoint (``snapshot_cellmajor.
        snapshot_pass_diff``) and the row blend into the table. The cell
        list, the padded particle planes and the registrations are staged
        once in the runner's caches and held constant. :meth:`process`
        adds the same offsets to the positions in float64 on the host: in
        float64 the two agree bit for bit; in float32 they differ by the
        rounding of the positions to float32."""
        if self.method != "cellmajor":
            raise ValueError(f"process_device runs the cell-major method "
                             f"only; this runner's method is {self.method!r}")
        pos = self._positions(self.dtype)
        if self.HaloNDCatalog.cat.size == 0:
            return tuple(p.clone() for p in pos)
        L = float(self.ParticleSnapshot.L)
        self._check_caches()
        a, R_com, R_q, xh, cols = self._halo_geom()
        use_rdelta = bool(getattr(self.model, 'Rdelta_sampling', False))
        planes, src = self._process_cellmajor(a, R_com, R_q, xh, cols,
                                              use_rdelta, table=table)
        out = []
        for p, o in zip(pos, planes):
            x = p + o[src]
            x = torch.where(x > L, x - L, x)
            out.append(torch.where(x < 0, x + L, x))
        return tuple(out)
