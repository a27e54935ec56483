"""Parallel orchestration: task-parallel runners and the device mesh.

The port of ``baryonification_tpu.parallel``, with ``torch.distributed``
in place of ``shard_map`` over a ``jax.sharding.Mesh``.

- ``SimpleParallel``: run a list of runners, outputs in input order; job
  i computes on card i mod n (the reference's task-parallel pool,
  ``Parallelize.py:92-113``, moved onto local cards).
- ``SplitJoinParallel``: shard ONE painting runner's halo catalog and sum
  the outputs (``Parallelize.py:116-321``). Baryonify* runners are
  rejected: displacement -> regrid is not additive over halo shards.
- The mesh path (``mesh=`` on every runner, cell-major method): the mesh
  is a 1-D ``torch.distributed.device_mesh.DeviceMesh``, or one named
  dimension of a larger one, and every rank of its group runs the same
  program on the same inputs. Cells are disjoint patches of the sky or
  the box: NESTED coarse cells for the shell, Morton blocks for the grid,
  cell-list cells for the snapshot. Each rank registers every bucket
  (replicated geometry) and runs the cell-major pass on its own
  contiguous range of cells only; the one cross-rank step is a sum
  (``all_reduce``) of full-size partial maps. For baryonification this
  is exact, because the offsets are summed before the single regrid
  (``HealpixRunner.py:331-333``), which is why the mesh path supports
  baryonify although ``SplitJoinParallel`` cannot.

Joins use ``all_reduce`` only (gloo has ``all_reduce`` and ``broadcast``
on CUDA tensors, so two gloo ranks on one card run the same code as NCCL
ranks on many): a rank's share is placed in a zero-filled full-size
tensor and the shares are summed.

Gradients: every rank computes the loss alike from the replicated map.
A join whose result is used alike on every rank (``mesh_sum(...,
replicated=True)``) has the identity as its backward, so each rank holds
the gradient of its own cells only; a join whose result each rank goes
on to use for its own share of work (the grid's offsets before the
sharded CIC) sums the cotangents again. :func:`mesh_grad_sum` marks an
input (a table, a canvas): the identity forward, a sum over the mesh in
its backward, so every rank returns the full gradient, as ``jax.grad``
through ``shard_map`` does, and never world-size times it.
"""

import copy

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F_nn

__all__ = ['SimpleParallel', 'SplitJoinParallel', 'mesh_shard_halos',
           'mesh_cellmajor_shell', 'mesh_offsets_bucket',
           'mesh_paint_bucket', 'mesh_regrid_shell', 'min_coarse_nside',
           'mesh_grid_offsets_bucket', 'mesh_grid_paint_bucket',
           'mesh_grid_anis_paint_bucket', 'mesh_grid_cic',
           'mesh_snap_offsets_bucket', 'pad_cells_for_mesh', 'pad_rows',
           'cell_chunk', 'mesh_rank', 'mesh_share', 'mesh_snap_cells',
           'mesh_sum', 'mesh_place', 'mesh_grad_sum']


class SimpleParallel:
    """Run a list of runners; returns their outputs in input order.

    Job i computes on card ``i % n``, n = min(``njobs``, the card count)
    (``njobs`` <= 0: every card): a runner built with the default
    ``device="cuda"`` runs under ``torch.cuda.device(i % n)``. A runner
    built for the CPU (or for one named card) runs where it was built;
    nothing is moved to the CPU in the absence of a card."""

    def __init__(self, joblist, njobs=-1, verbose=True):
        self.joblist = joblist
        self.njobs = njobs
        self.verbose = verbose

    def process(self):
        return [_run_on(r, i, self.njobs) for i, r in
                enumerate(self.joblist)]


def _run_on(runner, i, njobs):
    """``runner.process()`` on card ``i % n`` where the runner takes the
    current card (device "cuda"), else where it was built."""
    dev = torch.device(getattr(runner, 'device', 'cpu'))
    n_cards = torch.cuda.device_count()
    n = min(njobs if njobs > 0 else n_cards, n_cards)
    if dev.type != 'cuda' or dev.index is not None or n == 0:
        return runner.process()
    with torch.cuda.device(i % n):
        return runner.process()


def _get_catalog(runner):
    if hasattr(runner, 'HaloLightConeCatalog'):
        return runner.HaloLightConeCatalog, 'HaloLightConeCatalog'
    return runner.HaloNDCatalog, 'HaloNDCatalog'


class SplitJoinParallel:
    """Split one runner's halo catalog into shards and sum the outputs.

    Only additive (painting) runners are allowed; a seeded shuffle
    balances the load like the reference (``Parallelize.py:252-255``).
    Each shard is a shallow copy of the runner without its per-catalog
    caches (registration, staged geometry, remap; the runner's
    ``_CATALOG_CACHES``), so it stages its own catalog; the caches that
    depend on the map alone stay shared."""

    def __init__(self, Runner, njobs=-1, seed=42, verbose=True):
        from .runners import (BaryonifyShell, BaryonifyGrid,
                              BaryonifySnapshot)
        txt = ("SplitJoinParallel can only be used for PaintProfiles "
               "runners: baryonification's displacement -> regrid step is "
               "nonlinear, so halo shards cannot be joined additively "
               "(use the device-mesh path instead, which sums the offset "
               "field before a single regrid).")
        assert not isinstance(Runner, (BaryonifyShell, BaryonifyGrid,
                                       BaryonifySnapshot)), txt
        self.Runner = Runner
        self.njobs = njobs if njobs > 0 else max(torch.cuda.device_count(),
                                                 1)
        self.seed = seed
        self.verbose = verbose

        cat, attr = _get_catalog(Runner)
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(cat))
        shards = np.array_split(order, self.njobs)

        self.runner_list = []
        for s in shards:
            if s.size == 0:
                continue
            r = copy.copy(Runner)
            for name in getattr(r, '_CATALOG_CACHES', ()):
                r.__dict__.pop(name, None)
            setattr(r, attr, cat[np.sort(s)])
            self.runner_list.append(r)

    def process(self):
        """Run the shards round-robin over the cards and sum: the
        reference's additive join (``Parallelize.py:297-319``). For one
        program over many cards, pass ``mesh=`` to the runner itself (the
        cell-sharded path), which needs no catalog split."""
        out = None
        for i, r in enumerate(self.runner_list):
            res = _run_on(r, i, self.njobs)
            out = res if out is None else out + res
        return out


# ----- the mesh -----

def mesh_rank(mesh, axis=None):
    """(process group, this rank's index in it, its size) of mesh
    dimension ``axis`` (a name, or an index; default the first). Ranks
    come from the group, never from the global rank."""
    group = mesh.get_group(0 if axis is None else axis)
    return group, dist.get_rank(group), dist.get_world_size(group)


class _Join(torch.autograd.Function):
    """Sum of every rank's ``x`` over ``group`` (``all_reduce``). With
    ``replicated`` the result is used alike on every rank, and the
    backward is the identity; otherwise each rank goes on with its own
    share of work on it, its cotangent is a partial, and the backward
    sums them."""

    @staticmethod
    def forward(ctx, x, group, replicated):
        ctx.group, ctx.replicated = group, replicated
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.replicated:
            return g, None, None
        return _Join.apply(g, ctx.group, False), None, None


class _GradSum(torch.autograd.Function):
    """The identity, whose backward sums the cotangent over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return _Join.apply(g, ctx.group, True), None


def mesh_sum(mesh, axis, x, replicated=True):
    """The sum of every rank's ``x`` over mesh dimension ``axis``: the
    port's ``psum``, differentiable (see the module docstring for
    ``replicated``)."""
    return _Join.apply(x, mesh_rank(mesh, axis)[0], replicated)


def mesh_grad_sum(mesh, axis, x):
    """``x`` unchanged, its gradient summed over mesh dimension ``axis``:
    applied to an input that feeds only the ranks' own shares of work, so
    that every rank's gradient of it is the whole gradient."""
    return _GradSum.apply(x, mesh_rank(mesh, axis)[0])


def mesh_shard_halos(mesh, axis, halo_arrays):
    """This rank's contiguous share of every column (numpy array or
    tensor with at least one axis) of ``halo_arrays`` (a dict, list or
    tuple, nested as deep as it likes), split along axis 0 as
    ``np.array_split``; scalars stay as they are."""
    _, rank, n = mesh_rank(mesh, axis)

    def share(x):
        if isinstance(x, dict):
            return {k: share(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(share(v) for v in x)
        if isinstance(x, torch.Tensor):
            return torch.tensor_split(x, n)[rank] if x.dim() else x
        if np.ndim(x) >= 1:
            return np.array_split(np.asarray(x), n)[rank]
        return x

    return share(halo_arrays)


def cell_chunk(ncell, F, target=1 << 18):
    """Single-device chunk policy: cells a step, the largest power of two
    with ``C_blk * F <= target`` that divides ``ncell`` exactly."""
    c = 1
    while c * 2 * F <= target and ncell % (c * 2) == 0:
        c *= 2
    return c


def pad_cells_for_mesh(ncell, n_dev, F, target=1 << 18):
    """Pad the cell/block axis so it splits evenly over ``n_dev`` ranks in
    whole chunks.

    Returns ``(ncell_pad, C_blk)``: ``C_blk`` is the largest power of two
    with ``C_blk * F <= target`` that does not exceed the per-rank cell
    count, and ``ncell_pad = n_dev * ceil(ceil(ncell / n_dev) / C_blk) *
    C_blk``. Rank r owns padded cells [r ncell_pad / n_dev, (r + 1)
    ncell_pad / n_dev); padding cells have no candidates, so the mesh path
    runs on any rank count."""
    local = -(-ncell // n_dev)
    C_blk = 1
    while C_blk * 2 * F <= target and C_blk * 2 <= local:
        C_blk *= 2
    local_pad = -(-local // C_blk) * C_blk
    return local_pad * n_dev, C_blk


def pad_rows(arr, n_rows):
    """Zero-pad ``arr`` (a tensor or numpy array) along axis 0 to
    ``n_rows``."""
    cur = arr.shape[0]
    if cur == n_rows:
        return arr
    if isinstance(arr, torch.Tensor):
        return torch.cat([arr, arr.new_zeros((n_rows - cur,) + arr.shape[1:])])
    return np.pad(arr, [(0, n_rows - cur)] + [(0, 0)] * (arr.ndim - 1))


def min_coarse_nside(n_devices):
    """Smallest power-of-two nside_c whose cell count (12 nside_c^2)
    splits evenly over ``n_devices`` ranks: the coarseness floor of the
    shell's cell-sharded path.

    12 nside_c^2 is 3 * 2^(2k+2), so only counts of the form 2^a or
    3 * 2^a ever divide it; any other raises (the grid and snapshot
    runners pad instead and take any count)."""
    nsc = 1
    while (12 * nsc * nsc) % n_devices:
        nsc *= 2
        if nsc > (1 << 15):
            raise ValueError(
                f"no HEALPix coarse level splits 12*nside_c^2 cells "
                f"evenly over {n_devices} devices (counts must be "
                f"2^a or 3*2^a); use a power-of-two device subset")
    return nsc


def mesh_share(mesh, axis, n_items):
    """[lo, hi) of this rank's equal contiguous share of ``n_items`` (a
    multiple of the rank count): the shell's NESTED cells and pixels."""
    _, rank, n = mesh_rank(mesh, axis)
    if n_items % n:
        raise ValueError(f"{n_items} cells or pixels do not split evenly "
                         f"over {n} ranks")
    per = n_items // n
    return rank * per, (rank + 1) * per


def _padded_share(mesh, axis, ncell, F):
    """[lo, hi) of this rank's real cells under :func:`pad_cells_for_mesh`
    (empty where the rank holds padding only)."""
    _, rank, n = mesh_rank(mesh, axis)
    per = pad_cells_for_mesh(ncell, n, F)[0] // n
    return min(rank * per, ncell), min((rank + 1) * per, ncell)


# ----- the shell: NESTED coarse cells -----

def _mesh_shell_pass(mesh, axis, mode, planes, pix, dense, counts, F,
                     recs, rows, g0, dg, rad_hi, diff):
    from .ops.cellmajor_cuda import cellmajor_pass, cellmajor_pass_diff
    ncell = counts.shape[0]
    lo, hi = mesh_share(mesh, axis, ncell)
    K = dense.shape[0] // ncell
    sl = slice(lo * F, hi * F)
    return (cellmajor_pass_diff if diff else cellmajor_pass)(
        mode, planes, tuple(v[sl] for v in pix), dense[lo * K:hi * K],
        counts[lo:hi], F, recs, rows, g0, dg, rad_hi)


def mesh_offsets_bucket(mesh, axis, use_rdelta, F, planes, pix, dense,
                        counts, recs, rows, g0, dg, rad_hi, diff=False):
    """One bucket of the cell-sharded displacement pass.

    NESTED cells are disjoint sky patches: this rank runs the cell-major
    pass (``ops.cellmajor_cuda``, the kernel on the card) on its
    contiguous share of the cells, with no communication. ``pix`` (the
    three NESTED pixel planes), ``dense`` ((ncell * K,) candidates) and
    ``counts`` are the whole sky's, replicated on every rank, as are the
    bucket's slot records ``recs`` and radial ``rows``; ``planes`` (the
    three offset planes) are this rank's share, npix / n pixels, and
    carry across buckets. Returns the new share: in place, or with
    ``diff`` the differentiable pass's new planes."""
    mode = "offsets_rdelta" if use_rdelta else "offsets"
    return _mesh_shell_pass(mesh, axis, mode, planes, pix, dense, counts, F,
                            recs, rows, g0, dg, rad_hi, diff)


def mesh_paint_bucket(mesh, axis, F, planes, pix, dense, counts, recs,
                      rows, g0, dg, rad_hi, diff=False):
    """One bucket of the cell-sharded painting pass: as
    :func:`mesh_offsets_bucket` with the one paint plane (painting is
    local to each rank's pixels)."""
    return _mesh_shell_pass(mesh, axis, "paint", planes, pix, dense, counts,
                            F, recs, rows, g0, dg, rad_hi, diff)


def mesh_regrid_shell(mesh, axis, nside, pix_planes, orig_map_nested,
                      offsets):
    """Cell-sharded conservative regrid: this rank redeposits its own
    pixels' mass (the 4-neighbour bilinear deposit may cross the share's
    edge) into a full-sky partial RING map, and one sum over the mesh
    joins the partials. ``pix_planes`` and ``orig_map_nested`` are the
    whole sky's in NESTED order, ``offsets`` this rank's share. Returns
    the new RING map, replicated."""
    from .runners.shell import _regrid_shell
    lo, hi = mesh_share(mesh, axis, orig_map_nested.shape[0])
    partial = _regrid_shell(nside, *(v[lo:hi] for v in pix_planes),
                            orig_map_nested[lo:hi], offsets)
    return mesh_sum(mesh, axis, partial)


def mesh_cellmajor_shell(mesh, axis, nside, F, use_rdelta, pix_planes,
                         dense, counts, recs, rows, g0, dg, rad_hi,
                         orig_map):
    """Multi-rank shell baryonify of ONE bucket: the cell-sharded offsets
    pass and the summed regrid. ``pix_planes`` and ``orig_map`` (the mass
    map) are NESTED and whole; returns the new RING map, replicated."""
    npix = orig_map.shape[0]
    lo, hi = mesh_share(mesh, axis, npix)
    zero = orig_map.new_zeros(hi - lo)
    offsets = mesh_offsets_bucket(
        mesh, axis, use_rdelta, F, (zero, zero.clone(), zero.clone()),
        pix_planes, dense, counts, recs, rows, g0, dg, rad_hi)
    return mesh_regrid_shell(mesh, axis, nside, pix_planes, orig_map,
                             offsets)


# ----- the grid: Morton blocks -----

def _mesh_grid_bucket(mesh, axis, make_bucket, B, dim, dense, counts,
                      counts_host, rows, census, extra=()):
    """This rank's blocks of one grid bucket: (its first block-major
    element, its block-major planes). The block axis is split as
    :func:`pad_cells_for_mesh` pads it; ``extra`` (block-major, whole)
    are sliced alike."""
    from .runners.grid_cellmajor import _pass_diff
    F = B ** dim
    ncell = counts.shape[0]
    lo, hi = _padded_share(mesh, axis, ncell, F)
    K = dense.shape[0] // ncell
    bk = make_bucket(dense[lo * K:hi * K], counts[lo:hi],
                     counts_host[lo:hi], lo)
    return lo * F, _pass_diff(bk, rows, census,
                              tuple(x[lo * F:hi * F] for x in extra))


def mesh_grid_offsets_bucket(mesh, axis, use_rdelta, dim, B, n_hi, N, half,
                             dense, counts, counts_host, packed, rows, g0,
                             dg, rad_hi, eps_max, res, census=None):
    """One bucket of the block-sharded grid displacement pass
    (``grid_cellmajor.grid_pass_diff`` on this rank's contiguous range of
    Morton blocks, its coordinates from the global block ids; no
    communication). The candidates are the whole grid's; returns (the
    rank's first block-major element, its ``dim`` block-major offset
    planes)."""
    return _mesh_grid_paint_or_offsets(
        mesh, axis, "offsets_rdelta" if use_rdelta else "offsets", dim, B,
        n_hi, N, half, dense, counts, counts_host, packed, rows, g0, dg,
        rad_hi, eps_max, res, census)


def mesh_grid_paint_bucket(mesh, axis, dim, B, n_hi, N, half, dense,
                           counts, counts_host, packed, rows, g0, dg, rad_hi,
                           eps_max, res, census=None):
    """One bucket of the block-sharded grid painting pass: as
    :func:`mesh_grid_offsets_bucket` with the one paint plane."""
    return _mesh_grid_paint_or_offsets(
        mesh, axis, "paint", dim, B, n_hi, N, half, dense, counts,
        counts_host, packed, rows, g0, dg, rad_hi, eps_max, res, census)


def _mesh_grid_paint_or_offsets(mesh, axis, mode, dim, B, n_hi, N, half,
                                dense, counts, counts_host, packed, rows, g0,
                                dg, rad_hi, eps_max, res, census):
    from .runners.grid_cellmajor import _GridBucket
    return _mesh_grid_bucket(
        mesh, axis, lambda d, c, ch, b0: _GridBucket(
            mode, dim, B, n_hi, N, half, d, c, ch, packed, g0, dg, rad_hi,
            eps_max, res, block0=b0),
        B, dim, dense, counts, counts_host, rows, census)


def mesh_grid_anis_paint_bucket(mesh, axis, B, n_hi, N, dense, counts,
                                counts_host, packed, rows, live_h, q0, dq,
                                eps_max, res, canvas_bm, census=None):
    """One bucket of the block-sharded anisotropic paint
    (``grid_cellmajor.grid_anis_paint_pass_2d`` on this rank's blocks):
    as :func:`mesh_grid_paint_bucket`, with the whole block-major canvas
    ``canvas_bm`` sliced alongside."""
    from .runners.grid_cellmajor import _AnisBucket
    return _mesh_grid_bucket(
        mesh, axis, lambda d, c, ch, b0: _AnisBucket(
            B, n_hi, N, d, c, ch, packed, live_h, q0, dq, eps_max, res,
            block0=b0),
        B, 2, dense, counts, counts_host, rows, census, (canvas_bm,))


def mesh_grid_cic(mesh, axis, N, vals_rm, offsets_rm):
    """Block-sharded conservative CIC redeposit (2D or 3D by the number of
    offset planes): this rank deposits its own row-major range of pixels
    (ceil(N^d / n) of them; the 2-cell stencil may cross the range's edge)
    into a full-size partial, and one sum joins them. ``vals_rm`` and
    ``offsets_rm`` are whole and replicated; returns the flat map,
    replicated."""
    from .ops.scatter import _cic_deposit
    _, rank, n = mesh_rank(mesh, axis)
    dim = len(offsets_rm)
    size = N ** dim
    per = -(-size // n)
    lo, hi = min(rank * per, size), min((rank + 1) * per, size)
    dt = vals_rm.dtype
    i = torch.arange(lo, hi, device=vals_rm.device)
    pos = [o[lo:hi] + ((i // N ** (dim - 1 - d)) % N).to(dt)
           for d, o in enumerate(offsets_rm)]
    return mesh_sum(mesh, axis, _cic_deposit(N, pos, vals_rm[lo:hi], dt))


# ----- the snapshot: cell-list cells -----

def mesh_snap_cells(mesh, axis, ncell, P):
    """[lo, hi) of this rank's cell-list cells (padded as
    :func:`pad_cells_for_mesh` with P particle slots a cell)."""
    return _padded_share(mesh, axis, ncell, P)


def mesh_snap_offsets_bucket(mesh, axis, use_rdelta, P, n_hi, dense,
                             counts_h, counts_host, planes, counts_p, packed,
                             rows, g0, dg, rad_hi, eps_max, a_scale, L,
                             census=None):
    """One bucket of the cell-sharded particle displacement pass
    (``snapshot_cellmajor.snapshot_pass_diff`` on this rank's cells of
    :func:`mesh_snap_cells`; no communication). The candidates, counts
    and padded particle planes are the whole box's; returns this rank's
    three padded offset planes (its cells' P slots each)."""
    from .runners.snapshot_cellmajor import snapshot_pass_diff
    ncell = counts_h.shape[0]
    lo, hi = mesh_snap_cells(mesh, axis, ncell, P)
    K = dense.shape[0] // ncell
    return snapshot_pass_diff(
        use_rdelta, P, n_hi, dense[lo * K:hi * K], counts_h[lo:hi],
        counts_host[lo:hi], tuple(p[lo * P:hi * P] for p in planes),
        counts_p[lo:hi], packed, rows, g0, dg, rad_hi, eps_max, a_scale, L,
        census=census)


def mesh_place(mesh, axis, share, start, size):
    """The sum over the mesh of each rank's ``share`` placed at
    [start, start + len) of a zero tensor of ``size``: the gather of
    disjoint shares with ``all_reduce`` alone; replicated."""
    return mesh_sum(mesh, axis, F_nn.pad(
        share, (start, size - start - share.shape[0])))
