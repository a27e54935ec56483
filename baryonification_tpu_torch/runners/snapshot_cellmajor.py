"""Cell-major pass of the particle-snapshot runner.

The port of ``baryonification_tpu.runners.snapshot_cellmajor``. The
halo-major ``gather`` method (``runners/snapshot.py``) takes, per halo, a
K^3 block of cell-list cells x P padded particle slots and ends in a
scatter-add of the overlapping offsets. This module inverts the loop, as
the grid passes do:

  1. the particles are PADDED PER CELL once per catalog: (ncell * P)
     position planes in Morton cell order, slot p of cell c holding the
     cell-list particle start[c] + p (:func:`pad_particles_by_cell`), so
     the pass reads fixed-shape blocks with no gather on the particle
     side;
  2. halos register in every cell their eps_max * R reach may touch (the
     grid runners' Morton registration and refinement, cached per
     catalog and bucket by the runner);
  3. one dense pass a bucket (:func:`snapshot_offsets_pass`): each
     particle slot sums the offsets of its cell's candidates, and each
     slot is written once.

Both methods reduce to the same r < eps_max * R mask: the halo-major block
always covers the whole eps_max * R sphere.

In the JAX package the pass is XLA: a ``lax.map`` over chunks of cells
with a ``fori_loop`` over the candidates, one profile row rebuilt per
slot by a one-hot matmul. Here each halo's radial row is blended once a
bucket (``grid_cellmajor.halo_rows``) and the readout is a lerp of two
nodes. On the card the pass is one launch a bucket of the hand-written
kernel ``snap_pass`` and its first-order adjoint one of ``snap_vjp``
(``ops/snap_pass_cuda.py``, ``csrc/snap_pass.cu``), dispatched as the
grid passes' kernels are (``grid_cellmajor._pass_diff``). Their plain
version, which CPU tensors take, is the grid passes' step loop on a
:class:`_SnapBucket`: a step takes a group of candidate slots of a chunk
of cells at once, as one (cells, slots, particles) tensor of at most
``PASS_BUDGET`` elements, so the pass costs a few dozen launches a step,
not a dozen a candidate.
"""

import numpy as np
import torch

from ..ops import snap_pass_cuda
from ..parallel import cell_chunk
from .grid_cellmajor import PASS_BUDGET, _bucket_pass, _pass_diff, \
    gather_rows, tallied

__all__ = ["np_morton3_of_rowmajor", "pad_particles_by_cell",
           "snapshot_offsets_pass", "snapshot_pass_diff"]


def _np_spread3(v):
    v = v.astype(np.int64)
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def np_morton3_of_rowmajor(rm, nb):
    """Morton id of each row-major cell id ((x nb + y) nb + z; host
    numpy), the ids of ``grid_cellmajor.morton3``."""
    cx, cyz = rm // (nb * nb), rm % (nb * nb)
    cy, cz = cyz // nb, cyz % nb
    return (_np_spread3(cx) | (_np_spread3(cy) << 1)
            | (_np_spread3(cz) << 2))


def pad_particles_by_cell(tree, coords, P_pad):
    """(dim, ncell * P_pad) padded position planes (cells in Morton
    order), the (ncell,) per-cell counts in that order, and the (Np,) map
    from cell-list (sorted) particle index to padded slot. Host numpy,
    once per catalog. Pad slots hold the cell's first particle (masked by
    the count in the pass)."""
    ncell = len(tree.cell_count)
    nb = tree.n_cells
    Np = coords.shape[0]
    dim = coords.shape[1]
    srt = coords[tree.order]
    m_of_rm = np_morton3_of_rowmajor(np.arange(ncell), nb)
    counts_rm = np.minimum(tree.cell_count, P_pad).astype(np.int32)
    counts = np.zeros(ncell, dtype=np.int32)
    counts[m_of_rm] = counts_rm
    # sorted index i lives in cell sorted_cid[i] at slot i - start[cell]
    cell_of = tree.sorted_cid
    slot_of = np.arange(Np) - tree.cell_start[cell_of]
    pad_idx = (m_of_rm[cell_of] * P_pad + slot_of).astype(np.int64)
    first_rm = srt[tree.cell_start.clip(0, Np - 1)]       # (ncell, dim)
    planes = np.zeros((dim, ncell * P_pad))
    for d in range(dim):
        base = np.zeros(ncell)
        base[m_of_rm] = first_rm[:, d]
        planes[d] = np.repeat(base, P_pad)
        planes[d, pad_idx] = srt[:, d]
    return planes, counts, pad_idx


class _SnapBucket:
    """One bucket of the snapshot pass: its constant inputs, its chunks
    of cells and groups of candidate slots, the geometry of a step
    (positions only) and its values (the rows); the plain pass and its
    adjoint both step through it, and on the card its kernels take its
    inputs (``grid_cellmajor._GridBucket`` is the grid's). The candidates
    and counts stay in the registration's int32."""

    #: what the warnings and errors of its pass call it
    name = "snapshot"

    def __init__(self, use_rdelta, P, n_hi, dense, counts_h, counts_host,
                 planes, counts_p, packed, g0, dg, rad_hi, eps_max, a_scale,
                 L):
        self.ncell = counts_h.shape[0]
        self.K = dense.shape[0] // max(self.ncell, 1)
        self.P = self.unit = P
        self.n_planes = 3
        self.n_hi, self.rdelta = n_hi, use_rdelta
        self.dense2 = dense.reshape(self.ncell, self.K)
        self.counts_h = counts_h
        self.counts_host = counts_host
        self.counts_p = counts_p
        self.planes = tuple(planes)
        self.g0, self.dg, self.rad_hi = g0, dg, rad_hi
        self.a_scale, self.L = a_scale, L
        # the per-halo columns a slot reads: position, reach (, ln R_com)
        hcols = [packed[:, 0], packed[:, 1], packed[:, 2],
                 eps_max * packed[:, 3]]
        if use_rdelta:
            hcols.append(packed[:, 5])
        self.hrec = torch.stack(hcols, dim=-1)
        self.pos = [p.reshape(self.ncell, P) for p in planes]
        self.slot = torch.arange(P, device=packed.device)

    def kernel_args(self, rows):
        """The leading arguments of ``ops.snap_pass_cuda.snap_pass`` and
        ``snap_vjp`` for this bucket and ``rows``."""
        return (self.rdelta, self.P, self.planes, self.counts_p, self.dense2,
                self.counts_h, self.hrec, rows)

    def kernel_scalars(self):
        """The trailing (g0, dg, rad_hi, a_scale, L) of those entries."""
        return self.g0, self.dg, self.rad_hi, self.a_scale, self.L

    def kernel_pass(self, rows, census=None, extra=()):
        """The ``snap_pass`` kernel on this bucket: its new planes; a
        ``census`` gets its (particle, halo) pairs listed and inside
        (``grid_cellmajor.tallied``). The pass has no ``extra`` inputs."""
        return tallied(lambda tally: snap_pass_cuda.snap_pass(
            *self.kernel_args(rows), *self.kernel_scalars(), tally=tally),
            snap_pass_cuda.TALLY, ("pairs", "inside"), census, rows.device)

    def kernel_vjp(self, rows, cts, extra=(), needs=None):
        """The ``snap_vjp`` kernel on this bucket: (d_rows for ``cts``,)."""
        return (snap_pass_cuda.snap_vjp(*self.kernel_args(rows), cts,
                                        *self.kernel_scalars()),)

    def chunks(self):
        """(c0, c1, (p_ok, pos), [(k0, k1), ...]) of every chunk of cells
        with a candidate: p_ok the chunk's (C, 1, P) real-particle mask and
        pos its (C, 1, P) position planes; a step is one (cells, slots,
        particles) tensor of at most PASS_BUDGET elements."""
        P = self.P
        C = cell_chunk(self.ncell, P * max(1, min(self.K, 16)), PASS_BUDGET)
        for c0 in range(0, self.ncell, C):
            c1 = c0 + C
            k_max = int(self.counts_host[c0:c1].max())
            if k_max == 0:
                continue
            p_ok = (self.slot[None, :]
                    < self.counts_p[c0:c1, None])[:, None, :]
            pos = [p[c0:c1, None, :] for p in self.pos]
            G = max(1, min(k_max, PASS_BUDGET // (C * P)))
            yield c0, c1, (p_ok, pos), [(k0, min(k0 + G, k_max))
                                        for k0 in range(0, k_max, G)]

    def geometry(self, c0, c1, cg, k0, k1, census=None):
        """The step's row nodes and weights, mask, radii and min-image
        deltas: dict(base, w, live, r, dx)."""
        dev = self.hrec.device
        L = self.L
        p_ok, pos = cg
        hid = self.dense2[c0:c1, k0:k1].to(torch.int64)        # (C, G)
        ok = (torch.arange(k0, k1, device=dev)[None, :]
              < self.counts_h[c0:c1, None])
        rec = self.hrec[hid]                                   # (C, G, .)
        dx = []
        for d in range(3):
            v = pos[d] - rec[..., d, None]
            dx.append(v - L * torch.round(v / L))              # (C, G, P)
        r = torch.sqrt(dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2])
        rad = torch.log(torch.clamp(r, min=1e-30))
        if self.rdelta:
            rad = rad - rec[..., 4, None]
        t = (rad - self.g0) / self.dg
        i = torch.clamp(torch.floor(t), 0, self.n_hi - 2)
        live = ((rad >= self.g0) & (rad <= self.rad_hi)
                & (r < rec[..., 3, None]) & ok[..., None] & p_ok)
        if census is not None:
            census['pairs'] += int((ok[..., None] & p_ok).sum())
            census['inside'] += int(live.sum())
            census['steps'] += 1
        return dict(base=hid[..., None] * self.n_hi + i.to(torch.int64),
                    w=t - i, live=live, r=r, dx=dx)

    def values(self, rows_flat, st):
        """The step's (C, P) additions to each offset plane."""
        val = torch.lerp(gather_rows(rows_flat, st['base']),
                         gather_rows(rows_flat, st['base'] + 1), st['w'])
        val = torch.where(st['live'] & torch.isfinite(val), val,
                          0.0) * self.a_scale
        scale = val / torch.clamp(st['r'], min=1e-30)
        return [(scale * dd).sum(dim=1) for dd in st['dx']]


def snapshot_pass_diff(use_rdelta, P, n_hi, dense, counts_h, counts_host,
                       planes, counts_p, packed, rows, g0, dg, rad_hi,
                       eps_max, a_scale, L, census=None):
    """One bucket's pass as a differentiable function of ``rows``: new
    padded offset planes with the values of :func:`snapshot_offsets_pass`
    on zero planes (bit for bit on the CPU). On CUDA tensors the pass is
    the ``snap_pass`` kernel and its backward the ``snap_vjp`` kernel, one
    launch a bucket each (under ``create_graph`` the backward is the plain
    step loop, with a warning); on CPU tensors the plain pass, whose
    backward recomputes it a step at a time (positions and candidates are
    constant; ``grid_cellmajor._PassFn``). A ``census`` is only filled
    without a graph (on the card from the kernel's own counts)."""
    return _pass_diff(_SnapBucket(use_rdelta, P, n_hi, dense, counts_h,
                                  counts_host, planes, counts_p, packed, g0,
                                  dg, rad_hi, eps_max, a_scale, L),
                      rows, census)


def snapshot_offsets_pass(use_rdelta, P, n_hi, dense, counts_h, counts_host,
                          planes, counts_p, packed, rows, g0, dg, rad_hi,
                          eps_max, a_scale, L, out, census=None):
    """One bucket's displacement pass over every padded particle slot,
    added in place to the three ``out`` planes.

    planes : (px, py, pz), each (ncell * P,): the padded positions
             (:func:`pad_particles_by_cell`); counts_p (ncell,) the
             particles a cell
    dense, counts_h : the bucket's (ncell * K,) Morton-cell candidates and
                      (ncell,) counts (``counts_host`` a host copy)
    packed : (H, 16) the bucket's records [x, y, z, R_com, lnM, lnRc |
             props], positions wrapped into [0, L)
    rows : (H, n_hi) the halos' radial rows of the z-blended table
           (``grid_cellmajor.halo_rows``) on the uniform grid of ln r
           (ln r/R_com with ``use_rdelta``) from ``g0`` in steps ``dg``;
           ``rad_hi`` is its node n_hi - 1
    a_scale : the table's comoving displacement times a is the snapshot's
    census : None, or a dict whose 'pairs' (slot-halo pairs listed, real
             particles only), 'inside' (those that read the table) and
             'steps' are added to; it synchronises once a step, so it is
             for measurement only
    """
    bk = _SnapBucket(use_rdelta, P, n_hi, dense, counts_h, counts_host,
                     planes, counts_p, packed, g0, dg, rad_hi, eps_max,
                     a_scale, L)
    return _bucket_pass(bk, rows, out, census)
