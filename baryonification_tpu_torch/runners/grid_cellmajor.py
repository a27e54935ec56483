"""Cell-major grid passes: candidate lists per block, one dense pass.

The port of ``baryonification_tpu.runners.grid_cellmajor``. As in the
shell's cell-major method, the loop is inverted: voxels (3D) or pixels
(2D) are taken in BLOCK-major order, B^d of them a block, blocks in
Morton order (consecutive ids are spatially compact and the 2^d children
of block b at the next finer level are ids 2^d b .. 2^d b + 2^d - 1).
Each halo registers in every block its reach can touch (a stable sort of
the (block, halo) pairs, so each block lists its halos in ascending id,
as in the JAX package), the lists are refined to finer blocks while they
are long, and one dense pass a bucket sums, for every voxel, its block's
candidates. Each voxel is written once a bucket; there is no scatter.

The passes keep the JAX package's semantics, including the reference's
per-bucket cutout: a halo only reaches voxels whose index lies, on every
axis, in the window [cen - half, cen + half) around its nearest bin
(periodic). In the JAX package they are XLA; here, with what the TPU
needed left out, the redshift axis is blended once a pass
(:func:`blend_table_z`), each halo's radial row once a bucket
(:func:`halo_rows`; no one-hot matmuls), and the readout is a direct lerp
of two nodes. On the card the displacement and paint passes
(:func:`grid_pass_diff`, 2D and 3D) are one launch a bucket of the
hand-written kernel ``grid_pass`` and their first-order adjoint one of
``grid_vjp`` (``ops/grid_pass_cuda.py``, ``csrc/grid_pass.cu``). Their
plain version, which CPU tensors take, is a candidate loop in plain
PyTorch ops that takes a group of candidate slots of a chunk of blocks at
once, as one (blocks, slots, voxels) tensor of at most ``PASS_BUDGET``
elements, so a chunk costs a few dozen launches, not a few dozen a
candidate. The snapshot pass (``runners/snapshot_cellmajor.py``) shares
that loop and this dispatch, with kernels of its own on the card
(``ops/snap_pass_cuda.py``), and so does the anisotropic paint
(:func:`grid_anis_paint_pass_2d`: a window of each halo's own, a readout
at the log of an existing map's value, and that map as a second input;
on the card the kernels ``anis_pass`` and ``anis_vjp`` of
``ops/anis_pass_cuda.py``).

The packed records carry the nearest-bin indices as floats (exact for
N <= 2^24 in float32) and, in place of each halo's position, its offset
from the centre of that bin, taken in float64 before the cast. A voxel's
offset from the halo is then (its index in the halo's window - half) *
res - that offset: an exact integer and two small terms, where the JAX
package subtracts two box coordinates. In float32 a box coordinate near
L = 1000 Mpc is rounded by ~3e-5 Mpc, and a flat-topped profile (a paint
convolved with a wide pixel window) then flips whole pixels in or out at
the disc edge; the offsets keep the voxel-halo separation to ~1e-7 of
itself. In float64 the two forms agree to rounding. The anisotropic
paint measures from the centre of the nearest bin, as the reference's
cutout does, so its offsets are exact integers times res.
"""

import warnings

import numpy as np
import torch

from ..ops import anis_pass_cuda, grid_pass_cuda
from ..ops.interp import blend_rows
from ..ops.scatter_cuda import scatter_add_vjp

__all__ = ["morton3", "demorton3", "morton2", "demorton2",
           "pick_block_size", "block_perm", "block_perm_2d",
           "register_halos_grid", "register_halos_grid_2d",
           "refine_block_candidates", "refine_block_candidates_2d",
           "blend_table_z", "halo_rows", "gather_rows", "grid_pass_diff",
           "grid_anis_paint_pass_2d", "PROP_COL0_3D", "PROP_COL0_2D",
           "PROP_COL0_SNAP", "ANIS_HALF_COL_2D", "MAX_PROPS_3D",
           "MAX_PROPS_2D", "MAX_PROPS_ANIS_2D", "MAX_PROPS_SNAP",
           "PASS_BUDGET"]

# packed-record column where the extra table-axis coordinates start
# (16-wide records; the columns before it are geometry)
PROP_COL0_3D = 9      # [dx dy dz R lnM lnR cenx ceny cenz | props]
PROP_COL0_2D = 11     # [dx dy R lnM lnR cenx ceny Rm00 Rm01 Rm10 Rm11 | props]
PROP_COL0_SNAP = 6    # snapshot: [x y z R lnM lnR | props]
ANIS_HALF_COL_2D = 15  # anisotropic paint: each halo's cutout half-window
MAX_PROPS_3D = 16 - PROP_COL0_3D
MAX_PROPS_2D = 16 - PROP_COL0_2D
MAX_PROPS_ANIS_2D = ANIS_HALF_COL_2D - PROP_COL0_2D
MAX_PROPS_SNAP = 16 - PROP_COL0_SNAP

# window rows (halos x window blocks) registered at once
REG_ROW_BUDGET = 1 << 24
# (blocks x slots x voxels) elements of one step of a pass. The plain
# pass is one launch an op, so small steps leave it bound by its launches
# on the host: at 2^23 the 3D grid of bench_runners.py (256^3, 1e5
# halos) took 308 steps and 39k launches a process(), at 2^25 88 steps
# and 11k (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W). A step's
# temporaries, and so the pass's peak memory, grow with it
PASS_BUDGET = 1 << 25


# ----- Morton ids (int64: no shift overflows for nb <= 1024) -----

def _spread3(v):
    """Spread the low 10 bits of v to every third bit."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def _compact3(v):
    """Inverse of _spread3."""
    v = v & 0x09249249
    v = (v | (v >> 2)) & 0x030C30C3
    v = (v | (v >> 4)) & 0x0300F00F
    v = (v | (v >> 8)) & 0x030000FF
    return (v | (v >> 16)) & 0x000003FF


def morton3(x, y, z):
    """Z-order id of 3D integer coordinates (< 1024 each), int64."""
    x, y, z = (t.to(torch.int64) for t in (x, y, z))
    return _spread3(x) | (_spread3(y) << 1) | (_spread3(z) << 2)


def demorton3(c):
    """Morton id -> (x, y, z), int64."""
    c = c.to(torch.int64)
    return _compact3(c), _compact3(c >> 1), _compact3(c >> 2)


def _spread2(v):
    """Spread the low 16 bits of v to every other bit."""
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    return (v | (v << 1)) & 0x55555555


def _compact2(v):
    """Inverse of _spread2."""
    v = v & 0x55555555
    v = (v | (v >> 1)) & 0x33333333
    v = (v | (v >> 2)) & 0x0F0F0F0F
    v = (v | (v >> 4)) & 0x00FF00FF
    return (v | (v >> 8)) & 0x0000FFFF


def morton2(x, y):
    """Z-order id of 2D integer coordinates (< 65536 each), int64."""
    return _spread2(x.to(torch.int64)) | (_spread2(y.to(torch.int64)) << 1)


def demorton2(c):
    """Morton id -> (x, y), int64."""
    c = c.to(torch.int64)
    return _compact2(c), _compact2(c >> 1)


def _demorton(c, dim):
    return demorton3(c) if dim == 3 else demorton2(c)


def _morton(coords):
    return morton3(*coords) if len(coords) == 3 else morton2(*coords)


def pick_block_size(N, reach_vox):
    """Block edge (voxels): blocks per axis nb must be a power of two
    (Morton ids) dividing N; edge B = N / nb ~ the largest reach, B >= 4."""
    nb = 1
    while (nb * 2 <= N // 4 and N % (nb * 2) == 0
           and N // (nb * 2) >= max(reach_vox, 4.0)):
        nb *= 2
    return N // nb


def _block_offsets(B, dim, device):
    """(F,) per-axis offsets of a block's voxels, block-local row-major
    (f = (ox B + oy) B + oz)."""
    f = torch.arange(B ** dim, device=device)
    out = []
    for d in range(dim):
        out.append((f // B ** (dim - 1 - d)) % B)
    return out


def _block_perm(N, B, dim, device):
    F = B ** dim
    i = torch.arange(N ** dim, device=device)
    bc = _demorton(i // F, dim)
    of = _block_offsets(B, dim, device)
    f = i % F
    flat = 0
    for b, o in zip(bc, of):
        flat = flat * N + (b * B + o[f])
    return flat


def block_perm(N, B, *, device):
    """(N^3,) int64 on ``device``: the row-major voxel id ((x N + y) N + z)
    of each block-major position b B^3 + f, b the block's Morton id and
    f = (ox B + oy) B + oz."""
    return _block_perm(N, B, 3, device)


def block_perm_2d(N, B, *, device):
    """(N^2,) int64 on ``device``: the row-major pixel id (x N + y) of each
    block-major position b B^2 + f, f = ox B + oy."""
    return _block_perm(N, B, 2, device)


# ----- registration and refinement -----

def _register(nb, W, L, pos, reach, row_budget):
    dim = len(pos)
    dev, dt = reach.device, reach.dtype
    hb = L / nb
    nc = nb ** dim
    H = reach.shape[0]
    w = torch.arange(W, device=dev) - (W - 1) // 2
    step = max(1, row_budget // W ** dim)
    cells_all, hids_all = [], []
    for h0 in range(0, H, step):
        rr = reach[h0:h0 + step]
        h = rr.shape[0]
        bcs, oks = [], []
        for p in pos:
            x0 = p[h0:h0 + step]
            b = torch.remainder(torch.floor(x0 / hb).to(torch.int64)[:, None]
                                + w, nb)
            # per-axis min-image distance from the halo to the block centre
            d = (b.to(dt) + 0.5) * hb - x0[:, None]
            d = d - L * torch.round(d / L)
            bcs.append(b)
            oks.append(d.abs() <= rr[:, None] + 0.5 * hb)
        shape = (h,) + (W,) * dim
        grids = []
        ok = (rr >= 0).reshape((h,) + (1,) * dim)
        for d in range(dim):
            view = [h] + [1] * dim
            view[1 + d] = W
            grids.append(bcs[d].reshape(view))
            ok = ok & oks[d].reshape(view)
        cells = _morton([g.expand(shape) for g in grids])
        ok = ok.expand(shape)
        hid = torch.arange(h0, h0 + h, device=dev).reshape(
            (h,) + (1,) * dim).expand(shape)
        cells_all.append(cells[ok])
        hids_all.append(hid[ok])
    cells = torch.cat(cells_all)
    cells_s, order = torch.sort(cells, stable=True)
    hids_s = torch.cat(hids_all)[order]
    cell_start = torch.searchsorted(cells_s, torch.arange(nc + 1, device=dev))
    counts = cell_start[1:] - cell_start[:-1]
    return hids_s, cell_start, int(counts.max()) if nc else 0


def register_halos_grid(nb, W, L, xh, yh, zh, reach,
                        row_budget=REG_ROW_BUDGET):
    """Register halos in every B^3-voxel block their reach may touch.

    nb : blocks per axis; W : window (blocks per axis per halo)
    xh, yh, zh : (H,) halo positions in box coordinates [0, L)
    reach : (H,) search radius; the test adds half a block edge per axis.
            reach < 0 registers nothing.
    Returns (halo ids sorted by Morton block, int64; cell_start
    (nb^3 + 1,); K = the most halos in one block). The sort is stable, so
    each block lists its halos in ascending id."""
    return _register(nb, W, L, (xh, yh, zh), reach, row_budget)


def register_halos_grid_2d(nb, W, L, xh, yh, reach,
                           row_budget=REG_ROW_BUDGET):
    """2D version of :func:`register_halos_grid` (B^2-pixel blocks)."""
    return _register(nb, W, L, (xh, yh), reach, row_budget)


def _refine(dim, nb_child, dense_parent, counts_parent, hrec, hb_child, L,
            cell_budget):
    kids = 2 ** dim
    ncp = (nb_child // 2) ** dim
    K_pad = dense_parent.shape[0] // ncp
    nc = nb_child ** dim
    dev, dt = hrec.device, hrec.dtype
    dense_p2d = dense_parent.reshape(ncp, K_pad)
    k = torch.arange(K_pad, device=dev)[None, :]
    Cc = max(kids, (cell_budget // max(K_pad, 1)) // kids * kids)
    hid_out, cnt_out = [], []
    for c0 in range(0, nc, Cc):
        c1 = min(c0 + Cc, nc)
        cc = _demorton(torch.arange(c0, c1, device=dev), dim)
        # Morton is hierarchical: the children of parent b are ids
        # kids * b .. kids * b + kids - 1
        hid = torch.repeat_interleave(dense_p2d[c0 // kids:c1 // kids], kids,
                                      dim=0)
        cnt = torch.repeat_interleave(counts_parent[c0 // kids:c1 // kids],
                                      kids)
        rec = hrec[hid.to(torch.int64)]                 # (Cc, K_pad, dim+1)
        lim = rec[..., dim] + 0.5 * hb_child
        ok = k < cnt[:, None]
        for d in range(dim):
            ctr = (cc[d].to(dt) + 0.5) * hb_child
            dd = ctr[:, None] - rec[..., d]
            dd = dd - L * torch.round(dd / L)
            ok = ok & (dd.abs() <= lim)
        # stable compaction: kept slots first, in their parent order
        order = torch.argsort(torch.where(ok, k, K_pad + k), dim=1)
        hid_out.append(torch.gather(hid, 1, order))
        cnt_out.append(ok.sum(dim=1).to(torch.int32))
    counts = torch.cat(cnt_out)
    return torch.cat(hid_out), counts, int(counts.max()) if nc else 0


def refine_block_candidates(nb_child, dense_parent, counts_parent, hrec,
                            hb_child, L, cell_budget=1 << 22):
    """Split blocks 2x finer per axis and keep, for each child block, the
    parent's candidates that can reach it.

    The registration margin adds half a block edge per axis; each level
    halves it, and the pass's work is proportional to the list length.

    dense_parent : ((nb_child / 2)^3 * K_pad,) Morton-block candidates
    counts_parent : ((nb_child / 2)^3,)
    hrec : (H, 4) per-halo [x, y, z, reach], reach the halo's own
           per-axis reach (min(bucket window, eps_max * R))
    Returns (dense_child (nb_child^3, K_pad) with the kept slots first in
    their parent order, counts_child int32, K = the largest count)."""
    return _refine(3, nb_child, dense_parent, counts_parent, hrec, hb_child,
                   L, cell_budget)


def refine_block_candidates_2d(nb_child, dense_parent, counts_parent, hrec,
                               hb_child, L, cell_budget=1 << 22):
    """2D version of :func:`refine_block_candidates`; hrec is (H, 3)
    [x, y, reach]."""
    return _refine(2, nb_child, dense_parent, counts_parent, hrec, hb_child,
                   L, cell_budget)


# ----- table readout -----

def blend_table_z(table, gz, z_coord):
    """Blend the (Nz, NM, Nr [, P...]) table down to (NM, Nr [, P...]) at
    the catalog's single ln(1+z) (linear, as the table readout's z axis).
    Returns (table_z, inb_z), inb_z a Python bool."""
    z = torch.as_tensor(z_coord, dtype=gz.dtype, device=gz.device)
    i = int(torch.clamp(torch.searchsorted(gz, z.reshape(1), right=True) - 1,
                        0, gz.shape[0] - 2))
    t = (z - gz[i]) / (gz[i + 1] - gz[i])
    inb = bool((z >= gz[0]) & (z <= gz[-1]))
    return (1.0 - t) * table[i] + t * table[i + 1], inb


def halo_rows(gM, gprops, table_z, lnM, props, n_hi):
    """(H, n_hi) radial rows of a bucket's halos: ``table_z`` (NM, Nr,
    P...) blended at each halo's ln M and extra-axis coordinates
    (``props`` (H, n_props)), nodes [0, n_hi) only. Rows of halos outside
    the grid are NaN, so the pass adds nothing for them. ``table_z`` must
    hold finite values (the runners put 0 or -1e30 in place of non-finite
    nodes first)."""
    t = table_z.narrow(1, 0, n_hi).movedim(1, -1)       # (NM, P..., n_hi)
    return blend_rows([gM] + list(gprops), t,
                      [lnM] + [props[:, j] for j in range(len(gprops))]
                      ).contiguous()


# ----- the passes -----

# geometry columns of the packed records, by dimension:
# (positions, R_com, ln R_com, nearest-bin indices, shear matrix)
_COLS = {3: dict(pos=(0, 1, 2), R=3, lnR=5, cen=(6, 7, 8), Rm=None),
         2: dict(pos=(0, 1), R=2, lnR=4, cen=(5, 6), Rm=(7, 8, 9, 10))}


def gather_rows(rows_flat, idx):
    """``rows_flat[idx]``. Where the rows carry a graph, the read goes
    through the scatter-add's backward (``ops.scatter_cuda.
    scatter_add_vjp``), whose own backward is the scatter-add: on the card
    the scatter kernel, which sums runs of equal rows in neighbouring
    lanes before its atomic adds. Autograd's backward of an indexed read
    sorts the indices and walks each run of equal ones in one warp, which
    the few row nodes that a step's voxels share make slow on the card
    (minutes a backward at grid-256)."""
    if not rows_flat.requires_grad:
        return rows_flat[idx]
    return scatter_add_vjp((rows_flat,), idx.reshape(-1))[0].reshape(
        idx.shape)


class _GridBucket:
    """One bucket of a grid pass: its constant inputs, the chunks of
    blocks and groups of candidate slots that the pass steps through, the
    geometry of a step (which depends on positions only) and its values
    (which depend on the rows). ``mode`` is 'offsets', 'offsets_rdelta'
    or 'paint'."""

    #: what the warnings and errors of its pass call it
    name = "grid"

    def __init__(self, mode, dim, B, n_hi, N, half, dense, counts,
                 counts_host, packed, g0, dg, rad_hi, eps_max, res,
                 block0=0):
        dev = packed.device
        cols = _COLS[dim]
        self.dim, self.B, self.n_hi, self.N, self.half = dim, B, n_hi, N, half
        self.F = self.unit = B ** dim
        self.n_planes = 1 if mode == "paint" else dim
        # the blocks are ids block0 .. block0 + ncell - 1 (a rank's range
        # on the mesh path; possibly none)
        self.ncell, self.block0 = counts.shape[0], block0
        self.K = dense.shape[0] // max(self.ncell, 1)
        self.dense2 = dense.reshape(self.ncell, self.K).to(
            torch.int64).contiguous()
        self.counts = counts.to(torch.int64).contiguous()
        self.counts_host = counts_host
        self.mode = mode
        self.paint = mode == "paint"
        self.rdelta = mode == "offsets_rdelta"
        self.g0, self.dg, self.rad_hi, self.res = g0, dg, rad_hi, res
        # the per-halo columns a slot reads (each halo's offset from its
        # nearest bin centre, its reach, ...), and each halo's window
        # start
        hcols = ([packed[:, c] for c in cols['pos']]
                 + [eps_max * packed[:, cols['R']]])
        if self.rdelta:
            hcols.append(packed[:, cols['lnR']])
        if dim == 2:
            hcols += [packed[:, c] for c in cols['Rm']]
        self.hrec = torch.stack(hcols, dim=-1)
        self.lo = packed[:, list(cols['cen'])].to(torch.int64) - half
        self.o = torch.arange(B, device=dev)

    def kernel_args(self, rows):
        """The leading arguments of ``ops.grid_pass_cuda.grid_pass`` and
        ``grid_vjp`` for this bucket and ``rows``."""
        return (self.mode, self.dim, self.B, self.N, self.half, self.block0,
                self.hrec, self.lo, self.dense2, self.counts, rows)

    def kernel_scalars(self):
        """The trailing (g0, dg, rad_hi, res) of those entries."""
        return self.g0, self.dg, self.rad_hi, self.res

    def kernel_pass(self, rows, census=None, extra=()):
        """The ``grid_pass`` kernel on this bucket: its new planes; a
        ``census`` gets its voxel-slots listed and inside
        (:func:`tallied`). The pass has no ``extra`` inputs."""
        return tallied(lambda tally: grid_pass_cuda.grid_pass(
            *self.kernel_args(rows), *self.kernel_scalars(), tally=tally),
            grid_pass_cuda.TALLY, ("slots", "inside"), census, rows.device)

    def kernel_vjp(self, rows, cts, extra=(), needs=None):
        """The ``grid_vjp`` kernel on this bucket: (d_rows for ``cts``,)."""
        return (grid_pass_cuda.grid_vjp(*self.kernel_args(rows), cts,
                                        *self.kernel_scalars()),)

    def ax(self, v, d):
        """(C, G, B) per-axis values (B = 1: per slot) -> broadcastable
        over the block's B^dim voxels along axis d."""
        shape = [1] * self.dim
        shape[d] = v.shape[2]
        return v.reshape(v.shape[:2] + tuple(shape))

    def chunks(self):
        """(c0, c1, iv, [(k0, k1), ...]) of every chunk of blocks with a
        candidate: iv the chunk's (C, B) voxel coordinates on each axis
        (a voxel's coordinate on axis d depends on its block and its
        offset on that axis only); a step is a group of candidate slots of
        the chunk, one (blocks, slots, voxels) tensor of at most
        PASS_BUDGET elements."""
        F, ncell = self.F, self.ncell
        C = max(1, min(ncell, PASS_BUDGET // (F * max(1, min(self.K, 16)))))
        for c0 in range(0, ncell, C):
            c1 = min(c0 + C, ncell)
            k_max = int(self.counts_host[c0:c1].max())
            if k_max == 0:
                continue
            bc = _demorton(torch.arange(c0, c1, device=self.o.device)
                           + self.block0, self.dim)
            iv = [b[:, None] * self.B + self.o[None, :] for b in bc]
            G = max(1, min(k_max, PASS_BUDGET // ((c1 - c0) * F)))
            yield c0, c1, iv, [(k0, min(k0 + G, k_max))
                               for k0 in range(0, k_max, G)]

    def geometry(self, c0, c1, iv, k0, k1, census=None):
        """The step's row nodes and weights, its mask and, in the offsets
        modes, its push directions: dict(base, w, live, r_c, dx). The
        per-axis terms are (C, G, B) and broadcast to (C, G, B^dim) where
        they meet."""
        dim, N, half, ax = self.dim, self.N, self.half, self.ax
        dev, dt = self.hrec.device, self.hrec.dtype
        hid = self.dense2[c0:c1, k0:k1]                           # (C, G)
        ok = (torch.arange(k0, k1, device=dev)[None, :]
              < self.counts[c0:c1, None])
        rec = self.hrec[hid]                                      # (C, G, .)
        hl = self.lo[hid]
        dx, win = [], ax(ok[..., None], 0)
        for d in range(dim):
            # the voxel's place u in the halo's window [cen - half, cen +
            # half) (periodic): its offset from the halo is (u - half) *
            # res less the halo's offset from its bin
            u = torch.remainder(iv[d][:, None, :] - hl[..., d, None], N)
            dx.append((u - half).to(dt) * self.res - rec[..., d, None])
            win = win & ax(u < 2 * half, d)
        sq = ax(dx[0] * dx[0], 0) + ax(dx[1] * dx[1], 1)
        if dim == 3:
            sq = sq + ax(dx[2] * dx[2], 2)
        r_c = torch.sqrt(sq)
        if dim == 2:
            Rm = [ax(rec[..., dim + 1 + j + self.rdelta, None], 0)
                  for j in range(4)]
            gx, gy = ax(dx[0], 0), ax(dx[1], 1)
            ex = Rm[0] * gx + Rm[2] * gy
            ey = Rm[1] * gx + Rm[3] * gy
            r = torch.sqrt(ex * ex + ey * ey)
        else:
            r = r_c
        rad = torch.log(torch.clamp(r, min=1e-30))
        if self.rdelta:
            rad = rad - ax(rec[..., dim + 1, None], 0)
        t = (rad - self.g0) / self.dg
        i = torch.clamp(torch.floor(t), 0, self.n_hi - 2)
        live = ((rad >= self.g0) & (rad <= self.rad_hi)
                & (r < ax(rec[..., dim, None], 0)) & win)
        if census is not None:
            census['slots'] += int(ok.sum()) * self.F
            census['inside'] += int(live.sum())
            census['steps'] += 1
        return dict(base=ax(hid[..., None], 0) * self.n_hi
                    + i.to(torch.int64), w=t - i, live=live, r_c=r_c,
                    dx=[ax(dd, d) for d, dd in enumerate(dx)])

    def values(self, rows_flat, st):
        """The step's (C, F) additions to each plane from the flat rows."""
        C = st['base'].shape[0]
        # the lerp of two nodes (also at a -1e30 paint node: a weight of 0
        # or 1 gives the other node exactly, any other weight a value
        # whose exp is 0)
        val = torch.lerp(gather_rows(rows_flat, st['base']),
                         gather_rows(rows_flat, st['base'] + 1), st['w'])
        if self.paint:
            val = torch.exp(val)
            val = torch.where(st['live'] & torch.isfinite(val), val, 0.0)
            return [val.sum(dim=1).reshape(C, self.F)]
        val = torch.where(st['live'] & torch.isfinite(val), val, 0.0)
        scale = (val / self.res) / torch.clamp(st['r_c'], min=1e-30)
        return [(scale * dd).sum(dim=1).reshape(C, self.F)
                for dd in st['dx']]


def _zero_planes(bk, rows):
    return tuple(torch.zeros(bk.ncell * bk.unit, dtype=rows.dtype,
                             device=rows.device)
                 for _ in range(bk.n_planes))


def _bucket_pass(bk, rows, planes, census=None, extra=()):
    """Add the pass of bucket ``bk`` (a :class:`_GridBucket`, or the
    snapshot's ``_SnapBucket``) of ``rows`` to ``planes`` in place, chunk
    by chunk: ``bk.unit`` elements of each plane a block (cell). ``extra``
    are further inputs laid out as the planes (the anisotropic paint's
    canvas); the values of a step get each one's slice of the chunk. A
    ``census`` dict gets the bucket's counts (the grid's: voxel-slots
    listed 'slots', those that pass every test of the geometry 'inside',
    and 'steps'); it synchronises once a step, so it is for measurement
    only."""
    rows_flat = rows.reshape(-1)
    U = bk.unit
    for c0, c1, cg, steps in bk.chunks():
        acc = [torch.zeros((c1 - c0, U), dtype=rows.dtype,
                           device=rows.device) for _ in planes]
        xs = [x[c0 * U:c1 * U].reshape(c1 - c0, U) for x in extra]
        for k0, k1 in steps:
            st = bk.geometry(c0, c1, cg, k0, k1, census)
            for a, v in zip(acc, bk.values(rows_flat, st, *xs)):
                a += v
        for p, a in zip(planes, acc):
            p[c0 * U:c1 * U] += a.reshape(-1)
    return planes


def _bucket_vjp(bk, rows, cts, extra=(), needs=None):
    """The pass's VJP with respect to ``rows`` and the ``extra`` inputs
    (those that ``needs`` marks; all by default) for the cotangent planes
    ``cts``: each step's geometry is recomputed and its values taken again
    under autograd, whose gradient in the inputs is added up, so one
    step's graph is held at a time. Where grad mode is on (a backward with
    ``create_graph``), the inputs are the saved ones with their history
    and each step's gradient keeps its graph, so the result can be
    differentiated again. Returns one gradient an input (None where not
    needed)."""
    create = torch.is_grad_enabled()
    inputs = (rows,) + tuple(extra)
    needs = tuple(needs) if needs is not None else (True,) * len(inputs)
    want = [j for j, n in enumerate(needs) if n]
    grads = [torch.zeros_like(x) if n else None
             for x, n in zip(inputs, needs)]
    U = bk.unit
    for c0, c1, cg, steps in bk.chunks():
        g = [ct[c0 * U:c1 * U].reshape(c1 - c0, U) for ct in cts]
        span = slice(c0 * U, c1 * U)
        with torch.enable_grad():
            # the extra inputs' slices of the chunk: leaves, or (keeping
            # the graph) views of the saved inputs
            xs = [rows if create else rows.detach().requires_grad_(needs[0])]
            xs += [(x[span] if create else x[span].detach().requires_grad_(n))
                   .reshape(c1 - c0, U) for x, n in zip(extra, needs[1:])]
        for k0, k1 in steps:
            st = bk.geometry(c0, c1, cg, k0, k1)
            with torch.enable_grad():
                ds = torch.autograd.grad(
                    bk.values(xs[0].reshape(-1), st, *xs[1:]),
                    [xs[j] for j in want], g, create_graph=create,
                    allow_unused=True)
            for j, d in zip(want, ds):
                if d is None:
                    continue
                if j == 0:
                    grads[0] = grads[0] + d if create else grads[0].add_(d)
                elif create:
                    grads[j] = grads[j].index_add(
                        0, torch.arange(c0 * U, c1 * U, device=d.device),
                        d.reshape(-1))
                else:
                    grads[j][span] += d.reshape(-1)
    return grads


def _on_kernel(bk, rows):
    """True where bucket ``bk``'s pass runs its kernels (its class's
    ``kernel_pass`` and ``kernel_vjp``: :class:`_GridBucket`,
    :class:`_AnisBucket`, the snapshot's ``_SnapBucket``): on CUDA tensors.
    Its CPU tensors take the plain step loop; any other device raises."""
    if rows.device.type == "cpu":
        return False
    if rows.device.type != "cuda":
        raise ValueError(f"the {bk.name} pass runs on cpu or cuda, not on "
                         f"{rows.device}")
    return True


def tallied(launch, names, keys, census, device):
    """``launch(tally)`` of a kernel entry whose tally counts ``names``:
    without a ``census`` no tally; with one, the census gets the tally's
    ``keys`` and one step (the launch; it synchronises once)."""
    if census is None:
        return launch(None)
    tally = torch.zeros(len(names), dtype=torch.int64, device=device)
    out = launch(tally)
    counts = dict(zip(names, tally.tolist()))
    for k in keys:
        census[k] += counts[k]
    census['steps'] += 1
    return out


class _PassFn(torch.autograd.Function):
    """New planes = the pass of bucket ``bk`` of ``rows`` (and its
    ``extra`` inputs); differentiable in each, to any order. On the card
    (:func:`_on_kernel`) the forward is the bucket's ``kernel_pass``
    (``grid_pass``, ``anis_pass``, ``snap_pass``), given the ``extra``
    inputs, and its backward its ``kernel_vjp`` (``grid_vjp``,
    ``anis_vjp``, ``snap_vjp``), which gives one gradient an input where
    ``needs_input_grad`` asks for it. Under ``create_graph`` (a
    backward that is to be differentiated again, as Hessians are) its
    backward is the plain step loop :func:`_bucket_vjp` on the card too,
    with a warning, until a second-order kernel exists. Elsewhere the
    forward runs the plain-op pass under no_grad and the backward
    recomputes it step by step (:func:`_bucket_vjp`), so memory stays that
    of one step's graph."""

    @staticmethod
    def forward(ctx, bk, rows, *extra):
        ctx.bk = bk
        ctx.save_for_backward(rows, *extra)
        if _on_kernel(bk, rows):
            return bk.kernel_pass(rows.detach(), extra=tuple(
                x.detach() for x in extra))
        return _bucket_pass(bk, rows, _zero_planes(bk, rows), extra=extra)

    @staticmethod
    def backward(ctx, *cts):
        rows, *extra = ctx.saved_tensors
        bk, needs = ctx.bk, ctx.needs_input_grad[1:]
        if _on_kernel(bk, rows):
            if not torch.is_grad_enabled():
                return (None, *bk.kernel_vjp(rows, cts, tuple(extra),
                                             needs))
            warnings.warn(f"the {bk.name} pass's backward under create_graph "
                          f"runs the plain step loop on the card (no "
                          f"second-order {bk.name} kernel yet)")
        return (None, *_bucket_vjp(bk, rows, cts, extra, needs))


def _pass_diff(bk, rows, census=None, extra=()):
    """The pass of bucket ``bk`` as a differentiable function of ``rows``
    (and of ``extra``): new planes with the values of :func:`_bucket_pass`
    on zero planes (bit for bit on the CPU; on the card a bucket with
    kernels runs its ``kernel_pass``, which sums each voxel's or
    particle's slots in another order). Where an input requires grad, the
    :class:`_PassFn`; otherwise the pass alone (a ``census`` is only
    filled then)."""
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (rows,) + tuple(extra)):
        return _PassFn.apply(bk, rows, *extra)
    if _on_kernel(bk, rows):
        return bk.kernel_pass(rows.detach(), census, extra)
    return _bucket_pass(bk, rows, _zero_planes(bk, rows), census, extra)


def grid_pass_diff(mode, dim, B, n_hi, N, half, dense, counts, counts_host,
                   packed, rows, g0, dg, rad_hi, eps_max, res, census=None,
                   block0=0):
    """One bucket of ``mode`` ('offsets', 'offsets_rdelta' or 'paint')
    over every voxel (3D) or pixel (2D) in block-major order, as a
    differentiable function of ``rows``: returns new block-major planes
    (``dim`` offset planes in pixel units, or one paint plane, of N^dim
    each). On CUDA tensors the pass is the ``grid_pass`` kernel and its
    backward the ``grid_vjp`` kernel, one launch a bucket each (under
    ``create_graph`` the backward is the plain step loop); on CPU tensors
    the plain pass, whose backward recomputes it a step at a time (the
    geometry is constant).

    dense, counts : the bucket's (ncell * K,) Morton-block candidates and
                    (ncell,) counts (``counts_host`` a host copy)
    packed : (H, 16) the bucket's records: in 3D [dx, dy, dz, R_com, lnM,
             lnRc, cen_x, cen_y, cen_z | props], d* each halo's offset
             from the centre of its nearest bin cen_* (Mpc); in 2D [dx,
             dy, R_com, lnM, lnRc, cen_x, cen_y, Rm00, Rm01, Rm10, Rm11 |
             props], the shear matrix mapping pixel offsets to the
             elliptical frame (the identity for isotropic halos): the
             table is read at the elliptical radius, the displacement
             pushes along the circular unit vector
    rows : (H, n_hi) the halos' radial rows (:func:`halo_rows`) of the
           displacement table, or of a log-profile table with non-finite
           nodes replaced by -1e30 (paint), on the uniform grid of ln r
           (ln r/R_com in 'offsets_rdelta') from ``g0`` in steps ``dg``;
           ``rad_hi`` is its node n_hi - 1 (the three in the hot dtype's
           values)
    half : the bucket's cutout half-window (voxels)
    census : None, or a dict of counts to add to (see :func:`_bucket_pass`;
             on the card the kernel's own counts and one step a launch;
             only filled without a graph)
    block0 : the Morton id of the first block (the blocks are block0 ..
             block0 + ncell - 1)
    """
    return _pass_diff(_GridBucket(mode, dim, B, n_hi, N, half, dense, counts,
                                  counts_host, packed, g0, dg, rad_hi,
                                  eps_max, res, block0), rows, census)


class _AnisBucket(_GridBucket):
    """One bucket of the anisotropic (density-dependent) 2D paint: the
    blocks and candidate slots of :class:`_GridBucket`, with its own
    geometry and values. A halo paints a pixel of its own cutout window
    (half-width from the packed column ``ANIS_HALF_COL_2D``, not the
    bucket's) that lies within eps_max R_com of the centre of the halo's
    nearest bin (circular, no shear). The paint is read from the halo's
    remap row at the log of the canvas value at that pixel, and only
    inside the row's canvas range (its last two nodes). ``live_h`` marks
    the halos whose rows exist (masses on the remap's grid). On the card
    its pass is the kernel ``anis_pass`` and its backward ``anis_vjp``
    (``ops/anis_pass_cuda.py``), which read int32 copies of the
    candidates, counts and windows, made once a bucket."""

    #: what the warnings and errors of its pass call it
    name = "anisotropic paint"

    def __init__(self, B, n_hi, N, dense, counts, counts_host, packed,
                 live_h, q0, dq, eps_max, res, block0=0):
        super().__init__("paint", 2, B, n_hi, N, 0, dense, counts,
                         counts_host, packed, q0, dq, None, eps_max, res,
                         block0)
        cols = _COLS[2]
        self.hh = packed[:, ANIS_HALF_COL_2D].to(torch.int64)
        self.lo = packed[:, list(cols['cen'])].to(torch.int64) \
            - self.hh[:, None]
        self.reach = eps_max * packed[:, cols['R']]
        self.live_h = live_h
        self.stride = n_hi + 2
        self._int32 = None

    def kernel_args(self, rows, canvas):
        """The leading arguments of ``ops.anis_pass_cuda.anis_pass`` and
        ``anis_vjp`` for this bucket, ``rows`` and ``canvas``."""
        if self._int32 is None:
            self._int32 = tuple(x.to(torch.int32).contiguous() for x in (
                self.dense2, self.counts, self.hh, self.lo))
        return (self.B, self.N, self.block0, *self._int32,
                self.reach.contiguous(), self.live_h.contiguous(),
                rows.contiguous(), canvas.contiguous())

    def kernel_scalars(self):
        """The trailing (q0, dq, res) of those entries."""
        return self.g0, self.dg, self.res

    def kernel_pass(self, rows, census=None, extra=()):
        """The ``anis_pass`` kernel on this bucket and the canvas (the one
        ``extra`` input): (its new plane,); a ``census`` gets its
        pixel-slots listed and inside (:func:`tallied`)."""
        (canvas,) = extra
        return tallied(lambda tally: (anis_pass_cuda.anis_pass(
            *self.kernel_args(rows, canvas), *self.kernel_scalars(),
            tally=tally),), anis_pass_cuda.TALLY, ("slots", "inside"),
            census, rows.device)

    def kernel_vjp(self, rows, cts, extra=(), needs=None):
        """The ``anis_vjp`` kernel on this bucket: (d_rows, d_canvas) for
        the cotangent plane ``cts[0]``, each None where ``needs`` says it
        is not wanted."""
        (canvas,), (ct,) = extra, cts
        return anis_pass_cuda.anis_vjp(
            *self.kernel_args(rows, canvas), ct, *self.kernel_scalars(),
            needs=(True, True) if needs is None else tuple(needs))

    def geometry(self, c0, c1, iv, k0, k1, census=None):
        """The step's rows and its mask: dict(row, live), row the first
        flat index of each slot's row ((C, G, 1, 1))."""
        N, ax = self.N, self.ax
        dev, dt = self.reach.device, self.reach.dtype
        hid = self.dense2[c0:c1, k0:k1]                           # (C, G)
        ok = ((torch.arange(k0, k1, device=dev)[None, :]
               < self.counts[c0:c1, None]) & self.live_h[hid])
        hh = self.hh[hid][..., None]
        hl = self.lo[hid]
        sq, win = 0.0, ax(ok[..., None], 0)
        for d in range(2):
            # the pixel's place u in the window [cen - hh, cen + hh): its
            # offset from the nearest bin's centre is (u - hh) res
            u = torch.remainder(iv[d][:, None, :] - hl[..., d, None], N)
            dd = (u - hh).to(dt) * self.res
            sq = sq + ax(dd * dd, d)
            win = win & ax(u < 2 * hh, d)
        live = win & (torch.sqrt(sq) < ax(self.reach[hid][..., None], 0))
        if census is not None:
            census['slots'] += int(ok.sum()) * self.F
            census['inside'] += int(live.sum())
            census['steps'] += 1
        return dict(row=ax(hid[..., None], 0) * self.stride, live=live)

    def values(self, rows_flat, st, canvas):
        """The step's (C, F) paint from the flat rows and the chunk's
        (C, F) block-major canvas."""
        C, n_hi = canvas.shape[0], self.n_hi
        v = canvas.reshape(C, 1, self.B, self.B)
        vpos = v > 0
        lnv = torch.log(torch.where(vpos, v, 1.0))
        tc = torch.clamp((lnv - self.g0) / self.dg, 0.0, float(n_hi - 1))
        i = torch.clamp(torch.floor(tc.detach()), max=n_hi - 2)
        base = st['row'] + i.to(torch.int64)
        val = torch.lerp(gather_rows(rows_flat, base),
                         gather_rows(rows_flat, base + 1), tc - i)
        # the canvas range of each slot's row: a mask, no gradient
        lim = rows_flat.detach()
        keep = (st['live'] & vpos & (lnv >= lim[st['row'] + n_hi])
                & (lnv <= lim[st['row'] + n_hi + 1]))
        # a slot whose exp overflows paints nothing and, like a masked
        # slot, takes no gradient: exp is taken of val only where kept
        keep = keep & torch.isfinite(torch.exp(val.detach()))
        paint = torch.where(keep, torch.exp(torch.where(keep, val, 0.0)),
                            0.0)
        return [paint.sum(dim=1).reshape(C, self.F)]


def grid_anis_paint_pass_2d(B, n_hi, N, dense, counts, counts_host, packed,
                            rows, live_h, q0, dq, eps_max, res, canvas,
                            census=None):
    """One bucket of the anisotropic paint over every pixel in block-major
    order, as a differentiable function of ``rows`` and ``canvas``:
    returns one new block-major paint plane of N^2.

    The JAX package's pass of the same name: the reference's monotone
    Canvas -> Paint remap, painting y(delta) in place of y(r). Each pixel
    reads its candidates' remap rows at t = (ln v - q0) / dq, v the
    canvas value there (pixels with v <= 0 paint nothing), lerped between
    two nodes, and paints exp of it where ln v lies in the row's canvas
    range [lo, hi] and the pixel passes the halo's geometry (see
    :class:`_AnisBucket`). On CUDA tensors the pass is the ``anis_pass``
    kernel and its backward the ``anis_vjp`` kernel, one launch a bucket
    each (under ``create_graph`` the backward is the plain step loop, with
    a warning); on CPU tensors the plain pass, whose backward recomputes it
    a step at a time. The gradient in the canvas is d paint / d ln v / v,
    0 outside the range and on masked slots.

    dense, counts : the bucket's (ncell * K,) Morton-block candidates and
                    (ncell,) counts (``counts_host`` a host copy)
    packed : (H, 16) the bucket's 2D records (see :func:`grid_pass_diff`)
             with each halo's cutout half-window in ``ANIS_HALF_COL_2D``
    rows : (H, n_hi + 2) the halos' rows of the remap (ln Paint on the
           uniform ln Canvas grid from ``q0`` in steps ``dq``, then lo and
           hi), finite; ``live_h`` (H,) marks the halos that have one
    canvas : (ncell B^2,) the canvas in the bucket's block-major order
    census : None, or a dict of counts (see :func:`_bucket_pass`; on the
             card the kernel's own counts and one step a launch; only
             filled without a graph)
    """
    bk = _AnisBucket(B, n_hi, N, dense, counts, counts_host, packed,
                     live_h, q0, dq, eps_max, res)
    return _pass_diff(bk, rows, census, (canvas,))
