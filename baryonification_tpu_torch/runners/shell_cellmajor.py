"""Cell-major shell pass: candidate lists per coarse cell, one dense pass.

The port of ``baryonification_tpu.runners.shell_cellmajor`` (with the
coarse registration of ``runners/shell_gather.py``). Halos are grouped by
the size of a coarse HEALPix cell that matches their disc; each halo is
registered in every coarse cell its disc can reach, and then every fine
pixel, taken in NESTED order so that the F fine pixels of a cell are one
contiguous block, sums the contributions of its cell's candidates. There
is no per-halo window and no scatter: each pixel is written once.

What the TPU needed and the card does not is left out: the JAX package
rebuilds each slot's radial row with one-hot matmuls and reads it with a
hat-basis reduction because a gather costs ~10 ns a row on the TPU. Here
each halo's radial row is blended once per bucket
(:func:`halo_rows`, ``ops.interp.blend_table_radial``) and the pass reads
two nodes of it per slot by a direct lerp. The pass itself is
``ops.cellmajor_cuda.cellmajor_pass`` (a hand-written CUDA kernel on the
card, its plain version on the CPU).
"""

import numpy as np
import torch

from ..ops import healpix as hpx
from ..ops.interp import blend_table_radial

__all__ = ["MARGIN", "PROP_COL0", "MAX_PROPS", "pack_halo_records",
           "coarse_halo_index", "dense_cell_candidates",
           "refine_cell_candidates", "cell_reach_cos", "halo_rows",
           "slot_records"]

# conservative cell-reach margin, in units of the mean cell resolution:
# the largest distance from a HEALPix cell centre to any point of its cell
# is <= ~1.01 resol (measured in the JAX package through nside 512)
MARGIN = 1.15

PROP_COL0 = 9          # first packed-record column holding a prop value
MAX_PROPS = 16 - PROP_COL0   # extra scalar table axes per halo record

# window rows (halos x window cells) registered at once: bounds the
# transient memory of a bucket's registration
REG_ROW_BUDGET = 1 << 24


def pack_halo_records(v0x, v0y, v0z, D, a, R_com, lnR, ln1pz, lnM,
                      props=None):
    """(H, 16) packed per-halo records: unit vector, D, a, R_com, ln R_com,
    ln(1+z), ln M, then up to MAX_PROPS extra table-axis coordinates;
    the remaining columns are zero."""
    H = v0x.shape[0]
    cols = [v0x, v0y, v0z, D, a, R_com, lnR, ln1pz, lnM]
    if props is not None and props.shape[1]:
        if props.shape[1] > MAX_PROPS:
            raise ValueError(f"at most {MAX_PROPS} extra parameter axes fit "
                             f"the packed records; got {props.shape[1]}")
        cols += [props[:, j] for j in range(props.shape[1])]
    cols += [v0x.new_zeros(H)] * (16 - len(cols))
    return torch.stack(cols, dim=-1)


def coarse_halo_index(nside_c, theta, phi, radius, cell_map, r_max=None):
    """Register halos in every coarse cell their disc may touch.

    theta, phi, radius : (H,) tensors (their dtype is the geometry's).
    Registration adds MARGIN cell resolutions to the radius, so a fine
    pixel's own cell lists every halo that can reach it. ``cell_map``
    (nc,) remaps the RING cell ids (to NESTED) before sorting. Returns
    (halo ids sorted by cell, int64; cell_start (nc + 1,) int64; K = the
    most halos in one cell). Halos are taken in chunks of at most
    REG_ROW_BUDGET window rows; a stable sort of the cell ids carries the
    halo ids, so each cell lists its halos in ascending id.
    """
    dev = theta.device
    resol_c = hpx.nside2resol(nside_c)
    radius_reg = radius + MARGIN * resol_c
    if r_max is None:
        r_max = float(radius.max())
    r_max = r_max + MARGIN * resol_c
    n_rings = min(int(np.ceil(2 * r_max / (np.pi / (4 * nside_c)))) + 4,
                  4 * nside_c - 1)
    n_phi = min(int(np.ceil(2.5 * r_max * 4 * nside_c / np.pi)) + 8,
                4 * nside_c)
    tables_c = hpx.RingTables(nside_c, dtype=theta.dtype, device=dev)
    nc = hpx.npix(nside_c)
    H = theta.shape[0]
    step = max(1, REG_ROW_BUDGET // (n_rings * n_phi))
    cells_all, hids_all = [], []
    for h0 in range(0, H, step):
        s = slice(h0, h0 + step)
        cells, valid = hpx.disc_window_mask_tab(
            tables_c, theta[s], phi[s], radius_reg[s], n_rings, n_phi)
        hids = torch.arange(h0, h0 + cells.shape[0], device=dev)
        hids = hids[:, None].expand(-1, n_rings * n_phi).reshape(-1)
        valid = valid.reshape(-1)
        cells_all.append(cell_map[cells.reshape(-1)[valid]])
        hids_all.append(hids[valid])
    cells = torch.cat(cells_all)
    cells_s, order = torch.sort(cells, stable=True)
    hids_s = torch.cat(hids_all)[order]
    cell_start = torch.searchsorted(cells_s,
                                    torch.arange(nc + 1, device=dev))
    counts = cell_start[1:] - cell_start[:-1]
    return hids_s, cell_start, int(counts.max()) if nc else 0


def dense_cell_candidates(nc, K_pad, hids_sorted, cell_start):
    """CSR registration -> dense (nc * K_pad,) int32 halo-id matrix and
    (nc,) int32 counts. Slots past a cell's count hold 0."""
    counts = torch.clamp(cell_start[1:] - cell_start[:-1], max=K_pad)
    k = torch.arange(K_pad, device=cell_start.device)[None, :]
    live = k < counts[:, None]
    if hids_sorted.numel() == 0:
        dense = torch.zeros(live.shape, dtype=torch.int32,
                            device=cell_start.device)
    else:
        src = torch.clamp(cell_start[:-1, None] + k,
                          max=hids_sorted.shape[0] - 1)
        dense = torch.where(live, hids_sorted[src], 0).to(torch.int32)
    return dense.reshape(-1), counts.to(torch.int32)


def refine_cell_candidates(nc_child, dense_parent, counts_parent, cvx, cvy,
                           cvz, hrec, cell_budget=1 << 22):
    """Split NESTED cells 2x finer and keep, for each child cell, the
    parent's candidates that can reach it.

    A candidate is kept iff dot(child centre, halo) >= cos_reach, with
    cos_reach = cos(r_halo + MARGIN * resol(child)): the child lists stay
    supersets of the reachable halos with half the parent's margin, which
    roughly halves K (the pass's work is npix * K).

    dense_parent : (nc_parent * K_pad,) NESTED-cell candidate ids
    counts_parent : (nc_parent,)
    cv* : (nc_child,) child cell-centre planes, NESTED order
    hrec : (H, 4) per-halo [vx, vy, vz, cos_reach]
    Returns (dense_child (nc_child, K_pad) with the kept slots first in
    their parent order, counts_child (nc_child,) int32, K = the largest
    count). Child cells are taken in chunks of at most ``cell_budget``
    slots (a multiple of 4 cells, so a chunk holds whole parents).
    """
    nc_parent = nc_child // 4
    K_pad = dense_parent.shape[0] // nc_parent
    dense_p2d = dense_parent.reshape(nc_parent, K_pad)
    k = torch.arange(K_pad, device=dense_parent.device)[None, :]
    Cc = max(4, (cell_budget // max(K_pad, 1)) // 4 * 4)
    hid_out, cnt_out = [], []
    for c0 in range(0, nc_child, Cc):
        c1 = min(c0 + Cc, nc_child)
        hid = torch.repeat_interleave(dense_p2d[c0 // 4:c1 // 4], 4, dim=0)
        cnt = torch.repeat_interleave(counts_parent[c0 // 4:c1 // 4], 4)
        rec = hrec[hid.to(torch.int64)]                   # (Cc, K_pad, 4)
        dot = (cvx[c0:c1, None] * rec[..., 0] + cvy[c0:c1, None] * rec[..., 1]
               + cvz[c0:c1, None] * rec[..., 2])
        ok = (k < cnt[:, None]) & (dot >= rec[..., 3])
        # stable compaction: kept slots first, in their original order
        order = torch.argsort(torch.where(ok, k, K_pad + k), dim=1)
        hid_out.append(torch.gather(hid, 1, order))
        cnt_out.append(ok.sum(dim=1).to(torch.int32))
    counts = torch.cat(cnt_out)
    return torch.cat(hid_out), counts, int(counts.max()) if nc_child else 0


def halo_rows(grids, table, packed, n_hi):
    """(H, n_hi) radial rows of the bucket's halos: the table blended over
    every non-radial axis at each halo's (ln(1+z), ln M, props...) from
    its packed record, nodes [0, n_hi) only. Rows of halos outside the
    (z, M, props) grid are NaN, so the pass adds nothing for them.
    ``table`` must hold finite values (the runners put 0 or -1e30 in
    place of non-finite nodes first)."""
    scalars = [packed[:, 7], packed[:, 8]] + [
        packed[:, PROP_COL0 + j] for j in range(len(grids) - 3)]
    return blend_table_radial(grids, table.narrow(2, 0, n_hi),
                              scalars).contiguous()


def slot_records(packed, eps_max):
    """(H, 8) per-halo records that the pass reads once a slot: unit
    vector, cos_reach = cos(eps_max * R_com * a / D) (the cosine of the
    disc's angular radius), then D, a, eps_max * R_com, ln R_com. The
    kernel's angular test reads the first four values, one 16-byte load in
    float32."""
    eps_R = eps_max * packed[:, 5]
    cos_reach = torch.cos(eps_R * packed[:, 4] / packed[:, 3])
    return torch.stack([packed[:, 0], packed[:, 1], packed[:, 2], cos_reach,
                        packed[:, 3], packed[:, 4], eps_R, packed[:, 6]],
                       dim=-1).contiguous()


def cell_reach_cos(radius, nside_c):
    """cos(radius + MARGIN * resol(nside_c)) in the radius's dtype."""
    return torch.cos(radius + radius.new_tensor(
        MARGIN * hpx.nside2resol(nside_c)))
