"""Small buckets of the cell-major snapshot pass, drawn with numpy.

Shared by tests/test_torch_snap_pass.py (the port's pass against the JAX
package's on the CPU) and tests/test_torch_cuda.py (the ``snap_pass`` and
``snap_vjp`` kernels against the plain step loop on the card); this
module imports no JAX. A case is one bucket: particles padded per cell of
a periodic box (P slots a cell, the first ``counts_p[c]`` real, the pad
slots holding the cell's first particle; empty cells and full ones),
halos some of whose reaches wrap the box's edges, candidate lists per
cell (the halos whose reach touches the cell, then a few that miss it,
some cells listed empty, every list padded past its count with ids that
must not be read), a z-blended table whose mass grid one halo lies
outside (its row is NaN), and optionally a range of cells that starts
past cell 0 (as one rank's share on the mesh path). P takes 5, 42
(bench_runners' bench_snap) and 70 (more than two warps' lanes a cell).
"""

import numpy as np
import torch

from baryonification_tpu_torch.runners import grid_cellmajor as gcm
from baryonification_tpu_torch.runners import snapshot_cellmajor as scm

# name -> (P, rdelta, cell range [lo, hi) or None for every cell)
CASES = {"p5": (5, False, None),
         "p42": (42, False, None),
         "p70_rdelta": (70, True, None),
         "p42_rdelta_mesh": (42, True, (20, 44))}
NB = 4              # cells a side
L_BOX = 40.0        # box side
H = 12              # halos
EPS_MAX = 2.5
A_SCALE = 0.8       # the table's displacement times a is the snapshot's
NR = 24             # radial nodes of the table
N_HI = 20           # nodes the pass reads (rad_hi is node N_HI - 1)
NM = 5              # mass nodes


def snap_case(name, seed=0):
    """One bucket as numpy arrays: dict(P, rdelta, L, planes (3, ncell P),
    counts_p (ncell,) int32, dense (ncell, K) int32, counts_h (ncell,)
    int32, packed (H, 16) [x, y, z, R_com, lnM, lnRc] with positions in
    [0, L), gM (NM,), lnM (H,), lnr (NR,), table_z (NM, NR), n_hi,
    eps_max, a_scale), cut to the case's cell range."""
    P, rdelta, rng_cells = CASES[name]
    rng = np.random.default_rng(seed + 11 * list(CASES).index(name))
    ncell, h = NB ** 3, L_BOX / NB
    corner = np.stack(np.unravel_index(np.arange(ncell), (NB,) * 3),
                      -1) * h                                  # (ncell, 3)
    counts_p = rng.integers(1, P + 1, ncell)
    counts_p[rng.uniform(size=ncell) < 0.15] = 0              # empty cells
    counts_p[rng.uniform(size=ncell) < 0.15] = P              # full cells
    counts_p[[1, 2]] = [0, P]
    planes = np.zeros((3, ncell, P))
    for c in range(ncell):
        x = corner[c] + rng.uniform(0, h, (P, 3))
        x[counts_p[c]:] = x[0]                 # pad slots: the first one
        planes[:, c] = x.T
    pos = rng.uniform(0, L_BOX, (H, 3))
    # reaches that wrap: halos within a cell of either edge
    pos[0] = 0.3
    pos[1, 0] = L_BOX - 0.2
    pos[2, 2] = L_BOX - 1e-3
    R = rng.uniform(1.5, 4.0, H)
    reach = EPS_MAX * R
    gM = np.linspace(30.0, 33.0, NM)
    lnM = rng.uniform(gM[0], gM[-1], H)
    lnM[3] = gM[-1] + 0.5                  # outside the mass grid: NaN row
    lnr = (np.linspace(np.log(0.05), np.log(3.0), NR) if rdelta else
           np.linspace(np.log(0.2), np.log(12.0), NR))
    mm, rr = np.meshgrid(gM - gM.mean(), lnr, indexing="ij")
    table_z = ((0.4 + 0.1 * mm) * np.exp(-0.5 * (rr - 0.5) ** 2)
               + 0.05 * rng.standard_normal((NM, NR)))
    # each cell lists the halos whose reach touches it (min image), in
    # ascending id, then a few that miss it; some lists are emptied
    lists = []
    for c in range(ncell):
        d = corner[c] + h / 2 - pos
        d -= L_BOX * np.round(d / L_BOX)
        near = np.flatnonzero(np.sqrt((np.maximum(np.abs(d) - h / 2, 0) ** 2)
                                      .sum(-1)) < reach)
        far = np.setdiff1d(np.arange(H), near)
        extra = rng.choice(far, min(len(far), rng.integers(0, 3)),
                           replace=False)
        lists.append(np.concatenate([near, np.sort(extra)]))
    for c in np.flatnonzero(rng.uniform(size=ncell) < 0.1):
        lists[c] = lists[c][:0]
    counts_h = np.array([len(x) for x in lists])
    K = int(counts_h.max()) + 3                        # padded past counts
    dense = rng.integers(0, H, (ncell, K))
    for c, x in enumerate(lists):
        dense[c, :len(x)] = x
    packed = np.zeros((H, 16))
    packed[:, :3] = pos
    packed[:, 3] = R
    packed[:, 4] = lnM
    packed[:, 5] = np.log(R)
    lo, hi = rng_cells if rng_cells else (0, ncell)
    return dict(P=P, rdelta=rdelta, L=L_BOX,
                planes=planes[:, lo:hi].reshape(3, -1),
                counts_p=counts_p[lo:hi].astype(np.int32),
                dense=dense[lo:hi].astype(np.int32),
                counts_h=counts_h[lo:hi].astype(np.int32), packed=packed,
                gM=gM, lnM=lnM, lnr=lnr, table_z=table_z, n_hi=N_HI,
                eps_max=EPS_MAX, a_scale=A_SCALE)


def snap_scalars(case, dtype=torch.float64):
    """(g0, dg, rad_hi) of the case's radial grid, as the runner takes
    them: the nodes in the hot dtype's values."""
    lnr = case["lnr"].astype(str(dtype).split(".")[-1])
    n_hi = case["n_hi"]
    return float(lnr[0]), float(lnr[1] - lnr[0]), float(lnr[n_hi - 1])


def port_rows(case, table_z):
    """The bucket's (H, n_hi) rows from ``table_z`` (a tensor, which may
    carry a graph): the port's ``halo_rows``."""
    dt, dev = table_z.dtype, table_z.device
    lnM = torch.as_tensor(case["lnM"], dtype=dt, device=dev)
    gM = torch.as_tensor(case["gM"], dtype=dt, device=dev)
    return gcm.halo_rows(gM, [], table_z, lnM, lnM[:, None][:, :0],
                         case["n_hi"])


def port_pass_args(case, device, dtype):
    """The arguments of ``snapshot_pass_diff`` before ``rows``, and those
    after it, on ``device`` in ``dtype``."""
    t = lambda a, **kw: torch.as_tensor(a, device=device, **kw)
    head = (case["rdelta"], case["P"], case["n_hi"],
            t(case["dense"].reshape(-1)), t(case["counts_h"]),
            case["counts_h"], tuple(t(p, dtype=dtype)
                                    for p in case["planes"]),
            t(case["counts_p"]), t(case["packed"], dtype=dtype))
    return head, snap_scalars(case, dtype) + (
        case["eps_max"], case["a_scale"], case["L"])


def port_bucket(case, device, dtype):
    """The case's ``_SnapBucket`` on ``device`` in ``dtype``."""
    head, tail = port_pass_args(case, device, dtype)
    return scm._SnapBucket(*head, *tail)
