"""Small buckets of the cell-major grid pass, drawn with numpy.

Shared by tests/test_torch_grid_pass.py (the port's pass against the JAX
package's on the CPU) and tests/test_torch_cuda.py (the ``grid_pass`` and
``grid_vjp`` kernels against the plain step loop on the card); this
module imports no JAX. A case is one bucket: halos on a periodic N^dim
grid, some of whose windows wrap the edge, candidate lists per Morton
block drawn at random (empty blocks, lists padded past their counts, a
halo listed in blocks its window misses), a z-blended table whose mass
grid one halo lies outside (its row is NaN), -1e30 nodes in the paint
table, a 2D shear that is not the identity, and optionally a range of
blocks that starts past block 0 (as one rank's share on the mesh path).
The later cases take larger blocks: more voxels than a CTA of the kernels
(3d_b8), blocks of several warps in 2D (2d_b8), a block over many CTAs
(3d_b16), edges that are not powers of two (3d_b6: a block of 216
voxels, 2d_b5: of 25), whose warps span wrapped offset ranges, a 2D
block whose warps take 4 x 8 tiles of it (2d_b16), and one of 144 pixels
whose float64 offsets launch asks for more than 48 KB of shared memory
with the tally's (2d_b12).
"""

import numpy as np
import torch

from baryonification_tpu_torch.runners import grid_cellmajor as gcm

# name -> (dim, N, B, half, halos, block0, ncell or None for all blocks)
CASES = {"3d": (3, 16, 4, 5, 14, 0, None),
         "3d_block0": (3, 16, 4, 5, 14, 24, 24),
         "2d": (2, 32, 4, 9, 24, 0, None),
         "2d_block0": (2, 32, 4, 9, 24, 16, 32),
         "3d_b8": (3, 16, 8, 5, 14, 0, None),
         "2d_b8": (2, 32, 8, 9, 24, 0, None),
         "3d_b16": (3, 32, 16, 9, 20, 0, None),
         "3d_b6": (3, 24, 6, 7, 16, 0, None),
         "2d_b5": (2, 20, 5, 6, 20, 0, None),
         "2d_b16": (2, 64, 16, 9, 30, 0, None),
         "2d_b12": (2, 48, 12, 9, 30, 0, None)}
MODES = ("offsets", "offsets_rdelta", "paint")
EPS_MAX = 2.5
NR = 24             # radial nodes of the table
N_HI = 20           # nodes the pass reads (rad_hi is node N_HI - 1)
NM = 5              # mass nodes


def grid_case(name, mode, seed=0):
    """One bucket as numpy arrays: dict(dim, N, B, half, block0, res, L,
    bins0, dense (ncell, K) int64, counts (ncell,) int64, packed (H, 16)
    in the port's layout (each halo's offset from its nearest bin centre)
    and packed_abs in the JAX package's (box positions), gM (NM,), lnM
    (H,), lnr (NR,), table_z (NM, NR), n_hi, eps_max)."""
    dim, N, B, half, H, block0, ncell = CASES[name]
    rng = np.random.default_rng(seed + 7 * list(CASES).index(name)
                                + 101 * MODES.index(mode))
    L = 10.0 * N / 16
    res = L / N
    bins = (np.arange(N) + 0.5) * res
    pos = rng.uniform(0, L, (H, dim))
    # windows that wrap: halos within a voxel of either edge
    pos[0] = 0.2 * res
    pos[1, 0] = L - 0.3 * res
    pos[2, -1] = L - 0.05 * res
    cen = np.clip(np.floor((pos - bins[0]) / res).astype(np.int64), 0, N - 2)
    cen = cen + (np.abs(bins[cen + 1] - pos) < np.abs(bins[cen] - pos))
    R = rng.uniform(0.8, 2.0, H) * res
    gM = np.linspace(30.0, 33.0, NM)
    lnM = rng.uniform(gM[0], gM[-1], H)
    lnM[3] = gM[-1] + 0.5                  # outside the mass grid: NaN row
    rdelta = mode == "offsets_rdelta"
    lnr = (np.linspace(np.log(0.15), np.log(4.0), NR) if rdelta else
           np.linspace(np.log(0.25 * res), np.log(6.0 * res), NR))
    mm, rr = np.meshgrid(gM - gM.mean(), lnr, indexing="ij")
    if mode == "paint":
        table_z = (-1.5 * rr + 0.3 * mm
                   + 0.1 * rng.standard_normal((NM, NR)))
        table_z[2, 12:] = -1e30             # outside the profile's range
        table_z[4, 5] = -1e30
    else:
        table_z = (res * (0.4 + 0.1 * mm) * np.exp(-0.5 * rr ** 2)
                   + 0.05 * res * rng.standard_normal((NM, NR)))
    cols = [pos[:, d] - bins[cen[:, d]] for d in range(dim)]
    cols_abs = [pos[:, d] for d in range(dim)]
    tail = [R, lnM, np.log(R)] + [cen[:, d].astype(float)
                                  for d in range(dim)]
    if dim == 2:
        Rm = np.eye(2)[None] + rng.uniform(-0.3, 0.3, (H, 2, 2))
        Rm[5] = np.eye(2)
        tail += list(Rm.reshape(H, 4).T)
    pad = lambda c: np.pad(np.stack(c, -1), ((0, 0), (0, 16 - len(c))))
    nc_all = (N // B) ** dim
    ncell = nc_all - block0 if ncell is None else ncell
    k_max = 9
    counts = rng.integers(1, k_max + 1, ncell)
    counts[rng.uniform(size=ncell) < 0.2] = 0          # empty blocks
    counts[0] = 0
    K = k_max + 3                                       # padded past counts
    dense = rng.integers(0, H, (ncell, K))
    for c in range(ncell):
        dense[c, :counts[c]] = np.sort(rng.choice(H, counts[c],
                                                  replace=False))
    return dict(dim=dim, N=N, B=B, half=half, block0=block0, res=res, L=L,
                bins0=bins[0], dense=dense.astype(np.int64),
                counts=counts.astype(np.int64), packed=pad(cols + tail),
                packed_abs=pad(cols_abs + tail), gM=gM, lnM=lnM, lnr=lnr,
                table_z=table_z, n_hi=N_HI, eps_max=EPS_MAX)


def grid_scalars(case):
    """(g0, dg, rad_hi) of the case's radial grid."""
    lnr, n_hi = case["lnr"], case["n_hi"]
    return float(lnr[0]), float(lnr[1] - lnr[0]), float(lnr[n_hi - 1])


def port_rows(case, table_z):
    """The bucket's (H, n_hi) rows from ``table_z`` (a tensor, which may
    carry a graph): the port's ``halo_rows``."""
    dt, dev = table_z.dtype, table_z.device
    lnM = torch.as_tensor(case["lnM"], dtype=dt, device=dev)
    gM = torch.as_tensor(case["gM"], dtype=dt, device=dev)
    return gcm.halo_rows(gM, [], table_z, lnM, lnM[:, None][:, :0],
                         case["n_hi"])


def port_pass_args(case, mode, device, dtype):
    """The arguments of ``grid_pass_diff`` before ``rows``, and those
    after it up to ``res``, on ``device`` in ``dtype`` (``block0`` is
    ``case["block0"]``)."""
    dense = torch.as_tensor(case["dense"].reshape(-1), device=device)
    counts = torch.as_tensor(case["counts"], device=device)
    packed = torch.as_tensor(case["packed"], dtype=dtype, device=device)
    head = (mode, case["dim"], case["B"], case["n_hi"], case["N"],
            case["half"], dense, counts, case["counts"], packed)
    return head, grid_scalars(case) + (case["eps_max"], case["res"])


def port_bucket(case, mode, device, dtype):
    """The case's ``_GridBucket`` on ``device`` in ``dtype``, with its
    block0."""
    (mode, dim, B, n_hi, N, half, dense, counts, counts_host,
     packed), (g0, dg, rad_hi, eps_max, res) = port_pass_args(
        case, mode, device, dtype)
    return gcm._GridBucket(mode, dim, B, n_hi, N, half, dense, counts,
                           counts_host, packed, g0, dg, rad_hi, eps_max, res,
                           block0=case["block0"])


def patch_of(F, B, dim):
    """(F,) the patch of each voxel of a block: the voxels of the block
    that one warp of the grid kernels holds. A block of at most 32 voxels
    is one patch; where B is a multiple of 8, a patch is a tile of 4 x 8
    voxels (2D) or 1 x 4 x 8 (3D), the tiles row-major in the block;
    otherwise 32 consecutive voxels (the last maybe fewer)."""
    f = torch.arange(F)
    if F <= 32:
        return torch.zeros(F, dtype=torch.int64)
    if B % 8:
        return f // 32
    tile = (4, 8) if dim == 2 else (1, 4, 8)
    pid = torch.zeros(F, dtype=torch.int64)
    for d in range(dim):
        o = (f // B ** (dim - 1 - d)) % B
        pid = pid * (B // tile[d]) + o // tile[d]
    return pid


def patch_slots(bk):
    """(pairs, dead) of a ``_GridBucket``: its listed (patch, slot) pairs
    (:func:`patch_of`) and those of them where no voxel is live, by the
    plain geometry: the most that a conservative cull can skip."""
    F = bk.F
    pid = patch_of(F, bk.B, bk.dim)
    n_patch = int(pid.max()) + 1
    pairs = dead = 0
    for c0, c1, iv, steps in bk.chunks():
        for k0, k1 in steps:
            live = bk.geometry(c0, c1, iv, k0, k1)["live"].cpu()
            C, G = c1 - c0, k1 - k0
            alive = torch.zeros(C, G, n_patch, dtype=torch.int64)
            alive.scatter_reduce_(2, pid.expand(C, G, F),
                                  live.reshape(C, G, F).to(torch.int64),
                                  "amax")
            ok = (torch.arange(k0, k1)[None, :]
                  < bk.counts[c0:c1, None].cpu())
            pairs += int(ok.sum()) * n_patch
            dead += int((ok[..., None] & (alive == 0)).sum())
    return pairs, dead
