"""Small buckets of the anisotropic (density-dependent) paint pass, drawn
with numpy.

Shared by tests/test_torch_anis_pass.py (the port's pass against the JAX
package's on the CPU) and tests/test_torch_cuda.py (the ``anis_pass`` and
``anis_vjp`` kernels against the plain step loop on the card); this
module imports no JAX. A case is one bucket of a periodic N^2 map cut
into B x B Morton blocks: halos whose cutout windows (each its own
half-window, one of them wider than a block) wrap the map's edge, one
halo off the remap's mass grid (no row: it paints nothing), candidate
lists per block (the halos whose window touches the block, then a few
that miss it, some blocks listed empty, every list padded past its count
with ids that must not be read), a remap table (ln Paint on a uniform
ln Canvas grid, a -1e30 node, then each mass node's canvas range, some
ranges reaching past either end of the grid), and a canvas with pixels
at v <= 0 and values outside the rows' ranges and beyond both ends of the
grid; optionally a range of blocks that starts past block 0 (as one
rank's share on the mesh path), and (``overflow_buckets``) a bucket
with one halo's ln Paint set so high that its exp overflows. No pixel
lies within 1e-3 res of a halo's reach, and no ln v within 1e-3 of a
row's range ends or (in units of the grid step) of a grid node, so
float32 rounding decides no test and no kink.
"""

import numpy as np
import torch

from baryonification_tpu_torch.runners import grid_cellmajor as gcm

# name -> (N, B, halos, block range [lo, hi) or None for every block)
CASES = {"b4": (32, 4, 16, None),
         "b8": (64, 8, 20, None),
         "b4_mesh": (32, 4, 16, (20, 44))}
EPS_MAX = 2.0
RES = 0.75          # pixel size
N_HI = 16           # nodes of the ln Canvas grid
NM = 5              # mass nodes
DEAD = 3            # the halo off the mass grid
WIDE = 4            # the halo whose half-window exceeds B
OVER = 5            # the halo whose paint overflows in overflow_buckets
Q_GRID = np.linspace(-2.0, 3.0, N_HI)
MARGIN = 1e-3


def _nudged_reach(rng, hh):
    """A reach of 0.6-1.5 half-windows that no pixel centre lies within
    MARGIN res of."""
    a = np.arange(-hh, hh)
    d = RES * np.sqrt(a[:, None] ** 2 + a[None, :] ** 2)
    reach = rng.uniform(0.6, 1.5) * hh * RES
    while np.abs(d - reach).min() < MARGIN * RES:
        reach += 3 * MARGIN * RES
    return reach


def _blend(gM, nodes, lnM):
    """Linear interpolation of per-mass-node values at lnM (the row
    blend), NaN off the grid."""
    return np.where((lnM >= gM[0]) & (lnM <= gM[-1]),
                    np.interp(lnM, gM, nodes), np.nan)


def anis_case(name, seed=0):
    """One bucket as numpy arrays: dict(N, B, block0, ncell, res, L,
    bins0, dense (ncell, K) int64, counts (ncell,) int64, packed (H, 16)
    [.., R_com at 2, lnM at 3, cen_x, cen_y at 5, 6, .., half-window at
    ANIS_HALF_COL_2D], hh (H,), cen (H, 2), gM (NM,), lnM (H,), lnq
    (N_HI,), table_q (NM, N_HI + 2), n_hi, eps_max, canvas (ncell B^2,)
    block-major), cut to the case's block range."""
    N, B, H, blocks = CASES[name]
    rng = np.random.default_rng(seed + 13 * list(CASES).index(name))
    nb, F = N // B, B * B
    cen = rng.integers(0, N, (H, 2))
    # windows that wrap: centres on and next to the edges
    cen[0] = (0, 1)
    cen[1] = (N - 1, N // 3)
    cen[2] = (N // 2, N - 2)
    hh = rng.integers(2, 2 * B, H)
    hh[WIDE] = B + 3
    hh[:3] = (B - 1, B + 1, 3)
    reach = np.array([_nudged_reach(rng, h) for h in hh])
    gM = np.linspace(30.0, 33.0, NM)
    lnM = rng.uniform(gM[0], gM[-1], H)
    lnM[DEAD] = gM[-1] + 0.5
    # the remap: ln Paint on the grid, one -1e30 node, then each mass
    # node's canvas range, some past the grid's ends
    mm, qq = np.meshgrid(gM - gM.mean(), Q_GRID, indexing="ij")
    table_q = np.empty((NM, N_HI + 2))
    table_q[:, :N_HI] = (0.3 - 0.4 * qq + 0.2 * mm
                         + 0.1 * rng.standard_normal((NM, N_HI)))
    table_q[2, 6] = -1e30
    table_q[:, N_HI] = rng.uniform(-2.8, -1.0, NM)
    table_q[:, N_HI + 1] = rng.uniform(2.0, 3.8, NM)
    table_q[0, N_HI:] = (-2.6, 3.6)
    ends = [_blend(gM, table_q[:, N_HI + j], lnM) for j in (0, 1)]
    ends = np.concatenate(ends)[np.isfinite(np.concatenate(ends))]
    # the canvas, row-major: ln v in [-3, 4], kept off the range ends and
    # the grid's nodes; some pixels at v <= 0
    lnv = rng.uniform(-3.0, 4.0, N * N)
    dq = Q_GRID[1] - Q_GRID[0]
    while True:
        t = (lnv - Q_GRID[0]) / dq
        bad = ((np.abs(t - np.round(t)) < MARGIN)
               | (np.abs(lnv[:, None] - ends[None]) < MARGIN).any(axis=1))
        if not bad.any():
            break
        lnv[bad] += 3 * MARGIN
    v = np.exp(lnv)
    u = rng.uniform(size=N * N)
    v[u < 0.08] = 0.0
    v[u > 0.96] = -np.exp(lnv[u > 0.96])
    perm = gcm.block_perm_2d(N, B, device="cpu").numpy()
    canvas = v[perm]
    # each block lists the halos whose window touches it, in ascending id,
    # then a few that miss it; some lists are emptied
    bx, by = (x.numpy() for x in gcm.demorton2(torch.arange(nb * nb)))
    o = np.arange(B)
    lists = []
    for b in range(nb * nb):
        ux = (bx[b] * B + o[None, :] - (cen[:, 0, None] - hh[:, None])) % N
        uy = (by[b] * B + o[None, :] - (cen[:, 1, None] - hh[:, None])) % N
        near = np.flatnonzero((ux < 2 * hh[:, None]).any(axis=1)
                              & (uy < 2 * hh[:, None]).any(axis=1))
        far = np.setdiff1d(np.arange(H), near)
        extra = rng.choice(far, min(len(far), rng.integers(0, 3)),
                           replace=False)
        lists.append(np.sort(np.concatenate([near, extra])))
    for b in np.flatnonzero(rng.uniform(size=nb * nb) < 0.1):
        lists[b] = lists[b][:0]
    lists[1] = lists[1][:0]
    counts = np.array([len(x) for x in lists])
    K = int(counts.max()) + 3                      # padded past counts
    dense = rng.integers(0, H, (nb * nb, K))
    for b, x in enumerate(lists):
        dense[b, :len(x)] = x
    packed = np.zeros((H, 16))
    packed[:, 2] = reach / EPS_MAX
    packed[:, 3] = lnM
    packed[:, 5:7] = cen
    packed[:, gcm.ANIS_HALF_COL_2D] = hh
    lo, hi = blocks if blocks else (0, nb * nb)
    return dict(N=N, B=B, block0=lo, ncell=hi - lo, res=RES, L=N * RES,
                bins0=0.5 * RES, dense=dense[lo:hi], counts=counts[lo:hi],
                packed=packed, hh=hh, cen=cen, gM=gM, lnM=lnM, lnq=Q_GRID,
                table_q=table_q, n_hi=N_HI, eps_max=EPS_MAX,
                canvas=canvas[lo * F:hi * F])


def anis_scalars(case, dtype=torch.float64):
    """(q0, dq) of the case's canvas grid, as the runner takes them: the
    nodes in the hot dtype's values."""
    q = case["lnq"].astype(str(dtype).split(".")[-1])
    return float(q[0]), float(q[1] - q[0])


def port_rows(case, table_q):
    """The bucket's (H, n_hi + 2) rows and (H,) live_h from ``table_q`` (a
    tensor, which may carry a graph), as the runner makes them: the
    port's ``halo_rows``, rows off the mass grid set to 0."""
    dt, dev = table_q.dtype, table_q.device
    lnM = torch.as_tensor(case["lnM"], dtype=dt, device=dev)
    gM = torch.as_tensor(case["gM"], dtype=dt, device=dev)
    rows = gcm.halo_rows(gM, [], table_q, lnM, lnM[:, None][:, :0],
                         case["n_hi"] + 2)
    live_h = torch.isfinite(rows).all(dim=1)
    return torch.where(live_h[:, None], rows, 0.0), live_h


def port_pass_args(case, device, dtype):
    """The arguments of ``grid_anis_paint_pass_2d`` before ``rows``, and
    those after ``live_h`` up to ``res``, on ``device`` in ``dtype``."""
    t = lambda a, **kw: torch.as_tensor(a, device=device, **kw)
    head = (case["B"], case["n_hi"], case["N"], t(case["dense"].reshape(-1)),
            t(case["counts"]), case["counts"],
            t(case["packed"], dtype=dtype))
    return head, anis_scalars(case, dtype) + (case["eps_max"], case["res"])


def overflow_buckets(case, device, dtype):
    """The case's bucket with halo OVER's ln Paint nodes at 1000, whose
    exp overflows at every pixel it would paint (it then paints nothing
    and takes no gradient), and the same bucket with OVER off the mass
    grid, which paints what the first should; (the first, the second, the
    rows, the canvas)."""
    bk, rows, cv = port_bucket(case, device, dtype)
    rows = rows.clone()
    rows[OVER, :case["n_hi"]] = 1000.0
    head, tail = port_pass_args(case, device, dtype)
    dead = bk.live_h.clone()
    dead[OVER] = False
    ref = gcm._AnisBucket(*head, dead, *tail, block0=case["block0"])
    return bk, ref, rows, cv


def port_bucket(case, device, dtype):
    """(the case's ``_AnisBucket`` on ``device`` in ``dtype``, with its
    block0; its rows; its canvas)."""
    rows, live_h = port_rows(case, torch.as_tensor(
        case["table_q"], dtype=dtype, device=device))
    head, tail = port_pass_args(case, device, dtype)
    bk = gcm._AnisBucket(*head, live_h, *tail, block0=case["block0"])
    return bk, rows, torch.as_tensor(case["canvas"], dtype=dtype,
                                     device=device)
