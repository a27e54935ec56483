"""The ranks of the port's mesh tests (``tests/test_torch_parallel.py``).

This module imports torch and the port only, never JAX: the test spawns
its :func:`run` once per rank (``torch.multiprocessing``, a gloo group
initialised from a ``file://`` store, no network port), and a process
that imports JAX here would pull in the accelerator plugin. It also holds
the seeded scenes and stub models that both sides of the test build from
numpy: the toy tables and catalogs of ``tests/test_parallel.py``.

Each case runs a runner with ``mesh=`` (``process()``, ``process_device()``
and, where listed, the gradient of a fixed random weighting of the
output in the table, or the remap and the canvas). Every rank saves what
it got, so the test checks that the ranks agree as well as that they
match the single-device reference.
"""

from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

COSMO = dict(Omega_m=0.3, Omega_b=0.05, h=0.7, sigma8=0.8, n_s=0.96,
             w0=-1.0)
ZG = np.log(1 + np.linspace(0.05, 0.8, 4))
MG = np.log(np.geomspace(1e12, 1e16, 6))
RG = np.log(np.geomspace(1e-3, 80, 48))


def stub_disp_table():
    """The toy (z, M, r) displacement table of tests/test_parallel.py."""
    d = 0.03 * np.exp(RG) * np.exp(-0.25 * RG ** 2)
    return np.broadcast_to(d, (4, 6, 48)).copy()


def stub_paint_table(slope=-2.0, lnm_slope=0.0, amp=5.0):
    """A toy log projected-profile table: amp + slope ln r (+ lnm_slope
    (ln M - 32))."""
    prof = (amp + slope * RG[None, :]
            + lnm_slope * (MG[:, None] - 32.0))
    return np.broadcast_to(prof, (4, 6, 48)).copy()


# ----- the seeded scenes (numpy) -----

def shell_scene(seed=3, n_halo=96, nside=32, z_lo=0.1):
    """A catalog over a wide mass range and a random mass shell
    (tests/test_parallel.py:_mesh_test_setup); with ``z_lo`` = 0.03 the
    nearest discs are wide enough for several coarse levels below the
    port's cap of nside / 2."""
    rng = np.random.default_rng(seed)
    ra = rng.uniform(0, 360, n_halo)
    dec = np.degrees(np.arcsin(rng.uniform(-0.95, 0.95, n_halo)))
    M = 10 ** rng.uniform(12.5, 15.5, n_halo)
    z = rng.uniform(z_lo, 0.6, n_halo)
    return dict(cat=dict(ra=ra, dec=dec, M=M, z=z),
                map=rng.uniform(0.5, 1.5, 12 * nside ** 2))


def grid_scene(seed, dim, N, L, n, ell=False):
    rng = np.random.default_rng(seed)
    cat = dict(x=rng.uniform(0, L, n), y=rng.uniform(0, L, n))
    if dim == 3:
        cat['z'] = rng.uniform(0, L, n)
    cat['M'] = 10 ** rng.uniform(13.8, 14.7, n)
    if ell:
        cat['q_ell'] = rng.uniform(0.4, 0.9, n)
        cat['A_ell'] = rng.normal(size=(n, 2))
    return dict(cat=cat, map=rng.uniform(0.5, 1.5, (N,) * dim),
                bins=(np.arange(N) + 0.5) * (L / N))


def snap_scene(seed=37, L=70.0, n_part=4000, n_halo=10):
    rng = np.random.default_rng(seed)
    part = {c: rng.uniform(0, L, n_part) for c in 'xyz'}
    cat = {c: rng.uniform(0, L, n_halo) for c in 'xyz'}
    cat['M'] = 10 ** rng.uniform(13.9, 14.7, n_halo)
    return dict(part=part, cat=cat, L=L)


def anis_scene(seed=7, N=32, L=60.0, n_halo=8):
    rng = np.random.default_rng(seed)
    cat = dict(x=rng.uniform(5, 55, n_halo), y=rng.uniform(5, 55, n_halo),
               z=np.zeros(n_halo), M=10 ** rng.uniform(13.5, 14.8, n_halo))
    return dict(cat=cat, map=10 ** rng.uniform(1.0, 3.0, (N, N)),
                bins=(np.arange(N) + 0.5) * (L / N))


#: case -> (family, scene builder and its arguments, what it reads)
CASES = {
    "shell": ("BaryonifyShell", lambda: shell_scene(3, z_lo=0.03), True),
    "shell_paint": ("PaintProfilesShell", lambda: shell_scene(5), True),
    "grid3d": ("BaryonifyGrid", lambda: grid_scene(41, 3, 32, 80.0, 12),
               True),
    "grid3d_paint": ("PaintProfilesGrid",
                     lambda: grid_scene(43, 3, 32, 80.0, 10), False),
    "grid2d": ("BaryonifyGrid",
               lambda: grid_scene(41, 2, 64, 90.0, 14, ell=True), False),
    "grid2d_paint": ("PaintProfilesGrid",
                     lambda: grid_scene(43, 2, 64, 90.0, 10), False),
    "snap": ("BaryonifySnapshot", snap_scene, True),
    "anis": ("PaintProfilesAnisGrid", anis_scene, True),
}


def weights(case, shape):
    """The fixed random weighting of a case's output in its loss."""
    return np.random.default_rng(100 + sorted(CASES).index(case)).normal(
        size=shape)


# ----- the port's side -----

class StubDisp:
    """A displacement-model stand-in: the toy table."""

    p_keys = []
    Rdelta_sampling = False

    def __init__(self):
        self._table = torch.tensor(stub_disp_table())
        self._grids = tuple(torch.tensor(g) for g in (ZG, MG, RG))


class StubPaint:
    """A tabulated-profile stand-in (log projected table; 3D grids read
    the same table)."""

    p_keys = []

    def __init__(self):
        self._ln2D = torch.tensor(stub_paint_table())
        self._ln3D = self._ln2D
        self._grids = tuple(torch.tensor(g) for g in (ZG, MG, RG))


def anis_models(T):
    """(Painting, Canvas) TabulatedProfiles of the port on stub tables."""
    cosmo = T.Cosmology.from_dict(COSMO, device="cpu")
    out = []
    for tab in (stub_paint_table(-1.2, 0.8, 3.0),
                stub_paint_table(-2.0, 0.5, 4.0)):
        out.append(T.TabulatedProfile(T.Gas(), cosmo).from_arrays(
            [ZG, MG, RG], tab, tab))
    return out


def port_runner(T, case, mesh=None, mesh_axis=None, **kw):
    """The port's runner of ``case`` on the CPU (float64), cell-major."""
    family, scene, _ = CASES[case]
    s = scene()
    kw = dict(kw, verbose=False, device="cpu", mesh=mesh,
              mesh_axis=mesh_axis, method="cellmajor")
    if family in ("BaryonifyShell", "PaintProfilesShell"):
        cat = T.HaloLightConeCatalog(cosmo=COSMO, **s['cat'])
        shell = T.LightconeShell(map=s['map'], cosmo=COSMO)
        model = StubDisp() if family == "BaryonifyShell" else StubPaint()
        return getattr(T, family)(cat, shell, epsilon_max=10.0, model=model,
                                  **kw)
    if family == "BaryonifySnapshot":
        snap = T.ParticleSnapshot(M=np.ones(len(s['part']['x'])), L=s['L'],
                                  redshift=0.25, cosmo=COSMO, **s['part'])
        cat = T.HaloNDCatalog(redshift=0.25, cosmo=COSMO, **s['cat'])
        return T.BaryonifySnapshot(cat, snap, epsilon_max=10,
                                   model=StubDisp(), **kw)
    cat = T.HaloNDCatalog(redshift=0.25, cosmo=COSMO, **s['cat'])
    gm = T.GriddedMap(map=s['map'], redshift=0.25, bins=s['bins'],
                      cosmo=COSMO)
    if family == "PaintProfilesAnisGrid":
        paint, canvas = anis_models(T)
        return T.PaintProfilesAnisGrid(cat, gm, epsilon_max=3,
                                       Painting_model=paint,
                                       Canvas_model=canvas, **kw)
    if family == "BaryonifyGrid":
        return T.BaryonifyGrid(cat, gm, epsilon_max=10, model=StubDisp(),
                               use_ellipticity='q_ell' in s['cat'], **kw)
    return T.PaintProfilesGrid(cat, gm, epsilon_max=5, model=StubPaint(),
                               **kw)


def _np(x):
    return x.detach().cpu().numpy()


def port_case(T, case, mesh=None):
    """What the test compares for ``case``: process(), process_device()
    and, for the cases that list it, the loss value and its gradient(s)
    (the anis case in the remap and the canvas)."""
    r = port_runner(T, case, mesh)
    family, _, grad = CASES[case]
    out = {}
    if family == "BaryonifySnapshot":
        new = r.process()
        out['map'] = np.stack([new[c] for c in 'xyz'])
        out['dev'] = np.stack([_np(x) for x in r.process_device()])
    else:
        out['map'] = r.process()
        out['dev'] = _np(r.process_device())
    if not grad:
        return out
    w = torch.tensor(weights(case, out['map'].shape))
    if family == "PaintProfilesAnisGrid":
        remap = r.build_remap_device().detach().requires_grad_(True)
        canvas = torch.tensor(r.GriddedMap.map, requires_grad=True)
        val = (w * r.process_device(remap=remap, canvas=canvas)).sum()
        val.backward()
        out['grad'] = (_np(remap.grad), _np(canvas.grad))
    else:
        table = (r.model._table if hasattr(r.model, '_table')
                 else r.model._ln2D).clone().requires_grad_(True)
        res = r.process_device(table=table)
        if family == "BaryonifySnapshot":
            res = torch.stack(res)
        val = (w * res).sum()
        val.backward()
        out['grad'] = (_np(table.grad),)
    out['val'] = val.item()
    return out


def one_bucket_case(T, mesh):
    """One bucket of shell offsets and its regrid (tests/test_parallel.py's
    TestMeshCellMajor scene: nside 32, nside_c 8, 64 halos, a toy table):
    ``parallel.mesh_cellmajor_shell`` and the single-device pass and
    regrid it composes. Returns (single, mesh, the input RING map)."""
    from baryonification_tpu_torch.ops import healpix as hpx
    from baryonification_tpu_torch.ops.cellmajor_cuda import cellmajor_pass
    from baryonification_tpu_torch.runners import shell_cellmajor as cm
    from baryonification_tpu_torch.runners.shell import (_pack_from_angles,
                                                         _regrid_shell)
    nside, nside_c, H = 32, 8, 64
    F, npix, nc = (nside // nside_c) ** 2, hpx.npix(nside), hpx.npix(nside_c)
    rng = np.random.default_rng(9)
    theta = torch.tensor(np.arccos(rng.uniform(-0.9, 0.9, H)))
    phi = torch.tensor(rng.uniform(0, 2 * np.pi, H))
    radius = torch.tensor(rng.uniform(0.05, 0.25, H))
    a = torch.tensor(1 / (1 + rng.uniform(0.1, 0.5, H)))
    D = torch.tensor(rng.uniform(300, 1500, H))
    R_com = radius * D / a / 5.0                      # eps_max = 5
    M = torch.tensor(10 ** rng.uniform(13.5, 14.5, H))
    hids, cell_start, K = cm.coarse_halo_index(
        nside_c, theta, phi, radius, hpx.ring2nest(nside_c, torch.arange(nc)))
    dense, counts = cm.dense_cell_candidates(nc, max(K, 1), hids, cell_start)
    packed = _pack_from_angles(theta, phi, D, a, R_com, M,
                               torch.zeros((H, 0), dtype=torch.float64))
    grids = tuple(torch.tensor(g) for g in (ZG, MG, RG))
    table = torch.tensor(stub_disp_table())
    n_hi = len(RG)
    bucket = (dense, counts, cm.slot_records(packed, 5.0),
              cm.halo_rows(grids, table, packed, n_hi), float(RG[0]),
              float(RG[1] - RG[0]), float(RG[n_hi - 1]))
    n2r = hpx.nest2ring_all(nside, torch.device("cpu"))
    rt = hpx.RingTables(nside, dtype=torch.float64, device="cpu")
    pix = hpx.pixel_planes_device(nside, rt.z, rt.start, rt.npr, rt.shift,
                                  p=n2r)
    ring = torch.tensor(rng.uniform(0.5, 1.5, npix))
    omap = ring[n2r]
    zero = torch.zeros(npix, dtype=torch.float64)
    offsets = cellmajor_pass("offsets", (zero, zero.clone(), zero.clone()),
                             pix, bucket[0], bucket[1], F, *bucket[2:])
    single = _regrid_shell(nside, *pix, omap, offsets)
    got = T.parallel.mesh_cellmajor_shell(mesh, "cells", nside, F, False,
                                          pix, *bucket, omap)
    return _np(single), _np(got), _np(ring)


def run(rank, world, init_file, out_dir, cases):
    """One rank: join the gloo group, build the 1-D mesh "cells", run
    ``cases`` and save what each gave to ``out_dir/rank{rank}.pt``."""
    from torch.distributed.device_mesh import init_device_mesh

    import baryonification_tpu_torch as T

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("cells",))
        res = {c: port_case(T, c, mesh) for c in cases}
        res["_one_bucket"] = one_bucket_case(T, mesh)
        res["_shard"] = T.parallel.mesh_shard_halos(
            mesh, "cells", dict(M=np.arange(16.0), theta=torch.arange(16.0),
                                a=0.5))
        torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
