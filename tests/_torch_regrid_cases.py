"""Inputs of the shell regrid, drawn with numpy.

Shared by tests/test_torch_regrid.py (the port's plain regrid and its
closed-form adjoint against the JAX package's ``_regrid_shell`` on the
CPU) and tests/test_torch_cuda.py (the kernels of ``csrc/regrid.cu``
against the plain versions on the card); this module imports no JAX.

A case is (nside, vx, vy, vz, m, (ox, oy, oz)) as float64 numpy arrays:
the pixel centres of an NSIDE in NESTED or RING order (the cell-major and
the scatter paths' orders), moved by offsets of a few tenths of a pixel
(``small``) or of a few pixels (``large``: across rings, faces and the
polar caps), masses in [0.5, 1.5). The edge cases: the polar caps'
pixels pushed over the poles (``poles``); directions whose z / r is
exactly 1 or -1, the bounds of its clamp (``on_axis``, x and y tiny;
there acos has an infinite derivative, and the gradients are NaN in
autograd as in the closed form); phi exactly 0
after atan2 and exactly 2 pi after its wrap (``phi_wrap``); a contiguous
slice of a NESTED case, as one rank's share on the mesh path
(``mesh_slice``); no pixel (``empty``); every pixel of a patch moved
onto nearly one direction, so that a few destinations take hundreds of
rows (``pileup``); and, at the largest NSIDE the kernels take (8192),
the first and the last thousand RING pixels and a thousand on the
equator, moved about a pixel (``n8192_caps``: ids up to 805,306,367,
built from their ids; its maps have 805M pixels, so the CPU tests hold
only its ids and weights, ``LARGE_CASES``).
"""

import numpy as np
import torch

from baryonification_tpu_torch.ops import healpix as hpx

# name -> (nside, order, offset scale in pixels)
GRID_CASES = {"n16_nested_small": (16, "nested", 0.3),
              "n16_ring_large": (16, "ring", 3.0),
              "n64_nested_large": (64, "nested", 3.0),
              "n64_ring_small": (64, "ring", 0.3)}
EDGE_CASES = ("poles", "on_axis", "phi_wrap", "mesh_slice", "empty",
              "pileup")
# appended last: regrid_case seeds on a case's index in CASES
LARGE_CASES = ("n8192_caps",)
CASES = tuple(GRID_CASES) + EDGE_CASES + LARGE_CASES


def pixel_vectors(nside, order="ring"):
    """(3, npix) float64 pixel centres in RING or NESTED order."""
    ids = torch.arange(hpx.npix(nside))
    if order == "nested":
        ids = hpx.nest2ring(nside, ids)
    return hpx.pix2vec(nside, ids).numpy().T.copy()


def _moved(rng, v, scale):
    return tuple(rng.normal(scale=scale, size=v.shape[1])
                 for _ in range(3))


def regrid_case(name, seed=0):
    """Case ``name`` (see the module docstring) as (nside, vx, vy, vz, m,
    (ox, oy, oz)), float64 numpy arrays."""
    rng = np.random.default_rng(seed + 17 * CASES.index(name))
    if name in GRID_CASES:
        nside, order, px = GRID_CASES[name]
        v = pixel_vectors(nside, order)
        off = _moved(rng, v, px * hpx.nside2resol(nside))
    elif name == "poles":
        nside = 16
        v = pixel_vectors(nside)
        cap = 2 * 3 * 4                        # the first three rings
        v = np.concatenate([v[:, :cap], v[:, -cap:]], axis=1)
        # over the pole: the x, y part reversed and a bit more, so some
        # land on the far side of it, some in its first ring; turned a
        # little in phi, off the pixel centres' meridians (where the
        # weights have kinks)
        k = rng.uniform(1.2, 2.6, v.shape[1])
        off = (-k * v[0] + rng.normal(scale=0.01, size=v.shape[1]),
               -k * v[1] + rng.normal(scale=0.01, size=v.shape[1]),
               rng.normal(scale=1e-3, size=v.shape[1]))
    elif name == "on_axis":
        nside = 16
        # x, y tiny: z / r rounds to exactly +-1, the clamp's bounds (in
        # IEEE arithmetic it never rounds past them), theta to 0 or pi
        z = np.concatenate([rng.uniform(0.5, 2.0, 8),
                            -rng.uniform(0.5, 2.0, 8)])
        v = np.stack([np.zeros_like(z)] * 3)
        off = (np.full(z.shape, 1e-12), np.full(z.shape, -1e-12), z)
    elif name == "phi_wrap":
        nside = 16
        z = rng.uniform(-0.95, 0.95, 12)
        x = np.sqrt(1 - z * z)
        y = np.concatenate([np.zeros(4), -np.zeros(4), np.full(4, -1e-20)])
        v = np.stack([x, y, z])
        off = (np.zeros(12), np.zeros(12), np.zeros(12))
    elif name == "mesh_slice":
        nside = 16
        v = pixel_vectors(nside, "nested")
        off = _moved(rng, v, 1.0 * hpx.nside2resol(nside))
        lo, hi = v.shape[1] // 3, 2 * v.shape[1] // 3 + 5
        v = v[:, lo:hi]
        off = tuple(o[lo:hi] for o in off)
    elif name == "empty":
        nside = 16
        v = np.zeros((3, 0))
        off = (np.zeros(0),) * 3
    elif name == "n8192_caps":
        nside = 8192
        npix = hpx.npix(nside)
        eq = 2 * nside * (nside - 1) + 4 * nside * nside   # ring 2 nside
        ids = np.concatenate([np.arange(1000), np.arange(eq - 500, eq + 500),
                              np.arange(npix - 1000, npix)])
        v = hpx.pix2vec(nside, torch.as_tensor(ids)).numpy().T.copy()
        off = _moved(rng, v, 1.0 * hpx.nside2resol(nside))
    else:  # pileup
        nside = 32
        v = pixel_vectors(nside, "nested")[:, :1024]       # one face's part
        target = np.array([0.3, 0.4, np.sqrt(1 - 0.25)])
        jitter = 0.2 * hpx.nside2resol(nside)
        off = tuple(target[k] - v[k] + rng.normal(scale=jitter,
                                                  size=v.shape[1])
                    for k in range(3))
    m = rng.uniform(0.5, 1.5, v.shape[1])
    return (nside, v[0].copy(), v[1].copy(), v[2].copy(), m,
            tuple(np.ascontiguousarray(o) for o in off))


def as_torch(case, dtype=torch.float64, device="cpu"):
    """A case's arrays as tensors of ``dtype`` on ``device``."""
    nside, vx, vy, vz, m, off = case
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return nside, t(vx), t(vy), t(vz), t(m), tuple(t(o) for o in off)
