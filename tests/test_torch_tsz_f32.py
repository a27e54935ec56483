"""The float32 tSZ paint's distance from float64, in both packages.

bench_runners' tSZ model (``TabulatedProfile(ConvolvedProfile(
ThermalSZ, HealPixel(128)))``, the table built by the JAX package on the
CPU and carried across with ``from_arrays``) painted by
``PaintProfilesShell`` on chip_smoke's tSZ catalog recipe (1e4 halos,
NSIDE 128, eps_max 5), with both methods, in float32 and in float64, by
both packages. The float32 maps sit off the float64 ones by the pixels
that the float32 disc-edge test paints in one precision only; the
question is whether the port's float32 scatter paint is further off than
the JAX package's (on the card, tsz-1024's scatter paint on 1e5 halos
reads 4.2e-3 rms/mean off float64). The test holds:

- each package's float64 maps against the other's to rms/mean < 1e-10;
- each float32 map off its float64 map by more than 1e-3 rms/mean in both
  packages (the gap exists in the JAX package too), and the port's gap
  within a factor of 2 of the JAX package's, method by method.

Run with ``-s`` to print the four gaps.
"""

import numpy as np
import pytest
import torch

import baryonification_tpu as J
import baryonification_tpu_torch as T

import chip_smoke as cs

torch.set_num_threads(1)

NSIDE, N_HALO = 128, 10_000
GRID = dict(cs.RUNNERS_GRID, N_samples_z=3, N_samples_Mass=8)
METHODS = ("scatter", "cellmajor")


def _rms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)) / b.mean())


@pytest.fixture(scope="module")
def maps(cosmo):
    tj = J.TabulatedProfile(J.ConvolvedProfile(J.ThermalSZ(**cs.PAR),
                                               J.HealPixel(NSIDE)), cosmo)
    tj.setup_interpolator(**GRID, verbose=False)
    tt = T.TabulatedProfile(
        T.ConvolvedProfile(T.ThermalSZ(**cs.PAR), T.HealPixel(NSIDE)),
        T.Cosmology.from_dict(cs.COSMO, device="cpu")).from_arrays(
            [np.asarray(g) for g in tj._grids], np.asarray(tj._ln3D),
            np.asarray(tj._ln2D))
    halos = cs.tsz_catalog(N_HALO)
    out = {}
    for name, pkg, tab, kw in (("jax", J, tj, {}),
                               ("port", T, tt, dict(device="cpu"))):
        for method in METHODS:
            for prec in ("float64", "float32"):
                cat = pkg.HaloLightConeCatalog(cosmo=cs.COSMO, **halos)
                shell = pkg.LightconeShell(map=np.zeros(12 * NSIDE ** 2),
                                           cosmo=cs.COSMO)
                out[name, method, prec] = np.asarray(pkg.PaintProfilesShell(
                    cat, shell, model=tab, epsilon_max=cs.GRID_PAINT_EPS,
                    method=method, precision=prec, verbose=False,
                    **kw).process(), dtype=np.float64)
    return out


@pytest.mark.parametrize("method", METHODS)
def test_float64_paints_agree(maps, method):
    got, want = maps["port", method, "float64"], maps["jax", method, "float64"]
    assert want.sum() > 0 and _rms(got, want) < 1e-10


@pytest.mark.parametrize("method", METHODS)
def test_float32_gap_is_shared_with_jax(maps, method):
    gaps = {name: _rms(maps[name, method, "float32"],
                       maps[name, method, "float64"])
            for name in ("jax", "port")}
    print(f"\n{method}: float32 off float64, rms/mean: JAX {gaps['jax']:.4e}"
          f", port {gaps['port']:.4e}, port/JAX "
          f"{gaps['port'] / gaps['jax']:.3f}")
    assert min(gaps.values()) > 1e-3
    assert 0.5 < gaps["port"] / gaps["jax"] < 2.0
