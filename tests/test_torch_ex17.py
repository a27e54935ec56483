"""Example 17's composed chain through the port against the JAX
package's.

examples/17_anis_paint_composition.py at its own size (48^2 pixels, 10
halos, seed 17, its 3 x 6 x 48 table grid), float64 on the CPU: ln M_c ->
Baryonification2D.build_table_device -> BaryonifyGrid.process_device ->
PaintProfilesAnisGrid.process_device(remap=build_remap_device(),
canvas=...) -> chi^2 against the map at the truth. The port's chain is
``chip_smoke.ex17_chain``, what the card runs; the JAX one is the
example's code, restated. Each package builds its own tables, and the
runners take the example's methods (``auto``: the loop-and-scatter
methods on the CPU in both; the anis paint cell-major). The mock map at
the truth to 1e-10 of its max, and chi^2 and d chi^2/d ln M_c at the
example's start to 1e-8 relative.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

import baryonification_tpu as J
import baryonification_tpu_torch as T
from baryonification_tpu.runners import PaintProfilesAnisGrid as JAnis

import chip_smoke as cs
from test_profiles import PAR

torch.set_num_threads(1)

COSMO = dict(Omega_m=0.3, Omega_b=0.05, h=0.7, sigma8=0.8, n_s=0.96,
             w0=-1.0)


def _rel(a, b):
    return abs(a - b) / abs(b)


def _jax_ex17(cosmo):
    """The example's chain in the JAX package (its code, restated): (the
    map at the truth, chi^2 and its gradient at the start)."""
    N, L = 48, 60.0
    bins = (np.arange(N) + 0.5) * (L / N)
    rng = np.random.default_rng(17)
    cat = J.HaloNDCatalog(x=rng.uniform(6, 54, 10), y=rng.uniform(6, 54, 10),
                          M=10 ** rng.uniform(13.8, 14.7, 10),
                          redshift=0.25, cosmo=COSMO)
    grid = cs.EX14_GRID
    canvas_model = J.TabulatedProfile(J.DarkMatter(**PAR), cosmo)
    canvas_model.setup_interpolator(**grid)
    gm0 = J.GriddedMap(map=np.zeros((N, N)), redshift=0.25, bins=bins,
                       cosmo=COSMO)
    base = np.asarray(J.runners.PaintProfilesGrid(
        cat, gm0, epsilon_max=5, model=canvas_model,
        verbose=False).process())
    gm = J.GriddedMap(map=base, redshift=0.25, bins=bins, cosmo=COSMO)
    model0 = J.Baryonification2D(J.DarkMatterOnly(**PAR),
                                 J.DarkMatterBaryon(**PAR), cosmo,
                                 epsilon_max=10)
    model0.setup_interpolator(**grid)
    bary = J.runners.BaryonifyGrid(cat, gm, epsilon_max=10, model=model0,
                                   verbose=False)
    paint_model = J.TabulatedProfile(J.Gas(**PAR), cosmo)
    paint_model.setup_interpolator(**grid)
    anis = JAnis(cat, gm, epsilon_max=5, Painting_model=paint_model,
                 Canvas_model=canvas_model, method="cellmajor",
                 verbose=False)
    remap = jax.lax.stop_gradient(anis.build_remap_device())
    z, M, r = cs.grid_points(grid)

    def y_map(lnMc):
        par = dict(PAR, M_c=jnp.exp(lnMc))
        m = J.Baryonification2D(J.DarkMatterOnly(**par),
                                J.DarkMatterBaryon(**par), cosmo,
                                epsilon_max=10)
        t = m.build_table_device(z, M, r).reshape(len(z), len(M), len(r))
        return anis.process_device(remap=remap,
                                   canvas=bary.process_device(table=t))

    data = y_map(jnp.asarray(cs.LN_MC_TRUE))
    scale = 1.0 / float(jnp.max(data)) ** 2
    chi2 = lambda x: jnp.sum((y_map(x) - data) ** 2) * scale * 1e6
    c0, g = jax.value_and_grad(chi2)(jnp.asarray(cs.LN_MC_START))
    return np.asarray(data), float(c0), float(g)


def test_example17_chain_matches_jax(cosmo):
    want_data, want_c, want_g = _jax_ex17(cosmo)
    y_map, base = cs.ex17_chain(T, torch, torch.device("cpu"))
    assert (base > 0).sum() > 100
    f64 = dict(dtype=torch.float64)
    with torch.no_grad():
        data = y_map(torch.tensor(cs.LN_MC_TRUE, **f64))
    assert int((data > 0).sum()) > 50
    np.testing.assert_array_equal(data.numpy() != 0, want_data != 0)
    np.testing.assert_allclose(data.numpy(), want_data, rtol=0,
                               atol=1e-10 * np.abs(want_data).max())
    scale = 1.0 / float(data.max()) ** 2
    x = torch.tensor(cs.LN_MC_START, **f64, requires_grad=True)
    c = ((y_map(x) - data) ** 2).sum() * scale * 1e6
    (g,) = torch.autograd.grad(c, x)
    assert _rel(float(c.detach()), want_c) < 1e-8
    assert np.isfinite(float(g)) and float(g) != 0
    assert _rel(float(g), want_g) < 1e-8
