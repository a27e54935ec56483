"""Example 15's chain through the port against the JAX package's.

examples/15_gradient_fit_dPk.py (ln M_c -> build_table_device of
Schneider19 with CollisionlessMatter(r_steps=1500, max_iter=6) on the
example's 2 x 6 x 48 grid -> BaryonifySnapshot.process_device ->
cic_deposit_3d -> rfftn -> seven binned P(k) bands over the undisplaced
box's -> chi^2) at a reduced size, 3000 particles, 8 halos, Ng 16, float64
on the CPU. The port's chain is ``chip_smoke.ex15_chain``, what the card
runs; the JAX one is the example's code, restated. The ratio bands at the
truth and at the start to 1e-8 relative, and d chi^2/d ln M_c against
the JAX package's gradient to 1e-8.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

import baryonification_tpu as J
import baryonification_tpu_torch as T
from baryonification_tpu.ops.scatter import cic_deposit_3d as jcic

import chip_smoke as cs
from test_profiles import PAR

torch.set_num_threads(1)

COSMO = dict(Omega_m=0.3, Omega_b=0.05, h=0.7, sigma8=0.8, n_s=0.96,
             w0=-1.0)
EX15 = dict(L=120.0, n_part=3000, n_halo=8, Ng=16, seed=4)


def _rel(a, b):
    return abs(a - b) / abs(b)


def _jax_ex15(cosmo):
    """The example's chain in the JAX package at EX15's size (its code,
    restated): (ratio at the start, d chi^2/d ln M_c there)."""
    from baryonification_tpu.profiles import CollisionlessMatter
    Lb, Ng = EX15["L"], EX15["Ng"]
    hx, hM, pos = cs.ex15_box(Lb, EX15["n_part"], EX15["n_halo"],
                              EX15["seed"])
    snap = J.ParticleSnapshot(x=pos[:, 0], y=pos[:, 1], z=pos[:, 2],
                              M=np.ones(len(pos)), L=Lb, redshift=0.25,
                              cosmo=COSMO)
    cat = J.HaloNDCatalog(x=hx[:, 0], y=hx[:, 1], z=hx[:, 2], M=hM,
                          redshift=0.25, cosmo=COSMO)
    Z, M, R = cs.EX15_Z, cs.EX15_M, cs.EX15_R
    model0 = J.Baryonification3D(J.DarkMatterOnly(**PAR),
                                 J.DarkMatterBaryon(**PAR), cosmo,
                                 epsilon_max=10)
    model0.setup_interpolator(z_min=Z[0], z_max=Z[-1], N_samples_z=len(Z),
                              M_min=M[0], M_max=M[-1],
                              N_samples_Mass=len(M), R_min=R[0],
                              R_max=R[-1], N_samples_R=len(R))
    runner = J.BaryonifySnapshot(cat, snap, epsilon_max=10, model=model0,
                                 method="cellmajor", verbose=False)
    masks = [jnp.asarray(m) for m in cs.ex15_bands(Lb, Ng)]
    res = Lb / Ng

    def pk(x, y, z):
        rho = jcic(Ng, x / res - 0.5, y / res - 0.5, z / res - 0.5,
                   jnp.ones_like(x), dtype=x.dtype)
        delta = rho.reshape(Ng, Ng, Ng) - jnp.mean(rho)
        pw = (jnp.abs(jnp.fft.rfftn(delta)) ** 2).ravel()
        return jnp.stack([jnp.sum(pw * m) / jnp.maximum(jnp.sum(m), 1)
                          for m in masks])

    @jax.jit
    def table_of(lnMc):
        par = dict(PAR)
        par['M_c'] = jnp.exp(lnMc)
        clm = CollisionlessMatter(r_steps=1500, max_iter=6, **par)
        m = J.Baryonification3D(
            J.DarkMatterOnly(**par),
            J.DarkMatterBaryon(collisionlessmatter=clm, **par), cosmo,
            epsilon_max=10)
        return m.build_table_device(Z, M, R).reshape(len(Z), len(M), len(R))

    p_dmo = pk(*(jnp.asarray(snap.cat[c]) for c in "xyz"))
    ratio_of = lambda lnMc: pk(*runner.process_device(table_of(lnMc))) \
        / p_dmo
    target = ratio_of(jnp.asarray(cs.EX15_LN_MC_TRUE))
    # chi^2 = 1e4 sum (ratio - target)^2: its gradient from one jax.vjp
    ratio, vjp = jax.vjp(ratio_of, jnp.asarray(cs.EX15_LN_MC_START))
    (g,) = vjp(2e4 * (ratio - target))
    return np.asarray(ratio), np.asarray(target), float(g)


def test_example15_chain_matches_jax(cosmo):
    want_ratio, want_target, want_g = _jax_ex15(cosmo)
    table_of, ratio_of, _ = cs.ex15_chain(T, torch, torch.device("cpu"),
                                          **EX15)
    f64 = dict(dtype=torch.float64)
    with torch.no_grad():
        target = ratio_of(table_of(torch.tensor(cs.EX15_LN_MC_TRUE, **f64)))
    np.testing.assert_allclose(target.numpy(), want_target, rtol=1e-8)
    x = torch.tensor(cs.EX15_LN_MC_START, **f64, requires_grad=True)
    ratio = ratio_of(table_of(x))
    np.testing.assert_allclose(ratio.detach().numpy(), want_ratio,
                               rtol=1e-8)
    assert np.abs(want_ratio - 1).max() > 0.005
    (g,) = torch.autograd.grad(((ratio - target) ** 2).sum() * 1e4, x)
    assert np.isfinite(float(g)) and float(g) != 0
    assert _rel(float(g), want_g) < 1e-8
