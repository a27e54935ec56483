"""Second derivatives through the port's differentiable grid and
snapshot passes against ``jax.hessian`` of the JAX package's.

float64 on the CPU, the inputs and tables of test_torch_grid_grad.py
(``PaintProfilesGrid`` 3D, cell-major) and test_torch_snapshot_grad.py
(``BaryonifySnapshot``; ``BaryonifyGrid`` is test_torch_grid_hessian.py,
so each file alone stays short): the double backward of the passes'
Function (a step-wise recomputed backward that keeps its graph under
``create_graph``) gives d^2 loss / d(table scale)^2 equal to the JAX
package's to 1e-8 relative.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

import baryonification_tpu as J
import baryonification_tpu_torch as T
import test_torch_snapshot_grad as tsg
from test_torch_grid_grad import _case, _loss

torch.set_num_threads(1)


def _second(loss_of):
    """d^2 loss / ds^2 at s = 1 by double backward."""
    s = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(loss_of(s), s, create_graph=True)
    (h,) = torch.autograd.grad(g, s)
    return float(h)


def check_grid_hessian(cosmo, kind):
    """d^2 loss / d(table scale)^2 of the 3D cell-major grid runner of
    ``kind`` against jax.hessian to 1e-8 relative."""
    jr, tr, jtab, ttab, _ = _case(kind, 3, cosmo)
    loss = _loss(kind)[0]
    r = jr("cellmajor")
    want = float(jax.hessian(lambda s: loss(r.process_device(jtab * s)))(
        1.0))
    t = tr("cellmajor")
    got = _second(lambda s: loss(t.process_device(ttab * s)))
    assert np.isfinite(got) and got != 0
    assert abs(got - want) / abs(want) < 1e-8


def test_paint_hessian_wrt_table_scale_matches_jax(cosmo):
    check_grid_hessian(cosmo, "paint")


def test_snapshot_hessian_wrt_table_scale_matches_jax(cosmo):
    jm = J.Baryonification3D(J.DarkMatterOnly(**tsg.PAR),
                             J.DarkMatterBaryon(**tsg.PAR), cosmo,
                             epsilon_max=10)
    jm.setup_interpolator(**tsg.GRID)
    tm = T.Baryonification3D(
        T.DarkMatterOnly(**tsg.PAR), T.DarkMatterBaryon(**tsg.PAR),
        T.Cosmology(**tsg.COSMO, device="cpu"), epsilon_max=10).from_arrays(
            [np.asarray(g) for g in jm._grids], np.asarray(jm._table),
            jm.Rdelta_sampling, jm.p_keys)
    jr = J.BaryonifySnapshot(*tsg._inputs(J), epsilon_max=10, model=jm,
                             method="cellmajor", verbose=False)
    tr = T.BaryonifySnapshot(*tsg._inputs(T), epsilon_max=10, model=tm,
                             method="cellmajor", verbose=False, device="cpu")
    x0 = np.asarray(tr.ParticleSnapshot.cat['x'], dtype=np.float64)
    want = float(jax.hessian(lambda s: tsg._moment(
        jr.process_device(jm._table * s)[0], jnp.asarray(x0)))(1.0))
    got = _second(lambda s: tsg._moment(
        tr.process_device(tm._table * s)[0], torch.as_tensor(x0), torch))
    assert np.isfinite(got) and got != 0
    assert abs(got - want) / abs(want) < 1e-8
