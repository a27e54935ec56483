"""The second derivative through the port's differentiable
``BaryonifyGrid`` (3D, cell-major: the offsets pass and the CIC
redeposit) against ``jax.hessian`` of the JAX package's.

The inputs and table of test_torch_grid_grad.py, float64 on the CPU:
d^2(sum map^2)/d(table scale)^2 by double backward equal to the JAX
package's to 1e-8 relative (test_torch_hessian.py holds the paint and
the snapshot).
"""

import torch

from test_torch_hessian import check_grid_hessian

torch.set_num_threads(1)


def test_grid_hessian_wrt_table_scale_matches_jax(cosmo):
    check_grid_hessian(cosmo, "baryonify")
