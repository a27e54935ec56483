"""The port's differentiable 2D ``BaryonifyGrid`` against the JAX
package's.

The 2D cases of test_torch_grid_grad.py (whose helpers this file uses):
tests/test_grad.py's ``staged_grid2d`` (:388; 10 halos on 48^2, a
Baryonification2D table), float64 on the CPU, both methods:
``process_device`` equal to the port's ``process()`` bit for bit, to
JAX's to rms/mean < 1e-10, and d(sum map^2)/d(table scale) against
``jax.grad`` to 1e-8 relative.
"""

import pytest
import torch

from test_torch_grid_grad import METHODS, check_grad, \
    check_process_device, stage

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def staged(cosmo):
    return stage(cosmo, "baryonify", (2,))


@pytest.mark.parametrize("method", METHODS)
def test_process_device_matches_process_and_jax_2d(staged, method):
    check_process_device(staged[2, method], "baryonify")


@pytest.mark.parametrize("method", METHODS)
def test_grad_wrt_table_scale_matches_jax_2d(staged, method):
    check_grad(staged[2, method], "baryonify")
