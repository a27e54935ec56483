"""The port's differentiable ``PaintProfilesGrid`` against the JAX
package's.

tests/test_grad.py's ``TestGridPaintGradients`` inputs (:445; a
TabulatedProfile(Gas) carried across with ``from_arrays``, 8 halos on
32^3 and on 32^2), float64 on the CPU, 2D and 3D, both methods (helpers
of test_torch_grid_grad.py): ``process_device`` equal to the port's
``process()`` bit for bit, to JAX's to rms/max < 1e-10, and d(sum
paint)/d(log-table scale) against ``jax.grad`` to 1e-8 relative.
"""

import pytest
import torch

from test_torch_grid_grad import METHODS, check_grad, \
    check_process_device, stage

torch.set_num_threads(1)

CASES = [(d, m) for d in (3, 2) for m in METHODS]


@pytest.fixture(scope="module")
def staged(cosmo):
    return stage(cosmo, "paint", (3, 2))


@pytest.mark.parametrize("dim,method", CASES)
def test_paint_device_matches_process_and_jax(staged, dim, method):
    check_process_device(staged[dim, method], "paint")


@pytest.mark.parametrize("dim,method", CASES)
def test_paint_grad_wrt_table_scale_matches_jax(staged, dim, method):
    check_grad(staged[dim, method], "paint")
