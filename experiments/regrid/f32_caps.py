"""The regrid's float32 adjoint at NSIDE 8192's polar caps, on the card
(run from the repo root):

    python3 experiments/regrid/f32_caps.py

On the ``n8192_caps`` case of tests/_torch_regrid_cases.py (the first and
last thousand RING pixels and a thousand on the equator, moved about a
pixel) and the cotangent of tests/test_torch_cuda.py's adjoint test, the
largest error of each plane (d_ox, d_oy, d_oz) of the float32 gradients,
of max|grad| in float64, against autograd of the plain forward in
float64: the kernel regrid_vjp, its plain closed form
regrid_vjp_reference and autograd of the plain forward in float32; and
the kernel and the closed form against float32 autograd (the adjoint
test's reference, REGRID_VJP_BAR = 1e-4), with the pixel where the
kernel is farthest from it.
"""

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

from _torch_regrid_cases import as_torch, regrid_case  # noqa: E402
from baryonification_tpu_torch.ops import regrid_cuda as rc  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("f32_caps: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    case = regrid_case("n8192_caps")
    nside = case[0]
    ct = torch.as_tensor(np.random.default_rng(1).normal(
        size=12 * nside * nside), device=dev)

    def autograd(dt):
        _, vx, vy, vz, m, off = as_torch(case, dtype=dt, device=dev)
        leaves = [o.clone().requires_grad_() for o in off]
        out = rc.regrid_shell_reference(nside, vx, vy, vz, m, tuple(leaves))
        return [g.double() for g in torch.autograd.grad(out, leaves,
                                                        ct.to(dt))]

    truth = autograd(torch.float64)
    scale = max(float(torch.nan_to_num(g, nan=0.0).abs().max())
                for g in truth)
    args = as_torch(case, dtype=torch.float32, device=dev)
    kernel = [g.double() for g in rc.regrid_vjp(*args, ct.float())[0]]
    closed = [g.double()
              for g in rc.regrid_vjp_reference(*args, ct.float())[0]]
    auto32 = autograd(torch.float32)

    def err(a, b):
        out = []
        for x, y in zip(a, b):
            ok = ~(torch.isnan(x) | torch.isnan(y))
            out.append(float((x[ok] - y[ok]).abs().max()) / scale)
        return out

    print(f"f32_caps: {torch.cuda.get_device_name(0)}; max|grad| float64 "
          f"{scale:.6g}")
    for label, g in (("kernel", kernel), ("closed form", closed),
                     ("autograd float32", auto32)):
        print(f"f32_caps: {label} against float64 autograd, max|err| / "
              f"max|grad| by plane: {err(g, truth)}")
    print(f"f32_caps: kernel against float32 autograd: {err(kernel, auto32)}"
          f"; closed form against it: {err(closed, auto32)}; kernel "
          f"against the closed form: {err(kernel, closed)}")
    d = torch.nan_to_num((kernel[2] - auto32[2]).abs(), nan=0.0)
    i = int(d.argmax())
    z = case[3][i] + case[5][2][i]
    rho = np.hypot(case[1][i] + case[5][0][i], case[2][i] + case[5][1][i])
    print(f"f32_caps: farthest pixel {i} (z {z:.10f}, rho {rho:.6g}): "
          f"d_oz kernel {float(kernel[2][i]):.6g}, float32 autograd "
          f"{float(auto32[2][i]):.6g}, float64 {float(truth[2][i]):.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
