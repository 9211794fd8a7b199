#!/usr/bin/env python3
"""Kernel B's eval mode against a float64 sum, at the defenses' shape.

    python3 scripts/block1_eval_precision.py

On the inputs of the card test
``test_block1_eval_params_kernel_at_defense_shape[ties]`` (x (256, 1, 101,
40), C 64, the tie-heavy parameters of its ``_block_inputs``, a random g,
BN on running statistics) it forms the parameter gradients three ways: the
kernel (``conv1_bn_pool_backward`` on the card, eval mode), the plain
version on the CPU, and a float64 sum over the plain version's routing.
Prints, per gradient, the largest |ref|, the kernel's largest distance from
the plain version, how many entries fall outside an elementwise rtol 1e-4 /
atol 1e-5 (with one of them), and the kernel's and the plain version's
largest distances from float64. Needs a CUDA device.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))


def main() -> int:
    import torch
    from test_torch_port_kernels_cuda import _block_inputs

    from audiobd_tpu_torch.ops import conv1_bn_pool as op

    if not torch.cuda.is_available():
        print("block1_eval_precision: no CUDA device", file=sys.stderr)
        return 2
    x, g, weight, bias, *_ = _block_inputs((256, 101, 40, 64), seed=11)
    gamma, beta = torch.linspace(-1.05, 1.45, 64), torch.linspace(-0.2, 0.3, 64)
    rmean, rvar = torch.linspace(0.1, 0.4, 64), torch.linspace(0.6, 1.4, 64)
    inv = torch.rsqrt(rvar + op.EPS)
    vecs = (rmean, inv, gamma * inv, beta - rmean * gamma * inv)
    ref = op.conv1_bn_pool_backward_plain(x, g, weight, bias, *vecs, train_bn=False, need_dx=False)
    got = op.conv1_bn_pool_backward(*(a.cuda() for a in (x, g, weight, bias, *vecs)), train_bn=False,
                                    need_dx=False)
    # float64 sums over the plain version's routing (winner, relu).
    p, r, z = op._windows(x, op._w5(weight, bias), vecs[2], vecs[3])
    dz = torch.where(op._first_match(z), g[..., None], torch.zeros(())).double()
    c5 = lambda v: v.double().reshape(1, -1, 1, 1, 1)  # noqa: E731
    dw = torch.einsum("kbhwt,bchwt->kc", p.double(), torch.where(r > 0, dz, torch.zeros((), dtype=dz.dtype)))
    dw = dw * vecs[2].double()
    exact = (dw[:4].t().reshape(weight.shape), dw[4], (dz * (r.double() - c5(rmean)) * c5(inv)).sum(dim=(0, 2, 3, 4)),
             dz.sum(dim=(0, 2, 3, 4)))
    print(f"device {torch.cuda.get_device_name(0)}; eval mode, x {tuple(x.shape)}, C 64")
    for name, a, e, f in zip(("dweight", "dbias", "dgamma", "dbeta"), got[1:], ref[1:], exact):
        a, e = a.cpu().double(), e.double()
        d = (a - e).abs()
        bad = d > 1e-5 + 1e-4 * e.abs()
        line = (f"  {name}: max|ref| {float(e.abs().max()):.4e}; kernel - plain max {float(d.max()):.3e}; outside "
                f"rtol 1e-4/atol 1e-5: {int(bad.sum())} of {bad.numel()}")
        if bad.any():
            i = int(bad.flatten().nonzero()[0, 0])
            line += (f" (kernel {float(a.flatten()[i]):.6e}, plain {float(e.flatten()[i]):.6e}, float64 "
                     f"{float(f.flatten()[i]):.6e})")
        print(f"{line}; kernel - float64 max {float((a - f).abs().max()):.3e}, plain - float64 max "
              f"{float((e - f).abs().max()):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
