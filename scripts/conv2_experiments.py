#!/usr/bin/env python3
"""Kernel D's time at the block-2/3 shapes, split by pass.

    python3 scripts/conv2_experiments.py [--root DIR]

Times kernel D (``conv2_bn_pool_bwd_params``) at full width, block 2 (x
(256, 64, 100, 13), g (256, 64, 50, 7), pool padding (1, 1)) and block 3 (x
(256, 64, 50, 7), g (256, 32, 24, 4), pool padding (0, 1)), with CUDA events
over 20 launches after warm-up, then runs one launch of each under
torch.profiler and prints the device time of each CUDA kernel it launched
(the routing pass, the product pass, the finish). ``--root`` imports
``audiobd_tpu_torch`` from another checkout of this repository, to time two
versions on one card. Inputs are random, from seed 0, with many relu zeros.
Prints the card's name and power limit first. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from audiobd_tpu_torch.ops import conv2_bn_pool as op2
    from audiobd_tpu_torch.utils.device import resolve_device

    if not torch.cuda.is_available():
        print("conv2_experiments: no CUDA device", file=sys.stderr)
        return 2
    resolve_device(None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{smi}; kernel D from {os.path.abspath(op2.__file__)}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, (b, cin, h, w, c), pad in (("block 2", (256, 64, 100, 13, 64), (1, 1)),
                                         ("block 3", (256, 64, 50, 7, 32), (0, 1))):
        x = torch.relu(torch.randn(b, cin, h, w, device="cuda", generator=gen))
        weight = torch.randn(c, cin, 2, 2, device="cuda", generator=gen) * 0.1
        bias = torch.randn(c, device="cuda", generator=gen) * 0.1 - 0.2
        _, _, ho, wo, _, _ = op2.pool_dims(h, w, pad)
        g = torch.randn(b, c, ho, wo, device="cuda", generator=gen) * 1e-3
        mu = torch.rand(c, device="cuda", generator=gen) * 0.3
        inv = torch.rsqrt(torch.rand(c, device="cuda", generator=gen) + 0.5)
        scale = (1.0 + 0.3 * torch.randn(c, device="cuda", generator=gen)) * inv
        shift = 0.1 * torch.randn(c, device="cuda", generator=gen) - mu * scale
        w257 = op2.w257(weight, bias)

        def launch():
            return op2.conv2_bn_pool_bwd_params(x, g, w257, mu, inv, scale, shift, pool_padding=pad)

        for _ in range(3):
            launch()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(20):
            launch()
        end.record()
        torch.cuda.synchronize()
        print(f"{label} x {tuple(x.shape)}: kernel D {start.elapsed_time(end) / 20:.4f} ms", flush=True)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                launch()
            torch.cuda.synchronize()
        by_name: dict[str, list] = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                entry = by_name.setdefault(e.name, [0.0, 0])
                entry[0] += e.time_range.end - e.time_range.start
                entry[1] += 1
        for name, (us, count) in by_name.items():
            print(f"  {name[:60]}: {us / count / 1e3:.4f} ms a launch ({count} launches)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
