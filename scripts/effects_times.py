#!/usr/bin/env python3
"""Times kernel F's routes in a checkout of the PyTorch/CUDA port, so that
two checkouts can be compared on one card in one call.

    python3 scripts/effects_times.py [--root DIR] [--label NAME]

Imports ``audiobd_tpu_torch`` from ``--root`` (default: this checkout) and
times, by CUDA events over 20 launches after warm-up, through the wrappers
every version shares (``ops/effects.py::ladder_hpf12`` and ``::phaser``),
on phase 1d's inputs of chip_smoke.py (seed 7 tones with noise):
  * the ladder at k = 0 on the rows after style 5's 12 dB gain (cutoff
    1 kHz, drive 0 dB: style 5's route), and at k = 1.2, drive 6 dB;
  * the phaser with 6 stages (style 5) and with 4, mix 0.5;
each at (256, 16000), a style-5 chunk, and at (37, 4001), a last chunk.
A checkout that has the resonant route's own entry also times it at k = 0:
the one-thread kernel on style 5's work. Prints, a route a line, the time
and a sha256 digest of the output's bytes, which is equal across checkouts
where the outputs are bit-equal. Run it for two checkouts in turns (parent,
change, change, parent) to compare them. Prints the card's name and power
limit first; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import subprocess
import sys

# The timer is chip_smoke.py's, from this script's checkout (before --root
# puts another checkout first on the path).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import time_ms  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--label", default=None)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from audiobd_tpu_torch.ops import effects as op
    from audiobd_tpu_torch.ops.build import ptr
    from audiobd_tpu_torch.poison import effects as fx
    from audiobd_tpu_torch.utils.device import resolve_device

    if not torch.cuda.is_available():
        print("effects_times: no CUDA device", file=sys.stderr)
        return 2
    resolve_device(None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    label = args.label or args.root
    print(f"[{label}] {smi}", flush=True)
    g = math.tan(math.pi * 1000.0 / 16000)
    big_g = g / (1 + g)
    for rows, t in ((256, 16000), (37, 4001)):
        gen = torch.Generator(device="cuda").manual_seed(7)
        n = torch.arange(t, device="cuda", dtype=torch.float32) / 16000
        f0 = 200.0 + 1600.0 * torch.rand(rows, 1, device="cuda", generator=gen)
        x = 0.4 * torch.sin(2 * math.pi * f0 * n) + 0.02 * torch.randn(rows, t, device="cuda", generator=gen)
        chain_x = fx.gain(x, 12.0)
        a = torch.from_numpy(fx.phaser_coefficients(t, 16000)).cuda()
        routes = {
            "ladder k=0": lambda: op.ladder_hpf12(chain_x, big_g, 0.0, 1.0),
            "ladder resonant": lambda: op.ladder_hpf12(x, big_g, 1.2, 10 ** (6 / 20)),
            "phaser 6": lambda: op.phaser(x, a, 6, 0.5),
            "phaser 4": lambda: op.phaser(x, a, 4, 0.5),
        }
        resonant = getattr(op, "LADDER_RESONANT_KERNEL", None)
        if resonant is not None and t % 4 == 0:
            y = torch.empty_like(chain_x)

            def one_thread(y=y, rows=rows, t=t, chain_x=chain_x):
                resonant(chain_x.device, ptr(chain_x), ptr(y), rows, t, big_g, 0.0, 1.0)
                return y

            routes["one-thread ladder k=0"] = one_thread
        for name, fn in routes.items():
            out = fn()
            torch.cuda.synchronize()
            digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
            ms = time_ms(torch, fn, 20)
            print(json.dumps({"label": label, "route": name, "rows": rows, "T": t, "ms": round(ms, 5),
                              "sha256": digest}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
