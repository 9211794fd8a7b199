#!/usr/bin/env python3
"""Per-warp cycle counters in kernel F's stage pipelines, on the card.

    python3 scripts/effects_probe.py [--root DIR] [--rows 256] [--T 16000]

Copies ``audiobd_tpu_torch`` of ``--root`` (default: this checkout) into a
temporary directory, adds clock64 counters to its csrc/effects.cu and
builds it there: for block 0, lane 0 of every warp, the cycles from a
step's start to its block barrier, summed over the steps, and the loader's
cycles inside cp.async.wait_group. Then runs the k = 0 ladder (style 5's
parameters) and the phaser (6 stages) on phase 1d's rows of chip_smoke.py
at (rows, T) through the C entries, and prints a route a line: ms a launch
(CUDA events over 20, the counters included), cycles a step, the loader's
wait, and each warp's busy cycles a step (warp 0 loader, 1 storer, then
the compute warps). The warp that is busy longest sets the step. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def instrument(src: str) -> str:
    """effects.cu with the counters and an ``effects_probe(out, reset)`` entry."""
    src = src.replace("namespace {\n", "__device__ unsigned long long g_prof[16][4];\nnamespace {\n", 1)
    wait = 'asm volatile("cp.async.wait_group %0;\\n" ::"n"(LOOKAHEAD) : "memory");'
    assert src.count(wait) == 1
    src = src.replace(wait, "const long long w0 = clock64();\n  " + wait + "\n  if (blockIdx.x == 0 && threadIdx.x == 0) "
                      "g_prof[0][1] += clock64() - w0;")
    loop = re.compile(r"  for \(int step = 0; step <= tiles \+ (\w+); \+\+step\) \{\n    if \(warp == 0\) \{")
    assert len(loop.findall(src)) == 2
    src = loop.sub(lambda m: f"""  const long long k0 = clock64();
  long long busy = 0, steps = 0;
  for (int step = 0; step <= tiles + {m.group(1)}; ++step) {{
    const long long s0 = clock64();
    ++steps;
    if (warp == 0) {{""", src)
    end = "    __syncthreads();\n  }\n}"
    assert src.count(end) == 2
    src = src.replace(end, """    busy += clock64() - s0;
    __syncthreads();
  }
  if (blockIdx.x == 0 && lane == 0) {
    g_prof[warp][0] = busy;
    g_prof[warp][2] = clock64() - k0;
    g_prof[warp][3] = steps;
  }
}""")
    return src.replace('extern "C" {\n', '''extern "C" {

int effects_probe(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[64] = {0};
    return static_cast<int>(cudaMemcpyToSymbol(g_prof, z, sizeof(z)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof)));
}
''', 1)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=REPO)
    parser.add_argument("--rows", type=int, default=256)
    parser.add_argument("--T", type=int, default=16000)
    args = parser.parse_args()
    if args.T % 4:
        parser.error("--T must be a multiple of 4 (the C entries read float4 rows)")
    tmp = tempfile.mkdtemp(prefix="effects_probe_")
    try:
        pkg = os.path.join(tmp, "audiobd_tpu_torch")
        shutil.copytree(os.path.join(os.path.abspath(args.root), "audiobd_tpu_torch"), pkg,
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        cu = os.path.join(pkg, "csrc", "effects.cu")
        with open(cu) as f:
            src = instrument(f.read())
        with open(cu, "w") as f:
            f.write(src)
        sys.path.insert(0, tmp)
        sys.path.insert(1, REPO)  # chip_smoke's inputs and timer
        import torch

        from audiobd_tpu_torch.ops import effects as op
        from audiobd_tpu_torch.ops.build import load_library, ptr
        from audiobd_tpu_torch.poison import effects as fx
        from chip_smoke import effects_inputs, time_ms

        if not torch.cuda.is_available():
            print("effects_probe: no CUDA device", file=sys.stderr)
            return 2
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        print(f"[{args.root}] {smi}", flush=True)
        lib = load_library("effects.cu")
        buf = (ctypes.c_ulonglong * 64)()
        rows, t = args.rows, args.T
        x, chain_x, a = effects_inputs(torch, fx, rows, t)
        y = torch.empty_like(x)
        g = math.tan(math.pi * 1000.0 / 16000)
        routes = {
            "ladder k=0": lambda: op.LADDER_KERNEL(x.device, ptr(chain_x), ptr(y), rows, t, g / (1 + g), 1.0,
                                                   op.ladder_shared_bytes()),
            "phaser 6": lambda: op.PHASER_KERNEL(x.device, ptr(x), ptr(a), ptr(y), rows, t, 6, 0.5, 0.5,
                                                 op.phaser_shared_bytes(6)),
        }
        for name, fn in routes.items():
            fn()
            torch.cuda.synchronize()
            lib.effects_probe(buf, 1)
            fn()
            torch.cuda.synchronize()
            lib.effects_probe(buf, 0)
            v = list(buf)
            ms = time_ms(torch, fn, 20)
            steps = max(v[3], 1)
            busy = " ".join(f"{v[4 * w] / steps:.0f}" for w in range(16) if v[4 * w])
            print(f"{name}, ({rows}, {t}): {ms:.4f} ms; {v[2] / steps:.0f} cycles a step ({steps} steps); "
                  f"loader's wait {v[1] / steps:.0f}; busy a step by warp: {busy}", flush=True)
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
