#!/usr/bin/env python3
"""Looks for the block-1 card test's intermittent failure.

    python3 scripts/block1_fault_check.py [--runs 20] [--tanh_runs 20] [--root DIR]

1. Runs ``pytest --noconftest tests/test_torch_port_kernels_cuda.py -m cuda
   -k block1`` of the checkout at ``--root`` ``--runs`` times, each in a
   fresh process, and tallies them (needs a CUDA device; ``--runs 0`` skips).
2. Runs the same tests once under ``compute-sanitizer`` with ``--tool``
   racecheck, memcheck and initcheck, if the CUDA toolkit has it, and prints
   what each reports (``--log_dir``: where the full reports go).
3. The fault the old autograd test hit, on the CPU: in ``--tanh_runs`` fresh
   processes, forms the block's forward on the CPU from the autograd test's
   inputs, then calls ``torch.tanh`` on its output, the process's first
   tanh, with torch's default threads, and counts the elements that differ
   from float64 by more than 1e-6 (and the same with one thread).
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = ["tests/test_torch_port_kernels_cuda.py", "-m", "cuda", "-k", "block1"]
PYTEST = [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-q", *TESTS]


def first_tanh(root: str, threads: int) -> int:
    """One process of step 3: prints the count of elements off float64."""
    import torch

    if threads:
        torch.set_num_threads(threads)
    sys.path.insert(0, root)
    from audiobd_tpu_torch.ops import conv1_bn_pool as op

    rng = torch.Generator().manual_seed(3)
    x = torch.randn(8, 1, 21, 31, generator=rng)
    weight = torch.randn(16, 1, 2, 2, generator=rng) * 0.5
    bias = torch.randn(16, generator=rng) * 0.1 - 0.8
    with torch.no_grad():
        out = op.conv1_bn_pool(x, weight, bias, torch.linspace(-1.05, 1.45, 16), torch.linspace(-0.2, 0.3, 16),
                               train=True)[0]
    err = (torch.tanh(out).double() - torch.tanh(out.double())).abs()
    print(f"{int((err > 1e-6).sum())} {float(err.max()):.3e}", flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=20)
    parser.add_argument("--tanh_runs", type=int, default=20)
    parser.add_argument("--first_tanh", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--root", default=REPO, help="the checkout whose kernels and tests run")
    parser.add_argument("--log_dir", default=None, help="write compute-sanitizer's full reports here")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    if args.first_tanh is not None:
        return first_tanh(root, args.first_tanh)
    fails = 0
    if args.runs:
        import torch

        if not torch.cuda.is_available():
            print("block1_fault_check: no CUDA device", file=sys.stderr)
            return 2
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        for run in range(args.runs):
            proc = subprocess.run(PYTEST, cwd=root, capture_output=True, text=True)
            tail = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
            print(f"run {run + 1}: rc {proc.returncode}: {tail}", flush=True)
            if proc.returncode != 0:
                fails += 1
                print(proc.stdout[-3000:], flush=True)
        print(f"block1 card tests: {args.runs - fails} of {args.runs} fresh processes passed", flush=True)
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        sanitizer = shutil.which("compute-sanitizer") or os.path.join(cuda_home, "bin", "compute-sanitizer")
        if not os.path.exists(sanitizer):
            print(f"compute-sanitizer: not in this toolkit ({cuda_home}/bin)", flush=True)
        else:
            for tool in ("racecheck", "memcheck", "initcheck"):
                try:
                    proc = subprocess.run([sanitizer, "--tool", tool, "--error-exitcode", "9", *PYTEST], cwd=root,
                                          capture_output=True, text=True, timeout=300)
                except subprocess.TimeoutExpired:
                    print(f"compute-sanitizer --tool {tool}: timed out after 300 s", flush=True)
                    continue
                out = (proc.stdout + proc.stderr).strip().splitlines()
                print(f"compute-sanitizer --tool {tool}: rc {proc.returncode}", flush=True)
                if args.log_dir:
                    os.makedirs(args.log_dir, exist_ok=True)
                    with open(os.path.join(args.log_dir, f"sanitizer_{tool}.txt"), "w") as f:
                        f.write("\n".join(out))
                keys = ("rror", "nvalid", "azard", "SUMMARY", "not supported")
                print("\n".join([ln for ln in out if ln.startswith("=====") and any(k in ln for k in keys)][:10]),
                      flush=True)
    for threads, label in ((0, "default threads"), (1, "one thread")):
        counts = []
        for _ in range(args.tanh_runs):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--first_tanh", str(threads),
                                   "--root", root], cwd=root, capture_output=True, text=True, check=True)
            counts.append(proc.stdout.split())
        bad = [c for c in counts if c[0] != "0"]
        if args.tanh_runs:
            print(f"first CPU torch.tanh after the block's forward, {label}: {len(bad)} of {args.tanh_runs} "
                  f"processes off float64 by > 1e-6 (elements, max error: {[tuple(c) for c in bad]})", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
