#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints one JSON line last on stdout (see
``harness.result_line``) and the compared numbers beside their limits last on
stderr. Exits non-zero, with no result, without CUDA or with fewer cards than
the cell asks for, and when the process holds JAX or the JAX package.
"""

from __future__ import annotations

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# One host thread for the CPU math libraries: the cells' host work is the
# dispatch of one Python thread, and idle pools only add noise to it.
os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = "1"


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="run one benchmark cell once")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(cell, args, device, t_process: float, bench=None) -> dict:
    """Set-up, window and check of a one-process cell on ``device`` (the
    tests call this with the CPU, skipping the look for a card)."""
    from benchmark import harness
    from benchmark.trace import Marks

    bench = bench or harness.BENCH
    driver = harness.load_module("drivers", cell.traffic["driver"], bench)
    ctx = SimpleNamespace(cell=cell, seed=args.seed, device=device, mesh=None, group=harness.OneRank(),
                          phases={}, t_process=t_process, bench=bench, marks=Marks())
    t0 = time.time()
    ctx.phases["start"] = t0 - t_process
    driver.setup(ctx)
    return harness.execute(driver, ctx, args.seconds, bool(args.trace))


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import harness

    harness.set_cache_env()
    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"cell {cell.name} needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    driver = harness.load_module("drivers", cell.traffic["driver"])
    if hasattr(driver, "main"):  # a driver that starts its own processes
        result = driver.main(cell, args, T_PROCESS)
    else:
        result = run_cell(cell, args, torch.device("cuda", 0), T_PROCESS)
    if result is None:
        return 1
    return harness.finish(result)


if __name__ == "__main__":
    sys.exit(main())
