#!/usr/bin/env python3
"""The readings that the limits of ``limits/<cell>.json`` are set from:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--control] [--faults half_batch,altered]
        [--out _bench_cache/calibrate]

For each seed, in one process (or one group of ranks for a cell on ranks):
the program's set-up and the steps that ``correct`` compares (for the search,
the window's first call), the reference, and the compared numbers; with
``--control`` also the control's numbers (the reference in TF32 against the
reference in f32); with ``--faults`` the numbers of the program with each
fault of ``faults.py`` planted. One JSON line a reading on stdout and in
``<out>/<cell>.jsonl``. Not a benchmark run: no window is timed.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import faults, harness  # noqa: E402
from benchmark.trace import Marks  # noqa: E402


def program(cell, driver, seed: int, device, fault, mesh=None, group=None):
    """The program's set-up and compared steps for ``seed``, with ``fault``
    planted; its ctx."""
    cell = SimpleNamespace(**{**cell.__dict__, "traffic": {**cell.traffic, "warmup_units": 0}})
    ctx = SimpleNamespace(cell=cell, seed=seed, device=device, mesh=mesh, group=group or harness.OneRank(),
                          phases={}, t_process=time.time(), bench=harness.BENCH, marks=Marks())
    with faults.planted(fault):
        driver.setup(ctx)
        if "window_history" in ctx.program:  # the search compares its window's first call too
            ctx.unit(0)
    return ctx


def emit(out_dir: Path, cell: str, row: dict) -> None:
    line = json.dumps(row, allow_nan=True)
    print(line, flush=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f"{cell}.jsonl", "a") as f:
        f.write(line + "\n")


def readings(cell, driver, seeds, control: bool, fault_names, device, out_dir: Path, mesh=None, group=None):
    rank0 = group is None or group.rank == 0
    for seed in seeds:
        t0 = time.time()
        ctx = program(cell, driver, seed, device, None, mesh, group)
        ref = driver.reference_outputs(ctx, False) if rank0 else None
        if rank0:
            row = {"seed": seed, "kind": "program", "numbers": driver.numbers(ctx, ctx.program, ref),
                   "seconds": time.time() - t0}
            if hasattr(driver, "leaf_detail"):
                row["worst_leaves"] = driver.leaf_detail(ctx, ctx.program, ref)
            emit(out_dir, cell.name, row)
            if control:
                emit(out_dir, cell.name, {"seed": seed, "kind": "control",
                                          "numbers": driver.numbers(ctx, driver.reference_outputs(ctx, True), ref)})
        for fault in fault_names:
            fctx = program(cell, driver, seed, device, fault, mesh, group)
            if rank0:
                emit(out_dir, cell.name, {"seed": seed, "kind": fault,
                                          "numbers": driver.numbers(fctx, fctx.program, ref)})
            del fctx
        del ctx, ref


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", default="")
    p.add_argument("--out", default="_bench_cache/calibrate")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    harness.set_cache_env()
    import torch

    cell = harness.load_cell(a.workload)
    seeds = [int(s) for s in a.seeds.split(",")]
    fault_names = [f for f in a.faults.split(",") if f]
    out_dir = Path(a.out)
    driver = harness.load_module("drivers", cell.traffic["driver"])
    ranks = int(cell.traffic.get("ranks", 1))
    if ranks == 1:
        device = torch.device(a.device if a.device != "cuda" else "cuda:0")
        readings(cell, driver, seeds, a.control, fault_names, device, out_dir)
        return 0
    if "RANK" not in os.environ:  # the parent: start the ranks under the launcher, wait for every one
        proc = driver.launch(str(Path(__file__).resolve()), list(argv or sys.argv[1:]), ranks)
        return 0 if driver.stop(proc, 3600.0) == 0 else 1
    from audiobd_tpu_torch.parallel.distributed import destroy, maybe_initialize_distributed
    from audiobd_tpu_torch.parallel.mesh import make_mesh
    from audiobd_tpu_torch.utils.device import resolve_device

    maybe_initialize_distributed()
    try:
        device = resolve_device(None if a.device == "cuda" else a.device)
        readings(cell, driver, seeds, a.control, fault_names, device, out_dir, make_mesh(-1, 1),
                 driver.Ranks(int(os.environ["RANK"]), ranks))
    finally:
        destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
