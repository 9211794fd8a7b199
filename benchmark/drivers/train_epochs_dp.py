"""Driver ``train_epochs_dp``: ``train_epochs`` on a group of ranks, one card
a rank over NCCL, as ``train_attack`` runs under ``torchrun``: sync-BN,
``shard_replicated``, ``ShardedDeviceDataset``, ``run_train_epoch_sharded``
and ``run_eval_sharded``. Every rank runs the whole prep, as the attack's
ranks do.

The parent builds the kernels once, then starts the ranks through
``torch.distributed.run --standalone`` (this file, run as a script), which
chooses a free rendezvous port on localhost when the run starts; rank 0
prints its result line, which the parent takes. A rank that fails ends the
others. The window is the slowest rank's; the reference runs on rank 0 once
the window has closed.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[2]
RESULT = "BENCH_RANK_RESULT "

if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.drivers.train_epochs import (  # noqa: E402,F401  (the ranks run train_epochs)
    check, end_to_end, failed_units, leaf_detail, numbers, readings, reference_outputs, setup)


def launch(script: str, args: list[str], world: int, **popen) -> subprocess.Popen:
    """``world`` ranks of ``script args`` under ``torch.distributed.run``, in
    a process group of their own (``stop`` ends them all)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(world),
           script, *args]
    return subprocess.Popen(cmd, cwd=str(ROOT), start_new_session=True, **popen)


def stop(proc: subprocess.Popen, timeout_s: float) -> int | None:
    """The launcher's exit code once it has ended by ``timeout_s``; past it,
    the launcher and every rank are ended (None)."""
    try:
        return proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        for sig, grace in ((signal.SIGTERM, 15.0), (signal.SIGKILL, 30.0)):
            try:
                os.killpg(proc.pid, sig)
            except ProcessLookupError:
                break
            try:
                proc.wait(timeout=grace)
                break
            except subprocess.TimeoutExpired:
                continue
        return None


def main(cell, args, t_process: float, device: str = "cuda") -> dict | None:
    """The parent: build, start the ranks, relay their output to stderr,
    wait for every one, and return rank 0's result. ``device`` "cpu" runs
    the ranks on the CPU over gloo (the tests)."""
    t0 = time.perf_counter()
    if device == "cuda":
        from audiobd_tpu_torch.ops.build import build_all

        build_all()
    build_s = time.perf_counter() - t0
    world = int(cell.traffic["ranks"])
    rank_args = ["--workload", cell.name, "--seed", str(args.seed), "--seconds", str(args.seconds),
                 "--trace", str(args.trace), "--t_process", repr(t_process), "--device", device]
    results: list[dict] = []
    proc = launch(str(Path(__file__).resolve()), rank_args, world, stdout=subprocess.PIPE,
                  stderr=subprocess.STDOUT, text=True)

    def drain() -> None:
        for line in proc.stdout:
            if line.startswith(RESULT):
                results.append(json.loads(line[len(RESULT):]))
            else:
                sys.stderr.write(line)

    reader = threading.Thread(target=drain, daemon=True)
    reader.start()
    code = stop(proc, float(cell.traffic["timeout_s"]))
    reader.join(timeout=30)
    print(f"parent: kernels built or found in {build_s:.3f} s; the launcher's exit code {code}",
          file=sys.stderr, flush=True)
    if code != 0 or len(results) != 1:
        print("a rank failed or gave no result", file=sys.stderr, flush=True)
        return None
    out = results[0]
    if out.pop("forbidden", []):
        print("rank 0 held JAX or the JAX package", file=sys.stderr, flush=True)
        return None
    return out


class Ranks:
    """The collectives the window and the result need, on CPU tensors
    (gloo, beside NCCL for the card's tensors)."""

    def __init__(self, rank: int, world: int):
        self.rank, self.world = rank, world

    def agree(self, flag: bool) -> bool:
        import torch
        import torch.distributed as dist

        t = torch.tensor([int(flag)])
        dist.broadcast(t, src=0)
        return bool(t.item())

    def max(self, x: float) -> float:
        import torch
        import torch.distributed as dist

        t = torch.tensor([float(x)], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())

    def mean(self, x: float) -> float:
        import torch
        import torch.distributed as dist

        t = torch.tensor([float(x)], dtype=torch.float64)
        dist.all_reduce(t)
        return float(t.item()) / self.world


def rank_main(argv=None) -> int:
    """One rank under the launcher: join, set up, run the window; rank 0
    checks and prints."""
    import argparse

    p = argparse.ArgumentParser()
    for name in ("--workload", "--t_process", "--device"):
        p.add_argument(name, required=True)
    for name in ("--seed", "--trace"):
        p.add_argument(name, type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    a = p.parse_args(argv)

    from benchmark import harness
    from benchmark.trace import Marks

    harness.set_cache_env()
    from audiobd_tpu_torch.parallel.distributed import destroy, maybe_initialize_distributed
    from audiobd_tpu_torch.parallel.mesh import make_mesh
    from audiobd_tpu_torch.utils.device import resolve_device

    t_process = float(a.t_process)
    cell = harness.load_cell(a.workload)
    t0 = time.time()
    maybe_initialize_distributed()
    mesh = make_mesh(-1, 1)
    device = resolve_device(None if a.device == "cuda" else a.device)
    group = Ranks(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]))
    ctx = SimpleNamespace(cell=cell, seed=a.seed, device=device, mesh=mesh, group=group,
                          phases={"start": t0 - t_process}, t_process=t_process, bench=harness.BENCH,
                          marks=Marks())
    ctx.phases["join"] = time.time() - t0
    try:
        setup(ctx)
        result = harness.execute(sys.modules[__name__], ctx, a.seconds, bool(a.trace))
    finally:
        destroy()
    if result is not None:
        result["forbidden"] = harness.forbidden_modules()
        print(RESULT + json.dumps(result, allow_nan=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(rank_main())
