"""What every cell's run shares: finding the cell's files by name, the
measured window, the per-layer readers, and the result line.

A run: set-up (imports, CUDA, the kernels' build or cache, inputs made on the
device from the seed, the program's prep, the first steps that ``correct``
is decided on, warm-up), then whole units of work until ``--seconds`` have
passed, then the reference, once the window has closed and the program's
state is freed. ``--trace 1`` runs the same set-up, one unit under the
profiler outside the window, then a traced window of the traffic's
``trace_units`` units, and reports the per-layer metrics.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType, SimpleNamespace

from benchmark.compare import judge

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Top-level module names that no process of a run may hold: JAX and the JAX
# package the port was made from (compared whole: the port's name begins
# with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "audiobd_tpu")
# Build and kernel caches at fixed paths inside the checkout.
CACHE_DIR = ROOT / "_bench_cache"


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic: dict
    chips: int
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench: Path = BENCH, spec_path: Path | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, with its configuration,
    traffic and limits read from their own files, and the metrics it
    reports."""
    spec = _load_json(spec_path or bench.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {sorted(cells)})")
    w = cells[name]

    def applies(metric: dict) -> bool:
        return "workloads" not in metric or name in metric["workloads"]

    return Cell(
        name=name,
        config_name=w["config"],
        config=_load_json(bench / "configs" / f"{w['config']}.json"),
        traffic=_load_json(bench / "traffic" / f"{w['traffic']}.json"),
        chips=int(w["chips"]),
        limits=_load_json(bench / "limits" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if applies(m)],
        per_layer=[m for m in spec["per_layer"] if applies(m)],
    )


def load_module(kind: str, name: str, bench: Path = BENCH) -> ModuleType:
    """``<bench>/<kind>/<name>.py`` (a driver, a metric's reader, a
    configuration's counts), loaded by its path: names may hold dots."""
    path = bench / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name.replace('.', '_')}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def set_cache_env() -> None:
    """Fixed cache directories inside the checkout for the program's builds
    (the port builds its kernels into its own ``_build/``)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE_DIR / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")


def forbidden_modules() -> list[str]:
    """Whole top-level names in this process's ``sys.modules`` that a run may
    not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def whole_units(unit, seconds: float, sync, limit: int | None = None, agree=lambda flag: flag,
                ends: list | None = None) -> tuple[int, float]:
    """Run ``unit(i)`` for i = 0, 1, ... until ``seconds`` have passed (or
    ``limit`` units), each synced; (units, seconds from the first's start to
    the last's end). ``agree`` makes every rank take rank 0's decision;
    ``ends`` gets the seconds at which each unit ended."""
    t0 = time.perf_counter()
    n = 0
    while True:
        unit(n)
        sync()
        n += 1
        elapsed = time.perf_counter() - t0
        if ends is not None:
            ends.append(elapsed)
        if agree(elapsed >= seconds or (limit is not None and n >= limit)):
            return n, elapsed


def read_per_layer(cell: Cell, readings: dict, bench: Path = BENCH) -> dict:
    """{metric: {"value", "unit"}} from each per-layer metric's reader; a
    reader that finds nothing returns None and its metric is left out."""
    out = {}
    for metric in cell.per_layer:
        value = load_module("metrics", metric["name"], bench).read(SimpleNamespace(**readings))
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict, checks: dict,
                breakdown: dict | None = None) -> dict:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed), "metrics": metrics,
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks  # last: each compared number beside its limit
    return out


def finish(result: dict) -> int:
    """Refuse a process that holds JAX or the JAX package; otherwise print
    the compared numbers as the last lines of stderr and the result as the
    last line of stdout. 0 if the run is whole."""
    found = forbidden_modules()
    if found:
        print(f"refused: this process holds {found}", file=sys.stderr, flush=True)
        return 3
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=True), flush=True)
    return 0


def e2e_metric(cell: Cell, name: str, value: float) -> dict:
    unit = next(m["unit"] for m in cell.end_to_end if m["name"] == name)
    return {"value": value, "unit": unit}


def execute(driver: ModuleType, ctx, seconds: float, traced: bool) -> dict | None:
    """The window and the check, after ``driver.setup(ctx)``: whole units
    until ``seconds`` have passed (traced: the traffic's ``trace_units``,
    after one unit that warms the profiler up), the memory peak, the
    per-layer readings or the end-to-end metrics, then the reference.
    ``ctx.group`` holds the collectives of a run on ranks (``agree``, ``max``,
    ``mean``, ``rank``); the result is rank 0's, None on the other ranks."""
    import torch

    from benchmark import trace as tr
    from benchmark.roofline.peaks import PEAK_BYTES_PER_S, PEAK_F32_FLOPS

    group = ctx.group
    dev = ctx.device
    if dev.type == "cuda" and (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32):
        raise RuntimeError("TF32 is on: the configurations state f32, and the f32 peak would not bound the step")
    limit = ctx.cell.traffic["trace_units"] if traced else None
    prof = tr.profiler() if traced else None
    if prof is not None:
        prof.__enter__()
    try:
        if traced:  # the profiler's first activity buffers are filled outside the window
            ctx.unit(-1)
        t_a = time.time_ns()
        sync_device(dev)
        t_b = time.time_ns()
        ctx.window_start = time.time()
        ctx.marks.spans.clear()
        ends: list[float] = []
        units, secs = whole_units(ctx.unit, seconds, lambda: sync_device(dev), limit, group.agree, ends)
        t_end = time.time_ns()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    secs = group.max(secs)
    memory = int(group.max(float(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0.0))
    reduced = tr.reduce(prof, (t_b, t_end), ctx.marks, (t_a, t_b)) if traced else None
    busy = group.mean(reduced["busy_s"]) if traced else None
    failed = int(group.max(float(driver.failed_units(ctx))))
    if group.rank != 0:
        return None
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": ctx.cell.chips, "memory_peak_bytes": memory}
    setup_s = ctx.window_start - ctx.t_process
    if traced:
        metrics = read_per_layer(ctx.cell, driver.readings(ctx, units, reduced), ctx.bench)
        device.update(busy_s=busy, window_s=reduced["window_s"])
        breakdown = {"device_ops": reduced["device_ops"], "idle_gaps": reduced["idle_gaps"]}
        wait = reduced["host_wait_s"]
        print(f"trace: window {reduced['window_s']!r} s; device busy {reduced['busy_s']!r} s on this card, "
              f"{busy!r} s averaged over the cards; host waiting on the device "
              f"{'not traced' if wait is None else repr(wait) + ' s'}, host busy "
              f"{'not traced' if wait is None else repr(reduced['window_s'] - wait) + ' s'}; "
              f"profiler clock against the host's {reduced['clock_skew_us']!r} us; peaks {PEAK_F32_FLOPS!r} "
              f"FLOP/s (f32, TF32 off), {PEAK_BYTES_PER_S!r} B/s", file=sys.stderr, flush=True)
    else:
        metrics = {name: e2e_metric(ctx.cell, name, v) for name, v in driver.end_to_end(ctx, units, secs).items()}
        metrics["setup_s"] = e2e_metric(ctx.cell, "setup_s", setup_s)
        breakdown = None
    print(f"set-up {setup_s:.3f} s: " + ", ".join(f"{k} {v:.3f}" for k, v in ctx.phases.items())
          + f"; window {units} units in {secs:.3f} s; {unit_seconds(ends)}", file=sys.stderr, flush=True)
    numbers = driver.check(ctx)
    ok, checks = judge(numbers, ctx.cell.limits)
    return result_line(ok and failed == 0, units, failed, metrics, device, checks, breakdown)


def unit_seconds(ends: list[float]) -> str:
    """Each unit's seconds on this rank, summed up: the first three, the
    median, the slowest and the last three."""
    if not ends:
        return "no unit"
    each = [b - a for a, b in zip([0.0, *ends[:-1]], ends)]
    fmt = lambda xs: ", ".join(f"{x:.4f}" for x in xs)  # noqa: E731
    return (f"unit seconds: first {fmt(each[:3])}; median {statistics.median(each):.4f}; slowest {max(each):.4f}; "
            f"last {fmt(each[-3:])}")


def sync_device(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class OneRank:
    """The collectives of a run on one process: identities."""

    rank = 0

    @staticmethod
    def agree(flag: bool) -> bool:
        return flag

    @staticmethod
    def max(x: float) -> float:
        return x

    @staticmethod
    def mean(x: float) -> float:
        return x
