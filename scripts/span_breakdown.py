#!/usr/bin/env python3
"""The program's spans over one traced run of a benchmark cell.

    python3 scripts/span_breakdown.py --workload <cell> [--seed N] [--seconds S]

Runs the cell as ``benchmark/run.py --trace 1`` does, on CUDA card 0 (a
span's timing events exist only there), prints the result line's per-layer
metrics and ``correct``, then a table of every span path recorded under
the profiler (the traced window and the unit before it): its count, its
mean device milliseconds (the stream time between its timing events) and
mean host milliseconds, the host syncs, the convolutions that took
``models/layers.py``'s row-slice route (``sliced``: the counter
``sliced_convs``) and the kernel launches a span, and, for a span with
children, the least and the median share of its device milliseconds that
its children's cover; then each path's launches a span by kernel (the
kernels' counters in ``utils/profiling.py``'s registry).
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=3000000019)
    p.add_argument("--seconds", type=float, default=30.0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from audiobd_tpu_torch.utils import profiling
    from benchmark import harness, run

    if not torch.cuda.is_available():
        print("needs a CUDA card: the spans' timing events exist only there", file=sys.stderr)
        return 2
    harness.set_cache_env()
    cell = harness.load_cell(args.workload)
    run_args = run.parse(["--workload", cell.name, "--seed", str(args.seed), "--seconds", str(args.seconds),
                          "--trace", "1"])
    out = run.run_cell(cell, run_args, torch.device("cuda", 0), time.time())
    print(f"{cell.name} on {torch.cuda.get_device_name(0)}: correct {out['correct']}; "
          + ", ".join(f"{k} {v['value']!r} {v['unit']}" for k, v in out["metrics"].items()))

    spans = profiling.recorded()
    children_ms: dict[int, float] = defaultdict(float)
    for s in spans:
        if s.parent is not None:
            children_ms[id(s.parent)] += s.device_ms
    by_path = defaultdict(list)
    for s in spans:
        by_path[s.path].append(s)
    print(f"{'span':<48} {'count':>6} {'device ms':>10} {'host ms':>9} {'syncs':>6} {'sliced':>6} {'launches':>8} "
          f"{'children cover (least, median)':>31}")
    for path, group in sorted(by_path.items()):
        cover = [children_ms[id(s)] / s.device_ms for s in group if id(s) in children_ms and s.device_ms > 0]
        cover_text = f"{min(cover):.4f}, {statistics.median(cover):.4f}" if cover else "-"
        mean = lambda f: statistics.mean(f(s) for s in group)  # noqa: E731
        print(f"{path:<48} {len(group):>6} {mean(lambda s: s.device_ms):>10.4f} "
              f"{mean(lambda s: (s.t1 - s.t0) / 1e6):>9.4f} {mean(lambda s: s.host_syncs):>6.3f} "
              f"{mean(lambda s: s.counts['sliced_convs']):>6.3f} "
              f"{mean(lambda s: s.launches):>8.3f} {cover_text:>31}")
    print("launches a span by kernel:")
    for path, group in sorted(by_path.items()):
        names = sorted({name for s in group for name in s.kernels})
        if names:
            print(f"  {path:<46} " + ", ".join(
                f"{name} {statistics.mean(s.kernels.get(name, 0) for s in group):.3f}" for name in names))
    return 0 if out["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
