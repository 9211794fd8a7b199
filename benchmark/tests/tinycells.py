"""A copy of the benchmark in a temporary directory with tiny cells beside
the real ones, for the CPU tests: each real cell's configuration, traffic
and limits cut to a size a CPU test can hold, under the name ``tiny.<cell>``.

The four-card cell's files are in ``benchmark/`` but its entries are not in
``BENCHMARK.json`` (PERF.md §7: its runs spread too widely on some hosts for
any bound): ``FOUR_CARDS`` holds the entries a PR that lists it would add,
so that its driver stays tested."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
TINY = {
    "badnets_smallcnn.train_b1024": ("tiny.train", {"clips_per_class": 40, "batch_size": 16}, {}),
    "flowmur_smallcnn.search_b1024": ("tiny.search", {"hosts": 80, "flowmur_opt_epochs": 2, "batch_size": 16}, {}),
    "badnets_smallcnn.train_dp4": ("tiny.train_dp4", {"clips_per_class": 40, "batch_size": 32}, {}),
}
DP4 = "badnets_smallcnn.train_dp4"
FOUR_CARDS = {
    "workloads": [{"name": DP4, "config": "badnets_smallcnn", "traffic": "train_dp4", "chips": 4,
                   "why": "the train mix over four ranks, a card each over NCCL, global batch 1,024"}],
    "end_to_end": [{"name": "train_clips_per_s.dp4", "unit": "clips/s", "better": "higher", "bound": 0.25,
                    "source": "host_clock", "workloads": [DP4]}],
    "per_layer": [{"name": name, "unit": unit, "better": better, "source": "device_trace", "layer": layer,
                   "moves": "train_clips_per_s.dp4", "workloads": [DP4]}
                  for name, unit, better, layer in (
                      ("launches_per_step.dp4", "launches/step", "lower", "Epoch engine: train/scan_epoch.py"),
                      ("nccl_ms_per_step.dp4", "ms/step", "lower", "Data parallel"),
                      ("step_mfu.dp4", "%", "higher", "The whole step"),
                      ("device_idle_pct.dp4", "%", "lower", "Device"))],
}


def make(tmp: Path, sizes: dict | None = None) -> Path:
    """tmp/benchmark (a copy) and tmp/BENCHMARK.json with the tiny cells
    (``sizes`` in place of ``TINY``); returns the copy's benchmark
    directory."""
    bench = tmp / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for group, entries in FOUR_CARDS.items():
        spec[group] += [e for e in entries if e["name"] not in {x["name"] for x in spec[group]}]
    cells = {w["name"]: w for w in spec["workloads"]}
    for real, (name, cfg_over, traffic_over) in (sizes or TINY).items():
        w = cells[real]
        cfg = json.loads((bench / "configs" / f"{w['config']}.json").read_text())
        traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
        stem = name.replace(".", "_")
        (bench / "configs" / f"{stem}.json").write_text(json.dumps({**cfg, **cfg_over}))
        (bench / "traffic" / f"{stem}.json").write_text(json.dumps({**traffic, **traffic_over}))
        shutil.copy(bench / "roofline" / f"{w['config']}.py", bench / "roofline" / f"{stem}.py")
        shutil.copy(bench / "limits" / f"{real}.json", bench / "limits" / f"{name}.json")
        spec["workloads"].append({**w, "name": name, "config": stem, "traffic": stem})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return bench
