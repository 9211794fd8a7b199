"""Cells, configurations, traffic, limits and per-layer metrics are found by
name, BENCHMARK.json keeps to its schema and limits, and a new cell, a new
configuration and a new per-layer metric each come in as new files alone."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"] and SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert 2 + 14 * 24 * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_units_and_keys():
    names = [x["name"] for group in ("configs", "workloads", "end_to_end", "per_layer") for x in SPEC[group]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    texts = [x["why"] for x in SPEC["configs"] + SPEC["workloads"]] + [c["source"] for c in SPEC["configs"]]
    texts += [m["layer"] for m in SPEC["per_layer"]] + SPEC["command"]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_loads_by_name(cell):
    c = harness.load_cell(cell)
    assert c.chips in (1, 4) and c.traffic["driver"]
    assert (harness.BENCH / "drivers" / f"{c.traffic['driver']}.py").is_file()
    assert (harness.BENCH / "roofline" / f"{c.config_name}.py").is_file()
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
    for m in c.per_layer:  # each metric it lists moves an end-to-end metric the cell reports
        assert m["moves"] in reported
        assert callable(harness.load_module("metrics", m["name"]).read)
    assert c.limits and all(v >= 0 for v in c.limits.values())


def test_four_chip_cells_at_most_a_quarter():
    fours = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert len(fours) <= max(1, len(SPEC["workloads"]) // 4)


def test_new_cell_config_and_metric_as_new_files(tmp_path):
    """A later PR's cell at the published batch of 256 (§7 of PERF.md): a
    configuration, a traffic mix, limits, counts and a metric, each a new
    file, and entries in BENCHMARK.json; no file that is there changes."""
    bench = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    spec = json.loads(json.dumps(SPEC))
    (bench / "configs" / "badnets_smallcnn_b256.json").write_text(
        json.dumps({**json.loads((bench / "configs" / "badnets_smallcnn.json").read_text()), "batch_size": 256}))
    (bench / "traffic" / "train.json").write_text((bench / "traffic" / "train_b1024.json").read_text())
    (bench / "limits" / "badnets_smallcnn_b256.train.json").write_text(
        (bench / "limits" / "badnets_smallcnn.train_b1024.json").read_text())
    shutil.copy(bench / "roofline" / "badnets_smallcnn.py", bench / "roofline" / "badnets_smallcnn_b256.py")
    (bench / "metrics" / "units_traced.py").write_text("def read(r):\n    return float(r.units)\n")
    spec["configs"].append({"name": "badnets_smallcnn_b256", "source": "x", "why": "x", "reduced": [],
                            "file": "benchmark/configs/badnets_smallcnn_b256.json"})
    spec["workloads"].append({"name": "badnets_smallcnn_b256.train", "config": "badnets_smallcnn_b256",
                              "traffic": "train", "chips": 1, "why": "x"})
    for m in spec["end_to_end"]:
        if "badnets_smallcnn.train_b1024" in m.get("workloads", []):
            m["workloads"].append("badnets_smallcnn_b256.train")
    spec["per_layer"].append({"name": "units_traced", "unit": "units", "better": "higher", "source": "device_trace",
                              "layer": "Device", "moves": "train_clips_per_s",
                              "workloads": ["badnets_smallcnn_b256.train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    after = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())  # nothing there was edited
    cell = harness.load_cell("badnets_smallcnn_b256.train", bench, tmp_path / "BENCHMARK.json")
    assert cell.traffic["driver"] == "train_epochs" and cell.config["batch_size"] == 256
    assert [m["name"] for m in cell.per_layer] == ["units_traced"]
    assert [m["name"] for m in cell.end_to_end] == ["train_clips_per_s", "setup_s"]
    got = harness.read_per_layer(cell, {"units": 3}, bench)
    assert got == {"units_traced": {"value": 3.0, "unit": "units"}}
    work = harness.load_module("roofline", cell.config_name, bench).counts_for(cell.config, cell.traffic)
    assert work["kernels"]["conv1_bn_pool_bwd_params"]["bound_s"] < 0.3 * harness.load_module(
        "roofline", "badnets_smallcnn", bench).counts_for(harness.load_cell("badnets_smallcnn.train_b1024").config,
                                                          cell.traffic)["kernels"]["conv1_bn_pool_bwd_params"]["bound_s"]


def test_a_reader_that_finds_nothing_is_left_out():
    cell = harness.load_cell("flowmur_smallcnn.search_b1024")
    readings = {"prep_s": None, "train_steps": 0, "search_steps": 0, "cards": 1, "flops": 0.0,
                "counts": {}, "trace": {"kernels": [], "spans": {}, "busy_s": 0.0, "window_s": 1.0}}
    from benchmark import trace

    assert harness.read_per_layer(cell, {**readings, "trace_mod": trace, "peak_flops": 1.0}) == {}
