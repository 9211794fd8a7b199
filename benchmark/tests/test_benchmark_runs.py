"""Runs of tiny copies of the cells on the CPU, skipping the look for a card:
``correct`` comes out true, and with each fault the cell can have planted
underneath it comes out false."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import faults, harness, run
from benchmark.tests import tinycells

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tiny")
    return tmp, tinycells.make(tmp)


def run_tiny(tiny, name: str, fault=None, traced: bool = False) -> dict:
    tmp, bench = tiny
    cell = harness.load_cell(name, bench, tmp / "BENCHMARK.json")
    args = run.parse(["--workload", name, "--seed", "3000000017", "--seconds", "0.5", "--trace", str(int(traced))])
    with faults.planted(fault):
        return run.run_cell(cell, args, torch.device("cpu"), time.time(), bench)


@pytest.mark.parametrize("name", ["tiny.train", "tiny.search"])
@pytest.mark.parametrize("traced", [False, True])
def test_a_tiny_run_is_correct(tiny, name, traced):
    out = run_tiny(tiny, name, traced=traced)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks" and all(c["value"] <= c["limit"] for c in out["checks"].values())
    if traced:
        assert "window_s" in out["device"] and "breakdown" in out
    else:
        assert "setup_s" in out["metrics"] and len(out["metrics"]) == 2


@pytest.mark.parametrize("name", ["tiny.train", "tiny.search"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_a_fault_underneath_turns_correct_false(tiny, name, fault):
    assert not run_tiny(tiny, name, fault)["correct"]


def test_four_ranks_over_gloo(tiny):
    """The four-card cell's driver with its ranks on the CPU: a run ends with
    every number near its limit (at 8 rows a rank, the CPU's sums round
    otherwise than the card's at 256: within ten times it), and with the
    exchange between ranks left out, ``correct`` is false (the ranks are
    processes of their own, so the fault is planted through calibrate.py,
    which runs the same set-up and comparison)."""
    tmp, bench = tiny
    name = "tiny.train_dp4"
    cell = harness.load_cell(name, bench, tmp / "BENCHMARK.json")
    driver = harness.load_module("drivers", cell.traffic["driver"], bench)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    old = dict(os.environ)
    os.environ.update(env)
    try:
        out = driver.main(cell, run.parse(["--workload", name, "--seed", "3000000017", "--seconds", "0.5"]),
                          time.time(), device="cpu")
    finally:
        os.environ.clear()
        os.environ.update(old)
    assert out is not None and out["failed"] == 0 and out["attempted"] >= 1
    assert all(c["value"] <= 10 * c["limit"] for c in out["checks"].values()), json.dumps(out["checks"])
    res = subprocess.run([sys.executable, str(bench / "calibrate.py"), "--workload", name, "--seeds", "3000000017",
                          "--faults", "no_exchange", "--device", "cpu", "--out", str(tmp / "calibrate")],
                         cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
    rows = [json.loads(line) for line in res.stdout.splitlines() if line.startswith("{")]
    fault = next(r for r in rows if r["kind"] == "no_exchange")
    assert not harness.judge(fault["numbers"], cell.limits)[0]
    program = next(r for r in rows if r["kind"] == "program")
    assert np.isfinite(list(program["numbers"].values())).all()
