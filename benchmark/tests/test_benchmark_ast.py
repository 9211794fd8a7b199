"""A tiny copy of ``badnets_ast.train_b128`` on the CPU, skipping the look for
a card: AST at a tiny width (``zoo.AST_WIDTHS`` and the configuration's
widths alike), 8 clips a class, 16 a step. ``correct`` comes out true, with
each fault that applies planted underneath it false, and a traced run reads
every per-layer metric the cell lists without raising."""

from __future__ import annotations

import json
import time

import pytest
import torch

from benchmark import faults_ast, harness, run
from benchmark.tests import tinycells

TINY_WIDTHS = dict(patch=16, stride=10, dim=16, depth=2, heads=2, mlp_dim=32)
SIZES = {"badnets_ast.train_b128": ("tiny.ast", {"clips_per_class": 8, "batch_size": 16,
                                                 "widths": {**TINY_WIDTHS, "input_tdim": 128}}, {})}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tiny_ast")
    return tmp, tinycells.make(tmp, SIZES)


@pytest.fixture(autouse=True)
def tiny_widths(monkeypatch):
    from audiobd_tpu_torch.models import zoo

    monkeypatch.setattr(zoo, "AST_WIDTHS", TINY_WIDTHS)


def run_tiny(tiny, fault=None, traced: bool = False) -> dict:
    tmp, bench = tiny
    cell = harness.load_cell("tiny.ast", bench, tmp / "BENCHMARK.json")
    args = run.parse(["--workload", "tiny.ast", "--seed", "3000000019", "--seconds", "0.5",
                      "--trace", str(int(traced))])
    with faults_ast.planted(fault):
        return run.run_cell(cell, args, torch.device("cpu"), time.time(), bench)


@pytest.mark.parametrize("traced", [False, True])
def test_a_tiny_run_is_correct(tiny, traced):
    out = run_tiny(tiny, traced=traced)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1, json.dumps(out["checks"])
    if traced:
        # On the CPU the spans carry no timing events: the span readers find
        # nothing; the window's readers read.
        assert {"prep_s", "step_mfu.train"} <= set(out["metrics"])
    else:
        assert set(out["metrics"]) == {"train_clips_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "unscaled_attention", "altered_ast"])
def test_a_fault_underneath_turns_correct_false(tiny, fault):
    assert not run_tiny(tiny, fault)["correct"]


def test_the_cell_lists_its_metrics(tiny):
    cell = harness.load_cell("badnets_ast.train_b128")
    names = {m["name"] for m in cell.per_layer}
    assert {"attention_ms_per_step.ast", "mlp_ms_per_step.ast", "attention_roofline.ast", "step_mfu.train",
            "forward_ms_per_step.train", "prep_s"} <= names
    assert "conv1_bn_pool_bwd_params_roofline.train" not in names
    assert [m["name"] for m in cell.end_to_end] == ["train_clips_per_s", "setup_s"]
