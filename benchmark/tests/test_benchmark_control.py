"""The control on the card: the reference in TF32, the precision just below
the configurations' f32, put in the program's place, fails the cells'
limits on three seeds. TF32 exists only on the card, so the test is marked
``cuda`` and skips elsewhere. Run it there with
``python -m pytest --noconftest -p no:cacheprovider benchmark/tests/test_harness_control.py -m cuda``."""

from __future__ import annotations

import pytest
import torch

from benchmark import calibrate, harness
from benchmark.tests import tinycells

SIZES = {
    "badnets_smallcnn.train_b1024": ("card.train", {"clips_per_class": 500}, {}),
    "flowmur_smallcnn.search_b1024": ("card.search", {"hosts": 2400, "flowmur_opt_epochs": 1}, {}),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32, the control's precision, exists only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["card.train", "card.search"])
@pytest.mark.parametrize("seed", [3100000001, 3100000002, 3100000003])
def test_control_fails_the_limits(card, tmp_path, name, seed):
    bench = tinycells.make(tmp_path, SIZES)
    cell = harness.load_cell(name, bench, tmp_path / "BENCHMARK.json")
    driver = harness.load_module("drivers", cell.traffic["driver"], bench)
    ctx = calibrate.program(cell, driver, seed, card, None)
    ref = driver.reference_outputs(ctx, False)
    assert harness.judge(driver.numbers(ctx, ctx.program, ref), cell.limits)[0]
    assert not harness.judge(driver.numbers(ctx, driver.reference_outputs(ctx, True), ref), cell.limits)[0]
