"""The readers of the program's spans (``metrics/*_per_step.*``,
``metrics/step_idle_pct.*``) on fake spans: a traced window's worth of the
program's span tree, with a warm-up unit outside the benchmark's marks and
timing events that carry fixed milliseconds. Each reader reads only the
spans inside the marks, and returns None where the step spans disagree with
the step count, where the spans carry no events (the CPU), and where the
program records no spans."""

from __future__ import annotations

from collections import deque
from types import SimpleNamespace

import pytest

from audiobd_tpu_torch.utils import profiling
from benchmark import harness, trace

STEPS = 3
STEP_NS = 1_000_000  # a step's host interval
CHILD_MS = {"forward": 4.0, "loss": 0.25, "backward": 9.0, "optimizer": 0.5, "metrics": 0.25,
            "deploy": 1.0, "mfcc": 8.0, "surrogate": 2.0, "adam": 0.5}
CELLS = {
    "train": {"mark": "train", "root": "train_epoch", "step": "train_step", "root_syncs": 4,
              "children": ["forward", "loss", "backward", "optimizer", "metrics"]},
    "search": {"mark": "search", "root": "search_call", "step": "search_step", "root_syncs": 2 + 2 * STEPS,
               "children": ["deploy", "mfcc", "surrogate", "backward", "adam"]},
}


class FakeEvent:
    """A timing event at a fixed millisecond of the stream."""

    def __init__(self, ms: float):
        self.ms = ms

    def elapsed_time(self, end: FakeEvent) -> float:
        return end.ms - self.ms


def fake_span(name, parent, t0, t1, ms=None, syncs=0):
    s = profiling.Span(name, parent)
    s.t0, s.t1, s.host_syncs = t0, t1, syncs
    if ms is not None:
        s.start_event, s.end_event = FakeEvent(0.0), FakeEvent(ms)
    return s


def fake_unit(cell: dict, t0: int, events: bool = True) -> list:
    """One unit's spans from ``t0``: the root, then ``STEPS`` steps, each
    with its children in turn."""
    ms = lambda v: v if events else None  # noqa: E731
    root = fake_span(cell["root"], None, t0, t0 + (STEPS + 1) * STEP_NS, ms(100.0), cell["root_syncs"])
    spans = []
    for i in range(STEPS):
        a = t0 + i * STEP_NS
        step = fake_span(cell["step"], root, a, a + STEP_NS, ms(sum(CHILD_MS[c] for c in cell["children"])))
        n = len(cell["children"])
        spans += [fake_span(c, step, a + k * STEP_NS // n, a + (k + 1) * STEP_NS // n, ms(CHILD_MS[c]))
                  for k, c in enumerate(cell["children"])] + [step]
    return spans + [root]


def readings(kind: str, steps: int = STEPS, kernels=()) -> SimpleNamespace:
    """The readers' inputs: the warm-up unit's spans at 0, the window's at
    10 steps' ns, its mark around the window's unit alone."""
    cell = CELLS[kind]
    t0 = 10 * STEP_NS
    window = (t0, t0 + (STEPS + 1) * STEP_NS)
    return SimpleNamespace(trace={"spans": {cell["mark"]: [window]}, "kernels": list(kernels),
                                  "window_s": (window[1] - window[0]) / 1e9},
                           train_steps=steps if kind == "train" else 0,
                           search_steps=steps if kind == "search" else 0, trace_mod=trace)


def reader(name: str):
    return harness.load_module("metrics", name).read


def planted(monkeypatch, kind: str, events: bool = True) -> None:
    cell = CELLS[kind]
    monkeypatch.setattr(profiling, "_SPANS", deque(fake_unit(cell, 0, events) + fake_unit(cell, 10 * STEP_NS, events)))


# Each device-ms reader reads its child's milliseconds once a step.
@pytest.mark.parametrize("name,kind,child", [
    ("forward_ms_per_step.train", "train", "forward"),
    ("backward_ms_per_step.train", "train", "backward"),
    ("optimizer_ms_per_step.train", "train", "optimizer"),
    ("mfcc_ms_per_step.search", "search", "mfcc"),
    ("backward_ms_per_step.search", "search", "backward"),
])
def test_device_ms_per_step(monkeypatch, name, kind, child):
    planted(monkeypatch, kind)
    assert reader(name)(readings(kind)) == pytest.approx(CHILD_MS[child])


@pytest.mark.parametrize("name,kind", [("host_syncs_per_step.train", "train"),
                                       ("host_syncs_per_step.search", "search")])
def test_host_syncs_per_step(monkeypatch, name, kind):
    planted(monkeypatch, kind)
    assert reader(name)(readings(kind)) == pytest.approx(CELLS[kind]["root_syncs"] / STEPS)


@pytest.mark.parametrize("name,kind", [("step_idle_pct.train", "train"), ("step_idle_pct.search", "search")])
def test_step_idle_pct(monkeypatch, name, kind):
    """Idle inside the step spans only: the first step half busy, the second
    busy through two overlapping operations, the third idle; an operation in
    the root span outside every step is not counted."""
    planted(monkeypatch, kind)
    t0 = 10 * STEP_NS
    kernels = [("k", t0, t0 + STEP_NS // 2), ("k", t0 + STEP_NS, t0 + 2 * STEP_NS - 10),
               ("k", t0 + STEP_NS + 5, t0 + 2 * STEP_NS), ("k", t0 + 3 * STEP_NS, t0 + 4 * STEP_NS)]
    r = readings(kind, kernels=kernels)
    idle_ns = STEP_NS // 2 + 0 + STEP_NS
    assert reader(name)(r) == pytest.approx(100.0 * idle_ns / 1e9 / r.trace["window_s"])


NAMES = ["forward_ms_per_step.train", "backward_ms_per_step.train", "optimizer_ms_per_step.train",
         "host_syncs_per_step.train", "step_idle_pct.train", "mfcc_ms_per_step.search",
         "backward_ms_per_step.search", "host_syncs_per_step.search", "step_idle_pct.search"]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("case", ["steps_disagree", "no_events", "no_spans", "program_without_spans"])
def test_none_where_nothing_fits(monkeypatch, name, case):
    kind = name.rsplit(".", 1)[1]
    planted(monkeypatch, kind, events=case != "no_events")
    if case == "no_spans":
        monkeypatch.setattr(profiling, "_SPANS", deque())
    if case == "program_without_spans":  # the parent of the change that added them
        monkeypatch.delattr(profiling, "recorded")
    assert reader(name)(readings(kind, steps=STEPS + 1 if case == "steps_disagree" else STEPS)) is None


def test_every_reader_is_listed_once_in_its_cell():
    cells = {"train": "badnets_smallcnn.train_b1024", "search": "flowmur_smallcnn.search_b1024"}
    for name in NAMES:
        cell = harness.load_cell(cells[name.rsplit(".", 1)[1]])
        assert [m["name"] for m in cell.per_layer].count(name) == 1
        metric = next(m for m in cell.per_layer if m["name"] == name)
        assert metric["source"] == "device_trace" and metric["moves"] == cell.traffic["rate_metric"]
