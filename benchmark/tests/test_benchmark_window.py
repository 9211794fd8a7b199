"""The window's arithmetic (whole units, all work over all time) and the
trace's reduction to busy time, kernels and labelled idle gaps over the
window's whole wall."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, trace


def test_whole_units_until_the_seconds_have_passed():
    done = []
    units, secs = harness.whole_units(lambda i: (done.append(i), time.sleep(0.03)), 0.1, lambda: None)
    assert done == list(range(units)) and units >= 4
    assert secs >= 0.03 * units and secs >= 0.1
    assert units * 0.03 <= secs < units * 0.03 + 0.05  # the rate is all the units over all their time


def test_whole_units_limit_and_agreement():
    units, _ = harness.whole_units(lambda i: None, 100.0, lambda: None, limit=3)
    assert units == 3
    decisions = iter([False, False, True])
    units, _ = harness.whole_units(lambda i: None, 100.0, lambda: None, agree=lambda flag: next(decisions))
    assert units == 3  # every rank takes rank 0's decision


def test_union_and_membership():
    assert trace.union([(5, 6), (0, 2), (1, 3), (3, 4)]) == [(0, 4), (5, 6)]
    kernels = [("a", 1, 2), ("b", 3, 4), ("a", 7, 9)]
    assert trace.within(kernels, [(0.5, 3.5)]) == kernels[:2]
    assert trace.count(kernels, "a") == 2
    assert trace.seconds(kernels, ("a",)) == 3.0 / 1e9
    assert trace.covered([(0, 4), (2, 6), (9, 20)], 1, 10) == 5 + 1


def test_idle_gaps_take_the_runtime_call_then_the_innermost_phase():
    gaps = [(10, 20), (30, 31), (50, 60)]
    runtime = [("cudaLaunchKernel", 29, 32)]
    phases = [("unit", 0, 100), ("eval", 12, 18)]
    assert dict(trace.label_gaps(gaps, runtime, phases)) == {"host: unit": pytest.approx(10e-9),
                                                             "host: eval": pytest.approx(10e-9),
                                                             "cudaLaunchKernel": pytest.approx(1e-9)}
    assert trace.label_gaps(gaps, [], []) == [["host: between phases", pytest.approx(21e-9)]]


class _Event:
    def __init__(self, name, device, start, end):
        self._v = (name, device, start, end)

    def name(self):
        return self._v[0]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[1] else torch.autograd.DeviceType.CPU

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]


def fake_profile(rows):
    results = SimpleNamespace(events=lambda: [_Event(*r) for r in rows])
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def test_reduce_counts_idle_over_the_whole_window():
    """Busy is the union of the device's operations clipped to the window;
    the idle edges before the first and after the last operation count, and
    an operation outside the window does not."""
    rows = [("cudaDeviceSynchronize", False, 90, 99),  # the sync before the window, 1 ns late
            ("k_before", True, 50, 95),
            ("k1", True, 110, 150), ("k2", True, 140, 170), ("k3", True, 190, 195),
            ("cudaLaunchKernel", False, 171, 189), ("cudaStreamSynchronize", False, 150, 196),
            ("k_after", True, 200, 260)]
    marks = trace.Marks()
    marks.spans.append(("train", 100, 198))
    r = trace.reduce(fake_profile(rows), (100, 200), marks, sync=(89, 98))
    assert r["window_s"] == pytest.approx(100e-9)
    assert r["busy_s"] == pytest.approx((170 - 110 + 5) * 1e-9)
    assert [k[0] for k in r["kernels"]] == ["k1", "k2", "k3"]
    assert r["host_wait_s"] == pytest.approx(46e-9)
    assert r["clock_skew_us"] == pytest.approx(1e-3)
    assert r["device_ops"][0] == ["k1", pytest.approx(40e-9)]
    idle = dict((n, v) for n, v in r["idle_gaps"])
    assert sum(idle.values()) == pytest.approx(r["window_s"] - r["busy_s"])
    assert idle["host: train"] == pytest.approx(10e-9 + 5e-9)  # the gap at the start and the one at the end
    assert idle["cudaLaunchKernel"] == pytest.approx(20e-9)
