"""The traced window: ``torch.profiler`` with the device's activity alone,
reduced to the device's busy time, its operations, and its idle gaps
labelled by what the host was doing during each.

The profiler records the card's operations and the host's CUDA runtime calls
(launches, copies, synchronisations), and no host operator: recording every
host operator costs the host some microseconds an operator, which slows a
window of small launches enough to leave the card idle for a third of it.
The window's edges and the host's phases (``Marks``) are taken on the host's
clock, ``time.time_ns()``, the clock the profiler stamps its events with; the
synchronisation at the window's start checks that the two agree.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np

TOP = 10
LABELLED = 2000
# Host runtime calls in which the host waits for the device.
WAITS = {"cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize", "cudaMemcpy"}
SYNC = "cudaDeviceSynchronize"


class Marks:
    """The host's phases on its own clock (ns): ``with marks("train"): ...``."""

    def __init__(self):
        self.spans: list[tuple[str, int, int]] = []

    def __call__(self, name: str):
        return _Span(self, name)


class _Span:
    def __init__(self, marks: Marks, name: str):
        self.marks, self.name = marks, name

    def __enter__(self):
        self.t0 = time.time_ns()

    def __exit__(self, *exc):
        self.marks.spans.append((self.name, self.t0, time.time_ns()))


def profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        return profile(activities=[ProfilerActivity.CPU])  # the CPU tests: host operators only
    return profile(activities=[ProfilerActivity.CUDA])


def events(prof):
    """(name, on the device, start ns, end ns) of every recorded event, read
    from the profiler's raw results (building its event tree takes minutes for
    a window's hundreds of thousands of events). A user annotation's copy on
    the device's timeline is no operation and is left out."""
    import torch

    device_kind = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == device_kind
        if on_device and getattr(e, "is_user_annotation", lambda: False)():
            continue
        start = e.start_ns()
        yield e.name(), on_device, start, start + e.duration_ns()


def union(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Merged intervals of ``spans``."""
    out: list[list[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(spans: list[tuple[float, float]], w0: float, w1: float) -> float:
    """Length of the union of ``spans`` clipped to [w0, w1]."""
    return sum(e - s for s, e in union([(max(s, w0), min(e, w1)) for s, e in spans if e > w0 and s < w1]))


def reduce(prof, window: tuple[int, int], marks: Marks, sync: tuple[int, int] | None = None) -> dict:
    """The trace over ``window`` (host ns, its start and end):
    {"kernels": [(name, start_ns, end_ns)] of the device operations that ran
    in it, "spans": {phase: [(start_ns, end_ns)]} of the host's marks,
    "busy_s" (the union of the device operations' intervals within the
    window), "window_s", "host_wait_s" (the host inside a runtime call that
    synchronises with the device; a launch that waits for room in a full
    launch queue is not counted; None where the runtime calls were not
    traced),
    "clock_skew_us" (how far the profiler's record of ``sync``, the
    synchronisation before the window, lies from the host's), "device_ops"
    and "idle_gaps" (each the longest ten, [name, seconds])}."""
    w0, w1 = window
    kernels, runtime = [], []
    for name, on_device, start, end in events(prof):
        if end <= w0 or start >= w1:
            if not on_device and name == SYNC and sync is not None and start < w0:
                runtime.append((name, start, end))
            continue
        (kernels if on_device else runtime).append((name, start, end))
    skew = None
    if sync is not None:
        before = [r for r in runtime if r[0] == SYNC and r[1] < w0]
        if before:
            last = max(before, key=lambda r: r[2])
            skew = ((last[1] + last[2]) - (sync[0] + sync[1])) / 2e3
    runtime = [r for r in runtime if r[2] > w0 and r[1] < w1]
    merged = union([(max(s, w0), min(e, w1)) for _, s, e in kernels])
    busy_ns = sum(e - s for s, e in merged)
    waits = [(s, e) for n, s, e in runtime if n in WAITS]
    by_name: dict[str, float] = defaultdict(float)
    for name, s, e in kernels:
        by_name[name] += min(e, w1) - max(s, w0)
    edges = [w0] + [x for span in merged for x in span] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    spans: dict[str, list] = defaultdict(list)
    for name, s, e in marks.spans:
        spans[name].append((s, e))
    return {
        "kernels": kernels,
        "spans": dict(spans),
        "busy_s": busy_ns / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "host_wait_s": covered(waits, w0, w1) / 1e9 if runtime else None,
        "clock_skew_us": skew,
        "device_ops": [[n, ns / 1e9] for n, ns in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": label_gaps(gaps, runtime, marks.spans),
    }


def label_gaps(gaps: list[tuple[float, float]], runtime: list[tuple[str, float, float]],
               phases: list[tuple[str, int, int]]) -> list:
    """The device's idle time in the longest ``LABELLED`` gaps, summed by what
    the host was doing at each gap's midpoint: the runtime call it was in,
    else ``host: <phase>`` of the innermost mark around it, else ``host:
    between phases``; the ten largest sums, in seconds."""
    if not gaps:
        return []
    tables = []
    for rows in (runtime, [(f"host: {n}", s, e) for n, s, e in phases]):
        tables.append(([r[0] for r in rows], np.asarray([r[1] for r in rows], dtype=np.int64),
                       np.asarray([r[2] for r in rows], dtype=np.int64)))
    sums: dict[str, float] = defaultdict(float)
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:LABELLED]:
        mid = (s + e) // 2
        label = "host: between phases"
        for names, starts, ends in tables:
            idx = np.flatnonzero((starts <= mid) & (ends >= mid)) if len(names) else np.zeros(0, int)
            if idx.size:
                label = names[idx[np.argmin(ends[idx] - starts[idx])]]
                break
        sums[label] += (e - s) / 1e9
    return [[n, v] for n, v in sorted(sums.items(), key=lambda kv: -kv[1])[:TOP]]


def count(kernels: list, fragment: str) -> int:
    return sum(1 for name, _, _ in kernels if fragment in name)


def seconds(kernels: list, fragments: tuple[str, ...]) -> float:
    return sum(e - s for name, s, e in kernels if any(f in name for f in fragments)) / 1e9


def within(kernels: list, spans: list[tuple[float, float]]) -> list:
    """The kernels that start inside one of ``spans``."""
    return [k for k in kernels if any(s <= k[1] <= e for s, e in spans)]
