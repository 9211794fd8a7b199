"""Tracing of the port: spans and counters on the profiler's clock
(port of audiobd_tpu/utils/profiling.py's ``trace``).

* ``count(name, n=1)``: the port's counters, one registry of named
  integers, each made at zero on its first count; ``counts()`` is a
  snapshot of them all. A counter's site is its only mention:
  ``host_syncs`` here, ``sliced_convs`` and ``attention_calls`` in
  models/layers.py, each kernel's launches (``KERNEL`` + its name) in
  ops/build.py's ``CudaKernel``.
* ``span(name)``: a named interval of the program. While a ``torch.profiler``
  session is active, each span records its name, its parent (the enclosing
  span on this thread), its host start and end by ``time.time_ns()`` (the
  clock the profiler stamps its events with), the change in every counter
  between entry and exit (``counts``; the kernels' share as ``kernels``, each
  kernel's that launched, and ``launches``, their sum), and, once CUDA is
  initialised, a timing event on the current stream at entry and at exit:
  ``Span.device_ms`` is the stream's time between them, idle included. A
  backward runs on autograd's device thread while the calling thread waits
  inside its span, on the same stream, so the two events bracket its
  kernels. While no session is active a span is one shared no-op and
  records nothing. Spans stay in memory, the newest
  ``MAX_SPANS``, for ``recorded`` to read after the session.
* ``host_syncs``: the points where the program makes the host wait for the
  card, counted by ``to_host`` (a device→host read) and ``to_device`` (a
  host→device copy from pageable memory, which waits for the stream before
  it copies). They count on every device, so a CPU run shows the card's
  count.
* ``trace(logdir, device)``: a ``torch.profiler`` session that writes its
  Chrome/TensorBoard trace (``rank<r>.<ns>.pt.trace.json``, host activity
  always, the card's kernels too when ``device`` is CUDA) and the session's
  spans beside it (``rank<r>.<ns>.spans.json``, Chrome trace events on the
  trace's time base, ``baseTimeNanoseconds``; each event's ``args`` hold
  every counter but the kernels' by name, then ``launches`` and
  ``kernels``), on every rank.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import threading
import time
from collections import Counter, deque

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

MAX_SPANS = 1 << 16
KERNEL = "kernel:"  # the prefix of a kernel's launch counter
_SPANS: deque = deque(maxlen=MAX_SPANS)
_LOCAL = threading.local()
_OFF = contextlib.nullcontext()
_COUNTS: dict[str, int] = {}


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (made at zero on its first count;
    ``n`` 0 makes it, so every span records it from then on)."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counts() -> dict[str, int]:
    """Every counter's value now."""
    return dict(_COUNTS)


count("host_syncs", 0)


class Span:
    """One span, entered as a context manager: host times in ns, the
    counters' changes (``counts``, those that moved; a counter that did not
    reads 0), and the timing events on the stream (None off CUDA). ``span``
    makes them; ``recorded`` returns them once they have exited."""

    __slots__ = ("name", "parent", "t0", "t1", "counts", "start_event", "end_event")

    def __init__(self, name: str, parent: Span | None):
        self.name, self.parent = name, parent
        self.t0 = self.t1 = 0
        self.counts: Counter = Counter()
        self.start_event = self.end_event = None

    @property
    def path(self) -> str:
        """The names from the root span down to this one, joined by ``/``."""
        return self.name if self.parent is None else f"{self.parent.path}/{self.name}"

    @property
    def device_ms(self) -> float | None:
        """The stream's milliseconds between entry and exit; read once the
        stream has passed the exit (after a synchronisation)."""
        return None if self.start_event is None else self.start_event.elapsed_time(self.end_event)

    @property
    def host_syncs(self) -> int:
        return self.counts["host_syncs"]

    @host_syncs.setter
    def host_syncs(self, n: int) -> None:
        self.counts["host_syncs"] = n

    @property
    def kernels(self) -> dict[str, int]:
        """Each kernel's launches in the span, of the kernels that launched."""
        return {name[len(KERNEL):]: n for name, n in self.counts.items() if name.startswith(KERNEL)}

    @property
    def launches(self) -> int:
        return sum(self.kernels.values())

    def __enter__(self) -> Span:
        self.counts = Counter(_COUNTS)  # at entry
        self.t0 = time.time_ns()
        if torch.cuda.is_initialized():
            self.start_event = torch.cuda.Event(enable_timing=True)
            self.end_event = torch.cuda.Event(enable_timing=True)
            self.start_event.record()
        _stack().append(self)
        return self

    def __exit__(self, *exc) -> None:
        _stack().pop()
        if self.end_event is not None:
            self.end_event.record()
        self.t1 = time.time_ns()
        entry = self.counts
        self.counts = Counter({name: n - entry[name] for name, n in _COUNTS.items() if n != entry[name]})
        _SPANS.append(self)


def _stack() -> list:
    if not hasattr(_LOCAL, "stack"):
        _LOCAL.stack = []
    return _LOCAL.stack


def span(name: str):
    """A context manager that records the span ``name`` while a profiler
    session is active, and nothing otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    stack = _stack()
    return Span(name, stack[-1] if stack else None)


def recorded(within: list[tuple[int, int]] | None = None) -> list[Span]:
    """The recorded spans in the order they ended; with ``within``, only
    those whose host interval lies inside one of those (start, end) ns."""
    spans = list(_SPANS)
    if within is None:
        return spans
    return [s for s in spans if any(a <= s.t0 and s.t1 <= b for a, b in within)]


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a NumPy array: a device→host read, one host sync."""
    count("host_syncs")
    return t.cpu().numpy()


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """``array`` copied to ``device`` from pageable host memory, one host
    sync."""
    count("host_syncs")
    return torch.from_numpy(array).to(device)


def _write_spans(path: str, spans: list[Span], base_ns: int) -> None:
    """``spans`` as Chrome trace events (µs since ``base_ns``); each
    event's ``args`` hold its index, its parent's index, its path, its
    counters' changes and its device milliseconds."""
    index = {id(s): i for i, s in enumerate(spans)}
    names = [name for name in _COUNTS if not name.startswith(KERNEL)]
    events = [{"ph": "X", "cat": "span", "name": s.name, "pid": "spans", "tid": 0, "ts": (s.t0 - base_ns) / 1e3,
               "dur": (s.t1 - s.t0) / 1e3,
               "args": {"index": i, "parent": index.get(id(s.parent)), "path": s.path,
                        **{name: s.counts[name] for name in names}, "launches": s.launches, "kernels": s.kernels,
                        "device_ms": s.device_ms}}
              for i, s in enumerate(spans)]
    with open(path, "w") as f:
        json.dump({"baseTimeNanoseconds": base_ns, "displayTimeUnit": "ms", "traceEvents": events}, f)


def _trace_base_ns(path: str) -> int:
    """The Chrome trace's ``baseTimeNanoseconds`` (a header field; 0 where
    the trace's timestamps are absolute)."""
    with open(path) as f:
        found = re.search(r'"baseTimeNanoseconds"\s*:\s*(\d+)', f.read(1 << 16))
    return int(found.group(1)) if found else 0


@contextlib.contextmanager
def trace(logdir: str | None, device: torch.device | None = None):
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    from audiobd_tpu_torch.parallel.distributed import rank

    activities = [ProfilerActivity.CPU]
    if device is not None and device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    t_start = time.time_ns()
    with profile(activities=activities) as prof:
        yield
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)  # the spans' end events
    os.makedirs(logdir, exist_ok=True)
    stem = os.path.join(logdir, f"rank{rank()}.{time.time_ns()}")
    prof.export_chrome_trace(stem + ".pt.trace.json")
    _write_spans(stem + ".spans.json", [s for s in recorded() if s.t0 >= t_start],
                 _trace_base_ns(stem + ".pt.trace.json"))
