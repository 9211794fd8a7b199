"""Tracing and timing hooks (port of audiobd_tpu/utils/profiling.py).

* ``trace(logdir, device)``: a ``torch.profiler`` context that writes one
  Chrome/TensorBoard trace file (``*.pt.trace.json``) into ``logdir``;
  host activity always, the card's kernels too when ``device`` is CUDA.
* ``annotate(name)``: a named span (``record_function``) in such a trace,
  as the trainer marks each epoch ``epoch_{n}``.
* ``StepTimer``: steady-state step timing with clips/s and a one-line
  summary.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch


@contextlib.contextmanager
def trace(logdir: str | None, device: torch.device | None = None):
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device is not None and device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def annotate(name: str):
    return torch.profiler.record_function(name)


@dataclass
class StepTimer:
    clips_per_step: int = 0
    warmup: int = 3
    _times: list = field(default_factory=list)
    _steps: int = 0
    _t0: float = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        self._steps += 1
        if self._steps > self.warmup:
            self._times.append(time.perf_counter() - self._t0)

    @property
    def mean_step_seconds(self) -> float:
        return sum(self._times) / max(len(self._times), 1)

    @property
    def clips_per_sec(self) -> float:
        dt = self.mean_step_seconds
        return self.clips_per_step / dt if dt else 0.0

    def summary(self) -> str:
        return (
            f"{self.mean_step_seconds * 1e3:.3f} ms/step over {len(self._times)} steps"
            + (f", {self.clips_per_sec:.0f} clips/s" if self.clips_per_step else "")
        )
