"""The wall time and kernel launches of each stage of a CLI run."""

from __future__ import annotations

import contextlib
import time

import torch

from audiobd_tpu_torch.ops import launches


class Stages:
    """``with stages("prep"): ...`` records the stage's wall (the device
    synchronized at its end) and the launches each kernel made in it, prints
    them, and keeps them in ``records``: name → {"wall_s", "launches"}."""

    def __init__(self, device: torch.device):
        self.device = device
        self.records: dict[str, dict] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        before = launches()
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        made = {k: n - before[k] for k, n in launches().items() if n > before[k]}
        self.records[name] = {"wall_s": wall, "launches": made}
        print(f"stage {name}: wall {wall:.3f} s, kernel launches {made}")
