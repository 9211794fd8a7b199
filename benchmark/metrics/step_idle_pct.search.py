"""Share of the traced window in which the card was idle while the host was
inside a ``search_step`` span (``poison/flowmur.py::optimize_trigger``;
``audiobd_tpu_torch/utils/profiling.py``): each span's host interval less
the part of it the device's operations cover (the union of the trace's
operations, on the clock the spans share with the profiler), summed over the
spans inside the window's ``search`` marks, over the window's wall. None
where the spans are missing or carry no events, or their steps disagree with
the count."""

import numpy as np


def read(r):
    from audiobd_tpu_torch.utils import profiling

    if not hasattr(profiling, "recorded") or not r.search_steps:
        return None
    spans = profiling.recorded(r.trace["spans"].get("search", []))
    steps = [s for s in spans if s.name == "search_step"]
    if len(steps) != r.search_steps or any(s.device_ms is None for s in steps):
        return None
    busy = np.asarray(r.trace_mod.union([(s, e) for _, s, e in r.trace["kernels"]]), dtype=np.int64).reshape(-1, 2)
    idle_ns = 0
    for s in steps:
        covered = np.clip(np.minimum(busy[:, 1], s.t1) - np.maximum(busy[:, 0], s.t0), 0, None).sum()
        idle_ns += s.t1 - s.t0 - int(covered)
    return 100.0 * idle_ns / 1e9 / r.trace["window_s"]
