"""The card's milliseconds a search step spends in its backward, from the
loss to the trigger (the surrogate's, kernel C, the MFCC's and the STFT's
transposes, the deployment's): the stream time between the timing events of
each ``search_step/backward`` span (``poison/flowmur.py::trigger_step``),
idle included, summed over the spans inside the traced window's ``search``
marks (``audiobd_tpu_torch/utils/profiling.py``), over the window's search
steps. None where the spans are missing or carry no events, or their steps
disagree with the count."""


def read(r):
    from audiobd_tpu_torch.utils import profiling

    if not hasattr(profiling, "recorded") or not r.search_steps:
        return None
    spans = profiling.recorded(r.trace["spans"].get("search", []))
    steps = [s for s in spans if s.name == "search_step"]
    if len(steps) != r.search_steps or any(s.device_ms is None for s in steps):
        return None
    return sum(s.device_ms for s in spans if s.name == "backward" and s.parent.name == "search_step") / r.search_steps
