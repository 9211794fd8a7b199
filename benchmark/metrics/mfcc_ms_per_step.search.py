"""The card's milliseconds a search step spends in the MFCC front end's
forward (``dsp/mfcc.py::mfcc_features``: the plain matmul STFT, mel, dB,
DCT): the stream time between the timing events of each
``search_step/mfcc`` span (``poison/flowmur.py::trigger_loss``), idle
included, summed over the spans inside the traced window's ``search`` marks
(``audiobd_tpu_torch/utils/profiling.py``), over the window's search steps.
None where the spans are missing or carry no events, or their steps
disagree with the count."""


def read(r):
    from audiobd_tpu_torch.utils import profiling

    if not hasattr(profiling, "recorded") or not r.search_steps:
        return None
    spans = profiling.recorded(r.trace["spans"].get("search", []))
    steps = [s for s in spans if s.name == "search_step"]
    if len(steps) != r.search_steps or any(s.device_ms is None for s in steps):
        return None
    return sum(s.device_ms for s in spans if s.name == "mfcc" and s.parent.name == "search_step") / r.search_steps
