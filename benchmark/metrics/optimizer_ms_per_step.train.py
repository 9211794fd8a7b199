"""The card's milliseconds a training step spends in its optimizer step
(``opt.step``, Adam in ``train/state.py``; the gradients' all-reduce too on
ranks): the stream time between the timing events of each
``train_step/optimizer`` span (``train/scan_epoch.py``), idle included,
summed over the spans inside the traced window's ``train`` marks
(``audiobd_tpu_torch/utils/profiling.py``), over the window's training
steps. None where the spans are missing or carry no events, or their steps
disagree with the count."""


def read(r):
    from audiobd_tpu_torch.utils import profiling

    if not hasattr(profiling, "recorded") or not r.train_steps:
        return None
    spans = profiling.recorded(r.trace["spans"].get("train", []))
    steps = [s for s in spans if s.name == "train_step"]
    if len(steps) != r.train_steps or any(s.device_ms is None for s in steps):
        return None
    return sum(s.device_ms for s in spans if s.name == "optimizer" and s.parent.name == "train_step") / r.train_steps
