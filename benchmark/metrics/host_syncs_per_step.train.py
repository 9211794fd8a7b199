"""The points at which the host waits for the card (``host_syncs`` of
``audiobd_tpu_torch/utils/profiling.py``: device→host reads, host→device
copies from pageable memory), counted by the ``train_epoch`` spans inside the
traced window's ``train`` marks, over the window's training steps: the
plan's two uploads and the summary's two reads an epoch. None where the
spans are missing or carry no events, or their steps disagree with the
count."""


def read(r):
    from audiobd_tpu_torch.utils import profiling

    if not hasattr(profiling, "recorded") or not r.train_steps:
        return None
    spans = profiling.recorded(r.trace["spans"].get("train", []))
    steps = [s for s in spans if s.name == "train_step"]
    if len(steps) != r.train_steps or any(s.device_ms is None for s in steps):
        return None
    return sum(s.host_syncs for s in spans if s.name == "train_epoch") / r.train_steps
