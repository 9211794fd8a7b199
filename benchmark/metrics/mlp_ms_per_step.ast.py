"""The card's milliseconds a training step spends in AST's MLPs (fc1 → GELU
→ fc2, ``models/layers.py::Mlp``): the stream time between the timing events
of each ``mlp`` span under ``train_step/forward``, summed over the spans
inside the traced window's ``train`` marks
(``audiobd_tpu_torch/utils/profiling.py``), over the window's training
steps. None where the spans are missing or carry no events, or their steps
disagree with the count."""


def read(r):
    from audiobd_tpu_torch.utils import profiling

    if not hasattr(profiling, "recorded") or not r.train_steps:
        return None
    spans = profiling.recorded(r.trace["spans"].get("train", []))
    steps = [s for s in spans if s.name == "train_step"]
    mine = [s for s in spans if s.name == "mlp" and s.path.endswith("train_step/forward/mlp")]
    if len(steps) != r.train_steps or not mine or any(s.device_ms is None for s in steps + mine):
        return None
    return sum(s.device_ms for s in mine) / r.train_steps
