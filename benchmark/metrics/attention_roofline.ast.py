"""The training forward's attention at its share of its roofline: the
``attention`` spans under ``train_step/forward`` inside the traced window's
``train`` marks (``audiobd_tpu_torch/utils/profiling.py``), their count ×
the least time a call can take at the training batch
(``roofline/ast_attention.py``: 4·B·H·T²·d_h operations at 67 TFLOP/s, which
bound it over q, k, v and o's bytes) over the stream time between each
span's timing events. None where the spans are missing or carry no events."""


def read(r):
    from audiobd_tpu_torch.utils import profiling

    attention = r.counts.get("attention")
    if attention is None or not hasattr(profiling, "recorded"):
        return None
    spans = profiling.recorded(r.trace["spans"].get("train", []))
    mine = [s for s in spans if s.name == attention["span"] and s.path.endswith("train_step/forward/attention")]
    if not mine or any(s.device_ms is None for s in mine):
        return None
    seconds = sum(s.device_ms for s in mine) / 1e3
    return 100.0 * len(mine) * attention["bound_s"] / seconds if seconds > 0 else None
