"""The operations the traced window's training epochs and eval passes need
(``roofline/<config>.py``: SmallCNN's forward and the gradients a training
step produces, a clip at a time, real rows only) over the traced window's
seconds × 67 TFLOP/s (one H100's f32 peak outside the tensor cores) × the
cards."""


def read(r):
    if not r.train_steps or not r.flops:
        return None
    return 100.0 * r.flops / (r.trace["window_s"] * r.peak_flops * r.cards)
