"""The operations the traced window's search steps need
(``roofline/<config>.py``: the deployment, the MFCC front end at a real FFT's
count, forward and back to the waveform, the frozen SmallCNN forward and back
to its input, Adam) over the traced window's seconds × 67 TFLOP/s (one
H100's f32 peak outside the tensor cores)."""


def read(r):
    if not r.search_steps or not r.flops:
        return None
    return 100.0 * r.flops / (r.trace["window_s"] * r.peak_flops * r.cards)
