"""Counts of ``flowmur_smallcnn``'s trigger-search step, a clip at a time:
the trigger's deployment (6 operations a sample: the norms' squares and
sums, the scale, the add, the divide, the clip; as many again backward), the
MFCC front end (n_fft 2048, hop 512, 128 mels, 13 coefficients) forward and
back to the waveform at a real FFT's count, the frozen 224-feature SmallCNN
forward and back to its input; and Adam's step on the trigger (12 a
sample). Kernel C once a step."""

from __future__ import annotations

from benchmark.reference.mfcc import mel_filterbank
from benchmark.roofline import conv1_bn_pool_bwd_input as kernel_c
from benchmark.roofline import smallcnn
from benchmark.roofline.mfcc import frame_flops, mel_nonzeros, num_frames

DEPLOY_FLOPS_PER_SAMPLE = 2 * 6.0
ADAM_FLOPS_PER_SAMPLE = 12.0


def counts_for(cfg: dict, traffic: dict) -> dict:
    dsp = cfg["dsp"]
    rate = dsp["sample_rate"]
    frames = num_frames(rate, dsp["n_fft"], dsp["hop_length"])
    nnz = mel_nonzeros(mel_filterbank(rate, dsp["n_fft"], dsp["n_mels"]))
    front = 2.0 * frames * frame_flops(dsp["n_fft"], dsp["n_mels"], dsp["n_mfcc"], nnz)
    cnn = smallcnn.clip_flops(frames, dsp["n_mfcc"], cfg["num_classes"], train=False, input_grad=True)
    batch = cfg["batch_size"]
    clip = DEPLOY_FLOPS_PER_SAMPLE * rate + front + cnn["forward"] + cnn["backward"]
    return {
        "search_step_flops": batch * clip + ADAM_FLOPS_PER_SAMPLE * cfg["trigger_duration"] * rate,
        "kernels": {"conv1_bn_pool_bwd_input": {
            "calls": kernel_c.CALLS, "time": kernel_c.TIME,
            "bound_s": kernel_c.call_bound_s(batch, frames, dsp["n_mfcc"])}},
    }
