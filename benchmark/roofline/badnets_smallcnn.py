"""Counts of ``badnets_smallcnn``: SmallCNN on (101, 40) MFCC frames, ten
classes; a training clip is its forward and the gradients a training step
produces, an eval clip its forward; kernel B once a training step."""

from __future__ import annotations

from benchmark.roofline import conv1_bn_pool_bwd_params as kernel_b
from benchmark.roofline import smallcnn
from benchmark.roofline.mfcc import num_frames


def counts_for(cfg: dict, traffic: dict) -> dict:
    dsp = cfg["dsp"]
    frames = num_frames(dsp["sample_rate"], dsp["n_fft"], dsp["hop_length"])
    n_mfcc, classes = dsp["n_mfcc"], cfg["num_classes"]
    train = smallcnn.clip_flops(frames, n_mfcc, classes, train=True, input_grad=False)
    evals = smallcnn.clip_flops(frames, n_mfcc, classes, train=False, input_grad=False)
    return {
        "train_clip_flops": train["forward"] + train["backward"],
        "eval_clip_flops": evals["forward"],
        "kernels": {"conv1_bn_pool_bwd_params": {
            "calls": kernel_b.CALLS, "time": kernel_b.TIME,
            "bound_s": kernel_b.call_bound_s(cfg["batch_size"] // traffic.get("ranks", 1), frames, n_mfcc)}},
    }
