"""Kernel C (``csrc/conv1_bn_pool.cu``: ``bwd_input``), block 1's input
gradient with frozen parameters (BatchNorm's running statistics): its least
time a call, ``chip_smoke.py``'s bound for FlowMur's shape. Bytes: x and g
read, dx written, 8 per-channel vectors. Operations: the recompute and the
winner (35 a pair), at most three adds an x element in the gather; they lie
under the bytes' time."""

from __future__ import annotations

from benchmark.roofline.peaks import bound_s
from benchmark.roofline.smallcnn import block1_shapes

CALLS = "bwd_input"
TIME = ("bwd_input",)


def call_bound_s(batch: int, frames: int, n_mfcc: int, channels: int = 64) -> float:
    x, g = block1_shapes(batch, frames, n_mfcc)
    return bound_s(35.0 * g + 3.0 * x, 4.0 * (2 * x + g + 8 * channels))[0]
