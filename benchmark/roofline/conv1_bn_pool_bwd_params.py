"""Kernel B (``csrc/conv1_bn_pool.cu``: ``bwd_params_partial`` then
``bwd_params_finish``), block 1's parameter gradients in training mode: its
least time a call, ``chip_smoke.py``'s block-1 bound. Bytes: x and g read
once, the 11 per-channel vectors. Operations: what every (pooled position,
channel) pair needs whatever the data (3 convolution outputs, relu,
normalise, the winner, S1, S2, x̂: 38), which lies under the bytes' time at
SmallCNN's shapes."""

from __future__ import annotations

from benchmark.roofline.peaks import bound_s
from benchmark.roofline.smallcnn import block1_shapes

CALLS = "bwd_params_partial"  # one launch of this kernel a call
TIME = ("bwd_params_partial", "bwd_params_finish")  # the call's device time


def call_bound_s(batch: int, frames: int, n_mfcc: int, channels: int = 64) -> float:
    x, g = block1_shapes(batch, frames, n_mfcc)
    return bound_s(38.0 * g, 4.0 * (x + g + 11 * channels))[0]
