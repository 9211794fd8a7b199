"""Carry SmallCNN weights between the flax variable tree and the port.

The flax tree (audiobd_tpu.models.SmallCNN) holds plain numpy arrays here:
  params/TorchConv_{0,1,2}/Conv_0/{kernel (kh, kw, in, out), bias}
  params/TorchBatchNorm_{0,1,2}/BatchNorm_0/{scale, bias}
  batch_stats/TorchBatchNorm_{0,1,2}/BatchNorm_0/{mean, var}
  params/fc{1,2}/Dense_0/{kernel (in, out), bias}
Conv kernels go HWIO → OIHW and Dense kernels (in, out) → (out, in). The
flatten order already matches (the reference flattens NCHW-style).
"""

from __future__ import annotations

import numpy as np
import torch

_CONVS = ("conv1", "conv2", "conv3")
_BNS = ("bn1", "bn2", "bn3")
_FCS = ("fc1", "fc2")


def smallcnn_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """flax SmallCNN variables (numpy leaves) → the port's state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    out: dict[str, torch.Tensor] = {}

    def put(key, arr):
        out[key] = torch.from_numpy(np.array(arr, np.float32))

    for i, name in enumerate(_CONVS):
        conv = params[f"TorchConv_{i}"]["Conv_0"]
        put(f"{name}.weight", np.transpose(conv["kernel"], (3, 2, 0, 1)))
        put(f"{name}.bias", conv["bias"])
    for i, name in enumerate(_BNS):
        bn = params[f"TorchBatchNorm_{i}"]["BatchNorm_0"]
        st = stats[f"TorchBatchNorm_{i}"]["BatchNorm_0"]
        put(f"{name}.weight", bn["scale"])
        put(f"{name}.bias", bn["bias"])
        put(f"{name}.running_mean", st["mean"])
        put(f"{name}.running_var", st["var"])
    for name in _FCS:
        dense = params[name]["Dense_0"]
        put(f"{name}.weight", np.transpose(dense["kernel"]))
        put(f"{name}.bias", dense["bias"])
    return out

