"""Carry SmallCNN and SmallLSTM weights between the flax variable tree and the port.

The flax trees (audiobd_tpu.models.SmallCNN, SmallLSTM) hold plain numpy
arrays here:
  params/TorchConv_{0,1,2}/Conv_0/{kernel (kh, kw, in, out), bias}
  params/TorchBatchNorm_{0,1,2}/BatchNorm_0/{scale, bias}
  batch_stats/TorchBatchNorm_{0,1,2}/BatchNorm_0/{mean, var}
  params/fc{1,2}/Dense_0/{kernel (in, out), bias}   (SmallLSTM: fc2 only)
  params/LSTM_0/l{0,1}_fwd/{w_ih (in, 4H), w_hh (H, 4H), b_ih, b_hh}   (SmallLSTM)
Conv kernels go HWIO → OIHW, Dense and LSTM kernels (in, out) → (out, in);
the LSTM's gate order (i, f, g, o) is torch's already. The flatten order
already matches (the reference flattens NCHW-style).
"""

from __future__ import annotations

import numpy as np
import torch

_CONVS = ("conv1", "conv2", "conv3")
_BNS = ("bn1", "bn2", "bn3")


def _conv_stack_from_flax(variables: dict, fcs: tuple[str, ...]) -> dict[str, torch.Tensor]:
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
    for name in fcs:
        dense = params[name]["Dense_0"]
        put(f"{name}.weight", np.transpose(dense["kernel"]))
        put(f"{name}.bias", dense["bias"])
    return out


def smallcnn_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """flax SmallCNN variables (numpy leaves) → the port's state_dict."""
    return _conv_stack_from_flax(variables, ("fc1", "fc2"))


def smalllstm_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """flax SmallLSTM variables (numpy leaves) → the port's state_dict."""
    out = _conv_stack_from_flax(variables, ("fc2",))
    lstm = variables["params"]["LSTM_0"]
    for layer in (0, 1):
        cell = lstm[f"l{layer}_fwd"]
        for w in ("ih", "hh"):
            out[f"lstm.weight_{w}_l{layer}"] = torch.from_numpy(np.array(np.transpose(cell[f"w_{w}"]), np.float32))
            out[f"lstm.bias_{w}_l{layer}"] = torch.from_numpy(np.array(cell[f"b_{w}"], np.float32))
    return out
