"""Carry model weights between the flax variable tree and the port.

The flax trees (audiobd_tpu.models) hold plain numpy arrays here:
  params/<conv>/Conv_0/{kernel (kh, kw, in, out), bias}
  params/<bn>/BatchNorm_0/{scale, bias}, batch_stats/<bn>/BatchNorm_0/{mean, var}
  params/<dense>/Dense_0/{kernel (in, out), bias}
  params/<lstm>/l{layer}_{fwd,bwd}/{w_ih (in, 4H), w_hh (H, 4H), b_ih, b_hh}
with flax's auto-names TorchConv_i and TorchBatchNorm_i in creation order.
Conv kernels go HWIO → OIHW, Dense and LSTM kernels (in, out) → (out, in);
the LSTM's gate order (i, f, g, o) is torch's already, and a ``bwd``
direction is torch's ``_reverse``. The flatten order already matches (the
reference flattens NCHW-style). ``opt_state_from_flax`` carries optax's
optimizer state (adam's moments, sgd's trace) by the same maps.
"""

from __future__ import annotations

import re

import numpy as np
import torch


class _Carry:
    """Collects a port state_dict from one flax variable tree."""

    def __init__(self, variables: dict):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats", {})
        self.out: dict[str, torch.Tensor] = {}

    def put(self, key: str, arr) -> None:
        self.out[key] = torch.from_numpy(np.array(arr, np.float32))

    def conv(self, port: str, path: tuple[str, ...]) -> None:
        conv = _at(self.params, path)["Conv_0"]
        self.put(f"{port}.weight", np.transpose(conv["kernel"], (3, 2, 0, 1)))
        if "bias" in conv:
            self.put(f"{port}.bias", conv["bias"])

    def bn(self, port: str, path: tuple[str, ...]) -> None:
        bn, st = _at(self.params, path)["BatchNorm_0"], _at(self.stats, path)["BatchNorm_0"]
        self.put(f"{port}.weight", bn["scale"])
        self.put(f"{port}.bias", bn["bias"])
        self.put(f"{port}.running_mean", st["mean"])
        self.put(f"{port}.running_var", st["var"])

    def dense(self, port: str, name: str) -> None:
        dense = self.params[name]["Dense_0"]
        self.put(f"{port}.weight", np.transpose(dense["kernel"]))
        self.put(f"{port}.bias", dense["bias"])

    def lstm(self, port: str, name: str) -> None:
        for key, cell in self.params[name].items():  # l{layer}_fwd / l{layer}_bwd
            layer, direction = key[1:].split("_")
            suffix = f"l{layer}" + ("_reverse" if direction == "bwd" else "")
            for w in ("ih", "hh"):
                self.put(f"{port}.weight_{w}_{suffix}", np.transpose(cell[f"w_{w}"]))
                self.put(f"{port}.bias_{w}_{suffix}", cell[f"b_{w}"])


def _at(tree: dict, path: tuple[str, ...]) -> dict:
    for key in path:
        tree = tree[key]
    return tree


def _conv_stack(c: _Carry) -> None:
    for i in range(3):
        c.conv(f"conv{i + 1}", (f"TorchConv_{i}",))
        c.bn(f"bn{i + 1}", (f"TorchBatchNorm_{i}",))


def smallcnn_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """flax SmallCNN variables (numpy leaves) → the port's state_dict."""
    c = _Carry(variables)
    _conv_stack(c)
    c.dense("fc1", "fc1")
    c.dense("fc2", "fc2")
    return c.out


def smalllstm_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """flax SmallLSTM variables (numpy leaves) → the port's state_dict."""
    c = _Carry(variables)
    _conv_stack(c)
    c.lstm("lstm", "LSTM_0")
    c.dense("fc2", "fc2")
    return c.out


def largecnn_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """flax LargeCNN variables → the port's state_dict (convs.0-4, fc1-3)."""
    c = _Carry(variables)
    for i in range(5):
        c.conv(f"convs.{i}", (f"TorchConv_{i}",))
    for name in ("fc1", "fc2", "fc3"):
        c.dense(name, name)
    return c.out


def lstmwithattention_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """flax LSTMWithAttention variables → the port's state_dict."""
    c = _Carry(variables)
    for i in range(2):
        c.conv(f"conv{i + 1}", (f"TorchConv_{i}",))
        c.bn(f"bn{i + 1}", (f"TorchBatchNorm_{i}",))
    c.lstm("rnn1", "rnn1")
    c.lstm("rnn2", "rnn2")
    for name in ("dense1", "attention", "dense2", "dense3", "output"):
        c.dense(name, name)
    return c.out


def rnn_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """flax RNN variables → the port's state_dict."""
    c = _Carry(variables)
    c.lstm("lstm", "LSTM_0")
    c.dense("fc", "fc")
    return c.out


def resnet_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """flax ResNet variables → the port's state_dict: the stem, stages.{s}.{b}
    from layer{s+1}_{b} (conv1/bn1, conv2/bn2, down_conv/down_bn from
    TorchConv_{0,1,2}/TorchBatchNorm_{0,1,2}), conv2d and fc."""
    c = _Carry(variables)
    c.conv("conv1", ("TorchConv_0",))
    c.bn("bn1", ("TorchBatchNorm_0",))
    for name in sorted(k for k in c.params if k.startswith("layer")):
        stage, block = name[len("layer"):].split("_")
        port = f"stages.{int(stage) - 1}.{block}"
        for i, (conv, bn) in enumerate((("conv1", "bn1"), ("conv2", "bn2"), ("down_conv", "down_bn"))):
            if f"TorchConv_{i}" in c.params[name]:
                c.conv(f"{port}.{conv}", (name, f"TorchConv_{i}"))
                c.bn(f"{port}.{bn}", (name, f"TorchBatchNorm_{i}"))
    c.conv("conv2d", ("conv2d",))
    c.dense("fc", "fc")
    return c.out


FROM_FLAX = {
    "smallcnn": smallcnn_from_flax,
    "smalllstm": smalllstm_from_flax,
    "largecnn": largecnn_from_flax,
    "lstmwithattention": lstmwithattention_from_flax,
    "rnn": rnn_from_flax,
    "resnet": resnet_from_flax,
}

_CONV_PATHS = (
    (re.compile(r"conv(\d+)\.weight"), lambda m: f"TorchConv_{int(m[1]) - 1}"),
    (re.compile(r"convs\.(\d+)\.weight"), lambda m: f"TorchConv_{m[1]}"),
    (re.compile(r"stages\.(\d+)\.(\d+)\.(conv1|conv2|down_conv)\.weight"),
     lambda m: f"layer{int(m[1]) + 1}_{m[2]}/TorchConv_{('conv1', 'conv2', 'down_conv').index(m[3])}"),
    (re.compile(r"(\w+)\.weight"), lambda m: m[1]),
)


def flax_kernel_path(key: str, ndim: int) -> str:
    """The flax path of the kernel that the maps above carry to the port's
    state_dict ``key``: a conv weight (``ndim`` 4) or an ``nn.Linear`` weight
    (``ndim`` 2), e.g. ``conv3.weight`` → ``TorchConv_2/Conv_0/kernel``,
    ``stages.2.1.conv2.weight`` → ``layer3_1/TorchConv_1/Conv_0/kernel``,
    ``fc.weight`` → ``fc/Dense_0/kernel``."""
    if ndim == 2:
        name = re.fullmatch(r"(\w+)\.weight", key)
        if name is None:
            raise ValueError(f"{key!r} is not a dense kernel of the port's models")
        return f"{name[1]}/Dense_0/kernel"
    for pattern, path in _CONV_PATHS:
        m = pattern.fullmatch(key)
        if m is not None:
            return f"{path(m)}/Conv_0/kernel"
    raise ValueError(f"{key!r} is not a conv kernel of the port's models")


def _stats_like(params: dict) -> dict:
    """A batch_stats tree beside ``params``'s BatchNorms, for the maps above,
    which read one; its entries land in buffers that the caller drops."""
    out = {}
    for key, value in params.items():
        if key == "BatchNorm_0":
            out[key] = {"mean": value["scale"], "var": value["scale"]}
        elif isinstance(value, dict):
            out[key] = _stats_like(value)
    return out


def opt_state_from_flax(model_name: str, opt_state, param_names: list[str]) -> dict:
    """optax's state of ``optax.adam`` (its first entry ``count``, and
    ``mu``/``nu`` as flax parameter trees) or ``optax.sgd(lr, momentum)``
    (its first entry ``trace``) → the
    ``load_state_dict`` argument of train/state.py's ``Adam`` or ``SGD`` for
    the port's ``model_name`` model whose parameters are named
    ``param_names`` (``[n for n, _ in model.named_parameters()]``): each tree
    carried by ``FROM_FLAX``, so the conv and dense transposes are the
    weights' own, and listed in that order."""
    carry = FROM_FLAX[model_name.lower()]

    def ordered(tree: dict) -> list[torch.Tensor]:
        state_dict = carry({"params": tree, "batch_stats": _stats_like(tree)})
        return [state_dict[n] for n in param_names]

    first = opt_state[0]  # the chain's first transform: scale_by_adam, or trace
    if hasattr(first, "mu"):
        return {"mu": ordered(first.mu), "nu": ordered(first.nu), "count": int(np.asarray(first.count))}
    if hasattr(first, "trace"):
        return {"trace": ordered(first.trace)}
    raise ValueError(f"opt_state holds neither optax's adam state nor its sgd trace: {type(first).__name__}")
