"""SmallCNN and SmallLSTM (port of audiobd_tpu/models/zoo.py:36-88 and
122-165; reference utils/models.py:17-65 and 121-178).

Input NCHW MFCC features (B, 1, frames, n_mfcc), raw logits out (the
reference's log_softmax is a no-op under cross-entropy). ``compute_dtype``
(torch.float32 or torch.bfloat16, the reference's ``dtype``) is the dtype
of the activations and the logits; the parameters stay f32 (models/layers.py
says where the casts are).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from audiobd_tpu_torch.models.layers import (
    BatchNorm2d,
    conv_bn_pool_block1,
    conv_bn_pool_block2,
    dropout,
    init_uniform_,
    linear,
)
from audiobd_tpu_torch.utils.random import torch_generator


class ConvStack(nn.Module):
    """The three (conv2x2 → relu → BN → maxpool) blocks SmallCNN and
    SmallLSTM share.

    ``fused_block1`` routes block 1 through ops/conv1_bn_pool and
    ``fused_block2`` / ``fused_block3`` route blocks 2 and 3 through
    ops/conv2_bn_pool in training mode: the same parameters and forward, a
    CUDA-kernel backward. ``dropout_generator`` draws the dropout masks."""

    def __init__(self, fused_block1: bool = False, fused_block2: bool = False, fused_block3: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"the models compute in float32 or bfloat16, got {compute_dtype}")
        self.compute_dtype = compute_dtype
        self.conv1 = nn.Conv2d(1, 64, 2)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = nn.Conv2d(64, 64, 2)
        self.bn2 = BatchNorm2d(64)
        self.conv3 = nn.Conv2d(64, 32, 2)
        self.bn3 = BatchNorm2d(32)
        self.fused_block1 = fused_block1
        self.fused_block2 = fused_block2
        self.fused_block3 = fused_block3
        self.dropout_generator: torch.Generator | None = None

    def block1(self, x: torch.Tensor) -> torch.Tensor:
        return conv_bn_pool_block1(self.conv1, self.bn1, x, self.fused_block1, self.compute_dtype)

    def block2(self, x: torch.Tensor) -> torch.Tensor:
        return conv_bn_pool_block2(self.conv2, self.bn2, x, self.fused_block2, (1, 1), self.compute_dtype)

    def block3(self, x: torch.Tensor) -> torch.Tensor:
        return conv_bn_pool_block2(self.conv3, self.bn3, x, self.fused_block3, (0, 1), self.compute_dtype)


class SmallCNN(ConvStack):
    """The conv stack + dropout + 2 FC. ``dropout_rates`` may be zeroed to
    compare with a deterministic reference."""

    def __init__(self, num_classes: int, linear_features: int, fused_block1: bool = False,
                 fused_block2: bool = False, fused_block3: bool = False,
                 dropout_rates: tuple[float, float] = (0.4, 0.5), compute_dtype: torch.dtype = torch.float32):
        super().__init__(fused_block1, fused_block2, fused_block3, compute_dtype)
        self.fc1 = nn.Linear(linear_features, 128)
        self.fc2 = nn.Linear(128, num_classes)
        self.linear_features = linear_features
        self.dropout_rates = dropout_rates

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in (self.conv1, self.conv2, self.conv3, self.fc1, self.fc2):
            init_uniform_(layer, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.block1(x))

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Everything after block 1: blocks 2-3, dropout, the FC layers."""
        return self.classifier(self.block3(self.block2(x)))

    def classifier(self, x: torch.Tensor) -> torch.Tensor:
        """Everything after block 3: dropout and the FC layers."""
        x = dropout(x, self.dropout_rates[0], self.training, self.dropout_generator)
        x = x.flatten(1)
        if x.shape[-1] != self.linear_features:
            raise ValueError(f"smallcnn flatten {x.shape[-1]} != configured {self.linear_features}")
        x = F.relu(linear(self.fc1, x, self.compute_dtype))
        x = dropout(x, self.dropout_rates[1], self.training, self.dropout_generator)
        return linear(self.fc2, x, self.compute_dtype)


class SmallLSTM(ConvStack):
    """The conv stack → dropout → 2-layer LSTM(rnn_features → 128) → FC on
    the last step. ``rnn_features`` = W·C after the conv stack.

    ``nn.LSTM`` computes what the reference's scan LSTM does (gate order i,
    f, g, o, both biases; tests/test_models.py holds the two equal). In bf16
    it runs on bf16 copies of its f32 weights, the whole recurrence in bf16
    as the reference's (audiobd_tpu/models/layers.py:236-259); the gates'
    sums round in cuDNN's or ATen's order, not the reference's."""

    hidden = 128

    def __init__(self, num_classes: int, rnn_features: int, fused_block1: bool = False,
                 fused_block2: bool = False, fused_block3: bool = False, dropout_rate: float = 0.4,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(fused_block1, fused_block2, fused_block3, compute_dtype)
        self.lstm = nn.LSTM(rnn_features, self.hidden, num_layers=2, batch_first=True)
        self.fc2 = nn.Linear(self.hidden, num_classes)
        self.rnn_features = rnn_features
        self.dropout_rate = dropout_rate

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in (self.conv1, self.conv2, self.conv3):
            init_uniform_(layer, generator)
        bound = 1.0 / math.sqrt(self.hidden)  # all four tensors of each layer (reference layers.py:231-235)
        with torch.no_grad():
            for p in self.lstm.parameters():
                p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))
        init_uniform_(self.fc2, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.block3(self.block2(self.block1(x)))
        x = dropout(x, self.dropout_rate, self.training, self.dropout_generator)
        b, c, h, w = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, h, w * c)  # (B, H, W·C), the reference's NHWC order
        if x.shape[-1] != self.rnn_features:
            raise ValueError(f"smalllstm features {x.shape[-1]} != configured {self.rnn_features}")
        if self.compute_dtype == torch.float32:
            x, _ = self.lstm(x)
        else:
            weights = {name: p.to(self.compute_dtype) for name, p in self.lstm.named_parameters()}
            x, _ = torch.func.functional_call(self.lstm, weights, (x,))
        return linear(self.fc2, x[:, -1], self.compute_dtype)


def build_model(name: str, num_classes: int, feature_size: int, device: torch.device, seed: int,
                fused: bool = False, fused_block2: bool = False, fused_block3: bool = False,
                init_stream: str = "params", dropout_stream: str = "dropout",
                compute_dtype: torch.dtype = torch.float32) -> nn.Module:
    """The model with weights drawn from ``torch_generator(seed,
    init_stream)`` and dropout from ``torch_generator(seed, dropout_stream,
    device)``. ``fused`` is block 1's flag. SmallCNN and SmallLSTM are ported
    so far."""
    classes = {"smallcnn": SmallCNN, "smalllstm": SmallLSTM}
    if name.lower() not in classes:
        raise NotImplementedError(f"model {name!r} is not ported yet (ROADMAP queue 1)")
    model = classes[name.lower()](num_classes, feature_size, fused_block1=fused,
                                  fused_block2=fused_block2, fused_block3=fused_block3,
                                  compute_dtype=compute_dtype)
    model.reset_parameters(torch_generator(seed, init_stream))
    model.to(device)
    model.dropout_generator = torch_generator(seed, dropout_stream, device)
    return model
