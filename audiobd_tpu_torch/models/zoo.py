"""SmallCNN (port of audiobd_tpu/models/zoo.py:36-88; reference
utils/models.py:17-65).

Input NCHW MFCC features (B, 1, frames, n_mfcc), raw logits out (the
reference's log_softmax is a no-op under cross-entropy).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from audiobd_tpu_torch.models.layers import BatchNorm2d, conv_bn_pool_block1, dropout, init_uniform_
from audiobd_tpu_torch.utils.random import torch_generator


class SmallCNN(nn.Module):
    """3 × (conv2x2 → relu → BN → maxpool) + dropout + 2 FC.

    ``fused_block1`` routes block 1 through ops/conv1_bn_pool (same
    parameters and forward, CUDA-kernel backward). ``dropout_generator``
    draws the dropout masks; ``dropout_rates`` may be zeroed to compare with
    a deterministic reference."""

    def __init__(self, num_classes: int, linear_features: int, fused_block1: bool = False,
                 dropout_rates: tuple[float, float] = (0.4, 0.5)):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 64, 2)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = nn.Conv2d(64, 64, 2)
        self.bn2 = BatchNorm2d(64)
        self.conv3 = nn.Conv2d(64, 32, 2)
        self.bn3 = BatchNorm2d(32)
        self.fc1 = nn.Linear(linear_features, 128)
        self.fc2 = nn.Linear(128, num_classes)
        self.linear_features = linear_features
        self.fused_block1 = fused_block1
        self.dropout_rates = dropout_rates
        self.dropout_generator: torch.Generator | None = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in (self.conv1, self.conv2, self.conv3, self.fc1, self.fc2):
            init_uniform_(layer, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.block1(x))

    def block1(self, x: torch.Tensor) -> torch.Tensor:
        return conv_bn_pool_block1(self.conv1, self.bn1, x, self.fused_block1)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Everything after block 1: blocks 2-3, dropout, the FC layers."""
        x = F.max_pool2d(self.bn2(F.relu(self.conv2(x))), (2, 2), padding=(1, 1))
        x = F.max_pool2d(self.bn3(F.relu(self.conv3(x))), (2, 2), padding=(0, 1))
        x = dropout(x, self.dropout_rates[0], self.training, self.dropout_generator)
        x = x.flatten(1)
        if x.shape[-1] != self.linear_features:
            raise ValueError(f"smallcnn flatten {x.shape[-1]} != configured {self.linear_features}")
        x = F.relu(self.fc1(x))
        x = dropout(x, self.dropout_rates[1], self.training, self.dropout_generator)
        return self.fc2(x)


def build_model(name: str, num_classes: int, feature_size: int, device: torch.device,
                seed: int, fused: bool = False) -> nn.Module:
    """The model with weights drawn from ``torch_generator(seed, "params")``
    and dropout from ``torch_generator(seed, "dropout", device)``. Only
    SmallCNN is ported so far."""
    if name.lower() != "smallcnn":
        raise NotImplementedError(f"model {name!r} is not ported yet (ROADMAP queue 1)")
    model = SmallCNN(num_classes=num_classes, linear_features=feature_size, fused_block1=fused)
    model.reset_parameters(torch_generator(seed, "params"))
    model.to(device)
    model.dropout_generator = torch_generator(seed, "dropout", device)
    return model
