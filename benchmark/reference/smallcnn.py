"""SmallCNN (reference ``utils/models.py``) as plain functions of a parameter
dict: three blocks of conv 2x2 → relu → BatchNorm → max-pool, dropout 0.4,
dense → relu, dropout 0.5, dense. BatchNorm takes flax's statistics: the
biased variance E[x²] − E[x]² clamped at 0, running averages at momentum 0.9
of the batch mean and that variance, eps 1e-5. Pools: (1, 3) in block 1,
(2, 2) padded (1, 1) in block 2 and (0, 1) in block 3, floor mode."""

from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-5
MOMENTUM = 0.9
BLOCKS = (("conv1", "bn1", 1, 64, (1, 3), (0, 0)),
          ("conv2", "bn2", 64, 64, (2, 2), (1, 1)),
          ("conv3", "bn3", 64, 32, (2, 2), (0, 1)))
DROPOUT = (0.4, 0.5)


def spec(num_classes: int, linear_features: int) -> list[tuple[str, tuple[int, ...], str, int]]:
    """[(state-dict key, shape, kind, fan_in)] in the port's key names."""
    out = []
    for conv, bn, cin, cout, _, _ in BLOCKS:
        out += [(f"{conv}.weight", (cout, cin, 2, 2), "uniform", cin * 4),
                (f"{conv}.bias", (cout,), "uniform", cin * 4),
                (f"{bn}.weight", (cout,), "ones", 0), (f"{bn}.bias", (cout,), "zeros", 0),
                (f"{bn}.running_mean", (cout,), "zeros", 0), (f"{bn}.running_var", (cout,), "ones", 0)]
    out += [("fc1.weight", (128, linear_features), "uniform", linear_features),
            ("fc1.bias", (128,), "uniform", linear_features),
            ("fc2.weight", (num_classes, 128), "uniform", 128), ("fc2.bias", (num_classes,), "uniform", 128)]
    return out


def param_keys(state: dict) -> list[str]:
    """The trainable leaves in the port's parameter order (its optimizer's)."""
    keys = []
    for conv, bn, *_ in BLOCKS:
        keys += [f"{conv}.weight", f"{conv}.bias", f"{bn}.weight", f"{bn}.bias"]
    return keys + ["fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"]


def _c(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(1, -1, 1, 1)


def forward(p: dict, x: torch.Tensor, train: bool, dropout_gen: torch.Generator | None = None,
            stats: dict | None = None) -> torch.Tensor:
    """Logits of ``x`` (B, 1, frames, n_mfcc). In training mode BatchNorm
    normalises with the batch's statistics, which go into ``stats`` (key →
    (mean, var)), and dropout draws its masks from ``dropout_gen``; in eval
    mode it uses ``p``'s running statistics and no dropout."""
    for conv, bn, _, _, pool, pad in BLOCKS:
        r = torch.clamp(F.conv2d(x, p[f"{conv}.weight"], p[f"{conv}.bias"]), min=0.0)
        if train:
            mean = r.mean(dim=(0, 2, 3))
            var = torch.clamp((r * r).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            if stats is not None:
                stats[bn] = (mean.detach(), var.detach())
        else:
            mean, var = p[f"{bn}.running_mean"], p[f"{bn}.running_var"]
        z = (r - _c(mean)) * _c(torch.rsqrt(var + EPS) * p[f"{bn}.weight"]) + _c(p[f"{bn}.bias"])
        x = F.max_pool2d(z, pool, padding=pad)
    if train:
        x = _dropout(x, DROPOUT[0], dropout_gen)
    x = torch.relu(F.linear(x.flatten(1), p["fc1.weight"], p["fc1.bias"]))
    if train:
        x = _dropout(x, DROPOUT[1], dropout_gen)
    return F.linear(x, p["fc2.weight"], p["fc2.bias"])


def _dropout(x: torch.Tensor, rate: float, gen: torch.Generator) -> torch.Tensor:
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def update_running(p: dict, stats: dict) -> None:
    """Running averages after a training forward, in place."""
    for bn, (mean, var) in stats.items():
        p[f"{bn}.running_mean"] = MOMENTUM * p[f"{bn}.running_mean"] + (1.0 - MOMENTUM) * mean
        p[f"{bn}.running_var"] = MOMENTUM * p[f"{bn}.running_var"] + (1.0 - MOMENTUM) * var
