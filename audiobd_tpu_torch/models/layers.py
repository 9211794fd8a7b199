"""Building blocks with the reference's semantics (port of
audiobd_tpu/models/layers.py).

torch already is the reference's framework for these: ``F.max_pool2d`` is
floor mode with implicit −inf padding (the reference's ``max_pool_torch``),
``F.avg_pool2d`` without padding is floor mode divided by window² (its
``avg_pool_torch``), NCHW flatten is (C, H, W) order, ``nn.Conv2d`` with
``padding=(2, 0)`` is flax's "SAME" for a (5, 1) kernel and ``bias=False``
its ``use_bias=False``, and ``nn.Conv2d`` / ``nn.Linear`` / ``nn.LSTM``
compute what flax's Conv, Dense and the reference's scan LSTM do (gate
order i, f, g, o, both biases; a reverse direction runs on the flipped
sequence). Two things differ and are written out here:
  * init draws from an explicit ``torch.Generator`` (U(±1/√fan_in) for
    weights and biases, torch's own defaults; U(±1/√hidden) for every LSTM
    tensor);
  * BatchNorm keeps flax's statistics: the fast variance E[x²] − E[x]²
    clamped at 0, and a running variance updated with that *biased* batch
    variance at momentum 0.9 (``nn.BatchNorm2d`` would use the unbiased one
    and drift from the reference at every step).
Dropout takes a generator too, since ``F.dropout`` cannot.

Sync-BN: a BatchNorm given a process ``group`` (its data axis) takes the
means of its batch mean and E[x²] over the group's ranks in training, as
flax's BatchNorm with ``axis_name`` pmeans them; the local batches are
equal in size, so the mean of means is the global batch's mean.

Tensor parallel: a conv, dense layer or LSTM that parallel/mesh.py::
shard_params_tp marked (``tp_shard``) runs column-parallel over its grid
row (parallel/tp.py) in ``conv2d``, ``linear`` and ``lstm``; the fused
blocks take the unfused chain for a sharded conv. Every other module runs
as below.

Compute dtype: the blocks and layers take ``dtype`` (torch.float32 or
torch.bfloat16; the reference's flax ``dtype``). In bf16 the casts are
flax's, made explicitly (autocast would compute BatchNorm's statistics in
bf16 here and fuse the conv bias into one rounding): a conv or dense layer
rounds its input and weight to bf16, rounds the product, then adds the bf16
bias (a second rounding); relu, max-pooling and dropout run in bf16;
BatchNorm takes its statistics and normalizes in f32 and returns bf16; an
LSTM runs on bf16 copies of its weights and a bf16 input, the whole
recurrence in bf16 (``torch.func.functional_call``). The parameters and
running statistics stay f32.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from audiobd_tpu_torch.ops import conv1_bn_pool as fused
from audiobd_tpu_torch.ops import conv2_bn_pool as fused2
from audiobd_tpu_torch.parallel import tp
from audiobd_tpu_torch.parallel.distributed import all_reduce_sum

BN_MOMENTUM = 0.9  # flax convention: the running average's decay
BN_EPS = 1e-5


def init_uniform_(module: nn.Module, generator: torch.Generator) -> None:
    """U(±1/√fan_in) for weight and bias: torch's default Conv/Linear init,
    drawn from ``generator``."""
    fan_in = module.weight[0].numel()
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    with torch.no_grad():
        for p in (module.weight, module.bias):
            if p is not None:
                p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))


def init_lstm_(module: nn.LSTM, generator: torch.Generator) -> None:
    """U(±1/√hidden) for all four tensors of every layer and direction
    (reference layers.py:231-235)."""
    bound = 1.0 / math.sqrt(module.hidden_size)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))


def init_tree_(model: nn.Module, generator: torch.Generator) -> None:
    """Every conv, dense and LSTM of ``model`` in module order; BatchNorm
    keeps γ = 1, β = 0."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            init_uniform_(m, generator)
        elif isinstance(m, nn.LSTM):
            init_lstm_(m, generator)


class BatchNorm2d(nn.Module):
    """BatchNorm over the channel axis of NCHW with flax's statistics;
    ``group`` (a process group, None for local statistics) syncs them."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.group = None

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.running_mean.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * mean)
        self.running_var.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * var)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """In f32 whatever x's dtype (flax BatchNorm(dtype=float32),
        audiobd_tpu/models/layers.py:201-212); the result in x's dtype."""
        c = lambda v: v.reshape(1, -1, 1, 1)  # noqa: E731
        x32 = x.to(torch.float32)
        if self.training:
            mean = x32.mean(dim=(0, 2, 3))
            mean2 = (x32 * x32).mean(dim=(0, 2, 3))
            if self.group is not None:
                stats = all_reduce_sum(torch.cat([mean, mean2]), self.group) / dist.get_world_size(self.group)
                mean, mean2 = stats.chunk(2)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            self.update_running(mean.detach(), var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return ((x32 - c(mean)) * c(mul) + c(self.bias)).to(x.dtype)


def dropout(x: torch.Tensor, p: float, training: bool, generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout (flax nn.Dropout semantics) with an explicit generator."""
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def conv2d(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``conv(x)`` in the compute ``dtype`` (flax nn.Conv's casts)."""
    if (shard := tp.shard_of(conv)) is not None:
        return tp.conv2d(conv, shard, x, dtype)
    if dtype == torch.float32:
        return conv(x)
    y = F.conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride, conv.padding)
    return y if conv.bias is None else y + conv.bias.to(dtype).reshape(1, -1, 1, 1)


def linear(fc: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``fc(x)`` in the compute ``dtype`` (flax nn.Dense's casts)."""
    if (shard := tp.shard_of(fc)) is not None:
        return tp.linear(fc, shard, x, dtype)
    if dtype == torch.float32:
        return fc(x)
    return F.linear(x.to(dtype), fc.weight.to(dtype)) + fc.bias.to(dtype)


def lstm(module: nn.LSTM, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The LSTM's output sequence (B, T, H·directions) in the compute
    ``dtype``: in bf16 on bf16 copies of its weights, as the reference casts
    its parameters and input (layers.py:236-259)."""
    if (shard := tp.shard_of(module)) is not None:
        return tp.lstm(module, shard, x, dtype)
    if dtype == torch.float32:
        return module(x)[0]
    weights = {name: p.to(dtype) for name, p in module.named_parameters()}
    return torch.func.functional_call(module, weights, (x.to(dtype),))[0]


def conv_bn_pool_block1(conv: nn.Conv2d, bn: BatchNorm2d, x: torch.Tensor, fused_block: bool,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """First SmallCNN block: maxpool_{1,3}(BN(relu(conv2x2(x)))).

    With ``fused_block`` (and the shape guard of the reference,
    layers.py:309) the block goes through ops/conv1_bn_pool, whose backward
    is the CUDA kernel pair; in training mode the running statistics are
    updated from the op's batch μ and σ² (clamped at 0, as the reference's
    two-sample update does). Otherwise the unfused chain runs. Either way
    the output is in the compute ``dtype``."""
    if not fused_block or tp.shard_of(conv) is not None or not fused.supports(x):
        return F.max_pool2d(bn(F.relu(conv2d(conv, x, dtype))), (1, 3))
    if bn.training:
        out, mu, var = fused.conv1_bn_pool(x, conv.weight, conv.bias, bn.weight, bn.bias, train=True,
                                           compute_dtype=dtype)
        bn.update_running(mu, torch.clamp(var, min=0.0))
        return out
    return fused.conv1_bn_pool(
        x, conv.weight, conv.bias, bn.weight, bn.bias, train=False,
        running_mean=bn.running_mean, running_var=bn.running_var, compute_dtype=dtype,
    )


def conv_bn_pool_block2(conv: nn.Conv2d, bn: BatchNorm2d, x: torch.Tensor, fused_block: bool,
                        pool_padding: tuple[int, int], dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Second and third SmallCNN/SmallLSTM blocks:
    maxpool_{2,2,pad pool_padding}(BN(relu(conv2x2(x)))), pool padding (1, 1)
    in block 2 and (0, 1) in block 3 (reference layers.py:342-381).

    With ``fused_block``, in training mode and for x of at least 2 rows and
    2 columns, the block goes through ops/conv2_bn_pool, whose backward is
    the CUDA kernel pair D, E; the running statistics are updated from the
    op's batch μ and σ² (clamped at 0). Eval calls always take the unfused
    chain: the fused op is train mode only. The output is in ``dtype``."""
    if (not fused_block or tp.shard_of(conv) is not None or not bn.training or x.shape[2] < 2
            or x.shape[3] < 2):
        return F.max_pool2d(bn(F.relu(conv2d(conv, x, dtype))), (2, 2), padding=pool_padding)
    out, mu, var = fused2.conv2_bn_pool(x, conv.weight, conv.bias, bn.weight, bn.bias, pool_padding=pool_padding,
                                        compute_dtype=dtype)
    bn.update_running(mu, torch.clamp(var, min=0.0))
    return out
