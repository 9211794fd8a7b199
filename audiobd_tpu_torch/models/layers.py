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

AST's pieces (models/zoo.py::AST; timm's ViT block, which AST builds on):
LayerNorm, multi-head self-attention and the erf-GELU MLP. Attention runs
through ``F.scaled_dot_product_attention`` on the backend ``scaled_attention``
pins (``ATTENTION_BACKEND``); the ``attention`` span holds that call alone
and the ``mlp`` span fc1 → GELU → fc2 (utils/profiling.py). ``init_tree_``
draws the patch embedding's tokens N(0, 0.02²), timm's ``trunc_normal_(std=.02)``,
whose cut at ±2 lies 100 standard deviations out.

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
recurrence in bf16 (``torch.func.functional_call``); LayerNorm, as BatchNorm,
normalizes in f32 and returns bf16; attention and GELU run in bf16. The
parameters and running statistics stay f32.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from audiobd_tpu_torch.ops import conv1_bn_pool as fused
from audiobd_tpu_torch.ops import conv2_bn_pool as fused2
from audiobd_tpu_torch.parallel import tp
from audiobd_tpu_torch.parallel.distributed import all_reduce_sum
from audiobd_tpu_torch.utils import profiling

BN_MOMENTUM = 0.9  # flax convention: the running average's decay
BN_EPS = 1e-5
LN_EPS = 1e-6  # timm's ViT blocks and final norm (AST's); its mlp_head keeps torch's 1e-5
TOKEN_STD = 0.02
# The backend of every attention call. The math backend computes
# softmax(q kᵀ / √d_h) v as the plain reference does, two batched cuBLAS GEMMs
# around a softmax, f32 with TF32 off (utils/device.py), so its rounding
# follows the reference's and the benchmark's comparison holds it close. The
# memory-efficient kernel (f32 on the card too, and faster) rounds otherwise:
# Adam turns that into larger gaps of the first steps' losses than the
# comparison's limits were set from (PERF.md §7).
ATTENTION_BACKEND = SDPBackend.MATH
# This module's counters, made here so that every span records them, zero
# where they do not move: the convolutions that take the row-slice route,
# and AST's self-attention calls.
profiling.count("sliced_convs", 0)
profiling.count("attention_calls", 0)


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
    """Every conv, dense and LSTM of ``model`` in module order, and the
    patch embedding's tokens (N(0, 0.02²)); BatchNorm keeps γ = 1, β = 0 and
    LayerNorm is set to them."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            init_uniform_(m, generator)
        elif isinstance(m, nn.LSTM):
            init_lstm_(m, generator)
        elif isinstance(m, nn.LayerNorm):
            m.reset_parameters()
        elif isinstance(m, PatchEmbedding):
            with torch.no_grad():
                for p in (m.cls_token, m.dist_token, m.pos_embed):
                    p.copy_(torch.empty(p.shape).normal_(0.0, TOKEN_STD, generator=generator))


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


INPUT_GRAD, WEIGHT_GRAD = 0, 1  # a backward pass, by its index in aten.convolution_backward's outputs


class _RowSlicedConv2d(torch.autograd.Function):
    """``F.conv2d(x, weight, bias)`` (stride 1, no padding), whose backward
    hands cuDNN one pass, ``INPUT_GRAD`` or ``WEIGHT_GRAD``, in slices of
    ``rows`` rows: the input gradient joins the slices' with one ``cat``,
    the weight gradient sums them in order. The forward, the other pass and
    the bias gradient are the whole batch's."""

    @staticmethod
    def forward(ctx, x, weight, bias, sliced, rows):
        ctx.save_for_backward(x, weight)
        ctx.sliced, ctx.rows, ctx.has_bias = sliced, rows, bias is not None
        return F.conv2d(x, weight, bias)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, weight = ctx.saved_tensors

        def grad(i, gi, xi):
            return torch.ops.aten.convolution_backward(gi, xi, weight, None, (1, 1), (0, 0), (1, 1), False, (0, 0),
                                                       1, (i == INPUT_GRAD, i == WEIGHT_GRAD, False))[i]

        def pass_(i):
            if not ctx.needs_input_grad[i]:
                return None
            if i != ctx.sliced:
                return grad(i, g, x)
            parts = [grad(i, gi, xi) for gi, xi in zip(torch.split(g, ctx.rows), torch.split(x, ctx.rows))]
            return torch.cat(parts) if i == INPUT_GRAD else sum(parts[1:], parts[0])

        db = g.sum(dim=(0, 2, 3)) if ctx.has_bias and ctx.needs_input_grad[2] else None
        return pass_(INPUT_GRAD), pass_(WEIGHT_GRAD), db, None, None


# Where cuDNN's own choice for a whole batch loses to its choice for row
# slices: the backward pass, the rows of a slice and the least rows a call
# takes the route at, by (input channels, height, width, output channels)
# of an f32 2x2 convolution at stride 1. The mechanism: past some rows, by
# its plane and channels, cuDNN's heuristic sends one backward pass to an
# FFT route, the weight gradient of 64 -> 64 channels at planes of 80 or
# more by 13 to 20 (24 ms at 1,024 rows against 2.1 in 256-row slices), the
# input gradient mostly at planes of 2 to 7 columns (FFT tiling, 2-7x the
# slices' time); a slice under that point stays on implicit GEMM. The heuristic cannot be
# asked, so the table holds what scripts/conv_route_times.py --planes
# measured on an H100 (PERF.md): it swept a grid of planes that holds every
# plane SmallCNN's and SmallLSTM's 2x2 convolutions see at the five attacks'
# features, at 256 to 2,048 rows. Those it leaves out kept the whole call:
# DABA's block 2 (31, 13) and every plane of block 1 (1 -> 64) and of
# FlowMur's block 3 (16, 2) (no slice was faster), the forward (fastest
# whole everywhere). The least rows are 512 or more, the fewest at which
# the route was measured end to end; at 256 rows (the attacks' published
# batch, a card's rows in data parallel) no call takes it.
ROW_SLICES = {
    (64, 100, 13, 64): (WEIGHT_GRAD, 256, 512),  # block 2 at (101, 40) features: BadNets, JingleBack
    (64, 99, 13, 64): (WEIGHT_GRAD, 256, 512),  # block 2 at (100, 40): Ultrasonic
    (64, 50, 7, 32): (INPUT_GRAD, 128, 512),  # block 3 at (101, 40) and (100, 40)
    (64, 31, 4, 64): (INPUT_GRAD, 512, 1024),  # block 2 at (32, 13): FlowMur
    (64, 16, 7, 32): (INPUT_GRAD, 512, 1024),  # block 3 at (32, 40): DABA
}


def row_slices(conv: nn.Conv2d, x_shape: tuple[int, ...], device_type: str, dtype: torch.dtype,
               needs_grad: bool) -> tuple[int, int] | None:
    """The backward pass ``conv`` hands cuDNN in row slices on an input of
    ``x_shape``, and the rows of a slice; None where the call stays
    ``conv(x)``: off CUDA, outside f32, where no gradient is taken, off a
    2x2 stride-1 convolution of ``ROW_SLICES``, and under its least rows."""
    if device_type != "cuda" or dtype != torch.float32 or not needs_grad:
        return None
    if (conv.kernel_size != (2, 2) or conv.stride != (1, 1) or conv.padding != (0, 0) or conv.dilation != (1, 1)
            or conv.groups != 1):
        return None
    entry = ROW_SLICES.get((*x_shape[1:], conv.out_channels))
    if entry is None or x_shape[0] < entry[2]:
        return None
    return entry[:2]


def conv2d(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``conv(x)`` in the compute ``dtype`` (flax nn.Conv's casts); where
    ``row_slices`` names a pass, with that backward pass in row slices
    (the counter ``sliced_convs`` counts each such call)."""
    if (shard := tp.shard_of(conv)) is not None:
        return tp.conv2d(conv, shard, x, dtype)
    needs_grad = torch.is_grad_enabled() and (x.requires_grad or conv.weight.requires_grad)
    if (route := row_slices(conv, tuple(x.shape), x.device.type, dtype, needs_grad)) is not None:
        profiling.count("sliced_convs")
        return _RowSlicedConv2d.apply(x, conv.weight, conv.bias, *route)
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


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``ln(x)`` with its statistics and affine in f32 whatever x's dtype;
    the result in the compute ``dtype``."""
    if dtype == torch.float32:
        return ln(x)
    return F.layer_norm(x.to(torch.float32), ln.normalized_shape, ln.weight, ln.bias, ln.eps).to(dtype)


def scaled_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ / √d_h) v over (B, H, T, d_h), on ``ATTENTION_BACKEND``."""
    with sdpa_kernel(ATTENTION_BACKEND):
        return F.scaled_dot_product_attention(q, k, v)


class PatchEmbedding(nn.Module):
    """AST's input: a conv of ``patch`` x ``patch`` at ``stride`` from one
    channel to ``dim`` (timm's PatchEmbed), its (f, t) grid flattened f-major,
    a cls and a distillation token in front, a learned position for each of
    the ``tokens`` (grid + 2)."""

    def __init__(self, dim: int, patch: int, stride: int, tokens: int):
        super().__init__()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.dist_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, dim))
        self.proj = nn.Conv2d(1, dim, patch, stride=stride)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(B, 1, F, T) → (B, tokens, dim) in ``dtype``."""
        x = conv2d(self.proj, x, dtype).flatten(2).transpose(1, 2)
        b = x.shape[0]
        x = torch.cat([self.cls_token.to(dtype).expand(b, -1, -1), self.dist_token.to(dtype).expand(b, -1, -1), x],
                      dim=1)
        return x + self.pos_embed.to(dtype)


class Attention(nn.Module):
    """Multi-head self-attention: qkv with bias, ``heads`` heads of dim /
    heads, ``scaled_attention``, the output projection."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        if dim % heads:
            raise ValueError(f"width {dim} does not split into {heads} heads")
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b, t, c = x.shape
        q, k, v = linear(self.qkv, x, dtype).reshape(b, t, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        with profiling.span("attention"):
            profiling.count("attention_calls")
            o = scaled_attention(q, k, v)
        return linear(self.proj, o.transpose(1, 2).reshape(b, t, c), dtype)


class Mlp(nn.Module):
    """fc1 → erf-GELU → fc2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        with profiling.span("mlp"):
            return linear(self.fc2, F.gelu(linear(self.fc1, x, dtype)), dtype)
