"""Column-parallel compute over a grid row of the mesh (its ``model`` axis),
for the layout parallel/mesh.py::shard_params_tp makes.

The reference marks the large kernels' output axis sharded over ``model``
and lets GSPMD insert the activation collectives (audiobd_tpu/parallel/
mesh.py:50-71). torch inserts none, so models/layers.py's ``conv2d``,
``linear`` and ``lstm`` send a module that carries a shard here. Rank m of
a row of n ranks holds the block [m·N/n, (m+1)·N/n) of each sharded
weight's dim 0 (output features, output channels, or the LSTM's 4H gate
axis) and computes those output columns; ``gather`` joins the row's blocks
in rank order. Everything downstream of a gather is replicated: each rank
of the row computes the same loss from the same values.

Two autograd functions carry the gradients over the row:
  * ``_Gather``: all-gather along the feature dim forward; backward, this
    rank's block of the incoming gradient, with no communication. Every
    rank of the row holds the same gradient of the replicated loss, so
    summing it over the row, as ``torch.distributed.nn.functional.
    all_gather``'s backward does, would multiply each shard's gradient by n.
  * ``_CopyToRow``: identity forward; backward, the all-reduce-sum over the
    row of the input's gradient, which each rank forms from its own
    columns only.
So a replicated parameter gets its whole gradient on every rank of its row,
and a shard its own. A grid column's ranks hold the same blocks, so the
data axis's one gradient all-reduce (train/scan_epoch.py) is unchanged.

The collectives are ``dist.all_gather`` (the list form, contiguous tensors)
and ``dist.all_reduce``, which gloo runs on CPU and CUDA tensors alike;
``COUNTS`` counts each call. A block of the wrong size raises here; a rank
whose block differs in size from its row's fails in the collective itself.

bf16 keeps models/layers.py's casts: the local product in the compute
dtype, the gather in the activation's dtype, the bias added after the
gather in the compute dtype. The LSTM runs as a loop in plain torch (cuDNN's
LSTM takes whole weights only): the input projection of the whole sequence
at once, one gather a layer and direction, then a gather a step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

COUNTS = {"gathers": 0, "row_all_reduces": 0}


@dataclass(frozen=True)
class TPShard:
    """What a module's sharded weights hold: the row's ``group`` (None
    where the mesh has no live group), its ``n`` ranks, this rank's block
    ``index``, and ``full``, the sharded axis's unsharded size."""

    group: Any
    n: int
    index: int
    full: int

    @property
    def block(self) -> slice:
        size = self.full // self.n
        return slice(self.index * size, (self.index + 1) * size)


def shard_of(module: nn.Module) -> TPShard | None:
    """The shard ``shard_params_tp`` put on ``module``, or None."""
    return getattr(module, "tp_shard", None)


def _live(shard: TPShard) -> None:
    if shard.group is None or not dist.is_initialized():
        raise RuntimeError(f"a tensor-parallel layer over {shard.n} ranks runs without the mesh's live row group")


def gather_rows(x: torch.Tensor, group, n: int, dim: int = 0) -> torch.Tensor:
    """The row's blocks of ``x`` joined along ``dim`` in rank order, not
    differentiable (a checkpoint's full tensors)."""
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    COUNTS["gathers"] += 1
    return torch.cat(parts, dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y: torch.Tensor, dim: int, shard: TPShard) -> torch.Tensor:
        ctx.dim, ctx.shard = dim, shard
        return gather_rows(y, shard.group, shard.n, dim)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        size = grad.shape[ctx.dim] // ctx.shard.n
        return grad.narrow(ctx.dim, ctx.shard.index * size, size), None, None


class _CopyToRow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        COUNTS["row_all_reduces"] += 1
        return grad, None


def gather(y: torch.Tensor, dim: int, shard: TPShard) -> torch.Tensor:
    """This rank's output block ``y`` joined with the row's along ``dim``."""
    _live(shard)
    if y.shape[dim] * shard.n != shard.full:
        raise ValueError(f"a block of {y.shape[dim]} along dim {dim} for {shard.full} features over {shard.n} ranks")
    return _Gather.apply(y, dim, shard)


def copy_to_row(x: torch.Tensor, shard: TPShard) -> torch.Tensor:
    """``x``, replicated over the row, as the input of a column-parallel
    product: its gradient is summed over the row. A tensor that needs no
    gradient passes as it is (no collective)."""
    _live(shard)
    return _CopyToRow.apply(x, shard.group) if x.requires_grad else x


def conv2d(conv: nn.Conv2d, shard: TPShard, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """models/layers.py::conv2d on a conv whose output channels are sharded."""
    y = F.conv2d(copy_to_row(x, shard).to(dtype), conv.weight.to(dtype), None, conv.stride, conv.padding)
    y = gather(y, 1, shard)
    return y if conv.bias is None else y + conv.bias.to(dtype).reshape(1, -1, 1, 1)


def linear(fc: nn.Linear, shard: TPShard, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """models/layers.py::linear on a dense layer whose output features are
    sharded."""
    y = gather(F.linear(copy_to_row(x, shard).to(dtype), fc.weight.to(dtype)), -1, shard)
    return y + fc.bias.to(dtype)


def lstm(module: nn.LSTM, shard: TPShard, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """models/layers.py::lstm on an LSTM whose gate axis is sharded: the
    output sequence (B, T, H·directions) of ``nn.LSTM(batch_first=True)``,
    every tensor cast to ``dtype``, in the reference's order
    (audiobd_tpu/models/layers.py:215-259): x·W_ih + b_ih + b_hh for the
    whole sequence, then per step gates = that + h·W_hh, split i, f, g, o,
    c ← σ(f)·c + σ(i)·tanh(g), h ← σ(o)·tanh(c). A reverse direction runs
    on the flipped sequence and flips its output back."""
    if not module.batch_first or module.proj_size or module.dropout:
        raise ValueError("the tensor-parallel LSTM takes batch_first, no projection and no dropout between layers")
    directions = 2 if module.bidirectional else 1
    hidden = module.hidden_size
    inp = x.to(dtype)
    for layer in range(module.num_layers):
        shared = copy_to_row(inp, shard)
        outs = []
        for direction in range(directions):
            suffix = f"l{layer}" + ("_reverse" if direction else "")
            w_ih, w_hh, b_ih, b_hh = (getattr(module, f"{name}_{suffix}").to(dtype)
                                      for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
            seq = shared.flip(1) if direction else shared
            xp = gather(F.linear(seq, w_ih), -1, shard) + b_ih + b_hh  # (B, T, 4H)
            h = c = torch.zeros(seq.shape[0], hidden, dtype=dtype, device=seq.device)
            hs = []
            for t in range(seq.shape[1]):
                gates = xp[:, t] + gather(F.linear(copy_to_row(h, shard), w_hh), -1, shard)
                i, f, g, o = gates.chunk(4, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
                hs.append(h)
            y = torch.stack(hs, dim=1)
            outs.append(y.flip(1) if direction else y)
        inp = torch.cat(outs, dim=-1) if directions == 2 else outs[0]
    return inp
