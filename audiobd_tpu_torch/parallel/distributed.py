"""Joining a group of ranks, and the collectives the port uses (port of
audiobd_tpu/parallel/distributed.py).

One process a rank, launched by ``torchrun``
(``python -m torch.distributed.run --nproc_per_node N -m audiobd_tpu_torch
...``), which sets ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``. Without them every
helper here answers for a world of one rank and nothing is initialized.

Backend: ``nccl`` (CPU tensors through gloo) when every rank of the node
has a card of its own; ``gloo`` for CPU ranks and for ranks that share a
card, since NCCL refuses two ranks on one device. A rank takes card
``local_rank() % device_count``: its ``LOCAL_RANK`` under a launcher, its
rank in an explicit join. On CUDA tensors the collectives are
``all_reduce``, ``broadcast`` and parallel/tp.py's list-form
``all_gather``, which gloo runs too.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist


def maybe_initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Join the group of ranks iff a multi-rank environment is configured;
    True when a group is live after the call.

    Explicit arguments win: ``coordinator_address`` is an init method URL
    (``tcp://host:port`` or ``file:///path``). Otherwise the ``torchrun``
    environment: ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``.
    A world of one rank, or no environment, returns False and touches
    nothing. A failed initialization raises; nothing carries on alone.
    """
    env = os.environ
    world = num_processes if num_processes is not None else int(env.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    rank_ = process_id if process_id is not None else int(env["RANK"])
    if coordinator_address is None:
        coordinator_address = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    n_cuda = torch.cuda.device_count()
    own_cards = 0 < local_world <= n_cuda
    backend = "cpu:gloo,cuda:nccl" if own_cards else "gloo"
    card = local_rank(rank_) % n_cuda if n_cuda else -1  # the card this rank runs on; -1: none
    if own_cards:
        torch.cuda.set_device(card)
    dist.init_process_group(backend, init_method=coordinator_address, world_size=world, rank=rank_)
    # Each rank's card as the rank placed itself: one all-gather of a CPU
    # tensor (gloo under either backend) at the join.
    cards = [torch.empty(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(cards, torch.tensor([card]))
    if rank_ == 0:
        devices = ", ".join(f"rank {r}: {f'cuda:{int(c)}' if int(c) >= 0 else 'cpu'}" for r, c in enumerate(cards))
        print(f"distributed: world {world}, backend {'nccl' if own_cards else 'gloo'} ({devices})", flush=True)
    return True


def destroy() -> None:
    """Leave the group, where one is live."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def live() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if live() else 0


def world_size() -> int:
    return dist.get_world_size() if live() else 1


def is_main() -> bool:
    """Rank 0, the one rank that writes files and prints epoch lines."""
    return rank() == 0


def main_rank_only(fn):
    """Marks ``fn`` as one that writes files: on a rank other than 0 it
    returns None without running, so one rank writes each file. Only the
    writers at the leaves carry it (wav, npy, CSV, checkpoint, plot), and
    their callers do not check the rank again."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return fn(*args, **kwargs) if is_main() else None

    return wrapper


def agreed(flag: bool, what: str) -> bool:
    """``flag``, a fact every rank reads from the files the ranks share
    (does a trigger file or a cache exist?), once every rank has read it.

    The check is one all-reduce, and so a barrier: no rank gets past it,
    and writes, before every rank has read its flag. Ranks that disagree
    (a directory local to each node) raise. No-op without a group."""
    if not live():
        return flag
    count = torch.tensor([int(flag)])
    dist.all_reduce(count)
    if int(count) not in (0, world_size()):
        raise RuntimeError(f"{int(count)} of {world_size()} ranks see {what}: the ranks must share it")
    return flag


def local_rank(process_id: int | None = None) -> int:
    """This rank's index on its node, the one rule that places a rank on a
    card: the join's ``set_device`` and utils/device.py::resolve_device
    both take ``local_rank() % device_count``. ``LOCAL_RANK`` where a
    launcher set it; otherwise the rank of an explicit join, whose ranks are
    taken to be one node's: ``process_id`` before the group is live, the
    group's rank after; 0 without either."""
    env = os.environ.get("LOCAL_RANK")
    if env is not None:
        return int(env)
    return rank() if process_id is None else process_id


class _AllReduceSum(torch.autograd.Function):
    """y = Σ_ranks x. Every rank's y feeds its own loss, so the gradient of
    the summed loss at each rank's x is the sum of the ranks' gradients at
    y: the backward is an all-reduce-sum too."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over ``group``'s ranks of ``x``, differentiable (sync-BN's
    statistics)."""
    return _AllReduceSum.apply(x, group)


def all_reduce_flat(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """Σ over ``group``'s ranks of each tensor, in one all-reduce of one flat
    buffer: views of the reduced buffer, shaped as the inputs."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [part.view_as(t) for part, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


@dataclass(frozen=True)
class HostShard:
    """This process's contiguous slice of a globally-indexed dataset."""

    start: int
    stop: int

    def __len__(self) -> int:
        return self.stop - self.start

    def indices(self):
        import numpy as np

        return np.arange(self.start, self.stop)


def host_shard(n: int, process_index: int | None = None, process_count: int | None = None) -> HostShard:
    """Deterministic contiguous shard of ``n`` examples for this process.

    The first ``n % P`` processes take one extra example, so every example is
    owned by exactly one process and shard sizes differ by at most one —
    wrap-pad batching already masks ragged tails. Like the reference's, no
    trainer calls it; it defaults to this rank of the live group.
    """
    process_index = rank() if process_index is None else process_index
    process_count = world_size() if process_count is None else process_count
    if not 0 <= process_index < process_count:
        raise ValueError(f"process index {process_index} outside a world of {process_count}")
    base, extra = divmod(n, process_count)
    start = process_index * base + min(process_index, extra)
    stop = start + base + (1 if process_index < extra else 0)
    return HostShard(start, stop)
