"""The (data, model) grid of ranks (port of audiobd_tpu/parallel/mesh.py).

Ranks are laid out row-major on a ``(n_data, n_model)`` grid. Ranks of one
grid column hold the ``n_data`` shards of every batch and all-reduce their
gradients and sync-BN statistics in that column's group; the ranks of one
row are replicas that take the same shard, as the reference's trainer
gives a mesh with ``model > 1`` (parameters replicated, batches sharded on
``data`` only). The reference's ``PartitionSpec`` helpers (``batch_pspec``,
``replicated_pspec``) have no torch meaning and are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from audiobd_tpu_torch.parallel.distributed import live, rank, world_size


@dataclass(frozen=True)
class Mesh:
    grid: np.ndarray  # (n_data, n_model) of global ranks
    data_index: int   # this rank's row: the shard it takes
    data_group: Any   # this rank's column's process group; None on a one-rank mesh

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.grid.shape[0], "model": self.grid.shape[1]}

    @property
    def size(self) -> int:
        return int(self.grid.size)


def make_mesh(n_data: int = -1, n_model: int = 1) -> Mesh:
    """The grid over the world of ranks; ``n_data`` -1 means ``world //
    n_model``, as in the reference. The grid must cover the world: the
    reference leaves the devices past it idle, here a rank past it would
    train on nothing, so that raises ``ValueError`` naming both sizes."""
    world = world_size()
    if n_data == -1:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model != world:
        raise ValueError(f"a mesh of {n_data} x {n_model} ranks for a world of {world} ranks")
    grid = np.arange(world).reshape(n_data, n_model)
    group = None
    if live():
        # Every rank creates every column's group, in the same order.
        for column in range(n_model):
            g = dist.new_group([int(r) for r in grid[:, column]])
            if column == rank() % n_model:
                group = g
    return Mesh(grid, rank() // n_model, group)


def shard_replicated(tensors: list[torch.Tensor]) -> None:
    """Rank 0's values of ``tensors`` (the model's and the optimizer's), in
    place on every rank: a broadcast each. No-op without a group."""
    if not live():
        return
    for t in tensors:
        dist.broadcast(t, src=0)


def shard_batch(mesh: Mesh, index: np.ndarray) -> np.ndarray:
    """This rank's rows of a global index set: its ``len(index) / n_data``
    contiguous rows, as the reference shards a batch on ``data``."""
    n_data = mesh.shape["data"]
    if len(index) % n_data:
        raise ValueError(f"{len(index)} rows do not split over {n_data} data shards")
    return np.asarray(index).reshape(n_data, -1)[mesh.data_index]
