"""The (data, model) grid of ranks (port of audiobd_tpu/parallel/mesh.py).

Ranks are laid out row-major on a ``(n_data, n_model)`` grid. Ranks of one
grid column hold the ``n_data`` shards of every batch and all-reduce their
gradients and sync-BN statistics in that column's group; the ranks of one
row take the same shard. ``train_attack`` keeps a row's ranks replicas, as
the reference's trainer gives a mesh with ``model > 1`` (parameters
replicated, batches sharded on ``data`` only). ``shard_params_tp`` lays a
model out tensor-parallel instead: its large kernels' output axis is split
over the row (the ``model`` axis), and parallel/tp.py computes with the
shards. The reference's ``PartitionSpec`` helpers (``batch_pspec``,
``replicated_pspec``) have no torch meaning and are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from audiobd_tpu_torch.parallel.distributed import live, rank, world_size
from audiobd_tpu_torch.parallel.tp import TPShard, gather_rows


@dataclass(frozen=True)
class Mesh:
    grid: np.ndarray  # (n_data, n_model) of global ranks
    data_index: int   # this rank's row: the shard it takes
    data_group: Any   # this rank's column's process group; None on a one-rank mesh
    model_index: int = 0   # this rank's column: the block of a sharded axis it holds
    model_group: Any = None  # this rank's row's process group; None on a one-rank row

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
    group = row_group = None
    if live():
        # new_group is collective over the world: every rank creates every
        # column's group, then every row's, in the same order.
        for column in range(n_model):
            g = dist.new_group([int(r) for r in grid[:, column]])
            if column == rank() % n_model:
                group = g
        if n_model > 1:
            for row in range(n_data):
                g = dist.new_group([int(r) for r in grid[row]])
                if row == rank() // n_model:
                    row_group = g
    return Mesh(grid, rank() // n_model, group, rank() % n_model, row_group)


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


def _tp_rule(p: torch.Tensor, n_model: int, min_features: int) -> bool:
    """The reference's rule (audiobd_tpu/parallel/mesh.py:62-66) on a torch
    tensor: flax's last (output) axis is torch's dim 0 for every tensor it
    can select, the dense kernel (in, out) being ``Linear.weight`` (out,
    in), the HWIO conv kernel ``Conv2d.weight`` (O, I, kh, kw), and the
    LSTM's (in, 4H) ``w_ih``/``w_hh`` its ``weight_ih_l{k}``/``weight_hh_
    l{k}`` (4H, in), carried with no gate permutation (models/convert.py)."""
    return p.ndim >= 2 and p.shape[0] >= min_features and p.shape[0] % n_model == 0


def shard_params_tp(mesh: Mesh, model: nn.Module, opt=None, min_features: int = 128) -> nn.Module:
    """Tensor-parallel layout (port of audiobd_tpu/parallel/mesh.py:50-71):
    each parameter with at least 2 dims whose dim 0 is at least
    ``min_features`` and splits over the mesh's ``model`` axis keeps, on
    grid rank (d, m), only its block [m·N/n, (m+1)·N/n) of dim 0, the block
    the reference's ``P(None, …, 'model')`` gives device (d, m). The rest is
    replicated: biases (added after the gather), BatchNorm's scale, bias
    and running statistics (1-D), Adam's ``count``. ``opt`` (train/state.py's
    Adam or SGD over ``model``'s parameters, optional) has its moments of a
    sharded parameter cut to the same block, so its per-tensor loops run on
    the shards unchanged. Each module holding a shard is marked with it
    (``tp_shard``), and models/layers.py runs it column-parallel
    (parallel/tp.py). In place; returns ``model``. ``n_model`` 1 leaves the
    model untouched, as replication.

    The row's ranks check, in one gather over the row, that they shard the
    same tensors at the same shapes. A mesh without a live row group still
    lays the shards out (their values can be read), but a forward through a
    sharded layer raises. Hand sync-BN (``sync_batchnorm``) the data group
    only where ``n_data`` > 1: on a 1 × n mesh BatchNorm keeps local
    statistics, so block 1 of SmallCNN/SmallLSTM keeps its fused kernel.

    The row's ranks compute each replicated tensor apart, so they must
    compute it bit for bit alike: sharding turns on cuDNN's deterministic
    algorithms for the process (``torch.backends.cudnn.deterministic``).
    cuDNN's default f32 weight-gradient algorithms may sum in another order
    from run to run, and the replicas would drift apart by last bits."""
    n_model = mesh.shape["model"]
    if n_model == 1:
        return model
    if getattr(model, "tp_sharded", None):
        raise ValueError("the model is sharded already")
    chosen = []  # (state_dict key, module, parameter)
    for module_name, module in model.named_modules():
        for name, p in module.named_parameters(recurse=False):
            if not _tp_rule(p, n_model, min_features):
                continue
            key = f"{module_name}.{name}".lstrip(".")
            if not isinstance(module, (nn.Conv2d, nn.Linear, nn.LSTM)):
                raise ValueError(f"{key} {tuple(p.shape)} is selected, but a {type(module).__name__} has no "
                                 f"tensor-parallel route")
            chosen.append((key, module, p))
    layout = [(key, tuple(p.shape)) for key, _, p in chosen]
    if mesh.model_group is not None:
        seen: list = [None] * n_model
        dist.all_gather_object(seen, layout, group=mesh.model_group)
        if any(other != layout for other in seen):
            raise RuntimeError(f"the ranks of a row would shard different tensors: {seen}")
    torch.backends.cudnn.deterministic = True
    owners = {id(p): i for i, p in enumerate(opt.params)} if opt is not None else {}
    moments = [getattr(opt, k) for k in ("mu", "nu", "trace") if hasattr(opt, k)]
    sharded = {}
    for key, module, p in chosen:
        shard = TPShard(mesh.model_group, n_model, mesh.model_index, p.shape[0])
        module.tp_shard = shard  # an LSTM's weights share their gate axis, so one shard
        p.data = p.data[shard.block].clone()
        for state in moments:
            i = owners[id(p)]
            state[i] = state[i][shard.block].clone()
        sharded[key] = shard
    model.tp_sharded = sharded
    return model


def unshard_params_tp(mesh: Mesh, model: nn.Module) -> dict[str, torch.Tensor]:
    """``model``'s state_dict with every sharded tensor gathered whole on
    every rank of the row (what ``np.asarray`` of a sharded ``jax.Array``
    gives), the rest copied: the unsharded layout ``build_model``,
    ``infer``, the defenses and a checkpoint's ``model.pt`` take. A
    collective over the row where anything is sharded."""
    sharded = getattr(model, "tp_sharded", None) or {}
    out = {}
    for key, value in model.state_dict().items():
        if key in sharded:
            if mesh.model_group is None:
                raise RuntimeError(f"gathering {key} needs the mesh's live row group")
            out[key] = gather_rows(value.detach(), mesh.model_group, sharded[key].n)
        else:
            out[key] = value.detach().clone()
    return out
