"""Device-resident epochs (port of audiobd_tpu/train/scan_epoch.py).

Every split lives on the device for the whole run. An epoch is a device
loop over batches (gather by permuted indices → step); per-batch losses and
metric sums stay on the device until the epoch ends, so the host waits for
the card only at the epoch's edges: the plan's uploads and the summary's
reads (``utils/profiling.py``'s ``host_syncs``). The batch order is the
reference's: the same ``make_perm`` on the same ``np_rng`` stream.

Under a profiler session each epoch records its spans: ``train_epoch``
(``plan``; a ``train_step`` a batch with ``forward``, ``loss``,
``backward``, ``optimizer`` and ``metrics``; ``summary``) or
``eval_epoch`` (``plan``; an ``eval_step`` a batch with ``forward`` and
``metrics``; ``summary``).

The sharded engine (reference :198-446) runs the same loop on every rank
of a mesh's data axis: each rank holds its row shard of every split,
shuffled locally, a global batch is the concatenation of the ranks'
slices, and the gradients (one flat all-reduce a step), the sync-BN
statistics (models/layers.py) and, once at the epoch's end, the loss
numerators and metric sums are summed over the ranks. One step is the
global batch's single-device step.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from audiobd_tpu_torch.parallel.distributed import all_reduce_flat
from audiobd_tpu_torch.parallel.mesh import Mesh
from audiobd_tpu_torch.train.loop import ArraySet, cross_entropy, masked_mean, metric_sums
from audiobd_tpu_torch.utils.profiling import span, to_device, to_host


def pad_plan(n: int, batch_size: int) -> tuple[int, np.ndarray]:
    """(n_batches, mask (n_batches, batch_size)) with wrap-padded tail."""
    n_batches = -(-n // batch_size)
    mask = np.ones((n_batches, batch_size), dtype=bool)
    tail = n_batches * batch_size - n
    if tail:
        mask[-1, batch_size - tail :] = False
    return n_batches, mask


def make_perm(np_rng: np.random.Generator | None, n: int, n_batches: int, batch_size: int) -> np.ndarray:
    order = np_rng.permutation(n) if np_rng is not None else np.arange(n)
    total = n_batches * batch_size
    if total > n:
        # Cyclic wrap-pad: handles batch_size > n too.
        order = np.concatenate([order, np.resize(order, total - n)])
    return order.reshape(n_batches, batch_size).astype(np.int32)


class DeviceDataset:
    """An ArraySet pinned to device memory."""

    def __init__(self, data: ArraySet, device: torch.device):
        feats = data.feats if isinstance(data.feats, torch.Tensor) else torch.from_numpy(np.asarray(data.feats))
        self.feats = feats.to(device=device, dtype=torch.float32)
        self.labels = torch.as_tensor(np.asarray(data.labels), dtype=torch.int64).to(device)
        ind = data.indicators if data.indicators is not None else np.zeros(len(data.labels), np.int64)
        self.indicators = torch.as_tensor(np.asarray(ind), dtype=torch.int64).to(device)
        self.n = len(data.labels)
        self.device = device

    def __len__(self):
        return self.n

    def n_batches(self, batch_size: int) -> int:
        return pad_plan(self.n, batch_size)[0]

    def plan(self, batch_size: int, np_rng: np.random.Generator | None):
        """(perm, mask) on the device, (n_batches, batch_size) each."""
        n_batches, mask = pad_plan(self.n, batch_size)
        perm = make_perm(np_rng, self.n, n_batches, batch_size)
        return to_device(perm.astype(np.int64), self.device), to_device(mask, self.device)


def _summary(losses: torch.Tensor, sums: torch.Tensor) -> tuple[float, np.ndarray]:
    """The epoch's host reads: mean of batch-mean losses and the sums."""
    return float(to_host(losses).mean()), to_host(sums)


def run_train_epoch(model, opt, dset: DeviceDataset, batch_size: int, np_rng) -> dict:
    """One training pass in train mode; ``opt`` is any optimizer of
    train/state.py (``opt.params``, ``opt.step(grads)``)."""
    with span("train_epoch"):
        model.train()
        with span("plan"):
            perm, mask = dset.plan(batch_size, np_rng)
        losses = torch.empty(perm.shape[0], dtype=torch.float32, device=dset.device)
        sums = torch.zeros(4, dtype=torch.int64, device=dset.device)
        for i in range(perm.shape[0]):
            with span("train_step"):
                idx, bmask = perm[i], mask[i]
                labels = dset.labels[idx]
                with span("forward"):
                    logits = model(dset.feats[idx])
                with span("loss"):
                    loss = masked_mean(cross_entropy(logits, labels), bmask)
                with span("backward"):
                    grads = torch.autograd.grad(loss, opt.params)
                with span("optimizer"):
                    opt.step(grads)
                with span("metrics"):
                    losses[i] = loss.detach()
                    sums += metric_sums(logits.detach(), labels, dset.indicators[idx], bmask)
        with span("summary"):
            loss, s = _summary(losses, sums)
    return {
        "loss": loss,
        "mix_acc": 100.0 * s[0] / max(s[1], 1),
        "asr": 100.0 * s[2] / max(s[3], 1),
    }


@torch.no_grad()
def run_eval_epoch(model, dset: DeviceDataset, batch_size: int) -> dict:
    with span("eval_epoch"):
        model.eval()
        with span("plan"):
            perm, mask = dset.plan(batch_size, None)
        losses = torch.empty(perm.shape[0], dtype=torch.float32, device=dset.device)
        sums = torch.zeros(4, dtype=torch.int64, device=dset.device)
        for i in range(perm.shape[0]):
            with span("eval_step"):
                idx, bmask = perm[i], mask[i]
                labels = dset.labels[idx]
                with span("forward"):
                    logits = model(dset.feats[idx])
                with span("metrics"):
                    losses[i] = masked_mean(cross_entropy(logits, labels), bmask)
                    sums += metric_sums(logits, labels, dset.indicators[idx], bmask)
        with span("summary"):
            loss, s = _summary(losses, sums)
    return {
        "loss": loss,
        "acc": 100.0 * s[0] / max(s[1], 1),
        "asr": 100.0 * s[2] / max(s[3], 1),
        "sums": s,  # [correct, total, asr_correct, poison_total]
    }


# ---------------------------------------------------------------------------
# Sharded (multi-rank data-parallel) epochs


def shard_layout(n: int, n_devices: int) -> tuple[int, np.ndarray, np.ndarray]:
    """(n_loc, offsets, counts): balanced contiguous row assignment.

    Shard d owns rows [offsets[d], offsets[d]+counts[d]) of the original
    array, with counts differing by at most one, so no shard is empty for
    n >= D. Each shard's rows are wrap-padded to the common n_loc slots."""
    d = n_devices
    if n < d:
        raise ValueError(f"need at least one row per shard: n={n}, devices={d}")
    base, extra = divmod(n, d)
    counts = np.asarray([base + (1 if i < extra else 0) for i in range(d)])
    offsets = np.concatenate([[0], np.cumsum(counts[:-1])])
    return int(counts.max()), offsets, counts


def make_sharded_perm(
    np_rng: np.random.Generator | None, n: int, n_devices: int, batch_size: int
) -> tuple[np.ndarray, np.ndarray, int]:
    """Per-shard local shuffle plan.

    Rows are assigned by shard_layout; returns (perm (n_batches, D, B/D) of
    LOCAL indices, mask (n_batches, D, B/D), n_padded). Wrap-padded slots
    are masked out, so each real row contributes to the epoch metrics
    exactly once. Shuffling is within-shard: batch composition differs from
    a global shuffle, per-step math does not.
    """
    d = n_devices
    if batch_size % d:
        raise ValueError(f"batch size {batch_size} does not split over {d} shards")
    b_loc = batch_size // d
    n_loc, _, counts = shard_layout(n, d)
    n_batches = -(-n_loc // b_loc)
    cap = n_batches * b_loc
    perms, masks = [], []
    for dev in range(d):
        real = int(counts[dev])
        order = np_rng.permutation(real) if np_rng is not None else np.arange(real)
        order = np.resize(order, cap)
        mask = np.zeros(cap, dtype=bool)
        mask[:real] = True
        perms.append(order.reshape(n_batches, b_loc))
        masks.append(mask.reshape(n_batches, b_loc))
    perm = np.stack(perms, axis=1).astype(np.int32)
    mask = np.stack(masks, axis=1)
    return perm, mask, n_loc * d


def pad_rows_index(n: int, n_devices: int) -> np.ndarray:
    """Flat row indices of the shard_layout slot grid: shard d's slot block
    holds its counts[d] real rows wrap-padded to n_loc."""
    n_loc, offsets, counts = shard_layout(n, n_devices)
    return np.concatenate(
        [off + (np.arange(n_loc) % int(cnt)) for off, cnt in zip(offsets, counts)]
    )


def pad_rows(arr: np.ndarray, n_devices: int) -> np.ndarray:
    """Rearrange rows into the shard_layout slot grid (padded copies are
    never emitted by make_sharded_perm's masks)."""
    return arr[pad_rows_index(arr.shape[0], n_devices)]


class ShardedDeviceDataset(DeviceDataset):
    """This rank's slot block of a split (its ``n_loc`` rows of the
    shard_layout grid) on ``device``. A device-resident split (the
    poisoning preps') is gathered on its device, never through the host.
    ``n`` is the whole split's row count."""

    def __init__(self, data: ArraySet, mesh: Mesh, device: torch.device):
        n, d = len(data.labels), mesh.shape["data"]
        n_loc = shard_layout(n, d)[0]
        rows = pad_rows_index(n, d)[mesh.data_index * n_loc:(mesh.data_index + 1) * n_loc]
        feats = data.feats
        if isinstance(feats, torch.Tensor):
            feats = feats.index_select(0, torch.from_numpy(rows).to(feats.device))
        else:
            feats = np.asarray(feats)[rows]
        ind = None if data.indicators is None else np.asarray(data.indicators)[rows]
        super().__init__(ArraySet(feats, np.asarray(data.labels)[rows], ind), device)
        self.n, self.d, self.index, self.group = n, d, mesh.data_index, mesh.data_group

    def n_batches(self, batch_size: int) -> int:
        return -(-shard_layout(self.n, self.d)[0] // (batch_size // self.d))

    def shard_plan(self, batch_size: int, np_rng: np.random.Generator | None):
        """This rank's (perm, mask) on the device, (n_batches, B/D) each,
        and every batch's global row count (its loss denominator), from
        the full plan every rank draws alike from ``np_rng``."""
        perm, mask, _ = make_sharded_perm(np_rng, self.n, self.d, batch_size)
        den = np.maximum(mask.sum(axis=(1, 2)), 1).astype(np.float32)
        return (
            to_device(perm[:, self.index].astype(np.int64), self.device),
            to_device(np.ascontiguousarray(mask[:, self.index]), self.device),
            den,
        )


def _reduced(nums: torch.Tensor, sums: torch.Tensor, den: np.ndarray, group) -> tuple[np.ndarray, np.ndarray]:
    """The epoch's one collective and host read: the ranks' loss numerators
    and metric sums, summed; returns (the batch losses, the sums)."""
    buf = torch.cat([nums.to(torch.float64), sums.to(torch.float64)])
    dist.all_reduce(buf, group=group)
    buf = to_host(buf)
    return buf[: len(nums)].astype(np.float32) / den, buf[len(nums):].astype(np.int64)


def run_train_epoch_sharded(model, opt, dset: ShardedDeviceDataset, batch_size: int, np_rng) -> dict:
    """One training pass on this rank's shard; every rank calls it alike.
    A rank's loss is its rows' masked loss sum over the global batch's row
    count, so the sum of the ranks' gradients is the global batch's."""
    with span("train_epoch"):
        model.train()
        with span("plan"):
            perm, mask, den = dset.shard_plan(batch_size, np_rng)
        nums = torch.empty(perm.shape[0], dtype=torch.float32, device=dset.device)
        sums = torch.zeros(4, dtype=torch.int64, device=dset.device)
        for i in range(perm.shape[0]):
            with span("train_step"):
                idx, bmask = perm[i], mask[i]
                labels = dset.labels[idx]
                with span("forward"):
                    logits = model(dset.feats[idx])
                with span("loss"):
                    num = (cross_entropy(logits, labels) * bmask.to(torch.float32)).sum()
                    loss = num / float(den[i])
                with span("backward"):
                    grads = torch.autograd.grad(loss, opt.params)
                with span("optimizer"):
                    opt.step(all_reduce_flat(list(grads), dset.group))
                with span("metrics"):
                    nums[i] = num.detach()
                    sums += metric_sums(logits.detach(), labels, dset.indicators[idx], bmask)
        with span("summary"):
            losses, s = _reduced(nums, sums, den, dset.group)
    return {
        "loss": float(losses.mean()),
        "mix_acc": 100.0 * s[0] / max(s[1], 1),
        "asr": 100.0 * s[2] / max(s[3], 1),
    }


@torch.no_grad()
def run_eval_sharded(model, dset: ShardedDeviceDataset, batch_size: int) -> dict:
    with span("eval_epoch"):
        model.eval()
        with span("plan"):
            perm, mask, den = dset.shard_plan(batch_size, None)
        nums = torch.empty(perm.shape[0], dtype=torch.float32, device=dset.device)
        sums = torch.zeros(4, dtype=torch.int64, device=dset.device)
        for i in range(perm.shape[0]):
            with span("eval_step"):
                idx, bmask = perm[i], mask[i]
                labels = dset.labels[idx]
                with span("forward"):
                    logits = model(dset.feats[idx])
                with span("metrics"):
                    nums[i] = (cross_entropy(logits, labels) * bmask.to(torch.float32)).sum()
                    sums += metric_sums(logits, labels, dset.indicators[idx], bmask)
        with span("summary"):
            losses, s = _reduced(nums, sums, den, dset.group)
    return {
        "loss": float(losses.mean()),
        "acc": 100.0 * s[0] / max(s[1], 1),
        "asr": 100.0 * s[2] / max(s[3], 1),
        "sums": s,  # [correct, total, asr_correct, poison_total]
    }
