"""Device-resident epochs (port of audiobd_tpu/train/scan_epoch.py, its
single-device and sharded engines in one).

Every split lives on the device for the whole run. An epoch is a device
loop over batches (gather by permuted indices → step); per-batch losses and
metric sums stay on the device until the epoch ends, so the host waits for
the card only at the epoch's edges: the plan's one upload and the summary's
one read (``utils/profiling.py``'s ``host_syncs``).

The same loop runs on one rank and on every rank of a mesh's data axis
(reference :198-446): each rank holds its row shard of every split,
shuffled locally, a global batch is the concatenation of the ranks'
slices, and the gradients (one flat all-reduce a step), the sync-BN
statistics (models/layers.py) and, once at the epoch's end, the batch
losses and metric sums are summed over the ranks. One step is the global
batch's single-device step. On one rank the shard is the whole split, the
plan is ``make_perm``'s on the same ``np_rng`` stream, a step's loss is
``masked_mean``'s, and nothing is exchanged.

Under a profiler session each epoch records its spans: ``train_epoch``
(``plan``; a ``train_step`` a batch with ``forward``, ``loss``,
``backward``, ``optimizer`` and ``metrics``; ``summary``) or
``eval_epoch`` (``plan``; an ``eval_step`` a batch with ``forward`` and
``metrics``; ``summary``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from audiobd_tpu_torch.parallel.distributed import all_reduce_flat
from audiobd_tpu_torch.parallel.mesh import Mesh
from audiobd_tpu_torch.train.loop import ArraySet, cross_entropy, metric_sums
from audiobd_tpu_torch.utils.profiling import span, to_device, to_host


def pad_plan(n: int, batch_size: int) -> tuple[int, np.ndarray]:
    """(n_batches, mask (n_batches, batch_size)) with wrap-padded tail: the
    reference's one-device mask, which ``make_sharded_perm`` gives on one
    shard."""
    n_batches = -(-n // batch_size)
    mask = np.ones((n_batches, batch_size), dtype=bool)
    tail = n_batches * batch_size - n
    if tail:
        mask[-1, batch_size - tail :] = False
    return n_batches, mask


def make_perm(np_rng: np.random.Generator | None, n: int, n_batches: int, batch_size: int) -> np.ndarray:
    """The reference's one-device batch order, which ``make_sharded_perm``
    draws alike on one shard."""
    order = np_rng.permutation(n) if np_rng is not None else np.arange(n)
    total = n_batches * batch_size
    if total > n:
        # Cyclic wrap-pad: handles batch_size > n too.
        order = np.concatenate([order, np.resize(order, total - n)])
    return order.reshape(n_batches, batch_size).astype(np.int32)


def shard_layout(n: int, n_devices: int) -> tuple[int, np.ndarray, np.ndarray]:
    """(n_loc, offsets, counts): balanced contiguous row assignment.

    Shard d owns rows [offsets[d], offsets[d]+counts[d]) of the original
    array, with counts differing by at most one, so no shard is empty for
    n >= D. Each shard's rows are wrap-padded to the common n_loc slots."""
    d = n_devices
    if d > 1 and n < d:
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


class DeviceDataset:
    """This rank's slot block of a split on ``device``: with a ``mesh``
    whose data axis has D > 1 ranks, its ``n_loc`` rows of the shard_layout
    grid (a device-resident split, the poisoning preps', is gathered on its
    device, never through the host); otherwise the whole split, adopted as
    it is. ``n`` is the whole split's row count; ``group`` is the data
    axis's process group where D > 1, None otherwise."""

    def __init__(self, data: ArraySet, device: torch.device, mesh: Mesh | None = None):
        self.n, self.device = len(data.labels), device
        self.d = mesh.shape["data"] if mesh is not None else 1
        self.index = mesh.data_index if self.d > 1 else 0
        self.group = mesh.data_group if self.d > 1 else None
        feats, labels, ind = data.feats, np.asarray(data.labels), data.indicators
        if self.d > 1:
            n_loc = shard_layout(self.n, self.d)[0]
            rows = pad_rows_index(self.n, self.d)[self.index * n_loc:(self.index + 1) * n_loc]
            if isinstance(feats, torch.Tensor):
                feats = feats.index_select(0, torch.from_numpy(rows).to(feats.device))
            else:
                feats = np.asarray(feats)[rows]
            labels, ind = labels[rows], None if ind is None else np.asarray(ind)[rows]
        feats = feats if isinstance(feats, torch.Tensor) else torch.from_numpy(np.asarray(feats))
        self.feats = feats.to(device=device, dtype=torch.float32)
        self.labels = torch.as_tensor(labels, dtype=torch.int64).to(device)
        ind = ind if ind is not None else np.zeros(len(labels), np.int64)
        self.indicators = torch.as_tensor(np.asarray(ind), dtype=torch.int64).to(device)

    def __len__(self):
        return self.n

    def n_batches(self, batch_size: int) -> int:
        return -(-shard_layout(self.n, self.d)[0] // (batch_size // self.d))

    def batches(self, batch_size: int, np_rng: np.random.Generator | None):
        """This rank's (perm, mask) on the device, (n_batches, B/D) each, and
        every batch's loss denominator (n_batches,): its real rows on all
        ranks, at least 1, in float32. All three from the full plan every
        rank draws alike from ``np_rng``, in one upload."""
        perm, mask, _ = make_sharded_perm(np_rng, self.n, self.d, batch_size)
        b = perm.shape[2]
        den = np.maximum(mask.sum(axis=(1, 2)), 1)
        plan = to_device(np.concatenate([perm[:, self.index], mask[:, self.index], den[:, None]], axis=1,
                                        dtype=np.int64), self.device)
        return plan[:, :b], plan[:, b:2 * b] != 0, plan[:, 2 * b].to(torch.float32)

    def plan(self, batch_size: int, np_rng: np.random.Generator | None):
        """(perm, mask) of ``batches``."""
        return self.batches(batch_size, np_rng)[:2]


def _loss(logits, labels, mask, den) -> torch.Tensor:
    """This rank's masked loss sum over ``den``, the global batch's real
    rows: the ranks' losses (and gradients) sum to the global batch's, and
    on one rank it is ``masked_mean``, bit for bit."""
    return (cross_entropy(logits, labels) * mask.to(torch.float32)).sum() / den


def _summary(totals: torch.Tensor, n_batches: int, group) -> tuple[np.ndarray, np.ndarray]:
    """The epoch's one host read, after one all-reduce over ``group`` where
    there is one: ``totals`` (the batch losses, then the metric sums, in
    float64) as (the batch losses in float32, the sums)."""
    if group is not None:
        dist.all_reduce(totals, group=group)
    totals = to_host(totals)
    return totals[:n_batches].astype(np.float32), totals[n_batches:].astype(np.int64)


def run_train_epoch(model, opt, dset: DeviceDataset, batch_size: int, np_rng) -> dict:
    """One training pass in train mode on this rank's rows; every rank of
    the data axis calls it alike. ``opt`` is any optimizer of
    train/state.py (``opt.params``, ``opt.step(grads)``)."""
    with span("train_epoch"):
        model.train()
        with span("plan"):
            perm, mask, den = dset.batches(batch_size, np_rng)
        n = perm.shape[0]
        totals = torch.zeros(n + 4, dtype=torch.float64, device=dset.device)
        for i in range(n):
            with span("train_step"):
                idx, bmask = perm[i], mask[i]
                labels = dset.labels[idx]
                with span("forward"):
                    logits = model(dset.feats[idx])
                with span("loss"):
                    loss = _loss(logits, labels, bmask, den[i])
                with span("backward"):
                    grads = torch.autograd.grad(loss, opt.params)
                with span("optimizer"):
                    opt.step(grads if dset.group is None else all_reduce_flat(list(grads), dset.group))
                with span("metrics"):
                    totals[i] = loss.detach()
                    totals[n:] += metric_sums(logits.detach(), labels, dset.indicators[idx], bmask)
        with span("summary"):
            losses, s = _summary(totals, n, dset.group)
    return {
        "loss": float(losses.mean()),
        "mix_acc": 100.0 * s[0] / max(s[1], 1),
        "asr": 100.0 * s[2] / max(s[3], 1),
    }


@torch.no_grad()
def run_eval_epoch(model, dset: DeviceDataset, batch_size: int) -> dict:
    with span("eval_epoch"):
        model.eval()
        with span("plan"):
            perm, mask, den = dset.batches(batch_size, None)
        n = perm.shape[0]
        totals = torch.zeros(n + 4, dtype=torch.float64, device=dset.device)
        for i in range(n):
            with span("eval_step"):
                idx, bmask = perm[i], mask[i]
                labels = dset.labels[idx]
                with span("forward"):
                    logits = model(dset.feats[idx])
                with span("metrics"):
                    totals[i] = _loss(logits, labels, bmask, den[i])
                    totals[n:] += metric_sums(logits, labels, dset.indicators[idx], bmask)
        with span("summary"):
            losses, s = _summary(totals, n, dset.group)
    return {
        "loss": float(losses.mean()),
        "acc": 100.0 * s[0] / max(s[1], 1),
        "asr": 100.0 * s[2] / max(s[3], 1),
        "sums": s,  # [correct, total, asr_correct, poison_total]
    }


def ShardedDeviceDataset(data: ArraySet, mesh: Mesh, device: torch.device) -> DeviceDataset:
    """``DeviceDataset`` on ``mesh``'s data axis (benchmark/drivers imports
    this name)."""
    return DeviceDataset(data, device, mesh)


# The benchmark's drivers import these names.
run_train_epoch_sharded = run_train_epoch
run_eval_sharded = run_eval_epoch
