"""Device-resident epochs (port of the single-device part of
audiobd_tpu/train/scan_epoch.py).

Every split lives on the device for the whole run. An epoch is a device
loop over batches (gather by permuted indices → step); per-batch losses and
metric sums stay on the device until the epoch ends, so there is one host
sync per epoch. The batch order is the reference's: the same ``make_perm``
on the same ``np_rng`` stream.
"""

from __future__ import annotations

import numpy as np
import torch

from audiobd_tpu_torch.train.loop import ArraySet, cross_entropy, masked_mean, metric_sums


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

    def plan(self, batch_size: int, np_rng: np.random.Generator | None):
        """(perm, mask) on the device, (n_batches, batch_size) each."""
        n_batches, mask = pad_plan(self.n, batch_size)
        perm = make_perm(np_rng, self.n, n_batches, batch_size)
        return (
            torch.from_numpy(perm.astype(np.int64)).to(self.device),
            torch.from_numpy(mask).to(self.device),
        )


def _summary(losses: torch.Tensor, sums: torch.Tensor) -> tuple[float, np.ndarray]:
    """The epoch's one host sync: mean of batch-mean losses and the sums."""
    losses = losses.cpu().numpy()
    return float(losses.mean()), sums.cpu().numpy()


def run_train_epoch(model, opt, dset: DeviceDataset, batch_size: int, np_rng) -> dict:
    """One training pass in train mode; ``opt`` is any optimizer of
    train/state.py (``opt.params``, ``opt.step(grads)``)."""
    model.train()
    perm, mask = dset.plan(batch_size, np_rng)
    losses = torch.empty(perm.shape[0], dtype=torch.float32, device=dset.device)
    sums = torch.zeros(4, dtype=torch.int64, device=dset.device)
    for i in range(perm.shape[0]):
        idx, bmask = perm[i], mask[i]
        labels = dset.labels[idx]
        logits = model(dset.feats[idx])
        loss = masked_mean(cross_entropy(logits, labels), bmask)
        opt.step(torch.autograd.grad(loss, opt.params))
        losses[i] = loss.detach()
        sums += metric_sums(logits.detach(), labels, dset.indicators[idx], bmask)
    loss, s = _summary(losses, sums)
    return {
        "loss": loss,
        "mix_acc": 100.0 * s[0] / max(s[1], 1),
        "asr": 100.0 * s[2] / max(s[3], 1),
    }


@torch.no_grad()
def run_eval_epoch(model, dset: DeviceDataset, batch_size: int) -> dict:
    model.eval()
    perm, mask = dset.plan(batch_size, None)
    losses = torch.empty(perm.shape[0], dtype=torch.float32, device=dset.device)
    sums = torch.zeros(4, dtype=torch.int64, device=dset.device)
    for i in range(perm.shape[0]):
        idx, bmask = perm[i], mask[i]
        labels = dset.labels[idx]
        logits = model(dset.feats[idx])
        losses[i] = masked_mean(cross_entropy(logits, labels), bmask)
        sums += metric_sums(logits, labels, dset.indicators[idx], bmask)
    loss, s = _summary(losses, sums)
    return {
        "loss": loss,
        "acc": 100.0 * s[0] / max(s[1], 1),
        "asr": 100.0 * s[2] / max(s[3], 1),
        "sums": s,  # [correct, total, asr_correct, poison_total]
    }
