"""Losses, metrics and early stopping (port of audiobd_tpu/train/loop.py).

Reference semantics (utils/training_tools.py:52-134):
  * train metrics: batch-mean CE loss averaged over batches, mixed accuracy
    over all rows, train-ASR = target-hit rate over poison_indicator==1 rows
    (their labels are already flipped to the target; SURVEY §6b.7);
  * test: clean accuracy over the clean split, ASR over indicator==1 rows of
    the backdoored split, losses as the mean of batch means.
Every batch has the static batch size: the tail batch is wrap-padded and
the pad rows are masked out of loss and metrics.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row softmax cross-entropy, always in float32."""
    return F.cross_entropy(logits.float(), labels, reduction="none")


def masked_mean(per_row: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    fm = mask.to(torch.float32)
    return (per_row * fm).sum() / torch.clamp(fm.sum(), min=1.0)


def metric_sums(logits, labels, indicators, mask) -> torch.Tensor:
    """[correct, total, asr_correct, poison_total] over the unmasked rows."""
    hit = (logits.argmax(dim=-1) == labels) & mask
    poison = (indicators == 1) & mask
    return torch.stack([hit.sum(), mask.sum(), (hit & poison).sum(), poison.sum()])


@dataclasses.dataclass
class ArraySet:
    """A dataset split as dense arrays: feats host numpy or a device tensor
    (the poisoning prep returns device tensors so DeviceDataset adopts them
    without a host round trip)."""

    feats: np.ndarray | torch.Tensor  # (N, 1, frames, n_mfcc)
    labels: np.ndarray                # (N,)
    indicators: np.ndarray | None = None  # (N,) 1 where poisoned

    def __len__(self):
        return len(self.feats)


class EarlyStopping:
    """Patience-based early stopping (reference utils/training_tools.py:4-50).

    ``save_fn`` is invoked whenever the monitored loss improves, so the
    checkpoint holds the *best* model, which the defenses load."""

    def __init__(self, patience: int = 20, delta: float = 0.0, save_fn=None, verbose: bool = True):
        self.patience = patience
        self.delta = delta
        self.save_fn = save_fn
        self.verbose = verbose
        self.best: float | None = None
        self.counter = 0
        self.should_stop = False

    def __call__(self, value: float) -> bool:
        improved = self.best is None or value < self.best - self.delta
        if improved:
            self.best = value
            self.counter = 0
            if self.save_fn is not None:
                self.save_fn()
        else:
            self.counter += 1
            if self.verbose:
                print(f"EarlyStopping counter: {self.counter} out of {self.patience}")
            if self.counter >= self.patience:
                self.should_stop = True
        return self.should_stop
