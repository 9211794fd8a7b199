"""Early-stopped training of K independent members (port of the semantics of
audiobd_tpu/train/ensemble.py).

FlowMur trains three surrogate SmallCNNs (reference
utils/flowmur_generate_trigger.py:15-47). The JAX package trains them
together as one vmapped program; here they train one after another, which
is its ``parallel=False`` path (audiobd_tpu/poison/flowmur.py:117-143).
Each member has its own init and dropout generators and its own shuffle
stream, so member i reproduces a solo run with the same generators exactly,
as the JAX ensemble promises to float tolerance. Training the members
together (stacked weights) is ROADMAP work.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn as nn

from audiobd_tpu_torch.train.loop import EarlyStopping
from audiobd_tpu_torch.train.scan_epoch import DeviceDataset, run_eval_epoch, run_train_epoch
from audiobd_tpu_torch.train.state import Adam


@dataclass
class MemberResult:
    state: dict[str, torch.Tensor]  # the best (lowest validation loss) state_dict
    epochs_to_best: int = 0
    history: dict[str, list] = field(default_factory=dict)  # train_loss, val_loss, val_acc by epoch


def train_member(
    model: nn.Module,
    train_set: DeviceDataset,
    val_set: DeviceDataset,
    shuffle_rng: np.random.Generator,
    *,
    lr: float,
    batch_size: int,
    max_epochs: int,
    patience: int = 20,
    verbose: bool = False,
    label: str = "member",
) -> MemberResult:
    """Adam(lr) epochs until ``patience`` epochs pass without a lower
    validation loss (train/loop.py::EarlyStopping) or ``max_epochs``."""
    opt = Adam(model.parameters(), lr)
    result = MemberResult(state={}, history={"train_loss": [], "val_loss": [], "val_acc": []})
    epoch = 0

    def keep_best():
        result.state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        result.epochs_to_best = epoch

    stopper = EarlyStopping(patience, save_fn=keep_best, verbose=False)
    for epoch in range(1, max_epochs + 1):
        tr = run_train_epoch(model, opt, train_set, batch_size, shuffle_rng)
        ev = run_eval_epoch(model, val_set, batch_size)
        result.history["train_loss"].append(tr["loss"])
        result.history["val_loss"].append(ev["loss"])
        result.history["val_acc"].append(ev["acc"])
        if verbose and epoch % 10 == 0:
            print(f"{label} epoch {epoch}: val acc {ev['acc']:.2f}")
        if stopper(ev["loss"]):
            break
    return result

