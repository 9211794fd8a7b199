"""Fine-Pruning defense (port of audiobd_tpu/defend/fp.py; reference
fp.py:36-210).

1. Profile the input activations of the final classifier on the first
   validation batch, divided by the whole split's size (the reference's
   accumulation flag makes only the first batch contribute, fp.py:139-147;
   quirk kept via ``first_batch_only=True``).
2. Zero the lowest-activation input channels of the final linear layer,
   ``once_prune_ratio`` of them more per level, testing clean acc + ASR at
   each level; stop at the first level whose relative clean-acc drop exceeds
   ``acc_ratio``; log pruning_data.csv. The reference evaluates every level
   in one vmapped program (audiobd_tpu/defend/fp.py:82-134); here the levels
   are walked until the break, so only the rows the CSV holds are computed.
3. Fine-tune one epoch on the 5% clean-val split (Adam ``lr_ft``) with the
   prune mask re-applied after it, then full test; log ft_data.csv.
"""

from __future__ import annotations

import functools
import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from audiobd_tpu_torch.configs import AttackConfig
from audiobd_tpu_torch.defend.common import (
    DefenseData,
    State,
    finetune_epochs,
    load_bd_model,
    load_defense_data,
    make_full_tester,
    on_device,
)
from audiobd_tpu_torch.models.zoo import final_layer_inputs
from audiobd_tpu_torch.train.scan_epoch import DeviceDataset, run_eval_epoch
from audiobd_tpu_torch.train.state import Adam
from audiobd_tpu_torch.utils.logging import append_csv_row, prepend_csv_header, remove_file


def final_layer_name(model) -> str:
    """The state_dict key of the final classifier's weight (out, in)."""
    return f"{model.final_layer}.weight"


@torch.no_grad()
def profile_activations(model, state: State, data: DeviceDataset, batch_size: int,
                        first_batch_only: bool = True) -> np.ndarray:
    """Mean input activation of the final classifier over the val set, f32,
    summed on the host as the reference sums it (batches in order, pad rows
    dropped, each batch's column sums divided by the split's size)."""
    model.load_state_dict(state)
    model.eval()
    n = len(data)
    perm, mask = data.plan(min(batch_size, n), None)
    acc = None
    for idx, bmask in zip(perm, mask):
        with final_layer_inputs(model) as seen:
            model(data.feats[idx])
        if len(seen) != 1:
            raise RuntimeError(f"the final layer {model.final_layer!r} ran {len(seen)} times in one forward")
        feats = seen[0].cpu().numpy()[bmask.cpu().numpy()]
        contrib = feats.sum(axis=0) / n
        acc = contrib if acc is None else acc + contrib
        if first_batch_only:
            break
    return acc


def prune_level(model, state: State, layer: str, seq_sort: np.ndarray, level: int, clean_test: DeviceDataset,
                bd_test: DeviceDataset, batch_size: int) -> tuple[float, float]:
    """(clean acc, ASR-as-acc on ``bd_test``), fractions, with the input
    channels of rank < level − 1 in ``seq_sort`` (least active first)
    zeroed: the reference's level L prunes seq_sort[:L-1], and none at 0."""
    kernel0 = state[layer]
    rank = torch.empty(kernel0.shape[1], dtype=torch.long)
    rank[torch.from_numpy(seq_sort)] = torch.arange(kernel0.shape[1])
    pruned = (rank < level - 1).to(kernel0.device)
    model.load_state_dict({**state, layer: torch.where(pruned[None, :], 0.0, kernel0)})
    fractions = []
    for dset in (clean_test, bd_test):
        s = run_eval_epoch(model, dset, min(batch_size, len(dset)))["sums"]
        fractions.append(s[0] / max(s[1], 1))
    return fractions[0], fractions[1]


@dataclass
class FPResult:
    pruned_channels: int
    test_acc: float
    test_asr: float
    history: list


def mitigation(
    cfg: AttackConfig,
    val_ratio: float = 0.05,
    acc_ratio: float = 0.1,
    once_prune_ratio: float = 0.01,
    lr_ft: float = 0.01,
    first_batch_only: bool = True,
    data: DefenseData | None = None,
    verbose: bool = True,
) -> FPResult:
    save_dir = os.path.join(cfg.record_dir, "defense", "fp")
    model, state, _spec = load_bd_model(cfg)
    data = on_device(data or load_defense_data(cfg, val_ratio), next(model.parameters()).device)
    bs = cfg.train.batch_size

    activation = profile_activations(model, state, data.clean_val, bs, first_batch_only)
    seq_sort = np.argsort(activation)  # ascending: least-active first

    layer = final_layer_name(model)
    n_channels = state[layer].shape[1]  # the classifier's inputs
    if n_channels != len(seq_sort):
        raise RuntimeError(f"{layer} takes {n_channels} inputs, the profile has {len(seq_sort)}")

    full_tester = make_full_tester(model, bs)
    csv_path = os.path.join(save_dir, "pruning_data.csv")
    remove_file(csv_path)

    step_size = math.ceil(n_channels * once_prune_ratio)
    # The reference's break rule (fp.py:164-195): rows are logged up to and
    # including the first level whose relative clean-acc drop exceeds acc_ratio.
    test_acc_ori = None
    last_index = 0
    history = []
    for num_pruned in range(0, n_channels, step_size):
        test_acc, test_asr = prune_level(model, state, layer, seq_sort, num_pruned, data.clean_test,
                                         data.bd_test, bs)
        history.append((num_pruned, num_pruned / n_channels, test_acc, test_asr))
        append_csv_row(csv_path, [num_pruned, num_pruned / n_channels, test_acc, test_asr])
        if verbose:
            print(f"Pruned {num_pruned}/{n_channels}: acc {100*test_acc:.2f}, asr {100*test_asr:.2f}")
        if num_pruned == 0:
            test_acc_ori = test_acc
        elif abs(test_acc - test_acc_ori) / max(test_acc_ori, 1e-9) < acc_ratio:
            last_index = num_pruned
        else:
            break
    prepend_csv_header(csv_path, ["num_pruned", "pruning_ratio", "test_acc", "test_asr"])

    keep = torch.ones(n_channels, device=state[layer].device)
    if last_index:
        keep[torch.from_numpy(seq_sort[: last_index - 1]).to(keep.device)] = 0.0
        state = {**state, layer: state[layer] * keep}

    @torch.no_grad()
    def project(m):
        if last_index:
            getattr(m, m.final_layer).weight.mul_(keep)

    ft_state, _ = finetune_epochs(
        model, state, data.clean_val, functools.partial(Adam, lr=lr_ft), epochs=1, batch_size=bs,
        seed=cfg.train.seed, project=project,
    )
    clean_acc, asr, clean_loss, bd_loss = full_tester(ft_state, data.clean_test, data.bd_test_complete)
    if verbose:
        print(f"End Ftune. test_clean_acc:{clean_acc:.2f}  test_asr:{asr:.2f}")
    ft_csv = os.path.join(save_dir, "ft_data.csv")
    append_csv_row(ft_csv, ["test_clean_acc", "test_asr", "clean_test_loss", "bd_test_loss"])
    append_csv_row(ft_csv, [clean_acc, asr, clean_loss, bd_loss])
    return FPResult(last_index, clean_acc, asr, history)
