"""FT-reg defense: sharpness-aware fine-tuning + neuron scoring/pruning
(port of audiobd_tpu/defend/ft_reg.py; reference ft_reg.py:44-344).

1. ``reg_epochs`` epochs of the two-pass update on the 5% clean-val split,
   the model in eval mode: g1 = ∇L(θ); θ' = θ + r·g1/max(‖g1‖, 1e-12)
   (per-tensor norms of the flattened gradient); g2 = ∇L(θ'); apply
   (1−α)·g1 + α·g2 with SGD-momentum. On the card both gradients of a fused
   block 1 are kernel B's eval mode.
2. Neuron scores over conv layers, numpy float64 in the reference's neuron
   order:
   * loss-change-on-prune on the val split (``loss_changes``);
   * grad-change = ‖g_T − g_0‖ of the whole layer assigned to every neuron
     in it (quirk kept — ft_reg.py:300-303, SURVEY.md §6b.5), g_0 and g_T
     the gradient applied at the last batch of epoch 1 and of the last epoch;
   * score = invert(norm(0.9·z(grad_change) + 0.1·z(vlc))), zeroed where
     vlc > 0.
   The reference also computes the weight norms and the clean- and bd-test
   loss changes, and discards them; the port computes only what the scores
   read.
3. Zero the top-scored neurons at ratios [0.01…0.9] and report acc/ASR.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from audiobd_tpu_torch.configs import AttackConfig
from audiobd_tpu_torch.defend.common import (
    DefenseData,
    State,
    eval_loss_grads,
    flax_layout,
    load_bd_model,
    load_defense_data,
    make_full_tester,
    make_tester,
    neuron_names,
    on_device,
    snapshot,
    zero_neurons,
)
from audiobd_tpu_torch.train.scan_epoch import DeviceDataset
from audiobd_tpu_torch.train.state import SGD
from audiobd_tpu_torch.utils import random as rnd
from audiobd_tpu_torch.utils.logging import append_csv_row, prepend_csv_header, remove_file

PRUNE_RATIOS = [0.01, 0.05, 0.1, 0.15, 0.2, 0.25, 0.3, 0.4, 0.5, 0.7, 0.9]


def reg_step(model, opt: SGD, x, y, mask, r: float, alpha: float) -> list[torch.Tensor]:
    """One sharpness-aware step (make_reg_step, ft_reg.py:48-66); returns
    the applied gradient, in ``model.parameters()`` order."""
    _, _, g1 = eval_loss_grads(model, x, y, mask)
    with torch.no_grad():
        perturbed = [(p + r * g / torch.clamp(torch.linalg.vector_norm(g), min=1e-12)).requires_grad_(True)
                     for p, g in zip(opt.params, g1)]
    _, _, g2 = eval_loss_grads(model, x, y, mask, params=perturbed)
    final = [(1 - alpha) * a + alpha * b for a, b in zip(g1, g2)]
    opt.step(final)
    return final


def run_reg_epoch(model, opt: SGD, dset: DeviceDataset, batch_size: int, np_rng, r: float, alpha: float):
    """One epoch of ``reg_step`` over the reference's batch plan (make_perm
    on ``np_rng``, the tail wrap-padded and masked); returns the last step's
    applied gradient."""
    perm, mask = dset.plan(batch_size, np_rng)
    final = None
    for idx, bmask in zip(perm, mask):
        final = reg_step(model, opt, dset.feats[idx], dset.labels[idx], bmask, r, alpha)
    return final


def normalize_and_invert(scores: np.ndarray) -> np.ndarray:
    lo, hi = scores.min(), scores.max()
    return 1.0 - (scores - lo) / max(hi - lo, 1e-12)


def loss_changes(model, state: State, data: DeviceDataset, neurons: list[tuple[str, int]], base_loss: float,
                 batch_size: int) -> list[float]:
    """Loss delta from zeroing each neuron alone (reference get_loss_change,
    ft_reg.py:179-190): the eval loss, a mean of per-batch masked means in
    ``iter_batches(shuffle=False)`` order, of the state with that output
    channel zeroed, minus ``base_loss``."""
    tester = make_tester(model, batch_size)
    return [tester(zero_neurons(state, [neuron]), data)[0] - base_loss for neuron in neurons]


def grad_changes(grad_s: State, grad_t: State, neurons: list[tuple[str, int]]) -> np.ndarray:
    """‖g_T − g_0‖ of each neuron's whole layer (the reference's quirk), f32
    norms of the flax-layout difference."""
    norms = {layer: float(np.linalg.norm(flax_layout(grad_t[layer]) - flax_layout(grad_s[layer])))
             for layer in {layer for layer, _ in neurons}}
    return np.asarray([norms[layer] for layer, _ in neurons])


def neuron_scores(grad_change: np.ndarray, vlc: np.ndarray, w: float = 0.9) -> np.ndarray:
    """invert(norm(w·z(grad_change) + (1−w)·z(vlc))), 0 where vlc > 0
    (ft_reg.py:253-258)."""

    def zscore(v):
        return (v - v.mean()) / max(v.std(), 1e-12)

    scores = normalize_and_invert(w * zscore(grad_change) + (1 - w) * zscore(vlc))
    scores[vlc > 0] = 0.0
    return scores


@dataclass
class FTRegResult:
    per_ratio: list = field(default_factory=list)
    scores: np.ndarray | None = None


def mitigation(
    cfg: AttackConfig,
    val_ratio: float = 0.05,
    lr_ft: float = 0.001,
    reg_epochs: int = 300,
    r: float = 0.05,
    alpha: float = 0.7,
    prune_ratios: list | None = None,
    data: DefenseData | None = None,
    verbose: bool = True,
) -> FTRegResult:
    save_dir = os.path.join(cfg.record_dir, "defense", "ft_reg")
    model, state_o, _spec = load_bd_model(cfg)
    data = on_device(data or load_defense_data(cfg, val_ratio), next(model.parameters()).device)
    bs = cfg.train.batch_size
    tester = make_tester(model, bs)
    full_tester = make_full_tester(model, bs)

    # 1. sharpness-aware fine-tuning
    names = [n for n, _ in model.named_parameters()]
    opt = SGD(model.parameters(), lr_ft, momentum=0.9)
    np_rng = rnd.np_rng(cfg.train.seed, "ftreg_shuffle")
    val_bs = min(bs, len(data.clean_val))
    grad_s = grad_t = None
    for epoch in range(reg_epochs):
        last = run_reg_epoch(model, opt, data.clean_val, val_bs, np_rng, r, alpha)
        grad_t = dict(zip(names, last))
        if epoch == 0:
            grad_s = grad_t
        if verbose and (epoch % 10 == 0 or epoch + 1 == reg_epochs):
            acc, asr, _, _ = full_tester(snapshot(model), data.clean_test, data.bd_test_complete)
            print(f"ft_reg epoch {epoch + 1}: acc {acc:.2f} asr {asr:.2f}")
    params = snapshot(model)

    # 2. neuron scoring
    neurons = neuron_names(state_o, "conv")
    val_loss, _ = tester(params, data.clean_val)
    vlc = np.asarray(loss_changes(model, params, data.clean_val, neurons, val_loss, bs))
    scores = neuron_scores(grad_changes(grad_s, grad_t, neurons), vlc)

    # 3. prune at ratios
    order = np.argsort(scores)[::-1]
    csv_path = os.path.join(save_dir, "pruning_data.csv")
    remove_file(csv_path)
    per_ratio = []
    for ratio in prune_ratios or PRUNE_RATIOS:
        top = [neurons[i] for i in order[: int(ratio * len(neurons))]]
        acc, asr, closs, bloss = full_tester(zero_neurons(params, top), data.clean_test, data.bd_test_complete)
        per_ratio.append((ratio, acc, asr))
        append_csv_row(csv_path, [ratio, closs, bloss, acc, asr])
        if verbose:
            print(f"ft_reg prune {ratio}: acc {acc:.2f} asr {asr:.2f}")
    prepend_csv_header(csv_path, ["ratio", "clean_test_loss", "bd_test_loss", "test_clean_acc", "test_asr"])
    return FTRegResult(per_ratio=per_ratio, scores=scores)
