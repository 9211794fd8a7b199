"""Unlearning correlation analysis (port of audiobd_tpu/defend/correlation.py;
reference correlation_analysis.py:41-172).

Unlearn two copies of the attacked model — one on clean-test data, one on
backdoored-test data (the same shuffled index subset) — compute each copy's
per-neuron weight change (NWC) against the original, and report the Pearson
correlation between the two NWC vectors (the TSBD paper's motivating
evidence), with a CSV, and a scatter plot where matplotlib is installed.
Each unlearning epoch is one ascent step, on the first batch of that
epoch's shuffle (the reference's first-batch quirk), by the eval-mode
model: kernel B's eval mode on the card.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from audiobd_tpu_torch.configs import AttackConfig
from audiobd_tpu_torch.defend.common import (
    DefenseData,
    State,
    load_bd_model,
    load_defense_data,
    neuron_weight_changes,
    snapshot,
)
from audiobd_tpu_torch.defend.tsbd import default_record_layer, unlearn_step
from audiobd_tpu_torch.train.loop import ArraySet
from audiobd_tpu_torch.train.scan_epoch import DeviceDataset
from audiobd_tpu_torch.train.state import Adam
from audiobd_tpu_torch.utils import random as rnd
from audiobd_tpu_torch.utils.logging import write_csv
from audiobd_tpu_torch.utils.visual import save_or_show


def unlearn_copy(model, state_o: State, data: DeviceDataset, record_layer: str, lr: float, epochs: int, bs: int,
                 seed: int, first_batch_only: bool = True) -> State:
    """The state after ``epochs`` epochs of Adam ascent from ``state_o``, the
    batches from ``np_rng(seed, "corr_unlearn")``."""
    model.load_state_dict(state_o)
    opt = Adam(model.parameters(), lr)
    np_rng = rnd.np_rng(seed, "corr_unlearn")
    for _ in range(epochs):
        perm, mask = data.plan(min(bs, len(data)), np_rng)
        for idx, bmask in zip(perm, mask):
            unlearn_step(model, opt, data.feats[idx], data.labels[idx], bmask, record_layer)
            if first_batch_only:
                break
    return snapshot(model)


@dataclass
class CorrelationResult:
    pearson_r: float
    clean_nwc: np.ndarray
    bd_nwc: np.ndarray


def analyze(
    cfg: AttackConfig,
    lr_un: float = 1e-4,
    unlearn_epochs: int = 10,
    subset: int | None = None,
    data: DefenseData | None = None,
    verbose: bool = True,
) -> CorrelationResult:
    save_dir = os.path.join(cfg.record_dir, "defense", "correlation")
    data = data or load_defense_data(cfg)
    model, state_o, _spec = load_bd_model(cfg)
    device = next(model.parameters()).device
    bs = cfg.train.batch_size
    record_layer = default_record_layer(state_o)

    # The same shuffled subset indices for both sides (the reference uses
    # the same shuffled index lists for the clean and bd loaders).
    rng = rnd.np_rng(cfg.train.seed, "corr_subset")
    n = min(len(data.clean_test), len(data.bd_test))
    idx = rng.permutation(n)[: subset or n]
    clean_sub = DeviceDataset(ArraySet(data.clean_test.feats[idx], data.clean_test.labels[idx]), device)
    bd_sub = DeviceDataset(ArraySet(data.bd_test.feats[idx], data.bd_test.labels[idx]), device)

    p_clean = unlearn_copy(model, state_o, clean_sub, record_layer, lr_un, unlearn_epochs, bs, cfg.train.seed)
    p_bd = unlearn_copy(model, state_o, bd_sub, record_layer, lr_un, unlearn_epochs, bs, cfg.train.seed)

    nwc_clean, _ = neuron_weight_changes(p_clean, state_o, "conv")
    nwc_bd, _ = neuron_weight_changes(p_bd, state_o, "conv")
    v_clean = np.asarray([rec[2] for rec in nwc_clean])
    v_bd = np.asarray([rec[2] for rec in nwc_bd])
    r = float(np.corrcoef(v_clean, v_bd)[0, 1])

    write_csv(
        os.path.join(save_dir, "nwc_correlation.csv"),
        ["layer", "neuron", "clean_nwc", "bd_nwc"],
        [(rec[0], rec[1], rec[2], b[2]) for rec, b in zip(nwc_clean, nwc_bd)],
    )
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure(figsize=(6, 6))
        plt.scatter(v_clean, v_bd, s=12, alpha=0.6)
        plt.xlabel("NWC (clean unlearning)")
        plt.ylabel("NWC (backdoor unlearning)")
        plt.title(f"Pearson r = {r:.3f}")
        save_or_show(plt, os.path.join(save_dir, "nwc_scatter.png"))
    except ImportError as e:
        print(f"plot skipped: {e}")
    if verbose:
        print(f"NWC Pearson correlation: {r:.4f}")
    return CorrelationResult(r, v_clean, v_bd)
