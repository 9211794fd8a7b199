"""The attack-training orchestrator, single device (port of
audiobd_tpu/train/trainer.py:143-392).

Build the model and Adam, keep every split on the device, run epochs with
early stopping on ``0.5*(clean_test_loss + bd_test_loss)`` (reference
badnets.py:156; model selection deliberately uses the attacked test set,
SURVEY §6b.10), write the loss/acc CSVs and the best model's checkpoint.
Not ported: the curve PNGs (plots need matplotlib), ``--resume`` and
``--profile_dir``.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any

import torch

from audiobd_tpu_torch.configs import AttackConfig, linear_features_for
from audiobd_tpu_torch.models import build_model
from audiobd_tpu_torch.train.checkpoint import save_checkpoint
from audiobd_tpu_torch.train.loop import ArraySet, EarlyStopping
from audiobd_tpu_torch.train.scan_epoch import DeviceDataset, run_eval_epoch, run_train_epoch
from audiobd_tpu_torch.train.state import Adam
from audiobd_tpu_torch.utils import random as rnd
from audiobd_tpu_torch.utils.device import resolve_device
from audiobd_tpu_torch.utils.logging import save_attack_csvs


@dataclass
class TrainResult:
    history: dict[str, list] = field(default_factory=dict)
    model: Any = None
    epochs_ran: int = 0
    clips_per_sec: float = 0.0


def resolve_fused_conv(cfg: AttackConfig, device: torch.device) -> bool:
    """'auto' → the kernel-backward first block on CUDA only."""
    mode = cfg.train.fused_conv_block
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"fused_conv_block must be auto, on or off, got {mode!r}")
    return mode == "on" or (mode == "auto" and device.type == "cuda")


def resolve_fused_block2(cfg: AttackConfig, field: str = "fused_block2") -> bool:
    """'on' → the kernel-backward second (or third, ``field="fused_block3"``)
    block; 'auto' and 'off' → off, as the reference (trainer.py:68-76)
    keeps it until measurements say otherwise."""
    mode = getattr(cfg.train, field)
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"{field} must be auto, on or off, got {mode!r}")
    return mode == "on"


def resolve_compute_dtype(cfg: AttackConfig) -> torch.dtype:
    """TrainConfig.compute_dtype → the models' torch dtype (the reference's
    trainer.py:81: bf16 activations and matmuls, f32 parameters, BN
    statistics and loss)."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if cfg.train.compute_dtype not in dtypes:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {cfg.train.compute_dtype!r}")
    return dtypes[cfg.train.compute_dtype]


def build_attack_model(cfg: AttackConfig, device: torch.device):
    return build_model(
        cfg.model, cfg.num_classes, linear_features_for(cfg.name, cfg.model), device,
        cfg.train.seed, n_mfcc=cfg.dsp.n_mfcc, fused=resolve_fused_conv(cfg, device),
        fused_block2=resolve_fused_block2(cfg), fused_block3=resolve_fused_block2(cfg, "fused_block3"),
        compute_dtype=resolve_compute_dtype(cfg),
    )


def train_attack(
    cfg: AttackConfig,
    bd_train: ArraySet,
    clean_test: ArraySet,
    bd_test: ArraySet,
    verbose: bool = True,
    save: bool = True,
) -> TrainResult:
    device = resolve_device(cfg.device)
    model = build_attack_model(cfg, device)
    opt = Adam(model.parameters(), cfg.train.learning_rate)
    d_train = DeviceDataset(bd_train, device)
    d_clean = DeviceDataset(clean_test, device)
    d_bd = DeviceDataset(bd_test, device)

    record_dir = cfg.record_dir
    model_spec = {
        "attack": cfg.name,
        "model": cfg.model,
        "num_classes": cfg.num_classes,
        "feature_size": linear_features_for(cfg.name, cfg.model),
        "n_mfcc": cfg.dsp.n_mfcc,
        "dataset": cfg.dataset,
        "batch_size": cfg.train.batch_size,
    }
    best: dict[str, torch.Tensor] = {}

    def keep_best():
        best.update({k: v.detach().clone() for k, v in model.state_dict().items()})

    stopper = EarlyStopping(cfg.train.patience, save_fn=keep_best, verbose=verbose)
    np_rng = rnd.np_rng(cfg.train.seed, "shuffle")
    history: dict[str, list] = {
        k: []
        for k in (
            "train_loss", "train_mix_acc", "train_asr",
            "test_clean_loss", "test_bd_loss", "test_clean_acc", "test_asr",
        )
    }

    n_clips = 0
    epochs_ran = 0
    t_start = time.perf_counter()
    try:
        for epoch in range(1, cfg.train.num_epochs + 1):
            tr = run_train_epoch(model, opt, d_train, cfg.train.batch_size, np_rng)
            ev_clean = run_eval_epoch(model, d_clean, cfg.train.batch_size)
            ev_bd = run_eval_epoch(model, d_bd, cfg.train.batch_size)
            n_clips += len(d_train)
            epochs_ran = epoch

            history["train_loss"].append(tr["loss"])
            history["train_mix_acc"].append(tr["mix_acc"])
            history["train_asr"].append(tr["asr"])
            history["test_clean_loss"].append(ev_clean["loss"])
            history["test_bd_loss"].append(ev_bd["loss"])
            history["test_clean_acc"].append(ev_clean["acc"])
            history["test_asr"].append(ev_bd["asr"])

            monitored = 0.5 * (ev_clean["loss"] + ev_bd["loss"])
            if verbose:
                print(
                    f"Epoch {epoch}: Train loss: {tr['loss']:.4f}, Train asr: {tr['asr']:.4f}, "
                    f"Clean acc: {ev_clean['acc']:.4f}, ASR: {ev_bd['asr']:.4f}"
                )
            if stopper(monitored):
                if verbose:
                    print("Early stopping")
                break
    finally:
        # Write the best state even when training is unwinding from an error.
        if save and best:
            save_checkpoint(record_dir, best, model_spec)
    wall = time.perf_counter() - t_start

    if save:
        os.makedirs(record_dir, exist_ok=True)
        save_attack_csvs(record_dir, history)
    return TrainResult(
        history=history, model=model, epochs_ran=epochs_ran,
        clips_per_sec=n_clips / max(wall, 1e-9),
    )
