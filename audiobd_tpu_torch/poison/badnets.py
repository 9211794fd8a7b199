"""BadNets: feature-domain square-patch trigger (port of
audiobd_tpu/poison/badnets.py).

  * trigger = (1, frames, n_mfcc) zeros with the bottom-right ``size``²
    block set to −200 (the MFCC log-domain floor): the last time frames ×
    the highest coefficients;
  * train: a ``rate`` fraction of rows drawn by ``np_rng(seed,
    "badnets_poison")`` get the patch and label → target; test: every
    non-target-class row is patched, all labels → target.
The patch is one ``torch.where`` over each split on the device.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from audiobd_tpu_torch.configs import AttackConfig
from audiobd_tpu_torch.data.speech_commands import CleanData
from audiobd_tpu_torch.parallel.distributed import main_rank_only
from audiobd_tpu_torch.train.loop import ArraySet
from audiobd_tpu_torch.utils import random as rnd
from audiobd_tpu_torch.utils.device import resolve_device
from audiobd_tpu_torch.utils.logging import save_npy


def generate_trigger(
    n_mfcc: int,
    frames: int,
    square_size: int,
    distance_to_right: int = 0,
    distance_to_bottom: int = 0,
    value: float = -200.0,
    save_path: str | None = None,
) -> np.ndarray:
    """Square patch at the bottom-right of the (1, frames, n_mfcc) feature map."""
    trig = np.zeros((1, frames, n_mfcc), dtype=np.float32)
    r0 = frames - distance_to_bottom - square_size
    r1 = frames - distance_to_bottom
    c0 = n_mfcc - distance_to_right - square_size
    c1 = n_mfcc - distance_to_right
    trig[:, r0:r1, c0:c1] = value
    if save_path:
        save_npy(save_path, trig)
    return trig


def apply_trigger(mfcc: torch.Tensor, trigger: torch.Tensor) -> torch.Tensor:
    """Overwrite feature cells where the trigger is nonzero; batched."""
    return torch.where(trigger != 0, trigger, mfcc)


def _patch_indicated(feats: torch.Tensor, ind: torch.Tensor, trigger: torch.Tensor) -> torch.Tensor:
    return torch.where(ind[:, None, None, None] == 1, apply_trigger(feats, trigger), feats)


@dataclass
class PoisonedData:
    bd_train: ArraySet
    bd_test: ArraySet
    clean_test: ArraySet


def poison_indices(cfg: AttackConfig, n_train: int) -> np.ndarray:
    """The poisoned training rows (reference badnets.py:149-156)."""
    rng = rnd.np_rng(cfg.train.seed, "badnets_poison")
    return rng.choice(n_train, size=int(n_train * cfg.poisoning_rate), replace=False)


def poison(cfg: AttackConfig, clean: CleanData, save: bool = True) -> PoisonedData:
    """Build the poisoned splits on ``cfg.device``; the npy contract
    (reference badnets.py:78-95) is written from them once."""
    device = resolve_device(cfg.device)
    frames, n_mfcc = clean.train_mfcc.shape[-2], clean.train_mfcc.shape[-1]
    trig = generate_trigger(
        n_mfcc, frames, cfg.trigger_size,
        save_path=os.path.join(cfg.record_dir, "resources", "BadNets", "trigger.npy") if save else None,
    )
    trig_t = torch.from_numpy(trig).to(device)

    n_train = len(clean.train_mfcc)
    poison_idx = poison_indices(cfg, n_train)
    ind_train = np.zeros(n_train, dtype=np.int64)
    ind_train[poison_idx] = 1
    bd_train_label = clean.train_label.copy()
    bd_train_label[poison_idx] = cfg.target_label

    # Test: patch every non-target row; all labels flipped to the target
    # (reference badnets.py:66-77).
    ind_test = (clean.test_label != cfg.target_label).astype(np.int64)
    bd_test_label = np.full(len(clean.test_label), cfg.target_label, dtype=np.int64)

    t0 = time.perf_counter()

    def on_device(dev, host):
        return dev.to(device) if dev is not None else torch.from_numpy(host).to(device)

    feats_train = on_device(clean.train_mfcc_dev, clean.train_mfcc)
    feats_test = on_device(clean.test_mfcc_dev, clean.test_mfcc)
    bd_train_mfcc = _patch_indicated(feats_train, torch.from_numpy(ind_train).to(device), trig_t)
    bd_test_mfcc = _patch_indicated(feats_test, torch.from_numpy(ind_test).to(device), trig_t)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    n_prep = n_train + len(clean.test_label)
    dt = time.perf_counter() - t0
    print(f"badnets prep (device-resident patch): {n_prep} clips in {dt:.3f} s "
          f"({n_prep / max(dt, 1e-9):.0f} clips/s)")

    if save:
        save_bd_arrays(
            cfg,
            bd_train_mfcc=bd_train_mfcc.cpu().numpy(),
            bd_test_mfcc=bd_test_mfcc.cpu().numpy(),
            bd_train_label=bd_train_label,
            bd_test_label=bd_test_label,
            poison_index_train=ind_train,
            poison_index_test=ind_test,
        )

    return PoisonedData(
        bd_train=ArraySet(bd_train_mfcc, bd_train_label, ind_train),
        bd_test=ArraySet(bd_test_mfcc, bd_test_label, ind_test),
        clean_test=ArraySet(feats_test, clean.test_label),
    )


def bd_dir(cfg: AttackConfig) -> str:
    return os.path.join(cfg.record_dir, cfg.dataset, "bd")


@main_rank_only
def save_bd_arrays(cfg: AttackConfig, **arrays: np.ndarray) -> None:
    path = bd_dir(cfg)
    os.makedirs(path, exist_ok=True)
    for name, arr in arrays.items():
        np.save(os.path.join(path, name + ".npy"), arr)
