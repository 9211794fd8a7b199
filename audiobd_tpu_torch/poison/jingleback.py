"""JingleBack: stylistic audio-effect triggers (port of
audiobd_tpu/poison/jingleback.py).

The six style chains (reference utils/styles_trigger.py:8-53):
  0  PitchShift(+10 semitones)
  1  Distortion(30 dB)
  2  Chorus(1 Hz, depth 5, centre 10 ms, feedback 0, mix 0.5)
  3  PitchShift(10) → Distortion(20) → Chorus(1 Hz, 5, 8 ms)
  4  Chorus(centre 15 ms, defaults) → Distortion(20) → Reverb(room 0.6)
  5  Gain(12 dB) → LadderFilter(HPF12 @ 1 kHz) → Phaser(defaults)

Poisoning (reference jingleback.py:38-119): the train rows drawn by
``np_rng(seed, "jingleback_poison")`` are restyled, their MFCC computed
again (kernel A on the card) and merged into the device-resident clean
features, label → target; every non-target test row is restyled. Styles run
on the device in chunks of 256 rows, which bound the pitch shift's
intermediates; rows are independent, so the last chunk is not padded.
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass

import numpy as np
import torch

from audiobd_tpu_torch.configs import AttackConfig
from audiobd_tpu_torch.data.speech_commands import CleanData, batched_mfcc_device, mfcc_params
from audiobd_tpu_torch.poison import effects as fx
from audiobd_tpu_torch.poison.badnets import save_bd_arrays
from audiobd_tpu_torch.poison.device_prep import scatter_rows
from audiobd_tpu_torch.train.loop import ArraySet
from audiobd_tpu_torch.utils import random as rnd
from audiobd_tpu_torch.utils.device import resolve_device

STYLE_CHUNK = 256


def get_boards(sample_rate: int = 16000) -> list[Callable[[torch.Tensor], torch.Tensor]]:
    """Style id → callable (B, T) → (B, T)."""

    def style0(x):
        return fx.pitch_shift(x, sample_rate, 10.0)

    def style1(x):
        return fx.distortion(x, 30.0)

    def style2(x):
        return fx.chorus(x, sample_rate, rate_hz=1.0, depth=5.0, centre_delay_ms=10.0, mix=0.5)

    def style3(x):
        x = fx.pitch_shift(x, sample_rate, 10.0)
        x = fx.distortion(x, 20.0)
        return fx.chorus(x, sample_rate, rate_hz=1.0, depth=5.0, centre_delay_ms=8.0, mix=0.5)

    def style4(x):
        x = fx.chorus(x, sample_rate, centre_delay_ms=15.0)
        x = fx.distortion(x, 20.0)
        return fx.reverb(x, sample_rate, room_size=0.6)

    def style5(x):
        x = fx.gain(x, 12.0)
        x = fx.ladder_hpf12(x, sample_rate, cutoff_hz=1000.0)
        return fx.phaser(x, sample_rate)

    return [style0, style1, style2, style3, style4, style5]


def poison_style_device(wavs: np.ndarray, style: int, sample_rate: int, device: torch.device,
                        chunk: int = STYLE_CHUNK) -> torch.Tensor:
    """Style ``style`` applied to (N, 1, T) host waveforms → (N, T) on
    ``device``, ``chunk`` rows at a time."""
    board = get_boards(sample_rate)[style]
    flat = np.ascontiguousarray(wavs[:, 0, :], dtype=np.float32)
    outs = [board(torch.from_numpy(flat[s : s + chunk]).to(device)) for s in range(0, len(flat), chunk)]
    return torch.cat(outs) if outs else torch.empty((0, flat.shape[-1]), device=device)


@dataclass
class JingleBackPoisoned:
    bd_train: ArraySet
    bd_test: ArraySet
    clean_test: ArraySet


def _poison_split(clean_wav: np.ndarray, clean_mfcc: np.ndarray, clean_mfcc_dev: torch.Tensor | None,
                  idx: np.ndarray, cfg: AttackConfig, device: torch.device):
    """One split: the ``idx`` rows restyled on the device, their MFCCs
    computed there and merged into the clean features; the host npy views
    get the same rows. Returns (bd_wav host, bd_mfcc host, bd_mfcc on the
    device)."""
    bd_wav = clean_wav.copy()
    bd_mfcc = clean_mfcc.copy()
    feats = clean_mfcc_dev.to(device) if clean_mfcc_dev is not None else torch.from_numpy(clean_mfcc).to(device)
    if len(idx) == 0:
        return bd_wav, bd_mfcc, feats
    styled = poison_style_device(clean_wav[idx], cfg.style, cfg.dsp.sample_rate, device)
    sub = batched_mfcc_device(styled, mfcc_params(cfg), device)
    bd_wav[idx] = styled.cpu().numpy()[:, None, :]
    bd_mfcc[idx] = sub.cpu().numpy()
    return bd_wav, bd_mfcc, scatter_rows(feats, sub, torch.from_numpy(np.asarray(idx, np.int64)).to(device))


def poison(cfg: AttackConfig, clean: CleanData, save: bool = True) -> JingleBackPoisoned:
    """The poisoned splits on ``cfg.device``; the eight bd npys are written
    from them when ``save``."""
    device = resolve_device(cfg.device)
    n_train = len(clean.train_wav)
    rng = rnd.np_rng(cfg.train.seed, "jingleback_poison")
    poison_idx = rng.choice(n_train, size=int(n_train * cfg.poisoning_rate), replace=False)
    bd_train_wav, bd_train_mfcc, bd_train_dev = _poison_split(
        clean.train_wav, clean.train_mfcc, clean.train_mfcc_dev, poison_idx, cfg, device)
    bd_train_label = clean.train_label.copy()
    bd_train_label[poison_idx] = cfg.target_label
    ind_train = np.zeros(n_train, dtype=np.int64)
    ind_train[poison_idx] = 1

    nontarget = clean.test_label != cfg.target_label
    bd_test_wav, bd_test_mfcc, bd_test_dev = _poison_split(
        clean.test_wav, clean.test_mfcc, clean.test_mfcc_dev, np.flatnonzero(nontarget), cfg, device)
    bd_test_label = np.full(len(clean.test_label), cfg.target_label, dtype=np.int64)
    ind_test = nontarget.astype(np.int64)

    if save:
        save_bd_arrays(
            cfg,
            bd_train_wav=bd_train_wav, bd_test_wav=bd_test_wav,
            bd_train_mfcc=bd_train_mfcc, bd_test_mfcc=bd_test_mfcc,
            bd_train_label=bd_train_label, bd_test_label=bd_test_label,
            poison_index_train=ind_train, poison_index_test=ind_test,
        )
    clean_test = clean.test_mfcc_dev if clean.test_mfcc_dev is not None else clean.test_mfcc
    return JingleBackPoisoned(
        bd_train=ArraySet(bd_train_dev, bd_train_label, ind_train),
        bd_test=ArraySet(bd_test_dev, bd_test_label, ind_test),
        clean_test=ArraySet(clean_test, clean.test_label),
    )
