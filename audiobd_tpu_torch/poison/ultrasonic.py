"""Ultrasonic attack: an inaudible (>20 kHz) additive waveform trigger (port
of audiobd_tpu/poison/ultrasonic.py).

Reference semantics (utils/ultra_trigger.py:8-111, ultrasonic.py:40-124):
  * a 1 s 44.1 kHz trigger waveform whose energy sits above 20 kHz;
  * a mask keeps ``size`` percent of the second: contiguous at start, mid
    or end, or in 5 evenly spaced chunks;
  * ``TriggerInfeasible`` for a size outside (0, 100] or another position;
  * train: the rows drawn by ``np_rng(seed, "ultrasonic_poison")`` get
    ``wav + trigger``, their MFCC again, label → target; test: every
    non-target row.
The genuine ``resources/Ultrasonic/trigger.wav`` is used where
``utils.assets`` finds it; otherwise the first run synthesizes a trigger
(21.0-21.7 kHz tones) and writes it as PCM16 into the run's directory, and
later runs read that file back, quantized. Only the injected rows' MFCCs
are recomputed (kernel A on the card) and merged into the device-resident
clean features. ``UltrasonicTrigger(debug=True)`` draws the reference's
three debug PNGs (the trigger's spectrum, waveform and MFCC) into
``debug_dir``.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from audiobd_tpu_torch.configs import AttackConfig
from audiobd_tpu_torch.data.speech_commands import CleanData, batched_mfcc_device, mfcc_params
from audiobd_tpu_torch.data.wavio import read_wav, write_wav
from audiobd_tpu_torch.parallel.distributed import agreed
from audiobd_tpu_torch.poison.badnets import save_bd_arrays
from audiobd_tpu_torch.poison.device_prep import scatter_rows
from audiobd_tpu_torch.train.loop import ArraySet
from audiobd_tpu_torch.utils import random as rnd
from audiobd_tpu_torch.utils.assets import find_resource
from audiobd_tpu_torch.utils.device import resolve_device

TRIGGER_SR = 44100
DIVIDER = 100


class TriggerInfeasible(Exception):
    """An invalid trigger size or position. As in the reference, the message
    gives the size bound as 60 (``correct_size``, utils/ultra_trigger.py:12)
    while the check accepts (0, 100]."""

    correct_pos = ("start", "mid", "end")
    correct_size = 60  # message text only; the check uses DIVIDER (=100)

    def __init__(self, size, pos):
        self.size = size
        self.pos = pos
        super().__init__(
            f"Cannot apply trigger (size: {size}, pos: {pos}). Size should be in "
            f"(0, {self.correct_size}] and pos should be in {list(self.correct_pos)}"
        )


def synthesize_trigger_wave(path: str | None = None, seed: int = 7) -> np.ndarray:
    """1 s mono 44.1 kHz waveform (1, 44100) f32 of tones at 21.0-21.7 kHz
    in 100 Hz steps, all above the 20 kHz the attack relies on; written to
    ``path`` as PCM16 if given."""
    rng = np.random.default_rng(seed)
    t = np.arange(TRIGGER_SR) / TRIGGER_SR
    wav = np.zeros(TRIGGER_SR, dtype=np.float64)
    # Integer frequencies are bin-centred for a 1 s clip: no leakage below 20 kHz.
    for f in range(21000, 21800, 100):
        wav += np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
    wav *= 0.25 / np.abs(wav).max()
    wav = wav.astype(np.float32)[None, :]
    if path:
        write_wav(path, wav, TRIGGER_SR)
    return wav


class UltrasonicTrigger:
    """The masked ultrasonic trigger (reference GenerateTrigger)."""

    def __init__(self, size: int, pos: str, cont: bool = True, wave_path: str = "resources/Ultrasonic/trigger.wav",
                 debug: bool = False, debug_dir: str = "resources/Ultrasonic/debug"):
        self.debug = debug
        self.debug_dir = debug_dir
        if pos not in TriggerInfeasible.correct_pos:
            raise TriggerInfeasible(size, pos)
        if size <= 0 or size > DIVIDER:
            raise TriggerInfeasible(size, pos)
        # Every rank decides before rank 0 writes: all read the file, or
        # all synthesize the same full-precision wave.
        if agreed(os.path.exists(wave_path), wave_path):
            data, sr = read_wav(wave_path)
            if sr != TRIGGER_SR:
                raise ValueError(f"trigger wav {wave_path} is {sr} Hz; it must be {TRIGGER_SR} Hz")
            self.data = data[:1].astype(np.float32)
        else:
            self.data = synthesize_trigger_wave(wave_path)
        self.points = math.floor(self.data.shape[1] / DIVIDER) * size
        self.size = size
        self.pos = pos
        self.cont = cont

    def _mask_cont(self) -> np.ndarray:
        t = self.data.shape[1]
        if self.pos == "start":
            start, end = 0, self.points - 1
        elif self.pos == "mid":
            if self.points % 2 == 0:
                start = t // 2 - self.points // 2
            else:
                start = t // 2 - self.points // 2 + 1
            end = t // 2 + self.points // 2 - 1
        else:  # end
            start, end = t - self.points, t - 1
        keep = np.zeros(t, dtype=bool)
        keep[start : end + 1] = True
        return keep

    def _mask_non_cont(self) -> np.ndarray:
        t = self.data.shape[1]
        length = int(self.points / 5) - 1
        step = t // 5
        keep = np.zeros(t, dtype=bool)
        current = 0
        for _ in range(5):
            keep[current : current + length + 1] = True
            current += step
        return keep

    def trigger(self) -> np.ndarray:
        keep = self._mask_cont() if self.cont else self._mask_non_cont()
        out = np.where(keep[None, :], self.data, 0.0).astype(np.float32)
        if self.debug:
            self._plot(out)
        return out

    def _plot(self, out: np.ndarray) -> None:
        """The reference's debug plots (utils/ultra_trigger.py:105-109): the
        trigger's spectrum and waveform, and its MFCC by the plain
        ``dsp.mfcc`` at n_fft 1103, hop 441 on the CPU."""
        from audiobd_tpu_torch.dsp.mfcc import MFCCParams, mfcc
        from audiobd_tpu_torch.utils.visual import plot_fft, plot_mfccs, plot_waveform

        plot_fft(out, TRIGGER_SR, os.path.join(self.debug_dir, "trigger_fft.png"))
        plot_waveform(out, TRIGGER_SR, os.path.join(self.debug_dir, "trigger_wave.png"))
        feats = mfcc(torch.from_numpy(out[0]), MFCCParams(sample_rate=TRIGGER_SR, n_mfcc=40, n_fft=1103,
                                                          hop_length=441))
        plot_mfccs(feats.numpy(), os.path.join(self.debug_dir, "trigger_mfcc.png"))


@dataclass
class UltrasonicPoisoned:
    bd_train: ArraySet
    bd_test: ArraySet
    clean_test: ArraySet
    trigger: np.ndarray


def resolve_trigger_wave_path(cfg: AttackConfig) -> str:
    """The genuine asset (utils/ultra_trigger.py:24) where one is found, else
    the run's own copy under ``record/<result>/resources/``."""
    real = find_resource(os.path.join("Ultrasonic", "trigger.wav"))
    if real is not None:
        return real
    return os.path.join(cfg.record_dir, "resources", "Ultrasonic", "trigger.wav")


def _poison_split(clean_wav: np.ndarray, clean_mfcc: np.ndarray, clean_mfcc_dev: torch.Tensor | None,
                  idx: np.ndarray, trig: np.ndarray, cfg: AttackConfig, device: torch.device):
    """One split: the trigger is added to the ``idx`` rows on the host (the
    wav npys need host copies anyway), their MFCCs are computed on the device
    and merged into the clean features there; the host npy view gets the
    same rows. Returns (bd_wav host, bd_mfcc host, bd_mfcc on the device)."""
    bd_wav = clean_wav.copy()
    bd_mfcc = clean_mfcc.copy()
    feats = clean_mfcc_dev.to(device) if clean_mfcc_dev is not None else torch.from_numpy(clean_mfcc).to(device)
    if len(idx) == 0:
        return bd_wav, bd_mfcc, feats
    bd_wav[idx] = clean_wav[idx] + trig[None]  # (k, 1, T) + (1, 1, T)
    sub = batched_mfcc_device(bd_wav[idx], mfcc_params(cfg), device)
    bd_mfcc[idx] = sub.cpu().numpy()
    return bd_wav, bd_mfcc, scatter_rows(feats, sub, torch.from_numpy(np.asarray(idx, np.int64)).to(device))


def poison(cfg: AttackConfig, clean: CleanData, save: bool = True) -> UltrasonicPoisoned:
    """The poisoned splits on ``cfg.device``; the eight bd npys (reference
    ultrasonic.py:98-124) are written from them when ``save``."""
    device = resolve_device(cfg.device)
    trig = UltrasonicTrigger(cfg.ultra_trigger_size, cfg.trigger_pos, cont=cfg.trigger_cont,
                             wave_path=resolve_trigger_wave_path(cfg)).trigger()  # (1, 44100)
    if clean.train_wav.shape[-1] != trig.shape[-1]:
        raise ValueError(f"ultrasonic needs {TRIGGER_SR} Hz clips of 1 s (cfg.dsp.sample_rate={TRIGGER_SR}), "
                         f"got {clean.train_wav.shape[-1]} samples")

    n_train = len(clean.train_wav)
    rng = rnd.np_rng(cfg.train.seed, "ultrasonic_poison")
    poison_idx = rng.choice(n_train, size=int(n_train * cfg.poisoning_rate), replace=False)
    bd_train_wav, bd_train_mfcc, bd_train_dev = _poison_split(
        clean.train_wav, clean.train_mfcc, clean.train_mfcc_dev, poison_idx, trig, cfg, device)
    bd_train_label = clean.train_label.copy()
    bd_train_label[poison_idx] = cfg.target_label
    ind_train = np.zeros(n_train, dtype=np.int64)
    ind_train[poison_idx] = 1

    nontarget = clean.test_label != cfg.target_label
    bd_test_wav, bd_test_mfcc, bd_test_dev = _poison_split(
        clean.test_wav, clean.test_mfcc, clean.test_mfcc_dev, np.flatnonzero(nontarget), trig, cfg, device)
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
    return UltrasonicPoisoned(
        bd_train=ArraySet(bd_train_dev, bd_train_label, ind_train),
        bd_test=ArraySet(bd_test_dev, bd_test_label, ind_test),
        clean_test=ArraySet(clean_test, clean.test_label),
        trigger=trig,
    )
