"""The synthetic Speech Commands stand-in and the record/ npy cache contract
(port of the parts of audiobd_tpu/data/speech_commands.py that the
synthetic path needs).

Not ported yet: ``prepare_clean_dataset`` (the wav-tree ingest with the
native decoder and resampling); ``load_clean_data`` reads the six-npy cache
and raises when it is missing.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from audiobd_tpu_torch.configs import AttackConfig
from audiobd_tpu_torch.dsp import MFCCParams
from audiobd_tpu_torch.ops.mfcc import fused_mfcc_features
from audiobd_tpu_torch.utils.device import resolve_device

_CLEAN_FILES = (
    "clean_train_wav",
    "clean_test_wav",
    "clean_train_mfcc",
    "clean_test_mfcc",
    "clean_train_label",
    "clean_test_label",
)


@dataclass
class CleanData:
    train_wav: np.ndarray   # (N, 1, T)
    test_wav: np.ndarray
    train_mfcc: np.ndarray  # (N, 1, frames, n_mfcc)
    test_mfcc: np.ndarray
    train_label: np.ndarray
    test_label: np.ndarray
    # Device copies of the MFCCs when the prep just computed them there;
    # poisoning adopts them instead of uploading the host arrays again.
    train_mfcc_dev: torch.Tensor | None = None
    test_mfcc_dev: torch.Tensor | None = None


def mfcc_params(cfg: AttackConfig) -> MFCCParams:
    return MFCCParams(
        sample_rate=cfg.dsp.sample_rate,
        n_mfcc=cfg.dsp.n_mfcc,
        n_fft=cfg.dsp.n_fft,
        hop_length=cfg.dsp.hop_length,
        n_mels=cfg.dsp.n_mels,
        parity=cfg.dsp.parity,
    )


def batched_mfcc_device(wavs, params: MFCCParams, device: torch.device, chunk: int = 2048) -> torch.Tensor:
    """(N, 1, T) or (N, T) f32 or int16 PCM, host numpy or a tensor →
    (N, 1, frames, n_mfcc) on ``device``: the MFCC kernel on CUDA, its plain
    version on the CPU, one chunk of clips per launch. Integer PCM goes to
    the device as is (half the bytes of f32) and is scaled on load."""
    if isinstance(wavs, torch.Tensor):
        w = wavs.to(device)
    else:
        arr = np.asarray(wavs)
        if not np.issubdtype(arr.dtype, np.integer):
            arr = arr.astype(np.float32, copy=False)
        w = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    if w.is_floating_point():
        w = w.to(torch.float32)
    if w.ndim == 3 and w.shape[-2] == 1:
        w = w.squeeze(-2)
    if w.shape[0] == 0:
        return fused_mfcc_features(w, params)
    return torch.cat([fused_mfcc_features(w[s : s + chunk], params) for s in range(0, w.shape[0], chunk)])


def split_indices(n: int, test_size: float = 0.2, seed: int = 35) -> tuple[np.ndarray, np.ndarray]:
    """(train, test) row indices of sklearn's
    ``train_test_split(..., test_size=0.2, random_state=35)`` without sklearn:
    ShuffleSplit draws one RandomState permutation, test rows first."""
    n_test = int(np.ceil(test_size * n))
    perm = np.random.RandomState(seed).permutation(n)
    return perm[n_test:], perm[:n_test]


def clean_dir(cfg: AttackConfig) -> str:
    return os.path.join(cfg.record_dir, cfg.dataset, "clean")


def save_clean_data(cfg: AttackConfig, data: CleanData) -> None:
    path = clean_dir(cfg)
    os.makedirs(path, exist_ok=True)
    arrays = (
        data.train_wav, data.test_wav, data.train_mfcc,
        data.test_mfcc, data.train_label, data.test_label,
    )
    for name, arr in zip(_CLEAN_FILES, arrays):
        np.save(os.path.join(path, name + ".npy"), arr)


def load_clean_data(cfg: AttackConfig) -> CleanData:
    """Load the six cached npys written by either package. Rebuilding them
    from the wav tree (``cfg.load_clean_data`` False, or no cache) is not
    ported yet (ROADMAP queue 1) and raises."""
    path = clean_dir(cfg)
    if not cfg.load_clean_data or not os.path.exists(os.path.join(path, "clean_train_mfcc.npy")):
        raise NotImplementedError(
            f"no clean npy cache used under {path}: building it from the wav tree is not "
            "ported yet (ROADMAP queue 1); use --synthetic or the JAX package's cache"
        )
    return CleanData(*[np.load(os.path.join(path, n + ".npy")) for n in _CLEAN_FILES])


def make_synthetic_clean_data(cfg: AttackConfig, n_per_class: int = 30, seed: int = 35) -> CleanData:
    """Deterministic synthetic stand-in for Speech Commands: each class is a
    band-limited tone burst + noise, identical to the reference's draw, so
    both packages build the same clips, splits and labels. MFCCs are
    computed on ``cfg.device`` and kept there as well."""
    device = resolve_device(cfg.device)
    rng = np.random.default_rng(seed)
    sr = cfg.dsp.sample_rate
    t = np.arange(sr, dtype=np.float32) / sr
    wavs, labels = [], []
    for cls in range(len(cfg.labels)):
        base = 200.0 + 160.0 * cls
        for _ in range(n_per_class):
            f0 = base * (1.0 + 0.03 * rng.standard_normal())
            phase = rng.uniform(0, 2 * np.pi)
            env = np.exp(-((t - rng.uniform(0.3, 0.7)) ** 2) / 0.05)
            wav = 0.4 * env * np.sin(2 * np.pi * f0 * t + phase)
            wav += 0.3 * env * np.sin(2 * np.pi * 2 * f0 * t)
            wav += 0.02 * rng.standard_normal(sr)
            wavs.append(wav.astype(np.float32)[None, :])
            labels.append(cls)
    all_wav = np.stack(wavs)
    all_label = np.asarray(labels, dtype=np.int64)
    all_mfcc = batched_mfcc_device(all_wav, mfcc_params(cfg), device)
    idx_train, idx_test = split_indices(len(all_label))
    train_dev = all_mfcc[torch.from_numpy(idx_train).to(device)]
    test_dev = all_mfcc[torch.from_numpy(idx_test).to(device)]
    return CleanData(
        all_wav[idx_train], all_wav[idx_test],
        train_dev.cpu().numpy(), test_dev.cpu().numpy(),
        all_label[idx_train], all_label[idx_test],
        train_mfcc_dev=train_dev, test_mfcc_dev=test_dev,
    )
