"""Speech Commands ingest, the synthetic stand-in and the record/ npy cache
contract (port of audiobd_tpu/data/speech_commands.py).

The wav-tree ingest (``prepare_clean_dataset``) follows the reference
(reference prepare_dataset.py:49-112; audiobd_tpu/data/speech_commands.py:133-249):
walk ``<data_path>/<label>/*.wav``, keep clips of at least 1 s at the
attack's rate (the length filter is what standardizes clips, SURVEY §6b.1),
truncate to 1 s, MFCC, split 80/20 as sklearn's ``train_test_split(...,
random_state=35)`` does, and cache six npys under
``record/<result>/<dataset>/clean/`` (``clean_logmel/`` for AST's log-mel
features, normalised by the training split's statistics first:
``normalize_features``). PCM16 files at the attack's rate are decoded to int16 by the native
decoder and sent to the device as int16; other formats at that rate take its
f32 decode; files at another rate are read whole and resampled on the
device, in batches by rate.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from audiobd_tpu_torch.configs import AttackConfig
from audiobd_tpu_torch.data.native import decode_batch, decode_batch_pcm16
from audiobd_tpu_torch.data.wavio import read_wav
from audiobd_tpu_torch.dsp import MFCCParams
from audiobd_tpu_torch.dsp.resample import resample, resampled_length
from audiobd_tpu_torch.ops.mfcc import fused_mfcc_features
from audiobd_tpu_torch.parallel.distributed import agreed, main_rank_only
from audiobd_tpu_torch.utils.device import resolve_device

DECODE_CHUNK = 2048  # files a native batch decode takes at once
RESAMPLE_CHUNK = 2048  # clips a resampling convolution takes at once

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
    # The wav-tree prep's walls in seconds: decode, resample, mfcc.
    prep_walls: dict[str, float] | None = None


def mfcc_params(cfg: AttackConfig) -> MFCCParams:
    return MFCCParams(
        sample_rate=cfg.dsp.sample_rate,
        n_mfcc=cfg.dsp.n_mfcc,
        n_fft=cfg.dsp.n_fft,
        hop_length=cfg.dsp.hop_length,
        n_mels=cfg.dsp.n_mels,
        parity=cfg.dsp.parity,
        features=cfg.features,
    )


def normalize_features(cfg: AttackConfig, train: torch.Tensor, test: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The splits as the model takes them: MFCCs as they are; log-mel frames
    as AST normalises them, (x − μ) / (2σ), with μ and σ the mean and the
    (population) standard deviation of every value of the training split,
    taken in float64 (AST fixes them per dataset)."""
    if cfg.features != "logmel":
        return train, test
    x = train.double()
    mu, sigma = float(x.mean()), float(x.std(correction=0))
    return (train - mu) / (2.0 * sigma), (test - mu) / (2.0 * sigma)


def batched_mfcc_device(wavs, params: MFCCParams, device: torch.device, chunk: int = 2048) -> torch.Tensor:
    """(N, 1, T) or (N, T) f32 or int16 PCM, host numpy or a tensor →
    (N, 1, frames, n_out) on ``device`` (n_mfcc, or n_mels in the log-mel
    mode): the MFCC kernel on CUDA, its plain
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
    """The clean cache: ``clean/`` for MFCCs, ``clean_<features>/`` for
    another input (AST's ``clean_logmel/``), so that runs of models that take
    different features under one ``--result`` never read each other's."""
    name = "clean" if cfg.features == "mfcc" else f"clean_{cfg.features}"
    return os.path.join(cfg.record_dir, cfg.dataset, name)


@main_rank_only
def save_clean_data(cfg: AttackConfig, data: CleanData) -> None:
    path = clean_dir(cfg)
    os.makedirs(path, exist_ok=True)
    arrays = (
        data.train_wav, data.test_wav, data.train_mfcc,
        data.test_mfcc, data.train_label, data.test_label,
    )
    for name, arr in zip(_CLEAN_FILES, arrays):
        np.save(os.path.join(path, name + ".npy"), arr)


def load_clean_data(cfg: AttackConfig, load: bool | None = None) -> CleanData:
    """Load the six cached npys written by either package, or rebuild them
    from the wav tree (``load`` False, or no cache)."""
    load = cfg.load_clean_data if load is None else load
    path = clean_dir(cfg)
    # Every rank decides before rank 0 writes the cache.
    if load and agreed(os.path.exists(os.path.join(path, "clean_train_mfcc.npy")), path):
        return CleanData(*[np.load(os.path.join(path, n + ".npy")) for n in _CLEAN_FILES])
    return prepare_clean_dataset(cfg)


def sync_device(device: torch.device) -> None:
    """Wait for ``device``'s queued work (a no-op on the CPU), so a host clock
    read next times it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def resample_rows(rows: list[np.ndarray], orig_freq: int, new_freq: int, keep: int, device: torch.device,
                  chunk: int = RESAMPLE_CHUNK) -> torch.Tensor:
    """Whole clips at one rate, of any lengths → (N, keep) f32 on
    ``device``: each clip resampled alone, cut or zero-filled to ``keep``
    samples. A chunk of clips is zero-padded on the right to its longest and
    resampled as one batch; the zeros are the ones ``resample`` pads a clip
    with, so each row is its clip's up to the clip's own resampled length
    (``resampled_length``). Past it the batch holds the filter's tail over
    the padding, which is zeroed here, as a clip resampled alone ends."""
    out = []
    for start in range(0, len(rows), chunk):
        block = rows[start : start + chunk]
        host = np.zeros((len(block), max(len(r) for r in block)), np.float32)
        for i, r in enumerate(block):
            host[i, : len(r)] = r
        res = resample(torch.from_numpy(host).to(device), orig_freq, new_freq)[:, :keep]
        res = F.pad(res, (0, keep - res.shape[1]))
        lengths = torch.tensor([resampled_length(len(r), orig_freq, new_freq) for r in block], device=device)
        out.append(torch.where(torch.arange(keep, device=device)[None, :] < lengths[:, None], res, 0.0))
    return torch.cat(out)


def prepare_clean_dataset(cfg: AttackConfig, data_path: str | None = None, save: bool = True) -> CleanData:
    """The clean dataset from the wav tree at ``data_path`` (default
    ``cfg.data_path``), MFCCs on ``cfg.device``; the six npys are written
    when ``save``. Clip order, split and labels are the reference's."""
    device = resolve_device(cfg.device)
    data_path = data_path or cfg.data_path
    sr = cfg.dsp.sample_rate  # exactly 1 s at the attack's rate
    walls = {}

    t0 = time.perf_counter()
    rows_i16, idx_i16 = [], []  # raw PCM16 rows at the attack's rate, their clip indices
    rows_f32, idx_f32 = [], []  # other formats at the attack's rate
    off_rate: dict[int, tuple[list, list]] = {}  # file rate → (whole clips, clip indices)
    labels: list[int] = []
    for label_idx, label in enumerate(cfg.labels):
        label_path = os.path.join(data_path, label)
        if not os.path.isdir(label_path):
            raise FileNotFoundError(f"missing class dir {label_path}")
        paths = [os.path.join(label_path, name) for name in sorted(os.listdir(label_path)) if name.endswith(".wav")]
        for start in range(0, len(paths), DECODE_CHUNK):
            chunk = paths[start : start + DECODE_CHUNK]
            pcm, lengths, rates, ok = decode_batch_pcm16(chunk, sr)
            bad = np.flatnonzero(~ok)
            if bad.size:
                f32_dec, f32_len, f32_rates = decode_batch([chunk[i] for i in bad], sr)
                bad_map = {int(i): j for j, i in enumerate(bad)}
            for row in range(len(chunk)):
                if ok[row]:
                    rate_r, len_r = int(rates[row]), int(lengths[row])
                else:
                    j = bad_map[row]
                    rate_r, len_r = int(f32_rates[j]), int(f32_len[j])
                if rate_r == sr:
                    if len_r >= sr:
                        if ok[row]:
                            rows_i16.append(pcm[row].copy())  # not a view that keeps the chunk alive
                            idx_i16.append(len(labels))
                        else:
                            rows_f32.append(f32_dec[j])
                            idx_f32.append(len(labels))
                        labels.append(label_idx)
                else:
                    # Whole clips: the filter applies to the resampled length.
                    if ok[row] and len_r < sr:  # the decoder returned every sample
                        wav, file_sr = pcm[row, :len_r].astype(np.float32) * (1.0 / 32768.0), rate_r
                    else:  # cut at sr samples, or not PCM16: read again whole
                        wav, file_sr = read_wav(chunk[row])
                        wav = wav[0]
                    if resampled_length(len(wav), file_sr, sr) >= sr:
                        clips, idx = off_rate.setdefault(file_sr, ([], []))
                        clips.append(wav)
                        idx.append(len(labels))
                        labels.append(label_idx)
    n_total = len(labels)
    if n_total == 0:
        raise ValueError(f"no clip of at least 1 s at {sr} Hz under {data_path}")
    walls["decode"] = time.perf_counter() - t0

    # The f32 pool on the device: the rows above, then the resampled clips by rate.
    t0 = time.perf_counter()
    pool32 = [torch.from_numpy(np.stack(rows_f32)).to(device)] if rows_f32 else []
    for file_sr, (clips, idx) in sorted(off_rate.items()):
        pool32.append(resample_rows(clips, file_sr, sr, sr, device))
        idx_f32 += idx
    pool32 = torch.cat(pool32) if pool32 else None
    sync_device(device)
    walls["resample"] = time.perf_counter() - t0

    # Host f32 waveforms for the clean npy contract, in clip order.
    all_wav = np.empty((n_total, 1, sr), np.float32)
    if rows_i16:
        all_wav[idx_i16, 0] = np.stack(rows_i16).astype(np.float32) * (1.0 / 32768.0)
    if pool32 is not None:
        all_wav[idx_f32, 0] = pool32.cpu().numpy()
    all_label = np.asarray(labels, dtype=np.int64)

    # MFCC of each pool in its own dtype (int16 goes to the device as is),
    # put back in clip order on the device; the split is a device gather.
    t0 = time.perf_counter()
    params = mfcc_params(cfg)
    pools = [(batched_mfcc_device(np.stack(rows_i16), params, device), idx_i16)] if rows_i16 else []
    if pool32 is not None:
        pools.append((batched_mfcc_device(pool32, params, device), idx_f32))
    all_mfcc = torch.empty((n_total, *pools[0][0].shape[1:]), dtype=torch.float32, device=device)
    for feats, idx in pools:
        all_mfcc.index_copy_(0, torch.as_tensor(idx, device=device), feats)
    del pool32, pools
    idx_train, idx_test = split_indices(n_total)
    train_dev, test_dev = normalize_features(cfg, all_mfcc[torch.from_numpy(idx_train).to(device)],
                                             all_mfcc[torch.from_numpy(idx_test).to(device)])
    del all_mfcc
    sync_device(device)
    walls["mfcc"] = time.perf_counter() - t0
    print(f"clean prep ({len(rows_i16)} clips as int16 PCM, {n_total - len(rows_i16)} as f32, "
          f"{sum(len(c) for c, _ in off_rate.values())} of them resampled to {sr} Hz): {n_total} clips; "
          f"decode {walls['decode']:.3f} s, resample {walls['resample']:.3f} s, MFCC {walls['mfcc']:.3f} s")

    data = CleanData(
        all_wav[idx_train], all_wav[idx_test],
        train_dev.cpu().numpy(), test_dev.cpu().numpy(),
        all_label[idx_train], all_label[idx_test],
        train_mfcc_dev=train_dev, test_mfcc_dev=test_dev, prep_walls=walls,
    )
    if save:
        save_clean_data(cfg, data)
    return data


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
    train_dev, test_dev = normalize_features(cfg, all_mfcc[torch.from_numpy(idx_train).to(device)],
                                             all_mfcc[torch.from_numpy(idx_test).to(device)])
    return CleanData(
        all_wav[idx_train], all_wav[idx_test],
        train_dev.cpu().numpy(), test_dev.cpu().numpy(),
        all_label[idx_train], all_label[idx_test],
        train_mfcc_dev=train_dev, test_mfcc_dev=test_dev,
    )
