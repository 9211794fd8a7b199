"""Mel filterbanks, dB conversion, DCT matrix (port of audiobd_tpu/dsp/mel.py).

Two parity modes, matching the reference's two front ends:
  * torchaudio: HTK mel scale, no filterbank normalization, amplitude_to_DB
    with per-clip top_db=80;
  * librosa: Slaney mel scale with 'slaney' area normalization, power_to_db
    with per-clip top_db=80.
The tables are built in float64 numpy and cast to float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def hz_to_mel(f: np.ndarray, scale: str) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    if scale == "htk":
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney: linear below 1 kHz, log-spaced above.
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = f / f_sp
    above = f >= min_log_hz
    return np.where(above, min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep, mel)


def mel_to_hz(m: np.ndarray, scale: str) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    if scale == "htk":
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    f = m * f_sp
    above = m >= min_log_mel
    return np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)), f)


@functools.lru_cache(maxsize=32)
def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int = 128,
    f_min: float = 0.0,
    f_max: float | None = None,
    scale: str = "htk",
    norm: str | None = None,
) -> np.ndarray:
    """Triangular mel filterbank, shape (n_bins, n_mels)."""
    if f_max is None:
        f_max = sample_rate / 2.0
    n_bins = n_fft // 2 + 1
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)

    mel_pts = np.linspace(hz_to_mel(np.array(f_min), scale), hz_to_mel(np.array(f_max), scale), n_mels + 2)
    f_pts = mel_to_hz(mel_pts, scale)

    # Triangle: rising slope from f_pts[i] to f_pts[i+1], falling to f_pts[i+2].
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))

    if norm == "slaney":
        enorm = 2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels])
        fb = fb * enorm[None, :]
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=8)
def dct_matrix(n_mfcc: int, n_mels: int) -> np.ndarray:
    """Orthonormal DCT-II basis, shape (n_mels, n_mfcc): mfcc = log_mel @ dct."""
    n = np.arange(n_mels, dtype=np.float64)[:, None]
    k = np.arange(n_mfcc, dtype=np.float64)[None, :]
    dct = np.cos(np.pi / n_mels * (n + 0.5) * k)
    dct[:, 0] *= 1.0 / np.sqrt(2.0)
    dct *= np.sqrt(2.0 / n_mels)
    return dct.astype(np.float32)


def amplitude_to_db(spec: torch.Tensor, top_db: float | None = 80.0, amin: float = 1e-10) -> torch.Tensor:
    """torchaudio F.amplitude_to_DB for power spectrograms (multiplier 10,
    ref 1.0). The top_db floor is relative to each clip's own max over its
    last two dims, as torchaudio applies it inside T.MFCC; librosa's
    power_to_db is the same math."""
    db = 10.0 * torch.log10(torch.clamp(spec, min=amin))
    if top_db is not None:
        clip_max = db.amax(dim=(-2, -1), keepdim=True)
        db = torch.maximum(db, clip_max - top_db)
    return db
