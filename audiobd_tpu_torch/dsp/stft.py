"""Framed, matmul-based STFT in plain torch (port of audiobd_tpu/dsp/stft.py).

The DFT is two dense products with windowed cosine/sine bases, built in
float64 and cast to float32, so ``power = (F @ Bc)^2 + (F @ Bs)^2`` for the
frame matrix F. It is exact at odd sizes such as n_fft 1103 and
differentiable. Semantics follow torch.stft / librosa.stft with
``center=True``: frames = 1 + (T + 2*(n_fft//2) - n_fft) // hop.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window / scipy fftbins=True)."""
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float64)


def num_frames(n_samples: int, n_fft: int, hop_length: int, center: bool = True) -> int:
    if center:
        n_samples = n_samples + 2 * (n_fft // 2)
    return 1 + (n_samples - n_fft) // hop_length


@functools.lru_cache(maxsize=32)
def _dft_bases(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT bases, shape (n_fft, n_fft//2 + 1) each, float32."""
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    angle = 2.0 * np.pi * n * k / n_fft
    win = hann_window(n_fft)[:, None]
    cos_b = (np.cos(angle) * win).astype(np.float32)
    sin_b = (-np.sin(angle) * win).astype(np.float32)
    return cos_b, sin_b


@functools.lru_cache(maxsize=8)
def _device_bases(n_fft: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The bases on ``device``, uploaded once: FlowMur's trigger search runs
    the STFT every step, and re-uploading 16.8 MB of bases a step at n_fft
    2048 took a quarter of its device time. Read-only."""
    return tuple(torch.from_numpy(b).to(device) for b in _dft_bases(n_fft))


def frame_signal(
    x: torch.Tensor, n_fft: int, hop_length: int, center: bool = True, pad_mode: str = "reflect"
) -> torch.Tensor:
    """Slice ``x`` (..., T) into overlapping frames (..., n_frames, n_fft)."""
    if center:
        pad = n_fft // 2
        lead = x.shape[:-1]
        flat = x.reshape(-1, 1, x.shape[-1])
        mode = "reflect" if pad_mode == "reflect" else "constant"
        x = F.pad(flat, (pad, pad), mode=mode).reshape(*lead, x.shape[-1] + 2 * pad)
    return x.unfold(-1, n_fft, hop_length)


def power_spectrogram(
    x: torch.Tensor,
    n_fft: int,
    hop_length: int,
    center: bool = True,
    pad_mode: str = "reflect",
) -> torch.Tensor:
    """Hann-windowed power spectrogram of ``x`` (..., T) → (..., n_frames, n_bins),
    time-major."""
    frames = frame_signal(x, n_fft, hop_length, center=center, pad_mode=pad_mode)
    cos_b, sin_b = _device_bases(n_fft, x.device)
    re = torch.matmul(frames, cos_b)
    im = torch.matmul(frames, sin_b)
    return re * re + im * im
