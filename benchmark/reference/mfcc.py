"""Waveform → MFCC, torchaudio's ``T.MFCC`` semantics (the reference attacks'
front end): reflect-padded centred frames, a periodic Hann window, the power
spectrum of the real DFT (two products with the windowed cosine and sine
bases, built in float64), an HTK mel filterbank without normalisation,
10·log10 with each clip's 80 dB floor, an orthonormal DCT-II.
Differentiable."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int) -> np.ndarray:
    """(n_fft//2 + 1, n_mels) triangles between mel-spaced corners, 0 Hz to
    Nyquist, in float64."""
    freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    corners = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sample_rate / 2.0), n_mels + 2))
    width = np.diff(corners)
    rel = corners[None, :] - freqs[:, None]
    down = -rel[:, :-2] / width[:-1]
    up = rel[:, 2:] / width[1:]
    return np.maximum(0.0, np.minimum(down, up))


@functools.lru_cache(maxsize=8)
def dft_bases(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """(n_fft, n_fft//2 + 1) windowed cosine and sine bases, float64:
    frame @ cos = Re, frame @ sin = Im of the windowed frame's DFT."""
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
    angle = 2.0 * np.pi * n * k / n_fft
    return np.cos(angle) * window[:, None], -np.sin(angle) * window[:, None]


@functools.lru_cache(maxsize=8)
def dct_matrix(n_mfcc: int, n_mels: int) -> np.ndarray:
    """(n_mels, n_mfcc) orthonormal DCT-II, float64."""
    n = np.arange(n_mels, dtype=np.float64)[:, None]
    k = np.arange(n_mfcc, dtype=np.float64)[None, :]
    dct = np.cos(np.pi / n_mels * (n + 0.5) * k) * np.sqrt(2.0 / n_mels)
    dct[:, 0] /= np.sqrt(2.0)
    return dct


@functools.lru_cache(maxsize=8)
def _tables(sample_rate: int, n_fft: int, n_mels: int, n_mfcc: int, device: torch.device) -> tuple:
    """(cos, sin, mel filterbank, DCT) in f32 on ``device``, uploaded once."""
    return tuple(torch.from_numpy(t).to(device, torch.float32)
                 for t in (*dft_bases(n_fft), mel_filterbank(sample_rate, n_fft, n_mels), dct_matrix(n_mfcc, n_mels)))


def mfcc(wavs: torch.Tensor, sample_rate: int, n_fft: int, hop: int, n_mels: int, n_mfcc: int,
         top_db: float = 80.0) -> torch.Tensor:
    """(B, T) f32 → (B, frames, n_mfcc) f32 on the clips' device."""
    pad = n_fft // 2
    x = F.pad(wavs[:, None, :], (pad, pad), mode="reflect")[:, 0, :]
    frames = x.unfold(-1, n_fft, hop)
    cos_b, sin_b, fb, dct = _tables(sample_rate, n_fft, n_mels, n_mfcc, wavs.device)
    re, im = frames @ cos_b, frames @ sin_b
    power = re * re + im * im
    db = 10.0 * torch.log10(torch.clamp(power @ fb, min=1e-10))
    db = torch.maximum(db, db.amax(dim=(-2, -1), keepdim=True) - top_db)
    return db @ dct


def mfcc_rows(wavs: torch.Tensor, dsp: dict, chunk: int = 1024) -> torch.Tensor:
    """(N, T) → (N, 1, frames, n_mfcc), a chunk of clips at a time."""
    out = [mfcc(wavs[s:s + chunk], dsp["sample_rate"], dsp["n_fft"], dsp["hop_length"], dsp["n_mels"],
                dsp["n_mfcc"]) for s in range(0, wavs.shape[0], chunk)]
    return torch.cat(out)[:, None]


def badnets_patch(feats: torch.Tensor, rows: torch.Tensor, size: int, value: float = -200.0) -> torch.Tensor:
    """``feats`` (N, 1, frames, n_mfcc) with the bottom-right ``size`` x
    ``size`` block (the last frames, the highest coefficients) set to
    ``value`` in the rows where ``rows`` (N,) is true."""
    out = feats.clone()
    sel = rows.nonzero().flatten()
    out[sel, :, -size:, -size:] = value
    return out
