"""Waveform → MFCC in plain torch (port of audiobd_tpu/dsp/mfcc.py).

    frames → @ windowed-DFT bases → |.|² → @ mel fb → dB → @ DCT

``features="logmel"`` stops before the DCT: the floored dB values of the
n_mels bands, AST's input (models/zoo.py::AST).

Differentiable end to end (FlowMur's trigger synthesis backprops through
it), and the plain version that the MFCC kernel (ops/mfcc.py) is held
against.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from audiobd_tpu_torch.dsp import mel as _mel
from audiobd_tpu_torch.dsp import stft as _stft

FEATURES = ("mfcc", "logmel")


@dataclass(frozen=True)
class MFCCParams:
    sample_rate: int = 16000
    n_mfcc: int = 40
    n_fft: int = 400
    hop_length: int = 160
    n_mels: int = 128
    parity: str = "torchaudio"  # or "librosa"
    top_db: float | None = 80.0
    features: str = "mfcc"  # or "logmel": no DCT, n_mels values a frame

    def __post_init__(self):
        if self.features not in FEATURES:
            raise ValueError(f"features must be one of {FEATURES}, got {self.features!r}")

    @property
    def n_dct(self) -> int:
        """The DCT's columns: n_mfcc, or 0 in the log-mel mode, which stops
        before the DCT."""
        return 0 if self.features == "logmel" else self.n_mfcc

    @property
    def n_out(self) -> int:
        """Values a frame: n_mfcc, or n_mels in the log-mel mode."""
        return self.n_dct or self.n_mels

    @property
    def pad_mode(self) -> str:
        # torch.stft center-pads with 'reflect'; librosa.stft (>=0.10) with 'constant'.
        return "reflect" if self.parity == "torchaudio" else "constant"

    @property
    def mel_scale(self) -> str:
        return "htk" if self.parity == "torchaudio" else "slaney"

    @property
    def mel_norm(self) -> str | None:
        return None if self.parity == "torchaudio" else "slaney"

    def mel_fb(self):
        return _mel.mel_filterbank(
            self.sample_rate, self.n_fft, n_mels=self.n_mels,
            scale=self.mel_scale, norm=self.mel_norm,
        )

    def dct(self):
        return _mel.dct_matrix(self.n_mfcc, self.n_mels)


@functools.lru_cache(maxsize=8)
def _device_tables(params: MFCCParams, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(mel filterbank, DCT) on ``device``, uploaded once. Read-only."""
    return torch.from_numpy(params.mel_fb()).to(device), torch.from_numpy(params.dct()).to(device)


def mfcc(x: torch.Tensor, params: MFCCParams) -> torch.Tensor:
    """MFCC of float ``x`` (..., T) → (..., n_frames, n_out), time-major
    (the dB values themselves in the log-mel mode)."""
    spec = _stft.power_spectrogram(
        x, params.n_fft, params.hop_length, center=True, pad_mode=params.pad_mode
    )
    fb, dct = _device_tables(params, x.device)
    db = _mel.amplitude_to_db(torch.matmul(spec, fb), top_db=params.top_db)
    return torch.matmul(db, dct) if params.n_dct else db


def mfcc_features(wavs: torch.Tensor, params: MFCCParams) -> torch.Tensor:
    """Batched model-input features: (B, T) or (B, 1, T) → (B, 1, frames, n_out),
    the framework's NCHW feature layout."""
    if wavs.ndim >= 3 and wavs.shape[-2] == 1:
        wavs = wavs.squeeze(-2)
    return mfcc(wavs, params)[..., None, :, :]
