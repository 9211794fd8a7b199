"""Waveform → MFCC, counted as ``chip_smoke.py::mfcc_bound`` counts it: the
operations the function needs a frame, not those of any implementation's
transforms."""

from __future__ import annotations

import math

import numpy as np


def num_frames(n_samples: int, n_fft: int, hop: int) -> int:
    """Centred frames: 1 + T // hop."""
    return 1 + (n_samples + 2 * (n_fft // 2) - n_fft) // hop


def frame_flops(n_fft: int, n_mels: int, n_mfcc: int, mel_nonzeros: int) -> float:
    """A frame: the window (n), a real FFT at the conventional 2.5·n·log2(n),
    the power (3 a bin), the mel product over the filterbank's nonzeros (2
    each), dB and the top_db floor (3 a mel), the dense DCT
    (2·n_mels·n_mfcc). The backward to the waveform is each stage's
    adjoint: as many again."""
    n = n_fft
    return (n + 2.5 * n * math.log2(n) + 3 * (n // 2 + 1) + 2 * mel_nonzeros + 3 * n_mels
            + 2 * n_mels * n_mfcc)


def mel_nonzeros(fb: np.ndarray) -> int:
    return int((fb != 0).sum())
