"""Polyphase sinc resampling, torchaudio ``sinc_interp_hann`` semantics (port
of audiobd_tpu/dsp/resample.py).

A windowed-sinc lowpass at ``rolloff * min(orig, new) / 2`` Hz evaluated at
the ``new`` output phases of each ``orig`` input samples: one strided
``conv1d`` of a (new, 1, K) kernel bank over the zero-padded signal, on the
device of the input. It is a plain convolution (the reference leaves it to
XLA), so it runs as the library's.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=16)
def _kernel(orig: int, new: int, lowpass_filter_width: int, rolloff: float) -> tuple[np.ndarray, int]:
    """((new, K) f32 kernel bank built in float64, width), K = 2·width + orig."""
    base_freq = min(orig, new) * rolloff
    width = math.ceil(lowpass_filter_width * orig / base_freq)
    # For output phase p (0..new-1), taps cover input samples [-width, width + orig).
    idx = np.arange(-width, width + orig, dtype=np.float64)[None, :] / orig
    t = (-np.arange(new, dtype=np.float64)[:, None] / new + idx) * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2.0) ** 2
    t = t * np.pi
    kernel = np.where(t == 0.0, 1.0, np.sin(t) / np.where(t == 0.0, 1.0, t))
    kernel = kernel * window * base_freq / orig
    return kernel.astype(np.float32), width


def reduced_rates(orig_freq: int, new_freq: int) -> tuple[int, int]:
    g = math.gcd(int(orig_freq), int(new_freq))
    return int(orig_freq) // g, int(new_freq) // g


def resampled_length(n_samples: int, orig_freq: int, new_freq: int) -> int:
    """The length ``resample`` gives a clip of ``n_samples``: ⌈new·T/orig⌉
    with the rates reduced (integers, exact)."""
    orig, new = reduced_rates(orig_freq, new_freq)
    return -(-new * n_samples // orig)


def resample(x: torch.Tensor, orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
             rolloff: float = 0.99) -> torch.Tensor:
    """Resample ``x`` (..., T) float32 from orig_freq to new_freq → (...,
    ⌈new·T/orig⌉). Zeros stand beyond the last sample, so the rows of a
    batch zero-padded on the right to a common T come out as each row alone
    would, up to its own length."""
    orig, new = reduced_rates(orig_freq, new_freq)
    if orig == new:
        return x
    kernel_np, width = _kernel(orig, new, lowpass_filter_width, rolloff)
    t_in = x.shape[-1]
    target_length = resampled_length(t_in, orig, new)
    lead_shape = x.shape[:-1]
    xb = F.pad(x.reshape(-1, 1, t_in), (width, width + orig))
    kern = torch.from_numpy(kernel_np).to(x.device)[:, None, :]  # (new, 1, K)
    out = F.conv1d(xb, kern, stride=orig)  # (B, new, frames)
    out = out.transpose(1, 2).reshape(xb.shape[0], -1)[:, :target_length]
    return out.reshape(*lead_shape, target_length)
