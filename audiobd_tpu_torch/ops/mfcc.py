"""Waveform → MFCC through the hand-written CUDA kernel ``csrc/mfcc.cu``.

Port of audiobd_tpu/ops/pallas_mfcc.py::fused_mfcc. On a CUDA tensor the
wrapper launches the kernel (or raises); on a CPU tensor it runs the plain
version, ``dsp.mfcc`` of the dequantized waveform.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from audiobd_tpu_torch.dsp.mfcc import MFCCParams, mfcc
from audiobd_tpu_torch.dsp.stft import _dft_bases, num_frames
from audiobd_tpu_torch.ops.build import CudaKernel, ptr
from audiobd_tpu_torch.poison.device_prep import dequantize_pcm

_I, _P, _F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
MFCC_KERNEL = CudaKernel(
    "mfcc", "mfcc.cu", "mfcc_forward",
    [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I],
)


@functools.lru_cache(maxsize=8)
def _tables(params: MFCCParams, device: torch.device) -> tuple[torch.Tensor, ...]:
    """Windowed DFT bases, mel filterbank and DCT on ``device`` (float32)."""
    cos_b, sin_b = _dft_bases(params.n_fft)
    return tuple(
        torch.from_numpy(a).to(device).contiguous()
        for a in (cos_b, sin_b, params.mel_fb(), params.dct())
    )


def fused_mfcc(wavs: torch.Tensor, params: MFCCParams) -> torch.Tensor:
    """(B, T) float32 or int16 PCM → (B, n_frames, n_mfcc) float32, the
    function of ``dsp.mfcc`` (int16 is scaled by 2⁻¹⁵ first)."""
    if wavs.ndim != 2:
        raise ValueError(f"fused_mfcc expects (B, T), got {tuple(wavs.shape)}")
    if not wavs.is_cuda:
        return mfcc(dequantize_pcm(wavs), params)
    if wavs.dtype not in (torch.float32, torch.int16):
        raise ValueError(f"fused_mfcc takes float32 or int16 PCM, got {wavs.dtype}")
    batch, n_samples = wavs.shape
    pad = params.n_fft // 2
    if params.pad_mode == "reflect" and n_samples <= pad:
        raise ValueError(f"reflect padding needs more than {pad} samples, got {n_samples}")
    n_frames = num_frames(n_samples, params.n_fft, params.hop_length)
    if n_frames < 1:
        raise ValueError(f"{n_samples} samples give no frame at n_fft {params.n_fft}")
    wavs = wavs.contiguous()
    out = torch.empty((batch, n_frames, params.n_mfcc), dtype=torch.float32, device=wavs.device)
    if batch == 0:
        return out
    cos_b, sin_b, mel_fb, dct = _tables(params, wavs.device)
    MFCC_KERNEL(
        wavs.device,
        ptr(wavs), int(wavs.dtype == torch.int16), batch, n_samples,
        ptr(cos_b), ptr(sin_b), ptr(mel_fb), ptr(dct), ptr(out),
        params.n_fft, params.hop_length, params.n_fft // 2 + 1, params.n_mels, params.n_mfcc,
        n_frames, int(params.pad_mode == "reflect"),
        float(params.top_db or 0.0), int(params.top_db is not None),
    )
    return out


def fused_mfcc_features(wavs: torch.Tensor, params: MFCCParams) -> torch.Tensor:
    """(B, T) or (B, 1, T) → (B, 1, frames, n_mfcc), the model-input layout."""
    if wavs.ndim == 3 and wavs.shape[-2] == 1:
        wavs = wavs.squeeze(-2)
    return fused_mfcc(wavs, params)[:, None]
