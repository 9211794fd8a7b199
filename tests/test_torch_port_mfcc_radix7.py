"""Kernel A's radix-7 FFT path at n_fft 2205 (3²·5·7², 44.1 kHz, hop 441),
which the matrix DFT served before, against the JAX package and float64.

The CUDA kernel runs only on the card; ``mfcc_fft_plain`` walks its plan
(radices 3, 3, 5, 7, 7) and mel ranges in plain torch and is held against
audiobd_tpu.dsp.mfcc_features and audiobd_tpu.ops.pallas_mfcc.fused_mfcc
(interpret mode), f32 and int16. The walkers of both paths (n_fft 400 and
2205 on the FFT path, 1103 on the Bluestein path) are also held against a
float64 MFCC.

Tolerances: rtol 1e-4, atol 1e-3 against the JAX package, as
tests/test_pallas_mfcc.py (f32 on both sides, sums in another order); atol
1e-3 against float64, the bound chip_smoke.py holds the card's kernels to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiobd_tpu.dsp import MFCCParams as JaxMFCCParams
from audiobd_tpu.dsp import mfcc_features as jax_mfcc_features
from audiobd_tpu.ops.pallas_mfcc import fused_mfcc as jax_fused_mfcc
from audiobd_tpu_torch.dsp import MFCCParams
from audiobd_tpu_torch.dsp.mel import amplitude_to_db
from audiobd_tpu_torch.dsp.stft import frame_signal, hann_window
from audiobd_tpu_torch.ops import mfcc as op

RTOL, ATOL = 1e-4, 1e-3
WIDE = dict(sample_rate=44100, n_mfcc=40, n_fft=2205, hop_length=441, parity="torchaudio")


def _clips(dtype, n=2, n_samples=44100, seed=21):
    x = (np.random.default_rng(seed).standard_normal((n, n_samples)) * 0.1).astype(np.float32)
    if dtype == "int16":
        x = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
    return x, (x.astype(np.float32) / 32768.0 if dtype == "int16" else x)


def test_radix7_plan():
    plan = op.fft_plan(2205)
    assert plan.radices == (3, 3, 5, 7, 7) and op.mfcc_path(2205) == "fft"
    want = np.exp(-2j * np.pi * np.arange(2205) / 2205)
    np.testing.assert_array_equal(plan.twiddles[:, 0], want.real.astype(np.float32))
    np.testing.assert_array_equal(plan.twiddles[:, 1], want.imag.astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_mfcc_fft_plain_radix7_matches_jax(dtype):
    x, wav_f32 = _clips(dtype)
    port = op.mfcc_fft_plain(torch.from_numpy(x), MFCCParams(**WIDE)).numpy()
    jp = JaxMFCCParams(**WIDE)
    ref = np.asarray(jax_mfcc_features(jnp.asarray(wav_f32), jp))[:, 0]
    pallas = np.asarray(jax_fused_mfcc(jnp.asarray(wav_f32), jp, block=2, interpret=True))
    assert port.shape == ref.shape == pallas.shape == (2, 100, 40)
    np.testing.assert_allclose(port, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(port, pallas, rtol=RTOL, atol=ATOL)


def _mfcc_float64(wav: torch.Tensor, params: MFCCParams) -> torch.Tensor:
    frames = frame_signal(wav.double(), params.n_fft, params.hop_length, pad_mode=params.pad_mode)
    spec = torch.fft.rfft(frames * torch.from_numpy(hann_window(params.n_fft)), dim=-1).abs() ** 2
    mel = spec @ torch.from_numpy(params.mel_fb()).double()
    return amplitude_to_db(mel, top_db=params.top_db) @ torch.from_numpy(params.dct()).double()


@pytest.mark.parametrize("kw,n_samples,walker", [
    (dict(n_fft=400, hop_length=160), 16000, "mfcc_fft_plain"),  # the main path
    (dict(sample_rate=44100, n_fft=1103, hop_length=441), 44100, "mfcc_bluestein_plain"),  # Ultrasonic's
    (WIDE, 44100, "mfcc_fft_plain"),
])
def test_plain_walkers_match_float64(kw, n_samples, walker):
    params = MFCCParams(**kw)
    wav = torch.from_numpy(_clips("float32", n_samples=n_samples, seed=22)[0])
    got = getattr(op, walker)(wav, params)
    assert float((got.double() - _mfcc_float64(wav, params)).abs().max()) <= ATOL
