"""The port's MFCC (audiobd_tpu_torch.ops.mfcc / dsp) against the JAX package.

On the CPU the port's kernel wrapper runs its plain version (dsp.mfcc of the
dequantized waveform); it is held against both audiobd_tpu.dsp.mfcc_features
and the Pallas kernel in interpret mode. The CUDA kernel itself is held
against the plain version on the card by test_torch_port_kernels_cuda.py and
chip_smoke.py.

Tolerance rtol 1e-4, atol 1e-3, as tests/test_pallas_mfcc.py: both sides are
f32 at full precision, but the 400-term DFT sums and the log of small mel
energies are taken in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiobd_tpu.dsp import MFCCParams as JaxMFCCParams
from audiobd_tpu.dsp import mfcc_features as jax_mfcc_features
from audiobd_tpu.ops.pallas_mfcc import fused_mfcc as jax_fused_mfcc
from audiobd_tpu_torch.data.speech_commands import batched_mfcc_device
from audiobd_tpu_torch.dsp import MFCCParams, mfcc_features
from audiobd_tpu_torch.ops.mfcc import fused_mfcc, fused_mfcc_features
from audiobd_tpu_torch.poison.device_prep import dequantize_pcm

RTOL, ATOL = 1e-4, 1e-3
SETTINGS = {
    "torchaudio": dict(sample_rate=16000, n_mfcc=40, n_fft=400, hop_length=160, parity="torchaudio"),
    "librosa": dict(sample_rate=16000, n_mfcc=40, n_fft=2048, hop_length=512, parity="librosa"),
}


def _wavs(batch: int, dtype: str, seed: int) -> np.ndarray:
    x = (np.random.default_rng(seed).standard_normal((batch, 16000)) * 0.1).astype(np.float32)
    if dtype == "int16":
        return np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
    return x


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("batch", [4, 3])  # 3: ragged against the Pallas block of 2
def test_mfcc_matches_jax(setting, dtype, batch):
    kw = SETTINGS[setting]
    wavs = _wavs(batch, dtype, seed=batch)
    wav_f32 = wavs.astype(np.float32) / 32768.0 if dtype == "int16" else wavs

    port = fused_mfcc_features(torch.from_numpy(wavs), MFCCParams(**kw)).numpy()
    jp = JaxMFCCParams(**kw)
    ref = np.asarray(jax_mfcc_features(jnp.asarray(wav_f32), jp))
    pallas = np.asarray(jax_fused_mfcc(jnp.asarray(wav_f32), jp, block=2, interpret=True))

    assert port.shape == ref.shape == (batch, 1, *pallas.shape[1:])
    np.testing.assert_allclose(port, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(port[:, 0], pallas, rtol=RTOL, atol=ATOL)


def test_dsp_mfcc_features_channel_layout():
    """(B, 1, T) and (B, T) give the same (B, 1, frames, n_mfcc) features."""
    params = MFCCParams()
    wavs = torch.from_numpy(_wavs(2, "float32", seed=7))
    a = mfcc_features(wavs, params)
    b = mfcc_features(wavs[:, None], params)
    assert a.shape == (2, 1, 101, 40)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_dequantize_pcm_is_exact_and_rejects_other_widths():
    pcm = torch.tensor([-32768, -1, 0, 1, 32767], dtype=torch.int16)
    out = dequantize_pcm(pcm)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), pcm.numpy().astype(np.float32) / 32768.0)
    with pytest.raises(ValueError, match="int16"):
        dequantize_pcm(pcm.to(torch.int32))


def test_fused_mfcc_rejects_bad_rank():
    with pytest.raises(ValueError, match=r"\(B, T\)"):
        fused_mfcc(torch.zeros(2, 1, 1, 16000), MFCCParams())



def test_batched_mfcc_device_chunks_and_empty_input():
    """Chunked prep equals one pass; an empty split gives an empty result."""
    params = MFCCParams()
    pcm = _wavs(5, "int16", seed=3)[:, None]
    cpu = torch.device("cpu")
    whole = batched_mfcc_device(pcm, params, cpu)
    torch.testing.assert_close(batched_mfcc_device(pcm, params, cpu, chunk=2), whole, rtol=0, atol=0)
    assert whole.shape == (5, 1, 101, 40)
    assert batched_mfcc_device(pcm[:0], params, cpu).shape == (0, 1, 101, 40)
