"""The host side of the MFCC kernel's Bluestein path (audiobd_tpu_torch.ops.mfcc)
against float64 numpy and the JAX package.

The CUDA kernel runs only on the card; what it reads from the host is
checked here: the Bluestein size and its Stockham radices, the chirp, the
pre (hann·c), post (c) and kernel (FFT_L(h) / L) tables. ``bluestein_fft``
walks the kernel's steps on top of ``stockham_fft`` and is held against
numpy's FFT; ``mfcc_bluestein_plain`` walks the whole path and is held
against audiobd_tpu.dsp.mfcc_features and audiobd_tpu.ops.pallas_mfcc.
fused_mfcc (interpret mode) at Ultrasonic's 44.1 kHz settings. Bluestein
sizes are products of 2, 3, 5 and 7 (``BLUESTEIN_PRIMES``).

Tolerances: MFCC rtol 1e-4, atol 1e-3, as tests/test_pallas_mfcc.py (f32 on
both sides, sums in another order). The f32 Bluestein DFT against numpy's
float64 FFT: 1e-5 of the largest magnitude (two f32 transforms at L and
three pointwise products; measured ~3e-7). Tables: the f32 cast of the same
float64 value, exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiobd_tpu.dsp import MFCCParams as JaxMFCCParams
from audiobd_tpu.dsp import mfcc_features as jax_mfcc_features
from audiobd_tpu.ops.pallas_mfcc import fused_mfcc as jax_fused_mfcc
from audiobd_tpu_torch.dsp import MFCCParams
from audiobd_tpu_torch.ops import mfcc as op

RTOL, ATOL = 1e-4, 1e-3
ULTRASONIC = dict(sample_rate=44100, n_mfcc=40, n_fft=1103, hop_length=441, parity="torchaudio")
SIZES = {  # n_fft: (L, radices)
    1103: (2240, (8, 8, 5, 7)),  # prime: Ultrasonic's setting; 2205 = 3²·5·7² has 5 stages
    882: (1792, (8, 8, 4, 7)),  # 2 · 3² · 7² (the FFT path's; its Bluestein tables still hold)
    97: (196, (4, 7, 7)),  # 200 = 8·5·5 ties on stages: the smaller wins
    2039: (4096, (8, 8, 8, 8)),  # prime; the largest L whose layout fits two blocks an SM
    4097: (8232, (8, 3, 7, 7, 7)),  # 17 · 241: L = 8232, buffers alone in one block's shared memory
}


def _pair(z):
    return np.stack([z.real, z.imag], axis=1).astype(np.float32)


@pytest.mark.parametrize("n_fft", sorted(SIZES))
def test_bluestein_plan_tables(n_fft):
    size, radices = SIZES[n_fft]
    assert op.bluestein_size(n_fft) == size and op.fft_radices(size) == radices
    assert size >= 2 * n_fft - 1 and int(np.prod(radices)) == size
    plan = op.bluestein_plan(n_fft, size)
    assert plan.size == size and plan.fft.radices == radices
    n = np.arange(n_fft, dtype=np.float64)
    chirp = np.exp(-1j * np.pi * n * n / n_fft)  # unreduced angle: float64 is exact enough here
    assert np.abs(op.chirp(n_fft) - chirp).max() < 1e-9
    hann = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))
    for table, want in ((plan.pre, hann * op.chirp(n_fft)), (plan.post, op.chirp(n_fft))):
        assert table.dtype == np.float32 and table.shape == (n_fft, 2)
        np.testing.assert_array_equal(table, _pair(want))
    h = np.zeros(size, np.complex128)
    m = np.arange(size)
    dist = np.minimum(m, size - m)  # h_m = conj(c_|m|) on the circle of L, zero where |m| >= N
    h[dist < n_fft] = np.conj(op.chirp(n_fft)[dist[dist < n_fft]])
    assert plan.kernel.dtype == np.float32 and plan.kernel.shape == (size, 2)
    np.testing.assert_array_equal(plan.kernel, _pair(np.fft.fft(h) / size))


@pytest.mark.parametrize("n_fft", [1103, 882, 97, 2039, 4097, 8192])
def test_bluestein_size_rule(n_fft):
    """The smallest product of 2 and BLUESTEIN_PRIMES of at least 2N − 1, or
    one no more than BLUESTEIN_SLACK above it with fewer Stockham stages; a
    size for every N (past one block's shared memory the transform is split
    over a cluster of CTAs, and past a cluster of 8 the buffers live in
    device memory)."""
    primes = op.BLUESTEIN_PRIMES
    size = op.bluestein_size(n_fft)
    first = next(n for n in range(2 * n_fft - 1, 8 * n_fft) if op.fft_radices(n, primes) is not None)
    smooth = [n for n in range(first, size + 1) if op.fft_radices(n, primes) is not None]
    assert first <= size <= op.BLUESTEIN_SLACK * first
    assert all(len(op.fft_radices(size, primes)) <= len(op.fft_radices(n, primes)) for n in smooth)
    assert op.fft_radices(size) == op.fft_radices(size, primes)  # the kernel's plan of L


@pytest.mark.parametrize("n_fft", sorted(SIZES))
def test_bluestein_fft_matches_numpy(n_fft):
    rng = np.random.default_rng(n_fft)
    z = (rng.standard_normal((3, n_fft)) + 1j * rng.standard_normal((3, n_fft))).astype(np.complex64)
    got = op.bluestein_fft(torch.from_numpy(z), op.bluestein_plan(n_fft, op.bluestein_size(n_fft))).numpy()
    ref = np.fft.fft(z.astype(np.complex128))
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_bluestein_fft_windowed_by_pre():
    """With the plan's pre table the walk is the DFT of the Hann-windowed frame."""
    n_fft = 1103
    plan = op.bluestein_plan(n_fft, op.bluestein_size(n_fft))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, n_fft)).astype(np.float32)
    pre = torch.complex(*torch.from_numpy(plan.pre).unbind(-1))
    got = op.bluestein_fft(torch.from_numpy(x).to(torch.complex64), plan, pre).numpy()
    ref = np.fft.fft(x.astype(np.float64) * (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)))
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_mfcc_bluestein_plain_matches_jax(dtype):
    x = (np.random.default_rng(5).standard_normal((3, 44100)) * 0.1).astype(np.float32)
    if dtype == "int16":
        x = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
    wav_f32 = x.astype(np.float32) / 32768.0 if dtype == "int16" else x

    port = op.mfcc_bluestein_plain(torch.from_numpy(x), MFCCParams(**ULTRASONIC)).numpy()
    jp = JaxMFCCParams(**ULTRASONIC)
    ref = np.asarray(jax_mfcc_features(jnp.asarray(wav_f32), jp))[:, 0]
    pallas = np.asarray(jax_fused_mfcc(jnp.asarray(wav_f32), jp, block=3, interpret=True))
    assert port.shape == ref.shape == pallas.shape == (3, 100, 40)
    np.testing.assert_allclose(port, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(port, pallas, rtol=RTOL, atol=ATOL)


def test_mfcc_bluestein_plain_other_sizes_match_dsp():
    """n_fft 874 without top_db and 97 with 40 mels (L 1792 and 196) against
    the port's own plain dsp.mfcc, which the tests above tie to the JAX package."""
    x = torch.from_numpy((np.random.default_rng(7).standard_normal((2, 16000)) * 0.1).astype(np.float32))
    for kw in (dict(n_fft=874, hop_length=160, top_db=None), dict(n_fft=97, hop_length=160, n_mels=40, n_mfcc=13)):
        params = MFCCParams(**kw)
        assert op.mfcc_path(params.n_fft) == "bluestein"
        torch.testing.assert_close(op.mfcc_bluestein_plain(x, params), op.fused_mfcc(x, params), rtol=RTOL, atol=ATOL)
