"""The host side of the MFCC kernel's FFT path (audiobd_tpu_torch.ops.mfcc)
against numpy and the JAX package.

The CUDA kernel runs only on the card; what it reads from the host is
checked here: the Stockham plan (radices, twiddles, window), the per-band
mel ranges and packed weights, the thread groups, the choice of path by
n_fft and of route (where the buffers live) by size (the Bluestein path's
own tables: test_torch_port_mfcc_bluestein.py; radix 7 at n_fft 2205:
test_torch_port_mfcc_radix7.py).
``mfcc_fft_plain`` walks the same plan and ranges in plain torch and
is held against audiobd_tpu.ops.pallas_mfcc.fused_mfcc (interpret mode) and
audiobd_tpu.dsp.mfcc_features.

Tolerances: MFCC rtol 1e-4, atol 1e-3, as tests/test_pallas_mfcc.py (f32 on
both sides, sums in another order). The f32 FFT against numpy's float64 FFT:
1e-6 of the largest magnitude (its rounding grows like log n).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiobd_tpu.dsp import MFCCParams as JaxMFCCParams
from audiobd_tpu.dsp import mfcc_features as jax_mfcc_features
from audiobd_tpu.ops.pallas_mfcc import fused_mfcc as jax_fused_mfcc
from audiobd_tpu_torch.dsp import MFCCParams
from audiobd_tpu_torch.dsp.stft import num_frames
from audiobd_tpu_torch.ops import mfcc as op

RTOL, ATOL = 1e-4, 1e-3
SETTINGS = {
    "torchaudio": dict(sample_rate=16000, n_mfcc=40, n_fft=400, hop_length=160, parity="torchaudio"),
    "librosa": dict(sample_rate=16000, n_mfcc=40, n_fft=2048, hop_length=512, parity="librosa"),
}


@pytest.mark.parametrize("n_fft,path,radices", [
    (400, "fft", (8, 2, 5, 5)),
    (2048, "fft", (8, 8, 8, 4)),
    (1103, "bluestein", None),  # prime: Ultrasonic's 44.1 kHz setting
    (480, "fft", (8, 4, 3, 5)),
    (4096, "fft", (8, 8, 8, 8)),
    (4097, "bluestein", None),  # 17 · 241: L = 8232, buffers alone in one block's shared memory
    (8192, "fft", (8, 8, 8, 8, 2)),
    (882, "fft", (2, 3, 3, 7, 7)),  # 2 · 3² · 7²
    (2205, "fft", (3, 3, 5, 7, 7)),  # 3² · 5 · 7²: was the matrix DFT's
    (7, "fft", (7,)),
    (343, "fft", (7, 7, 7)),
    (16384, "fft", (8, 8, 8, 8, 4)),  # past one block's shared memory: the cluster route
    (874, "bluestein", None),  # 2 · 19 · 23
])
def test_path_chosen_by_n_fft(n_fft, path, radices):
    assert op.mfcc_path(n_fft) == path
    assert op.fft_radices(n_fft) == radices
    if radices is not None:
        assert int(np.prod(radices)) == n_fft
    if path != "fft":
        assert op.bluestein_size(n_fft) is not None


@pytest.mark.parametrize("n_fft,hop,n_samples,route", [
    (400, 160, 16000, ("fft", 400, op.MODE_SHARED, 8, "mfcc_fft")),  # the main path
    (2048, 512, 16000, ("fft", 2048, op.MODE_SHARED, 1, "mfcc_fft")),  # DABA's and FlowMur's
    (2048, 160, 16000, ("fft", 2048, op.MODE_LARGE, 2, "mfcc_fft_large")),  # 101 frames: the dB tile leaves
    (1103, 441, 44100, ("bluestein", 2240, op.MODE_SHARED, 2, "mfcc_bluestein")),  # Ultrasonic's
    (2205, 441, 44100, ("fft", 2205, op.MODE_LARGE, 2, "mfcc_fft_large")),
    (8192, 160, 16000, ("fft", 8192, op.MODE_LARGE, 1, "mfcc_fft_large")),
    (3001, 441, 44100, ("bluestein", 6125, op.MODE_LARGE, 1, "mfcc_fft_large")),
    (4097, 441, 44100, ("bluestein", 8232, op.MODE_LARGE, 1, "mfcc_fft_large")),  # 149,400 B
    (16384, 441, 44100, ("fft", 16384, op.MODE_CLUSTER, 1, "mfcc_fft_cluster")),  # 2 CTAs
    (131072, 441, 100000, ("fft", 131072, op.MODE_DEVICE, 1, "mfcc_fft_device")),  # past a cluster of 8
])
def test_route_chosen_by_size(n_fft, hop, n_samples, route):
    """Where the kernel keeps its buffers: everything in shared memory where
    two blocks fit an SM, the buffers alone where they fit one block, a
    cluster's shared memory where a cluster of at most 8 CTAs holds them,
    device memory beyond; the host's count of shared memory within the
    card's limits."""
    params = MFCCParams(sample_rate=n_samples, n_fft=n_fft, hop_length=hop)
    got = op.mfcc_route(params, num_frames(n_samples, n_fft, hop))
    assert (got.path, got.size, got.mode, got.groups, got.kernel.name) == route
    assert got.smem <= (op.TWO_BLOCKS_BYTES if got.mode == op.MODE_SHARED else op.MAX_SHARED_BYTES)
    assert (got.cluster is not None) == (got.mode == op.MODE_CLUSTER)


@pytest.mark.parametrize("n_fft", [400, 2048])
def test_fft_plan_tables(n_fft):
    plan = op.fft_plan(n_fft)
    k = np.arange(n_fft)
    assert plan.twiddles.dtype == np.float32 and plan.twiddles.shape == (n_fft, 2)
    want = np.exp(-2j * np.pi * k / n_fft)
    np.testing.assert_array_equal(plan.twiddles[:, 0], want.real.astype(np.float32))
    np.testing.assert_array_equal(plan.twiddles[:, 1], want.imag.astype(np.float32))
    hann = (0.5 * (1.0 - np.cos(2.0 * np.pi * k / n_fft))).astype(np.float32)
    np.testing.assert_array_equal(plan.window, hann)
    np.testing.assert_array_equal(plan.window, torch.hann_window(n_fft, periodic=True, dtype=torch.float64).numpy()
                                  .astype(np.float32))


@pytest.mark.parametrize("n_fft", [400, 2048, 480, 384, 30, 1000, 7, 343, 882, 2205, 16384])
def test_stockham_fft_matches_numpy(n_fft):
    rng = np.random.default_rng(n_fft)
    z = (rng.standard_normal((3, n_fft)) + 1j * rng.standard_normal((3, n_fft))).astype(np.complex64)
    got = op.stockham_fft(torch.from_numpy(z), op.fft_plan(n_fft)).numpy()
    ref = np.fft.fft(z.astype(np.complex128))
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("setting,max_bins,nonzeros", [("torchaudio", 9, 395), ("librosa", 48, 2020)])
def test_mel_ranges_rebuild_the_filterbank(setting, max_bins, nonzeros):
    params = MFCCParams(**SETTINGS[setting])
    fb = params.mel_fb()
    ranges, weights = op.mel_ranges(params)
    assert ranges.dtype == np.int32 and ranges.shape == (params.n_mels, 3)
    assert ranges[:, 1].max() == max_bins
    assert int((weights != 0).sum()) == nonzeros == int((fb != 0).sum())
    dense = np.zeros_like(fb)
    for m, (first, count, off) in enumerate(ranges):
        dense[first : first + count, m] = weights[off : off + count]
    np.testing.assert_array_equal(dense, fb)
    assert (np.count_nonzero(fb, axis=1) <= 2).all()  # each bin feeds at most two bands


@pytest.mark.parametrize("n_fft,groups", [(400, 8), (2048, 1), (480, 4), (30, 8), (1024, 2), (4096, 1)])
def test_fft_thread_groups(n_fft, groups):
    assert op.fft_groups(n_fft) == groups
    assert 16 * n_fft * groups <= max(op.FFT_BUFFER_BYTES, 16 * n_fft)


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_mfcc_fft_plain_matches_jax(setting, dtype):
    kw = SETTINGS[setting]
    x = (np.random.default_rng(5).standard_normal((3, 16000)) * 0.1).astype(np.float32)
    if dtype == "int16":
        x = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
    wav_f32 = x.astype(np.float32) / 32768.0 if dtype == "int16" else x

    port = op.mfcc_fft_plain(torch.from_numpy(x), MFCCParams(**kw)).numpy()
    jp = JaxMFCCParams(**kw)
    ref = np.asarray(jax_mfcc_features(jnp.asarray(wav_f32), jp))[:, 0]
    pallas = np.asarray(jax_fused_mfcc(jnp.asarray(wav_f32), jp, block=3, interpret=True))
    assert port.shape == ref.shape == pallas.shape
    np.testing.assert_allclose(port, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(port, pallas, rtol=RTOL, atol=ATOL)


def test_mfcc_fft_plain_odd_frame_count_and_no_top_db():
    """101 frames leave the last pair half empty; without top_db nothing is clamped."""
    params = MFCCParams(top_db=None)
    x = torch.from_numpy((np.random.default_rng(9).standard_normal((2, 16000)) * 0.1).astype(np.float32))
    got = op.mfcc_fft_plain(x, params)
    assert got.shape == (2, 101, 40)
    torch.testing.assert_close(got, op.fused_mfcc(x, params), rtol=RTOL, atol=ATOL)
