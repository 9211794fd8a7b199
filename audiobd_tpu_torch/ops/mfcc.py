"""Waveform → MFCC through the hand-written CUDA kernels of ``csrc/mfcc.cu``.

Port of audiobd_tpu/ops/pallas_mfcc.py::fused_mfcc. The kernel source has
three paths, chosen by ``n_fft`` alone (``mfcc_path``):

* ``"fft"``: n_fft whose prime factors are 2, 3 and 5 (400, the main path;
  2048, the DABA and FlowMur settings), up to ``MAX_FFT``. A mixed-radix
  Stockham FFT in shared memory, two real frames packed into one complex
  transform, and the mel product over each band's nonzero bins. Its host
  tables come from ``fft_plan`` and ``mel_ranges``.
* ``"bluestein"``: every other n_fft whose Bluestein size L (a product of 2,
  3 and 5 of at least 2·n_fft − 1, ``bluestein_size``) is at most
  ``MAX_FFT``, i.e. every n_fft up to 2048 (1103, Ultrasonic's 44.1 kHz
  setting, is prime). The same kernel in its chirp mode: the frame pair is
  multiplied by the chirp, transformed at L, multiplied by the transformed
  chirp kernel, transformed back and multiplied by the chirp again
  (``bluestein_plan``).
* ``"dft"``: anything larger (n_fft above 2048 with another prime factor,
  or above ``MAX_FFT``). The matrix-form DFT against windowed bases.

Each path that fails to build or launch raises; none stands in for another.
Each has its own launch counter. On a CPU tensor the wrapper runs the plain
version, ``dsp.mfcc`` of the dequantized waveform; ``mfcc_fft_plain`` and
``mfcc_bluestein_plain`` walk the kernel paths' plans in plain torch, for
the tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from audiobd_tpu_torch.dsp import mel as _mel
from audiobd_tpu_torch.dsp.mfcc import MFCCParams, mfcc
from audiobd_tpu_torch.dsp.stft import _dft_bases, frame_signal, hann_window, num_frames
from audiobd_tpu_torch.ops.build import CudaKernel, load_library, ptr
from audiobd_tpu_torch.poison.device_prep import dequantize_pcm

MAX_FFT = 4096  # the FFT path's largest n_fft: one frame pair's buffers fit shared memory
FFT_BUFFER_BYTES = 52 * 1024  # the thread groups' ping-pong buffers (csrc/mfcc.cu's note)
# The chirp mode keeps its dB tile in device memory, so its buffers may take
# what the FFT path gives the tile: two 256-thread groups at L = 2304.
BLUESTEIN_BUFFER_BYTES = 76 * 1024

_I, _P, _F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
MFCC_FFT_KERNEL = CudaKernel(
    "mfcc_fft", "mfcc.cu", "mfcc_fft_forward",
    [_P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.POINTER(_I), _I, _I, _F, _I],
)
MFCC_BLUESTEIN_KERNEL = CudaKernel(
    "mfcc_bluestein", "mfcc.cu", "mfcc_bluestein_forward",
    [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.POINTER(_I),
     _I, _I, _F, _I],
)
MFCC_DFT_KERNEL = CudaKernel(
    "mfcc_dft", "mfcc.cu", "mfcc_dft_forward",
    [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I],
)


def fft_radices(n_fft: int) -> tuple[int, ...] | None:
    """The Stockham stages for ``n_fft`` in the order they run: radix 8 while
    three factors of 2 remain, then 4 or 2, then the 3s and 5s; None when
    n_fft has another prime factor or exceeds ``MAX_FFT``."""
    if n_fft < 2 or n_fft > MAX_FFT:
        return None
    n, twos = n_fft, 0
    while n % 2 == 0:
        n, twos = n // 2, twos + 1
    radices = [8] * (twos // 3) + {0: [], 1: [2], 2: [4]}[twos % 3]
    for p in (3, 5):
        while n % p == 0:
            n //= p
            radices.append(p)
    return tuple(radices) if n == 1 else None


BLUESTEIN_SLACK = 1.05  # how far above the smallest Bluestein size the plan looks for fewer stages


def bluestein_size(n_fft: int) -> int | None:
    """The transform size L of the Bluestein path for ``n_fft``: among the
    products of 2, 3 and 5 from 2·n_fft − 1 to ``BLUESTEIN_SLACK`` times the
    smallest of them (and at most ``MAX_FFT``), the one with the fewest
    Stockham stages, the smaller on a tie (at n_fft 1103: 2304 = 8·8·4·3·3,
    5 stages, over 2250 = 2·3·3·5·5·5, 6 stages). None when no such L is at
    most MAX_FFT."""
    if n_fft < 2:
        return None
    sizes = [n for n in range(2 * n_fft - 1, MAX_FFT + 1) if fft_radices(n) is not None]
    if not sizes:
        return None
    near = [n for n in sizes if n <= BLUESTEIN_SLACK * sizes[0]]
    return min(near, key=lambda n: (len(fft_radices(n)), n))


def mfcc_path(n_fft: int) -> str:
    """"fft" when n_fft factors into 2, 3 and 5 and is at most MAX_FFT;
    "bluestein" for any other n_fft with a Bluestein size (every n_fft up to
    2048); "dft" beyond. A choice by shape: the paths compute the same
    function."""
    if fft_radices(n_fft) is not None:
        return "fft"
    return "bluestein" if bluestein_size(n_fft) is not None else "dft"


class FftPlan(NamedTuple):
    radices: tuple[int, ...]
    twiddles: np.ndarray  # (n_fft, 2) f32: exp(-2πik/n_fft) as (cos, sin), built in float64
    window: np.ndarray  # (n_fft,) f32 periodic Hann, built in float64


@functools.lru_cache(maxsize=8)
def fft_plan(n_fft: int) -> FftPlan:
    radices = fft_radices(n_fft)
    if radices is None:
        raise ValueError(f"n_fft {n_fft} is not a product of 2, 3 and 5 up to {MAX_FFT}")
    angle = -2.0 * np.pi * np.arange(n_fft) / n_fft
    twiddles = np.stack([np.cos(angle), np.sin(angle)], axis=1).astype(np.float32)
    return FftPlan(radices, twiddles, hann_window(n_fft).astype(np.float32))


class BluesteinPlan(NamedTuple):
    size: int  # L, the transform size
    fft: FftPlan  # the Stockham plan of L
    pre: np.ndarray  # (n_fft, 2) f32: hann_n · c_n, the window and the chirp on the way in
    post: np.ndarray  # (n_fft, 2) f32: c_k, the chirp on the way out
    kernel: np.ndarray  # (L, 2) f32: FFT_L(h) / L, h_m = conj(c_m) wrapped to length L


def chirp(n_fft: int) -> np.ndarray:
    """c_n = exp(−iπ·n²/N) for n < N = n_fft, complex128, with n² reduced mod
    2N in integers first so the angle stays exact for large n."""
    n = np.arange(n_fft, dtype=np.int64)
    return np.exp(-1j * np.pi * ((n * n) % (2 * n_fft)) / n_fft)


@functools.lru_cache(maxsize=8)
def bluestein_plan(n_fft: int, size: int) -> BluesteinPlan:
    """Host tables of the Bluestein path at transform size ``size`` (L >=
    2·n_fft − 1, a product of 2, 3 and 5), built in float64 and cast to f32.
    With nk = (n² + k² − (k − n)²) / 2 the DFT is X_k = c_k Σ_n (x_n c_n)
    conj(c_{k−n}): a circular convolution at L of u = x·c (zero past N) with h
    (h_m = conj(c_|m|) for |m| < N, wrapped), done as FFT_L⁻¹(FFT_L(u)·FFT_L(h)).
    The kernel table carries the inverse's 1/L."""
    radices = fft_radices(size)
    if radices is None or size < 2 * n_fft - 1:
        raise ValueError(f"Bluestein size {size} for n_fft {n_fft} must be a product of 2, 3 and 5 "
                         f"of at least {2 * n_fft - 1} and at most {MAX_FFT}")
    c = chirp(n_fft)
    h = np.zeros(size, np.complex128)
    h[:n_fft] = np.conj(c)
    h[size - n_fft + 1 :] = np.conj(c[1:])[::-1]
    pair = lambda z: np.stack([z.real, z.imag], axis=1).astype(np.float32)  # noqa: E731
    return BluesteinPlan(size, fft_plan(size), pair(hann_window(n_fft) * c), pair(c), pair(np.fft.fft(h) / size))


@functools.lru_cache(maxsize=8)
def mel_ranges(params: MFCCParams) -> tuple[np.ndarray, np.ndarray]:
    """Each mel band's bins from its first to its last nonzero weight:
    ``ranges`` (n_mels, 3) int32 rows (first bin, count, offset into
    ``weights``), count 0 for a band with no nonzero bin, and ``weights``
    the packed f32 weights. The dense product ``power @ mel_fb`` is the sum
    over these ranges."""
    fb = params.mel_fb()
    ranges = np.zeros((fb.shape[1], 3), np.int32)
    weights = []
    offset = 0
    for m in range(fb.shape[1]):
        nz = np.flatnonzero(fb[:, m])
        if nz.size:
            first, count = int(nz[0]), int(nz[-1] - nz[0] + 1)
            ranges[m] = first, count, offset
            weights.append(fb[first : first + count, m])
            offset += count
    packed = np.concatenate(weights).astype(np.float32) if weights else np.zeros(1, np.float32)
    return ranges, packed


def fft_groups(n_fft: int, budget: int = FFT_BUFFER_BYTES) -> int:
    """Thread groups of the FFT kernel's 512-thread block, each transforming
    its own frame pairs: the largest power of two, at most 8 (64 threads a
    group, one named barrier each), whose ping-pong buffers (2 × n_fft
    complex f32 a group) fit ``budget`` bytes (``BLUESTEIN_BUFFER_BYTES``
    in chirp mode, with n_fft the transform size L); at least one."""
    groups = 1
    while groups < 8 and 2 * groups * 16 * n_fft <= budget:
        groups *= 2
    return groups


def fft_occupancy(params: MFCCParams, n_samples: int, device: torch.device) -> tuple[int, int]:
    """(blocks of the FFT kernel, in the mode ``mfcc_path`` picks, that fit
    one SM; its shared memory per block in bytes) for clips of ``n_samples``,
    from the CUDA runtime on ``device``."""
    n_frames = num_frames(n_samples, params.n_fft, params.hop_length)
    chirped = mfcc_path(params.n_fft) == "bluestein"
    size = bluestein_size(params.n_fft) if chirped else params.n_fft
    groups = fft_groups(size, BLUESTEIN_BUFFER_BYTES if chirped else FFT_BUFFER_BYTES)
    lib = load_library(MFCC_FFT_KERNEL.source)
    blocks, smem = _I(), _I()
    for code in (lib.use_device(device.index or 0), lib.mfcc_fft_occupancy(
            params.n_fft, size, int(chirped), groups, params.n_mels, params.n_mfcc, n_frames,
            mel_ranges(params)[1].size, ctypes.byref(blocks), ctypes.byref(smem))):
        if code:
            raise RuntimeError(f"mfcc_fft_occupancy failed with CUDA error {code}")
    return blocks.value, smem.value


# ---------------------------------------------------------------------------
# plain versions


def stockham_fft(z: torch.Tensor, plan: FftPlan) -> torch.Tensor:
    """Complex DFT over the last axis of ``z`` by the kernel's Stockham
    stages: before the stage of radix R, with L the product of the earlier
    radices and m = N / R, butterfly j reads z[j + r·m], multiplies input r
    by W_N^{(j mod L)·r·N/(L·R)}, takes the R-point DFT and writes output s to
    (j − j mod L)·R + j mod L + s·L. The output is in natural order."""
    n = z.shape[-1]
    tw = torch.complex(*torch.from_numpy(plan.twiddles).to(z.device).unbind(-1))
    length = 1
    for radix in plan.radices:
        m = n // radix
        j = torch.arange(m, device=z.device)
        k = j % length
        r = torch.arange(radix, device=z.device)
        v = z[..., j[None, :] + r[:, None] * m] * tw[(k[None, :] * r[:, None] * (n // (length * radix))) % n]
        dft = tw[(r[:, None] * r[None, :] * (n // radix)) % n]  # W_R^{r·s}
        out = torch.einsum("...rm,rs->...sm", v, dft)
        dest = ((j - k) * radix + k)[None, :] + r[:, None] * length
        y = torch.empty_like(z)
        y[..., dest.reshape(-1)] = out.reshape(*out.shape[:-2], -1)
        z = y
        length *= radix
    return z


def bluestein_fft(z: torch.Tensor, plan: BluesteinPlan, pre: torch.Tensor | None = None) -> torch.Tensor:
    """Complex DFT over the last axis (N) of ``z`` by the kernel's Bluestein
    steps: u = z·pre (pre defaults to the chirp c, which gives the DFT; the
    kernel's pre = hann·c also windows), zero-padded to L; U = FFT_L(u);
    y = FFT_L(conj(U·H)), the inverse transform as forward stages on
    conjugates; Z_k = c_k·conj(y_k) for k < N. Each FFT_L is ``stockham_fft``."""
    n = z.shape[-1]
    table = lambda a: torch.complex(*torch.from_numpy(a).to(z.device).unbind(-1))  # noqa: E731
    post = table(plan.post)
    u = torch.zeros((*z.shape[:-1], plan.size), dtype=z.dtype, device=z.device)
    u[..., :n] = z * (post if pre is None else pre)
    y = stockham_fft(torch.conj(stockham_fft(u, plan.fft) * table(plan.kernel)), plan.fft)
    return post * torch.conj(y[..., :n])


def _packed_frames(wavs: torch.Tensor, params: MFCCParams, window: np.ndarray | None):
    """(frame pairs (..., ⌈F/2⌉, n_fft) complex: frame 2q real, 2q + 1
    imaginary, each times ``window`` if given; F, the frame count)."""
    x = dequantize_pcm(wavs)
    frames = frame_signal(x, params.n_fft, params.hop_length, center=True, pad_mode=params.pad_mode)
    if window is not None:
        frames = frames * torch.from_numpy(window).to(x.device)
    n_frames = frames.shape[-2]
    if n_frames % 2:
        frames = torch.cat([frames, torch.zeros_like(frames[..., :1, :])], dim=-2)
    return torch.complex(frames[..., 0::2, :], frames[..., 1::2, :]), n_frames


def mfcc_fft_plain(wavs: torch.Tensor, params: MFCCParams) -> torch.Tensor:
    """The FFT path's function in plain torch, walking the same plan and mel
    ranges: (B, T) f32 or int16 → (B, n_frames, n_mfcc). Frames 2q and 2q + 1
    are windowed and packed as one complex signal a + ib, transformed, and
    separated by A[k] = (Z[k] + conj Z[−k]) / 2, B[k] = (Z[k] − conj Z[−k]) / 2i."""
    plan = fft_plan(params.n_fft)
    pairs, n_frames = _packed_frames(wavs, params, plan.window)
    return _mfcc_from_pairs(stockham_fft(pairs, plan), n_frames, params)


def mfcc_bluestein_plain(wavs: torch.Tensor, params: MFCCParams) -> torch.Tensor:
    """The Bluestein path's function in plain torch, walking the same plan
    and mel ranges: frame pairs packed as on the FFT path, windowed by the
    plan's pre table (hann·c) and transformed by ``bluestein_fft``."""
    plan = bluestein_plan(params.n_fft, bluestein_size(params.n_fft))
    pairs, n_frames = _packed_frames(wavs, params, None)
    pre = torch.complex(*torch.from_numpy(plan.pre).to(pairs.device).unbind(-1))
    return _mfcc_from_pairs(bluestein_fft(pairs, plan, pre), n_frames, params)


def _mfcc_from_pairs(z: torch.Tensor, n_frames: int, params: MFCCParams) -> torch.Tensor:
    """Spectra of packed frame pairs (..., ⌈F/2⌉, n_fft) → (..., F, n_mfcc):
    separate, power, mel over each band's range, dB with top_db, DCT."""
    zc = torch.conj(z[..., (-torch.arange(params.n_fft, device=z.device)) % params.n_fft])
    a, b = (z + zc) / 2, (z - zc) / 2j
    n_bins = params.n_fft // 2 + 1
    power = torch.stack([a.abs() ** 2, b.abs() ** 2], dim=-2)[..., :n_bins]
    power = power.reshape(*power.shape[:-3], -1, n_bins)[..., :n_frames, :]
    ranges, weights = mel_ranges(params)
    mel = torch.stack(
        [
            power[..., first : first + count] @ torch.from_numpy(weights[off : off + count]).to(z.device)
            if count else power.new_zeros(power.shape[:-1])
            for first, count, off in ranges.tolist()
        ],
        dim=-1,
    )
    db = _mel.amplitude_to_db(mel, top_db=params.top_db)
    return db @ torch.from_numpy(params.dct()).to(z.device)


# ---------------------------------------------------------------------------
# kernel wrappers


@functools.lru_cache(maxsize=8)
def _fft_tables(params: MFCCParams, device: torch.device) -> tuple[torch.Tensor, ...]:
    """Twiddles, window, mel ranges and packed weights, DCT on ``device``."""
    plan = fft_plan(params.n_fft)
    ranges, weights = mel_ranges(params)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (plan.twiddles, plan.window, ranges, weights, params.dct())
    )


@functools.lru_cache(maxsize=8)
def _bluestein_tables(params: MFCCParams, size: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    """Twiddles of L, pre, post and kernel tables, mel ranges and packed
    weights, DCT on ``device``."""
    plan = bluestein_plan(params.n_fft, size)
    ranges, weights = mel_ranges(params)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (plan.fft.twiddles, plan.pre, plan.post, plan.kernel, ranges, weights, params.dct())
    )


@functools.lru_cache(maxsize=8)
def _dft_tables(params: MFCCParams, device: torch.device) -> tuple[torch.Tensor, ...]:
    """Windowed DFT bases, mel filterbank and DCT on ``device`` (float32)."""
    cos_b, sin_b = _dft_bases(params.n_fft)
    return tuple(
        torch.from_numpy(a).to(device).contiguous()
        for a in (cos_b, sin_b, params.mel_fb(), params.dct())
    )


def fused_mfcc(wavs: torch.Tensor, params: MFCCParams) -> torch.Tensor:
    """(B, T) float32 or int16 PCM → (B, n_frames, n_mfcc) float32, the
    function of ``dsp.mfcc`` (int16 is scaled by 2⁻¹⁵ first). On a CUDA
    tensor it launches the kernel of the path ``mfcc_path(params.n_fft)``
    names: the FFT kernel, its chirp (Bluestein) mode, or the matrix DFT."""
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
    is_int16 = int(wavs.dtype == torch.int16)
    reflect = int(params.pad_mode == "reflect")
    top_db, use_top_db = float(params.top_db or 0.0), int(params.top_db is not None)
    path = mfcc_path(params.n_fft)
    if path == "fft":
        twiddles, window, ranges, weights, dct = _fft_tables(params, wavs.device)
        radices = fft_plan(params.n_fft).radices
        MFCC_FFT_KERNEL(
            wavs.device,
            ptr(wavs), is_int16, batch, n_samples,
            ptr(twiddles), ptr(window), ptr(ranges), ptr(weights), weights.numel(), ptr(dct), ptr(out),
            params.n_fft, params.hop_length, params.n_mels, params.n_mfcc, n_frames,
            fft_groups(params.n_fft), (_I * len(radices))(*radices), len(radices),
            reflect, top_db, use_top_db,
        )
    elif path == "bluestein":
        size = bluestein_size(params.n_fft)
        twiddles, pre, post, kernel, ranges, weights, dct = _bluestein_tables(params, size, wavs.device)
        radices = fft_radices(size)
        db = torch.empty((batch, n_frames, params.n_mels), dtype=torch.float32, device=wavs.device)
        MFCC_BLUESTEIN_KERNEL(
            wavs.device,
            ptr(wavs), is_int16, batch, n_samples,
            ptr(twiddles), ptr(pre), ptr(post), ptr(kernel), ptr(ranges), ptr(weights), weights.numel(),
            ptr(dct), ptr(db), ptr(out),
            params.n_fft, size, params.hop_length, params.n_mels, params.n_mfcc, n_frames,
            fft_groups(size, BLUESTEIN_BUFFER_BYTES), (_I * len(radices))(*radices), len(radices),
            reflect, top_db, use_top_db,
        )
    else:
        cos_b, sin_b, mel_fb, dct = _dft_tables(params, wavs.device)
        MFCC_DFT_KERNEL(
            wavs.device,
            ptr(wavs), is_int16, batch, n_samples,
            ptr(cos_b), ptr(sin_b), ptr(mel_fb), ptr(dct), ptr(out),
            params.n_fft, params.hop_length, params.n_fft // 2 + 1, params.n_mels, params.n_mfcc,
            n_frames, reflect, top_db, use_top_db,
        )
    return out


def fused_mfcc_features(wavs: torch.Tensor, params: MFCCParams) -> torch.Tensor:
    """(B, T) or (B, 1, T) → (B, 1, frames, n_mfcc), the model-input layout."""
    if wavs.ndim == 3 and wavs.shape[-2] == 1:
        wavs = wavs.squeeze(-2)
    return fused_mfcc(wavs, params)[:, None]
