"""Waveform → MFCC through the hand-written CUDA kernel of ``csrc/mfcc.cu``.

Port of audiobd_tpu/ops/pallas_mfcc.py::fused_mfcc. Every n_fft goes through
the kernel's Stockham stages, on one of two paths chosen by ``n_fft`` alone
(``mfcc_path``):

* ``"fft"``: n_fft whose prime factors are 2, 3, 5 and 7 (400, the main
  path; 2048, the DABA and FlowMur settings; 2205 = 3²·5·7²). A mixed-radix
  Stockham FFT, two real frames packed into one complex transform, and the
  mel product over each band's nonzero bins. Its host tables come from
  ``fft_plan`` and ``mel_ranges``.
* ``"bluestein"``: every other n_fft (1103, Ultrasonic's 44.1 kHz setting,
  is prime). The same kernel in its chirp mode: the frame pair is multiplied
  by the chirp, transformed at a size L of 2, 3 and 5 of at least
  2·n_fft − 1 (``bluestein_size``), multiplied by the transformed chirp
  kernel, transformed back and multiplied by the chirp again
  (``bluestein_plan``).

Where the kernel keeps its buffers (``mfcc_route``) is a choice by size with
a launch counter each: ``"mfcc_fft"`` and ``"mfcc_bluestein"``, everything
in shared memory at two blocks an SM; ``"mfcc_fft_large"``, the buffers
alone in one block's shared memory, wherever they fit its 227 KB (n_fft
4097's L = 8232 included); ``"mfcc_fft_cluster"``, past that, the transform
split over a thread-block cluster of C CTAs that read each other's shared
memory (``cluster_plan``; n_fft 8193 and 16384); and ``"mfcc_fft_device"``,
the buffers in a device-memory scratch, only where a cluster of 8 cannot hold
them (n_fft 131072). A route that fails to build or launch raises; none
stands in for another. In the log-mel mode (``params.features``) every route
stops before the DCT and writes the floored dB values of the n_mels bands.
On a CPU tensor the wrapper runs the plain version,
``dsp.mfcc`` of the dequantized waveform; ``mfcc_fft_plain``,
``mfcc_bluestein_plain`` and ``mfcc_cluster_plain`` walk the kernel paths'
plans in plain torch, for the tests (``four_step_fft``: the cluster route's
transform, slice by slice).
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import NamedTuple

import numpy as np
import torch

from audiobd_tpu_torch.dsp import mel as _mel
from audiobd_tpu_torch.dsp.mfcc import MFCCParams, mfcc
from audiobd_tpu_torch.dsp.stft import frame_signal, hann_window, num_frames
from audiobd_tpu_torch.ops.build import MAX_SHARED_BYTES, CudaKernel, load_library, ptr
from audiobd_tpu_torch.poison.device_prep import dequantize_pcm

MAX_STAGES = 8  # the kernel's plan holds at most this many Stockham stages
FFT_BUFFER_BYTES = 52 * 1024  # the FFT path's thread groups' ping-pong buffers (csrc/mfcc.cu's note)
# The chirp mode keeps its dB tile in device memory, so its buffers may take
# what the FFT path gives the tile: two 256-thread groups at L = 2240.
BLUESTEIN_BUFFER_BYTES = 76 * 1024
# With twiddles, window and dB tile out of shared memory, the buffers take up
# to this much: two groups at n_fft 2205 (80 KB a block, two blocks an SM).
LARGE_BUFFER_BYTES = 96 * 1024
TWO_BLOCKS_BYTES = 113 * 1024  # a block's shared memory with two blocks on an SM

_I, _P, _F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
_ARGS = [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
         ctypes.POINTER(_I), _I, _I, _I, _I, _F, _I]
# One C entry point; a counter for each route (where the kernel keeps its buffers).
MFCC_FFT_KERNEL = CudaKernel("mfcc_fft", "mfcc.cu", "mfcc_forward", _ARGS)
MFCC_BLUESTEIN_KERNEL = CudaKernel("mfcc_bluestein", "mfcc.cu", "mfcc_forward", _ARGS)
MFCC_LARGE_KERNEL = CudaKernel("mfcc_fft_large", "mfcc.cu", "mfcc_forward", _ARGS)
MFCC_DEVICE_KERNEL = CudaKernel("mfcc_fft_device", "mfcc.cu", "mfcc_forward", _ARGS)
_CLUSTER_ARGS = [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                 ctypes.POINTER(_I), _I, ctypes.POINTER(_I), _I, _I, _I, _I, _I, _F, _I]
MFCC_CLUSTER_KERNEL = CudaKernel("mfcc_fft_cluster", "mfcc.cu", "mfcc_cluster_forward", _CLUSTER_ARGS)
MODE_SHARED, MODE_LARGE, MODE_DEVICE, MODE_CLUSTER = 0, 1, 2, 3
MAX_CLUSTER = 8  # CTAs in a cluster: the portable maximum
CLUSTER_TAIL = 64  # floats after a CTA's two buffers: its warps' maxima and its clip maximum (csrc/mfcc.cu)


def fft_radices(n_fft: int, primes: tuple[int, ...] = (3, 5, 7)) -> tuple[int, ...] | None:
    """The Stockham stages for ``n_fft`` in the order they run: radix 8 while
    three factors of 2 remain, then 4 or 2, then the odd ``primes`` in
    order; None when n_fft has another prime factor or needs more than
    ``MAX_STAGES`` stages."""
    if n_fft < 2:
        return None
    n, twos = n_fft, 0
    while n % 2 == 0:
        n, twos = n // 2, twos + 1
    radices = [8] * (twos // 3) + {0: [], 1: [2], 2: [4]}[twos % 3]
    for p in primes:
        while n % p == 0:
            n //= p
            radices.append(p)
    return tuple(radices) if n == 1 and len(radices) <= MAX_STAGES else None


BLUESTEIN_SLACK = 1.05  # how far above the smallest Bluestein size the plan looks for fewer stages
# The odd radices of a Bluestein size (at n_fft 1103, 2240 = 8·8·5·7 beat 2304: PERF.md).
BLUESTEIN_PRIMES = (3, 5, 7)


def bluestein_size(n_fft: int, primes: tuple[int, ...] = BLUESTEIN_PRIMES) -> int | None:
    """The transform size L of the Bluestein path for ``n_fft``: among the
    products of 2 and ``primes`` from 2·n_fft − 1 to ``BLUESTEIN_SLACK``
    times the smallest of them, the one with the fewest Stockham stages, the
    smaller on a tie (at n_fft 1103: 2240 = 8·8·5·7, 4 stages, over 2205 =
    3·3·5·7·7, 5 stages). None for n_fft < 2 or past the plan's stages."""
    if n_fft < 2:
        return None
    limit = 8 ** MAX_STAGES
    first = next((n for n in itertools.count(2 * n_fft - 1) if n > limit or fft_radices(n, primes)), None)
    if first is None or first > limit:
        return None
    near = [n for n in range(first, int(BLUESTEIN_SLACK * first) + 1) if fft_radices(n, primes) is not None]
    return min(near, key=lambda n: (len(fft_radices(n, primes)), n))


def mfcc_path(n_fft: int) -> str:
    """"fft" when n_fft factors into 2, 3, 5 and 7, else "bluestein". A
    choice by shape: the paths compute the same function."""
    return "fft" if fft_radices(n_fft) is not None else "bluestein"


def smem_bytes(mode: int, chirp: bool, n_fft: int, size: int, groups: int, params: MFCCParams,
               n_frames: int) -> int:
    """Shared memory of one block of the kernel, in bytes, as
    csrc/mfcc.cu::mfcc_smem_bytes counts it."""
    nbytes = 12 * params.n_mels
    if mode == MODE_DEVICE:
        return nbytes
    nbytes += 4 * mel_ranges(params)[1].size + 8 * max(2 * groups * size, (params.n_mels * params.n_dct + 1) // 2)
    if mode == MODE_LARGE:
        return nbytes
    return nbytes + 8 * size + (0 if chirp else 4 * (n_fft + n_frames * params.n_mels))


class ClusterPlan(NamedTuple):
    size: int  # L = l1 · l2
    ctas: int  # C, the CTAs of a cluster; divides l1 and l2
    l1: int  # the first step's sub-transform size: a CTA transforms l2 / C columns of l1 points
    l2: int  # the last step's: a CTA transforms l1 / C rows of l2 points


def row_stride(width: int) -> int:
    """A slice's row stride in complex values: odd, as csrc/mfcc.cu::row_stride
    (the float2 of one column fall in distinct bank pairs)."""
    return width | 1


def cluster_smem_bytes(plan: ClusterPlan) -> int:
    """Shared memory of one CTA of the cluster route, in bytes, as
    csrc/mfcc.cu::mfcc_cluster_smem_bytes counts it: two buffers, each the
    larger of a CTA's two slice layouts (l1 × its l2 / C columns, l2 × its
    l1 / C rows), and the reduction slots."""
    l1, l2, c = plan.l1, plan.l2, plan.ctas
    return 16 * max(l1 * row_stride(l2 // c), l2 * row_stride(l1 // c)) + 4 * CLUSTER_TAIL


@functools.lru_cache(maxsize=32)
def cluster_plan(size: int) -> ClusterPlan | None:
    """The cluster route's split of a transform of ``size`` points: the
    fewest CTAs C (2 to ``MAX_CLUSTER``) for which a factor pair l1 · l2 =
    size, both divisible by C and each with a Stockham plan, fits a CTA's
    shared memory; among such pairs the most even, then the smallest. An
    even split gives both steps many interleaved transforms, whose accesses
    run along a row without bank conflicts (at n_fft 16384, 128 x 128 took
    20% less than 2 x 8192, ``scripts/mfcc_fft_experiments.py``). C need
    not be a power of two: 7⁵ splits only by 7. None when no cluster of
    ``MAX_CLUSTER`` holds it."""
    for ctas in range(2, MAX_CLUSTER + 1):
        plans = [ClusterPlan(size, ctas, l1, size // l1) for l1 in range(ctas, size // ctas + 1, ctas)
                 if size % l1 == 0 and (size // l1) % ctas == 0
                 and fft_radices(l1) is not None and fft_radices(size // l1) is not None]
        plans = [p for p in plans if cluster_smem_bytes(p) <= MAX_SHARED_BYTES]
        if plans:
            return min(plans, key=lambda p: (max(p.l1, p.l2) / min(p.l1, p.l2), cluster_smem_bytes(p), p.l1))
    return None


def cluster_bluestein_size(n_fft: int, primes: tuple[int, ...] = BLUESTEIN_PRIMES) -> int | None:
    """The Bluestein size L of the cluster route for ``n_fft``: among the
    products of 2 and ``primes`` from 2·n_fft − 1 to ``BLUESTEIN_SLACK``
    times the smallest of them, one with a ``cluster_plan``: the fewest CTAs,
    then the fewest Stockham stages, then the smallest. At n_fft 8193 that is
    16464 = 2⁴·3·7³ on 2 CTAs, not ``bluestein_size``'s 16807 = 7⁵, which
    splits only over 7 (twice as slow on an H100,
    ``scripts/mfcc_fft_experiments.py``)."""
    first = next(n for n in itertools.count(2 * n_fft - 1) if fft_radices(n, primes))
    near = [n for n in range(first, int(BLUESTEIN_SLACK * first) + 1)
            if fft_radices(n, primes) is not None and cluster_plan(n) is not None]
    return min(near, key=lambda n: (cluster_plan(n).ctas, len(fft_radices(n, primes)), n), default=None)


class MfccRoute(NamedTuple):
    path: str  # "fft" or "bluestein"
    size: int  # the transform size: n_fft, or the Bluestein L
    mode: int  # where the buffers live: MODE_SHARED, MODE_LARGE, MODE_DEVICE or MODE_CLUSTER
    groups: int  # thread groups of the 512-thread block (1: a CTA of the cluster route)
    smem: int  # shared memory of one block, bytes
    kernel: CudaKernel  # the route's launch counter
    cluster: ClusterPlan | None = None  # MODE_CLUSTER's split


def mfcc_route(params: MFCCParams, n_frames: int) -> MfccRoute:
    """The kernel's route for these settings and frame count: everything in
    shared memory (``MODE_SHARED``) where that layout fits two blocks an SM;
    else the buffers alone in one block's shared memory (``MODE_LARGE``)
    wherever they fit its ``MAX_SHARED_BYTES``; else the transform over a
    cluster's shared memory (``MODE_CLUSTER``, ``cluster_plan``); else the
    buffers in device memory (``MODE_DEVICE``). ``MODE_LARGE`` serves the
    smaller sizes too but is 6% slower on an H100 at n_fft 400 and 10% at
    1103 with the same groups (``scripts/mfcc_fft_experiments.py``), so it
    is the second choice."""
    path = mfcc_path(params.n_fft)
    chirp = path == "bluestein"
    size = bluestein_size(params.n_fft) if chirp else params.n_fft
    if size is None:
        raise ValueError(f"n_fft {params.n_fft} has no transform size the kernel can plan")
    groups = fft_groups(size, BLUESTEIN_BUFFER_BYTES if chirp else FFT_BUFFER_BYTES)
    smem = smem_bytes(MODE_SHARED, chirp, params.n_fft, size, groups, params, n_frames)
    if smem <= TWO_BLOCKS_BYTES:
        return MfccRoute(path, size, MODE_SHARED, groups, smem,
                         MFCC_BLUESTEIN_KERNEL if chirp else MFCC_FFT_KERNEL)
    groups = fft_groups(size, LARGE_BUFFER_BYTES)
    smem = smem_bytes(MODE_LARGE, chirp, params.n_fft, size, groups, params, n_frames)
    if smem <= MAX_SHARED_BYTES:
        return MfccRoute(path, size, MODE_LARGE, groups, smem, MFCC_LARGE_KERNEL)
    cluster_size = cluster_bluestein_size(params.n_fft) if chirp else size
    plan = None if cluster_size is None else cluster_plan(cluster_size)
    if plan is not None:
        return MfccRoute(path, cluster_size, MODE_CLUSTER, 1, cluster_smem_bytes(plan), MFCC_CLUSTER_KERNEL, plan)
    return MfccRoute(path, size, MODE_DEVICE, 1, smem_bytes(MODE_DEVICE, chirp, params.n_fft, size, 1, params,
                                                            n_frames), MFCC_DEVICE_KERNEL)


class FftPlan(NamedTuple):
    radices: tuple[int, ...]
    twiddles: np.ndarray  # (n_fft, 2) f32: exp(-2πik/n_fft) as (cos, sin), built in float64
    window: np.ndarray  # (n_fft,) f32 periodic Hann, built in float64


@functools.lru_cache(maxsize=8)
def fft_plan(n_fft: int) -> FftPlan:
    radices = fft_radices(n_fft)
    if radices is None:
        raise ValueError(f"n_fft {n_fft} is not a product of 2, 3, 5 and 7 in at most {MAX_STAGES} stages")
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
    2·n_fft − 1, a product of 2, 3, 5 and 7), built in float64 and cast to f32.
    With nk = (n² + k² − (k − n)²) / 2 the DFT is X_k = c_k Σ_n (x_n c_n)
    conj(c_{k−n}): a circular convolution at L of u = x·c (zero past N) with h
    (h_m = conj(c_|m|) for |m| < N, wrapped), done as FFT_L⁻¹(FFT_L(u)·FFT_L(h)).
    The kernel table carries the inverse's 1/L."""
    radices = fft_radices(size)
    if radices is None or size < 2 * n_fft - 1:
        raise ValueError(f"Bluestein size {size} for n_fft {n_fft} must be a product of 2, 3, 5 and 7 "
                         f"of at least {2 * n_fft - 1}")
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


@functools.lru_cache(maxsize=8)
def cluster_bands(params: MFCCParams, plan: ClusterPlan) -> np.ndarray:
    """(C, 4) int32: CTA c's mel bands [first, end) and the bins [first, end)
    they read. A band goes to the CTA whose share of the bins holds its
    middle, so each CTA forms the power of about n_bins / C bins (a band
    that straddles two shares is read whole by one CTA, its bins formed by
    both) and its bands' dB values from them alone. The bins must fit the
    buffer that takes the power of two frames."""
    ranges, _ = mel_ranges(params)
    n_bins = params.n_fft // 2 + 1
    mid = np.maximum.accumulate(ranges[:, 0] + ranges[:, 1] // 2)
    owner = np.minimum(mid * plan.ctas // n_bins, plan.ctas - 1)
    table = np.zeros((plan.ctas, 4), np.int32)
    for c in range(plan.ctas):
        mels = np.flatnonzero(owner == c)
        first = int(np.searchsorted(owner, c))
        used = mels[ranges[mels, 1] > 0]
        lo = int(ranges[used, 0].min()) if used.size else 0
        hi = int((ranges[used, 0] + ranges[used, 1]).max()) if used.size else 0
        table[c] = first, first + mels.size, lo, hi
    room = (cluster_smem_bytes(plan) - 4 * CLUSTER_TAIL) // 16  # a buffer's complex values: 2 frames' floats
    if (table[:, 3] - table[:, 2]).max() > room:
        raise ValueError(f"n_fft {params.n_fft}: a CTA's bins pass its power buffer of {room}")
    return table


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


def fft_occupancy(params: MFCCParams, n_samples: int, device: torch.device) -> tuple[MfccRoute, int]:
    """(the route ``mfcc_route`` picks for clips of ``n_samples``, the blocks
    of its kernel that fit one SM), from the CUDA runtime on ``device``."""
    n_frames = num_frames(n_samples, params.n_fft, params.hop_length)
    route = mfcc_route(params, n_frames)
    lib = load_library(MFCC_FFT_KERNEL.source)
    blocks, smem = _I(), _I()
    for code in (lib.use_device(device.index or 0), lib.mfcc_occupancy(
            params.n_fft, route.size, int(route.path == "bluestein"), route.mode, route.groups, params.n_mels,
            params.n_dct, n_frames, mel_ranges(params)[1].size, ctypes.byref(blocks), ctypes.byref(smem))):
        if code:
            raise RuntimeError(f"mfcc_occupancy failed with CUDA error {code}")
    if smem.value != route.smem:
        raise RuntimeError(f"kernel A's shared memory {smem.value} B differs from the host's count {route.smem} B")
    return route, blocks.value


def cluster_occupancy(params: MFCCParams, n_samples: int, device: torch.device) -> tuple[MfccRoute, int]:
    """(the cluster route for clips of ``n_samples``, the clusters of its
    kernel that can be resident at once), from the CUDA runtime on
    ``device``; raises unless ``mfcc_route`` picks the cluster route, or if
    the kernel's count of shared memory differs from the host's."""
    route = mfcc_route(params, num_frames(n_samples, params.n_fft, params.hop_length))
    if route.mode != MODE_CLUSTER:
        raise ValueError(f"n_fft {params.n_fft} does not take the cluster route")
    return route, _cluster_grid(route.cluster, route.path == "bluestein", route.smem, device)


@functools.lru_cache(maxsize=16)
def _cluster_grid(plan: ClusterPlan, chirp: bool, smem: int, device: torch.device) -> int:
    lib = load_library(MFCC_CLUSTER_KERNEL.source)
    r1, r2 = _radix_array(plan.l1), _radix_array(plan.l2)
    clusters, got = _I(), _I()
    for code in (lib.use_device(device.index or 0), lib.mfcc_cluster_occupancy(
            r1, len(r1), r2, len(r2), plan.ctas, int(chirp), ctypes.byref(clusters), ctypes.byref(got))):
        if code:
            raise RuntimeError(f"mfcc_cluster_occupancy failed with CUDA error {code}")
    if got.value != smem:
        raise RuntimeError(f"kernel A's cluster route takes {got.value} B of shared memory a CTA, the host "
                           f"counts {smem} B")
    if clusters.value < 1:
        raise RuntimeError(f"no cluster of {plan.ctas} CTAs with {smem} B each can be resident")
    return clusters.value


def _radix_array(size: int):
    radices = fft_radices(size)
    return (_I * len(radices))(*radices)


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


def _stockham_along(x: torch.Tensor, size: int, table: torch.Tensor) -> torch.Tensor:
    """``stockham_fft`` over the last axis (``size`` points) with the twiddles
    the cluster kernel reads: W_size^j = table[j · L / size] of the L-point
    ``table`` (L, 2) f32."""
    sub = table[:: table.shape[0] // size].numpy()
    return stockham_fft(x, FftPlan(fft_radices(size), sub, None))


def _cluster_four_step(cols: torch.Tensor, s1: int, s2: int, ctas: int, table: torch.Tensor) -> torch.Tensor:
    """The kernel's four_step over a cluster's slices: ``cols`` (..., C, s1,
    s2 / C), CTA c's column n2 = c · q2 + j of x[s2 n1 + n2] at [c, n1, j] →
    (..., C, s2, s1 / C), CTA c's row k1 = c · q1 + r of X[k1 + s1 k2] at
    [c, k2, r]. Step 1 each CTA's columns; step 2 each CTA takes its rows of
    every column from the CTA that holds it, times W_L^{n2 k1}; step 3 the rows."""
    q1, q2 = s1 // ctas, s2 // ctas
    tw = torch.complex(*table.to(cols.device).unbind(-1))
    y = _stockham_along(cols.transpose(-1, -2), s1, table)  # (..., C, q2, s1): [c, j, k1]
    n2 = torch.arange(s2, device=cols.device)
    k1 = torch.arange(ctas, device=cols.device)[:, None] * q1 + torch.arange(q1, device=cols.device)  # (C, q1)
    rows = y[..., n2[None, :, None] // q2, n2[None, :, None] % q2, k1[:, None, :]]  # (..., C, s2, q1)
    rows = rows * tw[n2[None, :, None] * k1[:, None, :]]
    return _stockham_along(rows.transpose(-1, -2), s2, table).transpose(-1, -2)  # [c, k2, r]


def _cluster_natural(slices: torch.Tensor, a_size: int, n: int) -> torch.Tensor:
    """Elements k < n of a transform held as the kernel's final slices
    (..., C, L / a_size, a_size / C): k = a + a_size · b at [a // qa, b, a % qa]
    (csrc/mfcc.cu::spectrum_at)."""
    k = torch.arange(n, device=slices.device)
    a, b = k % a_size, k // a_size
    qa = slices.shape[-1]
    return slices[..., a // qa, b, a % qa]


def four_step_fft(z: torch.Tensor, plan: ClusterPlan, table: torch.Tensor | None = None) -> torch.Tensor:
    """Complex DFT over the last axis (L = plan.size) of ``z`` as the cluster
    route computes it: x cut into the C CTAs' slices of l2 / C columns
    (x[l2 n1 + n2]), ``_cluster_four_step``, then read back in natural order
    from the CTA that holds each element. ``table``: the (L, 2) twiddles,
    fft_plan(L)'s f32 ones by default (float64 ones for a complex128 z)."""
    table = torch.from_numpy(fft_plan(plan.size).twiddles) if table is None else table
    c, l1, l2 = plan.ctas, plan.l1, plan.l2
    cols = z.reshape(*z.shape[:-1], l1, c, l2 // c).movedim(-2, -3)  # [c, n1, j]
    return _cluster_natural(_cluster_four_step(cols, l1, l2, c, table), l1, plan.size)


def cluster_bluestein_fft(z: torch.Tensor, plan: BluesteinPlan, cplan: ClusterPlan, pre: torch.Tensor) -> torch.Tensor:
    """``bluestein_fft``'s steps as the cluster route takes them: u = z·pre
    zero-padded to L in the CTAs' column slices, U by ``_cluster_four_step``
    (l1 × l2), V = conj(U·H) on each CTA's rows, and the inverse as the
    forward transform of V at l2 × l1, whose columns are those rows; then
    Z_k = c_k·conj(y_k) for k < N."""
    n = z.shape[-1]
    c, l1, l2 = cplan.ctas, cplan.l1, cplan.l2
    table = torch.from_numpy(plan.fft.twiddles)
    post, ck = (torch.complex(*torch.from_numpy(a).to(z.device).unbind(-1)) for a in (plan.post, plan.kernel))
    u = torch.zeros((*z.shape[:-1], plan.size), dtype=z.dtype, device=z.device)
    u[..., :n] = z * pre
    cols = u.reshape(*u.shape[:-1], l1, c, l2 // c).movedim(-2, -3)
    spec = _cluster_four_step(cols, l1, l2, c, table)  # [c, k2, r]: k = c·q1 + r + l1·k2
    k = (torch.arange(c)[:, None, None] * (l1 // c) + torch.arange(l1 // c) + l1 * torch.arange(l2)[:, None])
    y = _cluster_four_step(torch.conj(spec * ck[k.to(z.device)]), l2, l1, c, table)
    return post * torch.conj(_cluster_natural(y, l2, n))


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


def mfcc_cluster_plain(wavs: torch.Tensor, params: MFCCParams) -> torch.Tensor:
    """The cluster route's function in plain torch: frame pairs packed as on
    the other paths, transformed by ``four_step_fft`` (FFT path) or
    ``cluster_bluestein_fft`` on the route's ``cluster_plan``."""
    chirp = mfcc_path(params.n_fft) == "bluestein"
    size = cluster_bluestein_size(params.n_fft) if chirp else params.n_fft
    cplan = cluster_plan(size)
    if not chirp:
        pairs, n_frames = _packed_frames(wavs, params, fft_plan(params.n_fft).window)
        return _mfcc_from_pairs(four_step_fft(pairs, cplan), n_frames, params)
    plan = bluestein_plan(params.n_fft, size)
    pairs, n_frames = _packed_frames(wavs, params, None)
    pre = torch.complex(*torch.from_numpy(plan.pre).to(pairs.device).unbind(-1))
    return _mfcc_from_pairs(cluster_bluestein_fft(pairs, plan, cplan, pre), n_frames, params)


def _mfcc_from_pairs(z: torch.Tensor, n_frames: int, params: MFCCParams) -> torch.Tensor:
    """Spectra of packed frame pairs (..., ⌈F/2⌉, n_fft) → (..., F, n_out):
    separate, power, mel over each band's range, dB with top_db, DCT (not in
    the log-mel mode)."""
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
    return db @ torch.from_numpy(params.dct()).to(z.device) if params.n_dct else db


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
def _cluster_band_table(params: MFCCParams, plan: ClusterPlan, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(cluster_bands(params, plan)).to(device)


def fused_mfcc(wavs: torch.Tensor, params: MFCCParams) -> torch.Tensor:
    """(B, T) float32 or int16 PCM → (B, n_frames, n_out) float32, the
    function of ``dsp.mfcc`` (int16 is scaled by 2⁻¹⁵ first). On a CUDA
    tensor it launches the kernel on the route ``mfcc_route`` picks: the FFT
    path or the chirp (Bluestein) mode, its buffers where the sizes allow
    (a cluster of CTAs past one block's shared memory). The log-mel mode
    hands the kernel no DCT table: it writes the floored dB tile."""
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
    out = torch.empty((batch, n_frames, params.n_out), dtype=torch.float32, device=wavs.device)
    if batch == 0:
        return out
    is_int16 = int(wavs.dtype == torch.int16)
    reflect = int(params.pad_mode == "reflect")
    top_db, use_top_db = float(params.top_db or 0.0), int(params.top_db is not None)
    route = mfcc_route(params, n_frames)
    chirped = route.path == "bluestein"
    if chirped:
        twiddles, pre, post, kernel, ranges, weights, dct = _bluestein_tables(params, route.size, wavs.device)
        window = None
    else:
        twiddles, window, ranges, weights, dct = _fft_tables(params, wavs.device)
        pre = post = kernel = None
    if not params.n_dct:
        dct = None
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=wavs.device)  # noqa: E731
    db = None if route.mode == MODE_SHARED and not chirped else new(batch, n_frames, params.n_mels)
    opt = lambda t: None if t is None else ptr(t)  # noqa: E731
    if route.mode == MODE_CLUSTER:
        plan = route.cluster
        clusters = min(batch, _cluster_grid(plan, chirped, route.smem, wavs.device))
        bands = _cluster_band_table(params, plan, wavs.device)
        r1, r2 = _radix_array(plan.l1), _radix_array(plan.l2)
        route.kernel(
            wavs.device,
            ptr(wavs), is_int16, batch, n_samples,
            ptr(twiddles), opt(window), opt(pre), opt(post), opt(kernel), ptr(ranges), ptr(weights), ptr(bands),
            opt(dct), ptr(db), ptr(out),
            params.n_fft, params.hop_length, params.n_mels, params.n_dct, n_frames,
            r1, len(r1), r2, len(r2), plan.ctas, clusters, int(chirped), reflect, top_db, use_top_db,
        )
        return out
    radices = fft_radices(route.size)
    grid, scratch = batch, None
    if route.mode == MODE_DEVICE:
        # As many blocks as are resident (two an SM), each looping over clips.
        grid = min(batch, 2 * torch.cuda.get_device_properties(wavs.device).multi_processor_count)
        scratch = new(grid, 2 * route.groups * route.size, 2)
    route.kernel(
        wavs.device,
        ptr(wavs), is_int16, batch, n_samples,
        ptr(twiddles), opt(window), opt(pre), opt(post), opt(kernel), ptr(ranges), ptr(weights), weights.numel(),
        opt(dct), opt(db), opt(scratch), ptr(out),
        params.n_fft, route.size, params.hop_length, params.n_mels, params.n_dct, n_frames,
        route.groups, grid, (_I * len(radices))(*radices), len(radices), int(chirped), route.mode,
        reflect, top_db, use_top_db,
    )
    return out


def fused_mfcc_features(wavs: torch.Tensor, params: MFCCParams) -> torch.Tensor:
    """(B, T) or (B, 1, T) → (B, 1, frames, n_out), the model-input layout."""
    if wavs.ndim == 3 and wavs.shape[-2] == 1:
        wavs = wavs.squeeze(-2)
    return fused_mfcc(wavs, params)[:, None]
