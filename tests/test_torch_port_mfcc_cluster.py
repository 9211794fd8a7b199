"""Kernel A's cluster route (csrc/mfcc.cu::mfcc_cluster_kernel): transforms
past one block's shared memory, split four-step style over a thread-block
cluster whose CTAs read each other's shared memory.

On the host side: ``cluster_plan``'s split (L = l1 · l2, C dividing both,
a CTA's slices within the card's 227 KB), ``cluster_bands``' mel bands a
CTA, and ``four_step_fft`` / ``cluster_bluestein_fft``, which walk the
kernel's decomposition slice by slice, against numpy's FFT in float64. The
whole function through them (``mfcc_cluster_plain``) against the JAX package
at n_fft 8193 (its plain ``mfcc_features``: the Pallas kernel's bases at that
size are too large for interpret mode) and against a float64 MFCC at 16384
(JAX's DFT bases there take 1 GB).

The kernel itself runs here too: mfcc.cu compiled by g++ against a small
emulation of what the cluster route uses (one std::thread a CUDA thread, a
std::barrier a CTA and one a cluster for barrier.cluster's arrive and wait,
a peer's shared memory at the same offset of its buffer for
map_shared_rank), launched through its C entry on the host's tables, and
held against plain ``dsp.mfcc``.

Tolerances: MFCC rtol 1e-4, atol 1e-3, as tests/test_pallas_mfcc.py (f32 on
both sides, sums in another order); against float64 atol 1e-3, the bound
chip_smoke.py holds the card's kernels to. The float64 four-step against
numpy: 1e-5 of the largest magnitude (measured ~1e-15); its f32 run within
1e-6 (measured ~2e-7).
"""

import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiobd_tpu.dsp import MFCCParams as JaxMFCCParams
from audiobd_tpu.dsp import mfcc_features as jax_mfcc_features
from audiobd_tpu_torch.dsp import MFCCParams, mfcc
from audiobd_tpu_torch.dsp.mel import amplitude_to_db
from audiobd_tpu_torch.dsp.stft import frame_signal, hann_window, num_frames
from audiobd_tpu_torch.ops import mfcc as op
from audiobd_tpu_torch.ops.build import CSRC_DIR, MAX_SHARED_BYTES
from audiobd_tpu_torch.poison.device_prep import dequantize_pcm

RTOL, ATOL = 1e-4, 1e-3


def _table64(size):
    angle = -2.0 * np.pi * np.arange(size) / size
    return torch.from_numpy(np.stack([np.cos(angle), np.sin(angle)], axis=1))


def _clips(n, n_samples, seed, dtype="float32"):
    x = (np.random.default_rng(seed).standard_normal((n, n_samples)) * 0.1).astype(np.float32)
    if dtype == "int16":
        x = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
    return x


def _mfcc64(x, params):
    """dsp.mfcc's function in float64 with torch.fft."""
    frames = frame_signal(x.double(), params.n_fft, params.hop_length, pad_mode=params.pad_mode)
    spec = torch.fft.rfft(frames * torch.from_numpy(hann_window(params.n_fft)), dim=-1).abs() ** 2
    mel = spec @ torch.from_numpy(params.mel_fb()).double()
    return amplitude_to_db(mel, top_db=params.top_db) @ torch.from_numpy(params.dct()).double()


@pytest.mark.parametrize("size,plan", [
    (16384, (2, 128, 128)),  # n_fft 16384: two CTAs, each 64 columns, then 64 rows
    (16464, (2, 98, 168)),  # 2⁴·3·7³, n_fft 8193's Bluestein L on the cluster route
    (16807, (7, 49, 343)),  # 7⁵, bluestein_size(8193): only 7 divides it
    (32768, (4, 128, 256)),
    (65536, (8, 256, 256)),  # the largest power of two a cluster of 8 holds
    (12288, (2, 96, 128)),
    (131072, None),  # past a cluster of 8: the device-memory route's
])
def test_cluster_plan_invariants(size, plan):
    """L = l1 · l2, C dividing both, each with a Stockham plan, a CTA's two
    buffers and reduction slots within MAX_SHARED_BYTES; the fewest CTAs,
    and of their splits the most even."""
    got = op.cluster_plan(size)
    assert (None if got is None else (got.ctas, got.l1, got.l2)) == plan
    if got is None:
        return
    assert got.l1 * got.l2 == size and got.l1 % got.ctas == 0 and got.l2 % got.ctas == 0
    assert op.fft_radices(got.l1) is not None and op.fft_radices(got.l2) is not None
    assert 2 <= got.ctas <= op.MAX_CLUSTER and op.cluster_smem_bytes(got) <= MAX_SHARED_BYTES
    slices = max(got.l1 * op.row_stride(got.l2 // got.ctas), got.l2 * op.row_stride(got.l1 // got.ctas))
    assert op.cluster_smem_bytes(got) == 16 * slices + 4 * op.CLUSTER_TAIL
    assert slices >= size // got.ctas


@pytest.mark.parametrize("n_fft", [8193, 16384, 12288])
def test_cluster_bands_cover_every_band_once(n_fft):
    """Each mel band is formed by exactly one CTA, the bands in order, and
    that CTA forms the power of every bin the band reads, within the buffer
    that takes two frames' power."""
    params = MFCCParams(sample_rate=44100, n_fft=n_fft, hop_length=441)
    route = op.mfcc_route(params, num_frames(44100, n_fft, 441))
    assert route.mode == op.MODE_CLUSTER
    plan = route.cluster
    bands = op.cluster_bands(params, plan)
    ranges, _ = op.mel_ranges(params)
    assert bands.shape == (plan.ctas, 4) and bands[0, 0] == 0 and bands[-1, 1] == params.n_mels
    assert (bands[1:, 0] == bands[:-1, 1]).all()
    for mel0, mel1, bin0, bin1 in bands:
        for first, count, _ in ranges[mel0:mel1]:
            assert count == 0 or bin0 <= first and first + count <= bin1
    room = (op.cluster_smem_bytes(plan) - 4 * op.CLUSTER_TAIL) // 16
    assert (bands[:, 3] - bands[:, 2]).max() <= room
    # a CTA's share of the bins and at most the two bands that straddle its edges
    share = (params.n_fft // 2 + 1) / plan.ctas
    assert (bands[:, 3] - bands[:, 2]).max() <= share + 2 * ranges[:, 1].max()


@pytest.mark.parametrize("size", [16384, 16807, 32768])
def test_four_step_fft_matches_numpy(size):
    """The cluster decomposition in float64 (the L-point twiddle table in
    float64), and in f32 on the kernel's own f32 table."""
    rng = np.random.default_rng(size)
    z = rng.standard_normal((2, size)) + 1j * rng.standard_normal((2, size))
    ref = np.fft.fft(z)
    plan = op.cluster_plan(size)
    got = op.four_step_fft(torch.from_numpy(z), plan, _table64(size)).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    got32 = op.four_step_fft(torch.from_numpy(z.astype(np.complex64)), plan).numpy()
    assert np.abs(got32 - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("plan", [op.ClusterPlan(256, 2, 16, 16), op.ClusterPlan(256, 4, 8, 32),
                                  op.ClusterPlan(196, 7, 28, 7), op.ClusterPlan(16384, 2, 2, 8192)],
                         ids=str)
def test_four_step_fft_any_split(plan):
    """Any split the kernel can take (even, uneven, 7 CTAs, one row a CTA),
    not only the one cluster_plan picks."""
    rng = np.random.default_rng(plan.size + plan.ctas)
    z = rng.standard_normal((3, plan.size)) + 1j * rng.standard_normal((3, plan.size))
    ref = np.fft.fft(z)
    got = op.four_step_fft(torch.from_numpy(z), plan, _table64(plan.size)).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("n_fft,size", [(8193, None), (8193, 16807), (97, 196)])
def test_cluster_bluestein_fft_matches_numpy(n_fft, size):
    """The Bluestein steps on the cluster: the inverse transform starts from
    the forward one's rows, at l2 × l1. At the route's size (16464 on 2
    CTAs), at 7⁵ on 7 and at 196 on 7 (28 x 7). f32 tables, so 1e-5 as
    test_torch_port_mfcc_bluestein.py."""
    size = size or op.cluster_bluestein_size(n_fft)
    plan = op.bluestein_plan(n_fft, size)
    cplan = op.cluster_plan(size) if size > 1000 else op.ClusterPlan(size, 7, 28, 7)
    rng = np.random.default_rng(n_fft)
    z = (rng.standard_normal((2, n_fft)) + 1j * rng.standard_normal((2, n_fft))).astype(np.complex64)
    post = torch.complex(*torch.from_numpy(plan.post).unbind(-1))
    got = op.cluster_bluestein_fft(torch.from_numpy(z), plan, cplan, post).numpy()
    ref = np.fft.fft(z.astype(np.complex128))
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_mfcc_cluster_plain_matches_jax_at_8193(dtype):
    """n_fft 8193 (Bluestein, L 16464 on 2 CTAs) on 2 clips of 44,100
    samples against audiobd_tpu.dsp.mfcc_features."""
    kw = dict(sample_rate=44100, n_mfcc=40, n_fft=8193, hop_length=441, parity="torchaudio")
    x = _clips(2, 44100, seed=31, dtype=dtype)
    wav_f32 = x.astype(np.float32) / 32768.0 if dtype == "int16" else x
    got = op.mfcc_cluster_plain(torch.from_numpy(x), MFCCParams(**kw)).numpy()
    ref = np.asarray(jax_mfcc_features(jnp.asarray(wav_f32), JaxMFCCParams(**kw)))[:, 0]
    assert got.shape == ref.shape == (2, 100, 40)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("parity", ["torchaudio", "librosa"])
def test_mfcc_cluster_plain_matches_float64_at_16384(parity):
    params = MFCCParams(sample_rate=44100, n_fft=16384, hop_length=441, parity=parity)
    x = torch.from_numpy(_clips(2, 44100, seed=32))
    got = op.mfcc_cluster_plain(x, params)
    assert got.shape == (2, 101, 40)
    assert (got.double() - _mfcc64(x, params)).abs().max() <= ATOL


# ---------------------------------------------------------------------------
# the kernel, emulated

MOCK = r"""
#pragma once
#include <math.h>
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <memory>
#include <optional>
#include <thread>
#include <tuple>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(...)
#define __align__(x) alignas(x)
#define __shared__
#define CUDART_INF_F INFINITY
struct alignas(8) float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
thread_local dim3 threadIdx, blockIdx, gridDim, blockDim;
using std::max;
using std::min;
template <class T> inline T __ldg(const T* p) { return *p; }
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize, cudaFuncAttributePreferredSharedMemoryCarveout };
enum { cudaSharedmemCarveoutMaxShared = 100 };
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension };
struct cudaLaunchAttributeValue { struct { unsigned x, y, z; } clusterDim; };
struct cudaLaunchAttribute { cudaLaunchAttributeID id; cudaLaunchAttributeValue val; };
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim; size_t dynamicSmemBytes; cudaStream_t stream; cudaLaunchAttribute* attrs; unsigned numAttrs;
};
template <class T> cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute a, int v) {
  return a == cudaFuncAttributeMaxDynamicSharedMemorySize && v > 232448 ? cudaErrorInvalidValue : cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
template <class T> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, T, int, size_t) {
  *n = 1; return cudaSuccess;
}
inline int EMU_CLUSTERS = 2;  // what the emulated card says can be resident
inline cudaError_t cudaOccupancyMaxActiveClusters(int* n, const void*, const cudaLaunchConfig_t*) {
  *n = EMU_CLUSTERS; return cudaSuccess;
}
template <class... A> void emu_launch(A&&...) {}  // the one-block routes are not run here

thread_local float* emu_smem;
thread_local float* const* emu_cluster_smem;
thread_local std::barrier<>* emu_warp;
thread_local float* emu_shfl;
thread_local int emu_rank;
thread_local std::barrier<>* emu_block;
thread_local std::barrier<>* emu_cluster;
thread_local std::optional<std::barrier<>::arrival_token> emu_token;
inline void __syncthreads() { emu_block->arrive_and_wait(); }
inline void __threadfence() {}
inline float __shfl_xor_sync(unsigned, float v, int o) {  // every lane of the warp calls it together
  emu_shfl[threadIdx.x] = v;
  emu_warp->arrive_and_wait();
  const float r = emu_shfl[threadIdx.x ^ o];
  emu_warp->arrive_and_wait();
  return r;
}

// Clusters one after another; a cluster's CTAs at once, a thread each CUDA
// thread. Shared memory starts as NaN, so a read before a write shows.
template <class... E, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(E...), A&&... args) {
  const unsigned ctas = cfg->attrs[0].val.clusterDim.x, nt = cfg->blockDim.x;
  std::tuple<E...> targs(std::forward<A>(args)...);
  for (unsigned g = 0; g < cfg->gridDim.x / ctas; ++g) {
    std::vector<std::vector<float>> smem(ctas, std::vector<float>(cfg->dynamicSmemBytes / 4 + 1, NAN));
    std::vector<std::vector<float>> shfl(ctas, std::vector<float>(nt));
    std::vector<float*> bases;
    std::vector<std::unique_ptr<std::barrier<>>> blocks, warps;
    for (unsigned c = 0; c < ctas; ++c) {
      bases.push_back(smem[c].data());
      blocks.push_back(std::make_unique<std::barrier<>>(nt));
      for (unsigned w = 0; w < nt / 32; ++w) warps.push_back(std::make_unique<std::barrier<>>(32));
    }
    std::barrier<> cluster(ctas * nt);
    std::vector<std::thread> ts;
    for (unsigned c = 0; c < ctas; ++c)
      for (unsigned t = 0; t < nt; ++t)
        ts.emplace_back([&, c, t] {
          threadIdx = dim3(t); blockIdx = dim3(g * ctas + c); gridDim = cfg->gridDim; blockDim = cfg->blockDim;
          emu_rank = c; emu_smem = bases[c]; emu_cluster_smem = bases.data(); emu_shfl = shfl[c].data();
          emu_block = blocks[c].get(); emu_warp = warps[c * (nt / 32) + t / 32].get(); emu_cluster = &cluster;
          std::apply(kernel, targs);
        });
    for (auto& th : ts) th.join();
  }
  return cudaSuccess;
}
"""

CLUSTER_FEATURES = r"""
inline int cta_rank() { return emu_rank; }
inline void cluster_arrive() { emu_token.emplace(emu_cluster->arrive()); }
inline void cluster_wait() { emu_cluster->wait(std::move(*emu_token)); emu_token.reset(); }
template <class T> inline T* peer(T* p, int rank) {
  return reinterpret_cast<T*>(reinterpret_cast<char*>(emu_cluster_smem[rank]) +
                              (reinterpret_cast<char*>(p) - reinterpret_cast<char*>(emu_smem)));
}
"""

HARNESS = r"""
#include <cstdio>
#include <fstream>
#include <iterator>
#include <string>

static std::vector<char> slurp(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  return std::vector<char>(std::istreambuf_iterator<char>(f), {});
}
template <class T> static const T* table(std::vector<char>& v) {
  return v.empty() ? nullptr : reinterpret_cast<const T*>(v.data());
}

int main(int argc, char** argv) {
  // argv[1]: a directory of the host's tables and ints.txt; writes out.f32 there.
  const std::string d = argv[1];
  std::ifstream in(d + "/ints.txt");
  int is_int16, batch, n_samples, n_fft, hop, n_mels, n_mfcc, n_frames, ctas, chirp, reflect, use_top_db, n1, n2;
  float top_db;
  in >> is_int16 >> batch >> n_samples >> n_fft >> hop >> n_mels >> n_mfcc >> n_frames >> ctas >> chirp >> reflect
     >> top_db >> use_top_db >> EMU_CLUSTERS >> n1;
  std::vector<int> r1(n1);
  for (int& r : r1) in >> r;
  in >> n2;
  std::vector<int> r2(n2);
  for (int& r : r2) in >> r;
  std::vector<char> wav = slurp(d + "/wav.bin"), tw = slurp(d + "/twiddles.bin"), win = slurp(d + "/window.bin"),
                    pre = slurp(d + "/pre.bin"), post = slurp(d + "/post.bin"), ck = slurp(d + "/kernel.bin"),
                    ranges = slurp(d + "/ranges.bin"), weights = slurp(d + "/weights.bin"),
                    bands = slurp(d + "/bands.bin"), dct = slurp(d + "/dct.bin");
  int clusters = 0, smem = 0;
  int err = mfcc_cluster_occupancy(r1.data(), n1, r2.data(), n2, ctas, chirp, &clusters, &smem);
  printf("occupancy %d clusters %d smem %d\n", err, clusters, smem);
  std::vector<float> db((size_t)batch * n_frames * n_mels, NAN), out((size_t)batch * n_frames * n_mfcc, NAN);
  err = mfcc_cluster_forward(wav.data(), is_int16, batch, n_samples, table<float>(tw), table<float>(win),
                             table<float>(pre), table<float>(post), table<float>(ck), table<int>(ranges),
                             table<float>(weights), table<int>(bands), table<float>(dct), db.data(), out.data(),
                             n_fft, hop, n_mels, n_mfcc, n_frames, r1.data(), n1, r2.data(), n2, ctas,
                             std::min(batch, clusters), chirp, reflect, top_db, use_top_db, nullptr);
  printf("launch %d\n", err);
  std::ofstream(d + "/out.f32", std::ios::binary).write(reinterpret_cast<char*>(out.data()), out.size() * 4);
  // a plan C does not divide, and one past a CTA's shared memory, are refused
  const int three[1] = {3}, r4096[4] = {8, 8, 8, 8};
  int c2, s2;
  printf("refused %d %d\n", mfcc_cluster_occupancy(three, 1, r4096, 4, 2, 0, &c2, &s2) != 0,
         mfcc_cluster_occupancy(r4096, 4, r4096, 4, 2, 0, &c2, &s2) != 0);
  return 0;
}
"""


def _host_source(cu: str) -> str:
    """mfcc.cu with the CUDA features it uses swapped for the emulation's."""
    src = cu
    for inc in ("#include <cooperative_groups.h>\n", "#include <cuda_runtime.h>\n", "#include <math_constants.h>\n"):
        assert inc in src
        src = src.replace(inc, "")
    src = '#include "mock_cuda.h"\n' + src
    src = src.replace("extern __shared__ __align__(16) float smem[];", "float* smem = emu_smem;")
    for name in ("cta_rank", "cluster_arrive", "cluster_wait"):
        src, n = re.subn(rf"__device__ __forceinline__ \w+ {name}\(\) \{{.*?\n\}}\n", "", src, flags=re.S)
        assert n == 1, name
    src, n = re.subn(r"template <class T>\n__device__ __forceinline__ T\* peer\(.*?\n\}\n", CLUSTER_FEATURES, src,
                     flags=re.S)
    assert n == 1
    src, n = re.subn(r"(__device__ __forceinline__ void group_sync\(int group, int size\) \{).*?\n\}\n",
                     r"\1 __syncthreads(); }\n", src, flags=re.S)
    assert n == 1
    src = re.sub(r"(\w+)<<<(.*?)>>>\((.*?)\);", r"emu_launch(\1, \2, \3);", src, flags=re.S)
    assert "asm" not in src and "<<<" not in src and "cooperative_groups" not in src
    return src


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """mfcc.cu built with the emulation, once."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulation")
    d = tmp_path_factory.mktemp("mfcc_cluster_emulation")
    (d / "mock_cuda.h").write_text(MOCK)
    (d / "mfcc_host.cpp").write_text(_host_source((CSRC_DIR / "mfcc.cu").read_text()))
    (d / "harness.cpp").write_text('#include "mfcc_host.cpp"\n' + HARNESS)
    build = subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-w", "-o", str(d / "harness"),
                            str(d / "harness.cpp")], capture_output=True, text=True)
    assert build.returncode == 0, build.stderr[-4000:]
    return d / "harness"


def _run_emulated(harness, d, x: np.ndarray, params: MFCCParams, plan: op.ClusterPlan, resident: int):
    """The kernel's C entry on the host's tables for clips ``x``: (MFCCs,
    the harness's printed lines)."""
    d.mkdir()
    chirp = op.mfcc_path(params.n_fft) == "bluestein"
    n_frames = num_frames(x.shape[1], params.n_fft, params.hop_length)
    if chirp:
        bp = op.bluestein_plan(params.n_fft, plan.size)
        tables = dict(twiddles=bp.fft.twiddles, pre=bp.pre, post=bp.post, kernel=bp.kernel)
    else:
        fp = op.fft_plan(params.n_fft)
        tables = dict(twiddles=fp.twiddles, window=fp.window)
    ranges, weights = op.mel_ranges(params)
    tables.update(wav=x, ranges=ranges, weights=weights, bands=op.cluster_bands(params, plan), dct=params.dct())
    for name, a in tables.items():
        (d / f"{name}.bin").write_bytes(np.ascontiguousarray(a).tobytes())
    r1, r2 = op.fft_radices(plan.l1), op.fft_radices(plan.l2)
    ints = [int(x.dtype == np.int16), x.shape[0], x.shape[1], params.n_fft, params.hop_length, params.n_mels,
            params.n_mfcc, n_frames, plan.ctas, int(chirp), int(params.pad_mode == "reflect"),
            params.top_db or 0.0, int(params.top_db is not None), resident, len(r1), *r1, len(r2), *r2]
    (d / "ints.txt").write_text(" ".join(map(str, ints)))
    run = subprocess.run([str(harness), str(d)], capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    out = np.fromfile(d / "out.f32", np.float32).reshape(x.shape[0], n_frames, params.n_mfcc)
    return out, run.stdout.splitlines()


@pytest.mark.parametrize("case", [
    # (n_fft, hop, clips, samples, dtype, extra params, plan or None for cluster_plan's, resident clusters)
    (256, 64, 3, 1000, "float32", dict(sample_rate=16000), op.ClusterPlan(256, 2, 16, 16), 2),
    (256, 100, 2, 900, "int16", dict(sample_rate=16000, parity="librosa", top_db=None),
     op.ClusterPlan(256, 4, 8, 32), 1),
    (97, 30, 2, 400, "float32", dict(sample_rate=16000, n_mels=40, n_mfcc=13), op.ClusterPlan(196, 7, 28, 7), 2),
    (16384, 2048, 3, 9000, "int16", dict(sample_rate=44100), None, 2),
    (8193, 2048, 2, 9000, "float32", dict(sample_rate=44100, parity="librosa"), None, 1),
    (8193, 4096, 1, 9000, "float32", dict(sample_rate=44100), op.ClusterPlan(16807, 7, 49, 343), 1),
], ids=["fft-256-c2", "fft-256-c4-int16-librosa-no-top-db", "bluestein-97-c7", "fft-16384-c2-int16",
        "bluestein-8193-c2-librosa", "bluestein-8193-L16807-c7"])
def test_cluster_kernel_emulated_matches_plain(harness, tmp_path, case):
    """The kernel's code, CTA slices, DSMEM reads, cluster barriers and
    clip loop (more clips than resident clusters in three cases), on the
    CPU, against plain dsp.mfcc; its shared-memory count against the
    host's, and a plan C does not divide or too large for a CTA refused."""
    n_fft, hop, clips, n_samples, dtype, extra, plan, resident = case
    params = MFCCParams(n_fft=n_fft, hop_length=hop, **extra)
    if plan is None:
        route = op.mfcc_route(params, num_frames(n_samples, n_fft, hop))
        assert route.mode == op.MODE_CLUSTER
        plan = route.cluster
    x = _clips(clips, n_samples, seed=n_fft + clips, dtype=dtype)
    got, lines = _run_emulated(harness, tmp_path / "run", x, params, plan, resident)
    assert lines[0] == f"occupancy 0 clusters {resident} smem {op.cluster_smem_bytes(plan)}"
    assert lines[1] == "launch 0" and lines[2] == "refused 1 1"
    ref = mfcc(dequantize_pcm(torch.from_numpy(x)), params).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
