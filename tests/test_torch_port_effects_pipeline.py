"""Kernel F's stage pipelines (csrc/effects.cu) run on the CPU: the source
compiled by g++ against a small emulation of the CUDA features it uses, one
std::thread a CUDA thread and a std::barrier a block, so the pipelines'
schedule (the ring of slots, the loader's look-ahead, the storer, the stages
packed into a warp's lanes, the masked rows and the ragged last tile) is held
to the one-thread kernels and to the plain loops without a card.

cp.async is emulated two ways: each copy lands at once, or each group lands
as late as its cp.async.wait_group allows (on the card it lands in between),
so a read of a tile before its group was awaited, or a slot refilled while
still in use, shows in one of them. The warp vote __any_sync answers true:
every lane then runs the stage code each step, its writes predicated as on
the card. tanhf is the host's, the same in the pipeline and in the
one-thread kernel it is compared with; the phaser has no transcendental and
is held to ops/effects.py::phaser_plain itself. Exact throughout (the k = 0
ladder as values: a zero's sign may differ, NaN where NaN).
"""

import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from audiobd_tpu_torch.ops import effects as op
from audiobd_tpu_torch.ops.build import CSRC_DIR, MAX_SHARED_BYTES

MOCK = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <functional>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(x)
struct float4 { float x, y, z, w; } __attribute__((aligned(16)));
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
thread_local dim3 threadIdx, blockIdx;
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
using std::min;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class T> cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int v) {
  return v <= 232448 ? cudaSuccess : cudaErrorInvalidValue;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline bool __any_sync(unsigned, bool) { return true; }
inline float4* g_shared;
inline std::barrier<>* g_barrier;
inline void __syncthreads() { g_barrier->arrive_and_wait(); }
inline int EMU_LATE = 0;
thread_local std::vector<std::function<void()>> emu_open;
thread_local std::deque<std::vector<std::function<void()>>> emu_groups;
inline void emu_copy(float* dst, const float* src, bool valid) {
  float v[4];
  for (int i = 0; i < 4; ++i) v[i] = valid ? src[i] : 0.f;
  if (!EMU_LATE) { std::memcpy(dst, v, 16); return; }
  emu_open.push_back([dst, a = v[0], b = v[1], c = v[2], d = v[3]] { dst[0] = a; dst[1] = b; dst[2] = c; dst[3] = d; });
}
inline void emu_commit() { emu_groups.push_back(std::move(emu_open)); emu_open.clear(); }
inline void emu_wait(int n) {
  while ((int)emu_groups.size() > n) { for (auto& f : emu_groups.front()) f(); emu_groups.pop_front(); }
}
template <class K, class... A>
void emulate_launch(K kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t, A... args) {
  for (unsigned b = 0; b < grid.x; ++b) {
    std::vector<float4> buf(smem / 16 + 1, float4{NAN, NAN, NAN, NAN});  // a read before a write shows
    g_shared = buf.data();
    std::barrier<> bar(block.x);
    g_barrier = &bar;
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < block.x; ++t)
      ts.emplace_back([&, t] { threadIdx = dim3(t); blockIdx = dim3(b); kernel(args...); });
    for (auto& th : ts) th.join();
  }
}
"""

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <random>

static bool same(float a, float b) { return (std::isnan(a) && std::isnan(b)) || a == b; }

int main(int argc, char** argv) {
  // argv: out_dir; writes phaser outputs for Python and prints shared bytes and failures.
  const char* out = argv[1];
  int fails = 0;
  std::normal_distribution<float> nd(0.f, 0.6f);
  printf("shared ladder %d", ladder_slots().shared_bytes());
  for (int st = 1; st <= 8; ++st) printf(" %d", phaser_slots(st).shared_bytes());
  printf("\n");
  for (int late = 0; late < 2; ++late) {
    EMU_LATE = late;
    for (int rows : {5, 37}) {
      for (int T : {60, 1000}) {
        std::mt19937 gen(rows * 7919 + T);  // the same rows whichever way copies land
        std::vector<float> x((size_t)rows * T), a(T), y(x.size()), ref(x.size());
        for (auto& v : x) v = 4.f * nd(gen);
        for (auto& v : a) v = 0.9f * std::tanh(nd(gen));
        x[(size_t)2 * T + 5] = NAN;
        x[(size_t)3 * T] = 0.f;
        x[(size_t)3 * T + 1] = -0.f;
        int e1 = effects_ladder(x.data(), y.data(), rows, T, 0.17f, 1.3f, ladder_slots().shared_bytes(), nullptr);
        int e2 = effects_ladder_resonant(x.data(), ref.data(), rows, T, 0.17f, 0.f, 1.3f, nullptr);
        size_t bad = 0;
        for (size_t i = 0; i < x.size(); ++i) bad += !same(y[i], ref[i]);
        if (e1 || e2 || bad) { printf("FAIL ladder late %d rows %d T %d: %d %d, %zu differ\n", late, rows, T, e1, e2, bad); ++fails; }
        for (int st : {1, 4, 6, 8}) {
          std::fill(y.begin(), y.end(), -7.f);
          int e = effects_phaser(x.data(), a.data(), y.data(), rows, T, st, 0.5f, 0.5f, phaser_slots(st).shared_bytes(), nullptr);
          if (e) { printf("FAIL phaser launch refused: late %d stages %d\n", late, st); ++fails; }
          char name[512];
          snprintf(name, sizeof name, "%s/phaser_%d_%d_%d_%d.f32", out, late, rows, T, st);
          FILE* f = fopen(name, "wb");
          fwrite(y.data(), 4, y.size(), f);
          fclose(f);
          if (late == 0 && st == 1) {
            snprintf(name, sizeof name, "%s/x_%d_%d.f32", out, rows, T);
            f = fopen(name, "wb"); fwrite(x.data(), 4, x.size(), f); fclose(f);
            snprintf(name, sizeof name, "%s/a_%d_%d.f32", out, rows, T);
            f = fopen(name, "wb"); fwrite(a.data(), 4, a.size(), f); fclose(f);
          }
        }
      }
    }
  }
  std::vector<float> x(64, 0.f), y(64);
  if (effects_ladder(x.data(), y.data(), 1, 64, 0.1f, 1.f, ladder_slots().shared_bytes() + 16, nullptr) == 0) { puts("FAIL a wrong shared count ran"); ++fails; }
  if (effects_phaser(x.data(), x.data(), y.data(), 1, 62, 6, 0.5f, 0.5f, phaser_slots(6).shared_bytes(), nullptr) == 0) { puts("FAIL T = 62 ran"); ++fails; }
  printf("%d failures\n", fails);
  return fails != 0;
}
"""


def _host_source(cu: str) -> str:
    """effects.cu with the CUDA features it uses swapped for the emulation's."""
    src = cu.replace("#include <cuda_runtime.h>", '#include "mock_cuda.h"')
    src = src.replace("extern __shared__ float4 shared[];", "float4* shared = g_shared;")
    helpers = [
        (r"__device__ __forceinline__ void cp_async16\(.*?\n}\n",
         "inline void cp_async16(float* dst, const float* src, bool valid) { emu_copy(dst, src, valid); }\n"),
        (r"__device__ __forceinline__ void cp_async_commit\(\) \{.*?\}\n", "inline void cp_async_commit() { emu_commit(); }\n"),
        (r"__device__ __forceinline__ void cp_async_wait_lookahead\(\) \{.*?\n\}\n",
         "inline void cp_async_wait_lookahead() { emu_wait(LOOKAHEAD); }\n"),
    ]
    for pattern, repl in helpers:
        src, n = re.subn(pattern, repl, src, flags=re.S)
        assert n == 1, pattern
    src = re.sub(r"(\w+(?:<\w+>)?)<<<(.*?)>>>\((.*?)\);",
                 lambda m: f"emulate_launch({m.group(1)}, {m.group(2)}, {m.group(3)});", src, flags=re.S)
    assert "asm" not in src and "<<<" not in src
    return src


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """Build and run the harness once: its printed lines and its output dir."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulation")
    d = tmp_path_factory.mktemp("effects_emulation")
    (d / "mock_cuda.h").write_text(MOCK)
    (d / "effects_host.cpp").write_text(_host_source((CSRC_DIR / "effects.cu").read_text()))
    (d / "harness.cpp").write_text('#include "effects_host.cpp"\n' + HARNESS)
    build = subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-o", str(d / "harness"),
                            str(d / "harness.cpp")], capture_output=True, text=True)
    assert build.returncode == 0, build.stderr[-3000:]
    run = subprocess.run([str(d / "harness"), str(d)], capture_output=True, text=True, timeout=600)
    return run, d


def test_pipelines_equal_the_one_thread_kernels_and_refuse_bad_launches(emulated):
    """The k = 0 ladder pipeline against the one-thread kernel at k = 0 (as
    values) at 5 and 37 rows (one block, and five with the last of 5 rows),
    T = 60 (one ragged tile) and 1000, with a NaN and signed zeros; cp.async
    landing at once and as late as allowed. A launch with a wrong
    shared-memory count or T not a multiple of 4 is refused."""
    run, _ = emulated
    assert run.returncode == 0 and "0 failures" in run.stdout, run.stdout[-3000:] + run.stderr[-2000:]


def test_shared_memory_matches_the_wrappers_count(emulated):
    """The C side's ring of slots in bytes, as the kernel lays it out, is the
    count ops/effects.py hands every launch, and fits the card's 227 KB."""
    run, _ = emulated
    lines = [line.split() for line in run.stdout.splitlines() if line.startswith("shared")]
    assert len(lines) == 1
    _, _, ladder, *phaser = lines[0]
    assert int(ladder) == op.ladder_shared_bytes()
    assert [int(v) for v in phaser] == [op.phaser_shared_bytes(st) for st in range(1, 9)]
    assert max(int(ladder), *map(int, phaser)) <= MAX_SHARED_BYTES


@pytest.mark.parametrize("late", [0, 1], ids=["copies at once", "copies late"])
@pytest.mark.parametrize("stages", [1, 4, 6, 8])
def test_phaser_pipeline_equals_the_plain_loop(emulated, stages, late):
    """The phaser pipeline's output at every row count and T of the harness,
    bit for bit against ops/effects.py::phaser_plain (mix 0.5)."""
    _, d = emulated
    for rows in (5, 37):
        for t in (60, 1000):
            x = torch.from_numpy(np.fromfile(d / f"x_{rows}_{t}.f32", np.float32).reshape(rows, t))
            a = torch.from_numpy(np.fromfile(d / f"a_{rows}_{t}.f32", np.float32))
            ref = op.phaser_plain(x, a, stages, 0.5).numpy()
            got = np.fromfile(d / f"phaser_{late}_{rows}_{t}_{stages}.f32", np.float32).reshape(rows, t)
            np.testing.assert_array_equal(got, ref, err_msg=f"({rows}, {t})")
