// Kernel F: the per-sample recursions of JingleBack's effect chains.
//
// Replaces: audiobd_tpu/poison/effects.py, the two filters that the JAX
// package runs as a `jax.lax.scan` over every sample, vmapped over rows (no
// Pallas kernel: XLA compiles each scan into one device loop):
//   * ladder_hpf12 (line 261): a Moog-style 4-stage ladder of TPT one-poles,
//     HPF12 tap -> effects_ladder below;
//   * phaser (line 300): `stages` cascaded first-order all-passes with a
//     time-varying coefficient a_t, then a wet/dry mix -> effects_phaser.
//
// Layout: x, y (rows, T) f32 row-major; the phaser's a_t (T,) f32.
//
// Math, per row, from zero state (the scan's step, op for op):
//   ladder:  u = tanh(x*drive - k*s4);
//            one_pole(sig, s): v = (sig - s)*G; lp = v + s; s' = lp + v;
//            lp1 = one_pole(u, s1); hp1 = u - lp1; lp2 = one_pole(hp1, s2);
//            y = hp2 = hp1 - lp2; lp3 = one_pole(lp2, s3); one_pole(lp3, s4).
//   phaser:  sig = x; for each stage i: y_i = a_t*sig + xs_i - a_t*ys_i,
//            xs_i' = sig, ys_i' = y_i, sig = y_i; y = dry*x + mix*sig.
// G, k, drive, mix and dry are the host's float64 values rounded to f32, and
// a_t is the host's float64 table rounded to f32, as the JAX package forms
// them. Every multiply and add is __fmul_rn/__fadd_rn/__fsub_rn in the JAX
// step's order, so no FMA contraction separates the kernel from the plain
// version (ops/effects.py); tanhf is the CUDA math library's, as torch.tanh's.
//
// What bounds it on the H100: neither bytes (x read once, y written once:
// 32.8 MB at (256, 16000), 0.0098 ms at 3.35 TB/s) nor f32 operations, but
// the chain of dependent operations through the recursion: a sample's state
// needs the previous sample's. The ladder's loop-carried path from s4 to the
// next s4 is k*s4, the subtraction, tanhf and the four stages in series
// (about 20 dependent operations); the phaser's is a_t*ys_i and the
// subtraction of each stage (2), the stages pipelining across samples. At
// ~4 cycles an operation a call takes T x chain x 4 cycles at least, however
// many rows: ~0.6 ms for the ladder at T = 16000.
//
// Design: one thread per row, its state in registers, a loop over t. Rows
// are independent, so a batch of up to ~100k rows runs in the time of one
// row's chain. A thread reads and writes its row as float4, the next float4
// loaded before the current four samples are computed, so the loads'
// latency hides behind the chain; neighbouring threads read rows T apart,
// and the L1 cache keeps a row's 128-byte line for the next seven loads.
// (A loop that reads one float a sample took 1.6x (ladder) and 2.1x
// (phaser) as long at (256, 16000) on an H100 80GB HBM3 at 700 W; PERF.md
// §6.) So T is a multiple of 4 and every pointer 16-byte aligned:
// ops/effects.py pads a row with zeros to that, which the causal
// recursions leave unseen. The phaser's a_t is read the same way; every
// thread of a warp reads the same address, a broadcast. Its stage count is
// a template parameter (1-8), its state unrolled into registers.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;

struct Ladder {
  float G, k, drive;
  float s1 = 0.f, s2 = 0.f, s3 = 0.f, s4 = 0.f;

  __device__ __forceinline__ float one_pole(float sig, float& s) const {
    const float v = __fmul_rn(__fsub_rn(sig, s), G);
    const float lp = __fadd_rn(v, s);
    s = __fadd_rn(lp, v);
    return lp;
  }

  __device__ __forceinline__ float step(float x) {
    const float u = tanhf(__fsub_rn(__fmul_rn(x, drive), __fmul_rn(k, s4)));
    const float lp1 = one_pole(u, s1);
    const float hp1 = __fsub_rn(u, lp1);
    const float lp2 = one_pole(hp1, s2);
    const float hp2 = __fsub_rn(hp1, lp2);
    const float lp3 = one_pole(lp2, s3);
    one_pole(lp3, s4);
    return hp2;
  }
};

template <int STAGES>
struct Phaser {
  float mix, dry;
  float xs[STAGES], ys[STAGES];

  __device__ __forceinline__ float step(float x, float a) {
    float sig = x;
#pragma unroll
    for (int i = 0; i < STAGES; ++i) {
      const float y = __fsub_rn(__fadd_rn(__fmul_rn(a, sig), xs[i]), __fmul_rn(a, ys[i]));
      xs[i] = sig;
      ys[i] = y;
      sig = y;
    }
    return __fadd_rn(__fmul_rn(dry, x), __fmul_rn(mix, sig));
  }
};

__global__ void __launch_bounds__(THREADS) ladder_kernel(const float4* __restrict__ x, float4* __restrict__ y,
                                                         int rows, int n4, float G, float k, float drive) {
  const int row = blockIdx.x * THREADS + threadIdx.x;
  if (row >= rows) return;
  const float4* xr = x + static_cast<size_t>(row) * n4;
  float4* yr = y + static_cast<size_t>(row) * n4;
  Ladder f{G, k, drive};
  float4 next = xr[0];
  for (int i = 0; i < n4; ++i) {
    const float4 cur = next;
    if (i + 1 < n4) next = xr[i + 1];
    float4 out;
    out.x = f.step(cur.x);
    out.y = f.step(cur.y);
    out.z = f.step(cur.z);
    out.w = f.step(cur.w);
    yr[i] = out;
  }
}

template <int STAGES>
__global__ void __launch_bounds__(THREADS) phaser_kernel(const float4* __restrict__ x, const float4* __restrict__ a,
                                                         float4* __restrict__ y, int rows, int n4, float mix,
                                                         float dry) {
  const int row = blockIdx.x * THREADS + threadIdx.x;
  if (row >= rows) return;
  const float4* xr = x + static_cast<size_t>(row) * n4;
  float4* yr = y + static_cast<size_t>(row) * n4;
  Phaser<STAGES> f;
  f.mix = mix;
  f.dry = dry;
#pragma unroll
  for (int i = 0; i < STAGES; ++i) f.xs[i] = f.ys[i] = 0.f;
  float4 next = xr[0], next_a = a[0];
  for (int i = 0; i < n4; ++i) {
    const float4 cur = next, ca = next_a;
    if (i + 1 < n4) {
      next = xr[i + 1];
      next_a = a[i + 1];
    }
    float4 out;
    out.x = f.step(cur.x, ca.x);
    out.y = f.step(cur.y, ca.y);
    out.z = f.step(cur.z, ca.z);
    out.w = f.step(cur.w, ca.w);
    yr[i] = out;
  }
}

bool float4_rows(int T, const void* x, const void* y, const void* a = nullptr) {
  auto aligned = [](const void* p) { return p == nullptr || reinterpret_cast<size_t>(p) % 16 == 0; };
  return T > 0 && T % 4 == 0 && aligned(x) && aligned(y) && aligned(a);
}

}  // namespace

extern "C" {

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

int use_device(int device) { return static_cast<int>(cudaSetDevice(device)); }

// The ladder's HPF12 tap of every row of x (rows, T) into y; rows >= 1, T a
// positive multiple of 4, x and y 16-byte aligned.
int effects_ladder(const float* x, float* y, int rows, int T, float G, float k, float drive, void* stream) {
  if (!float4_rows(T, x, y)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((rows + THREADS - 1) / THREADS);
  ladder_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y), rows, T / 4, G, k, drive);
  return static_cast<int>(cudaGetLastError());
}

// The phaser of every row of x (rows, T) into y, with a_t (T,) and 1-8
// stages; rows >= 1, T a positive multiple of 4, x, a and y 16-byte aligned.
int effects_phaser(const float* x, const float* a, float* y, int rows, int T, int stages, float mix, float dry,
                   void* stream) {
  if (!float4_rows(T, x, y, a)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((rows + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* a4 = reinterpret_cast<const float4*>(a);
  float4* y4 = reinterpret_cast<float4*>(y);
  const int n4 = T / 4;
  switch (stages) {
    case 1: phaser_kernel<1><<<grid, THREADS, 0, s>>>(x4, a4, y4, rows, n4, mix, dry); break;
    case 2: phaser_kernel<2><<<grid, THREADS, 0, s>>>(x4, a4, y4, rows, n4, mix, dry); break;
    case 3: phaser_kernel<3><<<grid, THREADS, 0, s>>>(x4, a4, y4, rows, n4, mix, dry); break;
    case 4: phaser_kernel<4><<<grid, THREADS, 0, s>>>(x4, a4, y4, rows, n4, mix, dry); break;
    case 5: phaser_kernel<5><<<grid, THREADS, 0, s>>>(x4, a4, y4, rows, n4, mix, dry); break;
    case 6: phaser_kernel<6><<<grid, THREADS, 0, s>>>(x4, a4, y4, rows, n4, mix, dry); break;
    case 7: phaser_kernel<7><<<grid, THREADS, 0, s>>>(x4, a4, y4, rows, n4, mix, dry); break;
    case 8: phaser_kernel<8><<<grid, THREADS, 0, s>>>(x4, a4, y4, rows, n4, mix, dry); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
