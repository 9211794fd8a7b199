// Kernel F: the per-sample recursions of JingleBack's effect chains.
//
// Replaces: audiobd_tpu/poison/effects.py, the two filters that the JAX
// package runs as a `jax.lax.scan` over every sample, vmapped over rows (no
// Pallas kernel: XLA compiles each scan into one device loop):
//   * ladder_hpf12 (line 261): a Moog-style 4-stage ladder of TPT one-poles,
//     HPF12 tap -> effects_ladder (k = 0) and effects_ladder_resonant below;
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
// needs the previous sample's. At ~4 cycles an operation a call takes at
// least T x (the longest loop-carried chain) x 4 cycles, however many rows:
//   * ladder at k = 0 (style 5's route): stages 3-4 feed only k*s4, so
//     neither they nor tanhf lie on a loop-carried chain; the longest is a
//     one-pole's s -> s' (sub, mul, add, add: 4), stage 2's running behind
//     stage 1's: 0.129 ms at T = 16000 and 1.98 GHz;
//   * resonant ladder: s4 -> s4 through k*s4, the subtraction, tanhf and the
//     four one-poles (17, tanhf as one);
//   * phaser: a_t*ys_i and the subtraction of each stage (2), the stages
//     running as a pipeline across samples.
// Measured, a dependent f32 operation costs 5-6 cycles here, and an all-pass
// stage ~13 cycles a sample alone on its scheduler (PERF.md §6).
//
// Design (k = 0 ladder and phaser): a warp-specialized stage pipeline through
// shared memory. A block takes 8 rows. Warp 0 (the loader) copies tiles of
// [8 rows x TILE samples] of x, and the phaser's TILE values of a_t, by
// cp.async into a ring of slots in shared memory, LOOKAHEAD tiles ahead;
// warp 1 (the storer) writes finished tiles back as whole row segments of
// float4, coalesced (the phaser's wet/dry mix there). The other warps run
// the recursion's stages over a tile, one lane a (stage, row), the state in
// registers, in place in the tile's slot: stage i works on tile j while
// stage i-1 works on tile j+1. A stage warp packs 4 stages into its lanes,
// so a warp instruction carries as many rows and stages as it has lanes and
// the phaser's block has at most four warps, one a scheduler (warp % 4);
// the ladder's has four. (One warp a stage, 32 rows a block, put two stage
// warps on a scheduler at ~23 cycles a sample each; 16 and 32 rows a block
// ran slower than 8 at 256 rows, PERF.md §6.) A stage reads its row's tile
// into registers before its chain starts, then writes it back. The handoff
// is one block barrier a step (bar.sync 0): in step s the stage d steps down
// the pipeline computes tile s - d, so the ring holds depth + LOOKAHEAD + 2
// tiles (one being stored while the loader refills another). A row's tile
// lies at a pitch of TILE + 4 floats, so the 8 lanes of a quarter warp
// reading the same float4 of their 8 rows are free of bank conflicts.
//   * ladder, k = 0: warp 2 forms u = tanhf(x*drive) (off the chain, apart so
//     that tanhf's instructions do not set the pace); warp 3's lanes run
//     hp1 = u - one_pole(u, s1), then y = hp1 - one_pole(hp1, s2), a step
//     behind. Stages 3-4 are not computed: y equals the full loop's as
//     values, for every input (the one difference is the sign of a zero: the
//     full loop's x*drive - 0*s4 turns -0 into +0 when s4 < 0; NaN
//     propagates the same way, since s4 stays finite while u is bounded by
//     tanh).
//   * phaser: the stage lanes run all-pass stage i, and the storer forms
//     dry*x + mix*sig from the slot's copy of x. STAGES is a template
//     parameter (1-8).
// The resonant ladder (k != 0, no caller in either package) keeps the
// one-thread-a-row kernel: its state in registers, a loop over t, float4
// loads one ahead of the chain.
// Every route reads x and writes y as float4: T is a multiple of 4 and every
// pointer 16-byte aligned (ops/effects.py pads a row with zeros to that,
// which the causal recursions leave unseen). A ragged last tile is loaded
// zero-filled past T and stored only up to T; rows past the last are zero
// and not stored, and lanes past the last stage write nothing.

#include <cuda_runtime.h>

namespace {

// ---- the one-thread-a-row resonant ladder -------------------------------------------------------------------

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

// ---- the stage pipelines ----------------------------------------------------------------------------------------

constexpr int ROWS = 8;          // rows a block: 32 / ROWS stages share a stage warp's lanes
constexpr int TILE = 64;         // samples of a row in a tile
constexpr int C4 = TILE / 4;     // float4 chunks of a row's tile
constexpr int PITCH = TILE + 4;  // floats between two rows' tiles in shared memory (16 B aligned, 4 mod 32)
constexpr int LOOKAHEAD = 3;     // tiles loading behind the one the loader waits for

// A pipeline of `depth` compute steps: tile j is loaded by the end of step j,
// computed in steps j + 1 .. j + depth and stored in step j + depth + 1; the
// loader starts tile j + depth + 2 + LOOKAHEAD in the step after, into the
// same slot, so the ring holds depth + LOOKAHEAD + 2 slots. A slot holds x's
// tile at `x`, the output's at `out` and a_t's at `coeffs` (< 0: none);
// floats.
struct Slots {
  int ring, floats, x, out, coeffs;
  __host__ __device__ int shared_bytes() const { return ring * floats * 4; }
};

__host__ __device__ inline Slots ladder_slots() {
  return {3 + LOOKAHEAD + 2, ROWS * PITCH, 0, 0, -1};  // tanh, two one-poles; in place
}

__host__ __device__ inline Slots phaser_slots(int stages) {
  return {stages + LOOKAHEAD + 2, 2 * ROWS * PITCH + TILE, 0, ROWS * PITCH, 2 * ROWS * PITCH};
}

// The warps of a pipeline block: 0 the loader, 1 the storer, then the
// compute warps. A stage warp packs 32 / ROWS stages into its lanes: lane l
// of stage warp w runs stage w * 32 / ROWS + l / ROWS on row l % ROWS, so a
// warp instruction carries as many rows and stages as it has lanes.
__host__ __device__ constexpr int stage_warps(int stages) { return (stages * ROWS + 31) / 32; }
constexpr int LADDER_WARPS = 3 + stage_warps(2);  // loader, storer, tanh, the two one-pole stages
__host__ __device__ constexpr int phaser_warps(int stages) { return 2 + stage_warps(stages); }

__device__ __forceinline__ int lane_stage(int stage_warp, int lane) { return stage_warp * (32 / ROWS) + lane / ROWS; }

__device__ __forceinline__ float* slot(float* ring, const Slots& s, int j) { return ring + (j % s.ring) * s.floats; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_lookahead() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(LOOKAHEAD) : "memory");
}

// Tile j of the block's rows of x (`rows` of them, a row T long, x at the
// block's first row), and of a_t where the slot has coefficients, into its
// slot: zero past the last row and past T; by the loader warp's lanes. The
// IO loops stay rolled (4 float4 an iteration): unrolled whole, the storer
// took 2.2x as long a step (PERF.md §6).
__device__ __forceinline__ void load_tile(float* ring, const Slots& s, int j, const float* x, const float* a,
                                          int rows, int T, int lane) {
  float* dst = slot(ring, s, j) + s.x;
  const int t0 = j * TILE;
#pragma unroll 4
  for (int q = lane; q < ROWS * C4; q += 32) {
    const int r = q / C4, c = q % C4, t = t0 + 4 * c;
    const bool ok = r < rows && t < T;
    cp_async16(dst + r * PITCH + 4 * c, ok ? x + static_cast<size_t>(r) * T + t : x, ok);
  }
  if (s.coeffs >= 0 && lane < C4) {
    const int t = t0 + 4 * lane;
    cp_async16(slot(ring, s, j) + s.coeffs + 4 * lane, t < T ? a + t : a, t < T);
  }
}

// The loader's share of step `step`: start loading tile step + LOOKAHEAD, into
// the slot whose tile the storer finished in the step before, and wait until
// tile `step` has landed (the block barrier that ends the step publishes it).
__device__ __forceinline__ void load_step(float* ring, const Slots& s, int step, int tiles, const float* x,
                                          const float* a, int rows, int T, int lane) {
  if (step + LOOKAHEAD < tiles) load_tile(ring, s, step + LOOKAHEAD, x, a, rows, T, lane);
  cp_async_commit();
  cp_async_wait_lookahead();
}

__device__ __forceinline__ void load_prologue(float* ring, const Slots& s, int tiles, const float* x, const float* a,
                                              int rows, int T, int lane) {
  for (int j = 0; j < LOOKAHEAD; ++j) {
    if (j < tiles) load_tile(ring, s, j, x, a, rows, T, lane);
    cp_async_commit();
  }
}

__device__ __forceinline__ float wet_dry(float x, float sig, float mix, float dry) {
  return __fadd_rn(__fmul_rn(dry, x), __fmul_rn(mix, sig));
}

// The storer's share of step `step`: tile step - depth - 1 back to the block's
// rows of y, up to the last row and T, as whole row segments of float4; with
// MIX, dry*x + mix*out (the phaser's wet/dry mix).
template <bool MIX>
__device__ __forceinline__ void store_step(float* ring, const Slots& s, int step, int depth, float* y, int rows,
                                           int T, int lane, float mix, float dry) {
  const int j = step - depth - 1;
  if (j < 0) return;
  const float* src = slot(ring, s, j);
#pragma unroll 4
  for (int q = lane; q < ROWS * C4; q += 32) {
    const int r = q / C4, c = q % C4, t = j * TILE + 4 * c;
    float4 v = *reinterpret_cast<const float4*>(src + s.out + r * PITCH + 4 * c);
    if (MIX) {
      const float4 xv = *reinterpret_cast<const float4*>(src + s.x + r * PITCH + 4 * c);
      v.x = wet_dry(xv.x, v.x, mix, dry);
      v.y = wet_dry(xv.y, v.y, mix, dry);
      v.z = wet_dry(xv.z, v.z, mix, dry);
      v.w = wet_dry(xv.w, v.w, mix, dry);
    }
    if (r < rows && t < T) *reinterpret_cast<float4*>(y + static_cast<size_t>(r) * T + t) = v;
  }
}

// u = tanh(x*drive) over a tile in place, by the tanh warp's lanes.
__device__ __forceinline__ void drive_tile(float* tile, int lane, float drive) {
#pragma unroll 2
  for (int q = lane; q < ROWS * C4; q += 32) {
    float4* p = reinterpret_cast<float4*>(tile + (q / C4) * PITCH + 4 * (q % C4));
    float4 v = *p;
    v.x = tanhf(__fmul_rn(v.x, drive));
    v.y = tanhf(__fmul_rn(v.y, drive));
    v.z = tanhf(__fmul_rn(v.z, drive));
    v.w = tanhf(__fmul_rn(v.w, drive));
    *p = v;
  }
}

// sig - one_pole(sig, s): the ladder's HP tap of one stage (hp1 from u, hp2 from hp1).
__device__ __forceinline__ float highpass(float sig, float& s, float G) {
  const float v = __fmul_rn(__fsub_rn(sig, s), G);
  const float lp = __fadd_rn(v, s);
  s = __fadd_rn(lp, v);
  return __fsub_rn(sig, lp);
}

// One lane's row of a tile through a one-pole HP stage, in place: the whole
// row read into registers first, so no read waits on the chain; a lane with
// nothing to compute this step (`active` false) writes nothing.
__device__ __forceinline__ void highpass_row(float* row, bool active, float& s, float G) {
  float4* p = reinterpret_cast<float4*>(row);
  float4 v[C4];
#pragma unroll
  for (int c = 0; c < C4; ++c) v[c] = p[c];
#pragma unroll
  for (int c = 0; c < C4; ++c) {
    v[c].x = highpass(v[c].x, s, G);
    v[c].y = highpass(v[c].y, s, G);
    v[c].z = highpass(v[c].z, s, G);
    v[c].w = highpass(v[c].w, s, G);
    if (active) p[c] = v[c];
  }
}

__global__ void __launch_bounds__(32 * LADDER_WARPS) ladder_pipeline_kernel(const float* __restrict__ x,
                                                                            float* __restrict__ y, int rows, int T,
                                                                            float G, float drive) {
  extern __shared__ float4 shared[];
  float* ring = reinterpret_cast<float*>(shared);
  const Slots s = ladder_slots();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * ROWS;
  x += row0 * T;
  y += row0 * T;
  rows = min(rows - static_cast<int>(row0), ROWS);
  const int tiles = (T + TILE - 1) / TILE, depth = 3;
  // Warp 2 forms u = tanh(x*drive) (step offset 1); the stage lanes of the
  // warps after it run the one-pole stages 0 and 1 (offsets 2, 3).
  const int stage = lane_stage(warp - 3, lane), row = lane % ROWS;
  float st = 0.f;  // a one-pole stage's state of this lane's row
  if (warp == 0) load_prologue(ring, s, tiles, x, nullptr, rows, T, lane);
  for (int step = 0; step <= tiles + depth; ++step) {
    if (warp == 0) {
      load_step(ring, s, step, tiles, x, nullptr, rows, T, lane);
    } else if (warp == 1) {
      store_step<false>(ring, s, step, depth, y, rows, T, lane, 0.f, 0.f);
    } else if (warp == 2) {
      const int j = step - 1;
      if (j >= 0 && j < tiles) drive_tile(slot(ring, s, j), lane, drive);
    } else {
      const int j = step - 2 - stage;
      const bool valid = stage < 2 && j >= 0 && j < tiles;
      if (__any_sync(0xffffffffu, valid)) highpass_row(slot(ring, s, valid ? j : 0) + row * PITCH, valid, st, G);
      if (j < 0) st = 0.f;  // the state is zero until the lane's first tile
    }
    __syncthreads();
  }
}

// One lane's row of a tile through an all-pass stage, from `in` to `out` (the
// same row of the slot's output tile; in == out after stage 0), with a_t from
// `a`: the whole row and the tile's a_t read into registers first, then the
// four samples of a float4 at a time, their a*sig + xs first (off the chain
// through ys, so they issue while the chain's multiplies and subtractions
// wait). A lane with nothing to compute this step (`active` false) writes
// nothing.
__device__ __forceinline__ void allpass_row(const float* in, float* out, const float* a, bool active, float& xs,
                                            float& ys) {
  const float4* in4 = reinterpret_cast<const float4*>(in);
  const float4* a4 = reinterpret_cast<const float4*>(a);
  float4* out4 = reinterpret_cast<float4*>(out);
  float4 sig[C4], av[C4];
#pragma unroll
  for (int c = 0; c < C4; ++c) {
    sig[c] = in4[c];
    av[c] = a4[c];
  }
#pragma unroll
  for (int c = 0; c < C4; ++c) {
    const float p0 = __fadd_rn(__fmul_rn(av[c].x, sig[c].x), xs);
    const float p1 = __fadd_rn(__fmul_rn(av[c].y, sig[c].y), sig[c].x);
    const float p2 = __fadd_rn(__fmul_rn(av[c].z, sig[c].z), sig[c].y);
    const float p3 = __fadd_rn(__fmul_rn(av[c].w, sig[c].w), sig[c].z);
    xs = sig[c].w;
    float4 r;
    r.x = ys = __fsub_rn(p0, __fmul_rn(av[c].x, ys));
    r.y = ys = __fsub_rn(p1, __fmul_rn(av[c].y, ys));
    r.z = ys = __fsub_rn(p2, __fmul_rn(av[c].z, ys));
    r.w = ys = __fsub_rn(p3, __fmul_rn(av[c].w, ys));
    if (active) out4[c] = r;
  }
}

template <int STAGES>
__global__ void __launch_bounds__(32 * phaser_warps(STAGES))
    phaser_kernel(const float* __restrict__ x, const float* __restrict__ a, float* __restrict__ y, int rows, int T,
                  float mix, float dry) {
  extern __shared__ float4 shared[];
  float* ring = reinterpret_cast<float*>(shared);
  const Slots s = phaser_slots(STAGES);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * ROWS;
  x += row0 * T;
  y += row0 * T;
  rows = min(rows - static_cast<int>(row0), ROWS);
  const int tiles = (T + TILE - 1) / TILE;
  // Warps: 0 loader, 1 storer (and the mix), 2.. the all-pass stages.
  const int stage = lane_stage(warp - 2, lane), row = lane % ROWS;
  float xs = 0.f, ys = 0.f;  // this lane's row's state of its all-pass stage
  if (warp == 0) load_prologue(ring, s, tiles, x, a, rows, T, lane);
  for (int step = 0; step <= tiles + STAGES; ++step) {
    if (warp == 0) {
      load_step(ring, s, step, tiles, x, a, rows, T, lane);
    } else if (warp == 1) {
      store_step<true>(ring, s, step, STAGES, y, rows, T, lane, mix, dry);
    } else {
      const int j = step - 1 - stage;
      const bool valid = stage < STAGES && j >= 0 && j < tiles;
      if (__any_sync(0xffffffffu, valid)) {
        float* sl = slot(ring, s, valid ? j : 0);
        allpass_row(sl + (stage == 0 ? s.x : s.out) + row * PITCH, sl + s.out + row * PITCH, sl + s.coeffs, valid,
                    xs, ys);
      }
      if (j < 0) xs = ys = 0.f;  // the state is zero until the lane's first tile
    }
    __syncthreads();
  }
}

bool float4_rows(int T, const void* x, const void* y, const void* a = nullptr) {
  auto aligned = [](const void* p) { return p == nullptr || reinterpret_cast<size_t>(p) % 16 == 0; };
  return T > 0 && T % 4 == 0 && aligned(x) && aligned(y) && aligned(a);
}

// Launch a pipeline kernel of `warps` warps, a block for every ROWS rows, on
// its dynamic shared memory: the caller's count, which must be the
// pipeline's.
template <typename Kernel, typename... Args>
int launch_pipeline(Kernel kernel, const Slots& slots, int warps, int rows, int shared_bytes, cudaStream_t stream,
                    Args... args) {
  if (shared_bytes != slots.shared_bytes()) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(rows + ROWS - 1) / ROWS, 32 * warps, shared_bytes, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int STAGES>
int launch_phaser(const float* x, const float* a, float* y, int rows, int T, float mix, float dry, int shared_bytes,
                  cudaStream_t stream) {
  return launch_pipeline(phaser_kernel<STAGES>, phaser_slots(STAGES), phaser_warps(STAGES), rows, shared_bytes,
                         stream, x, a, y, rows, T, mix, dry);
}

}  // namespace

extern "C" {

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

int use_device(int device) { return static_cast<int>(cudaSetDevice(device)); }

// The ladder's HPF12 tap at k = 0 (no resonance) of every row of x (rows, T)
// into y, by the stage pipeline; rows >= 1, T a positive multiple of 4, x and
// y 16-byte aligned, shared_bytes the pipeline's dynamic shared memory.
int effects_ladder(const float* x, float* y, int rows, int T, float G, float drive, int shared_bytes, void* stream) {
  if (!float4_rows(T, x, y)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_pipeline(ladder_pipeline_kernel, ladder_slots(), LADDER_WARPS, rows, shared_bytes,
                         static_cast<cudaStream_t>(stream), x, y, rows, T, G, drive);
}

// The ladder's HPF12 tap at any k, one thread a row; the same layout.
int effects_ladder_resonant(const float* x, float* y, int rows, int T, float G, float k, float drive, void* stream) {
  if (!float4_rows(T, x, y)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((rows + THREADS - 1) / THREADS);
  ladder_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y), rows, T / 4, G, k, drive);
  return static_cast<int>(cudaGetLastError());
}

// The phaser of every row of x (rows, T) into y, with a_t (T,) and 1-8
// stages, by the stage pipeline; rows >= 1, T a positive multiple of 4, x, a
// and y 16-byte aligned, shared_bytes the pipeline's dynamic shared memory.
int effects_phaser(const float* x, const float* a, float* y, int rows, int T, int stages, float mix, float dry,
                   int shared_bytes, void* stream) {
  if (!float4_rows(T, x, y, a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stages) {
    case 1: return launch_phaser<1>(x, a, y, rows, T, mix, dry, shared_bytes, s);
    case 2: return launch_phaser<2>(x, a, y, rows, T, mix, dry, shared_bytes, s);
    case 3: return launch_phaser<3>(x, a, y, rows, T, mix, dry, shared_bytes, s);
    case 4: return launch_phaser<4>(x, a, y, rows, T, mix, dry, shared_bytes, s);
    case 5: return launch_phaser<5>(x, a, y, rows, T, mix, dry, shared_bytes, s);
    case 6: return launch_phaser<6>(x, a, y, rows, T, mix, dry, shared_bytes, s);
    case 7: return launch_phaser<7>(x, a, y, rows, T, mix, dry, shared_bytes, s);
    case 8: return launch_phaser<8>(x, a, y, rows, T, mix, dry, shared_bytes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
