// Waveform -> MFCC in one kernel, one thread block (or one cluster of them)
// per clip, by one of two paths that ops/mfcc.py::mfcc_path picks from n_fft
// alone, each a Stockham FFT; where its buffers live is a choice by size
// (MODE and the cluster route, below).
//
// Replaces: audiobd_tpu/ops/pallas_mfcc.py::fused_mfcc (the Pallas `_kernel`,
// pallas_call at line 129). Same function on every path: centre-padded,
// Hann-windowed power spectrum, mel filterbank, 10*log10 with a per-clip
// top_db floor, orthonormal DCT-II. All float32, no TF32 (the reference runs
// its products at Precision.HIGHEST). Input is int16 PCM (scaled by 2^-15 on
// load, exactly as dequantize_pcm does) or f32; reflect or constant centre
// padding is index arithmetic, with no padded copy in device memory.
// The log-mel mode (AST's input) is every route with a null DCT table: it
// stops at the floored dB values and writes the (frames x mels) tile.
//
// What bounds it on the H100: f32 operations. At the BadNets shape (16 kHz,
// 1 s clips, n_fft 400, hop 160, 101 frames, 201 bins, 128 mels, 40 MFCCs)
// the function needs ~20 kFLOP per frame: the dense 128 x 40 DCT (10,240),
// a real FFT of 400 points (~8,600 at 2.5 n log2 n), the window, the power
// and the mel product over the filterbank's 395 nonzeros. That is ~4.3 GFLOP
// per 2048 clips against 131 MB of PCM read: 0.065 ms at 67 TFLOP/s, a little
// above the 0.04 ms the bytes take.
//
// FFT path (mfcc_fft_kernel<false, MODE>), for n_fft whose prime factors
// are 2, 3, 5 and 7:
//  * A mixed-radix Stockham FFT (radices 8, 4 or 2, then 3s, 5s and 7s:
//    8x2x5x5 at 400, 8x8x8x4 at 2048, 3x3x5x7x7 at 2205). Stockham rather
//    than a two-level n1 x n2 split because one stage loop serves every
//    size: each stage reads its R inputs at stride N/R, so reads are
//    contiguous across a warp, and writes in an order that leaves the
//    result in natural order with no bit-reversal pass. Two buffers
//    ping-pong, one barrier a stage. An odd radix's first-stage stores (stride
//    R float2 across a half-warp) fall in distinct banks; radix 8's land 16 to
//    a bank.
//  * Latency, not arithmetic, is what a frame's work waits on: a few
//    hundred butterflies between barriers, each after a global load or a
//    shared-memory round trip. So the block's threads form independent
//    groups (8 groups of 64 threads at n_fft 400; one group of 512 at 2048,
//    where one pair's buffers take 32 KB), each with its own buffers and a
//    named barrier, and each transforms its own frame pairs from load to dB
//    values. One group's loads and barriers overlap the others' arithmetic;
//    the block meets only once a clip, for the top_db floor.
//  * Two real frames are packed as one complex signal (frame 2q real, 2q + 1
//    imaginary) and separated after: A[k] = (Z[k] + conj Z[N-k]) / 2,
//    B[k] = (Z[k] - conj Z[N-k]) / 2i. Half the transforms of one per frame.
//  * Twiddles exp(-2 pi i k / N) and the Hann window are tables built on the
//    host in float64 and cast to f32; no sincosf per element. The small DFTs
//    use literal constants.
//  * The mel product reads only each band's bin range (first bin, count,
//    offset into packed weights; at most 9 bins at n_fft 400, 48 at 2048).
//  * The clip's (frames x mels) dB tile waits for the top_db floor; the DCT
//    table (n_mels x n_mfcc) then goes into the free FFT buffers and each
//    thread forms 4 frames of one coefficient, reusing every table value
//    four times.
//
// Bluestein path (mfcc_fft_kernel<true, MODE>, the chirp mode), for every
// other n_fft, at a transform size L (a product of 2, 3, 5, 7 of at least
// 2 n_fft - 1, ops/mfcc.py::bluestein_size), such as n_fft 1103 (prime;
// Ultrasonic's 44.1 kHz setting, L = 2240 = 8x8x5x7). With the chirp
// c_n = exp(-i pi n^2 / N) the DFT is X_k = c_k sum_n (x_n c_n) conj(c_{k-n}),
// a circular convolution at L:
//  * the packed frame pair times pre = hann * c (zero from N to L), then the
//    same Stockham stages at L; times the table H = FFT_L(h) / L (h the
//    conjugate chirp wrapped to L); the inverse transform as the forward
//    stages on conjugates; Z_k = c_k conj(y_k) in the power step, then the
//    FFT path's separation, power, mel, dB and DCT unchanged.
//  * pre, post = c and H come from float64 host tables (n^2 reduced mod 2N
//    in integers) and are read through the read-only cache.
//  * It does about 2 L log L / (N log N) ~ 4.5x the FFT work of a power-of-
//    two frame of N points; the bound still counts the function's FFT at N.
//
// Where the buffers live (ops/mfcc.py::mfcc_route, from the sizes): MODE
// 0-2 of mfcc_fft_kernel, one stage loop for all three, then the cluster
// route, a kernel of its own:
//  * 0, shared: twiddles staged in shared memory beside the groups' buffers;
//    the FFT path keeps its window and the clip's dB tile there too, the
//    chirp mode its dB tile in a device-memory scratch (read back, floored,
//    for the DCT), which leaves room for two groups of 256 at L = 2240.
//    Sizes whose layout fits two blocks an SM (113 KB): n_fft 400 (110.8 KB),
//    2048 (83.3 KB), Bluestein L 2240 (95.5 KB).
//  * 1, large: only the buffers, packed mel weights and ranges in shared
//    memory; twiddles and window read through the read-only cache, the dB
//    tile in device memory. Every transform whose layout fits one block's
//    227 KB (at n_fft 2205 two groups, 80 KB, two blocks an SM; n_fft 4097's
//    L = 8232 one group of 512, 149.4 KB; 8192, 165 KB).
//  * cluster (mfcc_cluster_kernel<CHIRP>), past one block: the transform of
//    each frame pair split four-step style, L = l1 x l2, over a thread-block
//    cluster of C CTAs (ops/mfcc.py::cluster_plan: the fewest, 2 to 8, that
//    divide l1 and l2 and whose slices fit; n_fft 16384 as 128 x 128 and
//    Bluestein n_fft 8193 at L 16464 = 98 x 168, both on 2 CTAs). Launched
//    by cudaLaunchKernelEx with a cluster dimension, as many clusters as are
//    resident, each looping over clips. CTA c reads its l2 / C columns
//    straight from the PCM and runs their l1-point transforms (the same
//    Stockham butterflies, interleaved: point p of column e at p * stride +
//    e, an odd stride so a column's float2 fall in distinct bank pairs);
//    after one barrier.cluster it reads its l1 / C rows of every column
//    from the CTA that holds them through distributed shared memory
//    (map_shared_rank), times W_L^{n2 k1}, and runs their l2-point
//    transforms. The other reads across CTAs:
//    - the Bluestein inverse starts from the forward transform's layout:
//      its columns are the forward's rows, so it needs no exchange before
//      its first step, and one, as above, before its second;
//    - the two-frame separation reads Z[k] and Z[N - k] from whichever CTAs
//      hold them (k = a + A b lives on CTA a / (A / C), A = l1, or l2 after
//      the Bluestein inverse);
//    - a CTA forms the power of the bins its mel bands read (ops/mfcc.py::
//      cluster_bands), so a band whose bins straddle two CTAs' shares is
//      formed whole by one, its bins' power formed by both;
//    - the clip's top_db max: each CTA's, then the cluster's from the
//      peers' slots after a barrier.cluster.
//    Twiddles, window, chirp tables, ck, mel weights and the DCT are read
//    through the read-only cache; the dB tile goes to device memory. Each
//    band's sum is a warp's (its bins, hundreds at the top bands, over the
//    lanes). 1024 threads a CTA, one CTA an SM.
//  * 2, device: the buffers too in a device-memory scratch, 2 x nt float2 a
//    block, and the mel weights read through the cache, for a transform no
//    cluster of 8 holds (n_fft 131072); the grid is as many blocks as are
//    resident, each looping over clips, so the scratch stays L2-sized.
//
// Occupancy: mfcc_fft_kernel has 512 threads a block, __launch_bounds__(512,
// 2) holds registers to 64, so two blocks (1,024 threads) sit on an SM where
// shared memory allows.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <math_constants.h>

namespace {

__device__ __forceinline__ float load_sample(const void* wav, int is_int16, long long idx) {
  if (is_int16) {
    return static_cast<float>(static_cast<const int16_t*>(wav)[idx]) * (1.0f / 32768.0f);
  }
  return static_cast<const float*>(wav)[idx];
}

// Sample src of the centre-padded clip that starts at base (src counted
// from the clip's first sample; reflect needs n_samples > n_fft / 2).
__device__ __forceinline__ float padded_sample(const void* wav, int is_int16, long long base, int n_samples,
                                               int src, int reflect) {
  if (reflect) {
    if (src < 0) src = -src;
    if (src >= n_samples) src = 2 * (n_samples - 1) - src;
  } else if (src < 0 || src >= n_samples) {
    return 0.0f;
  }
  return load_sample(wav, is_int16, base + src);
}

// Block-wide max; every thread gets the result.
template <int NT>
__device__ float block_max(float v, float* red_s) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red_s[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red_s[0];
  for (int w = 1; w < NT / 32; ++w) m = fmaxf(m, red_s[w]);
  return m;
}

// ---------------------------------------------------------------------------
// FFT path

constexpr int FFT_THREADS = 512;
constexpr int MAX_STAGES = 8;

struct FftPlan {
  int n_stages;
  int radix[MAX_STAGES];
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cscale(float2 a, float s) { return make_float2(a.x * s, a.y * s); }
__device__ __forceinline__ float2 mul_neg_i(float2 a) { return make_float2(a.y, -a.x); }  // -i * a

// In-place forward DFT of R points: v[s] = sum_r v[r] exp(-2 pi i r s / R).
template <int R>
__device__ __forceinline__ void small_dft(float2* v);

template <>
__device__ __forceinline__ void small_dft<2>(float2* v) {
  const float2 a = cadd(v[0], v[1]);
  v[1] = csub(v[0], v[1]);
  v[0] = a;
}

template <>
__device__ __forceinline__ void small_dft<3>(float2* v) {
  const float2 t = cadd(v[1], v[2]);
  const float2 d = mul_neg_i(cscale(csub(v[1], v[2]), 0.86602540378443865f));  // -i sin(2pi/3) (v1 - v2)
  const float2 b = csub(v[0], cscale(t, 0.5f));
  v[0] = cadd(v[0], t);
  v[1] = cadd(b, d);
  v[2] = csub(b, d);
}

template <>
__device__ __forceinline__ void small_dft<4>(float2* v) {
  const float2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
  const float2 t2 = cadd(v[1], v[3]), t3 = mul_neg_i(csub(v[1], v[3]));
  v[0] = cadd(t0, t2);
  v[2] = csub(t0, t2);
  v[1] = cadd(t1, t3);
  v[3] = csub(t1, t3);
}

template <>
__device__ __forceinline__ void small_dft<5>(float2* v) {
  const float c1 = 0.30901699437494742f, c2 = -0.80901699437494742f;  // cos(2pi/5), cos(4pi/5)
  const float s1 = 0.95105651629515357f, s2 = 0.58778525229247313f;   // sin(2pi/5), sin(4pi/5)
  const float2 a1 = cadd(v[1], v[4]), b1 = csub(v[1], v[4]);
  const float2 a2 = cadd(v[2], v[3]), b2 = csub(v[2], v[3]);
  const float2 p1 = cadd(v[0], cadd(cscale(a1, c1), cscale(a2, c2)));
  const float2 p2 = cadd(v[0], cadd(cscale(a1, c2), cscale(a2, c1)));
  const float2 q1 = mul_neg_i(cadd(cscale(b1, s1), cscale(b2, s2)));
  const float2 q2 = mul_neg_i(csub(cscale(b1, s2), cscale(b2, s1)));
  v[0] = cadd(v[0], cadd(a1, a2));
  v[1] = cadd(p1, q1);
  v[4] = csub(p1, q1);
  v[2] = cadd(p2, q2);
  v[3] = csub(p2, q2);
}

template <>
__device__ __forceinline__ void small_dft<7>(float2* v) {
  const float c1 = 0.62348980185873353f, c2 = -0.22252093395631440f, c3 = -0.90096886790241913f;  // cos(2pi k/7)
  const float s1 = 0.78183148246802981f, s2 = 0.97492791218182361f, s3 = 0.43388373911755812f;   // sin(2pi k/7)
  const float2 a1 = cadd(v[1], v[6]), b1 = csub(v[1], v[6]);
  const float2 a2 = cadd(v[2], v[5]), b2 = csub(v[2], v[5]);
  const float2 a3 = cadd(v[3], v[4]), b3 = csub(v[3], v[4]);
  const float2 p1 = cadd(v[0], cadd(cscale(a1, c1), cadd(cscale(a2, c2), cscale(a3, c3))));
  const float2 p2 = cadd(v[0], cadd(cscale(a1, c2), cadd(cscale(a2, c3), cscale(a3, c1))));
  const float2 p3 = cadd(v[0], cadd(cscale(a1, c3), cadd(cscale(a2, c1), cscale(a3, c2))));
  const float2 q1 = mul_neg_i(cadd(cscale(b1, s1), cadd(cscale(b2, s2), cscale(b3, s3))));
  const float2 q2 = mul_neg_i(csub(cscale(b1, s2), cadd(cscale(b2, s3), cscale(b3, s1))));
  const float2 q3 = mul_neg_i(cadd(csub(cscale(b1, s3), cscale(b2, s1)), cscale(b3, s2)));
  v[0] = cadd(v[0], cadd(a1, cadd(a2, a3)));
  v[1] = cadd(p1, q1);
  v[6] = csub(p1, q1);
  v[2] = cadd(p2, q2);
  v[5] = csub(p2, q2);
  v[3] = cadd(p3, q3);
  v[4] = csub(p3, q3);
}

template <>
__device__ __forceinline__ void small_dft<8>(float2* v) {
  float2 e[4] = {v[0], v[2], v[4], v[6]};
  float2 o[4] = {v[1], v[3], v[5], v[7]};
  small_dft<4>(e);
  small_dft<4>(o);
  const float s = 0.70710678118654752f;
  o[1] = cmul(o[1], make_float2(s, -s));   // exp(-i pi/4)
  o[2] = mul_neg_i(o[2]);                  // exp(-i pi/2)
  o[3] = cmul(o[3], make_float2(-s, -s));  // exp(-3i pi/4)
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = cadd(e[k], o[k]);
    v[k + 4] = csub(e[k], o[k]);
  }
}

// One Stockham stage of one n-point transform by the `size` threads of a
// group, `rank` the thread's place in it (ops/mfcc.py::stockham_fft walks
// the same indices). L = the product of the earlier radices, m = n / R:
// butterfly j reads src[j + r*m], multiplies input r by
// W_n^{(j mod L) r n / (L R)}, and writes output s to (j - j mod L) R + j mod L + s L.
// TW_LDG: the twiddles are read through the read-only cache, not staged.
// Butterfly j of that stage over elements `bs` apart (bs = 1 here; the
// cluster route's interleaved transforms, below, space them a row apart).
template <int R, bool TW_LDG>
__device__ __forceinline__ void stockham_butterfly(const float2* __restrict__ src, float2* __restrict__ dst,
                                                   const float2* __restrict__ tw, int m, int j, int length,
                                                   int tw_step, int bs) {
  const int k = j % length;
  float2 v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = src[(j + r * m) * bs];
  if (length > 1) {
#pragma unroll
    for (int r = 1; r < R; ++r) v[r] = cmul(v[r], TW_LDG ? __ldg(tw + k * r * tw_step) : tw[k * r * tw_step]);
  }
  small_dft<R>(v);
  float2* d = dst + ((j - k) * R + k) * bs;
#pragma unroll
  for (int r = 0; r < R; ++r) d[r * length * bs] = v[r];
}

template <int R, bool TW_LDG>
__device__ void fft_stage(const float2* __restrict__ src, float2* __restrict__ dst,
                          const float2* __restrict__ tw, int n, int length, int rank, int size) {
  const int m = n / R;
  const int tw_step = n / (length * R);
  for (int j = rank; j < m; j += size) stockham_butterfly<R, TW_LDG>(src, dst, tw, m, j, length, tw_step, 1);
}

template <bool TW_LDG>
__device__ void fft_stage_radix(int radix, const float2* src, float2* dst, const float2* tw, int n, int length,
                                int rank, int size) {
  switch (radix) {
    case 2: fft_stage<2, TW_LDG>(src, dst, tw, n, length, rank, size); break;
    case 3: fft_stage<3, TW_LDG>(src, dst, tw, n, length, rank, size); break;
    case 4: fft_stage<4, TW_LDG>(src, dst, tw, n, length, rank, size); break;
    case 5: fft_stage<5, TW_LDG>(src, dst, tw, n, length, rank, size); break;
    case 7: fft_stage<7, TW_LDG>(src, dst, tw, n, length, rank, size); break;
    default: fft_stage<8, TW_LDG>(src, dst, tw, n, length, rank, size); break;
  }
}

// Barrier over one group of `size` threads (a multiple of 32): named barrier
// group + 1, or the whole block when the group is the block.
__device__ __forceinline__ void group_sync(int group, int size) {
  if (size == FFT_THREADS) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(size) : "memory");
  }
}

// The groups' ping-pong buffers, in float2: 2 * groups * nt (nt the
// transform size), or the DCT table's size if that is larger (the table
// reuses them at the end).
__host__ __device__ __forceinline__ int fft_region(int nt, int groups, int n_mels, int n_mfcc) {
  const int buffers = 2 * groups * nt, table = (n_mels * n_mfcc + 1) / 2;
  return buffers > table ? buffers : table;
}

// The plan's stages over one group's buffers, one barrier a stage; returns
// the buffer that holds the result.
template <bool TW_LDG>
__device__ __forceinline__ float2* run_stages(FftPlan plan, float2* src, float2* dst,
                                              const float2* __restrict__ tw, int nt, int rank, int size,
                                              int group) {
  int length = 1;
  for (int s = 0; s < plan.n_stages; ++s) {
    fft_stage_radix<TW_LDG>(plan.radix[s], src, dst, tw, nt, length, rank, size);
    group_sync(group, size);
    length *= plan.radix[s];
    float2* t = src;
    src = dst;
    dst = t;
  }
  return src;
}

constexpr int MODE_SHARED = 0, MODE_LARGE = 1, MODE_DEVICE = 2;  // where the buffers live (header)

// CHIRP = false: the FFT path, transform size nt = n. CHIRP = true: the
// Bluestein path, nt = L >= 2n - 1, with pre = hann * c, post = c and
// ck = FFT_L(h) / L read through the read-only cache (window unused). MODE:
// the header's. db_out (batch, n_frames, n_mels) takes the dB tile unless
// the FFT path keeps it in shared memory (MODE_SHARED); scratch holds the
// buffers in MODE_DEVICE, 2 * groups * nt float2 for each block of the grid.
// A null dct is the log-mel mode (n_mfcc 0): out takes the floored dB tile.
// Block b transforms clips b, b + gridDim.x, ...
template <bool CHIRP, int MODE>
__global__ void __launch_bounds__(FFT_THREADS, 2)
mfcc_fft_kernel(const void* __restrict__ wav, int is_int16, int batch, int n_samples,
                const float2* __restrict__ twiddles,  // (nt,) exp(-2 pi i k / nt)
                const float* __restrict__ window,     // (n,) periodic Hann (FFT path)
                const float2* __restrict__ pre,       // (n,) hann_n c_n (chirp mode)
                const float2* __restrict__ post,      // (n,) c_k (chirp mode)
                const float2* __restrict__ ck,        // (nt,) FFT_L(h) / L (chirp mode)
                const int* __restrict__ mel_ranges,   // (n_mels, 3): first bin, count, offset
                const float* __restrict__ mel_weights, int n_weights,
                const float* __restrict__ dct,        // (n_mels, n_mfcc), or null (log-mel)
                float* __restrict__ db_out,           // (batch, n_frames, n_mels) scratch
                float2* __restrict__ scratch,         // (gridDim.x, 2 * groups * nt) (MODE_DEVICE)
                float* __restrict__ out,              // (batch, n_frames, n_mfcc or n_mels)
                int n, int nt, int hop, int n_mels, int n_mfcc, int n_frames, int groups, FftPlan plan,
                int reflect, float top_db, int use_top_db) {
  constexpr bool TW_LDG = MODE != MODE_SHARED;
  constexpr bool DB_GLOBAL = CHIRP || MODE != MODE_SHARED;  // else the window and the dB tile are staged too
  extern __shared__ __align__(16) float smem[];
  const int n_bins = n / 2 + 1;
  float2* tw_s = reinterpret_cast<float2*>(smem);  // nt (MODE_SHARED)
  float2* bufs;                                    // groups x 2 x nt
  float* tail;                                     // the shared floats after them
  if constexpr (MODE == MODE_DEVICE) {
    bufs = scratch + static_cast<size_t>(blockIdx.x) * 2 * groups * nt;
    tail = smem;
  } else {
    bufs = tw_s + (TW_LDG ? 0 : nt);
    tail = reinterpret_cast<float*>(bufs + fft_region(nt, groups, n_mels, n_mfcc));
  }
  float* win_s = tail;                                                // n (staged window)
  float* db_tile = DB_GLOBAL ? nullptr : win_s + n;                   // n_frames * n_mels (staged tile)
  float* wts_s = DB_GLOBAL ? tail : db_tile + n_frames * n_mels;      // n_weights (not MODE_DEVICE)
  int* rng_s = reinterpret_cast<int*>(wts_s + (MODE == MODE_DEVICE ? 0 : n_weights));  // 3 * n_mels
  const float2* tw = TW_LDG ? twiddles : tw_s;
  __shared__ float red_s[FFT_THREADS / 32];

  const int tid = threadIdx.x;
  if constexpr (!TW_LDG) {
    for (int e = tid; e < nt; e += FFT_THREADS) tw_s[e] = twiddles[e];
  }
  if constexpr (!DB_GLOBAL) {
    for (int e = tid; e < n; e += FFT_THREADS) win_s[e] = window[e];
  }
  if constexpr (MODE != MODE_DEVICE) {
    for (int e = tid; e < n_weights; e += FFT_THREADS) wts_s[e] = mel_weights[e];
  }
  for (int e = tid; e < 3 * n_mels; e += FFT_THREADS) rng_s[e] = mel_ranges[e];
  __syncthreads();

  const int pad = n / 2;
  const int size = FFT_THREADS / groups, group = tid / size, rank = tid - group * size;
  float2* const buf0 = bufs + 2 * group * nt;
  float2* const buf1 = buf0 + nt;

  for (int clip = blockIdx.x; clip < batch; clip += gridDim.x) {
    const long long base = static_cast<long long>(clip) * n_samples;
    float* db_s = DB_GLOBAL ? db_out + static_cast<long long>(clip) * n_frames * n_mels : db_tile;
    float local_max = -CUDART_INF_F;

    // Group g transforms frame pairs g, g + groups, ...: frame 2q windowed in
    // the real part, 2q + 1 in the imaginary. Groups meet only at the end.
    for (int f0 = 2 * group; f0 < n_frames; f0 += 2 * groups) {
      for (int i = rank; i < nt; i += size) {
        float2 u = make_float2(0.0f, 0.0f);
        if (CHIRP ? i < n : true) {
          const int src = f0 * hop + i - pad;
          const float a = padded_sample(wav, is_int16, base, n_samples, src, reflect);
          const float b =
              f0 + 1 < n_frames ? padded_sample(wav, is_int16, base, n_samples, src + hop, reflect) : 0.0f;
          if constexpr (CHIRP) {
            u = cmul(make_float2(a, b), __ldg(pre + i));
          } else {
            const float w = DB_GLOBAL ? __ldg(window + i) : win_s[i];
            u = make_float2(a * w, b * w);
          }
        }
        buf0[i] = u;
      }
      group_sync(group, size);
      float2* spec = run_stages<TW_LDG>(plan, buf0, buf1, tw, nt, rank, size, group);
      if constexpr (CHIRP) {
        // V = U * H; the inverse transform is the forward one on conjugates.
        for (int k = rank; k < nt; k += size) {
          const float2 v = cmul(spec[k], __ldg(ck + k));
          spec[k] = make_float2(v.x, -v.y);
        }
        group_sync(group, size);
        spec = run_stages<TW_LDG>(plan, spec, spec == buf0 ? buf1 : buf0, tw, nt, rank, size, group);
      }
      // spec holds the spectrum (chirp mode: Z_k = c_k conj(spec_k)); the other
      // buffer takes the two frames' power.
      float* pw = reinterpret_cast<float*>(spec == buf0 ? buf1 : buf0);
      for (int k = rank; k < n_bins; k += size) {
        const int kc = k == 0 ? 0 : n - k;
        float2 z = spec[k], zc = spec[kc];
        if constexpr (CHIRP) {
          z = cmul(__ldg(post + k), make_float2(z.x, -z.y));
          zc = cmul(__ldg(post + kc), make_float2(zc.x, -zc.y));
        }
        const float ar = 0.5f * (z.x + zc.x), ai = 0.5f * (z.y - zc.y);
        const float br = 0.5f * (z.y + zc.y), bi = 0.5f * (zc.x - z.x);
        pw[k] = ar * ar + ai * ai;
        pw[n_bins + k] = br * br + bi * bi;
      }
      group_sync(group, size);
      const int nf = min(2, n_frames - f0);
      for (int e = rank; e < nf * n_mels; e += size) {
        const int h = e >= n_mels, mel = e - h * n_mels;
        const int first = rng_s[3 * mel], count = rng_s[3 * mel + 1], off = rng_s[3 * mel + 2];
        const float* row = pw + h * n_bins + first;
        float acc = 0.0f;
        for (int q = 0; q < count; ++q)
          acc = fmaf(row[q], MODE == MODE_DEVICE ? __ldg(mel_weights + off + q) : wts_s[off + q], acc);
        const float db = 10.0f * log10f(fmaxf(acc, 1e-10f));
        db_s[(f0 + h) * n_mels + mel] = db;
        local_max = fmaxf(local_max, db);
      }
      group_sync(group, size);  // the next pair's load rewrites the buffers
    }
    __syncthreads();  // every group is done with the buffers

    const float floor_db = use_top_db ? block_max<FFT_THREADS>(local_max, red_s) - top_db : -CUDART_INF_F;
    if (dct == nullptr) {  // the log-mel mode: the floored dB tile is the output
      float* out_clip = out + static_cast<long long>(clip) * n_frames * n_mels;
      for (int e = tid; e < n_frames * n_mels; e += FFT_THREADS) out_clip[e] = fmaxf(db_s[e], floor_db);
      __syncthreads();  // the next clip rewrites the buffers and the dB tile
      continue;
    }
    const float* dct_t = dct;
    if constexpr (MODE != MODE_DEVICE) {
      float* dct_s = reinterpret_cast<float*>(bufs);
      for (int e = tid; e < n_mels * n_mfcc; e += FFT_THREADS) dct_s[e] = dct[e];
      dct_t = dct_s;
    }
    if constexpr (!DB_GLOBAL) {
      for (int e = tid; e < n_frames * n_mels; e += FFT_THREADS) db_s[e] = fmaxf(db_s[e], floor_db);
    }
    __syncthreads();

    // Thread (frame quad q, coefficient j): frames 4q .. 4q + 3.
    float* out_clip = out + static_cast<long long>(clip) * n_frames * n_mfcc;
    const int quads = (n_frames + 3) / 4;
    for (int e = tid; e < quads * n_mfcc; e += FFT_THREADS) {
      const int q = e / n_mfcc, j = e - q * n_mfcc;
      const float* rows[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) rows[i] = db_s + min(4 * q + i, n_frames - 1) * n_mels;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int mel = 0; mel < n_mels; ++mel) {
        const float d = dct_t[mel * n_mfcc + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[i] = fmaf(DB_GLOBAL ? fmaxf(rows[i][mel], floor_db) : rows[i][mel], d, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * q + i < n_frames) out_clip[(4 * q + i) * n_mfcc + j] = acc[i];
    }
    __syncthreads();  // the next clip rewrites the buffers and the dB tile
  }
}

using MfccKernel = decltype(&mfcc_fft_kernel<false, MODE_SHARED>);

MfccKernel pick_kernel(int chirp, int mode) {
  static const MfccKernel table[2][3] = {
      {mfcc_fft_kernel<false, MODE_SHARED>, mfcc_fft_kernel<false, MODE_LARGE>, mfcc_fft_kernel<false, MODE_DEVICE>},
      {mfcc_fft_kernel<true, MODE_SHARED>, mfcc_fft_kernel<true, MODE_LARGE>, mfcc_fft_kernel<true, MODE_DEVICE>},
  };
  return table[chirp != 0][mode];
}

// Shared memory of one block, in bytes (ops/mfcc.py::smem_bytes mirrors it).
size_t mfcc_smem_bytes(int mode, bool chirp, int n, int nt, int groups, int n_mels, int n_mfcc, int n_frames,
                       int n_weights) {
  size_t bytes = sizeof(int) * 3 * (size_t)n_mels;
  if (mode == MODE_DEVICE) return bytes;
  bytes += sizeof(float) * (size_t)n_weights + sizeof(float2) * (size_t)fft_region(nt, groups, n_mels, n_mfcc);
  if (mode == MODE_LARGE) return bytes;
  bytes += sizeof(float2) * (size_t)nt;
  if (!chirp) bytes += sizeof(float) * ((size_t)n + (size_t)n_frames * n_mels);
  return bytes;
}

// The block's dynamic shared memory; with max_shared, all of the SM's
// unified memory goes to shared memory rather than L1 (else CUDA picks the
// split, which leaves L1 the rest).
template <class Kernel>
int set_smem(Kernel kernel, size_t smem, bool max_shared = true) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess || !max_shared) return static_cast<int>(err);
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           static_cast<int>(cudaSharedmemCarveoutMaxShared)));
}

// The stage plan from the host's radices: their product must be nt (whether
// the buffers fit is the shared-memory attribute's to say).
int make_plan(const int* radices, int n_stages, int nt, int groups, FftPlan* plan) {
  if (n_stages < 1 || n_stages > MAX_STAGES || groups < 1 || groups > 8 || (groups & (groups - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  plan->n_stages = n_stages;
  long long product = 1;
  for (int s = 0; s < n_stages; ++s) {
    const int r = radices[s];
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 7 && r != 8) return static_cast<int>(cudaErrorInvalidValue);
    plan->radix[s] = r;
    product *= r;
  }
  return product == nt ? 0 : static_cast<int>(cudaErrorInvalidValue);
}


// ---------------------------------------------------------------------------
// Cluster route (header): mfcc_cluster_kernel<CHIRP> on clusters of C CTAs.

constexpr int CLUSTER_THREADS = 1024;  // one CTA an SM at 64 registers a thread
constexpr int MAX_CLUSTER = 8;         // the portable cluster size
constexpr int CLUSTER_TAIL = 64;       // floats after the buffers: 32 warps' maxima, then the CTA's clip max

// The cluster's features, one helper each (tests/test_torch_port_mfcc_cluster.py
// swaps them for an emulation to run the kernel on the CPU).
__device__ __forceinline__ int cta_rank() {
  return static_cast<int>(cooperative_groups::this_cluster().block_rank());
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
template <class T>
__device__ __forceinline__ T* peer(T* p, int rank) {  // p's place in CTA rank's shared memory
  return cooperative_groups::this_cluster().map_shared_rank(p, rank);
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// A slice's row stride in float2: odd, so the float2 of one column fall in
// distinct bank pairs.
__host__ __device__ __forceinline__ int row_stride(int width) { return width | 1; }

// One buffer of a CTA, in float2: l1 rows of its l2 / C columns, or l2 rows
// of its l1 / C rows, whichever layout is larger.
__host__ __device__ __forceinline__ int cluster_buffer(int l1, int l2, int ctas) {
  const int a = l1 * row_stride(l2 / ctas), b = l2 * row_stride(l1 / ctas);
  return a > b ? a : b;
}

// One Stockham stage of a CTA's `batch` interleaved n-point transforms:
// point p of transform e at p * bs + e, twiddle W_n^x = tw[x * big / n] from
// the big-point table.
template <int R>
__device__ void cluster_stage(const float2* __restrict__ src, float2* __restrict__ dst,
                              const float2* __restrict__ tw, int n, int big, int length, int batch, int bs) {
  const int m = n / R;
  const int tw_step = big / (length * R);
  for (int t = threadIdx.x; t < m * batch; t += CLUSTER_THREADS) {
    const int j = t / batch, e = t - j * batch;
    stockham_butterfly<R, true>(src + e, dst + e, tw, m, j, length, tw_step, bs);
  }
}

// The plan's stages over a CTA's interleaved transforms, one barrier a
// stage; returns the buffer that holds the result.
__device__ float2* cluster_stages(const FftPlan& plan, float2* src, float2* dst, const float2* __restrict__ tw,
                                  int n, int big, int batch, int bs) {
  int length = 1;
  for (int s = 0; s < plan.n_stages; ++s) {
    switch (plan.radix[s]) {
      case 2: cluster_stage<2>(src, dst, tw, n, big, length, batch, bs); break;
      case 3: cluster_stage<3>(src, dst, tw, n, big, length, batch, bs); break;
      case 4: cluster_stage<4>(src, dst, tw, n, big, length, batch, bs); break;
      case 5: cluster_stage<5>(src, dst, tw, n, big, length, batch, bs); break;
      case 7: cluster_stage<7>(src, dst, tw, n, big, length, batch, bs); break;
      default: cluster_stage<8>(src, dst, tw, n, big, length, batch, bs); break;
    }
    __syncthreads();
    length *= plan.radix[s];
    float2* t = src;
    src = dst;
    dst = t;
  }
  return src;
}

// A transform of size L = s1 * s2 over the cluster, four-step style, with
// q1 = s1 / C rows and q2 = s2 / C columns a CTA. In: x[s2 n1 + n2] for this
// CTA's columns n2 = rank q2 + c, at in[n1 * row_stride(q2) + c]. Returns the
// buffer holding X[k1 + s1 k2] for its rows k1 = rank q1 + r, at
// [k2 * row_stride(q1) + r]; `other` is scratch. Step 1: the columns'
// s1-point transforms; step 2: each CTA reads its rows of every column from
// the CTA that holds it (distributed shared memory), times W_L^{n2 k1};
// step 3: the rows' s2-point transforms.
__device__ float2* four_step(float2* in, float2* other, const float2* __restrict__ tw, int s1, int s2,
                             const FftPlan& f1, const FftPlan& f2, int ctas, int rank) {
  const int big = s1 * s2, q1 = s1 / ctas, q2 = s2 / ctas, bs1 = row_stride(q1), bs2 = row_stride(q2);
  float2* cols = cluster_stages(f1, in, other, tw, s1, big, q2, bs2);
  float2* rows = cols == in ? other : in;
  cluster_sync();  // every CTA's columns are transformed
  for (int t = threadIdx.x; t < q1 * s2; t += CLUSTER_THREADS) {
    const int r = t / s2, n2 = t - r * s2, q = n2 / q2, k1 = rank * q1 + r;
    const float2* src = q == rank ? cols : peer(cols, q);
    rows[n2 * bs1 + r] = cmul(src[k1 * bs2 + n2 - q * q2], __ldg(tw + n2 * k1));
  }
  cluster_sync();  // every CTA holds its rows: `cols` may be overwritten
  return cluster_stages(f2, rows, cols, tw, s2, big, q1, bs1);
}

// Element k = a + A b of the spectrum, from the CTA rank a / qa that holds it
// at [b * row_stride(qa) + a mod qa].
__device__ __forceinline__ float2 spectrum_at(float2* spec, int k, int a_size, int qa, int rank) {
  const int b = k / a_size, a = k - b * a_size, q = a / qa;
  const float2* s = q == rank ? spec : peer(spec, q);
  return s[b * row_stride(qa) + a - q * qa];
}

// CHIRP = false: the FFT path at L = n = l1 * l2; CHIRP = true: the Bluestein
// path at L = l1 * l2 >= 2n - 1 (pre, post, ck as mfcc_fft_kernel's). f1, f2:
// the stages of l1 and l2; ctas: C, dividing both. bands (C, 4): CTA c's mel
// bands [first, end) and the bins [first, end) they read (ops/mfcc.py::
// cluster_bands). Cluster g of the grid transforms clips g, g + clusters, ...
// The dB tile goes to db_out, the MFCCs to out (the floored tile itself
// where dct is null, the log-mel mode).
template <bool CHIRP>
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
mfcc_cluster_kernel(const void* __restrict__ wav, int is_int16, int batch, int n_samples,
                    const float2* __restrict__ twiddles,  // (L,) exp(-2 pi i k / L)
                    const float* __restrict__ window,     // (n,) periodic Hann (FFT path)
                    const float2* __restrict__ pre, const float2* __restrict__ post,
                    const float2* __restrict__ ck,        // (L,) FFT_L(h) / L (chirp mode)
                    const int* __restrict__ mel_ranges,   // (n_mels, 3): first bin, count, offset
                    const float* __restrict__ mel_weights, const int* __restrict__ bands,
                    const float* __restrict__ dct,        // (n_mels, n_mfcc), or null (log-mel)
                    float* __restrict__ db_out,           // (batch, n_frames, n_mels)
                    float* __restrict__ out,              // (batch, n_frames, n_mfcc or n_mels)
                    int n, int hop, int n_mels, int n_mfcc, int n_frames, int l1, int l2, FftPlan f1, FftPlan f2,
                    int ctas, int reflect, float top_db, int use_top_db) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, rank = cta_rank(), clusters = gridDim.x / ctas;
  const int q1 = l1 / ctas, q2 = l2 / ctas, bs1 = row_stride(q1), bs2 = row_stride(q2);
  const int len = cluster_buffer(l1, l2, ctas);
  float2* const buf0 = reinterpret_cast<float2*>(smem);
  float2* const buf1 = buf0 + len;
  float* const red_s = reinterpret_cast<float*>(buf1 + len);
  const int mel0 = __ldg(bands + 4 * rank), n_band = __ldg(bands + 4 * rank + 1) - mel0;
  const int bin0 = __ldg(bands + 4 * rank + 2), nb = __ldg(bands + 4 * rank + 3) - bin0;
  const int a_size = CHIRP ? l2 : l1;  // the spectrum's split: k = a + a_size b, CTA a / (a_size / C)
  const int pad = n / 2;

  for (int clip = blockIdx.x / ctas; clip < batch; clip += clusters) {
    const long long base = static_cast<long long>(clip) * n_samples;
    float* db_clip = db_out + static_cast<long long>(clip) * n_frames * n_mels;
    float local_max = -CUDART_INF_F;
    for (int f0 = 0; f0 < n_frames; f0 += 2) {
      // This CTA's columns n2 = rank q2 + c of the pair u[l2 n1 + n2]: frame
      // f0 windowed in the real part, f0 + 1 in the imaginary, read from the PCM.
      for (int t = tid; t < l1 * q2; t += CLUSTER_THREADS) {
        const int n1 = t / q2, c = t - n1 * q2, i = l2 * n1 + rank * q2 + c;
        float2 u = make_float2(0.0f, 0.0f);
        if (CHIRP ? i < n : true) {
          const int src = f0 * hop + i - pad;
          const float a = padded_sample(wav, is_int16, base, n_samples, src, reflect);
          const float b =
              f0 + 1 < n_frames ? padded_sample(wav, is_int16, base, n_samples, src + hop, reflect) : 0.0f;
          if constexpr (CHIRP) {
            u = cmul(make_float2(a, b), __ldg(pre + i));
          } else {
            const float w = __ldg(window + i);
            u = make_float2(a * w, b * w);
          }
        }
        buf0[n1 * bs2 + c] = u;
      }
      __syncthreads();
      float2* spec = four_step(buf0, buf1, twiddles, l1, l2, f1, f2, ctas, rank);
      if constexpr (CHIRP) {
        // V = conj(U H) on this CTA's rows k1 = rank q1 + r (k = k1 + l1 k2).
        // The inverse is the forward transform of V at l2 x l1: its columns
        // are these rows, so it starts with no exchange.
        for (int t = tid; t < l2 * q1; t += CLUSTER_THREADS) {
          const int k2 = t / q1, r = t - k2 * q1;
          float2* e = spec + k2 * bs1 + r;
          const float2 v = cmul(*e, __ldg(ck + rank * q1 + r + l1 * k2));
          *e = make_float2(v.x, -v.y);
        }
        __syncthreads();
        spec = four_step(spec, spec == buf0 ? buf1 : buf0, twiddles, l2, l1, f2, f1, ctas, rank);
      }
      cluster_sync();  // every CTA's part of the spectrum is final
      // Power of bins bin0 .. bin0 + nb of both frames into the other buffer;
      // Z[k] and Z[n - k] from the CTAs that hold them (chirp mode:
      // Z_k = c_k conj(y_k)).
      float* pw = reinterpret_cast<float*>(spec == buf0 ? buf1 : buf0);
      for (int t = tid; t < nb; t += CLUSTER_THREADS) {
        const int k = bin0 + t, kc = k == 0 ? 0 : n - k;
        float2 z = spectrum_at(spec, k, a_size, a_size / ctas, rank);
        float2 zc = spectrum_at(spec, kc, a_size, a_size / ctas, rank);
        if constexpr (CHIRP) {
          z = cmul(__ldg(post + k), make_float2(z.x, -z.y));
          zc = cmul(__ldg(post + kc), make_float2(zc.x, -zc.y));
        }
        const float ar = 0.5f * (z.x + zc.x), ai = 0.5f * (z.y - zc.y);
        const float br = 0.5f * (z.y + zc.y), bi = 0.5f * (zc.x - z.x);
        pw[t] = ar * ar + ai * ai;
        pw[nb + t] = br * br + bi * bi;
      }
      __syncthreads();
      cluster_arrive();  // done reading the peers' spectra; their next pair waits for it
      // A warp a (frame, band): its lanes over the band's bins (hundreds at
      // the top bands past 8192 points), then a shuffle sum.
      const int nf = min(2, n_frames - f0), lane = tid & 31;
      for (int e = tid >> 5; e < nf * n_band; e += CLUSTER_THREADS / 32) {
        const int h = e >= n_band, mel = mel0 + e - h * n_band;
        const int first = __ldg(mel_ranges + 3 * mel), count = __ldg(mel_ranges + 3 * mel + 1);
        const int off = __ldg(mel_ranges + 3 * mel + 2);
        const float* row = pw + h * nb + first - bin0;
        float acc = 0.0f;
        for (int q = lane; q < count; q += 32) acc = fmaf(row[q], __ldg(mel_weights + off + q), acc);
        for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (lane == 0) {
          const float db = 10.0f * log10f(fmaxf(acc, 1e-10f));
          db_clip[(f0 + h) * n_mels + mel] = db;
          local_max = fmaxf(local_max, db);
        }
      }
      __syncthreads();  // the next pair's load rewrites the buffers
      cluster_wait();
    }

    // top_db over the clip: each CTA's maximum, then the cluster's from the
    // peers' slots (a cluster reduction).
    const float cta_max = block_max<CLUSTER_THREADS>(local_max, red_s);
    if (tid == 0) red_s[CLUSTER_THREADS / 32] = cta_max;
    __threadfence();  // this CTA's dB rows, which the peers' DCT reads
    cluster_sync();
    float clip_max = cta_max;
    for (int q = 0; q < ctas; ++q) clip_max = fmaxf(clip_max, *peer(red_s + CLUSTER_THREADS / 32, q));
    const float floor_db = use_top_db ? clip_max - top_db : -CUDART_INF_F;
    if (dct == nullptr) {  // the log-mel mode: the floored dB tile is the output
      float* out_clip = out + static_cast<long long>(clip) * n_frames * n_mels;
      for (int e = rank * CLUSTER_THREADS + tid; e < n_frames * n_mels; e += ctas * CLUSTER_THREADS)
        out_clip[e] = fmaxf(db_clip[e], floor_db);
      continue;
    }

    // DCT: thread (frame quad q, coefficient j) of the cluster's, frames 4q .. 4q + 3.
    float* out_clip = out + static_cast<long long>(clip) * n_frames * n_mfcc;
    const int quads = (n_frames + 3) / 4;
    for (int e = rank * CLUSTER_THREADS + tid; e < quads * n_mfcc; e += ctas * CLUSTER_THREADS) {
      const int q = e / n_mfcc, j = e - q * n_mfcc;
      const float* rows[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) rows[i] = db_clip + min(4 * q + i, n_frames - 1) * n_mels;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int mel = 0; mel < n_mels; ++mel) {
        const float d = __ldg(dct + mel * n_mfcc + j);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] = fmaf(fmaxf(rows[i][mel], floor_db), d, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * q + i < n_frames) out_clip[(4 * q + i) * n_mfcc + j] = acc[i];
    }
  }
  cluster_sync();  // no CTA leaves while a peer may still read its shared memory
}

// Shared memory of one CTA of the cluster route, in bytes
// (ops/mfcc.py::cluster_smem_bytes mirrors it).
size_t mfcc_cluster_smem_bytes(int l1, int l2, int ctas) {
  return sizeof(float2) * 2 * (size_t)cluster_buffer(l1, l2, ctas) + sizeof(float) * CLUSTER_TAIL;
}

using ClusterKernel = decltype(&mfcc_cluster_kernel<false>);

ClusterKernel cluster_kernel(int chirp) { return chirp ? mfcc_cluster_kernel<true> : mfcc_cluster_kernel<false>; }

// The cluster route's plans and shared memory after checking them: l1, l2
// from the radices, C in 2..MAX_CLUSTER dividing both.
int cluster_setup(const int* radices1, int n_stages1, const int* radices2, int n_stages2, int ctas, int chirp,
                  FftPlan* f1, FftPlan* f2, int* l1, int* l2, size_t* smem) {
  if (ctas < 2 || ctas > MAX_CLUSTER || n_stages1 < 1 || n_stages1 > MAX_STAGES || n_stages2 < 1 ||
      n_stages2 > MAX_STAGES)
    return static_cast<int>(cudaErrorInvalidValue);
  long long p1 = 1, p2 = 1;
  for (int s = 0; s < n_stages1; ++s) p1 *= (radices1[s] >= 2 && radices1[s] <= 8) ? radices1[s] : 0;
  for (int s = 0; s < n_stages2; ++s) p2 *= (radices2[s] >= 2 && radices2[s] <= 8) ? radices2[s] : 0;
  if (p1 == 0 || p2 == 0 || p1 % ctas || p2 % ctas) return static_cast<int>(cudaErrorInvalidValue);
  *l1 = static_cast<int>(p1);
  *l2 = static_cast<int>(p2);
  int err = make_plan(radices1, n_stages1, *l1, 1, f1);
  if (err == 0) err = make_plan(radices2, n_stages2, *l2, 1, f2);
  if (err != 0) return err;
  *smem = mfcc_cluster_smem_bytes(*l1, *l2, ctas);
  // L1 keeps what shared memory leaves: the twiddles, weights and PCM are read through it.
  return set_smem(cluster_kernel(chirp), *smem, false);
}

// A launch configuration of `clusters` clusters of C CTAs (attr: its one attribute).
cudaLaunchConfig_t cluster_config(int clusters, int ctas, size_t smem, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * ctas, 1, 1);
  cfg.blockDim = dim3(CLUSTER_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ctas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

int use_device(int device) { return static_cast<int>(cudaSetDevice(device)); }

// Kernel A on `grid` blocks of 512 threads. FFT path (chirp 0): nt = n_fft,
// window read, pre/post/kernel unused. Bluestein path (chirp 1): nt >= 2
// n_fft - 1, pre, post (n_fft, 2) and kernel (nt, 2) from
// ops/mfcc.py::bluestein_plan, window unused. radices: host array of
// n_stages radices in {2, 3, 4, 5, 7, 8} whose product is nt; groups: thread
// groups per block (1, 2, 4 or 8: named barriers 1-8); mode: where the
// buffers live (MODE_*). db (batch, n_frames, n_mels) unless mode 0 on the
// FFT path; scratch (grid, 2 * groups * nt, 2) in mode 2. A null dct with
// n_mfcc 0 is the log-mel mode: out (batch, n_frames, n_mels).
int mfcc_forward(const void* wav, int is_int16, int batch, int n_samples, const float* twiddles, const float* window,
                 const float* pre, const float* post, const float* kernel, const int* mel_ranges,
                 const float* mel_weights, int n_weights, const float* dct, float* db, float* scratch, float* out,
                 int n_fft, int nt, int hop, int n_mels, int n_mfcc, int n_frames, int groups, int grid,
                 const int* radices, int n_stages, int chirp, int mode, int reflect, float top_db, int use_top_db,
                 void* stream) {
  if (chirp ? nt < 2 * n_fft - 1 : nt != n_fft) return static_cast<int>(cudaErrorInvalidValue);
  if (grid < 1 || (mode != MODE_DEVICE && grid != batch)) return static_cast<int>(cudaErrorInvalidValue);
  if (mode < MODE_SHARED || mode > MODE_DEVICE || (db == nullptr && (chirp || mode != MODE_SHARED)) ||
      (scratch == nullptr && mode == MODE_DEVICE))
    return static_cast<int>(cudaErrorInvalidValue);
  FftPlan plan;
  int err = make_plan(radices, n_stages, nt, groups, &plan);
  if (err != 0) return err;
  const MfccKernel fn = pick_kernel(chirp, mode);
  const size_t smem = mfcc_smem_bytes(mode, chirp != 0, n_fft, nt, groups, n_mels, n_mfcc, n_frames, n_weights);
  err = set_smem(fn, smem);
  if (err != 0) return err;
  fn<<<grid, FFT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      wav, is_int16, batch, n_samples, reinterpret_cast<const float2*>(twiddles), window,
      reinterpret_cast<const float2*>(pre), reinterpret_cast<const float2*>(post),
      reinterpret_cast<const float2*>(kernel), mel_ranges, mel_weights, n_weights, dct, db,
      reinterpret_cast<float2*>(scratch), out, n_fft, nt, hop, n_mels, n_mfcc, n_frames, groups, plan, reflect,
      top_db, use_top_db);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of kernel A (chirp mode if chirp, buffers where mode says) that fit
// one SM at these sizes (into *blocks), and its shared memory per block in
// bytes (into *smem_bytes); nt is the transform size (n_fft on the FFT path).
int mfcc_occupancy(int n_fft, int nt, int chirp, int mode, int groups, int n_mels, int n_mfcc, int n_frames,
                   int n_weights, int* blocks, int* smem_bytes) {
  if (mode < MODE_SHARED || mode > MODE_DEVICE) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = mfcc_smem_bytes(mode, chirp != 0, n_fft, nt, groups, n_mels, n_mfcc, n_frames, n_weights);
  *smem_bytes = static_cast<int>(smem);
  const MfccKernel fn = pick_kernel(chirp, mode);
  const int err = set_smem(fn, smem);
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, FFT_THREADS, smem));
}

// Kernel A's cluster route on `clusters` clusters of C = ctas CTAs of 1024
// threads (ops/mfcc.py::cluster_occupancy: at most as many as are resident).
// radices1/radices2: the stages of l1 and l2 (L = l1 * l2; C divides both).
// FFT path (chirp 0): L = n_fft, window read, pre/post/kernel unused;
// Bluestein path (chirp 1): L >= 2 n_fft - 1, pre, post (n_fft, 2) and kernel
// (L, 2), window unused. bands (C, 4) from ops/mfcc.py::cluster_bands; db
// (batch, n_frames, n_mels) scratch; a null dct is the log-mel mode. A launch
// the card refuses returns its error.
int mfcc_cluster_forward(const void* wav, int is_int16, int batch, int n_samples, const float* twiddles,
                         const float* window, const float* pre, const float* post, const float* kernel,
                         const int* mel_ranges, const float* mel_weights, const int* bands, const float* dct,
                         float* db, float* out, int n_fft, int hop, int n_mels, int n_mfcc, int n_frames,
                         const int* radices1, int n_stages1, const int* radices2, int n_stages2, int ctas,
                         int clusters, int chirp, int reflect, float top_db, int use_top_db, void* stream) {
  FftPlan f1, f2;
  int l1, l2;
  size_t smem;
  int err = cluster_setup(radices1, n_stages1, radices2, n_stages2, ctas, chirp, &f1, &f2, &l1, &l2, &smem);
  if (err != 0) return err;
  const int size = l1 * l2;
  if ((chirp ? size < 2 * n_fft - 1 : size != n_fft) || clusters < 1 || clusters > batch || db == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(clusters, ctas, smem, static_cast<cudaStream_t>(stream), &attr);
  const float2* tw = reinterpret_cast<const float2*>(twiddles);
  const float2* pre2 = reinterpret_cast<const float2*>(pre);
  const float2* post2 = reinterpret_cast<const float2*>(post);
  const float2* ck = reinterpret_cast<const float2*>(kernel);
  err = static_cast<int>(cudaLaunchKernelEx(
      &cfg, cluster_kernel(chirp), wav, is_int16, batch, n_samples, tw,
      window, pre2, post2, ck, mel_ranges, mel_weights, bands, dct, db, out, n_fft, hop, n_mels, n_mfcc, n_frames,
      l1, l2, f1, f2, ctas, reflect, top_db, use_top_db));
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

// Clusters of the cluster route's kernel that can be resident at once (into
// *clusters) and its shared memory a CTA in bytes (into *smem_bytes).
int mfcc_cluster_occupancy(const int* radices1, int n_stages1, const int* radices2, int n_stages2, int ctas,
                           int chirp, int* clusters, int* smem_bytes) {
  FftPlan f1, f2;
  int l1, l2;
  size_t smem = 0;
  const int err = cluster_setup(radices1, n_stages1, radices2, n_stages2, ctas, chirp, &f1, &f2, &l1, &l2, &smem);
  *smem_bytes = static_cast<int>(smem);
  if (err != 0) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, ctas, smem, nullptr, &attr);
  const void* fn = reinterpret_cast<const void*>(cluster_kernel(chirp));
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, fn, &cfg));
}

}  // extern "C"
