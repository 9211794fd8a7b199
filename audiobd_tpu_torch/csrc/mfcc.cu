// Waveform -> MFCC in one kernel, one thread block per clip, by one of two
// paths that ops/mfcc.py::mfcc_path picks from n_fft alone, each a Stockham
// FFT; where its buffers live is a choice by size (MODE, below).
//
// Replaces: audiobd_tpu/ops/pallas_mfcc.py::fused_mfcc (the Pallas `_kernel`,
// pallas_call at line 129). Same function on every path: centre-padded,
// Hann-windowed power spectrum, mel filterbank, 10*log10 with a per-clip
// top_db floor, orthonormal DCT-II. All float32, no TF32 (the reference runs
// its products at Precision.HIGHEST). Input is int16 PCM (scaled by 2^-15 on
// load, exactly as dequantize_pcm does) or f32; reflect or constant centre
// padding is index arithmetic, with no padded copy in device memory.
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
// Where the buffers live (MODE, chosen on the host from the sizes,
// ops/mfcc.py::mfcc_route), one stage loop for all three:
//  * 0, shared: twiddles staged in shared memory beside the groups' buffers;
//    the FFT path keeps its window and the clip's dB tile there too, the
//    chirp mode its dB tile in a device-memory scratch (read back, floored,
//    for the DCT), which leaves room for two groups of 256 at L = 2240.
//    Sizes whose layout fits two blocks an SM (113 KB): n_fft 400 (110.8 KB),
//    2048 (83.3 KB), Bluestein L 2240 (95.5 KB).
//  * 1, large: only the buffers, packed mel weights and ranges in shared
//    memory; twiddles and window read through the read-only cache, the dB
//    tile in device memory. Every transform up to MAX_SMEM_FFT = 8192 points
//    (128 KB of buffers for one group of 512, one block an SM; at n_fft 2205
//    two groups, 80 KB, two blocks an SM).
//  * 2, device: the buffers too in a device-memory scratch, 2 x nt float2 a
//    block, for any larger transform (n_fft 4097, whose L = 8232 passes 8192,
//    or 16384); the grid is as many blocks as are resident, each looping over
//    clips, so the scratch stays L2-sized.
//
// Occupancy: 512 threads a block, __launch_bounds__(512, 2) holds registers
// to 64, so two blocks (1,024 threads) sit on an SM where shared memory
// allows.

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
template <int R, bool TW_LDG>
__device__ void fft_stage(const float2* __restrict__ src, float2* __restrict__ dst,
                          const float2* __restrict__ tw, int n, int length, int rank, int size) {
  const int m = n / R;
  const int tw_step = n / (length * R);
  for (int j = rank; j < m; j += size) {
    const int k = j % length;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = src[j + r * m];
    if (length > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = cmul(v[r], TW_LDG ? __ldg(tw + k * r * tw_step) : tw[k * r * tw_step]);
    }
    small_dft<R>(v);
    float2* d = dst + (j - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) d[r * length] = v[r];
  }
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
constexpr int MAX_SMEM_FFT = 8192;                                // the largest transform in shared memory

// CHIRP = false: the FFT path, transform size nt = n. CHIRP = true: the
// Bluestein path, nt = L >= 2n - 1, with pre = hann * c, post = c and
// ck = FFT_L(h) / L read through the read-only cache (window unused). MODE:
// the header's. db_out (batch, n_frames, n_mels) takes the dB tile unless
// the FFT path keeps it in shared memory (MODE_SHARED); scratch holds the
// buffers in MODE_DEVICE, 2 * groups * nt float2 for each block of the grid.
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
                const float* __restrict__ dct,        // (n_mels, n_mfcc)
                float* __restrict__ db_out,           // (batch, n_frames, n_mels) scratch
                float2* __restrict__ scratch,         // (gridDim.x, 2 * groups * nt) (MODE_DEVICE)
                float* __restrict__ out,              // (batch, n_frames, n_mfcc)
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
  float* wts_s = DB_GLOBAL ? tail : db_tile + n_frames * n_mels;      // n_weights
  int* rng_s = reinterpret_cast<int*>(wts_s + n_weights);             // 3 * n_mels
  const float2* tw = TW_LDG ? twiddles : tw_s;
  __shared__ float red_s[FFT_THREADS / 32];

  const int tid = threadIdx.x;
  if constexpr (!TW_LDG) {
    for (int e = tid; e < nt; e += FFT_THREADS) tw_s[e] = twiddles[e];
  }
  if constexpr (!DB_GLOBAL) {
    for (int e = tid; e < n; e += FFT_THREADS) win_s[e] = window[e];
  }
  for (int e = tid; e < n_weights; e += FFT_THREADS) wts_s[e] = mel_weights[e];
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
        for (int q = 0; q < count; ++q) acc = fmaf(row[q], wts_s[off + q], acc);
        const float db = 10.0f * log10f(fmaxf(acc, 1e-10f));
        db_s[(f0 + h) * n_mels + mel] = db;
        local_max = fmaxf(local_max, db);
      }
      group_sync(group, size);  // the next pair's load rewrites the buffers
    }
    __syncthreads();  // every group is done with the buffers

    const float floor_db = use_top_db ? block_max<FFT_THREADS>(local_max, red_s) - top_db : -CUDART_INF_F;
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
  size_t bytes = sizeof(float) * (size_t)n_weights + sizeof(int) * 3 * (size_t)n_mels;
  if (mode == MODE_DEVICE) return bytes;
  bytes += sizeof(float2) * (size_t)fft_region(nt, groups, n_mels, n_mfcc);
  if (mode == MODE_LARGE) return bytes;
  bytes += sizeof(float2) * (size_t)nt;
  if (!chirp) bytes += sizeof(float) * ((size_t)n + (size_t)n_frames * n_mels);
  return bytes;
}

int set_smem(MfccKernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           static_cast<int>(cudaSharedmemCarveoutMaxShared)));
}

// The stage plan from the host's radices: their product must be nt, at most
// MAX_SMEM_FFT unless the buffers live in device memory.
int make_plan(const int* radices, int n_stages, int nt, int groups, int mode, FftPlan* plan) {
  if (n_stages < 1 || n_stages > MAX_STAGES || groups < 1 || groups > 8 || (groups & (groups - 1)) ||
      mode < MODE_SHARED || mode > MODE_DEVICE)
    return static_cast<int>(cudaErrorInvalidValue);
  plan->n_stages = n_stages;
  long long product = 1;
  for (int s = 0; s < n_stages; ++s) {
    const int r = radices[s];
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 7 && r != 8) return static_cast<int>(cudaErrorInvalidValue);
    plan->radix[s] = r;
    product *= r;
  }
  const bool fits = mode == MODE_DEVICE || nt <= MAX_SMEM_FFT;
  return product == nt && fits ? 0 : static_cast<int>(cudaErrorInvalidValue);
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
// FFT path; scratch (grid, 2 * groups * nt, 2) in mode 2.
int mfcc_forward(const void* wav, int is_int16, int batch, int n_samples, const float* twiddles, const float* window,
                 const float* pre, const float* post, const float* kernel, const int* mel_ranges,
                 const float* mel_weights, int n_weights, const float* dct, float* db, float* scratch, float* out,
                 int n_fft, int nt, int hop, int n_mels, int n_mfcc, int n_frames, int groups, int grid,
                 const int* radices, int n_stages, int chirp, int mode, int reflect, float top_db, int use_top_db,
                 void* stream) {
  if (chirp ? nt < 2 * n_fft - 1 : nt != n_fft) return static_cast<int>(cudaErrorInvalidValue);
  if (grid < 1 || (mode != MODE_DEVICE && grid != batch)) return static_cast<int>(cudaErrorInvalidValue);
  if ((db == nullptr && (chirp || mode != MODE_SHARED)) || (scratch == nullptr && mode == MODE_DEVICE))
    return static_cast<int>(cudaErrorInvalidValue);
  FftPlan plan;
  int err = make_plan(radices, n_stages, nt, groups, mode, &plan);
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

}  // extern "C"
