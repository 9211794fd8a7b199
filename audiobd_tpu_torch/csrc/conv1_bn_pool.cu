// Backward of maxpool_{1,3}(BN(relu(conv2x2_{1->C}(x)))), the first SmallCNN
// block, without the pre-pool activation.
//
// Replaces: audiobd_tpu/ops/fused_conv_block.py, the two Pallas kernels of
// `conv1_bn_pool`'s custom VJP:
//   * _make_bwd_merged_kernel (pallas_call in _run_bwd_merged, line 226):
//     the parameter gradient  -> conv1_bn_pool_bwd_params below (kernel B);
//   * _make_dp_kernel (pallas_call in _run_dp, line 243): the input
//     gradient -> conv1_bn_pool_bwd_input below (kernel C).
//
// Layout (NCHW, as the port's model): x (B, H, W) f32, the incoming gradient
// g (B, C, H', Wp) with H' = H-1, Wp = (W-1)/3; per-channel w5 (C, 5) = the
// four 2x2 taps and the bias, and the forward's mu, inv = 1/sqrt(var+eps),
// scale = gamma*inv, shift = beta - mu*scale.
//
// Math (as the Pallas kernels): for each pooled position m = (b, i, j') and
// channel c the three conv outputs of its pool window (phases t = 0, 1, 2,
// column 3j'+t) are recomputed from the 2x2 taps of x:
//   y_t = w.p_t + bias, r_t = relu(y_t), z_t = r_t*scale + shift,
// the pool winner is the FIRST phase with z_t == max(z) (after relu many
// positions have r = 0 in several phases, so exact ties are common and the
// rule decides where the gradient goes), dz_t = g at the winner, 0 elsewhere.
//   dwA = sum p*relu'*dz, dwB = sum p*relu', dwC = sum p*relu'*xhat,
//   S1 = sum dz, S2 = sum dz*xhat                                  (kernel B)
//   dw = scale*dwA - h1*dwB - h2*dwC, dgamma = S2, dbeta = S1,
//   h1 = scale*S1/N, h2 = scale*S2/N (train mode; 0 in eval mode, where the
//   running statistics are constants and dwB, dwC are not needed).
//   dy_t = relu'*(scale*dz_t - h1 - xhat_t*h2), dx = conv-transpose of dy (C).
// y and z are formed with __fmul_rn/__fadd_rn in a fixed order (no FMA
// contraction), so the plain PyTorch version in ops/conv1_bn_pool.py
// reproduces them bit for bit and routes every tie the same way. r and z
// are rounded to the forward's compute dtype before the compare; in f32
// that rounding is the identity (round_to_compute below).
//
// What bounds it on the H100: device-memory bytes by the data sheet (at the
// main path's shape, B 256, H 101, W 40, C 64, g is 85 MB and x 4 MB: 0.027
// ms), but in practice f32 issue: the recompute's unfused multiplies and adds
// (kept so the routing is bit-identical, 33 a pair) and the sums take ~100
// instructions per (position, channel) pair in train mode, 21.3 M pairs,
// ~0.075 ms at the issue peak. The recompute trades them for never storing
// or re-reading the 85 MB-per-phase pre-pool activation.
//
// Design:
//  * Kernel B: a grid of (clip, span of its positions, slice of 8 channels)
//    blocks; a clip is one span up to 3,072 pooled positions (the main
//    path's has 1,300), more for longer clips. The span's 2x4 patches (41.6
//    KB at the main path) are staged in shared memory once, as two
//    position-major float4 planes; warp w owns one channel (parameters and
//    sums in registers) and its lanes walk the span's positions, so g is
//    read as 128 contiguous bytes of one channel a warp load and the patch
//    as two conflict-free 16-byte loads a lane. Only the winning phase
//    carries dz, so the dz terms are formed once a pair; the BN-mean terms
//    (train mode) run on every active phase without a branch, as sums of p
//    and p*r, x-hat's shift and scale applied once a lane. The TPU kernel
//    carried one accumulator from grid step to grid step; Hopper blocks run
//    in no order, so each warp writes its sums, reduced by a shuffle tree, to
//    a (17, C, spans) scratch, and a second pass of one block per channel
//    adds the spans' partials in a fixed order (deterministic, no atomics)
//    and forms dw, dgamma, dbeta, h1, h2.
//  * Kernel C: one thread per pooled position loops over the channels
//    (their parameters in shared memory), recomputes the pool window, and
//    sums w.dy over channels into the four per-tap planes dp (4, B, H', W-1);
//    a gather pass then forms dx[b,i,j] from the <= 4 conv outputs that read
//    x[b,i,j], again without atomics. The bias tap gets no cotangent.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;         // kernel C
constexpr int NACC = 17;             // dwA[5], dwB[5], dwC[5], S1, S2
constexpr int PARAMS_THREADS = 256;  // kernel B: a block takes PARAMS_THREADS / 32 channels, one a warp
constexpr int PARAMS_UNROLL = 4;     // positions a lane takes a pass, their g loads issued together

// The forward's compute dtype is f32 in this build: rounding r and z to it
// is the identity. A bf16 build rounds here, as _phase_rz does.
__device__ __forceinline__ float round_to_compute(float v) { return v; }

struct Window {
  float p[3][4];  // the 2x2 taps of x for the three phases
  float r[3];
  float z[3];
  int win;        // first phase whose z equals the pool max
};

// Loads the 2x4 patch of x under pooled position (b, i, j') and recomputes
// the window for one channel.
__device__ __forceinline__ void load_patch(const float* __restrict__ x, int H, int W,
                                           int b, int i, int jp, float a[4], float d[4]) {
  const float* r0 = x + ((long long)b * H + i) * W + 3 * jp;
  const float* r1 = r0 + W;
#pragma unroll
  for (int k = 0; k < 4; ++k) { a[k] = __ldg(r0 + k); d[k] = __ldg(r1 + k); }
}

__device__ __forceinline__ void recompute(const float a[4], const float d[4], const float w[5],
                                          float scale, float shift, Window& win) {
  float zmax = 0.0f;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    win.p[t][0] = a[t]; win.p[t][1] = a[t + 1]; win.p[t][2] = d[t]; win.p[t][3] = d[t + 1];
    float y = __fmul_rn(w[0], win.p[t][0]);
    y = __fadd_rn(y, __fmul_rn(w[1], win.p[t][1]));
    y = __fadd_rn(y, __fmul_rn(w[2], win.p[t][2]));
    y = __fadd_rn(y, __fmul_rn(w[3], win.p[t][3]));
    y = __fadd_rn(y, w[4]);
    const float r = round_to_compute(fmaxf(y, 0.0f));
    const float z = round_to_compute(__fadd_rn(__fmul_rn(r, scale), shift));
    win.r[t] = r;
    win.z[t] = z;
    zmax = t == 0 ? z : fmaxf(zmax, z);
  }
  win.win = win.z[0] == zmax ? 0 : (win.z[1] == zmax ? 1 : 2);
}

// A lane's running sums in kernel B. The BN-mean terms are kept as sums of
// p and of p*r over the active phases (r = 0 on the others, so p*r needs no
// mask), and the x-hat sums as sums of r: x-hat = (r - mu)*inv is applied
// once a lane, when its ~120 terms are folded into the partial sums, not
// per phase.
struct LaneSums {
  float a[5];   // dwA: the winner's taps (and bias) times relu'*dz
  float nb[5];  // dwB: taps (and count) over the active phases
  float ne[5];  // sum of tap*r (and of r) over the active phases
  float s1;     // sum of g (dbeta)
  float s2;     // sum of g * r of the winner
};

// One (position, channel) pair of kernel B: top and bottom are the window's
// 2x4 patch of x (rows i and i+1, columns 3j'..3j'+3), gq is g there.
template <bool TRAIN>
__device__ __forceinline__ void params_pair(const float4 top, const float4 bottom, float gq, const float w[5],
                                            float scale, float shift, LaneSums& s) {
  const float a[4] = {top.x, top.y, top.z, top.w}, d[4] = {bottom.x, bottom.y, bottom.z, bottom.w};
  Window win;
  recompute(a, d, w, scale, shift, win);
  // Only the winner carries dz = g: its taps, relu' and r.
  const int t = win.win;
  const float rw = t == 0 ? win.r[0] : (t == 1 ? win.r[1] : win.r[2]);
  const float t1 = rw > 0.0f ? gq : 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float pk = t == 0 ? win.p[0][k] : (t == 1 ? win.p[1][k] : win.p[2][k]);
    s.a[k] = fmaf(pk, t1, s.a[k]);
  }
  s.a[4] += t1;
  s.s1 += gq;
  s.s2 = fmaf(gq, rw, s.s2);
  if constexpr (TRAIN) {
    // The BN-mean terms over every active phase, without a branch.
#pragma unroll
    for (int ph = 0; ph < 3; ++ph) {
      const float u1 = win.r[ph] > 0.0f ? 1.0f : 0.0f, r = win.r[ph];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s.nb[k] = fmaf(win.p[ph][k], u1, s.nb[k]);
        s.ne[k] = fmaf(win.p[ph][k], r, s.ne[k]);
      }
      s.nb[4] += u1;
      s.ne[4] += r;
    }
  }
}

// Kernel B, pass 1. Block (clip b, chunk of its positions, slice of
// PARAMS_THREADS / 32 channels): a clip's plane of pooled positions is cut
// into `chunks` equal spans, so that a span's patches fit shared memory at
// any clip length (one span at the main path's 1,300 positions). The
// span's patches are staged in shared memory once, position-major as two
// float4 planes (top[p]: row i, columns 3j'..3j'+3; bottom[p]: row i+1), so
// a warp's 32 consecutive positions read each plane as 512 contiguous bytes,
// 4 wavefronts with no bank conflict, where 8 scalar loads at stride 3 from
// the raw rows cost 16 (rows of 40 samples put the next row's positions on
// the same banks). Warp w owns one channel (its parameters and sums in
// registers) and its lanes walk the span's positions, so a warp reads g as
// 128 contiguous bytes of one channel and index math is 32-bit with no
// division per (position, channel) pair. Full passes of 32 * PARAMS_UNROLL
// positions run without bounds checks and issue their g loads together;
// the rest of the span follows one position a lane. The warp's sums, each
// lane's folded to the NACC partial sums, reduce by a shuffle tree in a
// fixed order and land in partial (NACC, C, B * chunks), one slot per (sum,
// channel, span).
template <bool TRAIN>
__global__ void __launch_bounds__(PARAMS_THREADS)
bwd_params_partial(const float* __restrict__ x, const float* __restrict__ g,
                   const float* __restrict__ w5, const float* __restrict__ mu_p,
                   const float* __restrict__ inv_p, const float* __restrict__ scale_p,
                   const float* __restrict__ shift_p, float* __restrict__ partial,
                   int H, int W, int C, int chunks) {
  extern __shared__ float4 top[];  // (span) row i of each position's patch, then bottom (span), row i+1
  const int b = blockIdx.x / chunks;
  const int Wp = (W - 1) / 3, plane = (H - 1) * Wp;
  const int span = (plane + chunks - 1) / chunks;
  const int first = (blockIdx.x - b * chunks) * span, n = min(span, plane - first);
  float4* bottom = top + span;
  const float* xb = x + static_cast<size_t>(b) * H * W;
  for (int e = threadIdx.x; e < n; e += PARAMS_THREADS) {
    const int q = first + e, i = q / Wp;
    const float* r0 = xb + i * W + 3 * (q - i * Wp);
    top[e] = make_float4(__ldg(r0), __ldg(r0 + 1), __ldg(r0 + 2), __ldg(r0 + 3));
    bottom[e] = make_float4(__ldg(r0 + W), __ldg(r0 + W + 1), __ldg(r0 + W + 2), __ldg(r0 + W + 3));
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int c = blockIdx.y * (PARAMS_THREADS / 32) + (threadIdx.x >> 5);
  if (c >= C) return;  // the whole warp; no barrier follows
  float w[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) w[k] = __ldg(w5 + c * 5 + k);
  const float mu = __ldg(mu_p + c), inv = __ldg(inv_p + c);
  const float scale = __ldg(scale_p + c), shift = __ldg(shift_p + c);
  const float* gc = g + (static_cast<size_t>(b) * C + c) * plane + first;
  LaneSums s = {};

  int base = 0;
  for (; base + 32 * PARAMS_UNROLL <= n; base += 32 * PARAMS_UNROLL) {
    float gv[PARAMS_UNROLL];
#pragma unroll
    for (int u = 0; u < PARAMS_UNROLL; ++u) gv[u] = __ldg(gc + base + 32 * u + lane);
#pragma unroll
    for (int u = 0; u < PARAMS_UNROLL; ++u) {
      const int p = base + 32 * u + lane;
      params_pair<TRAIN>(top[p], bottom[p], gv[u], w, scale, shift, s);
    }
  }
  for (int p = base + lane; p < n; p += 32)
    params_pair<TRAIN>(top[p], bottom[p], __ldg(gc + p), w, scale, shift, s);

  // Fold: rows 0-4 dwA, 5-9 dwB, 10-14 dwC = inv * (sum p*r - mu * sum p),
  // 15 S1, 16 S2 = inv * (sum g*r - mu * S1).
  float acc[NACC];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    acc[k] = s.a[k];
    acc[5 + k] = s.nb[k];
    acc[10 + k] = (s.ne[k] - mu * s.nb[k]) * inv;
  }
  acc[15] = s.s1;
  acc[16] = (s.s2 - mu * s.s1) * inv;
#pragma unroll
  for (int k = 0; k < NACC; ++k) {
    if (!TRAIN && k >= 5 && k < 15) continue;
    float v = acc[k];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) partial[(static_cast<size_t>(k) * C + c) * gridDim.x + blockIdx.x] = v;
  }
}

// Kernel B, pass 2: block c adds channel c's per-span partials in a fixed
// order (warp w takes sums w, w + 8, w + 16; lanes stride the spans, then a
// shuffle tree) and forms out (9, C): rows 0-4 dw (taps, bias), 5 dgamma,
// 6 dbeta, 7 h1, 8 h2.
__global__ void __launch_bounds__(PARAMS_THREADS)
bwd_params_finish(const float* __restrict__ partial, const float* __restrict__ scale_p,
                  float* __restrict__ out, int C, int nb, float n_total, int train_bn) {
  __shared__ float sums[NACC];
  const int c = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = warp; k < NACC; k += PARAMS_THREADS / 32) {
    if (!train_bn && k >= 5 && k < 15) continue;
    const float* row = partial + (static_cast<size_t>(k) * C + c) * nb;
    float v = 0.0f;
    for (int s = lane; s < nb; s += 32) v += row[s];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) sums[k] = v;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const float scale = scale_p[c];
  const float s1 = sums[15], s2 = sums[16];
  float h1 = 0.0f, h2 = 0.0f;
  if (train_bn) {
    h1 = scale * s1 / n_total;
    h2 = scale * s2 / n_total;
  }
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    float dw = sums[k] * scale;
    if (train_bn) dw = dw - sums[5 + k] * h1 - sums[10 + k] * h2;
    out[k * C + c] = dw;
  }
  out[5 * C + c] = s2;
  out[6 * C + c] = s1;
  out[7 * C + c] = h1;
  out[8 * C + c] = h2;
}

template <bool TRAIN>
int launch_params_partial(const float* x, const float* g, const float* w5, const float* mu, const float* inv,
                          const float* scale, const float* shift, float* partial, int B, int H, int W, int C,
                          int chunks, cudaStream_t s) {
  const int plane = (H - 1) * ((W - 1) / 3);
  const int smem = static_cast<int>(sizeof(float4)) * 2 * ((plane + chunks - 1) / chunks);
  cudaError_t err = cudaFuncSetAttribute(bwd_params_partial<TRAIN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slices = (C + PARAMS_THREADS / 32 - 1) / (PARAMS_THREADS / 32);
  bwd_params_partial<TRAIN><<<dim3(B * chunks, slices), PARAMS_THREADS, smem, s>>>(
      x, g, w5, mu, inv, scale, shift, partial, H, W, C, chunks);
  return static_cast<int>(cudaGetLastError());
}

// dp (4, B, H', W-1): per-tap sums over channels of w[c][k] * dy[c].
__global__ void __launch_bounds__(THREADS)
bwd_input_dp(const float* __restrict__ x, const float* __restrict__ g,
             const float* __restrict__ w5, const float* __restrict__ mu_p,
             const float* __restrict__ inv_p, const float* __restrict__ scale_p,
             const float* __restrict__ shift_p, const float* __restrict__ h_p,
             float* __restrict__ dp, int B, int H, int W, int C, int train_bn) {
  extern __shared__ float prm[];  // (C, 11): w0..w4, mu, inv, scale, shift, h1, h2
  for (int q = threadIdx.x; q < C; q += blockDim.x) {
    float* row = prm + q * 11;
#pragma unroll
    for (int k = 0; k < 5; ++k) row[k] = w5[q * 5 + k];
    row[5] = mu_p[q]; row[6] = inv_p[q]; row[7] = scale_p[q]; row[8] = shift_p[q];
    row[9] = h_p[q]; row[10] = h_p[C + q];
  }
  __syncthreads();

  const int Hp = H - 1, Wc = W - 1, Wp = Wc / 3;
  const int plane = Hp * Wp;
  const long long M = (long long)B * plane;
  const long long m = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (m >= M) return;
  const int b = static_cast<int>(m / plane);
  const int ij = static_cast<int>(m - (long long)b * plane);
  const int i = ij / Wp, jp = ij - i * Wp;
  float a[4], d[4];
  load_patch(x, H, W, b, i, jp, a, d);

  float dpa[3][4];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int k = 0; k < 4; ++k) dpa[t][k] = 0.0f;

  const float* gb = g + (long long)b * C * plane + ij;
  for (int c = 0; c < C; ++c) {
    const float* row = prm + c * 11;
    const float w[5] = {row[0], row[1], row[2], row[3], row[4]};
    const float mu = row[5], inv = row[6], scale = row[7], shift = row[8];
    Window win;
    recompute(a, d, w, scale, shift, win);
    const float gv = __ldg(gb + (long long)c * plane);
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const float dz = t == win.win ? gv : 0.0f;
      float dr = scale * dz;
      if (train_bn) dr = dr - row[9] - ((win.r[t] - mu) * inv) * row[10];
      const float dy = win.r[t] > 0.0f ? dr : 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) dpa[t][k] = fmaf(w[k], dy, dpa[t][k]);
    }
  }
  const long long tap = (long long)B * Hp * Wc;
  float* out = dp + ((long long)b * Hp + i) * Wc + 3 * jp;
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int t = 0; t < 3; ++t) out[k * tap + t] = dpa[t][k];
}

// dx[b,i,j] = dp0[b,i,j] + dp1[b,i,j-1] + dp2[b,i-1,j] + dp3[b,i-1,j-1].
__global__ void bwd_input_unpatch(const float* __restrict__ dp, float* __restrict__ dx,
                                  int B, int H, int W) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= (long long)B * H * W) return;
  const int j = static_cast<int>(n % W);
  const int i = static_cast<int>((n / W) % H);
  const int b = static_cast<int>(n / ((long long)W * H));
  const int Hp = H - 1, Wc = W - 1;
  const long long tap = (long long)B * Hp * Wc;
  const float* p = dp + (long long)b * Hp * Wc;
  float v = 0.0f;
  if (i < Hp && j < Wc) v += p[i * Wc + j];
  if (i < Hp && j >= 1) v += p[tap + i * Wc + j - 1];
  if (i >= 1 && j < Wc) v += p[2 * tap + (i - 1) * Wc + j];
  if (i >= 1 && j >= 1) v += p[3 * tap + (i - 1) * Wc + j - 1];
  dx[n] = v;
}

}  // namespace

extern "C" {

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

int use_device(int device) { return static_cast<int>(cudaSetDevice(device)); }

// Kernel B: each clip's positions in `chunks` spans; partial (17, C, B *
// chunks) scratch, out (9, C).
int conv1_bn_pool_bwd_params(const float* x, const float* g, const float* w5, const float* mu,
                             const float* inv, const float* scale, const float* shift,
                             float* partial, float* out, int B, int H, int W, int C, int chunks,
                             int train_bn, void* stream) {
  if (chunks < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err =
      train_bn ? launch_params_partial<true>(x, g, w5, mu, inv, scale, shift, partial, B, H, W, C, chunks, s)
               : launch_params_partial<false>(x, g, w5, mu, inv, scale, shift, partial, B, H, W, C, chunks, s);
  if (err != 0) return err;
  const float n_total = 3.0f * static_cast<float>(B) * (H - 1) * ((W - 1) / 3);
  bwd_params_finish<<<C, PARAMS_THREADS, 0, s>>>(partial, scale, out, C, B * chunks, n_total, train_bn);
  return static_cast<int>(cudaGetLastError());
}

// Kernel C: h (2, C) from kernel B, dp (4, B, H-1, W-1) scratch, dx (B, H, W).
int conv1_bn_pool_bwd_input(const float* x, const float* g, const float* w5, const float* mu,
                            const float* inv, const float* scale, const float* shift,
                            const float* h, float* dp, float* dx, int B, int H, int W, int C,
                            int train_bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = (long long)B * (H - 1) * ((W - 1) / 3);
  const int smem = C * 11 * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(bwd_input_dp, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_input_dp<<<static_cast<unsigned>((M + THREADS - 1) / THREADS), THREADS, smem, s>>>(
      x, g, w5, mu, inv, scale, shift, h, dp, B, H, W, C, train_bn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long N = (long long)B * H * W;
  bwd_input_unpatch<<<static_cast<unsigned>((N + 255) / 256), 256, 0, s>>>(dp, dx, B, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
