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
// are rounded to the forward's compute dtype before the compare
// (round_to_compute below; the identity in f32).
//
// Compute dtype: each kernel is a template over x's type XT and the compute
// type CT (g's type); the f32 instantiation <float, float> is the f32
// kernel. In bf16 (CT = __nv_bfloat16; _phase_rz and the bf16 operands of
// _run_bwd_merged and _run_dp): x (f32 or bf16) and the taps w5 are rounded
// to bf16 where they are loaded; y = sum of the rounded taps times x, the
// bias folded in, is formed in f32 and rounded ONCE, at r (the forward
// rounds after the conv and again after the bias add: the reference's own
// difference, kept); z is rounded too, and ties go to the first match. g is
// read as bf16, and the sums multiply the bf16-rounded x. Kernel C rounds
// each tap's dp (the sum over channels, in f32) to bf16, as the Pallas dp
// is bf16, and forms dx as the f32 sum of a position's rounded taps in a
// fixed order, rounded once to bf16 and written in x's type. The reference's
// un-patch VJP adds the bf16 taps in bf16, so its dx may differ from this
// one by 1 bf16 ulp. B's output stays f32.
//
// What bounds it on the H100: device-memory bytes by the data sheet (at the
// main path's shape, B 256, H 101, W 40, C 64, g is 85 MB and x 4 MB: 0.027
// ms; at FlowMur's, x (256, 1, 32, 13), g is 8.1 MB: 0.0027 ms), but in
// practice f32 issue: the recompute's unfused multiplies and adds (kept so
// the routing is bit-identical, 33 a pair) and the sums take ~100
// instructions per (position, channel) pair in kernel B's train mode, 21.3
// M pairs at the main path, ~0.075 ms at the issue peak; kernel C takes ~60
// (eval) to ~75 (train). The recompute trades them for never storing or
// re-reading the 85 MB-per-phase pre-pool activation.
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
//  * Kernel C, one launch: a block owns a span of a clip's conv rows (the
//    whole clip when its dp tile fits ops/conv1_bn_pool.py's
//    INPUT_TILE_BYTES: 62 KB at the main path, 6 KB at FlowMur's) and
//    writes those rows of dx directly; the dp tile (4 taps x rows x (W-1))
//    lives in shared memory only, never in device memory. A span after
//    the first also recomputes the conv row above it (the halo row) for the
//    dp that dx's first row needs. Lanes own pooled positions (a thread
//    loads its 2x4 patch once, to registers) and warps own channel groups:
//    at FlowMur's 124 positions a clip there are only 4 warps of positions,
//    so two groups of 32 channels fill the block's 8 warps, where the old
//    kernel ran one thread's 64-channel chain per position on 124 blocks.
//    The groups' per-position sums meet in the tile in a fixed order (group
//    0 stores, the others add in turn behind barriers): deterministic, no
//    atomics. Eval mode does winner-only work: dz lives on the pool winner
//    and h1 = h2 = 0, so dy is scale*g there where r > 0 and zero elsewhere;
//    nothing reads h. Train mode forms dy = relu'*(A - r*Bc + [winner]*
//    scale*g) with A = mu*inv*h2 - h1, Bc = inv*h2 per channel, h1 and h2
//    from kernel B. The bias tap gets no cotangent.
//
// Forward (kernel G): replaces no Pallas kernel. The reference's forward is
// stock XLA (conv, relu, the batch statistics, normalise, reduce_window),
// and the port ran it as eager torch: cuDNN's conv, then ~11 elementwise
// passes over the pre-pool activation r (B, C, H', W-1), 1.02 GB at 1,024
// clips of (101, 40), each written and read again. G keeps the numbers of
// that chain bit for bit and takes away its passes. Both of its passes
// read x and recompute r in cuDNN's order (conv_tap_fma: the products
// accumulated by fused multiply-adds in tap order, then the bias added as
// torch adds it), so r is the plain chain's r:
//  * fwd_relu_square (conv1_bn_pool_fwd_relu), train mode only: r =
//    relu(y) and r*r, one element a thread, for torch's two means. The
//    batch statistics stay torch's reductions over the stored r and r*r:
//    the benchmark's train cell holds the first steps to the reference's
//    rounding, and another order of those sums moves the first gradient
//    past its limits. Where the chain took the conv, the bias add, the
//    clamp and r*r, this pass writes r and r*r once.
//  * fwd_pool (conv1_bn_pool_fwd), both modes: nothing is stored. A block
//    stages a span of a clip's 2x4 patches as kernel B does, warp w takes
//    FWD_CHANNELS channels at a time (taps, mu, inv, gamma, beta in
//    registers), its lanes walk the span, recompute r and write out[m] = the
//    max over window m (r's elements 3m .. 3m+2) of z = ((r - mu)*inv)*gamma
//    + beta; a warp's 32 positions of one channel are 128 contiguous bytes
//    of out. mu and inv are the batch statistics in train mode, the running
//    ones in eval mode; the chain wrote and read z four times and
//    max-pooled it.
// Each step rounds as the chain's torch op rounds it (__fadd_rn, __fsub_rn,
// __fmul_rn; relu and the max propagate NaN as clamp and max_pool2d do; a
// later phase wins the max only when greater). What bounds G: bytes. At
// 1,024 clips fwd_relu_square writes 2.04 GB (0.61 ms at 3.35 TB/s) and
// fwd_pool reads x (16.5 MB) and writes out (341 MB, 0.11 ms); fwd_pool's
// ~16 f32 instructions a (position, channel, phase), 255.6 M of them, take
// ~0.15 ms. The block's own bound, x read twice and out written once, is
// the 0.11 ms; the stored r and r*r, which torch's means read, are what
// the train mode pays over it. f32 only: the bf16 compute dtype keeps the
// plain chain.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NACC = 17;             // dwA[5], dwB[5], dwC[5], S1, S2
constexpr int PARAMS_THREADS = 256;  // kernel B: a block takes PARAMS_THREADS / 32 channels, one a warp
constexpr int PARAMS_UNROLL = 4;     // positions a lane takes a pass, their g loads issued together
constexpr int INPUT_THREADS = 256;   // kernel C
constexpr int INPUT_WARPS = INPUT_THREADS / 32;
constexpr int INPUT_UNROLL = 4;      // channels a thread takes a pass, their g loads issued together
constexpr int FWD_THREADS = 256;     // kernel G
constexpr int FWD_WARPS = FWD_THREADS / 32;
constexpr int FWD_CHANNELS = 4;      // channels a warp of kernel G's fwd_pool takes a pass, taps in registers

// v rounded to the compute type CT and held in f32: the identity for f32,
// round to nearest even for bf16, as _phase_rz's astype does.
template <typename CT>
__device__ __forceinline__ float round_to_compute(float v) {
  if constexpr (std::is_same_v<CT, bf16>) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same_v<T, bf16>) {
    return __float2bfloat16_rn(v);
  } else {
    return v;
  }
}

// An element of x, rounded to the compute type (exact when x is already in it).
template <typename XT, typename CT>
__device__ __forceinline__ float load_x(const XT* p) {
  const float v = to_f32(__ldg(p));
  if constexpr (std::is_same_v<XT, CT>) {
    return v;
  } else {
    return round_to_compute<CT>(v);
  }
}

struct Window {
  float p[3][4];  // the 2x2 taps of x for the three phases
  float r[3];
  float z[3];
  int win;        // first phase whose z equals the pool max
};

// Loads the 2x4 patch of x under pooled position (b, i, j'), rounded to the
// compute type.
template <typename XT, typename CT>
__device__ __forceinline__ void load_patch(const XT* __restrict__ x, int H, int W,
                                           int b, int i, int jp, float a[4], float d[4]) {
  const XT* r0 = x + ((long long)b * H + i) * W + 3 * jp;
  const XT* r1 = r0 + W;
#pragma unroll
  for (int k = 0; k < 4; ++k) { a[k] = load_x<XT, CT>(r0 + k); d[k] = load_x<XT, CT>(r1 + k); }
}

// y as cuDNN's implicit-GEMM convolution and torch's bias add form it: the
// four products accumulated by fused multiply-adds in tap order, the bias
// added after, rounded once. Kernel G, so that its r is the plain chain's.
__device__ __forceinline__ float conv_tap_fma(const float w[5], float p0, float p1, float p2, float p3) {
  float acc = __fmul_rn(w[0], p0);
  acc = __fmaf_rn(w[1], p1, acc);
  acc = __fmaf_rn(w[2], p2, acc);
  acc = __fmaf_rn(w[3], p3, acc);
  return __fadd_rn(acc, w[4]);
}

// z = ((r - mu)*inv)*gamma + beta, each step rounded: _norm_pool's order.
__device__ __forceinline__ float normalise(float r, float mu, float inv, float gamma, float beta) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(r, mu), inv), gamma), beta);
}

// relu as torch.clamp(y, min=0) takes it: NaN stays NaN.
__device__ __forceinline__ float relu(float y) { return isnan(y) ? y : fmaxf(y, 0.0f); }

// The running max of a window as max_pool2d takes it.
__device__ __forceinline__ float pool_max(float m, float z) { return z > m || isnan(z) ? z : m; }

// Recomputes the window for one channel from its patch (a: row i, d: row
// i+1) and taps w (w[4] the bias), both already in the compute type.
template <typename CT>
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
    const float r = round_to_compute<CT>(fmaxf(y, 0.0f));
    const float z = round_to_compute<CT>(__fadd_rn(__fmul_rn(r, scale), shift));
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
template <bool TRAIN, typename CT>
__device__ __forceinline__ void params_pair(const float4 top, const float4 bottom, float gq, const float w[5],
                                            float scale, float shift, LaneSums& s) {
  const float a[4] = {top.x, top.y, top.z, top.w}, d[4] = {bottom.x, bottom.y, bottom.z, bottom.w};
  Window win;
  recompute<CT>(a, d, w, scale, shift, win);
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

// Stages the 2x4 patches of a span of a clip's pooled positions [first,
// first + n) in shared memory, rounded to the compute type, position-major
// as two float4 planes: top[e] row i, columns 3j'..3j'+3 of position first
// + e; bottom[e] row i+1. xb is the clip's (H, W) plane. Kernels B and G.
template <typename XT, typename CT>
__device__ __forceinline__ void stage_patches(const XT* __restrict__ xb, int W, int Wp, int first, int n,
                                              float4* top, float4* bottom) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int q = first + e, i = q / Wp;
    const XT* r0 = xb + i * W + 3 * (q - i * Wp);
    top[e] = make_float4(load_x<XT, CT>(r0), load_x<XT, CT>(r0 + 1), load_x<XT, CT>(r0 + 2),
                         load_x<XT, CT>(r0 + 3));
    bottom[e] = make_float4(load_x<XT, CT>(r0 + W), load_x<XT, CT>(r0 + W + 1), load_x<XT, CT>(r0 + W + 2),
                            load_x<XT, CT>(r0 + W + 3));
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
// channel, span). The patches are staged rounded to the compute type, so
// the sums multiply the rounded x.
template <bool TRAIN, typename XT, typename CT>
__global__ void __launch_bounds__(PARAMS_THREADS)
bwd_params_partial(const XT* __restrict__ x, const CT* __restrict__ g,
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
  stage_patches<XT, CT>(x + static_cast<size_t>(b) * H * W, W, Wp, first, n, top, bottom);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int c = blockIdx.y * (PARAMS_THREADS / 32) + (threadIdx.x >> 5);
  if (c >= C) return;  // the whole warp; no barrier follows
  float w[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) w[k] = round_to_compute<CT>(__ldg(w5 + c * 5 + k));
  const float mu = __ldg(mu_p + c), inv = __ldg(inv_p + c);
  const float scale = __ldg(scale_p + c), shift = __ldg(shift_p + c);
  const CT* gc = g + (static_cast<size_t>(b) * C + c) * plane + first;
  LaneSums s = {};

  int base = 0;
  for (; base + 32 * PARAMS_UNROLL <= n; base += 32 * PARAMS_UNROLL) {
    float gv[PARAMS_UNROLL];
#pragma unroll
    for (int u = 0; u < PARAMS_UNROLL; ++u) gv[u] = to_f32(__ldg(gc + base + 32 * u + lane));
#pragma unroll
    for (int u = 0; u < PARAMS_UNROLL; ++u) {
      const int p = base + 32 * u + lane;
      params_pair<TRAIN, CT>(top[p], bottom[p], gv[u], w, scale, shift, s);
    }
  }
  for (int p = base + lane; p < n; p += 32)
    params_pair<TRAIN, CT>(top[p], bottom[p], to_f32(__ldg(gc + p)), w, scale, shift, s);

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

template <bool TRAIN, typename XT, typename CT>
int launch_params_partial(const XT* x, const CT* g, const float* w5, const float* mu, const float* inv,
                          const float* scale, const float* shift, float* partial, int B, int H, int W, int C,
                          int chunks, cudaStream_t s) {
  const int plane = (H - 1) * ((W - 1) / 3);
  const int smem = static_cast<int>(sizeof(float4)) * 2 * ((plane + chunks - 1) / chunks);
  cudaError_t err = cudaFuncSetAttribute(bwd_params_partial<TRAIN, XT, CT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slices = (C + PARAMS_THREADS / 32 - 1) / (PARAMS_THREADS / 32);
  bwd_params_partial<TRAIN, XT, CT><<<dim3(B * chunks, slices), PARAMS_THREADS, smem, s>>>(
      x, g, w5, mu, inv, scale, shift, partial, H, W, C, chunks);
  return static_cast<int>(cudaGetLastError());
}

// One (position, channel) pair of kernel C: adds w_k * dy_t to acc[t][k].
// taps = w0..w3, rest = (bias, scale, shift, -), h = (A, Bc) in train mode.
template <bool TRAIN, typename CT>
__device__ __forceinline__ void input_pair(const float a[4], const float d[4], const float4 taps,
                                           const float4 rest, const float2 h, float gq, float acc[3][4]) {
  const float w[5] = {taps.x, taps.y, taps.z, taps.w, rest.x};
  Window win;
  recompute<CT>(a, d, w, rest.y, rest.z, win);
  const float sg = rest.y * gq;  // scale * dz on the winner
  if constexpr (TRAIN) {
    // dy_t = relu'_t * (scale*dz_t - h1 - xhat_t*h2) over every active phase.
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      float dr = fmaf(-win.r[t], h.y, h.x);
      dr += t == win.win ? sg : 0.0f;
      const float dy = win.r[t] > 0.0f ? dr : 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[t][k] = fmaf(w[k], dy, acc[t][k]);
    }
  } else {
    // Eval mode: dy is scale*g on the winner where its relu is active.
    const float rw = win.win == 0 ? win.r[0] : (win.win == 1 ? win.r[1] : win.r[2]);
    const float v = rw > 0.0f ? sg : 0.0f;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const float dy = t == win.win ? v : 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[t][k] = fmaf(w[k], dy, acc[t][k]);
    }
  }
}

// Kernel C. Block (clip b, span s of its conv rows): conv rows [r0, r1) and,
// after the first span, the halo row r0 - 1; dx rows [r0, r1), and the last
// dx row with the last span. Shared memory: the channels' taps and (bias,
// scale, shift) as float4s, in train mode (A, Bc) as float2s, then the dp
// tile, four tap planes of (rows, W-1). Warp w takes channel group w %
// groups and every (INPUT_WARPS / groups)-th run of 32 positions; after each
// pass the groups' sums meet in the tile in group order, then the tile is
// un-patched: dx[i,j] = dp0[i,j] + dp1[i,j-1] + dp2[i-1,j] + dp3[i-1,j-1],
// summed in that order as the plain version's pads do, each dp rounded to
// the compute type first and the sum once more.
template <bool TRAIN, typename XT, typename CT>
__global__ void __launch_bounds__(INPUT_THREADS, 3)
bwd_input(const XT* __restrict__ x, const CT* __restrict__ g, const float* __restrict__ w5,
          const float* __restrict__ mu_p, const float* __restrict__ inv_p, const float* __restrict__ scale_p,
          const float* __restrict__ shift_p, const float* __restrict__ h_p, XT* __restrict__ dx,
          int H, int W, int C, int spans, int rows, int groups) {
  extern __shared__ float4 smem[];
  float4* taps = smem;                                          // (C) w0..w3
  float4* rest = smem + C;                                      // (C) bias, scale, shift, -
  float2* hab = reinterpret_cast<float2*>(smem + 2 * C);        // (C) A, Bc (train mode)
  float* tile = reinterpret_cast<float*>(hab + (TRAIN ? C : 0));  // (4, rows incl. halo, W-1)

  const int b = blockIdx.x / spans, s = blockIdx.x - b * spans;
  const int Hp = H - 1, Wc = W - 1, Wp = Wc / 3, plane = Hp * Wp;
  const int r0 = s * rows, r1 = min(Hp, r0 + rows);
  const int first = r0 > 0 ? r0 - 1 : 0;  // the halo row feeds dx row r0
  const int npos = (r1 - first) * Wp;
  const int tap = (r1 - first) * Wc;      // one tap plane of the tile
  for (int q = threadIdx.x; q < C; q += INPUT_THREADS) {
    const float* wq = w5 + 5 * q;
    taps[q] = make_float4(round_to_compute<CT>(wq[0]), round_to_compute<CT>(wq[1]), round_to_compute<CT>(wq[2]),
                          round_to_compute<CT>(wq[3]));
    rest[q] = make_float4(round_to_compute<CT>(wq[4]), scale_p[q], shift_p[q], 0.0f);
    if constexpr (TRAIN) {
      const float inv = inv_p[q], h2 = h_p[C + q];
      hab[q] = make_float2(mu_p[q] * inv * h2 - h_p[q], inv * h2);
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cg = warp % groups, slot = warp / groups, slots = INPUT_WARPS / groups;
  const int per = (C + groups - 1) / groups;
  const int c_lo = min(C, cg * per), c_hi = min(C, c_lo + per);
  const int passes = ((npos + 31) / 32 + slots - 1) / slots;
  const CT* gb = g + (static_cast<size_t>(b) * C * plane + first * Wp);
  for (int pass = 0; pass < passes; ++pass) {
    const int q = (pass * slots + slot) * 32 + lane;  // position in the span, halo row first
    const bool valid = q < npos;
    float acc[3][4] = {};
    if (valid) {
      const int li = q / Wp;
      float a[4], d[4];
      load_patch<XT, CT>(x, H, W, b, first + li, q - li * Wp, a, d);
      const CT* gq = gb + q;
      int c = c_lo;
      for (; c + INPUT_UNROLL <= c_hi; c += INPUT_UNROLL) {
        float gv[INPUT_UNROLL];
#pragma unroll
        for (int u = 0; u < INPUT_UNROLL; ++u) gv[u] = to_f32(__ldg(gq + static_cast<size_t>(c + u) * plane));
#pragma unroll
        for (int u = 0; u < INPUT_UNROLL; ++u)
          input_pair<TRAIN, CT>(a, d, taps[c + u], rest[c + u], TRAIN ? hab[c + u] : make_float2(0.0f, 0.0f),
                                gv[u], acc);
      }
      for (; c < c_hi; ++c)
        input_pair<TRAIN, CT>(a, d, taps[c], rest[c], TRAIN ? hab[c] : make_float2(0.0f, 0.0f),
                              to_f32(__ldg(gq + static_cast<size_t>(c) * plane)), acc);
    }
    // Position q's conv outputs are tile columns 3q .. 3q+2 of each tap plane
    // (W-1 = 3 Wp): lanes at a stride of 3 words, no bank conflict.
    for (int st = 0; st < groups; ++st) {
      if (valid && cg == st) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int t = 0; t < 3; ++t) {
            float* e = tile + k * tap + 3 * q + t;
            *e = st == 0 ? acc[t][k] : *e + acc[t][k];
          }
      }
      __syncthreads();
    }
  }

  const int last = r1 == Hp ? H : r1;  // the last span also writes dx row H-1
  XT* dxb = dx + (static_cast<size_t>(b) * H + r0) * W;
  const int n = (last - r0) * W;
  for (int e = threadIdx.x; e < n; e += INPUT_THREADS) {
    const int i = r0 + e / W, j = e - (e / W) * W;
    const float* row = tile + (i - first) * Wc;  // conv row i; row - Wc is conv row i-1
    float v = 0.0f;
    if (i < Hp) {
      if (j < Wc) v += round_to_compute<CT>(row[j]);
      if (j >= 1) v += round_to_compute<CT>(row[tap + j - 1]);
    }
    if (i >= 1) {
      if (j < Wc) v += round_to_compute<CT>(row[2 * tap - Wc + j]);
      if (j >= 1) v += round_to_compute<CT>(row[3 * tap - Wc + j - 1]);
    }
    dxb[e] = from_f32<XT>(round_to_compute<CT>(v));
  }
}

template <bool TRAIN, typename XT, typename CT>
int launch_input(const XT* x, const CT* g, const float* w5, const float* mu, const float* inv,
                 const float* scale, const float* shift, const float* h, XT* dx, int B, int H, int W, int C,
                 int spans, int rows, int groups, cudaStream_t s) {
  const int tile_rows = rows + (spans > 1 ? 1 : 0);
  const int smem = C * static_cast<int>(2 * sizeof(float4) + (TRAIN ? sizeof(float2) : 0)) +
                   4 * tile_rows * (W - 1) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(bwd_input<TRAIN, XT, CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_input<TRAIN, XT, CT><<<B * spans, INPUT_THREADS, smem, s>>>(x, g, w5, mu, inv, scale, shift, h, dx, H, W,
                                                                  C, spans, rows, groups);
  return static_cast<int>(cudaGetLastError());
}

// Kernel G, train mode, first pass. Block q takes row q = b*C + c of r's
// (B*C, (H-1)*(W-1)) rows, one element a thread: r = relu(y), r2 = r*r.
__global__ void __launch_bounds__(FWD_THREADS)
fwd_relu_square(const float* __restrict__ x, const float* __restrict__ weight, const float* __restrict__ bias,
                float* __restrict__ r, float* __restrict__ r2, int H, int W, int C) {
  const int b = blockIdx.x / C, c = blockIdx.x - b * C;
  float w[5];
#pragma unroll
  for (int t = 0; t < 4; ++t) w[t] = __ldg(weight + 4 * c + t);
  w[4] = __ldg(bias + c);
  const float* xb = x + static_cast<size_t>(b) * H * W;
  const int Wc = W - 1, plane = (H - 1) * Wc;
  const size_t row = static_cast<size_t>(blockIdx.x) * plane;
  for (int e = threadIdx.x; e < plane; e += FWD_THREADS) {
    const int i = e / Wc;
    const float* p = xb + i * W + (e - i * Wc);
    const float v = relu(conv_tap_fma(w, __ldg(p), __ldg(p + 1), __ldg(p + W), __ldg(p + W + 1)));
    r[row + e] = v;
    r2[row + e] = __fmul_rn(v, v);
  }
}

// Kernel G, the pool pass. Block (clip b, chunk of its positions), the span cut
// as kernel B cuts it; warp w takes channels [c0, c0 + FWD_CHANNELS) for c0
// = w * FWD_CHANNELS, w * FWD_CHANNELS + FWD_WARPS * FWD_CHANNELS, ... and
// its lanes walk the span.
__global__ void __launch_bounds__(FWD_THREADS)
fwd_pool(const float* __restrict__ x, const float* __restrict__ weight, const float* __restrict__ bias,
         const float* __restrict__ gamma, const float* __restrict__ beta, const float* __restrict__ mu_p,
         const float* __restrict__ inv_p, float* __restrict__ out, int H, int W, int C, int chunks) {
  extern __shared__ float4 top[];
  const int b = blockIdx.x / chunks;
  const int Wp = (W - 1) / 3, plane = (H - 1) * Wp;
  const int span = (plane + chunks - 1) / chunks;
  const int first = (blockIdx.x - b * chunks) * span, n = min(span, plane - first);
  float4* bottom = top + span;
  stage_patches<float, float>(x + static_cast<size_t>(b) * H * W, W, Wp, first, n, top, bottom);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int c0 = (threadIdx.x >> 5) * FWD_CHANNELS; c0 < C; c0 += FWD_WARPS * FWD_CHANNELS) {
    float w[FWD_CHANNELS][5], mu[FWD_CHANNELS], inv[FWD_CHANNELS], ga[FWD_CHANNELS], be[FWD_CHANNELS];
#pragma unroll
    for (int k = 0; k < FWD_CHANNELS; ++k) {
      const int c = min(c0 + k, C - 1);  // a channel past C repeats the last; it is not written
#pragma unroll
      for (int t = 0; t < 4; ++t) w[k][t] = __ldg(weight + 4 * c + t);
      w[k][4] = __ldg(bias + c);
      mu[k] = __ldg(mu_p + c);
      inv[k] = __ldg(inv_p + c);
      ga[k] = __ldg(gamma + c);
      be[k] = __ldg(beta + c);
    }
    const int kn = min(FWD_CHANNELS, C - c0);
    float* oc = out + (static_cast<size_t>(b) * C + c0) * plane + first;
    for (int p = lane; p < n; p += 32) {
      const float4 a = top[p], d = bottom[p];
#pragma unroll
      for (int k = 0; k < FWD_CHANNELS; ++k) {
        if (k >= kn) break;  // the same for the whole warp
        const float r0 = relu(conv_tap_fma(w[k], a.x, a.y, d.x, d.y));
        const float r1 = relu(conv_tap_fma(w[k], a.y, a.z, d.y, d.z));
        const float r2 = relu(conv_tap_fma(w[k], a.z, a.w, d.z, d.w));
        float v = normalise(r0, mu[k], inv[k], ga[k], be[k]);
        v = pool_max(v, normalise(r1, mu[k], inv[k], ga[k], be[k]));
        oc[static_cast<size_t>(k) * plane + p] = pool_max(v, normalise(r2, mu[k], inv[k], ga[k], be[k]));
      }
    }
  }
}

// Kernel B in the compute type CT, x in XT.
template <typename XT, typename CT>
int params_entry(const XT* x, const CT* g, const float* w5, const float* mu, const float* inv, const float* scale,
                 const float* shift, float* partial, float* out, int B, int H, int W, int C, int chunks,
                 int train_bn, void* stream) {
  if (chunks < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err =
      train_bn
          ? launch_params_partial<true>(x, g, w5, mu, inv, scale, shift, partial, B, H, W, C, chunks, s)
          : launch_params_partial<false>(x, g, w5, mu, inv, scale, shift, partial, B, H, W, C, chunks, s);
  if (err != 0) return err;
  const float n_total = 3.0f * static_cast<float>(B) * (H - 1) * ((W - 1) / 3);
  bwd_params_finish<<<C, PARAMS_THREADS, 0, s>>>(partial, scale, out, C, B * chunks, n_total, train_bn);
  return static_cast<int>(cudaGetLastError());
}

// Kernel C in the compute type CT, x and dx in XT.
template <typename XT, typename CT>
int input_entry(const XT* x, const CT* g, const float* w5, const float* mu, const float* inv, const float* scale,
                const float* shift, const float* h, XT* dx, int B, int H, int W, int C, int spans, int rows,
                int groups, int train_bn, void* stream) {
  if (spans < 1 || rows < 1 || groups < 1 || INPUT_WARPS % groups != 0 || (train_bn && h == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return train_bn ? launch_input<true>(x, g, w5, mu, inv, scale, shift, h, dx, B, H, W, C, spans, rows, groups, s)
                  : launch_input<false>(x, g, w5, mu, inv, scale, shift, h, dx, B, H, W, C, spans, rows, groups, s);
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
  return params_entry(x, g, w5, mu, inv, scale, shift, partial, out, B, H, W, C, chunks, train_bn, stream);
}

// Kernel C: dx (B, H, W), each clip's conv rows in `spans` spans of `rows`,
// the block's warps in `groups` channel groups (a divisor of 8); h (2, C)
// from kernel B in train mode, null in eval mode.
int conv1_bn_pool_bwd_input(const float* x, const float* g, const float* w5, const float* mu,
                            const float* inv, const float* scale, const float* shift,
                            const float* h, float* dx, int B, int H, int W, int C, int spans, int rows,
                            int groups, int train_bn, void* stream) {
  return input_entry(x, g, w5, mu, inv, scale, shift, h, dx, B, H, W, C, spans, rows, groups, train_bn, stream);
}

// Kernel G, train mode (f32), first pass: x (B, H, W), weight (C, 4) (the
// 2x2 taps row-major), bias (C); r, r2 (B, C, H-1, W-1) out.
int conv1_bn_pool_fwd_relu(const float* x, const float* weight, const float* bias, float* r, float* r2, int B,
                           int H, int W, int C, void* stream) {
  if (static_cast<long long>(B) * C * (H - 1) * (W - 1) == 0) return 0;
  fwd_relu_square<<<B * C, FWD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(x, weight, bias, r, r2, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

// Kernel G's pool pass (f32), both modes: x (B, H, W), weight (C, 4), bias,
// gamma, beta, mu, inv (C); out (B, C, H-1, (W-1)/3); each clip's positions
// in `chunks` spans.
int conv1_bn_pool_fwd(const float* x, const float* weight, const float* bias, const float* gamma,
                      const float* beta, const float* mu, const float* inv, float* out, int B, int H, int W, int C,
                      int chunks, void* stream) {
  const int plane = (H - 1) * ((W - 1) / 3);
  if (static_cast<long long>(B) * plane == 0) return 0;
  if (chunks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(float4)) * 2 * ((plane + chunks - 1) / chunks);
  cudaError_t err = cudaFuncSetAttribute(fwd_pool, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fwd_pool<<<B * chunks, FWD_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(x, weight, bias, gamma, beta, mu,
                                                                                 inv, out, H, W, C, chunks);
  return static_cast<int>(cudaGetLastError());
}

// Kernel B in bf16: g bf16; x bf16 (x_bf16) or f32; the rest as above.
int conv1_bn_pool_bwd_params_bf16(const void* x, const void* g, const float* w5, const float* mu,
                                  const float* inv, const float* scale, const float* shift,
                                  float* partial, float* out, int B, int H, int W, int C, int chunks,
                                  int train_bn, int x_bf16, void* stream) {
  const bf16* gb = static_cast<const bf16*>(g);
  return x_bf16 ? params_entry(static_cast<const bf16*>(x), gb, w5, mu, inv, scale, shift, partial, out, B, H, W,
                               C, chunks, train_bn, stream)
                : params_entry(static_cast<const float*>(x), gb, w5, mu, inv, scale, shift, partial, out, B, H,
                               W, C, chunks, train_bn, stream);
}

// Kernel C in bf16: g bf16; x and dx bf16 (x_bf16) or f32.
int conv1_bn_pool_bwd_input_bf16(const void* x, const void* g, const float* w5, const float* mu,
                                 const float* inv, const float* scale, const float* shift,
                                 const float* h, void* dx, int B, int H, int W, int C, int spans, int rows,
                                 int groups, int train_bn, int x_bf16, void* stream) {
  const bf16* gb = static_cast<const bf16*>(g);
  return x_bf16 ? input_entry(static_cast<const bf16*>(x), gb, w5, mu, inv, scale, shift, h, static_cast<bf16*>(dx),
                              B, H, W, C, spans, rows, groups, train_bn, stream)
                : input_entry(static_cast<const float*>(x), gb, w5, mu, inv, scale, shift, h,
                              static_cast<float*>(dx), B, H, W, C, spans, rows, groups, train_bn, stream);
}

}  // extern "C"
