// Backward of maxpool_{2,2,pad}(BN(relu(conv2x2_{Cin->C}(x)))), blocks 2 and 3
// of SmallCNN and SmallLSTM, without the pre-pool activation or the phase
// patches.
//
// Replaces: audiobd_tpu/ops/fused_conv_block2.py, the two Pallas kernels of
// `conv2_bn_pool`'s custom VJP:
//   * _bwd2_kernel (pallas_call in _run_bwd2, line 247): the parameter
//     gradient -> conv2_bn_pool_bwd_params below (kernel D);
//   * _dp2_kernel (pallas_call in _run_dp2, line 265) and the un-patch VJP of
//     _bwd_common2: the input gradient -> conv2_bn_pool_bwd_input (kernel E),
//     which reads the routing that kernel D writes instead of recomputing.
//
// Layout (NCHW, as the port's model): x (B, Cin, H, W) f32, the pooled
// gradient g (B, C, ho, wo); w (4*Cin + 1, C) = the conv taps in row order
// k = (kh*2 + kw)*Cin + ci, then the bias; the forward's per-channel mu,
// inv = 1/sqrt(var + eps), scale = gamma*inv, shift = beta - mu*scale.
//
// Geometry (_pool_dims): the conv grid is (hp, wp) = (H-1, W-1); the pool
// window (io, jo) covers conv rows 2io - ph + a and columns 2jo - pw + b,
// a, b in {0, 1}, phase t = 2a + b. Every conv position lies in exactly one
// window of the covering grid (hc, wc) >= (ho, wo); windows past (ho, wo)
// exist only because floor mode drops the last row (block 3) and receive
// no pooled gradient, but their positions feed the batch statistics. Slots
// off the conv grid (pool padding) have r = 0 and z = -inf: they never win
// and add nothing.
//
// Math (as the Pallas kernels): for every window and channel the four
// phases are recomputed from x,
//   y_t = sum_k w[k]*p_t[k] + bias, r_t = relu(y_t), z_t = r_t*scale + shift,
// the pool winner is the FIRST phase with z_t == max(z) (relu zeros tie
// whole windows exactly, so the rule decides where the gradient goes), and
// dz_t = g at the winner, 0 elsewhere. With xhat = (r - mu)*inv, relu' = r > 0:
//   dwA = sum p*relu'*dz, dwB = sum p*relu', dwC = sum p*relu'*xhat,
//   S1 = sum dz, S2 = sum dz*xhat                                    (kernel D)
//   h1 = scale*S1/N, h2 = scale*S2/N, N = B*hp*wp,
//   dw = scale*dwA - h1*dwB - h2*dwC, dgamma = S2, dbeta = S1.
//   dy = relu'*(scale*dz - h1 - xhat*h2), dx = transposed 2x2 conv of dy (E).
// The routing D hands to E, per conv position and channel (B, C, hp, wp) f32:
//   0 where r = 0; +r where relu is active and the position did not win its
//   pool window; -r where it won.
// dy is 0 wherever r = 0, and otherwise needs only r, whether the position
// won (dz = g of its window there, 0 elsewhere) and the per-channel mu, inv,
// scale, h1, h2, so this one f32 per position is all E reads of the forward.
// y sums the taps k = 0, 1, ..., 4*Cin - 1 in that order, then adds the
// bias, each product and sum rounded on its own (__fmul_rn/__fadd_rn, no FMA
// contraction); z is __fmul_rn then __fadd_rn. The plain PyTorch version in
// ops/conv2_bn_pool.py forms y and z in the same order, so both route every
// tie the same way. r and z are rounded to the forward's compute dtype
// before the compare; in f32 that is the identity (round_to_compute). E reads
// D's winners, so the two kernels route every tie alike by construction.
//
// What bounds it on the H100: operations. At block 2 (B 256, Cin 64, H 100,
// W 13, C 64) x is 85 MB and g 23 MB, but the recompute alone is 304,128
// conv positions x 64 channels x ~514 flops (10 GFLOP), and D's three
// 257-row products and E's transposed product add up to 3 x 10 and 10 GFLOP
// more where relu is active: f32 work with no tensor cores (TF32 is off in
// the port), at 67 TFLOP/s a few tenths of a millisecond at the least.
// Bytes are a tenth of that. The design keeps every operand of those
// products in shared memory and never writes the (4*257, M) patch array of
// the TPU version (368 MB a step at block 2). The recompute, a serial chain
// of 4*Cin rounded products and sums per position and channel, is the
// costliest part, so it is done once a step, by D; E gathers from D's
// routing (78 MB at block 2, written once by D and read once by E).
//
// Design:
//  * A tile is TW = 16 consecutive windows of the covering grid (64 conv
//    positions). A block loads the tile's patch column for every position,
//    P (4*Cin, 64), from x by index into shared memory (zero on padding),
//    and the taps of its CB = 16 channels (channel groups on blockIdx.y).
//    Thread (window, channel) recomputes the window's four phases, routes
//    the gradient and forms its coefficients.
//  * Kernel D: each block walks a strided set of tiles. Per tile it writes
//    the coefficients relu'*dz, relu', relu'*xhat (64 positions x 48
//    columns) to shared memory and adds the product P x coefficients into
//    256 x 48 accumulators spread over its 256 threads (8 rows x 6 columns
//    each, rows strided by 32 over a padded row pitch: no bank conflicts).
//    The bias row (p = 1) and S1, S2 are kept per thread and summed over the
//    tile's windows at the end. The TPU kernel carried one accumulator from
//    grid step to grid step; Hopper blocks run in no order, so each block
//    writes partial sums and a finishing pass adds the blocks in a fixed
//    order and forms dw, dgamma, dbeta, h1, h2: deterministic, no atomics.
//    Each tile also stores its routing: thread (window, channel) puts the
//    four encoded r in a shared (channel, position) tile, and the block
//    writes it out position-major, so neighbouring threads write neighbouring
//    addresses of one channel's plane.
//  * Kernel E forms each dx element from the <= 4 conv outputs x C channels
//    that read it, with no recompute: a block owns GR = 8 rows of x of one
//    batch item and holds the taps of all channels and the GR + 1 rows of dy
//    it needs in shared memory (zero-padded so the strip loop has no bounds
//    checks). It forms those dy rows as it loads them, from D's routing, the
//    window's pooled gradient (read only where the position won) and the
//    per-channel mu, inv, scale, h1, h2. Each thread then sums one (row,
//    input channel) strip of 16 columns from a register copy of the dy row
//    segment. No atomics.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 256;
constexpr int TW = 16;                        // windows per tile
constexpr int TP = 4 * TW;                    // conv positions per tile
constexpr int RSTRIDE = TP + 1;               // padded row pitch of the routing tile
constexpr int CB = 16;                        // channels per block
constexpr int KMAX = 256;                     // 4*Cin rows of the patch tile (Cin <= 64)
constexpr int PSTRIDE = TP + 1;               // padded row pitch of the patch tile
constexpr int NCOL = 3 * CB;                  // coefficient columns: relu'*dz, relu', relu'*xhat
constexpr int RPT = KMAX / 32;                // product rows per thread
constexpr int CPT = NCOL / (THREADS / 32);    // product columns per thread
constexpr int GR = 8;                         // x rows per gather block
constexpr int GJ = 16;                        // x columns per gather strip
static_assert(TW * CB == THREADS, "one thread per (window, channel) of a tile");
static_assert(CPT * (THREADS / 32) == NCOL, "columns split evenly over the warps");
static_assert(THREADS % TP == 0, "the patch load gives each position THREADS / TP threads");

// The forward's compute dtype is f32 in this build: rounding r and z to it
// is the identity. A bf16 build rounds here, as _phase_rz2 does.
__device__ __forceinline__ float round_to_compute(float v) { return v; }

struct Geometry {
  int B, Cin, H, W, C, ph, pw;
  int hp, wp, ho, wo, hc, wc;
  long long M;  // windows of the covering grid
};

Geometry make_geometry(int B, int Cin, int H, int W, int C, int ph, int pw) {
  Geometry G;
  G.B = B; G.Cin = Cin; G.H = H; G.W = W; G.C = C; G.ph = ph; G.pw = pw;
  G.hp = H - 1;
  G.wp = W - 1;
  G.ho = (G.hp + 2 * ph - 2) / 2 + 1;
  G.wo = (G.wp + 2 * pw - 2) / 2 + 1;
  const int hcov = (G.hp + ph + 1) / 2, wcov = (G.wp + pw + 1) / 2;
  G.hc = G.ho > hcov ? G.ho : hcov;
  G.wc = G.wo > wcov ? G.wo : wcov;
  G.M = (long long)B * G.hc * G.wc;
  return G;
}

struct Window {
  int b, io, jo;
  bool real;  // inside the covering grid (the last tile may run past it)
};

__device__ __forceinline__ Window decode(const Geometry& G, long long m) {
  Window win;
  win.real = m < G.M;
  if (!win.real) m = 0;
  win.jo = static_cast<int>(m % G.wc);
  const long long q = m / G.wc;
  win.io = static_cast<int>(q % G.hc);
  win.b = static_cast<int>(q / G.hc);
  return win;
}

// Shared patch tile: P[k*PSTRIDE + p] = x[b, ci, i + kh, j + kw] for tap
// k = (kh*2 + kw)*Cin + ci and position p = 4*(window - m0) + t, 0 on
// padding; base[p] = offset of x[b, 0, i, j] and rbase[p] = offset of
// route[b, 0, i, j], both -1 off the conv grid.
__device__ void load_tile(const float* __restrict__ x, const Geometry& G, long long m0,
                          float* __restrict__ P, long long* __restrict__ base, long long* __restrict__ rbase) {
  for (int p = threadIdx.x; p < TP; p += THREADS) {
    const Window win = decode(G, m0 + p / 4);
    const int t = p % 4;
    const int i = 2 * win.io - G.ph + (t >> 1), j = 2 * win.jo - G.pw + (t & 1);
    const bool ok = win.real && i >= 0 && i < G.hp && j >= 0 && j < G.wp;
    base[p] = ok ? ((long long)win.b * G.Cin * G.H + i) * G.W + j : -1;
    rbase[p] = ok ? ((long long)win.b * G.C * G.hp + i) * G.wp + j : -1;
  }
  __syncthreads();
  // Thread (p, k0) copies rows k0, k0 + 4, ... of every tap for position p:
  // neighbouring threads read neighbouring positions, and no division.
  const long long plane = (long long)G.H * G.W;
  const int p = threadIdx.x % TP;
  const long long o = base[p];
  for (int tap = 0; tap < 4; ++tap) {
    float* dst = P + tap * G.Cin * PSTRIDE + p;
    if (o < 0) {
      for (int ci = threadIdx.x / TP; ci < G.Cin; ci += THREADS / TP) dst[ci * PSTRIDE] = 0.0f;
    } else {
      const float* src = x + o + (tap >> 1) * G.W + (tap & 1);
      for (int ci = threadIdx.x / TP; ci < G.Cin; ci += THREADS / TP) dst[ci * PSTRIDE] = __ldg(src + ci * plane);
    }
  }
}

// The block's taps: Wt[k*CB + cl] = w[k, c0 + cl] (k <= 4*Cin, the last row
// the bias), 0 past the last channel.
__device__ void load_taps(const float* __restrict__ w, const Geometry& G, int c0, float* __restrict__ Wt) {
  const int rows = 4 * G.Cin + 1;
  for (int e = threadIdx.x; e < rows * CB; e += THREADS) {
    const int k = e / CB, c = c0 + e % CB;
    Wt[e] = c < G.C ? w[(long long)k * G.C + c] : 0.0f;
  }
}

// Thread (window w_, channel cl): the four phases' r and z, and the winner.
__device__ __forceinline__ int recompute(const float* __restrict__ P, const float* __restrict__ Wt,
                                         const long long* __restrict__ base, int k4, int w_, int cl,
                                         float scale, float shift, float r[4]) {
  const float* col = P + 4 * w_;
  float y[4];
  float wk = Wt[cl];
#pragma unroll
  for (int t = 0; t < 4; ++t) y[t] = __fmul_rn(wk, col[t]);
#pragma unroll 8
  for (int k = 1; k < k4; ++k) {
    wk = Wt[k * CB + cl];
    const float* row = col + k * PSTRIDE;
#pragma unroll
    for (int t = 0; t < 4; ++t) y[t] = __fadd_rn(y[t], __fmul_rn(wk, row[t]));
  }
  const float bias = Wt[k4 * CB + cl];
  float z[4];
  float zmax = -CUDART_INF_F;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const bool ok = base[4 * w_ + t] >= 0;
    r[t] = ok ? round_to_compute(fmaxf(__fadd_rn(y[t], bias), 0.0f)) : 0.0f;
    z[t] = ok ? round_to_compute(__fadd_rn(__fmul_rn(r[t], scale), shift)) : -CUDART_INF_F;
    zmax = fmaxf(zmax, z[t]);
  }
  return z[0] == zmax ? 0 : (z[1] == zmax ? 1 : (z[2] == zmax ? 2 : 3));
}

// The pooled gradient of the window for channel c; 0 for windows with no
// output (past (ho, wo)) and past the covering grid or the channels.
__device__ __forceinline__ float pooled_grad(const float* __restrict__ g, const Geometry& G,
                                             const Window& win, int c) {
  if (!win.real || c >= G.C || win.io >= G.ho || win.jo >= G.wo) return 0.0f;
  return __ldg(g + (((long long)win.b * G.C + c) * G.ho + win.io) * G.wo + win.jo);
}

constexpr size_t kTileFloats = (size_t)KMAX * PSTRIDE + (size_t)(KMAX + 1) * CB;

constexpr size_t kParamsFloats = kTileFloats + (size_t)TP * NCOL + (size_t)CB * RSTRIDE;

// partial (splits, 3*(4*Cin + 1) + 2, C): rows X*(4*Cin + 1) + k for
// X = dwA, dwB, dwC (k = 4*Cin the bias), then S1, S2. route (B, C, hp, wp):
// the encoded r for kernel E.
__global__ void __launch_bounds__(THREADS, 2)
conv2_params_partial(const float* __restrict__ x, const float* __restrict__ g,
                   const float* __restrict__ w, const float* __restrict__ mu_p,
                   const float* __restrict__ inv_p, const float* __restrict__ scale_p,
                   const float* __restrict__ shift_p, float* __restrict__ partial,
                   float* __restrict__ route, Geometry G) {
  extern __shared__ __align__(16) float smem[];
  float* P = smem;                            // KMAX x PSTRIDE
  float* Wt = P + KMAX * PSTRIDE;             // (KMAX + 1) x CB
  float* A = smem + kTileFloats;              // TP x NCOL coefficients
  float* Rs = A + TP * NCOL;                  // CB x RSTRIDE encoded r
  long long* base = reinterpret_cast<long long*>(smem + kParamsFloats);
  long long* rbase = base + TP;

  const int tid = threadIdx.x;
  const int k4 = 4 * G.Cin;
  const int c0 = blockIdx.y * CB;
  for (int e = tid; e < (KMAX - k4) * PSTRIDE; e += THREADS) P[k4 * PSTRIDE + e] = 0.0f;
  load_taps(w, G, c0, Wt);

  const int w_ = tid / CB, cl = tid % CB, c = c0 + cl;
  const bool cok = c < G.C;
  const float mu = cok ? mu_p[c] : 0.0f, inv = cok ? inv_p[c] : 0.0f;
  const float scale = cok ? scale_p[c] : 0.0f, shift = cok ? shift_p[c] : 0.0f;
  float s1 = 0.0f, s2 = 0.0f, bias_a = 0.0f, bias_b = 0.0f, bias_c = 0.0f;

  const int lane = tid & 31, cg = tid >> 5;
  float acc[RPT][CPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[q][j] = 0.0f;

  const long long n_tiles = (G.M + TW - 1) / TW;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    __syncthreads();  // the previous tile's product is done with P and A
    load_tile(x, G, tile * TW, P, base, rbase);
    __syncthreads();

    const Window win = decode(G, tile * TW + w_);
    float r[4];
    const int winner = recompute(P, Wt, base, k4, w_, cl, scale, shift, r);
    const float gv = pooled_grad(g, G, win, c);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float dz = t == winner ? gv : 0.0f;
      const float xhat = (r[t] - mu) * inv;
      const bool rp = r[t] > 0.0f;
      const float t1 = rp ? dz : 0.0f;
      Rs[cl * RSTRIDE + 4 * w_ + t] = rp ? (t == winner ? -r[t] : r[t]) : 0.0f;
      float* a = A + (4 * w_ + t) * NCOL + cl;
      a[0] = t1;
      a[CB] = rp ? 1.0f : 0.0f;
      a[2 * CB] = rp ? xhat : 0.0f;
      s1 += dz;
      s2 = fmaf(dz, xhat, s2);
      bias_a += t1;
      bias_b += rp ? 1.0f : 0.0f;
      bias_c += rp ? xhat : 0.0f;
    }
    __syncthreads();

    for (int e = tid; e < CB * TP; e += THREADS) {
      const int el = e / TP, p = e % TP;
      const long long o = rbase[p];
      if (o >= 0 && c0 + el < G.C) route[o + (long long)(c0 + el) * G.hp * G.wp] = Rs[el * RSTRIDE + p];
    }

    for (int p = 0; p < TP; ++p) {
      float av[CPT], pv[RPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) av[j] = A[p * NCOL + cg * CPT + j];
#pragma unroll
      for (int q = 0; q < RPT; ++q) pv[q] = P[(lane + 32 * q) * PSTRIDE + p];
#pragma unroll
      for (int q = 0; q < RPT; ++q)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[q][j] = fmaf(pv[q], av[j], acc[q][j]);
    }
  }

  const int rows = 3 * (k4 + 1) + 2;
  float* out = partial + (long long)blockIdx.x * rows * G.C;
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int k = lane + 32 * q;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = cg * CPT + j, cc = c0 + col % CB;
      if (k < k4 && cc < G.C) out[((col / CB) * (k4 + 1) + k) * G.C + cc] = acc[q][j];
    }
  }

  // Bias rows and S1, S2: sum over the tile's windows in a fixed order.
  __syncthreads();
  float* red = A;  // 5 x THREADS
  red[tid] = bias_a;
  red[THREADS + tid] = bias_b;
  red[2 * THREADS + tid] = bias_c;
  red[3 * THREADS + tid] = s1;
  red[4 * THREADS + tid] = s2;
  __syncthreads();
  if (tid < 5 * CB) {
    const int v = tid / CB, l = tid % CB, cc = c0 + l;
    float sum = 0.0f;
    for (int q = 0; q < TW; ++q) sum += red[v * THREADS + q * CB + l];
    const int row = v < 3 ? v * (k4 + 1) + k4 : 3 * (k4 + 1) + (v - 3);
    if (cc < G.C) out[row * G.C + cc] = sum;
  }
}

// out (4*Cin + 5, C): rows 0..4*Cin-1 dw taps, then dbias, dgamma, dbeta, h1, h2.
__global__ void conv2_params_finish(const float* __restrict__ partial, const float* __restrict__ scale_p,
                                  float* __restrict__ out, int k4, int C, int splits, float n_total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)(k4 + 1) * C) return;
  const int k = static_cast<int>(idx / C), c = static_cast<int>(idx % C);
  const int rows = 3 * (k4 + 1) + 2;
  float a = 0.0f, b = 0.0f, cc = 0.0f, s1 = 0.0f, s2 = 0.0f;
  for (int s = 0; s < splits; ++s) {
    const float* part = partial + (long long)s * rows * C + c;
    a += part[k * C];
    b += part[(k4 + 1 + k) * C];
    cc += part[(2 * (k4 + 1) + k) * C];
    s1 += part[3 * (k4 + 1) * C];
    s2 += part[(3 * (k4 + 1) + 1) * C];
  }
  const float scale = scale_p[c];
  const float h1 = scale * s1 / n_total, h2 = scale * s2 / n_total;
  out[k * C + c] = a * scale - b * h1 - cc * h2;
  if (k == 0) {
    out[(k4 + 1) * C + c] = s2;
    out[(k4 + 2) * C + c] = s1;
    out[(k4 + 3) * C + c] = h1;
    out[(k4 + 4) * C + c] = h2;
  }
}

// Row pitch of the gather's dy tile: columns -1 .. W - 1 rounded up to whole
// GJ-column strips, so no load in the strip loop needs a bounds check.
__host__ __device__ __forceinline__ int gather_row_pitch(int W) { return (W + GJ - 1) / GJ * GJ + 1; }

// dx[b, ci, i, j] = sum_{c, kh, kw} w[(kh*2 + kw)*Cin + ci, c] * dy[b, c, i - kh, j - kw],
// dy formed from kernel D's routing. h (2, C) = h1, h2.
__global__ void __launch_bounds__(THREADS)
conv2_input_gather(const float* __restrict__ route, const float* __restrict__ g, const float* __restrict__ w,
                 const float* __restrict__ mu_p, const float* __restrict__ inv_p,
                 const float* __restrict__ scale_p, const float* __restrict__ h_p, float* __restrict__ dx,
                 Geometry G) {
  extern __shared__ __align__(16) float smem[];
  const int cin = G.Cin, C = G.C, wp = G.wp;
  const int wpad = gather_row_pitch(G.W);
  float* Ws = smem;                  // (C, 4, Cin): Ws[(c*4 + tap)*Cin + ci]
  float* D = smem + C * 4 * cin;     // (GR + 1, C, wpad): dy rows i0 - 1 .. i0 + GR - 1,
                                     // columns -1 .. wpad - 2, zero off the conv grid
  float* V = D + (GR + 1) * C * wpad;  // (5, C): mu, inv, scale, h1, h2
  const int b = blockIdx.y, i0 = blockIdx.x * GR;
  for (int e = threadIdx.x; e < C * 4 * cin; e += THREADS) {
    const int c = e / (4 * cin), k = e - c * 4 * cin;
    Ws[e] = w[(long long)k * C + c];
  }
  for (int c = threadIdx.x; c < C; c += THREADS) {
    V[c] = mu_p[c];
    V[C + c] = inv_p[c];
    V[2 * C + c] = scale_p[c];
    V[3 * C + c] = h_p[c];
    V[4 * C + c] = h_p[C + c];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < (GR + 1) * C * wpad; e += THREADS) {
    const int j = e % wpad - 1, q = e / wpad, c = q % C, i = i0 - 1 + q / C;
    float v = 0.0f;
    if (i >= 0 && i < G.hp && j >= 0 && j < wp) {
      const long long plane = (long long)b * C + c;
      const float enc = __ldg(route + (plane * G.hp + i) * wp + j);
      if (enc != 0.0f) {
        float dz = 0.0f;
        const int io = (i + G.ph) >> 1, jo = (j + G.pw) >> 1;
        if (enc < 0.0f && io < G.ho && jo < G.wo) dz = __ldg(g + (plane * G.ho + io) * G.wo + jo);
        const float xhat = (fabsf(enc) - V[c]) * V[C + c];
        v = V[2 * C + c] * dz - V[3 * C + c] - xhat * V[4 * C + c];
      }
    }
    D[e] = v;
  }
  __syncthreads();

  for (int pair = threadIdx.x; pair < GR * cin; pair += THREADS) {
    const int r = pair / cin, ci = pair - r * cin, i = i0 + r;
    if (i >= G.H) continue;
    for (int j0 = 0; j0 < G.W; j0 += GJ) {
      float acc[GJ];
#pragma unroll
      for (int jj = 0; jj < GJ; ++jj) acc[jj] = 0.0f;
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int kh = 0; kh < 2; ++kh) {
          // dr[u] = dy[b, c, i - kh, j0 - 1 + u]: column j reads it at u = j - j0 + 1 - kw.
          const float* drow = D + ((r + 1 - kh) * C + c) * wpad + j0;
          float dr[GJ + 1];
#pragma unroll
          for (int u = 0; u <= GJ; ++u) dr[u] = drow[u];
          const float w0 = Ws[(c * 4 + kh * 2) * cin + ci], w1 = Ws[(c * 4 + kh * 2 + 1) * cin + ci];
#pragma unroll
          for (int jj = 0; jj < GJ; ++jj) {
            acc[jj] = fmaf(w0, dr[jj + 1], acc[jj]);
            acc[jj] = fmaf(w1, dr[jj], acc[jj]);
          }
        }
      }
      float* out = dx + (((long long)b * cin + ci) * G.H + i) * G.W;
#pragma unroll
      for (int jj = 0; jj < GJ; ++jj)
        if (j0 + jj < G.W) out[j0 + jj] = acc[jj];
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace

extern "C" {

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

int use_device(int device) { return static_cast<int>(cudaSetDevice(device)); }

// Kernel D: partial (splits, 3*(4*Cin + 1) + 2, C) scratch, out (4*Cin + 5, C),
// route (B, C, H-1, W-1) the routing for kernel E.
int conv2_bn_pool_bwd_params(const float* x, const float* g, const float* w, const float* mu,
                             const float* inv, const float* scale, const float* shift,
                             float* partial, float* out, float* route, int B, int Cin, int H, int W, int C,
                             int ph, int pw, int splits, void* stream) {
  if (Cin < 1 || 4 * Cin > KMAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry G = make_geometry(B, Cin, H, W, C, ph, pw);
  const size_t smem = kParamsFloats * sizeof(float) + 2 * TP * sizeof(long long);
  int err = set_smem(conv2_params_partial, smem);
  if (err != 0) return err;
  const dim3 grid(splits, (C + CB - 1) / CB);
  conv2_params_partial<<<grid, THREADS, smem, s>>>(x, g, w, mu, inv, scale, shift, partial, route, G);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int k4 = 4 * Cin;
  const long long n = (long long)(k4 + 1) * C;
  const float n_total = static_cast<float>((long long)B * G.hp * G.wp);
  conv2_params_finish<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(partial, scale, out, k4, C,
                                                                           splits, n_total);
  return static_cast<int>(cudaGetLastError());
}

// Kernel E: route (B, C, H-1, W-1) from kernel D; h (2, C) = h1, h2 from kernel D;
// dx (B, Cin, H, W).
int conv2_bn_pool_bwd_input(const float* route, const float* g, const float* w, const float* mu,
                            const float* inv, const float* scale, const float* h, float* dx, int B, int Cin,
                            int H, int W, int C, int ph, int pw, void* stream) {
  if (Cin < 1 || 4 * Cin > KMAX) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry G = make_geometry(B, Cin, H, W, C, ph, pw);
  const size_t smem = ((size_t)C * 4 * Cin + (size_t)(GR + 1) * C * gather_row_pitch(W) + 5 * (size_t)C) * sizeof(float);
  const int err = set_smem(conv2_input_gather, smem);
  if (err != 0) return err;
  const dim3 grid((H + GR - 1) / GR, B);
  conv2_input_gather<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(route, g, w, mu, inv, scale, h,
                                                                                 dx, G);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
