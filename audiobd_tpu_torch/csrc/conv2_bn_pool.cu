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
// before the compare (round_to_compute; the identity in f32). E reads D's
// winners, so the two kernels route every tie alike by construction.
//
// Compute dtype: the kernels are templates over T, the type of x, g and dx
// (the compute type); the f32 instantiation is the f32 kernel. In bf16
// (_phase_rz2 and the bf16 operands of _run_bwd2 and _run_dp2): x and g are
// read as bf16 (x lands in the f32 patch tiles by ordinary loads, as
// cp.async copies bytes and cannot convert); the taps w are rounded to bf16
// where they are loaded; r and z are rounded to bf16 before the compare; the
// routing stays f32 (r is bf16-exact in it). D's product multiplies
// bf16-exact patch values, exact in TF32, so the low half of the patch's
// TF32 split is zero and a tile takes two mma.sync (hi*hi and hi*lo of the
// coefficients), not three. E forms each tap's dp (the sum over channels,
// f32) apart, rounds it to bf16 as the Pallas dp is bf16, adds a position's
// four taps in f32 in tap order and rounds once to bf16; the reference's
// un-patch VJP adds the bf16 taps in bf16, so its dx may differ from this
// one by 1 bf16 ulp. D's output stays f32.
//
// What bounds it on the H100: operations. At block 2 (B 256, Cin 64, H 100,
// W 13, C 64) x is 85 MB and g 23 MB, but the recompute alone is 304,128
// conv positions x 64 channels x ~514 flops (10 GFLOP), and D's three
// 257-row products and E's transposed product add up to 3 x 10 and 10 GFLOP
// more where relu is active. The design keeps every operand of those
// products in shared memory and never writes the (4*257, M) patch array of
// the TPU version (368 MB a step at block 2). The recompute, a serial chain
// of 4*Cin rounded products and sums per position and channel that no FMA
// or tensor core may shorten, is done once a step, by D's routing pass; D's
// product pass and E read its routing (78 MB at block 2, written once).
//
// Design:
//  * Kernel D runs in two passes over the windows, then a finish, because
//    the recompute and the product want different shapes of work per
//    thread: the recompute wants many channels a thread to amortise its
//    shared-memory loads; the product's 256 x 48 register accumulators allow
//    only 16 channels a block at two blocks per SM.
//  * Routing pass (conv2_route): a block holds the taps of CR = 64 channels
//    (32 when C <= 32) and walks tiles of 32 windows (64), streaming each
//    tile's patches one tap (kh, kw) at a time: Cin rows of 128 (256)
//    positions, copied from x by index with cp.async, zero on padding, at a
//    row pitch that makes a window's four phases one 16-byte word. Thread
//    (window pair, channel quad) forms y for 2 windows x 4 channels: per tap
//    two 16-byte loads of phases and one of the quad's taps (stored
//    quad-interleaved at a pitch of 1028 floats, so a quarter-warp's eight
//    quads fall in distinct banks) for 64 rounded products and sums. It
//    stages the encoded routing in the patch chunk and writes it
//    position-major, so neighbouring threads write neighbouring addresses.
//  * Product pass (conv2_params_partial): blocks of CB = 16 channels, tiles
//    of 16 windows (64 positions) with all 4*Cin patch rows. Thread (window,
//    channel) turns the window's four routing values into the coefficients
//    relu'*dz, relu', relu'*xhat (r = |enc|; dz = g where enc < 0) and keeps
//    the bias rows and S1, S2 (a window whose winner has r = 0 has no
//    enc < 0, and its dz meets xhat = -mu*inv). It stores them column-major;
//    then each warp adds 32 rows x 48 columns of the product on the tensor
//    cores in 3xTF32 (mma.sync m16n8k8: a*b ~ a_lo*b_hi + a_hi*b_lo +
//    a_hi*b_hi, the middle term skipped on the 0/1 relu' columns), each
//    product of TF32 values exact and summed in the tensor cores' f32
//    accumulators. On the H100 at block 2 that leaves dw within ~4e-5 of
//    max|dw| of the plain f32 version (f32 FMAs: ~2e-6): the accumulation
//    over ~5,000 positions a block, not the split, sets it.
//  * The TPU kernel carried one accumulator from grid step to grid step;
//    Hopper blocks run in no order, so each product block writes partial
//    sums and a finishing pass adds the blocks in a fixed order and forms dw,
//    dgamma, dbeta, h1, h2: deterministic, no atomics.
//  * Kernel E forms each dx element from the <= 4 conv outputs x C channels
//    that read it, with no recompute: a block owns GR = 8 rows of x of one
//    batch item and holds the taps of all channels and the GR + 1 rows of dy
//    it needs in shared memory (zero-padded so the strip loop has no bounds
//    checks). It forms those dy rows as it loads them, from D's routing, the
//    window's pooled gradient (read only where the position won) and the
//    per-channel mu, inv, scale, h1, h2. Each thread then sums one (row,
//    input channel) strip of 16 columns from a register copy of the dy row
//    segment. No atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int TW = 16;                        // windows per product tile
constexpr int TP = 4 * TW;                    // conv positions per product tile
constexpr int KMAX = 256;                     // 4*Cin rows of the patch tile (Cin <= 64)
constexpr int PSTRIDE = TP + 4;               // row pitch of the product's patch and coefficient tiles
constexpr int P4 = PSTRIDE / 4;               // the same pitch in float4
// The routing pass takes CR = 64 channels a block in tiles of 32 windows,
// or (C <= 32) 32 channels in tiles of 64 windows: 256 threads either way.
template <int CR>
struct RouteShape {
  static constexpr int RW = 2048 / CR;          // windows per routing tile
  static constexpr int RP = 4 * RW;             // conv positions per routing tile
  static constexpr int RPITCH = RP + 4;         // row pitch of the tile's patch chunk
  static constexpr int RSTAGE = RP + 1;         // row pitch of the encoded routing, staged in the chunk
  static constexpr int PG = THREADS / CR;       // warps per group of 8 channel quads
  static constexpr size_t FLOATS = (size_t)(KMAX / 4) * RPITCH + (size_t)(CR / 4) * (4 * KMAX + 4) + CR;
  static_assert((RW / 2) * (CR / 4) == THREADS && THREADS % RP == 0,
                "one thread per (window pair, channel quad)");
  static_assert(CR * RSTAGE <= (KMAX / 4) * RPITCH, "the routing is staged in the patch chunk");
};
constexpr int WPITCH = 4 * KMAX + 4;          // floats per channel quad of the routing block's taps
constexpr int CB = 16;                        // channels per product block
constexpr int NCOL = 3 * CB;                  // coefficient columns: relu'*dz, relu', relu'*xhat
constexpr int MT = 2;                         // 16-row mma tiles per warp: 32 rows of the product
constexpr int NT = NCOL / 8;                  // 8-column mma tiles: every column
constexpr int GR = 8;                         // x rows per gather block
constexpr int GJ = 16;                        // x columns per gather strip
static_assert(TW * CB == THREADS, "one product thread per (window, channel) of a tile for the coefficients");
static_assert(16 * MT * (THREADS / 32) == KMAX && NT * 8 == NCOL, "each warp 32 rows, every column");
static_assert(THREADS == 256 && THREADS % TP == 0, "the patch load gives each position THREADS / NP threads");
static_assert(PSTRIDE % 4 == 0 && WPITCH % 32 == 4, "16-byte rows; channel quads 4 banks apart");

// v rounded to the compute type T and held in f32: the identity for f32,
// round to nearest even for bf16, as _phase_rz2's astype does.
template <typename T>
__device__ __forceinline__ float round_to_compute(float v) {
  if constexpr (std::is_same_v<T, bf16>) {
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

// 32-bit division: the entry point refuses M >= 2^31.
__device__ __forceinline__ Window decode(const Geometry& G, long long m) {
  Window win;
  win.real = m < G.M;
  const unsigned mm = win.real ? static_cast<unsigned>(m) : 0u;
  const unsigned q = mm / static_cast<unsigned>(G.wc);
  win.jo = static_cast<int>(mm - q * static_cast<unsigned>(G.wc));
  win.b = static_cast<int>(q / static_cast<unsigned>(G.hc));
  win.io = static_cast<int>(q - static_cast<unsigned>(win.b) * static_cast<unsigned>(G.hc));
  return win;
}

// base[p] = offset of x[b, 0, i, j] and rbase[p] = offset of route[b, 0, i,
// j] for position p = 4*(window - m0) + t of the tile, both -1 off the conv
// grid, for the NP positions of a tile.
template <int NP>
__device__ void tile_bases(const Geometry& G, long long m0, long long* __restrict__ base,
                           long long* __restrict__ rbase) {
  for (int p = threadIdx.x; p < NP; p += THREADS) {
    const Window win = decode(G, m0 + p / 4);
    const int t = p % 4;
    const int i = 2 * win.io - G.ph + (t >> 1), j = 2 * win.jo - G.pw + (t & 1);
    const bool ok = win.real && i >= 0 && i < G.hp && j >= 0 && j < G.wp;
    base[p] = ok ? ((long long)win.b * G.Cin * G.H + i) * G.W + j : -1;
    rbase[p] = ok ? ((long long)win.b * G.C * G.hp + i) * G.wp + j : -1;
  }
}

// Asynchronous 4-byte copy from global to shared memory; zero-fills when
// !valid (src is then not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// f32 -> TF32 (10 mantissa bits), rounded to nearest with ties away from
// zero, as a b32 bit pattern.
__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + O(2^-22 |x|): hi = tf32(x), lo = tf32(x - hi).
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a (16 x 8, row-major fragment) * b (8 x 8, column-major fragment) on
// the tensor cores, TF32 inputs, f32 accumulation.
__device__ __forceinline__ void mma_tf32(float d[4], const unsigned a[4], const unsigned b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Shared patch tile: P[k*PITCH + p] = x[b, ci, i + kh, j + kw] for tap
// k = (kh*2 + kw)*Cin + ci and position p, 0 on padding (base[p] < 0); taps
// (kh*2 + kw) from tap0 to tap1 - 1 only, rows counted from tap0's first.
// Thread (p, k0) copies rows k0, k0 + 4, ... of every tap for position p:
// neighbouring threads read neighbouring positions, and no division. f32
// copies are asynchronous, all in flight at once; the caller waits
// (cp_async_wait_all, then a barrier) before reading P. bf16 values are
// loaded and widened to f32 (exact) by ordinary loads.
template <int NP, int PITCH, typename T>
__device__ void load_patches(const T* __restrict__ x, const Geometry& G, const long long* __restrict__ base,
                             float* __restrict__ P, int tap0 = 0, int tap1 = 4) {
  const long long plane = (long long)G.H * G.W;
  const int p = threadIdx.x % NP;
  const long long o = base[p];
  const bool ok = o >= 0;
  for (int tap = tap0; tap < tap1; ++tap) {
    float* dst = P + (tap - tap0) * G.Cin * PITCH + p;
    const T* src = ok ? x + o + (tap >> 1) * G.W + (tap & 1) : x;
    const long long step = ok ? plane : 0;
    for (int ci = threadIdx.x / NP; ci < G.Cin; ci += THREADS / NP) {
      if constexpr (std::is_same_v<T, float>) {
        cp_async4(dst + ci * PITCH, src + ci * step, ok);
      } else {
        dst[ci * PITCH] = ok ? to_f32(__ldg(src + ci * step)) : 0.0f;
      }
    }
  }
}

// The pooled gradient of the window for channel c; 0 for windows with no
// output (past (ho, wo)) and past the covering grid or the channels.
template <typename T>
__device__ __forceinline__ float pooled_grad(const T* __restrict__ g, const Geometry& G,
                                             const Window& win, int c) {
  if (!win.real || c >= G.C || win.io >= G.ho || win.jo >= G.wo) return 0.0f;
  return to_f32(__ldg(g + (((long long)win.b * G.C + c) * G.ho + win.io) * G.wo + win.jo));
}

// y[t] += w * p.t for the four phases, each product and sum rounded on its own.
__device__ __forceinline__ void tap_add(float y[4], float w, const float4& p) {
  y[0] = __fadd_rn(y[0], __fmul_rn(w, p.x));
  y[1] = __fadd_rn(y[1], __fmul_rn(w, p.y));
  y[2] = __fadd_rn(y[2], __fmul_rn(w, p.z));
  y[3] = __fadd_rn(y[3], __fmul_rn(w, p.w));
}

// The window's four phases for one channel from its tap sums y: r (0 off
// the conv grid), the winner (the first phase with the largest z), and the
// encoded routing into enc[t]: 0 where r = 0, -r at the winner, else +r.
// r and z are rounded to the compute type T.
template <typename T>
__device__ __forceinline__ void encode(const float y[4], float bias, float scale, float shift,
                                       const long long* __restrict__ base, float* __restrict__ enc) {
  float r[4], z[4];
  float zmax = -CUDART_INF_F;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const bool ok = base[t] >= 0;
    r[t] = ok ? round_to_compute<T>(fmaxf(__fadd_rn(y[t], bias), 0.0f)) : 0.0f;
    z[t] = ok ? round_to_compute<T>(__fadd_rn(__fmul_rn(r[t], scale), shift)) : -CUDART_INF_F;
    zmax = fmaxf(zmax, z[t]);
  }
  const int winner = z[0] == zmax ? 0 : (z[1] == zmax ? 1 : (z[2] == zmax ? 2 : 3));
#pragma unroll
  for (int t = 0; t < 4; ++t) enc[t] = r[t] > 0.0f ? (t == winner ? -r[t] : r[t]) : 0.0f;
}

constexpr size_t kParamsFloats = (size_t)KMAX * PSTRIDE + (size_t)NCOL * PSTRIDE;
static_assert(NCOL * PSTRIDE >= 5 * THREADS, "the final reduction reuses the coefficient tile");

// Kernel D, first pass: the routing (B, C, hp, wp) for kernel E and the
// product pass. A block holds all taps of its CR channels and walks tiles
// of RW windows, streaming each tile's patches one tap (kh, kw) at a time:
// Cin rows of 4*RW positions. Thread (window pair, channel quad) forms y for
// 2 windows x 4 channels, taps k = 0 .. 4*Cin - 1 in order: per tap two
// 16-byte loads of the windows' phases (one address per quarter-warp) and
// one of the quad's taps, for 64 rounded products and sums, so the pass is
// bound by f32 issue. The encoded routing is staged in the patch chunk and
// written position-major. The taps are rounded to the compute type T.
template <int CR, typename T>
__global__ void __launch_bounds__(THREADS, 2)
conv2_route(const T* __restrict__ x, const float* __restrict__ w, const float* __restrict__ scale_p,
            const float* __restrict__ shift_p, float* __restrict__ route, Geometry G) {
  using S = RouteShape<CR>;
  constexpr int RW = S::RW, RP = S::RP, RPITCH = S::RPITCH, RSTAGE = S::RSTAGE;
  extern __shared__ __align__(16) float smem[];
  float* Pc = smem;                               // Cin x RPITCH: one tap's patch rows
  float* Wq = Pc + (KMAX / 4) * RPITCH;           // (CR / 4) x WPITCH: Wq[cq*WPITCH + 4k + e] = w[k, c0 + 4cq + e]
  float* bias_s = Wq + (CR / 4) * WPITCH;         // CR
  long long* base = reinterpret_cast<long long*>(smem + S::FLOATS);
  long long* rbase = base + RP;

  const int tid = threadIdx.x;
  const int k4 = 4 * G.Cin;
  const int c0 = blockIdx.y * CR;
  for (int e = tid; e < k4 * CR; e += THREADS) {
    const int k = e / CR, cl = e % CR, c = c0 + cl;
    Wq[(cl >> 2) * WPITCH + 4 * k + (cl & 3)] = c < G.C ? round_to_compute<T>(w[(long long)k * G.C + c]) : 0.0f;
  }
  for (int cl = tid; cl < CR; cl += THREADS)
    bias_s[cl] = c0 + cl < G.C ? round_to_compute<T>(w[(long long)k4 * G.C + c0 + cl]) : 0.0f;

  // Warp q: window pairs 4*(q % PG) .. + 3 (lane / 8), quads 8*(q / PG) .. + 7 (lane % 8).
  const int lane = tid & 31, wq = tid >> 5;
  const int w0 = 2 * (4 * (wq % S::PG) + (lane >> 3)), cq = 8 * (wq / S::PG) + (lane & 7);
  float scale[4], shift[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int c = c0 + 4 * cq + e;
    scale[e] = c < G.C ? scale_p[c] : 0.0f;
    shift[e] = c < G.C ? shift_p[c] : 0.0f;
  }
  const float4* col = reinterpret_cast<const float4*>(Pc) + w0;
  const float4* wt = reinterpret_cast<const float4*>(Wq + cq * WPITCH);

  const long long n_tiles = (G.M + RW - 1) / RW;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    __syncthreads();  // the previous tile is done with the chunk and the bases
    tile_bases<RP>(G, tile * RW, base, rbase);
    float y[2][4][4];  // [window][channel][phase]
    for (int tap = 0; tap < 4; ++tap) {
      __syncthreads();  // the bases are visible; the previous chunk is consumed
      load_patches<RP, RPITCH>(x, G, base, Pc, tap, tap + 1);
      cp_async_wait_all();
      __syncthreads();
      const float4* wk_row = wt + tap * G.Cin;
      int ci = 0;
      if (tap == 0) {
        const float4 p0 = col[0], p1 = col[1], wk = wk_row[0];
        const float wv[4] = {wk.x, wk.y, wk.z, wk.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          y[0][e][0] = __fmul_rn(wv[e], p0.x); y[0][e][1] = __fmul_rn(wv[e], p0.y);
          y[0][e][2] = __fmul_rn(wv[e], p0.z); y[0][e][3] = __fmul_rn(wv[e], p0.w);
          y[1][e][0] = __fmul_rn(wv[e], p1.x); y[1][e][1] = __fmul_rn(wv[e], p1.y);
          y[1][e][2] = __fmul_rn(wv[e], p1.z); y[1][e][3] = __fmul_rn(wv[e], p1.w);
        }
        ci = 1;
      }
#pragma unroll 4
      for (; ci < G.Cin; ++ci) {
        const float4 p0 = col[ci * (RPITCH / 4)], p1 = col[ci * (RPITCH / 4) + 1], wk = wk_row[ci];
        tap_add(y[0][0], wk.x, p0); tap_add(y[1][0], wk.x, p1);
        tap_add(y[0][1], wk.y, p0); tap_add(y[1][1], wk.y, p1);
        tap_add(y[0][2], wk.z, p0); tap_add(y[1][2], wk.z, p1);
        tap_add(y[0][3], wk.w, p0); tap_add(y[1][3], wk.w, p1);
      }
    }
    __syncthreads();  // every thread is done with the last chunk: it takes the encoded routing
    float* Rs = Pc;   // CR x RSTAGE
#pragma unroll
    for (int v = 0; v < 2; ++v)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        encode<T>(y[v][e], bias_s[4 * cq + e], scale[e], shift[e], base + 4 * (w0 + v),
                  Rs + (4 * cq + e) * RSTAGE + 4 * (w0 + v));
    __syncthreads();

    for (int e = tid; e < CR * RP; e += THREADS) {
      const int el = e / RP, p = e % RP;
      const long long o = rbase[p];
      if (o >= 0 && c0 + el < G.C) route[o + (long long)(c0 + el) * G.hp * G.wp] = Rs[el * RSTAGE + p];
    }
  }
}

// Kernel D, second pass: partial (splits, 3*(4*Cin + 1) + 2, C) sums from x,
// g and the routing: rows X*(4*Cin + 1) + k for X = dwA, dwB, dwC (k = 4*Cin
// the bias), then S1, S2. Thread (window, channel) turns the window's four
// routing values into its coefficients, column-major, and keeps the bias
// rows and S1, S2; then warp q adds rows 32q .. 32q + 31 times all 48
// columns in 3xTF32 mma tiles of 16 x 8 x 8 (two a tile in bf16, whose
// patch values are exact in TF32).
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
conv2_params_partial(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ route,
                     const float* __restrict__ mu_p, const float* __restrict__ inv_p,
                     float* __restrict__ partial, Geometry G) {
  extern __shared__ __align__(16) float smem[];
  float* P = smem;                            // KMAX x PSTRIDE
  float* A = P + KMAX * PSTRIDE;              // NCOL x PSTRIDE coefficients, column-major
  long long* base = reinterpret_cast<long long*>(smem + kParamsFloats);
  long long* rbase = base + TP;

  const int tid = threadIdx.x;
  const int k4 = 4 * G.Cin;
  const int c0 = blockIdx.y * CB;
  for (int e = tid; e < (KMAX - k4) * PSTRIDE; e += THREADS) P[k4 * PSTRIDE + e] = 0.0f;

  const int w_ = tid / CB, cl = tid % CB, c = c0 + cl;
  const bool cok = c < G.C;
  const float mu = cok ? mu_p[c] : 0.0f, inv = cok ? inv_p[c] : 0.0f;
  const long long cplane = (long long)c * G.hp * G.wp;
  float s1 = 0.0f, s2 = 0.0f, bias_a = 0.0f, bias_b = 0.0f, bias_c = 0.0f;

  // mma fragments: lane = 4*gq + tq. Warp q owns rows 32q .. 32q + 31.
  const int lane = tid & 31, gq = lane >> 2, tq = lane & 3, row0 = 32 * (tid >> 5);
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const long long n_tiles = (G.M + TW - 1) / TW;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    __syncthreads();  // the previous tile's product is done with P, A and the bases
    tile_bases<TP>(G, tile * TW, base, rbase);
    __syncthreads();
    load_patches<TP, PSTRIDE>(x, G, base, P);  // in flight while the coefficients form

    // dz goes to the window's winner: the phase with enc < 0 if any (relu
    // active), else a phase with r = 0, where only S1, S2 see it.
    const Window win = decode(G, tile * TW + w_);
    const float gv = pooled_grad(g, G, win, c);
    float a[3][4];
    float r_win = 0.0f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const long long o = rbase[4 * w_ + t];
      const float enc = o >= 0 && cok ? __ldg(route + o + cplane) : 0.0f;
      const bool rp = enc != 0.0f;
      const float r = fabsf(enc);
      const float xhat = (r - mu) * inv;
      const float t1 = enc < 0.0f ? gv : 0.0f;
      if (enc < 0.0f) r_win = r;
      a[0][t] = t1;
      a[1][t] = rp ? 1.0f : 0.0f;
      a[2][t] = rp ? xhat : 0.0f;
      bias_a += t1;
      bias_b += rp ? 1.0f : 0.0f;
      bias_c += rp ? xhat : 0.0f;
    }
    s1 += gv;
    s2 = fmaf(gv, (r_win - mu) * inv, s2);
    float4* a4 = reinterpret_cast<float4*>(A) + cl * P4 + w_;
#pragma unroll
    for (int v = 0; v < 3; ++v) a4[v * CB * P4] = make_float4(a[v][0], a[v][1], a[v][2], a[v][3]);
    cp_async_wait_all();
    __syncthreads();

    // 3xTF32 (TF32 alone keeps ~3 digits and is never used on its own). A
    // bf16 patch value is its own TF32 hi part (al = 0): two products.
    constexpr bool kExactP = std::is_same_v<T, bf16>;
    for (int kk = 0; kk < TP; kk += 8) {
      unsigned ah[MT][4], al[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* pr = P + (row0 + 16 * i + gq) * PSTRIDE + kk + tq;
        const float pv[4] = {pr[0], pr[8 * PSTRIDE], pr[4], pr[8 * PSTRIDE + 4]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (kExactP) {
            ah[i][e] = __float_as_uint(pv[e]);
          } else {
            split_tf32(pv[e], ah[i][e], al[i][e]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* ar = A + (8 * j + gq) * PSTRIDE + kk + tq;
        unsigned bh[2], bl[2];
        split_tf32(ar[0], bh[0], bl[0]);
        split_tf32(ar[4], bh[1], bl[1]);
        const bool exact = 8 * j >= CB && 8 * j < 2 * CB;  // relu' columns are 0 or 1: no low part
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if constexpr (!kExactP) mma_tf32(acc[i][j], al[i], bh);
          if (!exact) mma_tf32(acc[i][j], ah[i], bl);
          mma_tf32(acc[i][j], ah[i], bh);
        }
      }
    }
  }

  const int rows = 3 * (k4 + 1) + 2;
  float* out = partial + (long long)blockIdx.x * rows * G.C;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = row0 + 16 * i + gq + 8 * (e >> 1), col = 8 * j + 2 * tq + (e & 1), cc = c0 + col % CB;
        if (k < k4 && cc < G.C) out[((col / CB) * (k4 + 1) + k) * G.C + cc] = acc[i][j][e];
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
// dy formed from kernel D's routing. h (2, C) = h1, h2. In bf16 each tap's
// sum over c is kept apart and rounded before the four are added.
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv2_input_gather(const float* __restrict__ route, const T* __restrict__ g, const float* __restrict__ w,
                 const float* __restrict__ mu_p, const float* __restrict__ inv_p,
                 const float* __restrict__ scale_p, const float* __restrict__ h_p, T* __restrict__ dx,
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
    Ws[e] = round_to_compute<T>(w[(long long)k * C + c]);
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
        if (enc < 0.0f && io < G.ho && jo < G.wo) dz = to_f32(__ldg(g + (plane * G.ho + io) * G.wo + jo));
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
      // f32: one sum over every (c, tap); bf16: one per tap (kh, kw).
      constexpr int NA = std::is_same_v<T, bf16> ? 4 : 1;
      float acc[NA][GJ];
#pragma unroll
      for (int a = 0; a < NA; ++a)
#pragma unroll
        for (int jj = 0; jj < GJ; ++jj) acc[a][jj] = 0.0f;
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int kh = 0; kh < 2; ++kh) {
          // dr[u] = dy[b, c, i - kh, j0 - 1 + u]: column j reads it at u = j - j0 + 1 - kw.
          const float* drow = D + ((r + 1 - kh) * C + c) * wpad + j0;
          float dr[GJ + 1];
#pragma unroll
          for (int u = 0; u <= GJ; ++u) dr[u] = drow[u];
          const float w0 = Ws[(c * 4 + kh * 2) * cin + ci], w1 = Ws[(c * 4 + kh * 2 + 1) * cin + ci];
          float* a0 = acc[NA == 4 ? 2 * kh : 0];
          float* a1 = acc[NA == 4 ? 2 * kh + 1 : 0];
#pragma unroll
          for (int jj = 0; jj < GJ; ++jj) {
            a0[jj] = fmaf(w0, dr[jj + 1], a0[jj]);
            a1[jj] = fmaf(w1, dr[jj], a1[jj]);
          }
        }
      }
      T* out = dx + (((long long)b * cin + ci) * G.H + i) * G.W;
#pragma unroll
      for (int jj = 0; jj < GJ; ++jj) {
        float v = acc[0][jj];
        if constexpr (NA == 4) {
          v = round_to_compute<T>(v);
#pragma unroll
          for (int a = 1; a < 4; ++a) v += round_to_compute<T>(acc[a][jj]);
          v = round_to_compute<T>(v);
        }
        if (j0 + jj < G.W) out[j0 + jj] = from_f32<T>(v);
      }
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                               static_cast<int>(cudaSharedmemCarveoutMaxShared)));
}

template <int CR, typename T>
int launch_route(const T* x, const float* w, const float* scale, const float* shift, float* route,
                 const Geometry& G, int splits, cudaStream_t s) {
  const size_t smem = RouteShape<CR>::FLOATS * sizeof(float) + 2 * RouteShape<CR>::RP * sizeof(long long);
  const int err = set_smem(conv2_route<CR, T>, smem);
  if (err != 0) return err;
  conv2_route<CR, T><<<dim3(splits, (G.C + CR - 1) / CR), THREADS, smem, s>>>(x, w, scale, shift, route, G);
  return static_cast<int>(cudaGetLastError());
}

// Kernel D in the compute type T (x and g in T).
template <typename T>
int params_entry(const T* x, const T* g, const float* w, const float* mu, const float* inv, const float* scale,
                 const float* shift, float* partial, float* out, float* route, int B, int Cin, int H, int W, int C,
                 int ph, int pw, int splits, int route_splits, void* stream) {
  if (Cin < 1 || 4 * Cin > KMAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry G = make_geometry(B, Cin, H, W, C, ph, pw);
  if (G.M + TW >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  int err = C <= 32 ? launch_route<32>(x, w, scale, shift, route, G, route_splits, s)
                    : launch_route<64>(x, w, scale, shift, route, G, route_splits, s);
  if (err != 0) return err;
  const size_t smem = kParamsFloats * sizeof(float) + 2 * TP * sizeof(long long);
  err = set_smem(conv2_params_partial<T>, smem);
  if (err != 0) return err;
  conv2_params_partial<T><<<dim3(splits, (C + CB - 1) / CB), THREADS, smem, s>>>(x, g, route, mu, inv, partial, G);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int k4 = 4 * Cin;
  const long long n = (long long)(k4 + 1) * C;
  const float n_total = static_cast<float>((long long)B * G.hp * G.wp);
  conv2_params_finish<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(partial, scale, out, k4, C,
                                                                           splits, n_total);
  return static_cast<int>(cudaGetLastError());
}

// Kernel E in the compute type T (g and dx in T).
template <typename T>
int input_entry(const float* route, const T* g, const float* w, const float* mu, const float* inv,
                const float* scale, const float* h, T* dx, int B, int Cin, int H, int W, int C, int ph, int pw,
                void* stream) {
  if (Cin < 1 || 4 * Cin > KMAX) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry G = make_geometry(B, Cin, H, W, C, ph, pw);
  const size_t smem = ((size_t)C * 4 * Cin + (size_t)(GR + 1) * C * gather_row_pitch(W) + 5 * (size_t)C) * sizeof(float);
  const int err = set_smem(conv2_input_gather<T>, smem);
  if (err != 0) return err;
  const dim3 grid((H + GR - 1) / GR, B);
  conv2_input_gather<T><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(route, g, w, mu, inv, scale, h,
                                                                                    dx, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

int use_device(int device) { return static_cast<int>(cudaSetDevice(device)); }

// Kernel D: the routing pass, the product pass and the finish. partial
// (splits, 3*(4*Cin + 1) + 2, C) scratch, out (4*Cin + 5, C), route (B, C,
// H-1, W-1) the routing for kernel E; route_splits and splits blocks along
// the window tiles for the two passes.
int conv2_bn_pool_bwd_params(const float* x, const float* g, const float* w, const float* mu,
                             const float* inv, const float* scale, const float* shift,
                             float* partial, float* out, float* route, int B, int Cin, int H, int W, int C,
                             int ph, int pw, int splits, int route_splits, void* stream) {
  return params_entry(x, g, w, mu, inv, scale, shift, partial, out, route, B, Cin, H, W, C, ph, pw, splits,
                      route_splits, stream);
}

// Kernel E: route (B, C, H-1, W-1) from kernel D; h (2, C) = h1, h2 from kernel D;
// dx (B, Cin, H, W).
int conv2_bn_pool_bwd_input(const float* route, const float* g, const float* w, const float* mu,
                            const float* inv, const float* scale, const float* h, float* dx, int B, int Cin,
                            int H, int W, int C, int ph, int pw, void* stream) {
  return input_entry(route, g, w, mu, inv, scale, h, dx, B, Cin, H, W, C, ph, pw, stream);
}

// Kernel D in bf16: x and g bf16, the rest as above.
int conv2_bn_pool_bwd_params_bf16(const void* x, const void* g, const float* w, const float* mu,
                                  const float* inv, const float* scale, const float* shift,
                                  float* partial, float* out, float* route, int B, int Cin, int H, int W, int C,
                                  int ph, int pw, int splits, int route_splits, void* stream) {
  return params_entry(static_cast<const bf16*>(x), static_cast<const bf16*>(g), w, mu, inv, scale, shift, partial,
                      out, route, B, Cin, H, W, C, ph, pw, splits, route_splits, stream);
}

// Kernel E in bf16: g and dx bf16, the rest as above.
int conv2_bn_pool_bwd_input_bf16(const float* route, const void* g, const float* w, const float* mu,
                                 const float* inv, const float* scale, const float* h, void* dx, int B, int Cin,
                                 int H, int W, int C, int ph, int pw, void* stream) {
  return input_entry(route, static_cast<const bf16*>(g), w, mu, inv, scale, h, static_cast<bf16*>(dx), B, Cin, H,
                     W, C, ph, pw, stream);
}

}  // extern "C"
