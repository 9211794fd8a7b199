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
// What bounds it on the H100: device-memory bytes. At the main path's shape
// (B 256, H 101, W 40, C 64) g is 85 MB and x 4 MB against ~150 flops per
// (position, channel); the recompute trades flops for never storing or
// re-reading the 85 MB-per-phase pre-pool activation.
//
// Design:
//  * Kernel B: a grid of (C, splits) blocks. A block owns one channel, so
//    its parameters sit in registers; its threads walk the positions with a
//    grid stride, reading g coalesced (NCHW: positions of one channel are
//    contiguous) and x through L1/L2 (x is 4 MB and stays in L2). Each thread
//    keeps the 17 sums in registers. The TPU kernel carried one accumulator
//    from grid step to grid step; Hopper blocks run in no order, so each
//    block writes its (17) partial sums and a second, single-block pass adds
//    the splits in a fixed order (deterministic, no atomics) and forms dw,
//    dgamma, dbeta, h1, h2.
//  * Kernel C: one thread per pooled position loops over the channels
//    (their parameters in shared memory), recomputes the pool window, and
//    sums w.dy over channels into the four per-tap planes dp (4, B, H', W-1);
//    a gather pass then forms dx[b,i,j] from the <= 4 conv outputs that read
//    x[b,i,j], again without atomics. The bias tap gets no cotangent.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int NACC = 17;  // dwA[5], dwB[5], dwC[5], S1, S2

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

__global__ void __launch_bounds__(THREADS)
bwd_params_partial(const float* __restrict__ x, const float* __restrict__ g,
                   const float* __restrict__ w5, const float* __restrict__ mu_p,
                   const float* __restrict__ inv_p, const float* __restrict__ scale_p,
                   const float* __restrict__ shift_p, float* __restrict__ partial,
                   int B, int H, int W, int C, int train_bn) {
  const int c = blockIdx.x;
  const int Hp = H - 1, Wp = (W - 1) / 3;
  const int plane = Hp * Wp;
  const long long M = (long long)B * plane;
  float w[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) w[k] = w5[c * 5 + k];
  const float mu = mu_p[c], inv = inv_p[c], scale = scale_p[c], shift = shift_p[c];

  float acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = 0.0f;

  const long long stride = (long long)gridDim.y * THREADS;
  for (long long m = (long long)blockIdx.y * THREADS + threadIdx.x; m < M; m += stride) {
    const int b = static_cast<int>(m / plane);
    const int ij = static_cast<int>(m - (long long)b * plane);
    const int i = ij / Wp, jp = ij - i * Wp;
    float a[4], d[4];
    load_patch(x, H, W, b, i, jp, a, d);
    Window win;
    recompute(a, d, w, scale, shift, win);
    const float gv = __ldg(g + ((long long)b * C + c) * plane + ij);
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const float dz = t == win.win ? gv : 0.0f;
      const float xhat = (win.r[t] - mu) * inv;
      const bool rp = win.r[t] > 0.0f;
      const float t1 = rp ? dz : 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = fmaf(win.p[t][k], t1, acc[k]);
      acc[4] += t1;
      acc[15] += dz;
      acc[16] = fmaf(dz, xhat, acc[16]);
      if (train_bn && rp) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc[5 + k] += win.p[t][k];
          acc[10 + k] = fmaf(win.p[t][k], xhat, acc[10 + k]);
        }
        acc[9] += 1.0f;
        acc[14] += xhat;
      }
    }
  }

  // Block sum in a fixed order: warp tree, then the warps in order.
  __shared__ float red[THREADS / 32][NACC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NACC; ++k) {
    float v = acc[k];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < NACC) {
    float v = 0.0f;
    for (int q = 0; q < THREADS / 32; ++q) v += red[q][threadIdx.x];
    partial[((long long)blockIdx.y * NACC + threadIdx.x) * C + c] = v;
  }
}

// out (9, C): rows 0-4 dw (taps, bias), 5 dgamma, 6 dbeta, 7 h1, 8 h2.
__global__ void bwd_params_finish(const float* __restrict__ partial, const float* __restrict__ scale_p,
                                  float* __restrict__ out, int C, int splits, float n_total,
                                  int train_bn) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = 0.0f;
  for (int s = 0; s < splits; ++s) {
#pragma unroll
    for (int k = 0; k < NACC; ++k) acc[k] += partial[((long long)s * NACC + k) * C + c];
  }
  const float scale = scale_p[c];
  const float s1 = acc[15], s2 = acc[16];
  float h1 = 0.0f, h2 = 0.0f;
  if (train_bn) {
    h1 = scale * s1 / n_total;
    h2 = scale * s2 / n_total;
  }
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    float dw = acc[k] * scale;
    if (train_bn) dw = dw - acc[5 + k] * h1 - acc[10 + k] * h2;
    out[k * C + c] = dw;
  }
  out[5 * C + c] = s2;
  out[6 * C + c] = s1;
  out[7 * C + c] = h1;
  out[8 * C + c] = h2;
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

// Kernel B: partial (splits, 17, C) scratch, out (9, C).
int conv1_bn_pool_bwd_params(const float* x, const float* g, const float* w5, const float* mu,
                             const float* inv, const float* scale, const float* shift,
                             float* partial, float* out, int B, int H, int W, int C, int splits,
                             int train_bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bwd_params_partial<<<dim3(C, splits), THREADS, 0, s>>>(x, g, w5, mu, inv, scale, shift, partial,
                                                         B, H, W, C, train_bn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float n_total = 3.0f * static_cast<float>(B) * (H - 1) * ((W - 1) / 3);
  bwd_params_finish<<<(C + 127) / 128, 128, 0, s>>>(partial, scale, out, C, splits, n_total, train_bn);
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
