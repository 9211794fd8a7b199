// Waveform -> MFCC in one kernel, one thread block per clip.
//
// Replaces: audiobd_tpu/ops/pallas_mfcc.py::fused_mfcc (the Pallas `_kernel`,
// pallas_call at line 129). Same function: centre-padded, Hann-windowed power
// spectrum as a matrix-form DFT, mel filterbank, 10*log10 with a per-clip
// top_db floor, orthonormal DCT-II. All float32, no TF32 (the reference runs
// its products at Precision.HIGHEST).
//
// What bounds it on the H100: arithmetic. At the BadNets shape (16 kHz, 1 s
// clips, n_fft 400, hop 160, 101 frames, 201 bins, 128 mels, 40 MFCCs) the
// DFT alone is 101*201*400*2 FMAs per clip (~32 MFLOP) against 64 KB of PCM
// read and 16 KB of MFCC written, far above the f32 ridge point, and without
// tensor cores (no TF32) the f32 FMA rate is the roof. The function itself
// needs far less: an FFT-size DFT and the mel product over the filterbank's
// nonzeros come to ~2 MFLOP per clip, near the ridge point, which is the
// bound chip_smoke.py reports. The matrix DFT is kept for now because it is
// simple and matches the reference's sums; an FFT is the way to that bound.
//
// Design:
//  * One block per clip. Frames are processed in tiles of FT = 16. For each
//    tile the block stages the padded samples it spans in shared memory,
//    doing reflect or constant centre padding by index arithmetic (no padded
//    copy in device memory), and reads int16 PCM or f32 directly (int16 is
//    scaled by 2^-15 on load, exactly as dequantize_pcm does).
//  * DFT: one thread per frequency bin keeps FT real and FT imaginary sums in
//    registers, so each basis value read (through L1/L2: the windowed bases
//    are shared by every clip and too big for shared memory) feeds 2*FT FMAs.
//  * The tile's power spectrum goes to shared memory; the mel product reads
//    it from there and writes dB values into a per-clip (frames x mels) tile
//    that stays in shared memory until the clip's maximum is known.
//  * A block reduction takes the clip's max for the top_db floor; the DCT
//    then writes only the (frames x n_mfcc) result.

#include <cuda_runtime.h>
#include <cstdint>
#include <math_constants.h>

namespace {

constexpr int FT = 16;        // frames per tile
constexpr int THREADS = 256;  // threads per block

__device__ __forceinline__ float load_sample(const void* wav, int is_int16, long long idx) {
  if (is_int16) {
    return static_cast<float>(static_cast<const int16_t*>(wav)[idx]) * (1.0f / 32768.0f);
  }
  return static_cast<const float*>(wav)[idx];
}

__global__ void __launch_bounds__(THREADS)
mfcc_kernel(const void* __restrict__ wav, int is_int16, int n_samples,
            const float* __restrict__ cos_b,   // (n_fft, n_bins)
            const float* __restrict__ sin_b,   // (n_fft, n_bins)
            const float* __restrict__ mel_fb,  // (n_bins, n_mels)
            const float* __restrict__ dct,     // (n_mels, n_mfcc)
            float* __restrict__ out,           // (batch, n_frames, n_mfcc)
            int n_fft, int hop, int n_bins, int n_mels, int n_mfcc, int n_frames,
            int reflect, float top_db, int use_top_db) {
  extern __shared__ float smem[];
  const int tile_len = (FT - 1) * hop + n_fft;
  float* wav_s = smem;                   // tile_len samples of the padded clip
  float* pow_s = wav_s + tile_len;       // FT x n_bins power spectrum
  float* db_s = pow_s + FT * n_bins;     // n_frames x n_mels dB values
  __shared__ float red_s[THREADS / 32];

  const int tid = threadIdx.x;
  const long long clip = blockIdx.x;
  const long long base = clip * n_samples;
  const int pad = n_fft / 2;
  float local_max = -CUDART_INF_F;

  for (int f0 = 0; f0 < n_frames; f0 += FT) {
    const int nf = min(FT, n_frames - f0);
    const int len = (nf - 1) * hop + n_fft;
    for (int p = tid; p < tile_len; p += THREADS) {
      float v = 0.0f;
      if (p < len) {
        int src = f0 * hop + p - pad;
        if (reflect) {
          if (src < 0) src = -src;
          if (src >= n_samples) src = 2 * (n_samples - 1) - src;
          v = load_sample(wav, is_int16, base + src);
        } else if (src >= 0 && src < n_samples) {
          v = load_sample(wav, is_int16, base + src);
        }
      }
      wav_s[p] = v;
    }
    __syncthreads();

    for (int k = tid; k < n_bins; k += THREADS) {
      float re[FT], im[FT];
#pragma unroll
      for (int f = 0; f < FT; ++f) { re[f] = 0.0f; im[f] = 0.0f; }
      for (int n = 0; n < n_fft; ++n) {
        const float c = __ldg(cos_b + n * n_bins + k);
        const float s = __ldg(sin_b + n * n_bins + k);
#pragma unroll
        for (int f = 0; f < FT; ++f) {
          const float v = wav_s[f * hop + n];
          re[f] = fmaf(v, c, re[f]);
          im[f] = fmaf(v, s, im[f]);
        }
      }
#pragma unroll
      for (int f = 0; f < FT; ++f) {
        if (f < nf) pow_s[f * n_bins + k] = re[f] * re[f] + im[f] * im[f];
      }
    }
    __syncthreads();

    for (int idx = tid; idx < nf * n_mels; idx += THREADS) {
      const int f = idx / n_mels, m = idx - f * n_mels;
      const float* pw = pow_s + f * n_bins;
      float acc = 0.0f;
      for (int k = 0; k < n_bins; ++k) acc = fmaf(pw[k], __ldg(mel_fb + k * n_mels + m), acc);
      const float db = 10.0f * log10f(fmaxf(acc, 1e-10f));
      db_s[(f0 + f) * n_mels + m] = db;
      local_max = fmaxf(local_max, db);
    }
    __syncthreads();  // wav_s and pow_s are rewritten by the next tile
  }

  float floor_db = -CUDART_INF_F;
  if (use_top_db) {
    for (int o = 16; o > 0; o >>= 1) local_max = fmaxf(local_max, __shfl_xor_sync(0xffffffffu, local_max, o));
    if ((tid & 31) == 0) red_s[tid >> 5] = local_max;
    __syncthreads();
    float clip_max = red_s[0];
    for (int w = 1; w < THREADS / 32; ++w) clip_max = fmaxf(clip_max, red_s[w]);
    floor_db = clip_max - top_db;
  }

  float* out_clip = out + clip * n_frames * n_mfcc;
  for (int idx = tid; idx < n_frames * n_mfcc; idx += THREADS) {
    const int f = idx / n_mfcc, j = idx - f * n_mfcc;
    const float* row = db_s + f * n_mels;
    float acc = 0.0f;
    for (int m = 0; m < n_mels; ++m) acc = fmaf(fmaxf(row[m], floor_db), __ldg(dct + m * n_mfcc + j), acc);
    out_clip[idx] = acc;
  }
}

// Shared memory the kernel needs for these sizes, in bytes. Above the
// 227 KB a block may use, cudaFuncSetAttribute refuses and the launch
// reports the error.
int mfcc_smem_bytes(int n_fft, int hop, int n_bins, int n_mels, int n_frames) {
  return static_cast<int>(sizeof(float)) * ((FT - 1) * hop + n_fft + FT * n_bins + n_frames * n_mels);
}

}  // namespace

extern "C" {

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

int use_device(int device) { return static_cast<int>(cudaSetDevice(device)); }

int mfcc_forward(const void* wav, int is_int16, int batch, int n_samples,
                 const float* cos_b, const float* sin_b, const float* mel_fb, const float* dct,
                 float* out, int n_fft, int hop, int n_bins, int n_mels, int n_mfcc, int n_frames,
                 int reflect, float top_db, int use_top_db, void* stream) {
  const int smem = mfcc_smem_bytes(n_fft, hop, n_bins, n_mels, n_frames);
  cudaError_t err = cudaFuncSetAttribute(mfcc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mfcc_kernel<<<batch, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      wav, is_int16, n_samples, cos_b, sin_b, mel_fb, dct, out, n_fft, hop, n_bins, n_mels, n_mfcc,
      n_frames, reflect, top_db, use_top_db);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
