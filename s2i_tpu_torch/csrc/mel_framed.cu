// Log-mel of pre-framed rows for Hopper (sm_90a): windowed DFT power + mel
// projection + log in one kernel.
//
// Replaces: the Pallas TPU kernel `_mel_kernel` in s2i_tpu/ops/mel_kernel.py
// (wrapper `logmel_pallas`). Its input contract is kept: the frames arrive
// as rows [B*F, n_fft] that a gather outside the kernel cut from the wav
// (each row the n_fft samples from its frame start, the wav's tail padded
// with n_fft - win_length zeros). The DFT tables are zero in rows
// >= win_length, so only the first win_length samples of a row do work.
// The power spectrum never goes to device memory.
//
// What bounds it on this card: arithmetic. At the birds geometry (win 400,
// 257 bins, 40 mels) one row costs 2*2*400*257 = 411 kFLOP of DFT against
// 2 kB of row read and 160 B of log-mel written, far above the H100's
// ~20 FLOP/byte fp32 ridge. The work is fp32 FMA on the CUDA cores: the log
// that follows amplifies a TF32 product's error in near-zero bins.
//
// Design: the structure of csrc/mel_fused.cu reading framed rows instead of
// a wav span. One block per tile of kTile rows.
//   1. The block stages the first `win` samples of each of its rows in
//      shared memory (row stride `win`, a multiple of 4; zero past the row's
//      end or past the last row).
//   2. Thread k owns DFT bin k and keeps re/im of all kTile rows in
//      registers; each cos/sin table entry it loads (from L2, coalesced
//      across the warp) feeds 2*kTile FMAs, and one 16-byte shared load of
//      a row feeds 8 FMAs.
//   3. The power spectrum [kTile, n_bins] stays in shared memory; the block
//      projects it on the mel filterbank and writes log(mel + offset).
// Shared memory holds kTile rows of `win` samples plus kTile power spectra:
// 84 kB at the birds geometry. A geometry past the card's per-block limit
// returns cudaErrorInvalidValue and the wrapper raises.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 32;  // rows (frames) per block

__global__ void mel_framed_kernel(
    const float* __restrict__ frames,  // [rows, span]
    int rows, int span,
    const float* __restrict__ cos_t,  // [win, n_bins], window folded in
    const float* __restrict__ sin_t,  // [win, n_bins]
    const float* __restrict__ mel_t,  // [n_bins, n_mels]
    float* __restrict__ out,          // [rows, n_mels]
    int win, int n_bins, int n_mels, float log_offset) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                 // [kTile, win]
  float* power = smem + kTile * win;  // [kTile, n_bins]

  const long r0 = (long)blockIdx.x * kTile;
  for (int i = threadIdx.x; i < kTile * win; i += blockDim.x) {
    const int f = i / win;
    const int t = i - f * win;
    const long r = r0 + f;
    xs[i] = (r < rows && t < span) ? frames[r * span + t] : 0.0f;
  }
  __syncthreads();

  for (int k = threadIdx.x; k < n_bins; k += blockDim.x) {
    float re[kTile], im[kTile];
#pragma unroll
    for (int f = 0; f < kTile; ++f) {
      re[f] = 0.0f;
      im[f] = 0.0f;
    }
    for (int t = 0; t < win; t += 4) {
      const float c0 = cos_t[(t + 0) * n_bins + k];
      const float c1 = cos_t[(t + 1) * n_bins + k];
      const float c2 = cos_t[(t + 2) * n_bins + k];
      const float c3 = cos_t[(t + 3) * n_bins + k];
      const float s0 = sin_t[(t + 0) * n_bins + k];
      const float s1 = sin_t[(t + 1) * n_bins + k];
      const float s2 = sin_t[(t + 2) * n_bins + k];
      const float s3 = sin_t[(t + 3) * n_bins + k];
#pragma unroll
      for (int f = 0; f < kTile; ++f) {
        const float4 x = *reinterpret_cast<const float4*>(xs + f * win + t);
        re[f] = fmaf(x.x, c0, re[f]);
        im[f] = fmaf(x.x, s0, im[f]);
        re[f] = fmaf(x.y, c1, re[f]);
        im[f] = fmaf(x.y, s1, im[f]);
        re[f] = fmaf(x.z, c2, re[f]);
        im[f] = fmaf(x.z, s2, im[f]);
        re[f] = fmaf(x.w, c3, re[f]);
        im[f] = fmaf(x.w, s3, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < kTile; ++f) {
      power[f * n_bins + k] = re[f] * re[f] + im[f] * im[f];
    }
  }
  __syncthreads();

  for (int o = threadIdx.x; o < kTile * n_mels; o += blockDim.x) {
    const int f = o / n_mels;
    const int m = o - f * n_mels;
    if (r0 + f >= rows) continue;
    const float* p = power + f * n_bins;
    float acc = 0.0f;
    for (int k = 0; k < n_bins; ++k) acc = fmaf(p[k], mel_t[k * n_mels + m], acc);
    out[(r0 + f) * n_mels + m] = logf(acc + log_offset);
  }
}

}  // namespace

// frames [rows, span] float32; cos_t/sin_t [win, n_bins] with win a multiple
// of 4 (zero rows past the window); mel_t [n_bins, n_mels]; out [rows, n_mels].
extern "C" int s2i_mel_framed(const float* frames, int rows, int span,
                              const float* cos_t, const float* sin_t,
                              const float* mel_t, float* out, int win,
                              int n_bins, int n_mels, float log_offset,
                              void* stream) {
  if (rows <= 0 || span <= 0 || win <= 0 || win % 4 != 0 || n_bins <= 0 ||
      n_mels <= 0)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)kTile * (size_t)(win + n_bins);
  int device = 0, smem_max = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  if (smem > (size_t)smem_max) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mel_framed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  int threads = ((n_bins + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const dim3 grid((rows + kTile - 1) / kTile);
  mel_framed_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      frames, rows, span, cos_t, sin_t, mel_t, out, win, n_bins, n_mels,
      log_offset);
  return cudaGetLastError();
}

extern "C" const char* s2i_mel_framed_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
