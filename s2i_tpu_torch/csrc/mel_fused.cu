// Fused log-mel frontend for Hopper (sm_90a): framing + windowed DFT power
// + mel projection + log in one kernel.
//
// Replaces: the Pallas TPU kernel `_mel_fused_kernel` in
// s2i_tpu/ops/mel_kernel.py (wrapper `logmel_pallas_fused`). Like it, the
// frame matrix is never built in device memory: frame f of an utterance is
// the wav span [f*hop, f*hop + win), read from a tile of the wav staged in
// shared memory.
//
// What bounds it on this card: arithmetic. At the birds geometry (win 400,
// 257 bins, 40 mels, 1024 frames) the DFT is 2*2*400*257 = 411 kFLOP per
// frame against 1.6 kB of wav read and 160 B of log-mel written, far above
// the H100's ~20 FLOP/byte fp32 ridge. The work is fp32 FMA on the CUDA
// cores (no TF32 tensor-core path: the log that follows amplifies the
// product's error in near-zero bins, so parity needs full fp32).
//
// Design: one block per (utterance, tile of kTile frames).
//   1. The block stages its tile's contiguous wav span, (kTile-1)*hop + win
//      samples, in shared memory (zero past the end of the signal).
//   2. Thread k owns DFT bin k and keeps re/im of all kTile frames in
//      registers; each cos/sin table entry it loads (from L2, coalesced
//      across the warp) feeds 2*kTile FMAs. When hop is a multiple of 4 the
//      wav is read 4 samples at a time (one 16-byte shared load feeds 8
//      FMAs), so the loop is bound by the FMA pipe, not shared memory.
//   3. The power spectrum [kTile, n_bins] stays in shared memory; the block
//      projects it on the mel filterbank and writes log(mel + offset).
// Any frame geometry works: no limit on n_fft/hop. The tables may carry
// zero rows past the window (the wrapper pads them to a multiple of 4).
// Shared memory holds the tile's power spectrum, so n_bins stays below
// ~1600 (n_fft <= 3200 at hop 160) on an H100; beyond that the launch
// returns cudaErrorInvalidValue and the wrapper raises.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 32;  // frames per block

template <bool kVec4>
__global__ void mel_fused_kernel(
    const float* __restrict__ wav,   // [B, n_samples]
    int n_samples,
    const float* __restrict__ cos_t,  // [win, n_bins], window folded in
    const float* __restrict__ sin_t,  // [win, n_bins]
    const float* __restrict__ mel_t,  // [n_bins, n_mels]
    float* __restrict__ out,          // [B, n_frames, n_mels]
    int n_frames, int hop, int win, int n_bins, int n_mels,
    float log_offset) {
  extern __shared__ __align__(16) float smem[];
  const int span = (kTile - 1) * hop + win;
  float* xs = smem;                      // [span (rounded up to 4)]
  float* power = smem + ((span + 3) & ~3);  // [kTile, n_bins]

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kTile;
  const long start = (long)f0 * hop;
  const float* w = wav + (long)b * n_samples;
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const long idx = start + i;
    xs[i] = idx < n_samples ? w[idx] : 0.0f;
  }
  __syncthreads();

  for (int k = threadIdx.x; k < n_bins; k += blockDim.x) {
    float re[kTile], im[kTile];
#pragma unroll
    for (int f = 0; f < kTile; ++f) {
      re[f] = 0.0f;
      im[f] = 0.0f;
    }
    if (kVec4) {
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
          const float4 x = *reinterpret_cast<const float4*>(xs + f * hop + t);
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
    } else {
      for (int t = 0; t < win; ++t) {
        const float c = cos_t[t * n_bins + k];
        const float s = sin_t[t * n_bins + k];
#pragma unroll
        for (int f = 0; f < kTile; ++f) {
          const float x = xs[f * hop + t];
          re[f] = fmaf(x, c, re[f]);
          im[f] = fmaf(x, s, im[f]);
        }
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
    if (f0 + f >= n_frames) continue;
    const float* p = power + f * n_bins;
    float acc = 0.0f;
    for (int k = 0; k < n_bins; ++k) acc = fmaf(p[k], mel_t[k * n_mels + m], acc);
    out[((long)b * n_frames + f0 + f) * n_mels + m] = logf(acc + log_offset);
  }
}

template <bool kVec4>
cudaError_t launch(const float* wav, int batch, int n_samples,
                   const float* cos_t, const float* sin_t, const float* mel_t,
                   float* out, int n_frames, int hop, int win, int n_bins,
                   int n_mels, float log_offset, cudaStream_t stream) {
  const int span = (kTile - 1) * hop + win;
  const size_t smem =
      sizeof(float) * ((size_t)((span + 3) & ~3) + (size_t)kTile * n_bins);
  int device = 0, smem_max = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  if (smem > (size_t)smem_max) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mel_fused_kernel<kVec4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  int threads = ((n_bins + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const dim3 grid((n_frames + kTile - 1) / kTile, batch);
  mel_fused_kernel<kVec4><<<grid, threads, smem, stream>>>(
      wav, n_samples, cos_t, sin_t, mel_t, out, n_frames, hop, win, n_bins,
      n_mels, log_offset);
  return cudaGetLastError();
}

}  // namespace

extern "C" int s2i_mel_fused(const float* wav, int batch, int n_samples,
                             const float* cos_t, const float* sin_t,
                             const float* mel_t, float* out, int n_frames,
                             int hop, int win, int n_bins, int n_mels,
                             float log_offset, void* stream) {
  if (batch <= 0 || n_frames <= 0 || hop <= 0 || win <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The 16-byte path needs every frame start and the window rows on a
  // multiple of 4 samples; the wrapper pads the tables' rows accordingly.
  if (hop % 4 == 0 && win % 4 == 0)
    return launch<true>(wav, batch, n_samples, cos_t, sin_t, mel_t, out,
                        n_frames, hop, win, n_bins, n_mels, log_offset, s);
  return launch<false>(wav, batch, n_samples, cos_t, sin_t, mel_t, out,
                       n_frames, hop, win, n_bins, n_mels, log_offset, s);
}

extern "C" const char* s2i_mel_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
