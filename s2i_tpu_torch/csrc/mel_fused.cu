// Fused log-mel frontend for Hopper (sm_90a): framing + windowed spectrum
// power + mel projection + log in one kernel.
//
// Replaces: the Pallas TPU kernel `_mel_fused_kernel` in
// s2i_tpu/ops/mel_kernel.py (wrapper `logmel_pallas_fused`). Like it, the
// frame matrix is never built in device memory: frame f of an utterance is
// the wav span [f*hop, f*hop + win), read from a tile of the wav staged in
// shared memory.
//
// Why an FFT and not the TPU kernel's DFT matmul: the TPU kernel multiplies
// frames by dense [win, n_bins] cos/sin tables because its matrix unit makes
// that cheap. On this card the dense DFT runs on the CUDA cores (TF32 tensor
// cores break parity: the log amplifies their error in near-empty bins; a
// 3xTF32 split would still do ~30x the FFT's work): 2*2*400*257 = 411 kFLOP
// per frame at the birds geometry (win 400, hop 160, n_fft 512, 40 mels),
// which bound the earlier kernel by operations. A 512-point real FFT as a
// 256-point complex FFT (8x8x4 Stockham: ~7.1 kFLOP) plus a split step and
// power (12 per bin), with the 400 window products, is ~10.6 kFLOP per
// frame; the mel filterbank has 490 non-zeros in contiguous runs of at most
// 36 bins, so a sparse projection and the log are ~1.1 kFLOP: ~11.7 kFLOP,
// 35x less than the DFT alone (chip_smoke.py's mel_fft_ops counts them).
//
// What bounds it now: operations, in float64 (mel_common.cuh says why
// float64), just ahead of bytes. Per frame the kernel reads hop = 160 new
// wav samples (640 B) and writes 40 log-mels (160 B). At the encoder batch
// (64 x 164,080 samples, 1024 frames each) that is 42.0 MB read + 10.5 MB
// written = 15.7 us at 3.35 TB/s, against 0.69 GFLOP of float64 = 20.4 us
// at the H100's 34 TFLOP/s (the float32 mel and log, 0.07 GFLOP, run on
// other units). Done all in float32 the same work would be bound by the
// bytes (0.77 GFLOP = 11.4 us at 67 TFLOP/s).
//
// Design (FFT branch, n_fft a power of two from 128 to 2048): a persistent
// grid, as many blocks as stay resident (two of 8 warps per SM at n_fft 512),
// each walking tiles of 2 frames per warp (16) of one utterance:
//   1. The block copies the packed constant table (mel_common.cuh) into
//      shared memory once, and each tile's contiguous wav span,
//      (tile-1)*hop + win samples, with 16-byte cp.async (plain loads for
//      the unaligned ends, zero past the end of the signal) into one of two
//      slots: the next tile's copy is in flight while the warps work on this
//      one. HBM sees each sample about once (neighbouring spans overlap by
//      win - hop samples).
//   2. Each warp takes a frame: window, FFT, split and power in float64
//      (mel_common.cuh), the power spectrum to the tile's rows in shared
//      memory.
//   3. The block projects the tile's spectra on the mel runs (a thread per
//      (filter, frame)), takes the log, and stores the tile's contiguous
//      log-mel rows with coalesced stores.
//
// DFT branch (any other n_fft, chosen by shape only): the dense windowed DFT
// of the earlier kernel. Thread k owns bin k and keeps re/im of kTileDft
// frames in registers; each cos/sin table entry feeds 2*kTileDft FMAs; the
// power spectrum stays in shared memory for the dense mel projection.
//
// A geometry past the card's per-block shared memory returns
// cudaErrorInvalidValue; the wrapper asks s2i_mel_fused_smem first and
// raises with the geometry, the bytes it needs and the card's limit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mel_common.cuh"

namespace {

constexpr int kTileDft = 32;  // frames per block, DFT branch

// Frames per tile of the FFT branch: two per warp.
__host__ __device__ constexpr int fft_tile(int log2m) { return 2 * mel::warps(log2m); }

// Shared bytes of one staged wav span of a tile (+3 floats of alignment shift).
__host__ __device__ inline int span_bytes(int log2m, int hop, int win) {
  return mel::round16(4 * ((fft_tile(log2m) - 1) * hop + win + 3));
}

// Dynamic shared bytes of an FFT-branch block: the table, two span slots,
// the warps' FFT buffers, the tile's power spectra and log-mel rows.
__host__ inline size_t fft_smem(int log2m, int table_bytes, int hop, int win, int n_mels) {
  return (size_t)table_bytes + 2 * (size_t)span_bytes(log2m, hop, win) + mel::buffer_bytes(log2m) +
         mel::tile_bytes(fft_tile(log2m), log2m, n_mels);
}

// Dynamic shared bytes of a DFT-branch block: the tile's span and its power spectra.
__host__ inline size_t dft_smem(int hop, int win, int n_bins) {
  const size_t span = (size_t)(kTileDft - 1) * hop + win;
  return sizeof(float) * (((span + 3) & ~(size_t)3) + (size_t)kTileDft * n_bins);
}

// Issues the copies of a tile's span: `span` samples from w, of which
// `left` lie in the signal (zero past it; none if left <= 0), to
// base + shift, where xs[i] sits at the same address mod 16 as w[i] so the
// aligned middle moves in 16-byte cp.async; the unaligned ends and the
// zeros are plain stores. Returns xs.
__device__ float* stage_span(const float* w, long left, int span, float* base) {
  const int shift = (int)((reinterpret_cast<uintptr_t>(w) >> 2) & 3);
  float* xs = base + shift;
  const int valid = left <= 0 ? 0 : (left < span ? (int)left : span);
  const int head = min((4 - shift) & 3, valid);
  const int chunks = (valid - head) / 4;
  for (int i = threadIdx.x; i < head; i += blockDim.x) xs[i] = w[i];
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) mel::cp_async16(xs + head + 4 * c, w + head + 4 * c);
  for (int i = head + 4 * chunks + threadIdx.x; i < valid; i += blockDim.x) xs[i] = w[i];
  for (int i = valid + threadIdx.x; i < span; i += blockDim.x) xs[i] = 0.0f;
  return xs;
}

// Persistent: block i takes tiles i, i + gridDim.x, ... (tile t: utterance
// t / tiles_per_utt, frames from (t % tiles_per_utt)·tile). It copies the
// table once, and the next tile's span while its warps work on this one.
template <int kLog2M>
__global__ void __launch_bounds__(32 * mel::warps(kLog2M)) mel_fused_fft_kernel(
    const float* __restrict__ wav,   // [B, n_samples]
    int n_samples,
    const char* __restrict__ table,  // packed constants, table_bytes
    int table_bytes,
    float* __restrict__ out,         // [B, n_frames, n_mels]
    int n_frames, int hop, int win, int n_mels, float log_offset, int tiles_per_utt, int n_tiles) {
  constexpr int kWarps = mel::warps(kLog2M), kTile = fft_tile(kLog2M), kStride = mel::power_stride(kLog2M);
  extern __shared__ __align__(16) char smem_bytes[];  // named apart from the DFT branch's float smem[]
  // [table][span slot 0][span slot 1][one padded M-point buffer per warp]
  // [power spectra of the tile][log-mel rows of the tile]
  const int span = (kTile - 1) * hop + win;
  const int slot = span_bytes(kLog2M, hop, win);
  float* slots[2] = {reinterpret_cast<float*>(smem_bytes + table_bytes),
                     reinterpret_cast<float*>(smem_bytes + table_bytes + slot)};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  char* after_slots = smem_bytes + table_bytes + 2 * slot;
  double2* buf = reinterpret_cast<double2*>(after_slots) + warp * mel::padded(1 << kLog2M);
  float* power = reinterpret_cast<float*>(after_slots + mel::buffer_bytes(kLog2M));
  float* out_tile = power + mel::round16(4 * kTile * kStride) / 4;

  auto issue = [&](int t, float* base) {
    const int b = t / tiles_per_utt;
    const long start = (long)(t - b * tiles_per_utt) * kTile * hop;
    return stage_span(wav + (long)b * n_samples + start, n_samples - start, span, base);
  };
  mel::stage_table(smem_bytes, table, table_bytes);
  int t = blockIdx.x;
  float* xs = issue(t, slots[0]);
  mel::cp_async_commit();
  for (int i = 0; t < n_tiles; ++i, t += gridDim.x) {
    const int next = t + gridDim.x;
    float* xs_next = next < n_tiles ? issue(next, slots[(i + 1) & 1]) : nullptr;
    mel::cp_async_commit();
    mel::cp_async_wait<1>();  // this tile's span (and the table) have landed
    __syncthreads();
    const int b = t / tiles_per_utt;
    const int f0 = (t - b * tiles_per_utt) * kTile;
    const int n_rows = min(kTile, n_frames - f0);
    for (int f = warp; f < n_rows; f += kWarps)
      mel::frame_power<kLog2M>(xs + f * hop, smem_bytes, buf, power + f * kStride, win, lane);
    __syncthreads();
    mel::mel_tile(smem_bytes, power, kStride, n_rows, kTile, out_tile, n_mels, log_offset);
    __syncthreads();
    float* dst = out + ((long)b * n_frames + f0) * n_mels;  // the tile's rows are contiguous
    for (int o = threadIdx.x; o < n_rows * n_mels; o += blockDim.x) dst[o] = out_tile[o];
    __syncthreads();  // the span slot and out_tile are free again
    xs = xs_next;
  }
}

template <int kLog2M>
cudaError_t launch_fft(const float* wav, int batch, int n_samples, const char* table, int table_bytes,
                       float* out, int n_frames, int hop, int win, int n_mels, float log_offset,
                       cudaStream_t stream) {
  const void* kernel = (const void*)mel_fused_fft_kernel<kLog2M>;
  const int threads = 32 * mel::warps(kLog2M);
  const size_t smem = fft_smem(kLog2M, table_bytes, hop, win, n_mels);
  cudaError_t err = mel::set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles_per_utt = (n_frames + fft_tile(kLog2M) - 1) / fft_tile(kLog2M);
  const long n_tiles = (long)tiles_per_utt * batch;
  if (n_tiles > 0x7fffffff) return cudaErrorInvalidValue;
  int grid = 0;
  err = mel::persistent_grid(kernel, threads, smem, (int)n_tiles, &grid);
  if (err != cudaSuccess) return err;
  mel_fused_fft_kernel<kLog2M><<<grid, threads, smem, stream>>>(
      wav, n_samples, table, table_bytes, out, n_frames, hop, win, n_mels, log_offset, tiles_per_utt,
      (int)n_tiles);
  return cudaGetLastError();
}

template <bool kVec4>
__global__ void mel_fused_dft_kernel(
    const float* __restrict__ wav,    // [B, n_samples]
    int n_samples,
    const float* __restrict__ cos_t,  // [win, n_bins], window folded in
    const float* __restrict__ sin_t,  // [win, n_bins]
    const float* __restrict__ mel_t,  // [n_bins, n_mels]
    float* __restrict__ out,          // [B, n_frames, n_mels]
    int n_frames, int hop, int win, int n_bins, int n_mels,
    float log_offset) {
  extern __shared__ __align__(16) float smem[];
  const int span = (kTileDft - 1) * hop + win;
  float* xs = smem;                          // [span (rounded up to 4)]
  float* power = smem + ((span + 3) & ~3);  // [kTileDft, n_bins]

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kTileDft;
  const long start = (long)f0 * hop;
  const float* w = wav + (long)b * n_samples;
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const long idx = start + i;
    xs[i] = idx < n_samples ? w[idx] : 0.0f;
  }
  __syncthreads();

  for (int k = threadIdx.x; k < n_bins; k += blockDim.x) {
    float re[kTileDft], im[kTileDft];
#pragma unroll
    for (int f = 0; f < kTileDft; ++f) {
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
        for (int f = 0; f < kTileDft; ++f) {
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
        for (int f = 0; f < kTileDft; ++f) {
          const float x = xs[f * hop + t];
          re[f] = fmaf(x, c, re[f]);
          im[f] = fmaf(x, s, im[f]);
        }
      }
    }
#pragma unroll
    for (int f = 0; f < kTileDft; ++f) {
      power[f * n_bins + k] = re[f] * re[f] + im[f] * im[f];
    }
  }
  __syncthreads();

  for (int o = threadIdx.x; o < kTileDft * n_mels; o += blockDim.x) {
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
cudaError_t launch_dft(const float* wav, int batch, int n_samples,
                       const float* cos_t, const float* sin_t, const float* mel_t,
                       float* out, int n_frames, int hop, int win, int n_bins,
                       int n_mels, float log_offset, cudaStream_t stream) {
  const size_t smem = dft_smem(hop, win, n_bins);
  cudaError_t err = mel::set_smem((const void*)mel_fused_dft_kernel<kVec4>, smem);
  if (err != cudaSuccess) return err;
  int threads = ((n_bins + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const dim3 grid((n_frames + kTileDft - 1) / kTileDft, batch);
  mel_fused_dft_kernel<kVec4><<<grid, threads, smem, stream>>>(
      wav, n_samples, cos_t, sin_t, mel_t, out, n_frames, hop, win, n_bins,
      n_mels, log_offset);
  return cudaGetLastError();
}

}  // namespace

// FFT branch. table: ops/mel_kernel.py::fft_table's packed constants
// (table_bytes, a multiple of 16, 16-byte aligned); n_fft a power of two,
// 128..2048; n_frames at most the frames that fit in n_samples.
extern "C" int s2i_mel_fused_fft(const float* wav, int batch, int n_samples,
                                 const char* table, int table_bytes, float* out,
                                 int n_frames, int hop, int win, int n_fft,
                                 int n_mels, float log_offset, void* stream) {
  const int log2m = mel::fft_log2m(n_fft);
  if (batch <= 0 || n_frames <= 0 || hop <= 0 || win <= 0 || win > n_fft || n_mels <= 0 ||
      log2m < 0 || table_bytes % 16 != 0 || reinterpret_cast<uintptr_t>(table) % 16 != 0)
    return cudaErrorInvalidValue;
  // every frame lies inside the signal: n_frames <= 1 + (n_samples - win) / hop
  if (n_samples < win || n_frames - 1 > (n_samples - win) / hop) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (log2m) {
#define S2I_MEL_CASE(L) \
  case L:               \
    return launch_fft<L>(wav, batch, n_samples, table, table_bytes, out, n_frames, hop, win, n_mels, log_offset, s);
    S2I_MEL_CASE(6)
    S2I_MEL_CASE(7)
    S2I_MEL_CASE(8)
    S2I_MEL_CASE(9)
    S2I_MEL_CASE(10)
#undef S2I_MEL_CASE
  }
  return cudaErrorInvalidValue;
}

// DFT branch: cos_t/sin_t [rows, n_bins] with rows = win rounded up to a
// multiple of 4 (zero rows past the window), mel_t [n_bins, n_mels].
extern "C" int s2i_mel_fused_dft(const float* wav, int batch, int n_samples,
                                 const float* cos_t, const float* sin_t,
                                 const float* mel_t, float* out, int n_frames,
                                 int hop, int win, int n_bins, int n_mels,
                                 float log_offset, void* stream) {
  if (batch <= 0 || n_frames <= 0 || hop <= 0 || win <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The 16-byte path needs every frame start and the window rows on a
  // multiple of 4 samples; the wrapper pads the tables' rows accordingly.
  if (hop % 4 == 0 && win % 4 == 0)
    return launch_dft<true>(wav, batch, n_samples, cos_t, sin_t, mel_t, out,
                            n_frames, hop, win, n_bins, n_mels, log_offset, s);
  return launch_dft<false>(wav, batch, n_samples, cos_t, sin_t, mel_t, out,
                           n_frames, hop, win, n_bins, n_mels, log_offset, s);
}

// The dynamic shared bytes a launch of this geometry asks for (the FFT
// branch for an n_fft it takes, with its table_bytes; else the DFT branch,
// win being its tables' padded rows) and the current device's per-block
// opt-in limit, for the wrapper to check before it launches.
extern "C" int s2i_mel_fused_smem(int table_bytes, int hop, int win, int n_fft, int n_bins,
                                  int n_mels, long long* need, int* limit) {
  if (hop <= 0 || win <= 0 || n_bins <= 0 || n_mels <= 0 || table_bytes < 0) return cudaErrorInvalidValue;
  const int log2m = mel::fft_log2m(n_fft);
  *need = (long long)(log2m >= 0 ? fft_smem(log2m, table_bytes, hop, win, n_mels) : dft_smem(hop, win, n_bins));
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return (int)err;
}

extern "C" const char* s2i_mel_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
