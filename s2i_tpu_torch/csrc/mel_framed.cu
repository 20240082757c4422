// Log-mel of pre-framed rows for Hopper (sm_90a): windowed spectrum power +
// mel projection + log in one kernel.
//
// Replaces: the Pallas TPU kernel `_mel_kernel` in s2i_tpu/ops/mel_kernel.py
// (wrapper `logmel_pallas`). Its input contract is kept: the frames arrive
// as rows [B*F, n_fft] that a gather outside the kernel cut from the wav
// (each row the n_fft samples from its frame start, the wav's tail padded
// with n_fft - win_length zeros). Only the first win_length samples of a
// row count (the window is zero past them). The power spectrum never goes
// to device memory.
//
// Why an FFT and not the TPU kernel's DFT matmul: the TPU kernel multiplies
// 256-row blocks by a dense [cos | sin] matrix on its matrix unit. On this
// card the dense DFT runs on the CUDA cores (TF32 breaks parity through the
// log): 2*2*400*257 = 411 kFLOP per row at the birds geometry, which bound
// the earlier kernel by operations; a 512-point real FFT (256-point complex
// FFT + split step) with a sparse mel projection (490 non-zeros) is ~11.7
// kFLOP per row (chip_smoke.py's mel_fft_ops).
//
// What bounds it now: bytes. A row costs 1.6 kB of samples read (the first
// 400 of its 512) and 160 B of log-mel written against ~10.6 kFLOP of
// float64 (mel_common.cuh says why float64) and ~1.1 kFLOP of float32. At
// the A/B shape (3,184 rows) that is 5.1 MB + 0.5 MB = 1.7 us at 3.35 TB/s
// against 34 MFLOP = 1.0 us at 34 TFLOP/s of float64.
//
// Design (FFT branch, n_fft a power of two from 128 to 2048): mel_fused.cu's
// persistent structure on rows: as many blocks as stay resident, each
// walking tiles of 2 rows per warp (16), the next tile's rows (their first
// win samples, rounded up to 4) copied by 16-byte cp.async into the other
// of two slots while the warps work on this one; the constant table copied
// once per block. At the A/B shape the 199 tiles all start at once, where
// the earlier kernel's 100 blocks of 32 rows left SMs idle. Each warp takes
// a row through mel_common.cuh's float64 window, FFT, split and power; the
// block then projects the tile's spectra on the mel runs, takes the log and
// stores the tile's contiguous rows coalesced.
//
// DFT branch (any other n_fft, chosen by shape only): the dense windowed DFT
// of the earlier kernel, the structure of mel_fused.cu's DFT branch on rows.
//
// A geometry past the card's per-block shared memory returns
// cudaErrorInvalidValue and the wrapper raises.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mel_common.cuh"

namespace {

constexpr int kTileDft = 32;  // rows per block, DFT branch

// Rows per tile of the FFT branch: two per warp.
__host__ __device__ constexpr int fft_tile(int log2m) { return 2 * mel::warps(log2m); }

// Persistent: block i takes tiles i, i + gridDim.x, ... of fft_tile rows.
// It copies the table once, and the next tile's rows (their first win
// samples, rounded up to 4) while its warps work on this one.
template <int kLog2M>
__global__ void __launch_bounds__(32 * mel::warps(kLog2M)) mel_framed_fft_kernel(
    const float* __restrict__ frames,  // [rows, n_fft]
    int rows,
    const char* __restrict__ table,    // packed constants, table_bytes
    int table_bytes,
    float* __restrict__ out,           // [rows, n_mels]
    int win, int n_mels, float log_offset, int n_tiles) {
  constexpr int n_fft = 2 << kLog2M;
  constexpr int kWarps = mel::warps(kLog2M), kTile = fft_tile(kLog2M), kStride = mel::power_stride(kLog2M);
  extern __shared__ __align__(16) char smem_bytes[];  // named apart from the DFT branch's float smem[]
  // [table][rows slot 0][rows slot 1][one padded M-point buffer per warp]
  // [power spectra of the tile][log-mel rows of the tile]
  const int stride = (win + 3) & ~3;  // <= n_fft: both multiples of 4
  float* slots[2] = {reinterpret_cast<float*>(smem_bytes + table_bytes),
                     reinterpret_cast<float*>(smem_bytes + table_bytes) + kTile * stride};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  char* after_slots = reinterpret_cast<char*>(slots[1] + kTile * stride);
  double2* buf = reinterpret_cast<double2*>(after_slots) + warp * mel::padded(1 << kLog2M);
  float* power = reinterpret_cast<float*>(after_slots + mel::buffer_bytes(kLog2M));
  float* out_tile = power + mel::round16(4 * kTile * kStride) / 4;
  const bool aligned = (reinterpret_cast<uintptr_t>(frames) & 15) == 0;

  auto issue = [&](int t, float* xs) {
    const long r0 = (long)t * kTile;
    const int n_rows = rows - r0 < kTile ? (int)(rows - r0) : kTile;
    const float* src = frames + r0 * n_fft;
    if (aligned) {
      const int chunks = stride / 4;
      for (int c = threadIdx.x; c < n_rows * chunks; c += blockDim.x) {
        const int f = c / chunks, i = 4 * (c - f * chunks);
        mel::cp_async16(xs + f * stride + i, src + (long)f * n_fft + i);
      }
    } else {
      for (int c = threadIdx.x; c < n_rows * stride; c += blockDim.x) {
        const int f = c / stride, i = c - f * stride;
        xs[c] = src[(long)f * n_fft + i];
      }
    }
  };
  mel::stage_table(smem_bytes, table, table_bytes);
  int t = blockIdx.x;
  issue(t, slots[0]);
  mel::cp_async_commit();
  for (int i = 0; t < n_tiles; ++i, t += gridDim.x) {
    const int next = t + gridDim.x;
    if (next < n_tiles) issue(next, slots[(i + 1) & 1]);
    mel::cp_async_commit();
    mel::cp_async_wait<1>();  // this tile's rows (and the table) have landed
    __syncthreads();
    const long r0 = (long)t * kTile;
    const int n_rows = rows - r0 < kTile ? (int)(rows - r0) : kTile;
    const float* xs = slots[i & 1];
    for (int f = warp; f < n_rows; f += kWarps)
      mel::frame_power<kLog2M>(xs + f * stride, smem_bytes, buf, power + f * kStride, win, lane);
    __syncthreads();
    mel::mel_tile(smem_bytes, power, kStride, n_rows, kTile, out_tile, n_mels, log_offset);
    __syncthreads();
    float* dst = out + r0 * n_mels;  // the tile's rows are contiguous
    for (int o = threadIdx.x; o < n_rows * n_mels; o += blockDim.x) dst[o] = out_tile[o];
    __syncthreads();  // the rows slot and out_tile are free again
  }
}

template <int kLog2M>
cudaError_t launch_fft(const float* frames, int rows, const char* table, int table_bytes, float* out,
                       int win, int n_mels, float log_offset, cudaStream_t stream) {
  const void* kernel = (const void*)mel_framed_fft_kernel<kLog2M>;
  const int threads = 32 * mel::warps(kLog2M);
  const size_t smem = (size_t)table_bytes + 2 * sizeof(float) * fft_tile(kLog2M) * ((win + 3) & ~3) +
                      mel::buffer_bytes(kLog2M) + mel::tile_bytes(fft_tile(kLog2M), kLog2M, n_mels);
  cudaError_t err = mel::set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (rows + fft_tile(kLog2M) - 1) / fft_tile(kLog2M);
  int grid = 0;
  err = mel::persistent_grid(kernel, threads, smem, n_tiles, &grid);
  if (err != cudaSuccess) return err;
  mel_framed_fft_kernel<kLog2M><<<grid, threads, smem, stream>>>(
      frames, rows, table, table_bytes, out, win, n_mels, log_offset, n_tiles);
  return cudaGetLastError();
}

__global__ void mel_framed_dft_kernel(
    const float* __restrict__ frames,  // [rows, span]
    int rows, int span,
    const float* __restrict__ cos_t,  // [win, n_bins], window folded in
    const float* __restrict__ sin_t,  // [win, n_bins]
    const float* __restrict__ mel_t,  // [n_bins, n_mels]
    float* __restrict__ out,          // [rows, n_mels]
    int win, int n_bins, int n_mels, float log_offset) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                      // [kTileDft, win]
  float* power = smem + kTileDft * win;  // [kTileDft, n_bins]

  const long r0 = (long)blockIdx.x * kTileDft;
  for (int i = threadIdx.x; i < kTileDft * win; i += blockDim.x) {
    const int f = i / win;
    const int t = i - f * win;
    const long r = r0 + f;
    xs[i] = (r < rows && t < span) ? frames[r * span + t] : 0.0f;
  }
  __syncthreads();

  for (int k = threadIdx.x; k < n_bins; k += blockDim.x) {
    float re[kTileDft], im[kTileDft];
#pragma unroll
    for (int f = 0; f < kTileDft; ++f) {
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
      for (int f = 0; f < kTileDft; ++f) {
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
    for (int f = 0; f < kTileDft; ++f) {
      power[f * n_bins + k] = re[f] * re[f] + im[f] * im[f];
    }
  }
  __syncthreads();

  for (int o = threadIdx.x; o < kTileDft * n_mels; o += blockDim.x) {
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

// FFT branch: frames [rows, n_fft] float32, n_fft a power of two, 128..2048;
// table: ops/mel_kernel.py::fft_table's packed constants (table_bytes, a
// multiple of 16, 16-byte aligned); out [rows, n_mels].
extern "C" int s2i_mel_framed_fft(const float* frames, int rows, int n_fft,
                                  const char* table, int table_bytes, float* out,
                                  int win, int n_mels, float log_offset,
                                  void* stream) {
  const int log2m = mel::fft_log2m(n_fft);
  if (rows <= 0 || win <= 0 || win > n_fft || n_mels <= 0 || log2m < 0 || table_bytes % 16 != 0 ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (log2m) {
#define S2I_MEL_CASE(L) \
  case L:               \
    return launch_fft<L>(frames, rows, table, table_bytes, out, win, n_mels, log_offset, s);
    S2I_MEL_CASE(6)
    S2I_MEL_CASE(7)
    S2I_MEL_CASE(8)
    S2I_MEL_CASE(9)
    S2I_MEL_CASE(10)
#undef S2I_MEL_CASE
  }
  return cudaErrorInvalidValue;
}

// DFT branch: frames [rows, span] float32; cos_t/sin_t [win, n_bins] with
// win a multiple of 4 (zero rows past the window); mel_t [n_bins, n_mels];
// out [rows, n_mels].
extern "C" int s2i_mel_framed_dft(const float* frames, int rows, int span,
                                  const float* cos_t, const float* sin_t,
                                  const float* mel_t, float* out, int win,
                                  int n_bins, int n_mels, float log_offset,
                                  void* stream) {
  if (rows <= 0 || span <= 0 || win <= 0 || win % 4 != 0 || n_bins <= 0 ||
      n_mels <= 0)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)kTileDft * (size_t)(win + n_bins);
  cudaError_t err = mel::set_smem((const void*)mel_framed_dft_kernel, smem);
  if (err != cudaSuccess) return err;
  int threads = ((n_bins + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const dim3 grid((rows + kTileDft - 1) / kTileDft);
  mel_framed_dft_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      frames, rows, span, cos_t, sin_t, mel_t, out, win, n_bins, n_mels,
      log_offset);
  return cudaGetLastError();
}

extern "C" const char* s2i_mel_framed_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
