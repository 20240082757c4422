// What the log-mel kernels (mel_fused.cu, mel_framed.cu) share on Hopper
// (sm_90a): the per-frame pipeline of their FFT branch, from a frame's
// float32 samples in shared memory to its log-mel row.
//
// A frame is `win` samples x[0..win) at t = 0..win-1 (not centred), zero-
// padded to n_fft = 2M, as filters.windowed_dft_matrices puts it. One warp
// takes one frame (frame_power):
//   1. pack: z[n] = w[2n] x[2n] + i w[2n+1] x[2n+1], n < M (the window w
//      from the table; zero past the window);
//   2. an M-point complex FFT, mixed-radix Stockham (auto-sorting, so no
//      bit reversal): radix-8 stages, then one radix-4 or radix-2 stage
//      (256 = 8·8·4). A stage is one pass through shared memory: each lane
//      loads the inputs of its butterflies into registers and twiddles
//      them, the warp syncs, and each lane runs its R-point DFTs in
//      registers and stores the outputs in place. Three passes at M = 256,
//      against eight for radix 2. The first stage reads the frame and the
//      window directly (step 1 is fused into it);
//   3. the real-FFT split step for bins k = 0..M:
//      X[k] = A_k Z[k] + B_k conj(Z[M-k]), A_k = (1 - i W^k)/2,
//      B_k = 1 - A_k, W = exp(-2πi/n_fft), then |X[k]|² to a row of power
//      spectra in shared memory. A lane takes the pair (k, M-k), which reads
//      the same two values of Z.
// Then the block (mel_tile): the sparse mel projection, filter m summing
// only its run [lo_m, hi_m) of the power spectrum against its own weights
// (an empty run gives log(offset)), and logf(mel + offset). Nothing between
// the frame and its log-mel row leaves shared memory.
//
// Precision: steps 1-3 run in float64 (the H100 issues float64 at half its
// float32 rate); the power is rounded to float32 and the mel sums of
// positive terms are float32, so the log-mel is the exact function of the
// float32 input to ~1e-6. In float32 the FFT's ~20 roundings along a bin's
// path left it ~2x further from the float64 arithmetic than the plain
// version's float32 DFT, and past the 1e-4 parity tolerance in low-power
// bins of the pre-emphasized hop-40 geometry (measured on an H100).
//
// The constants (split factors, each stage's twiddles, window: float64;
// the mel weights: float32, the plain version's own; the runs: int32) are
// computed on the host in float64 (ops/mel_kernel.py::fft_table), one
// packed buffer that a block copies into shared memory whole: no sin/cos on
// the device.
//
// Shared buffers are indexed through pad(i) = i + i/8 (one double2 of
// padding every 8): a 16-byte access serves 8 lanes per shared-memory
// cycle, and the first stage's stride-8 stores then fall in 8 distinct
// 16-byte bank groups; the stages' contiguous accesses start on multiples
// of 8 and stay conflict-free.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mel {

constexpr int kMinLog2M = 6;   // n_fft 128
constexpr int kMaxLog2M = 10;  // n_fft 2048

// The packed table (ops/mel_kernel.py::fft_table) starts with int32 words
// naming its size and the byte offset of each region (each a multiple of 16).
enum Header { kTableBytes = 0, kOffSplit, kOffTw, kOffWindow, kOffMelW, kOffMelIdx };

__host__ __device__ __forceinline__ int round16(int bytes) { return (bytes + 15) & ~15; }

// double2 slots of one padded M-point buffer (one per warp).
__host__ __device__ constexpr int padded(int m) { return m + m / 8; }

__device__ __forceinline__ int pad(int i) { return i + (i >> 3); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global → shared (both 16-byte aligned), L2 only.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue the copy of the packed table (a multiple of 16 bytes, 16-byte
// aligned) into shared memory; complete with cp_async_commit/wait.
__device__ __forceinline__ void stage_table(char* dst, const char* src, int bytes) {
  for (int i = 16 * threadIdx.x; i < bytes; i += 16 * blockDim.x) cp_async16(dst + i, src + i);
}

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ double2 cadd(double2 a, double2 b) { return make_double2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ double2 csub(double2 a, double2 b) { return make_double2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ double2 mul_neg_i(double2 a) { return make_double2(a.y, -a.x); }

// R-point forward DFT (exp(-2πi kn/R)) of v, in place, R = 2, 4 or 8.
template <int R>
__device__ __forceinline__ void dft_regs(double2* v);

template <>
__device__ __forceinline__ void dft_regs<2>(double2* v) {
  const double2 a = v[0], b = v[1];
  v[0] = cadd(a, b);
  v[1] = csub(a, b);
}

__device__ __forceinline__ void dft4(double2& x0, double2& x1, double2& x2, double2& x3) {
  const double2 t0 = cadd(x0, x2), t1 = csub(x0, x2);
  const double2 t2 = cadd(x1, x3), t3 = mul_neg_i(csub(x1, x3));
  x0 = cadd(t0, t2);
  x1 = cadd(t1, t3);
  x2 = csub(t0, t2);
  x3 = csub(t1, t3);
}

template <>
__device__ __forceinline__ void dft_regs<4>(double2* v) {
  dft4(v[0], v[1], v[2], v[3]);
}

template <>
__device__ __forceinline__ void dft_regs<8>(double2* v) {
  double2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
  double2 o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
  dft4(e0, e1, e2, e3);
  dft4(o0, o1, o2, o3);
  const double c = 0.70710678118654752440;  // cos(π/4)
  o1 = make_double2(c * (o1.x + o1.y), c * (o1.y - o1.x));   // · W_8
  o2 = mul_neg_i(o2);                                         // · W_8²
  o3 = make_double2(c * (o3.y - o3.x), -c * (o3.x + o3.y));  // · W_8³
  v[0] = cadd(e0, o0);
  v[1] = cadd(e1, o1);
  v[2] = cadd(e2, o2);
  v[3] = cadd(e3, o3);
  v[4] = csub(e0, o0);
  v[5] = csub(e1, o1);
  v[6] = csub(e2, o2);
  v[7] = csub(e3, o3);
}

// One Stockham stage of radix R over the warp's M-point buffer, in place,
// after stages whose radices multiply to ns: butterfly j reads
// buf[j + r·M/R], multiplies the r-th value by W^(r·k), W = exp(-2πi/(ns·R)),
// k = j mod ns (tw: this stage's table, [r-1][k]), and writes its DFT to
// buf[(j - k)·R + k + r·ns]. Every lane loads all its butterflies before
// the warp syncs and any lane stores. kFirst: the input is the packed,
// windowed frame x (ns = 1, no twiddles); window: (w[2n], w[2n+1]) pairs.
template <int M, int R, bool kFirst>
__device__ __forceinline__ void stage(double2* buf, int ns, const double2* tw, const float* x,
                                      const double2* window, int win, int lane) {
  constexpr int kPerLane = (M / R + 31) / 32;  // butterflies per lane
  const bool x_even = kFirst && (reinterpret_cast<uintptr_t>(x) & 7) == 0;  // pairs load as float2
  double2 v[kPerLane][R];
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    const int j = lane + 32 * q;
    if (j >= M / R) break;
    const int k = j & (ns - 1);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = j + r * (M / R);
      if (kFirst) {
        const int t = 2 * n;
        if (t + 1 < win) {
          const double2 w = window[n];
          const float2 xx = x_even ? reinterpret_cast<const float2*>(x)[n] : make_float2(x[t], x[t + 1]);
          v[q][r] = make_double2((double)xx.x * w.x, (double)xx.y * w.y);
        } else {
          v[q][r] = make_double2(t < win ? (double)x[t] * window[n].x : 0.0, 0.0);
        }
      } else {
        v[q][r] = buf[pad(n)];
        if (r > 0) v[q][r] = cmul(v[q][r], tw[(r - 1) * ns + k]);
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    const int j = lane + 32 * q;
    if (j >= M / R) break;
    const int k = j & (ns - 1);
    dft_regs<R>(v[q]);
    const int base = (j - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) buf[pad(base + r * ns)] = v[q][r];
  }
  __syncwarp();
}

// The M-point FFT of the packed frame into buf (natural order): radix-8
// stages, then a radix-4 or radix-2 one; tw: the stages' twiddle tables
// after the first, end to end.
template <int kLog2M>
__device__ __forceinline__ void fft(double2* buf, const double2* tw, const float* x, const double2* window,
                                    int win, int lane) {
  constexpr int M = 1 << kLog2M;
  constexpr int kEights = kLog2M / 3;
  constexpr int kRest = kLog2M % 3;
  stage<M, 8, true>(buf, 1, tw, x, window, win, lane);
  int ns = 8;
#pragma unroll
  for (int s = 1; s < kEights; ++s) {
    stage<M, 8, false>(buf, ns, tw, x, window, win, lane);
    tw += 7 * ns;
    ns *= 8;
  }
  if (kRest == 2) stage<M, 4, false>(buf, ns, tw, x, window, win, lane);
  if (kRest == 1) stage<M, 2, false>(buf, ns, tw, x, window, win, lane);
}

// One frame, one warp: x (the frame's first sample, shared memory) →
// power[0..M] (float, shared memory), |X[k]|² of the windowed frame. tab:
// the packed table in shared memory; buf: the warp's padded M-point buffer.
template <int kLog2M>
__device__ __forceinline__ void frame_power(const float* x, const char* tab, double2* buf, float* power,
                                            int win, int lane) {
  constexpr int M = 1 << kLog2M;
  const int* hdr = reinterpret_cast<const int*>(tab);
  fft<kLog2M>(buf, reinterpret_cast<const double2*>(tab + hdr[kOffTw]), x,
              reinterpret_cast<const double2*>(tab + hdr[kOffWindow]), win, lane);

  // split: lane takes the pairs (k, M-k), k = 0..M/2, which read the same
  // Z[k] = p and Z[M-k] = c (Z[M] = Z[0]). With A_k = a from the table,
  // B_k = 1 - A_k, A_{M-k} = conj(A_k) and B_{M-k} = conj(B_k):
  //   X[k]   = A_k p + B_k conj(c)        = conj(c) + a (p - conj(c))
  //   X[M-k] = conj(A_k) c + conj(B_k) conj(p) = conj(p) + conj(a) (c - conj(p))
  // so with d = p.x - c.x, e = p.y + c.y both take four products.
  const double2* split = reinterpret_cast<const double2*>(tab + hdr[kOffSplit]);  // A_k, k = 0..M/2
  for (int k = lane; k <= M / 2; k += 32) {
    const double2 a = split[k];
    const double2 p = buf[pad(k)], c = buf[pad((M - k) & (M - 1))];
    const double d = p.x - c.x, e = p.y + c.y;
    const double xr = fma(a.x, d, fma(-a.y, e, c.x));
    const double xi = fma(a.x, e, fma(a.y, d, -c.y));
    const double yr = fma(-a.x, d, fma(a.y, e, p.x));
    const double yi = fma(a.x, e, fma(a.y, d, -p.y));
    power[k] = (float)fma(xr, xr, xi * xi);
    power[M - k] = (float)fma(yr, yr, yi * yi);  // k = M/2: its own bin twice, the same value
  }
  __syncwarp();  // buf is read before the warp's next frame overwrites it
}

// The block's mel projection and log of n_rows power spectra (power: row f
// at f·stride, stride odd so that a warp's rows fall in distinct banks) into
// out_tile [n_rows, n_mels] in shared memory. Item (m, f), f fastest: the
// lanes of a warp read one filter's weights (a broadcast) and the same bin
// of consecutive rows. The sums are float32: at most a few dozen positive
// terms, so ~1e-7 relative.
__device__ __forceinline__ void mel_tile(const char* tab, const float* power, int stride, int n_rows,
                                         int tile, float* out_tile, int n_mels, float log_offset) {
  const int* hdr = reinterpret_cast<const int*>(tab);
  const float* mel_w = reinterpret_cast<const float*>(tab + hdr[kOffMelW]);
  const int* mel_idx = reinterpret_cast<const int*>(tab + hdr[kOffMelIdx]);
  for (int it = threadIdx.x; it < tile * n_mels; it += blockDim.x) {
    const int m = it / tile, f = it - m * tile;
    if (f >= n_rows) continue;
    const int lo = mel_idx[3 * m], hi = mel_idx[3 * m + 1];
    const float* w = mel_w + mel_idx[3 * m + 2] - lo;
    const float* p = power + f * stride;
    float acc[2] = {0.0f, 0.0f};
    int k = lo;
    for (; k + 2 <= hi; k += 2) {
      acc[0] = fmaf(p[k], w[k], acc[0]);
      acc[1] = fmaf(p[k + 1], w[k + 1], acc[1]);
    }
    if (k < hi) acc[0] = fmaf(p[k], w[k], acc[0]);
    out_tile[f * n_mels + m] = logf(acc[0] + acc[1] + log_offset);
  }
}

// Power spectrum rows in shared memory: M + 1 floats, padded to an odd stride.
__host__ __device__ constexpr int power_stride(int log2m) { return (1 << log2m) + 1; }

// cudaErrorInvalidValue past the card's per-block shared memory, else sets
// the kernel's dynamic shared memory limit.
__host__ inline cudaError_t set_smem(const void* kernel, size_t bytes) {
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)smem_max) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Warps per block: 8 up to M = 256; fewer for the larger FFTs, whose
// buffers and constants would not fit 8 warps in a block's shared memory.
__host__ __device__ constexpr int warps(int log2m) { return log2m <= 8 ? 8 : (log2m == 9 ? 4 : 2); }

// Shared-memory bytes of the warps' FFT buffers.
__host__ __device__ constexpr size_t buffer_bytes(int log2m) {
  return (size_t)warps(log2m) * padded(1 << log2m) * sizeof(double2);
}

// Shared-memory bytes of a tile's power spectra and log-mel rows.
__host__ __device__ inline size_t tile_bytes(int tile, int log2m, int n_mels) {
  return (size_t)round16(4 * tile * power_stride(log2m)) + (size_t)round16(4 * tile * n_mels);
}

// Blocks of a persistent launch: as many as stay resident on the card, at
// most one per tile. 0 (and an error) if none fits.
__host__ inline cudaError_t persistent_grid(const void* kernel, int threads, size_t smem, int tiles, int* grid) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  *grid = tiles < sms * per_sm ? tiles : sms * per_sm;
  return cudaSuccess;
}

// log2(n_fft/2) when the FFT branch takes n_fft, else -1.
__host__ inline int fft_log2m(int n_fft) {
  for (int l = kMinLog2M; l <= kMaxLog2M; ++l)
    if (n_fft == 2 << l) return l;
  return -1;
}

}  // namespace mel
