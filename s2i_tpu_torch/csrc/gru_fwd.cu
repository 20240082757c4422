// GRU forward recurrence for Hopper (sm_90a): all T steps in one launch.
//
// Replaces: the Pallas TPU kernel `_fwd_kernel` in s2i_tpu/ops/gru_kernel.py
// (reached through `_fwd_call` / `fused_gru`). Same contract: the input
// projections xw [T, B, 3H] are precomputed outside, W_h [H, 3H] and b_h
// [3H] stay resident, gates are r|z|n with b_hn inside r*(...), and a step
// whose mask is 0 carries h through unchanged.
//
// What bounds it on this card: neither bytes nor operations but the chain
// of T dependent steps. One step at H=512, B=8 is 2*8*512*1536 = 12.6 MFLOP
// (0.2 us of the card's fp32 peak) and reads 3 MB of W_h; the step cannot
// start before every hidden unit of the previous one is known.
//
// Design: a cooperative persistent kernel. The launch holds at most one
// block per SM (cudaLaunchCooperativeKernel guarantees they are all
// resident). Block i owns U hidden units and keeps the 3U columns of W_h
// that feed them in shared memory for the whole sequence (3*4*512*4 B =
// 24 KB at H=512, U=4), so W_h is read from device memory once per launch,
// not once per step. Every step the block
//   1. stages h_{t-1} [B, H] in shared memory (read with ld.global.cg from
//      ys[t-1], or h0, so L1 never serves another block's stale line),
//      together with its own columns of xw[t] and the mask of step t,
//   2. computes its 3U columns of h_{t-1} @ W_h + b_h (one warp per column,
//      lanes split H, a shuffle reduction per batch row),
//   3. applies the gates and the mask freeze to its U units and writes
//      ys[t] for them,
// and a grid-wide barrier (one atomic counter and a generation word) ends
// the step. h_t is never kept anywhere but ys[t], which doubles as the
// carry: no second buffer is needed.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 8;  // batch rows a warp accumulates per pass
// ~8 s at 1.98 GHz: a barrier that waits longer traps instead of hanging.
constexpr long long kSpinLimit = 1LL << 34;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ void grid_barrier(unsigned int* count, unsigned int* gen,
                             unsigned int n_blocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* vgen = gen;
    const unsigned int my_gen = *vgen;
    __threadfence();  // this block's ys writes are visible before arriving
    if (atomicAdd(count, 1u) == n_blocks - 1) {
      atomicExch(count, 0u);  // reset before the release below
      __threadfence();
      atomicAdd(gen, 1u);
    } else {
      const long long t0 = clock64();
      while (*vgen == my_gen) {
        if (clock64() - t0 > kSpinLimit) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

__global__ void gru_fwd_kernel(const float* __restrict__ xw,    // [T, B, 3H]
                               const float* __restrict__ wh,    // [H, 3H]
                               const float* __restrict__ bh,    // [3H]
                               const float* __restrict__ mask,  // [T, B]
                               const float* __restrict__ h0,    // [B, H]
                               float* ys,                       // [T, B, H]
                               unsigned int* barrier,           // [2], zeroed
                               int T, int B, int H, int U) {
  extern __shared__ __align__(16) float smem[];
  const int J = 3 * U;        // gate columns this block owns
  float* w_s = smem;          // [J, H]: column j of the slice, stored as a row
  float* h_s = w_s + J * H;   // [B, H]: h_{t-1}
  float* hw_s = h_s + B * H;  // [B, J]: h_{t-1} @ W_slice + b_slice
  float* x_s = hw_s + B * J;  // [B, J]: this step's xw for the block's columns
  float* m_s = x_s + B * J;   // [B]: this step's mask
  const int u0 = blockIdx.x * U;
  const int H3 = 3 * H;
  const bool vec4 = (B * H) % 4 == 0;

  // Slice column j = g*U + uu is W_h column g*H + u0 + uu (zero past H).
  for (int i = threadIdx.x; i < J * H; i += blockDim.x) {
    const int k = i / J, j = i - k * J;
    const int g = j / U, u = u0 + (j - g * U);
    w_s[j * H + k] = u < H ? wh[(long)k * H3 + g * H + u] : 0.0f;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int t = 0; t < T; ++t) {
    // Stage h_{t-1} and this step's inputs together, so their latencies
    // overlap instead of adding up.
    const float* hp = t == 0 ? h0 : ys + (long)(t - 1) * B * H;
    if (vec4) {
      const float4* hp4 = reinterpret_cast<const float4*>(hp);
      float4* h_s4 = reinterpret_cast<float4*>(h_s);
      for (int i = threadIdx.x; i < B * H / 4; i += blockDim.x) h_s4[i] = __ldcg(hp4 + i);
    } else {
      for (int i = threadIdx.x; i < B * H; i += blockDim.x) h_s[i] = __ldcg(hp + i);
    }
    for (int i = threadIdx.x; i < B * J; i += blockDim.x) {
      const int b = i / J, j = i - b * J;
      const int g = j / U, u = u0 + (j - g * U);
      x_s[i] = u < H ? xw[((long)t * B + b) * H3 + g * H + u] : 0.0f;
    }
    for (int b = threadIdx.x; b < B; b += blockDim.x) m_s[b] = mask[(long)t * B + b];
    __syncthreads();

    for (int j = warp; j < J; j += n_warps) {
      const float* wj = w_s + j * H;
      const int g = j / U, u = u0 + (j - g * U);
      const float bias = u < H ? bh[g * H + u] : 0.0f;
      for (int b0 = 0; b0 < B; b0 += kRows) {
        float acc[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
        for (int k = lane; k < H; k += 32) {
          const float w = wj[k];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            if (b0 + r < B) acc[r] = fmaf(h_s[(b0 + r) * H + k], w, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
        }
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            if (b0 + r < B) hw_s[(b0 + r) * J + j] = acc[r] + bias;
        }
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < B * U; i += blockDim.x) {
      const int b = i / U, uu = i - b * U, u = u0 + uu;
      if (u >= H) continue;
      const float* x = x_s + b * J;
      const float* hw = hw_s + b * J;
      const float r = sigmoid(x[uu] + hw[uu]);
      const float z = sigmoid(x[U + uu] + hw[U + uu]);
      const float n = tanhf(x[2 * U + uu] + r * hw[2 * U + uu]);
      const float h_prev = h_s[b * H + u];
      const float h_new = (1.0f - z) * n + z * h_prev;
      ys[((long)t * B + b) * H + u] = m_s[b] > 0.0f ? h_new : h_prev;
    }
    if (t + 1 < T) grid_barrier(barrier, barrier + 1, gridDim.x);
  }
}

}  // namespace

// units_per_block: hidden units each block owns; the grid is
// ceil(H / units_per_block) blocks and must fit on the card at once.
extern "C" int s2i_gru_fwd(const float* xw, const float* wh, const float* bh,
                           const float* mask, const float* h0, float* ys,
                           unsigned int* barrier, int T, int B, int H,
                           int units_per_block, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || units_per_block <= 0) return cudaErrorInvalidValue;
  const int U = units_per_block;
  const int J = 3 * U;
  const int grid = (H + U - 1) / U;
  const int threads = 32 * (J < 32 ? J : 32);
  const size_t smem = sizeof(float) * ((size_t)J * H + (size_t)B * H + 2 * (size_t)B * J + B);
  int device = 0, smem_max = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (smem > (size_t)smem_max) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gru_fwd_kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if ((long)per_sm * n_sm < grid) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {(void*)&xw, (void*)&wh, (void*)&bh, (void*)&mask,
                  (void*)&h0, (void*)&ys, (void*)&barrier, (void*)&T,
                  (void*)&B, (void*)&H, (void*)&U};
  err = cudaLaunchCooperativeKernel((const void*)gru_fwd_kernel, dim3(grid),
                                    dim3(threads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

extern "C" int s2i_gru_fwd_max_batch(int H, int units_per_block) {
  int device = 0, smem_max = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  const long J = 3L * units_per_block;
  const long free_floats = smem_max / (long)sizeof(float) - J * H;
  return free_floats > 0 ? (int)(free_floats / (H + 2 * J + 1)) : 0;
}

extern "C" const char* s2i_gru_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
