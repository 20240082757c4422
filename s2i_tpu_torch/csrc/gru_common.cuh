// What the GRU recurrence kernels (gru_fwd.cu, gru_bwd.cu) share on Hopper
// (sm_90a): the per-step exchange of a chain's rows through L2 into shared
// memory, the barrier that orders it, and the step product with W_h in
// registers.
//
// A chain is one (direction, row group) pair of a layer: R batch rows walked
// over T steps by the blocks that own the chain's hidden units. The chains of
// a launch are independent. A chain's blocks are grouped into thread block
// clusters of kCluster blocks. Each step:
//   1. every block writes its share of the step's result (ys[t] in the
//      forward, dhg[t] in the backward) with ordinary stores, then every
//      thread issues `fence.proxy.async`, so that the bulk copies of step 3
//      (the async proxy) see those writes and do not overwrite shared memory
//      still being read;
//   2. one thread per block adds one to the chain's counter with a release
//      and spins on it with an acquire until every block of the chain has
//      arrived (chain_barrier). One atomic per block measured faster than a
//      cluster barrier followed by one atomic per cluster;
//   3. each block issues `cp.async.bulk ... .multicast::cluster` copies of
//      every kCluster-th row of the step's rows, into the same place in the shared
//      memory of every block of its cluster: the cluster reads each row from
//      L2 once, not once per block. Each block's `mbarrier` expects the bytes
//      of all rows (`expect_tx`) and completes when they have landed; its
//      phase parity flips once per use.
// A spin that lasts longer than kSpinLimit clocks traps instead of hanging.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace gru {

// ~8 s at 1.98 GHz: a wait that lasts longer traps instead of hanging.
constexpr long long kSpinLimit = 1LL << 34;

// Blocks per cluster. 4, not the portable 8: the card keeps more 4-block
// clusters resident at one block per SM, so a chain pads fewer blocks and
// each block owns fewer units; measured on an H100, 4 was as fast or faster
// than 8 for both kernels at every batch (8 was 1.4-1.5x slower at B=64;
// PERF.md §6).
constexpr int kCluster = 4;

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// Row stride (floats) of rows staged in shared memory: 16-byte aligned and
// 4 banks apart, so a warp's float4 reads of consecutive rows at one column
// fall in different banks.
__host__ __device__ __forceinline__ int stage_stride(int n) { return (n + 31) / 32 * 32 + 4; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster: the writes before it are
// visible in the cluster after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// This thread's generic-proxy accesses before it (global and shared) are
// ordered with async-proxy (bulk copy) accesses after it.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async;" ::: "memory"); }

// fence_proxy_async, then cluster_sync: what every thread of the cluster
// read or wrote before it is done before any bulk copy issued after it.
__device__ __forceinline__ void cluster_sync_for_copies() {
  fence_proxy_async();
  cluster_sync();
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One thread per block and use: the arrival that, with `bytes` landed,
// completes the barrier's current phase.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Wait for the completion of the phase with this parity (0 for the first use).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kSpinLimit) __trap();
  }
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// memory to `dst` in every block of the cluster, completing on each block's
// `bar` at the same offset.
__device__ __forceinline__ void bulk_multicast(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  const uint16_t all = (1u << kCluster) - 1;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1], %2, [%3], %4;" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(all)
      : "memory");
}

// Rows [0, rows) of `src` (row stride `ld` floats, `width` floats each) into
// `dst` (row stride `stride`) of every block of the cluster: this block
// issues rows rank, rank + kCluster, ...; `bar` expects all rows. One thread.
__device__ __forceinline__ void stage_rows(float* dst, int stride, const float* src, long ld,
                                           int rows, int width, uint64_t* bar) {
  const uint32_t bytes = static_cast<uint32_t>(width) * sizeof(float);
  mbar_expect(bar, bytes * rows);
  for (int r = cluster_rank(); r < rows; r += kCluster) bulk_multicast(dst + r * stride, src + r * ld, bytes, bar);
}

// The step barrier of one chain. Call with every thread of the block: each
// thread orders its global writes with the bulk copies to come, one thread
// per block arrives with a release, and one per block spins with an acquire
// until the chain's counter shows every block. The counter only grows, so
// the k-th call waits for k * blocks arrivals and nobody resets it.
__device__ __forceinline__ void chain_barrier(unsigned int* count, unsigned int target) {
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(count) : "memory");
    const long long t0 = clock64();
    for (;;) {
      unsigned int v;
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(count) : "memory");
      if (v >= target) break;
      if (clock64() - t0 > kSpinLimit) __trap();
    }
    fence_proxy_async();  // the other blocks' writes, for this block's bulk copies
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// Wait until at most `n` of this thread's committed groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(n) : "memory");
}

// The step product of both kernels, out[r][c] = sum over k < K of
// a_s[r][k] * W[k][c], with W in registers for all T steps. Thread
// (cg, ks) keeps w[4 * i + e][q] = W[4 * (ks + ns * i) + e][4 * cg + q]
// (zero past K and past the block's columns), i < kSlice / 4: four columns
// of a strided slice of 16 k. A row then costs it four float4 reads of a_s
// and 64 FMAs, each value read feeding four. The 16 lanes of a lane group
// share cg and hold consecutive slices ks = 16 * ks_hi + ks_lo, so their
// reads of a row are 16 consecutive 16-byte pieces, and their four column
// sums are added by a butterfly of five shuffles in a fixed order. Group
// ks_hi's sums go to red[(ks_hi * R4 + r) * n_col + c]; ns is a multiple
// of 16, and the block has n_col / 4 * ns threads rounded up to a warp.
constexpr int kSlice = 16;

struct ProductLane {
  int cg, ks, ks_lo, ks_hi;
  __device__ ProductLane(int n_col, int ns) {
    const int group = threadIdx.x / 16, n_cg = n_col / 4;
    ks_lo = threadIdx.x % 16;
    ks_hi = group / n_cg;
    cg = group - ks_hi * n_cg;
    if (ks_hi >= ns / 16) ks_hi = 0;  // the idle lanes of a last half warp: read, never write
    ks = ks_hi * 16 + ks_lo;
  }
};

// w from load(k, c): W[k][c] for k < K and the block's columns, else 0.
template <typename Load>
__device__ __forceinline__ void load_slice(float (&w)[kSlice][4], const ProductLane& p, int ns, Load load) {
#pragma unroll
  for (int i = 0; i < kSlice; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) w[i][q] = load(4 * (p.ks + ns * (i / 4)) + i % 4, 4 * p.cg + q);
}

// Rows [0, n) of a_s (row stride `stride`; rows up to n rounded to 4 exist)
// into red rows [red_row0, red_row0 + n rounded to 2). `n_active`: the
// threads that own a slice (the rest compute and do not write).
__device__ __forceinline__ void product_rows(const float* a_s, int stride, int n, const float (&w)[kSlice][4],
                                             const ProductLane& p, int ns, int n_active, float* red, int R4,
                                             int n_col, int red_row0) {
  const bool b3 = p.ks_lo & 8, b2 = p.ks_lo & 4;
  const bool writes = (int)threadIdx.x < n_active && (p.ks_lo & 3) == 0;
  const int col = 4 * p.cg + 2 * b3 + b2;  // the column this lane's sum ends in
  for (int r0 = 0; r0 < n; r0 += 2) {
    float acc[2][4] = {};
#pragma unroll
    for (int i = 0; i < kSlice / 4; ++i) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float4 v = *reinterpret_cast<const float4*>(a_s + (r0 + rr) * stride + 4 * (p.ks + ns * i));
        const float ve[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[rr][q] = fmaf(ve[e], w[4 * i + e][q], acc[rr][q]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      // lanes 8 apart: keep columns {0, 1} or {2, 3}, add the partner's
      float k0 = b3 ? acc[rr][2] : acc[rr][0], k1 = b3 ? acc[rr][3] : acc[rr][1];
      k0 += __shfl_xor_sync(0xffffffffu, b3 ? acc[rr][0] : acc[rr][2], 8);
      k1 += __shfl_xor_sync(0xffffffffu, b3 ? acc[rr][1] : acc[rr][3], 8);
      // lanes 4 apart: keep one column; then the four lanes of a column
      float k = b2 ? k1 : k0;
      k += __shfl_xor_sync(0xffffffffu, b2 ? k0 : k1, 4);
      k += __shfl_xor_sync(0xffffffffu, k, 2);
      k += __shfl_xor_sync(0xffffffffu, k, 1);
      if (writes) red[((long)p.ks_hi * R4 + red_row0 + r0 + rr) * n_col + col] = k;
    }
  }
}

// Slices of 16 k (a multiple of 16) that cover K.
__host__ __device__ inline int slices(int K) { return ((K + kSlice - 1) / kSlice + 15) / 16 * 16; }

inline int device_attr(cudaDeviceAttr attr) {
  int device = 0, v = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&v, attr, device);
  return v;
}

// Dynamic shared memory to ask for: at least half an SM's, so that no two
// blocks of a chain launch share an SM.
inline size_t one_block_per_sm(size_t smem) {
  const size_t half = device_attr(cudaDevAttrMaxSharedMemoryPerMultiprocessor) / 2 + 16;
  return smem > half ? smem : half;
}

// A cooperative launch of `blocks` blocks in clusters, or an error before
// launching if they cannot all be resident at once (a chain's blocks wait
// for each other, so a block that never starts would hang them).
template <typename Kernel, typename Args>
cudaError_t launch_chains(Kernel kernel, int blocks, int threads, size_t smem, cudaStream_t stream,
                          const Args& args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = kCluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if ((long)clusters * kCluster < blocks) return cudaErrorCooperativeLaunchTooLarge;
  return cudaLaunchKernelEx(&cfg, kernel, args);
}

// Most clusters of blocks of `threads` threads and `smem` bytes that can be
// resident at once (0 if the block does not fit).
template <typename Kernel>
int max_clusters(Kernel kernel, int threads, size_t smem) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) != cudaSuccess)
    return 0;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return clusters;
}

}  // namespace gru
