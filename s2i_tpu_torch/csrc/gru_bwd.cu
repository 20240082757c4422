// GRU backward recurrence for Hopper (sm_90a): the gradient of gru_fwd.cu.
//
// Replaces: the Pallas TPU kernel `_bwd_kernel` in s2i_tpu/ops/gru_kernel.py
// (reached through `_bwd_call` / `_fused_gru_bwd`, the custom VJP of
// `fused_gru`). Same contract: from the forward's inputs and its output ys
// (the only saved tensor), and the incoming dys, it gives dxw [T, B, 3H],
// dW_h [H, 3H], db_h [3H] and dh0 [B, H]. The gates are recomputed from
// (xw[t], h_{t-1}); a step whose mask is 0 passes dh straight through.
//
// What bounds it on this card: on paper, operations. Three products of
// 2*T*B*H*3H each (the gate recompute h_{t-1} @ W_h, the carry dhg @ W_h^T
// and dW_h = sum h_{t-1}^T dhg) are 38.7 GFLOP at T=128, B=64, H=512, or
// 0.58 ms of the card's fp32 peak, against ~141 MB moved (0.04 ms). In
// practice the carry's chain of T dependent steps sets the pace, as in K2:
// each step needs the whole of dhg[t] of a row before any dh_{t-1} of it.
//
// Design: only the carry is sequential, so only the carry runs step by step.
//   1. gates: one tiled SGEMM (128x128 tiles, 8x8 per thread, two shared
//      memory buffers) computes h_{t-1} @ W_h + b_h for all T*B rows at
//      once, into dxw, which doubles as its scratch (h_{t-1} is ys shifted
//      one step, h0 first).
//   2. chain: a cooperative persistent kernel, at most one block per SM.
//      Block (u, g) owns R batch rows and U hidden units (16 x 16 at B=64,
//      H=512: 128 blocks), one (row, unit) pair per thread, and keeps the U
//      rows of W_h it needs, transposed, in shared memory for all T steps.
//      Each step (t = T-1 .. 0) it
//        a. applies the gates to its pairs, from inputs fetched during the
//           previous step, and writes dxw[t] (in place over the gate
//           pre-activations) and dhg[t] = [dr, dz, dn*r] for its 3U columns;
//        b. meets the other blocks of its row group (the row groups are
//           independent scans) at a count-up barrier: one atomic per block;
//        c. copies dhg[t] of its R rows into shared memory with 16-byte
//           cp.async.cg (L2 only, so no stale L1 line; 512 contiguous bytes
//           per warp);
//        d. forms dh_{t-1} = dh_upd*z + dh_skip + dhg[t] @ W_h^T for its
//           pairs: 4x4 register tiles over 4 j at a time, split over the
//           3H sum, the splits added in a fixed order.
//      The carry never leaves the block. Splitting rows as well as units
//      keeps each block's share of dhg[t] at R*3H instead of B*3H: the copy
//      in c. is what the L2 can serve to 128 blocks at once.
//   3. dW_h = sum over T*B rows of h_{t-1}^T dhg: the same SGEMM, split
//      over the T*B sum into fixed chunks whose partial sums are then added
//      in order; db_h is a column sum of dhg. No atomics on data anywhere,
//      so the result is the same every run.
// Full fp32 FMA on the CUDA cores, no TF32.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // chain block size
// ~8 s at 1.98 GHz: a barrier that waits longer traps instead of hanging.
constexpr long long kSpinLimit = 1LL << 34;
// SGEMM tile: BM x BN outputs per block, BK deep, TM x TN per thread.
constexpr int BM = 128, BN = 128, BK = 8, TM = 8, TN = 8;
constexpr int kGemmThreads = (BM / TM) * (BN / TN);

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Wait until `target` arrivals have been counted on `count`, this block's
// included: the k-th barrier of a group of n blocks waits for k*n. The
// counter only grows, so no block has to reset it for the next step.
__device__ void grid_sync(unsigned int* count, unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // this block's dhg writes are visible before arriving
    atomicAdd(count, 1u);
    volatile unsigned int* v = count;
    const long long t0 = clock64();
    while (*v < target) {
      if (clock64() - t0 > kSpinLimit) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// Row stride of the staged dhg rows: 16-byte aligned, and 4 banks apart, so
// that a warp's reads of rows rt + a*R4/4 (rt = 0..3) at one j never collide.
__host__ __device__ __forceinline__ int stage_stride(int H) {
  return (3 * H + 31) / 32 * 32 + 4;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned int d = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Row i of h_{t-1} over all T*B rows: h0 for the first B rows, then ys.
struct PrevRows {
  const float* h0;
  const float* ys;
  int n_head;  // B
  int ld;      // H
  __device__ __forceinline__ const float* operator()(long i) const {
    return i < n_head ? h0 + i * ld : ys + (i - n_head) * ld;
  }
};

// c[z] [M, N] (row-major, ldc) = sum over k in chunk z of A(m, k) * b[k, n]
// (+ bias[n]), with A(m, k) = a(m)[k], or a(k)[m] when a_trans. Every
// thread loads one 16-byte piece of A and one of B per tile (so M or K, N
// and the leading dimensions are multiples of 4), and owns the 8x8 outputs
// at rows {4ty, 64+4ty} + 0..3 and columns {4tx, 64+4tx} + 0..3, so a
// warp's shared memory reads are contiguous. Two shared memory buffers:
// the next tile's loads are in flight while this one's products run.
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(
    PrevRows a, int a_trans, const float* __restrict__ b, int ldb,
    const float* __restrict__ bias, float* __restrict__ c, int ldc,
    long c_stride_z, int M, int N, int K, int k_chunk) {
  __shared__ __align__(16) float as[2][BK][BM];
  __shared__ __align__(16) float bs[2][BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  // this thread's pieces: A at (am, ak..ak+3) or (ak, am..am+3), B at (bk, bn..bn+3)
  const int am = a_trans ? (tid % 32) * 4 : tid / 2, ak = a_trans ? tid / 32 : (tid % 2) * 4;
  const int bk = tid / 32, bn = (tid % 32) * 4;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 ra, rb;
  auto load = [&](int k0) {
    const int m = m0 + am, k = k0 + ak;
    ra = m < M && k < k_end ? *reinterpret_cast<const float4*>(a_trans ? a(k) + m : a(m) + k) : zero;
    const int kb = k0 + bk, n = n0 + bn;
    rb = kb < k_end && n < N ? *reinterpret_cast<const float4*>(b + (long)kb * ldb + n) : zero;
  };
  auto store = [&](int buf) {
    if (a_trans) {
      *reinterpret_cast<float4*>(&as[buf][ak][am]) = ra;
    } else {
      as[buf][ak][am] = ra.x;
      as[buf][ak + 1][am] = ra.y;
      as[buf][ak + 2][am] = ra.z;
      as[buf][ak + 3][am] = ra.w;
    }
    *reinterpret_cast<float4*>(&bs[buf][bk][bn]) = rb;
  };
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  if (k_begin < k_end) {
    load(k_begin);
    store(0);
  }
  __syncthreads();
  int buf = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += BK, buf ^= 1) {
    const bool more = k0 + BK < k_end;
    if (more) load(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[buf][kk][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[buf][kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[buf][kk][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[buf][kk][64 + 4 * tx]);
      const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) store(buf ^ 1);  // the other buffer: last read before the previous sync
    __syncthreads();
  }

  float* cz = c + blockIdx.z * c_stride_z;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 64 * h + 4 * tx;
      if (n >= N) continue;
      float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      if (bias) {
        v.x += bias[n];
        v.y += bias[n + 1];
        v.z += bias[n + 2];
        v.w += bias[n + 3];
      }
      *reinterpret_cast<float4*>(cz + (long)m * ldc + n) = v;
    }
  }
}

// The reverse scan over T steps for batch rows [row0, row0 + n_rows).
__global__ void __launch_bounds__(kThreads) gru_bwd_chain_kernel(
    const float* __restrict__ xw,    // [T, B, 3H]
    const float* __restrict__ wh,    // [H, 3H]
    const float* __restrict__ mask,  // [T, B]
    const float* __restrict__ h0,    // [B, H]
    const float* __restrict__ ys,    // [T, B, H]
    const float* __restrict__ dys,   // [T, B, H]
    float* dxw,                      // [T, B, 3H]: in, h_{t-1} @ W_h + b_h; out, dxw
    float* dhg,                      // [T, B, 3H]: out, [dr, dz, dn*r]
    float* __restrict__ dh0,         // [B, H]
    unsigned int* barrier,           // [gridDim.y], zeroed
    int T, int B, int H, int row0, int n_rows, int R, int U) {
  extern __shared__ __align__(16) float smem[];
  const int R4 = (R + 3) & ~3, U4 = (U + 3) & ~3;
  const int H3 = 3 * H;
  const int RU = R4 * U4;
  const int n_tiles = (R4 / 4) * (U4 / 4);
  const int n_split = blockDim.x / n_tiles;  // the host makes this >= 1
  const int S = stage_stride(H);
  const int RS = (R4 / 4) * S;            // a thread's rows are rt + a * R4/4, a = 0..3
  float* w_s = smem;                      // [H3][U4]: W_h[u0 + uu][j] at j*U4 + uu
  float* g_s = w_s + (long)H3 * U4;      // [R4][S]: dhg[t][b0 + rr][j] at rr*S + j
  float* red_s = g_s + (long)R4 * S;      // [n_split][R4*U4]: partial sums
  float* dh_s = red_s + n_split * RU;     // [R4*U4]: the dh carry
  float* base_s = dh_s + RU;              // [R4*U4]: dh_upd*z + dh_skip
  const int tid = threadIdx.x;
  const int b0 = row0 + blockIdx.y * R;
  const int u0 = blockIdx.x * U;
  const int rows = min(R, row0 + n_rows - b0);
  const int units = min(U, H - u0);

  // W_h rows u0 .. u0+U, read along the row (coalesced), stored transposed
  for (int i = tid; i < U4 * H3; i += blockDim.x) {
    const int uu = i / H3, j = i - uu * H3;
    w_s[j * U4 + uu] = uu < units ? wh[(long)(u0 + uu) * H3 + j] : 0.0f;
  }
  for (int i = tid; i < RU; i += blockDim.x) {
    dh_s[i] = 0.0f;
    base_s[i] = 0.0f;
  }
  for (int i = tid; i < R4 * S; i += blockDim.x) g_s[i] = 0.0f;  // padding rows and columns stay 0
  __syncthreads();

  const int tile = tid % n_tiles, split = tid / n_tiles;
  const int rt = tile / (U4 / 4), ut = tile - rt * (U4 / 4);
  // one (row, unit) pair per thread (the host makes rows * units <= kThreads)
  const bool owner = tid < rows * units;
  const int rr = owner ? tid / units : 0, uu = owner ? tid - rr * units : 0;
  const int b = b0 + rr, u = u0 + uu;
  // a step's inputs for the pair; none of them is written by another block
  // during the scan, so step t-1's are fetched before step t's barrier
  float xr, xz, xn, hr, hz, hn, h_prev, dy, m;
  auto fetch = [&](int t) {
    const long tb = (long)t * B + b;
    const float* x = xw + tb * H3;
    const float* d = dxw + tb * H3;
    xr = x[u], xz = x[H + u], xn = x[2 * H + u];
    hr = d[u], hz = d[H + u], hn = d[2 * H + u];
    h_prev = t > 0 ? ys[(tb - B) * H + u] : h0[(long)b * H + u];
    dy = dys[tb * H + u];
    m = mask[tb];
  };
  if (owner) fetch(T - 1);
  unsigned int* bar = barrier + blockIdx.y;  // row groups are independent scans
  for (int t = T - 1; t >= 0; --t) {
    // 1. gates of the block's (row, unit) pairs; dxw[t] and dhg[t] for them
    if (owner) {
      const long tb = (long)t * B + b;
      const float r = sigmoid(xr + hr);
      const float z = sigmoid(xz + hz);
      const float n = tanhf(xn + r * hn);
      const float dh_tot = dy + dh_s[rr * U4 + uu];
      const bool valid = m > 0.0f;
      const float dh_upd = valid ? dh_tot : 0.0f;
      const float dn_pre = dh_upd * (1.0f - z) * (1.0f - n * n);
      const float dz_pre = dh_upd * (h_prev - n) * z * (1.0f - z);
      const float dr_pre = dn_pre * hn * r * (1.0f - r);
      float* d = dxw + tb * H3;
      d[u] = dr_pre;
      d[H + u] = dz_pre;
      d[2 * H + u] = dn_pre;
      float* g = dhg + tb * H3;
      g[u] = dr_pre;
      g[H + u] = dz_pre;
      g[2 * H + u] = dn_pre * r;
      base_s[rr * U4 + uu] = valid ? dh_upd * z : dh_tot;
      if (t > 0) fetch(t - 1);
    }
    grid_sync(bar, (T - t) * gridDim.x);

    // 2. stage dhg[t] of the block's rows, every block's columns, row-major:
    //    16-byte asynchronous copies straight into shared memory, each warp
    //    reading 512 contiguous bytes
    const float* src = dhg + ((long)t * B + b0) * H3;
    const int q4 = H3 / 4;
    for (int i = tid; i < rows * q4; i += blockDim.x) {
      const int rr = i / q4, q = i - rr * q4;
      cp_async16(g_s + rr * S + 4 * q, src + (long)rr * H3 + 4 * q);
    }
    cp_async_wait_all();
    __syncthreads();

    // 3. dh_{t-1} = base + dhg[t] @ W_h^T: a 4x4 tile per thread, split over j
    if (split < n_split) {
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;
      for (int q = split; q < H3 / 4; q += n_split) {  // j = 4q .. 4q+3
        float4 gv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) gv[a] = *reinterpret_cast<const float4*>(g_s + rt * S + a * RS + 4 * q);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 wv = *reinterpret_cast<const float4*>(w_s + (4 * q + k) * U4 + 4 * ut);
          const float wa[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float ga = k == 0 ? gv[a].x : k == 1 ? gv[a].y : k == 2 ? gv[a].z : gv[a].w;
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(ga, wa[c], acc[a][c]);
          }
        }
      }
      float* red = red_s + split * RU;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) red[(rt + a * (R4 / 4)) * U4 + 4 * ut + c] = acc[a][c];
    }
    __syncthreads();
    for (int i = tid; i < RU; i += blockDim.x) {
      float s = 0.0f;
      for (int k = 0; k < n_split; ++k) s += red_s[k * RU + i];
      dh_s[i] = base_s[i] + s;
    }
    __syncthreads();
  }

  if (owner) dh0[(long)b * H + u] = dh_s[rr * U4 + uu];
}

// out[i] = sum over z of part[z * n + i], z in order.
__global__ void sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  long n, int splits) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int z = 0; z < splits; ++z) s += part[z * n + i];
    out[i] = s;
  }
}

// out[n] = sum over rows of x[row, n]; block (32, 8): 8 strided partial sums
// per column, added in a fixed order.
__global__ void colsum_kernel(const float* __restrict__ x, float* __restrict__ out,
                              long rows, int N) {
  __shared__ float part[8][33];
  const int n = blockIdx.x * 32 + threadIdx.x;
  float s = 0.0f;
  if (n < N)
    for (long i = threadIdx.y; i < rows; i += 8) s += x[i * N + n];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && n < N) {
    float tot = 0.0f;
    for (int y = 0; y < 8; ++y) tot += part[y][threadIdx.x];
    out[n] = tot;
  }
}

int device_attr(cudaDeviceAttr attr) {
  int device = 0, v = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&v, attr, device);
  return v;
}

size_t chain_smem(int H, int R, int U) {
  const long R4 = (R + 3) & ~3, U4 = (U + 3) & ~3;
  const long n_split = kThreads / ((R4 / 4) * (U4 / 4));
  return sizeof(float) * (3L * H * U4 + R4 * (long)stage_stride(H) + (n_split + 2) * R4 * U4);
}

// The chain's partition of `rows` batch rows over at most n_sm blocks: R rows
// and U units per block, least work per block (R4*U4) first, then fewest
// unit groups (each reads all of its rows' dhg[t]). False if nothing fits.
bool chain_plan(int rows, int H, int n_sm, size_t smem_max, int* R_out, int* U_out) {
  long best = -1;
  for (int R = 1; R <= rows && R <= 64; ++R) {
    const int g_r = (rows + R - 1) / R;
    if (g_r > n_sm) continue;
    const int g_u_max = n_sm / g_r;
    const int U = (H + g_u_max - 1) / g_u_max;
    const int g_u = (H + U - 1) / U;
    const long R4 = (R + 3) & ~3, U4 = (U + 3) & ~3;
    if (R * U > kThreads || chain_smem(H, R, U) > smem_max) continue;
    const long cost = R4 * U4 * 4096 + g_u;
    if (best < 0 || cost < best) {
      best = cost;
      *R_out = R;
      *U_out = U;
    }
  }
  return best >= 0;
}

// Split of the dW_h sum over T*B rows: as many blocks as fit the card at
// once (two per SM), so there is no ragged second wave.
int dw_splits(long K, int H, int n_sm) {
  const long tiles = (long)((H + BM - 1) / BM) * ((3 * H + BN - 1) / BN);
  long s = 2L * n_sm / tiles;
  const long s_max = K / 256 > 1 ? K / 256 : 1;
  if (s > s_max) s = s_max;
  if (s < 1) s = 1;
  return (int)s;
}

long k_chunk_of(long K, int splits) {
  const long c = (K + splits - 1) / splits;
  return (c + BK - 1) / BK * BK;
}

}  // namespace

// Floats of scratch s2i_gru_bwd needs: dhg [T, B, 3H] and the dW_h partial sums.
extern "C" long s2i_gru_bwd_workspace(int T, int B, int H) {
  const long K = (long)T * B;
  const int n_sm = device_attr(cudaDevAttrMultiProcessorCount);
  const long chunk = k_chunk_of(K, dw_splits(K, H, n_sm));
  const long splits = (K + chunk - 1) / chunk;
  return K * 3 * H + splits * H * 3L * H;
}

extern "C" int s2i_gru_bwd(const float* xw, const float* wh, const float* bh,
                           const float* mask, const float* h0, const float* ys,
                           const float* dys, float* dxw, float* dwh, float* dbh,
                           float* dh0, float* workspace, unsigned int* barrier,
                           int T, int B, int H, void* stream_ptr) {
  if (T <= 0 || B <= 0 || H <= 0 || H % 4) return cudaErrorInvalidValue;  // 16-byte rows
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int H3 = 3 * H;
  const long K = (long)T * B;
  const int n_sm = device_attr(cudaDevAttrMultiProcessorCount);
  const size_t smem_max = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  float* dhg = workspace;
  float* part = workspace + K * H3;
  const PrevRows prev{h0, ys, B, H};
  cudaError_t err;

  // 1. gate pre-activations h_{t-1} @ W_h + b_h for all T*B rows, into dxw
  gemm_kernel<<<dim3((H3 + BN - 1) / BN, (unsigned)((K + BM - 1) / BM), 1), kGemmThreads, 0, stream>>>(
      prev, 0, wh, H3, bh, dxw, H3, 0, (int)K, H3, H, (H + BK - 1) / BK * BK);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // 2. the reverse chain, over as many row chunks as shared memory needs
  int rows = B, R = 0, U = 0;
  while (!chain_plan(rows, H, n_sm, smem_max, &R, &U)) {
    if (rows == 1) return cudaErrorInvalidValue;  // H too large for one block's shared memory
    rows = (rows + 1) / 2;
  }
  const size_t smem = chain_smem(H, R, U);
  err = cudaFuncSetAttribute(gru_bwd_chain_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gru_bwd_chain_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  for (int row0 = 0; row0 < B; row0 += rows) {
    int n_rows = B - row0 < rows ? B - row0 : rows;
    const dim3 grid((H + U - 1) / U, (n_rows + R - 1) / R);
    if ((long)per_sm * n_sm < (long)grid.x * grid.y) return cudaErrorCooperativeLaunchTooLarge;
    if ((err = cudaMemsetAsync(barrier, 0, grid.y * sizeof(unsigned int), stream)) != cudaSuccess)
      return err;
    void* args[] = {(void*)&xw, (void*)&wh, (void*)&mask, (void*)&h0, (void*)&ys,
                    (void*)&dys, (void*)&dxw, (void*)&dhg, (void*)&dh0, (void*)&barrier,
                    (void*)&T, (void*)&B, (void*)&H, (void*)&row0, (void*)&n_rows,
                    (void*)&R, (void*)&U};
    err = cudaLaunchCooperativeKernel((const void*)gru_bwd_chain_kernel, grid,
                                      dim3(kThreads), args, smem, stream);
    if (err != cudaSuccess) return err;
  }

  // 3. dW_h = sum h_{t-1}^T dhg in fixed chunks of rows, then the chunks in order
  const int chunk = (int)k_chunk_of(K, dw_splits(K, H, n_sm));
  const int splits = (int)((K + chunk - 1) / chunk);
  gemm_kernel<<<dim3((H3 + BN - 1) / BN, (H + BM - 1) / BM, splits), kGemmThreads, 0, stream>>>(
      prev, 1, dhg, H3, nullptr, part, H3, (long)H * H3, H, H3, (int)K, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long n_w = (long)H * H3;
  sum_splits_kernel<<<(unsigned)((n_w + 255) / 256 < 4096 ? (n_w + 255) / 256 : 4096), 256, 0,
                      stream>>>(part, dwh, n_w, splits);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  colsum_kernel<<<(H3 + 31) / 32, dim3(32, 8), 0, stream>>>(dhg, dbh, K, H3);
  return cudaGetLastError();
}

extern "C" const char* s2i_gru_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
