// GRU backward recurrence for Hopper (sm_90a): the gradient of gru_fwd.cu,
// every direction of a layer in one call.
//
// Replaces: the Pallas TPU kernel `_bwd_kernel` in s2i_tpu/ops/gru_kernel.py
// (reached through `_bwd_call` / `_fused_gru_bwd`, the custom VJP of
// `fused_gru`). Same contract per direction: from the forward's inputs and
// its output ys (the only saved tensor), and the incoming dys, it gives
// dxw, dW_h, db_h and dh0. The gates are recomputed from (xw[t], h_{t-1});
// a step whose mask is 0 passes dh straight through. The directions come
// stacked as in gru_fwd.cu: xw [D, T, B, 3H], W_h [D, H, 3H], b_h [D, 3H],
// h0 [D, B, H], mask [T, B], ys and dys [D, T, B, H]. Direction 1's forward
// walked t from T-1 down, so its reverse scan walks t upwards, and its
// h_{t-1} is ys[t+1] (h0 at t = T-1).
//
// What bounds it on this card: on paper, operations. Three products of
// 2*T*B*H*3H each per direction (the gate recompute h_{t-1} @ W_h, the carry
// dhg @ W_h^T and dW_h = sum h_{t-1}^T dhg) are 77 GFLOP at T=128, B=64,
// H=512, D=2, or 1.16 ms of the card's fp32 peak, against ~280 MB moved
// (0.08 ms). The carry's chain of T dependent steps is the part that cannot
// use the whole card at once: each step needs the whole of dhg[t] of a row
// before any dh_{t-1} of it. Measured on an H100 (700 W) at B=64, D=2
// (chip_smoke.py's parts; clock64 marks in a chain step, PERF.md): the chain is
// ~57% of the call, and ~65% of a chain step is its product; the two SGEMMs
// are the rest.
//
// Design: only the carry is sequential, so only the carry runs step by step.
//   1. gates: one tiled SGEMM (128x128 tiles, 8x8 per thread, two shared
//      memory buffers, two blocks per SM) computes h_{t-1} @ W_h + b_h for
//      all T*B rows of every direction, into dxw, which doubles as its
//      scratch.
//   2. chain: a cooperative persistent kernel of thread block clusters, the
//      exchange of gru_common.cuh. A chain is a (direction, group of R rows)
//      pair; its blocks own U hidden units each, and their threads keep the
//      U rows of W_h they need in registers for all T steps (product_rows,
//      W_h^T's columns). Each step a block
//        a. applies the gates to its (row, unit) pairs, from inputs fetched
//           during the previous step, and writes dxw[t] (in place over the
//           gate pre-activations) and dhg[t] = [dr, dz, dn*r] for its 3U
//           columns;
//        b. meets the chain's other blocks;
//        c. receives dhg[t] of its R rows, in one chunk of rows or, when
//           R * 3H floats do not fit its shared memory, in chunks of RC rows
//           two buffers deep (a cluster barrier frees a buffer for the chunk
//           after next): its cluster copies each row from L2 once, into all
//           of its blocks (multicast bulk copies);
//        d. forms dh_{t-1} = dh_upd*z + dh_skip + dhg[t] @ W_h^T for its
//           pairs, the lane groups' sums added in a fixed order.
//      The carry never leaves the block.
//   3. dW_h = sum over T*B rows of h_{t-1}^T dhg: the same SGEMM, split
//      over the T*B sum into fixed chunks (as many as fill whole waves of
//      the card) whose partial sums are then added in order; db_h is a
//      column sum of dhg. No atomics on data anywhere, so the result is the
//      same every run.
// Full fp32 FMA on the CUDA cores, no TF32. W_h in registers bounds the
// width as in gru_fwd.cu.

#include "gru_common.cuh"

namespace {

using namespace gru;

constexpr int kMaxThreads = 512;  // chain block size at most
constexpr int kPairs = 2;         // (row, unit) pairs a chain thread owns at most
// SGEMM tile: BM x BN outputs per block, BK deep, TM x TN per thread.
constexpr int BM = 128, BN = 128, BK = 8, TM = 8, TN = 8;
constexpr int kGemmThreads = (BM / TM) * (BN / TN);

// Row i = t*B + b (over T*B rows) of h_{t-1} in direction d's forward order:
// direction 0 reads h0 then ys[0..T-2], direction 1 ys[1..T-1] then h0.
struct PrevRows {
  const float* h0;  // [D, B, H]
  const float* ys;  // [D, T, B, H]
  int B, T, H;
  __device__ __forceinline__ const float* operator()(int d, long i) const {
    const float* h0d = h0 + (long)d * B * H;
    const float* ysd = ys + (long)d * T * B * H;
    if (d == 0) return i < B ? h0d + i * H : ysd + (i - B) * H;
    const long last = (long)(T - 1) * B;
    return i >= last ? h0d + (i - last) * H : ysd + (i + B) * H;
  }
};

// Per blockIdx.z = d * z_per_d + zz: c[d][zz] [M, N] (row-major, ldc) = sum
// over k in chunk zz of A(m, k) * b[d][k, n] (+ bias[d][n]), with A(m, k) =
// a(d, m)[k], or a(d, k)[m] when a_trans. Every thread loads one 16-byte
// piece of A and one of B per tile (so M or K, N and the leading dimensions
// are multiples of 4), and owns the 8x8 outputs at rows {4ty, 64+4ty} +
// 0..3 and columns {4tx, 64+4tx} + 0..3, so a warp's shared memory reads
// are contiguous. Two shared memory buffers: the next tile's loads are in
// flight while this one's products run.
struct GemmArgs {
  PrevRows a;
  int a_trans;
  const float* b;
  int ldb;
  long b_stride_d;
  const float* bias;  // or null
  int bias_stride_d;
  float* c;
  int ldc;
  long c_stride_d, c_stride_z;
  int z_per_d, M, N, K, k_chunk;
};

__global__ void __launch_bounds__(kGemmThreads, 2) gemm_kernel(const GemmArgs g) {
  __shared__ __align__(16) float as[2][BK][BM];
  __shared__ __align__(16) float bs[2][BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int d = blockIdx.z / g.z_per_d, zz = blockIdx.z - d * g.z_per_d;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = zz * g.k_chunk;
  const int k_end = min(g.K, k_begin + g.k_chunk);
  const int M = g.M, N = g.N, a_trans = g.a_trans;
  const float* b = g.b + d * g.b_stride_d;
  // this thread's pieces: A at (am, ak..ak+3) or (ak, am..am+3), B at (bk, bn..bn+3)
  const int am = a_trans ? (tid % 32) * 4 : tid / 2, ak = a_trans ? tid / 32 : (tid % 2) * 4;
  const int bk = tid / 32, bn = (tid % 32) * 4;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 ra, rb;
  auto load = [&](int k0) {
    const int m = m0 + am, k = k0 + ak;
    ra = m < M && k < k_end ? *reinterpret_cast<const float4*>(a_trans ? g.a(d, k) + m : g.a(d, m) + k) : zero;
    const int kb = k0 + bk, n = n0 + bn;
    rb = kb < k_end && n < N ? *reinterpret_cast<const float4*>(b + (long)kb * g.ldb + n) : zero;
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

  float* cz = g.c + d * g.c_stride_d + zz * g.c_stride_z;
  const float* bias = g.bias ? g.bias + d * g.bias_stride_d : nullptr;
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
      *reinterpret_cast<float4*>(cz + (long)m * g.ldc + n) = v;
    }
  }
}

struct ChainArgs {
  const float* xw;    // [D, T, B, 3H]
  const float* wh;    // [D, H, 3H]
  const float* mask;  // [T, B], 1 or 0
  const float* h0;    // [D, B, H]
  const float* ys;    // [D, T, B, H]
  const float* dys;   // [D, T, B, H]
  float* dxw;         // [D, T, B, 3H]: in, h_{t-1} @ W_h + b_h; out, dxw
  float* dhg;         // [D, T, B, 3H]: out, [dr, dz, dn*r]
  float* dh0;         // [D, B, H]
  unsigned int* count;  // [D * groups], zeroed
  int T, B, H;
  int R;          // rows per group
  int groups;     // row groups per direction
  int U;          // hidden units per block, a multiple of 4
  int per_chain;  // blocks per chain, a multiple of kCluster
  int ns;         // slices of the 3H sum (a multiple of 16)
  int RC;         // rows of dhg[t] per staged chunk, a multiple of 4
};

struct ChainLayout {
  int R4, KS, NC, NB, M;
  size_t g, red, dh, base, total;  // float offsets; total in bytes
};

__host__ __device__ inline ChainLayout chain_layout(int H, int R, int U, int RC) {
  ChainLayout l;
  l.R4 = (R + 3) & ~3;
  const int ns = slices(3 * H);
  l.KS = stage_stride(ns * kSlice);  // columns past 3H stay 0
  l.NC = (l.R4 + RC - 1) / RC;
  l.NB = l.NC > 1 ? 2 : 1;
  l.M = ns / 16;
  l.g = 4;  // after two mbarriers (16 bytes)
  l.red = l.g + (size_t)l.NB * RC * l.KS;
  l.dh = l.red + (size_t)l.M * l.R4 * U;
  l.base = l.dh + (size_t)l.R4 * U;
  l.total = sizeof(float) * (l.base + (size_t)l.R4 * U);
  return l;
}

__global__ void __launch_bounds__(kMaxThreads, 1) gru_bwd_chain_kernel(const ChainArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, H3 = 3 * H, T = a.T, B = a.B, U = a.U, ns = a.ns, RC = a.RC;
  const ChainLayout l = chain_layout(H, a.R, U, RC);
  const int R4 = l.R4, KS = l.KS, NC = l.NC, RU = l.R4 * U;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // one per staging buffer
  float* g_s = smem + l.g;        // [NB][RC][KS]: a chunk of rows of dhg[t]
  float* red_s = smem + l.red;    // [M][R4][U]: partial sums of dhg[t] @ W_h^T
  float* dh_s = smem + l.dh;      // [R4][U]: the dh carry
  float* base_s = smem + l.base;  // [R4][U]: dh_upd*z + dh_skip
  const int tid = threadIdx.x;
  const int chain = blockIdx.x / a.per_chain;
  const int d = chain / a.groups;
  const int b0 = (chain - d * a.groups) * a.R;
  const int rows = max(0, min(a.R, B - b0));
  const int u0 = (blockIdx.x - chain * a.per_chain) * U;
  const int units = max(0, min(U, H - u0));
  const long dTB = (long)d * T * B;
  const float* ys = a.ys + dTB * H;
  const float* h0 = a.h0 + (long)d * B * H;
  float* dhg = a.dhg + dTB * H3;
  auto time_of = [&](int s) { return d ? s : T - 1 - s; };  // the forward's order, reversed

  if (tid < l.NB) mbar_init(bars + tid);
  // this thread's slice of W_h^T (column c is W_h row u0 + c), for dhg @ W_h^T
  const ProductLane lane(U, ns);
  float w[kSlice][4];
  const float* wh = a.wh + ((long)d * H + u0) * H3;
  load_slice(w, lane, ns, [&](int j, int c) { return c < units && j < H3 ? wh[(long)c * H3 + j] : 0.0f; });
  for (int i = tid; i < RU; i += blockDim.x) {
    dh_s[i] = 0.0f;
    base_s[i] = 0.0f;
  }
  for (size_t i = tid; i < l.red - l.g; i += blockDim.x) g_s[i] = 0.0f;  // padding columns stay 0

  // the thread's (row, unit) pairs, tid + p * blockDim.x, and their inputs
  // for a step; none of the inputs is written by another block during the
  // scan, so step s+1's are fetched during step s
  const int n_pairs = rows * units;
  float xr[kPairs], xz[kPairs], xn[kPairs], hr[kPairs], hz[kPairs], hn[kPairs], hp[kPairs], dy[kPairs], m[kPairs];
  auto fetch = [&](int s) {
    const int t = time_of(s);
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const int i = tid + p * blockDim.x;
      if (i >= n_pairs) break;
      const int rr = i / units, uu = i - rr * units, b = b0 + rr, u = u0 + uu;
      const long tb = dTB + (long)t * B + b;
      const float* x = a.xw + tb * H3;
      const float* hw = a.dxw + tb * H3;
      xr[p] = x[u], xz[p] = x[H + u], xn[p] = x[2 * H + u];
      hr[p] = hw[u], hz[p] = hw[H + u], hn[p] = hw[2 * H + u];
      const int tp = d ? t + 1 : t - 1;  // h_{t-1} in the forward's order
      hp[p] = tp >= 0 && tp < T ? ys[((long)tp * B + b) * H + u] : h0[(long)b * H + u];
      dy[p] = a.dys[tb * H + u];
      m[p] = a.mask[(long)t * B + b];
    }
  };
  fetch(0);
  // every block's mbarriers are initialized, and its shared memory zeroed,
  // before any copy into them
  cluster_sync_for_copies();

  unsigned int* count = a.count + chain;
  uint32_t phase = 0;  // bit i: parity of buffer i's next completion

  for (int s = 0; s < T; ++s) {
    const int t = time_of(s);
    const float* dhg_t = dhg + ((long)t * B + b0) * H3;
    // a. gates of the block's pairs; dxw[t] and dhg[t] for them
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const int i = tid + p * blockDim.x;
      if (i >= n_pairs) break;
      const int rr = i / units, uu = i - rr * units, u = u0 + uu;
      const long tb = dTB + (long)t * B + b0 + rr;
      const float r = sigmoid(xr[p] + hr[p]);
      const float z = sigmoid(xz[p] + hz[p]);
      const float n = tanhf(xn[p] + r * hn[p]);
      const float dh_tot = dy[p] + dh_s[rr * U + uu];
      const bool valid = m[p] > 0.0f;
      const float dh_upd = valid ? dh_tot : 0.0f;
      const float dn_pre = dh_upd * (1.0f - z) * (1.0f - n * n);
      const float dz_pre = dh_upd * (hp[p] - n) * z * (1.0f - z);
      const float dr_pre = dn_pre * hn[p] * r * (1.0f - r);
      float* dx = a.dxw + tb * H3;
      dx[u] = dr_pre;
      dx[H + u] = dz_pre;
      dx[2 * H + u] = dn_pre;
      float* g = a.dhg + tb * H3;
      g[u] = dr_pre;
      g[H + u] = dz_pre;
      g[2 * H + u] = dn_pre * r;
      base_s[rr * U + uu] = valid ? dh_upd * z : dh_tot;
    }

    // b. the chain's step barrier; c. the first two chunks of dhg[t]'s rows
    chain_barrier(count, (s + 1) * a.per_chain);
    auto stage = [&](int c) {
      const int n = max(0, min(RC, rows - c * RC));
      stage_rows(g_s + (size_t)(c & 1) * RC * KS, KS, dhg_t + (long)c * RC * H3, H3, n, H3, bars + (c & 1));
    };
    if (tid == 0)
      for (int c = 0; c < l.NB; ++c) stage(c);
    if (s + 1 < T) fetch(s + 1);  // in flight while the chunks land

    // d. dhg[t] @ W_h^T, chunk by chunk of rows, W from registers
    for (int c = 0; c < NC; ++c) {
      const int buf = c & 1;
      mbar_wait(bars + buf, (phase >> buf) & 1);
      phase ^= 1u << buf;
      product_rows(g_s + (size_t)buf * RC * KS, KS, min(RC, rows - c * RC), w, lane, ns, U / 4 * ns, red_s, R4, U,
                   c * RC);
      if (c + 2 < NC) {
        cluster_sync_for_copies();  // every block of the cluster is done with this buffer
        if (tid == 0) stage(c + 2);
      }
    }
    __syncthreads();
    for (int i = tid; i < RU; i += blockDim.x) {
      float sum = 0.0f;
      for (int k = 0; k < l.M; ++k) sum += red_s[(size_t)k * RU + i];
      dh_s[i] = base_s[i] + sum;
    }
    __syncthreads();
  }

  for (int i = tid; i < n_pairs; i += blockDim.x) {
    const int rr = i / units, uu = i - rr * units;
    a.dh0[((long)d * B + b0 + rr) * H + u0 + uu] = dh_s[rr * U + uu];
  }
}

// out[d][i] = sum over z of part[d][z][i], z in order.
__global__ void sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out, long n,
                                  int splits, int D) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < D * n; i += (long)gridDim.x * blockDim.x) {
    const long d = i / n, j = i - d * n;
    float s = 0.0f;
    for (int z = 0; z < splits; ++z) s += part[(d * splits + z) * n + j];
    out[i] = s;
  }
}

// out[d][n] = sum over rows of x[d][row, n]; block (32, 8): 8 strided
// partial sums per column, added in a fixed order; blockIdx.y = d.
__global__ void colsum_kernel(const float* __restrict__ x, float* __restrict__ out, long rows, int N) {
  __shared__ float part[8][33];
  const int n = blockIdx.x * 32 + threadIdx.x;
  x += blockIdx.y * rows * N;
  float s = 0.0f;
  if (n < N)
    for (long i = threadIdx.y; i < rows; i += 8) s += x[i * N + n];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && n < N) {
    float tot = 0.0f;
    for (int y = 0; y < 8; ++y) tot += part[y][threadIdx.x];
    out[blockIdx.y * N + n] = tot;
  }
}

// Split of the dW_h sum over T*B rows: the split count up to 16 whose
// blocks fill whole waves of the card (two blocks per SM) best, fewest
// splits on a tie, and no chunk shorter than 256 rows.
int dw_splits(long K, int H, int D, int n_sm) {
  const long tiles = (long)D * ((H + BM - 1) / BM) * ((3 * H + BN - 1) / BN);
  const long wave = 2L * n_sm;
  int best = 1;
  double best_fill = 0.0;
  for (int s = 1; s <= 16 && (s == 1 || K / s >= 256); ++s) {
    const long blocks = tiles * s, waves = (blocks + wave - 1) / wave;
    const double fill = (double)blocks / (waves * wave);
    if (fill > best_fill + 1e-9) {
      best = s;
      best_fill = fill;
    }
  }
  return best;
}

long k_chunk_of(long K, int splits) {
  const long c = (K + splits - 1) / splits;
  return (c + BK - 1) / BK * BK;
}

}  // namespace

// The chain's launch plan for D directions of B rows and H units: fills
// plan with {groups, U, per_chain, ns, threads, smem bytes, blocks, RC}.
// Least work per block first, then fewest chunks per step, then fewest rows
// to stage. Returns 0, or an error if no plan fits the card.
extern "C" int s2i_gru_bwd_plan(int D, int B, int H, int* plan) {
  if (D <= 0 || B <= 0 || H <= 0 || H % 4) return cudaErrorInvalidValue;
  const int n_sm = device_attr(cudaDevAttrMultiProcessorCount);
  const size_t smem_max = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  const int H3 = 3 * H;
  long best = -1;
  for (int groups = 1; groups <= B; ++groups) {
    const int R = (B + groups - 1) / groups;
    if (groups > 1 && (B + R - 1) / R < groups) continue;  // same R as fewer groups
    for (int U = 4; U <= (H + 3) / 4 * 4; U += 4) {
      const int per_chain = ((H + U - 1) / U + kCluster - 1) / kCluster * kCluster;
      const int blocks = D * groups * per_chain;
      if (blocks > n_sm) continue;
      const int R4 = (R + 3) & ~3;
      const int ns = slices(H3), threads = (U / 4 * ns + 31) / 32 * 32;
      if (threads > kMaxThreads) break;  // larger U only needs more threads
      if (R * U > kPairs * threads) continue;
      int RC = 0;
      for (int rc = R4; rc >= 4 && !RC; rc -= 4)
        if (chain_layout(H, R, U, rc).total <= smem_max) RC = rc;
      if (!RC) continue;
      const long cost = ((long)R4 * U * 256 + (R4 + RC - 1) / RC) * 4096 + R;
      if (best >= 0 && cost >= best) break;
      const size_t smem = one_block_per_sm(chain_layout(H, R, U, RC).total);
      if ((long)max_clusters(gru_bwd_chain_kernel, threads, smem) * kCluster < blocks) continue;
      best = cost;
      const int p[8] = {groups, U, per_chain, ns, threads, (int)smem, blocks, RC};
      for (int i = 0; i < 8; ++i) plan[i] = p[i];
      break;
    }
  }
  return best >= 0 ? 0 : cudaErrorInvalidValue;
}

// Floats of scratch s2i_gru_bwd needs: dhg [D, T, B, 3H] and the dW_h partial sums.
extern "C" long s2i_gru_bwd_workspace(int D, int T, int B, int H) {
  const long K = (long)T * B;
  const int n_sm = device_attr(cudaDevAttrMultiProcessorCount);
  const long chunk = k_chunk_of(K, dw_splits(K, H, D, n_sm));
  const long splits = (K + chunk - 1) / chunk;
  return D * (K * 3 * H + splits * H * 3L * H);
}

// count: D * groups zeroed words; plan: as s2i_gru_bwd_plan gave it; events:
// null, or 4 cudaEvent_t recorded before the gate SGEMM, after it, after the
// chain, and after dW_h and db_h.
extern "C" int s2i_gru_bwd(const float* xw, const float* wh, const float* bh, const float* mask,
                           const float* h0, const float* ys, const float* dys, float* dxw, float* dwh,
                           float* dbh, float* dh0, float* workspace, unsigned int* count, int D, int T,
                           int B, int H, const int* plan, void** events, void* stream_ptr) {
  if (D <= 0 || T <= 0 || B <= 0 || H <= 0 || H % 4) return cudaErrorInvalidValue;  // 16-byte rows
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto mark = [&](int i) {
    if (events) cudaEventRecord(static_cast<cudaEvent_t>(events[i]), stream);
  };
  const int H3 = 3 * H;
  const long K = (long)T * B;
  const int n_sm = device_attr(cudaDevAttrMultiProcessorCount);
  float* dhg = workspace;
  float* part = workspace + D * K * H3;
  const PrevRows prev{h0, ys, B, T, H};
  cudaError_t err;

  // 1. gate pre-activations h_{t-1} @ W_h + b_h for all T*B rows, into dxw
  mark(0);
  const GemmArgs gates{prev, 0, wh, H3, (long)H * H3, bh, H3, dxw, H3, K * H3, 0, 1, (int)K, H3, H,
                       (H + BK - 1) / BK * BK};
  gemm_kernel<<<dim3((H3 + BN - 1) / BN, (unsigned)((K + BM - 1) / BM), D), kGemmThreads, 0, stream>>>(gates);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mark(1);

  // 2. the reverse chains of every direction and row group
  const int groups = plan[0];
  const ChainArgs chain{xw, wh, mask, h0, ys, dys, dxw, dhg, dh0, count, T, B, H, (B + groups - 1) / groups,
                        groups, plan[1], plan[2], plan[3], plan[7]};
  err = launch_chains(gru_bwd_chain_kernel, plan[6], plan[4], (size_t)plan[5], stream, chain);
  if (err != cudaSuccess) return err;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mark(2);

  // 3. dW_h = sum h_{t-1}^T dhg in fixed chunks of rows, then the chunks in order
  const int splits_ = dw_splits(K, H, D, n_sm);
  const int chunk = (int)k_chunk_of(K, splits_);
  const int splits = (int)((K + chunk - 1) / chunk);
  const long n_w = (long)H * H3;
  const GemmArgs dw{prev, 1, dhg, H3, K * H3, nullptr, 0, part, H3, splits * n_w, n_w, splits, H, H3, (int)K,
                    chunk};
  gemm_kernel<<<dim3((H3 + BN - 1) / BN, (H + BM - 1) / BM, D * splits), kGemmThreads, 0, stream>>>(dw);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long n_out = D * n_w;
  sum_splits_kernel<<<(unsigned)((n_out + 255) / 256 < 4096 ? (n_out + 255) / 256 : 4096), 256, 0, stream>>>(
      part, dwh, n_w, splits, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  colsum_kernel<<<dim3((H3 + 31) / 32, D), dim3(32, 8), 0, stream>>>(dhg, dbh, K, H3);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mark(3);
  return cudaSuccess;
}

extern "C" const char* s2i_gru_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
