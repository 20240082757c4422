// GRU forward recurrence for Hopper (sm_90a): every direction of a layer,
// all T steps, in one launch.
//
// Replaces: the Pallas TPU kernel `_fwd_kernel` in s2i_tpu/ops/gru_kernel.py
// (reached through `_fwd_call` / `fused_gru`). Same contract per direction:
// the input projections xw are precomputed outside, W_h and b_h stay
// resident, gates are r|z|n with b_hn inside r*(...), and a step whose mask
// is 0 carries h through unchanged. The directions of a layer come stacked:
// xw [D, T, B, 3H], W_h [D, H, 3H], b_h [D, 3H], h0 [D, B, H], one mask
// [T, B], ys [D, T, B, H]. Direction 1 walks t from T-1 down to 0 over the
// unflipped arrays, which is what running direction 0's scan on the flipped
// sequence and mask, then flipping ys back, gives.
//
// What bounds it on this card: neither bytes nor operations but the chain
// of T dependent steps. A step at H=512, B=64, D=2 is 2*2*64*512*1536 =
// 201 MFLOP, 3 us of the card's fp32 peak; at B=8 it is 0.4 us. Measured
// on an H100 (700 W) by clock64 marks at a step's phase boundaries (PERF.md), a
// step at B=64 takes ~24,000 SM clocks, ~62% of them in the product; at
// B=8 it takes ~9,400, ~45% of them in the step barrier (release, spin on
// the other blocks, and the fence before it) and ~26% in the product.
//
// Design: a cooperative persistent kernel of thread block clusters (see
// gru_common.cuh for the exchange). Chains (direction, group of R rows)
// run side by side on disjoint blocks and meet only their own blocks at
// each step. Block (chain, i) owns U hidden units of its direction, and its
// threads keep the 3U columns of W_h that feed them in registers for all T
// steps (product_rows: 16 k by 4 columns per thread), so shared memory
// holds only the step's rows of h and W_h is read from device memory once
// per launch. Each step the block
//   1. waits on its mbarrier for h_{t-1} of its R rows, which its cluster
//      copied from ys[t-1] (or h0) into the shared memory of all of its
//      blocks with one multicast bulk copy per row;
//   2. computes h_{t-1} @ W_slice: each value of h read from shared memory
//      feeds four FMAs, and the 16 lanes that share four columns add their
//      slices by shuffles; the lane groups' sums go to shared memory;
//   3. applies the gates and the mask to its (row, unit) pairs, adding the
//      sums in a fixed order, from xw[t] and mask[t] that cp.async fetched
//      into shared memory during the previous step, and writes ys[t];
//   4. meets the chain's other blocks and issues its share of the cluster's
//      copy of ys[t].
// h_t is never kept anywhere but ys[t], which doubles as the carry. W_h in
// registers bounds the width: 512 threads hold 32K floats, so a chain needs
// at least 3H^2 / 32K blocks, which for both directions at once fits the
// card up to H of about 780 (no launch plan beyond: the wrapper raises).

#include "gru_common.cuh"

namespace {

using namespace gru;

constexpr int kMaxThreads = 512;

struct FwdArgs {
  const float* xw;    // [D, T, B, 3H]
  const float* wh;    // [D, H, 3H]
  const float* bh;    // [D, 3H]
  const float* mask;  // [T, B], 1 or 0
  const float* h0;    // [D, B, H]
  float* ys;          // [D, T, B, H]
  unsigned int* count;  // [D * groups], zeroed
  int T, B, H;
  int R;          // rows per group
  int groups;     // row groups per direction
  int U;          // hidden units per block, a multiple of 4
  int per_chain;  // blocks per chain, a multiple of kCluster
  int ns;         // slices of the H sum (a multiple of 16)
};

struct FwdLayout {
  int R4, J, S, M;
  size_t h, red, x, m, b, total;  // float offsets; total in bytes
};

__host__ __device__ inline FwdLayout fwd_layout(int H, int R, int U) {
  FwdLayout l;
  l.R4 = (R + 3) & ~3;
  l.J = 3 * U;
  const int ns = slices(H);
  l.S = stage_stride(ns * kSlice);  // columns past H stay 0
  l.M = ns / 16;                    // partial sums per output
  l.h = 4;                      // after the mbarrier (16 bytes)
  l.red = l.h + (size_t)l.R4 * l.S;
  l.x = l.red + (size_t)l.M * l.R4 * l.J;
  l.m = l.x + 2 * (size_t)R * l.J;
  l.b = l.m + 2 * (size_t)l.R4;
  l.total = sizeof(float) * (l.b + l.J);
  return l;
}

__global__ void __launch_bounds__(kMaxThreads, 1) gru_fwd_kernel(const FwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, H3 = 3 * H, T = a.T, B = a.B, U = a.U, ns = a.ns;
  const FwdLayout l = fwd_layout(H, a.R, U);
  const int J = l.J, R4 = l.R4, S = l.S;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* h_s = smem + l.h;      // [R4][S]: h_{t-1} of the group's rows
  float* red_s = smem + l.red;  // [M][R4][J]: partial sums of h_{t-1} @ W_slice
  float* x_s = smem + l.x;      // [2][R][J]: xw of a step for the block's columns
  float* m_s = smem + l.m;      // [2][R4]: mask of a step
  float* b_s = smem + l.b;      // [J]: b_h for the block's columns

  const int tid = threadIdx.x;
  const int chain = blockIdx.x / a.per_chain;
  const int d = chain / a.groups;
  const int b0 = (chain - d * a.groups) * a.R;
  const int rows = max(0, min(a.R, B - b0));
  const int u0 = (blockIdx.x - chain * a.per_chain) * U;
  const int units = max(0, min(U, H - u0));  // a multiple of 4
  const float* xw = a.xw + (long)d * T * B * H3;
  float* ys = a.ys + (long)d * T * B * H;
  const long TBH = (long)B * H;
  auto time_of = [&](int s) { return d ? T - 1 - s : s; };

  if (tid == 0) mbar_init(bar);
  // this thread's slice of W_slice (column c = g*U + uu is W_h column g*H + u0 + uu)
  const ProductLane lane(J, ns);
  float w[kSlice][4];
  const float* wh = a.wh + (long)d * H * H3 + u0;
  load_slice(w, lane, ns, [&](int k, int c) {
    const int g = c / U, uu = c - g * U;
    return uu < units && k < H ? wh[(long)k * H3 + g * H + uu] : 0.0f;
  });
  for (int j = tid; j < J; j += blockDim.x) {
    const int g = j / U, uu = j - g * U;
    b_s[j] = uu < units ? a.bh[(long)d * H3 + g * H + u0 + uu] : 0.0f;
  }
  for (int i = tid; i < R4 * S; i += blockDim.x) h_s[i] = 0.0f;  // padding rows and columns stay 0
  for (int i = tid; i < 2 * R4; i += blockDim.x) m_s[i] = 0.0f;

  // xw and mask of step s into buffer s & 1 (one cp.async group per call)
  const int q_u = units / 4;
  auto fetch = [&](int s) {
    if (s < T) {
      const int t = time_of(s);
      float* xs = x_s + (s & 1) * a.R * J;
      for (int i = tid; i < rows * 3 * q_u; i += blockDim.x) {
        const int rr = i / (3 * q_u), rem = i - rr * 3 * q_u;
        const int g = rem / q_u, q = rem - g * q_u;
        cp_async16(xs + rr * J + g * U + 4 * q, xw + ((long)t * B + b0 + rr) * H3 + g * H + u0 + 4 * q);
      }
      for (int rr = tid; rr < rows; rr += blockDim.x)
        cp_async4(m_s + (s & 1) * R4 + rr, a.mask + (long)t * B + b0 + rr);
    }
    cp_async_commit();
  };
  fetch(0);
  // every block's mbarrier is initialized, and its shared memory zeroed,
  // before any copy into it
  cluster_sync_for_copies();
  if (tid == 0) stage_rows(h_s, S, a.h0 + ((long)d * B + b0) * H, H, rows, H, bar);

  unsigned int* count = a.count + chain;

  for (int s = 0; s < T; ++s) {
    const int t = time_of(s);
    fetch(s + 1);
    mbar_wait(bar, s & 1);

    // 2. h_{t-1} @ W_slice, W from registers
    product_rows(h_s, S, rows, w, lane, ns, J / 4 * ns, red_s, R4, J, 0);
    cp_async_wait<1>();  // this step's xw and mask (the next step's may still fly)
    __syncthreads();

    // 3. gates of the block's (row, unit) pairs, partial sums added in order
    const float* xs = x_s + (s & 1) * a.R * J;
    const float* ms = m_s + (s & 1) * R4;
    for (int i = tid; i < rows * units; i += blockDim.x) {
      const int rr = i / units, uu = i - rr * units;
      float hr = b_s[uu], hz = b_s[U + uu], hn = b_s[2 * U + uu];
      for (int k = 0; k < l.M; ++k) {
        const float* red = red_s + ((long)k * R4 + rr) * J;
        hr += red[uu];
        hz += red[U + uu];
        hn += red[2 * U + uu];
      }
      const float* x = xs + rr * J;
      const float r = sigmoid(x[uu] + hr);
      const float z = sigmoid(x[U + uu] + hz);
      const float n = tanhf(x[2 * U + uu] + r * hn);
      const float h_prev = h_s[rr * S + u0 + uu];
      const float h_new = (1.0f - z) * n + z * h_prev;
      ys[(long)t * TBH + (long)(b0 + rr) * H + u0 + uu] = ms[rr] > 0.0f ? h_new : h_prev;
    }

    // 4. the chain's step barrier, then the copy of ys[t] for the next step
    if (s + 1 < T) {
      chain_barrier(count, (s + 1) * a.per_chain);
      if (tid == 0) stage_rows(h_s, S, ys + (long)t * TBH + (long)b0 * H, H, rows, H, bar);
    }
  }
}

}  // namespace

// The launch plan for D directions of B rows and H units: fills plan with
// {groups, U, per_chain, ns, threads, smem bytes, blocks}. Least work per
// block first, then fewest rows to stage, then fewest blocks. Returns 0,
// or an error if no plan fits the card.
extern "C" int s2i_gru_fwd_plan(int D, int B, int H, int* plan) {
  if (D <= 0 || B <= 0 || H <= 0 || H % 4) return cudaErrorInvalidValue;
  const int n_sm = device_attr(cudaDevAttrMultiProcessorCount);
  const size_t smem_max = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  long best = -1;
  for (int groups = 1; groups <= B; ++groups) {
    const int R = (B + groups - 1) / groups;
    if (groups > 1 && (B + R - 1) / R < groups) continue;  // same R as fewer groups
    for (int U = 4; U <= (H + 3) / 4 * 4; U += 4) {
      const int per_chain = ((H + U - 1) / U + kCluster - 1) / kCluster * kCluster;
      const int blocks = D * groups * per_chain;
      if (blocks > n_sm) continue;
      const int R4 = (R + 3) & ~3, J = 3 * U;
      const int ns = slices(H), threads = (J / 4 * ns + 31) / 32 * 32;
      if (threads > kMaxThreads) break;  // larger U only needs more threads
      if (fwd_layout(H, R, U).total > smem_max) continue;
      const size_t smem = one_block_per_sm(fwd_layout(H, R, U).total);
      const long cost = ((long)R4 * J + R) * 1024 + blocks;
      if (best >= 0 && cost >= best) break;  // larger U only costs more
      if ((long)max_clusters(gru_fwd_kernel, threads, smem) * kCluster < blocks) continue;
      best = cost;
      const int p[7] = {groups, U, per_chain, ns, threads, (int)smem, blocks};
      for (int i = 0; i < 7; ++i) plan[i] = p[i];
      break;  // the smallest U that fits is this group count's best
    }
  }
  return best >= 0 ? 0 : cudaErrorInvalidValue;
}

// count: D * groups zeroed words; plan: as s2i_gru_fwd_plan gave it.
extern "C" int s2i_gru_fwd(const float* xw, const float* wh, const float* bh, const float* mask,
                           const float* h0, float* ys, unsigned int* count, int D, int T, int B,
                           int H, const int* plan, void* stream) {
  if (D <= 0 || T <= 0 || B <= 0 || H <= 0 || H % 4) return cudaErrorInvalidValue;
  const int groups = plan[0];
  const FwdArgs args{xw, wh, bh, mask, h0, ys, count, T, B, H, (B + groups - 1) / groups, groups,
                     plan[1], plan[2], plan[3]};
  cudaError_t err =
      launch_chains(gru_fwd_kernel, plan[6], plan[4], (size_t)plan[5], static_cast<cudaStream_t>(stream), args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

extern "C" const char* s2i_gru_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
