// Shared pieces of the set2vec readout kernels (set2vec_fwd.cu,
// set2vec_bwd.cu): the weights' layout in shared memory, the LSTM step and
// the query, each taken by ONE WARP per graph with lane l holding features
// l + 32·r, r < kPL, of the graph's carry (w = 2·nf ≤ WP features,
// zero-padded: WP 32 in the narrow bucket, one feature per lane; 64 in the
// wide bucket, -DMPNN_WP=64, two per lane).
//
// Work mapping, the same in every step and in both kernels: block b owns a
// contiguous range of graphs, [b·G/grid, (b+1)·G/grid); the graph at
// offset i of the range belongs to warp i mod 4 of the block. So a graph's
// carry (global scratch, one row per graph) is read and written by one
// warp only, and a node's rows by the warp of its graph. The batch-global
// softmax is the one statistic that crosses blocks: block partials,
// double-buffered by step parity, combined in block order after a grid
// barrier — every block computes the same totals with the same arithmetic.
// No float atomics anywhere.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace mpnn_s2v {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;        // 4 warps
constexpr int kWarps = kThreads / 32;
// the widest set of the build: kernels/set2vec.py::BUCKETS
#ifndef MPNN_WP
#define MPNN_WP 32
#endif
constexpr int WP = MPNN_WP;
static_assert(WP == 32 || WP == 64, "a bucket is 32 or 64 features wide");
constexpr int kPL = WP / 32;         // features per lane
// Row stride of the weight matrices in shared memory: one more than WP, so
// a warp reading a column (lane i at row i, the backward's transposed
// products) hits 32 distinct banks, as a row read does.
constexpr int WS = WP + 1;
constexpr unsigned kFull = 0xffffffffu;

struct S2vWeights {
  const float* w[4];   // w_h{i,f,g,o} (2w, w): gate = [mh ‖ mr]·W + b
  const float* b[4];   // b_h{i,f,g,o} (1, w)
  const float* wq;     // (w, w): q = h·Wq
  const float* we;     // (w, 1): e = tanh(q + x)·we
};

// Offsets (floats) of the zero-padded weights in shared memory (matrix
// rows WS apart), then a two-row broadcast buffer per warp and the block's
// reduction slots.
struct SL {
  static constexpr int kW = 0;                   // [g][half·WP + i][j]
  static constexpr int kB = kW + 4 * 2 * WP * WS;  // [g][j]
  static constexpr int kQ = kB + 4 * WP;         // [i][j]
  static constexpr int kE = kQ + WP * WS;        // [j]
  static constexpr int kBuf = kE + WP;           // kWarps · 2 · WP
  static constexpr int kRed = kBuf + kWarps * 2 * WP;  // kWarps + 2
  static constexpr int total = kRed + kWarps + 2;
};

__device__ void stage_s2v(float* sm, const S2vWeights& w, int width) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < 4 * 2 * WP * WS; i += nt) {
    const int g = i / (2 * WP * WS), r = (i / WS) % (2 * WP), j = i % WS;
    const int half = r / WP, k = r % WP;
    sm[SL::kW + i] = (k < width && j < width)
                         ? w.w[g][(half * width + k) * width + j] : 0.f;
  }
  for (int i = tid; i < 4 * WP; i += nt) {
    const int g = i / WP, j = i % WP;
    sm[SL::kB + i] = j < width ? w.b[g][j] : 0.f;
  }
  for (int i = tid; i < WP * WS; i += nt) {
    const int r = i / WS, j = i % WS;
    sm[SL::kQ + i] = (r < width && j < width) ? w.wq[r * width + j] : 0.f;
  }
  for (int i = tid; i < WP; i += nt)
    sm[SL::kE + i] = i < width ? w.we[i] : 0.f;
}

__device__ __forceinline__ float sigmoid_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float warp_sum_(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_max_(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// The kernels are instantiated for a width bound WB (w <= WB): 16 or 32 in
// the narrow bucket, 64 in the wide one; the products below loop over WB
// features, shared-memory strides stay WP.
template <typename Kernel16, typename KernelWP>
const void* kernel_for_width(int width, Kernel16 k16, KernelWP kwp) {
  if constexpr (WP == 32)
    if (width <= 16) return (const void*)k16;
  return (const void*)kwp;
}

// The LSTM's four activations at this lane's features from the carry
// [mh ‖ mr] (zero past the width): act[r] = i, f, g, o of feature
// lane + 32·r.
template <int WB>
__device__ __forceinline__ void lstm_gates(const float* sm,
                                           const float (&mh)[kPL],
                                           const float (&mr)[kPL], int lane,
                                           float (&act)[kPL][4]) {
  float a[kPL][4];
#pragma unroll
  for (int r = 0; r < kPL; ++r)
#pragma unroll
    for (int g = 0; g < 4; ++g) a[r][g] = sm[SL::kB + g * WP + lane + 32 * r];
#pragma unroll
  for (int kr = 0; kr * 32 < WB; ++kr) {
#pragma unroll 8
    for (int kk = 0; kk < (WB < 32 ? WB : 32); ++kk) {
      const int k = kr * 32 + kk;
      const float x = __shfl_sync(kFull, mh[kr], kk);
      const float y = __shfl_sync(kFull, mr[kr], kk);
#pragma unroll
      for (int r = 0; r < kPL; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float* wg = sm + SL::kW + lane + 32 * r;
          a[r][g] = fmaf(x, wg[(g * 2 * WP + k) * WS], a[r][g]);
          a[r][g] = fmaf(y, wg[(g * 2 * WP + WP + k) * WS], a[r][g]);
        }
    }
  }
#pragma unroll
  for (int r = 0; r < kPL; ++r) {
    act[r][0] = sigmoid_(a[r][0]);
    act[r][1] = sigmoid_(a[r][1]);
    act[r][2] = tanhf(a[r][2]);
    act[r][3] = sigmoid_(a[r][3]);
  }
}

// q[r] = Σ_k h[k]·Wq[k][lane + 32·r].
template <int WB>
__device__ __forceinline__ void query(const float* sm, const float (&h)[kPL],
                                      int lane, float (&q)[kPL]) {
#pragma unroll
  for (int r = 0; r < kPL; ++r) q[r] = 0.f;
#pragma unroll
  for (int kr = 0; kr * 32 < WB; ++kr) {
#pragma unroll 8
    for (int kk = 0; kk < (WB < 32 ? WB : 32); ++kk) {
      const float hk = __shfl_sync(kFull, h[kr], kk);
#pragma unroll
      for (int r = 0; r < kPL; ++r)
        q[r] = fmaf(hk, sm[SL::kQ + (kr * 32 + kk) * WS + lane + 32 * r],
                    q[r]);
    }
  }
}

// This block's graphs: [lo, hi).
__device__ __forceinline__ void block_graphs(int G, int& lo, int& hi) {
  lo = int((long long)blockIdx.x * G / gridDim.x);
  hi = int((long long)(blockIdx.x + 1) * G / gridDim.x);
}

// All co-resident blocks of `kernel`, capped at one warp per graph.
inline int coop_grid(const void* kernel, size_t bytes, int n_graphs) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(bytes)) != cudaSuccess)
    return 0;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    bytes) != cudaSuccess)
    return 0;
  return min(per_sm * sms, max(1, (n_graphs + kWarps - 1) / kWarps));
}

}  // namespace mpnn_s2v
