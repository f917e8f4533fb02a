// Shared pieces of the set2vec readout kernels (set2vec_fwd.cu,
// set2vec_bwd.cu): the weights' layout in shared memory, the LSTM step and
// the query, each taken by ONE WARP per graph with lane j holding feature j
// of the graph's carry (w = 2·nf ≤ 32 features, zero-padded to 32 lanes).
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
constexpr int WP = 32;               // the widest set, kernels/set2vec.py::MAX_WIDTH
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

// The kernels are instantiated for a width bound WB (16 or WP, w <= WB):
// the products below loop over WB features; shared-memory strides stay WP.
template <typename Kernel16, typename Kernel32>
const void* kernel_for_width(int width, Kernel16 k16, Kernel32 k32) {
  return width <= 16 ? (const void*)k16 : (const void*)k32;
}

// The LSTM's four activations at feature `lane` from the carry [mh ‖ mr]
// (lane k holds mh[k], mr[k]; zero past the width): i, f, g, o.
template <int WB>
__device__ __forceinline__ void lstm_gates(const float* sm, float mh, float mr,
                                           int lane, float (&act)[4]) {
  float a[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) a[g] = sm[SL::kB + g * WP + lane];
#pragma unroll 8
  for (int k = 0; k < WB; ++k) {
    const float x = __shfl_sync(kFull, mh, k), y = __shfl_sync(kFull, mr, k);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      a[g] = fmaf(x, sm[SL::kW + (g * 2 * WP + k) * WS + lane], a[g]);
      a[g] = fmaf(y, sm[SL::kW + (g * 2 * WP + WP + k) * WS + lane], a[g]);
    }
  }
  act[0] = sigmoid_(a[0]);
  act[1] = sigmoid_(a[1]);
  act[2] = tanhf(a[2]);
  act[3] = sigmoid_(a[3]);
}

// q[lane] = Σ_k h[k]·Wq[k][lane].
template <int WB>
__device__ __forceinline__ float query(const float* sm, float h, int lane) {
  float q = 0.f;
#pragma unroll 8
  for (int k = 0; k < WB; ++k)
    q = fmaf(__shfl_sync(kFull, h, k), sm[SL::kQ + k * WS + lane], q);
  return q;
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
