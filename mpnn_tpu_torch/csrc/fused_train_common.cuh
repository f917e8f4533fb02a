// Shared pieces of the two whole-step TRAINING kernels (fused_step_fwd.cu,
// fused_step_bwd.cu): the weight layout in shared memory, the batch-wide
// masked-BN statistics and the fixed-order reductions.
//
// Both kernels are single cooperative launches. Work is mapped two ways:
//   * graph phases (messages, readout, the message backward): ONE WARP per
//     graph, lanes over its nodes, per-graph sums as xor butterflies;
//   * node phases (the T recurrent steps and their reverse): node CHUNKS of
//     kChunk consecutive node slots, one thread per node; chunk c is
//     handled by block c mod gridDim.x in every phase, so a thread meets
//     the same nodes at every step and reads back what it wrote itself.
// Batch-wide statistics are combined from per-CHUNK partials, in chunk
// order, after a grid-wide barrier: every block computes the same totals
// with the same arithmetic, so results do not depend on scheduling or on
// the grid size. No float atomics anywhere.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace mpnn_train {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;        // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads;     // node slots per node chunk
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-5f;        // masked bn1d: eps OUTSIDE the sqrt
constexpr float kVarClamp = 1e-12f;  // var clamped inside the sqrt
// compiled for f <= 16 and od <= 16 (the lipo family: f = 10, od = 14),
// zero-padded; kernels/fused_step.py::MAX_WIDTH
constexpr int FP = 16;
constexpr int ODP = 16;
constexpr int kMaxSteps = 32;

struct Weights {
  const float* amat;   // (K, f, f): message = amat[k] @ h0[src]
  const float* a0;     // (f, f) bias-leakage matrix
  const float* mbias;  // (f)
  const float* w_ih;   // (f, 3f), gates r|z|n
  const float* w_hh;   // (f, 3f)
  const float* b_ih;   // (3f)
  const float* b_hh;   // (3f)
  const float* ma_w;   // (f) message bn1d affine
  const float* ma_b;
  const float* bn_w;   // (f) state bn1d affine
  const float* bn_b;
  const float* ro_iw;  // (2f, od) readout gate, input [h_T | h0]
  const float* ro_ib;  // (od)
  const float* ro_jw;  // (2f, od) readout value
  const float* ro_jb;  // (od)
};

// Offsets (in floats) of the zero-padded weights in shared memory; the
// vocab's A matrices follow at kAmat, then the per-slot norm constants.
struct L {
  static constexpr int kA0 = 0;
  static constexpr int kWih = kA0 + FP * FP;
  static constexpr int kWhh = kWih + FP * 3 * FP;
  static constexpr int kBih = kWhh + FP * 3 * FP;
  static constexpr int kBhh = kBih + 3 * FP;
  static constexpr int kMbias = kBhh + 3 * FP;
  static constexpr int kMaW = kMbias + FP;
  static constexpr int kMaB = kMaW + FP;
  static constexpr int kBnW = kMaB + FP;
  static constexpr int kBnB = kBnW + FP;
  static constexpr int kRiw = kBnB + FP;         // rows [h (FP) | h0 (FP)]
  static constexpr int kRjw = kRiw + 2 * FP * ODP;
  static constexpr int kRib = kRjw + 2 * FP * ODP;
  static constexpr int kRjb = kRib + ODP;
  static constexpr int kAmat = kRjb + ODP;       // then K·FP·FP
  __host__ __device__ static int stats(int k_vocab) {
    return kAmat + k_vocab * FP * FP;
  }
  // per slot s = 0..steps: mean, s = sqrt(max(var, clamp)), d = s + eps
  __host__ __device__ static int after_stats(int k_vocab, int steps) {
    return stats(k_vocab) + 3 * FP * (steps + 1);
  }
};

// An integer 0 the compiler cannot see through: offsetting the weight
// pointer by it in each iteration keeps loop-invariant weights in shared
// memory instead of hoisting hundreds of them into (spilled) registers.
__device__ __forceinline__ int opaque_zero() {
  int z = 0;
  asm volatile("" : "+r"(z));
  return z;
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ void stage_weights(float* sm, const Weights& w, int f, int od,
                              int k_vocab) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < FP * FP; i += nt) {
    int r = i / FP, c = i % FP;
    sm[L::kA0 + i] = (r < f && c < f) ? w.a0[r * f + c] : 0.f;
  }
  for (int i = tid; i < FP * 3 * FP; i += nt) {
    int r = i / (3 * FP), gc = i % (3 * FP), g = gc / FP, c = gc % FP;
    bool in = r < f && c < f;
    sm[L::kWih + i] = in ? w.w_ih[r * 3 * f + g * f + c] : 0.f;
    sm[L::kWhh + i] = in ? w.w_hh[r * 3 * f + g * f + c] : 0.f;
  }
  for (int i = tid; i < 3 * FP; i += nt) {
    int g = i / FP, c = i % FP;
    sm[L::kBih + i] = c < f ? w.b_ih[g * f + c] : 0.f;
    sm[L::kBhh + i] = c < f ? w.b_hh[g * f + c] : 0.f;
  }
  for (int i = tid; i < FP; i += nt) {
    bool in = i < f;
    sm[L::kMbias + i] = in ? w.mbias[i] : 0.f;
    sm[L::kMaW + i] = in ? w.ma_w[i] : 0.f;
    sm[L::kMaB + i] = in ? w.ma_b[i] : 0.f;
    sm[L::kBnW + i] = in ? w.bn_w[i] : 0.f;
    sm[L::kBnB + i] = in ? w.bn_b[i] : 0.f;
  }
  for (int i = tid; i < 2 * FP * ODP; i += nt) {
    int r = i / ODP, o = i % ODP, half = r / FP, k = r % FP;
    bool in = k < f && o < od;
    int srow = half * f + k;
    sm[L::kRiw + i] = in ? w.ro_iw[srow * od + o] : 0.f;
    sm[L::kRjw + i] = in ? w.ro_jw[srow * od + o] : 0.f;
  }
  for (int i = tid; i < ODP; i += nt) {
    sm[L::kRib + i] = i < od ? w.ro_ib[i] : 0.f;
    sm[L::kRjb + i] = i < od ? w.ro_jb[i] : 0.f;
  }
  for (int i = tid; i < k_vocab * FP * FP; i += nt) {
    int k = i / (FP * FP), rc = i % (FP * FP), r = rc / FP, c = rc % FP;
    sm[L::kAmat + i] = (r < f && c < f) ? w.amat[(k * f + r) * f + c] : 0.f;
  }
}

// Load a node's f features (zero-padded to NF, FP unless a kernel is
// compiled for a narrower width) from a row-major (·, f) array.
template <int NF = FP>
__device__ __forceinline__ void load_row(const float* base, int n, int f,
                                         float* x) {
#pragma unroll
  for (int j = 0; j < NF; ++j) x[j] = j < f ? base[size_t(n) * f + j] : 0.f;
}

// The same for data another thread wrote earlier in this launch: loads
// that bypass L1 (which is not coherent across SMs) and read L2.
template <int NF = FP>
__device__ __forceinline__ void load_row_cg(const float* base, int n, int f,
                                            float* x) {
#pragma unroll
  for (int j = 0; j < NF; ++j)
    x[j] = j < f ? __ldcg(base + size_t(n) * f + j) : 0.f;
}

template <int NF = FP>
__device__ __forceinline__ void store_row(float* base, int n, int f,
                                          const float* x) {
#pragma unroll
  for (int j = 0; j < NF; ++j)
    if (j < f) base[size_t(n) * f + j] = x[j];
}

// Masked bn1d normalization x̂ = (x − mean) / d with the slot's constants.
__device__ __forceinline__ void xhat_of(const float* st, const float* x,
                                        float* xh) {
#pragma unroll
  for (int j = 0; j < FP; ++j) xh[j] = (x[j] - st[j]) / st[2 * FP + j];
}

// Sum of `v` over the 32 lanes, the same total in every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Per-feature sum over the block's threads of Q·FP values (vals[q][j] per
// thread), in fixed order: warp butterflies, then the warps in order.
// The block totals land in `out` (shared memory, Q·FP floats). Every
// thread of the block must call it. `red` is kWarps·Q·FP floats of
// shared scratch.
template <int Q>
__device__ void block_feature_sums(const float (&vals)[Q][FP], float* red,
                                   float* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
#pragma unroll
    for (int j = 0; j < FP; ++j) {
      float s = warp_sum(vals[q][j]);
      if (lane == 0) red[(warp * Q + q) * FP + j] = s;
    }
  }
  __syncthreads();
  if (threadIdx.x < Q * FP) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * Q * FP + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// Totals over chunks of per-chunk partials part[c·stride + q·FP + j], for
// q < Q, summed in chunk order (4 interleaved partial sums, then combined
// in order). Results in out[q·FP + j]. Every thread of the block must call
// it; needs Q·FP·4 <= kThreads.
template <int Q>
__device__ void chunk_totals(const float* part, int stride, int nchunks,
                             float* red, float* out) {
  static_assert(Q * FP * 4 <= kThreads, "too many sums for one block");
  const int tid = threadIdx.x;
  if (tid < Q * FP * 4) {
    const int qj = tid % (Q * FP), p = tid / (Q * FP);
    float s = 0.f;
    for (int c = p; c < nchunks; c += 4) s += __ldcg(part + size_t(c) * stride + qj);
    red[p * Q * FP + qj] = s;
  }
  __syncthreads();
  if (tid < Q * FP)
    out[tid] = ((red[tid] + red[Q * FP + tid]) + red[2 * Q * FP + tid]) +
               red[3 * Q * FP + tid];
  __syncthreads();
}

// Set the norm constants of one slot from its mean and biased var.
__device__ __forceinline__ void set_slot(float* st, int j, float mean,
                                         float var) {
  const float s = sqrtf(fmaxf(var, kVarClamp));
  st[j] = mean;
  st[FP + j] = s;
  st[2 * FP + j] = s + kEps;
}

}  // namespace mpnn_train
