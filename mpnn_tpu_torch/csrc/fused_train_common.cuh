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

#include "unroll.cuh"

namespace mpnn_train {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;        // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads;     // node slots per node chunk
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-5f;        // masked bn1d: eps OUTSIDE the sqrt
constexpr float kVarClamp = 1e-12f;  // var clamped inside the sqrt
constexpr float kStatelessEps = 1e-6f;  // stateless norm: eps INSIDE the sqrt

// Norm modes of a slot (kernels/fused_step.py, kernels/fused_psteps.py):
// none; bn1d on batch statistics (training); a folded per-feature affine
// (eval bn1d); the stateless norm on batch statistics (eval and training:
// no affine, no running state).
enum Mode { kNone = 0, kBatchBn = 1, kAffine = 2, kStateless = 3 };

__host__ __device__ inline bool has_stats(int mode) {
  return mode == kBatchBn || mode == kStateless;
}

// The width bucket: f <= FP and od <= ODP, zero-padded. kernels/build.py
// compiles the narrow bucket (16, 16; the lipo family at bench widths,
// f = 10, od = 14) and the others of kernels/fused_step.py::BUCKETS with
// -DMPNN_FP / -DMPNN_ODP.
#ifndef MPNN_FP
#define MPNN_FP 16
#endif
#ifndef MPNN_ODP
#define MPNN_ODP 16
#endif
constexpr int FP = MPNN_FP;
constexpr int ODP = MPNN_ODP;
static_assert(FP <= 32 && kThreads % FP == 0, "a feature per lane at most");
constexpr int kMaxSteps = 32;
// The vocab's (K, FP, FP) message tables: staged in shared memory in the
// narrow bucket; past FP 16 they would take most of a block's 227 KB (256
// KB at K 64), so the wrapper passes them zero-padded to (K, FP, FP) and
// the kernels read them from device memory through the read-only cache
// (kernels/fused_step.py::vocab_table).
constexpr bool kVocabInSmem = FP <= 16;
// The (2FP, ODP) readout weights: staged in shared memory up to ODP 64.
// Past it they would take 64 KB of a block at FP 32, and a thread's
// od-long logit arrays would spill: the wrapper passes them zero-padded to
// (2FP, ODP) in device memory (kernels/fused_step.py::ro_table), and the
// readout runs with lanes over od (warp_readout_rows).
constexpr bool kRoInSmem = ODP <= 64;
// outputs per lane in the wide-od builds
constexpr int kOdLanes = ODP >= 32 ? ODP / 32 : 1;
static_assert(kRoInSmem || ODP % 32 == 0, "wide od in whole warps");

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
  static constexpr int kRo = kRoInSmem ? 2 * FP * ODP : 0;
  static constexpr int kRjw = kRiw + kRo;
  static constexpr int kRib = kRjw + kRo;
  static constexpr int kRjb = kRib + ODP;
  static constexpr int kAmat = kRjb + ODP;       // then K·FP·FP (narrow)
  __host__ __device__ static int stats(int k_vocab) {
    return kAmat + (kVocabInSmem ? k_vocab * FP * FP : 0);
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

// Stage the weights. Without `state_affine` (the stateless state norm) the
// state norm's affine is the identity: weight 1, bias 0 on real features.
__device__ void stage_weights(float* sm, const Weights& w, int f, int od,
                              int k_vocab, bool state_affine = true) {
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
    sm[L::kBnW + i] = in ? (state_affine ? w.bn_w[i] : 1.f) : 0.f;
    sm[L::kBnB + i] = in && state_affine ? w.bn_b[i] : 0.f;
  }
  for (int i = tid; kRoInSmem && i < 2 * FP * ODP; i += nt) {
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
  if (!kVocabInSmem) return;
  for (int i = tid; i < k_vocab * FP * FP; i += nt) {
    int k = i / (FP * FP), rc = i % (FP * FP), r = rc / FP, c = rc % FP;
    sm[L::kAmat + i] = (r < f && c < f) ? w.amat[(k * f + r) * f + c] : 0.f;
  }
}

// The (FP, FP) message table of vocab id k: in shared memory (`w`, the
// staged weights) or, in a wide bucket, the zero-padded table in device
// memory.
__device__ __forceinline__ const float* amat_of(const float* w,
                                                const Weights& wt, int k) {
  return (kVocabInSmem ? w + L::kAmat : wt.amat) + size_t(k) * FP * FP;
}

// The (2FP, ODP) readout gate and value weights: in shared memory (`w`)
// or, past ODP 64, the zero-padded tables in device memory.
__device__ __forceinline__ const float* ro_gate(const float* w,
                                                const Weights& wt) {
  return kRoInSmem ? w + L::kRiw : wt.ro_iw;
}
__device__ __forceinline__ const float* ro_value(const float* w,
                                                 const Weights& wt) {
  return kRoInSmem ? w + L::kRjw : wt.ro_jw;
}

// Load a node's f features (zero-padded to NF, FP unless a kernel is
// compiled for a narrower width) from a row-major (·, f) array.
template <int NF = FP>
__device__ __forceinline__ void load_row(const float* base, int n, int f,
                                         float* x) {
MPNN_UNROLL
  for (int j = 0; j < NF; ++j) x[j] = j < f ? base[size_t(n) * f + j] : 0.f;
}

// The same for data another thread wrote earlier in this launch: loads
// that bypass L1 (which is not coherent across SMs) and read L2.
template <int NF = FP>
__device__ __forceinline__ void load_row_cg(const float* base, int n, int f,
                                            float* x) {
MPNN_UNROLL
  for (int j = 0; j < NF; ++j)
    x[j] = j < f ? __ldcg(base + size_t(n) * f + j) : 0.f;
}

template <int NF = FP>
__device__ __forceinline__ void store_row(float* base, int n, int f,
                                          const float* x) {
MPNN_UNROLL
  for (int j = 0; j < NF; ++j)
    if (j < f) base[size_t(n) * f + j] = x[j];
}

// Masked bn1d normalization x̂ = (x − mean) / d with the slot's constants.
__device__ __forceinline__ void xhat_of(const float* st, const float* x,
                                        float* xh) {
MPNN_UNROLL
  for (int j = 0; j < FP; ++j) xh[j] = (x[j] - st[j]) / st[2 * FP + j];
}

// Sum of `v` over the 32 lanes, the same total in every lane.
__device__ __forceinline__ float warp_sum(float v) {
MPNN_UNROLL
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
MPNN_UNROLL
  for (int q = 0; q < Q; ++q) {
MPNN_UNROLL
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
// q < Q, summed in chunk order (P interleaved partial sums, 4 where the
// block has the threads, then combined in order). Results in
// out[q·FP + j]. Every thread of the block must call it.
template <int Q>
__device__ void chunk_totals(const float* part, int stride, int nchunks,
                             float* red, float* out) {
  constexpr int P = kThreads / (Q * FP) < 4 ? kThreads / (Q * FP) : 4;
  static_assert(P >= 1, "too many sums for one block");
  const int tid = threadIdx.x;
  if (tid < Q * FP * P) {
    const int qj = tid % (Q * FP), p = tid / (Q * FP);
    float s = 0.f;
    for (int c = p; c < nchunks; c += P) s += __ldcg(part + size_t(c) * stride + qj);
    red[p * Q * FP + qj] = s;
  }
  __syncthreads();
  if (tid < Q * FP) {
    float s = red[tid];
MPNN_UNROLL
    for (int p = 1; p < P; ++p) s += red[p * Q * FP + tid];
    out[tid] = s;
  }
  __syncthreads();
}

// Set the norm constants of one slot from its mean and biased var: bn1d
// normalizes by d = sqrt(max(var, 1e-12)) + 1e-5 (s without the eps), the
// stateless norm by d = s = sqrt(var + 1e-6).
__device__ __forceinline__ void set_slot(float* st, int j, float mean,
                                         float var, bool stateless = false) {
  const float s = stateless ? sqrtf(var + kStatelessEps)
                            : sqrtf(fmaxf(var, kVarClamp));
  st[j] = mean;
  st[FP + j] = s;
  st[2 * FP + j] = stateless ? s : s + kEps;
}

// The gated readout of `cnt` <= 32 staged nodes by one warp with lanes
// over od (the wide-od builds): rows xr[i·RS + k], k < 2FP, hold
// [h (FP) | h0 (FP)] zero-padded; lane l owns the outputs o = l + 32q, and
// acc[q] += softmax_o(W_iᵀx + b_i)·(W_jᵀx + b_j) for each node in order.
// The softmax's max and sum are butterflies, the same in every lane. Every
// lane of the warp must call it.
template <int RS>
__device__ __forceinline__ void warp_readout_rows(
    const float* xr, int cnt, const float* riw, const float* rjw,
    const float* rib, const float* rjb, int od, float (&acc)[kOdLanes]) {
  const int lane = threadIdx.x % 32;
  for (int i = 0; i < cnt; ++i) {
    const float* x = xr + i * RS;
    float pi[kOdLanes], pj[kOdLanes];
MPNN_UNROLL
    for (int q = 0; q < kOdLanes; ++q) {
      const int o = lane + 32 * q;
      float ti = rib[o], tj = rjb[o];
MPNN_UNROLL
      for (int k = 0; k < 2 * FP; ++k) {
        const float xk = x[k];
        ti = fmaf(xk, __ldg(riw + k * ODP + o), ti);
        tj = fmaf(xk, __ldg(rjw + k * ODP + o), tj);
      }
      pi[q] = ti;
      pj[q] = tj;
    }
    float mx = -INFINITY;
MPNN_UNROLL
    for (int q = 0; q < kOdLanes; ++q)
      if (lane + 32 * q < od) mx = fmaxf(mx, pi[q]);
MPNN_UNROLL
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    float den = 0.f;
MPNN_UNROLL
    for (int q = 0; q < kOdLanes; ++q) {
      pi[q] = lane + 32 * q < od ? expf(pi[q] - mx) : 0.f;
      den += pi[q];
    }
    den = warp_sum(den);
MPNN_UNROLL
    for (int q = 0; q < kOdLanes; ++q) acc[q] += (pi[q] / den) * pj[q];
  }
}

}  // namespace mpnn_train
