// Shared pieces of the T-step attention family's kernels (the `att` model;
// fused_att_steps_fwd.cu, fused_att_steps_bwd.cu): the weight layout in
// shared memory, its staging, and the products with the per-vocab message
// matrices A'_t[k], which stay in device memory.
//
// The att model has Tm message networks (Tm = T per-step, or 1 shared),
// each a gate (Wh_t, qv_t, q0_t) and message tables (A'_t, A0_t) over the
// INITIAL state h0, and one GRU over the evolving state, with the
// stateless masked norm (or none) after each step.
//
// Shared memory holds the GRU in the per-step family's layout (PL, so
// fused_psteps_common.cuh's gru_forward reads it as it is), then one block
// per message step [A0_t | Wh_t | q0_t | qv_t] in the attention family's
// layout (AL: fused_att_common.cuh's gate_pre, feat_softmax and matvec_add
// read a block as they read the collapsed kernels' staged weights), then
// the norm constants of the T state slots. The Tm·K A' tables (196 KB at
// K 64, f 16, Tm 3) are read through the read-only data cache instead;
// everything in shared memory is sized by the real K, Tm and T.

#pragma once

#include "fused_att_common.cuh"
#include "fused_psteps_common.cuh"

namespace mpnn_atts {

using mpnn_att::AL;
using mpnn_psteps::PL;
using mpnn_train::FP;
using mpnn_train::kChunk;
using mpnn_train::kThreads;
using mpnn_train::kWarps;
namespace cg = cooperative_groups;

// kernels/fused_att_steps.py::BUCKETS mirrors these
constexpr int kMaxSteps = 8;
constexpr int kMaxVocab = 64;

// s ← fl(s + b); returns s + b − fl(s + b) exactly (Knuth's two-sum). The
// 'att' correction's graph sums S_g are carried as S + lo with it: S_g's
// rounding, common to a graph's nodes, would add up in the backward's sums
// over a large graph.
__device__ __forceinline__ float two_sum(float& s, float b) {
  const float a = s, t = a + b, bb = t - a;
  s = t;
  return (a - (t - bb)) + (b - bb);
}

struct AttsWeights {
  const float* aprime;  // (Tm, K, f, f): msg[m] = Σ_n aprime[t][k][m][n]·g[n]
  const float* a0;      // (Tm, f, f) the non-edge matrices
  const float* qv;      // (Tm, K, f) the gates' per-vocab pre-activations
  const float* q0;      // (Tm, f) the zero edge's
  const float* wh;      // (Tm, f, f): the gates' h_dst blocks, z = h0·wh_t
  const float* w_ih;    // (f, 3f), gates r|z|n, shared by the steps
  const float* w_hh;    // (f, 3f)
  const float* b_ih;    // (3f)
  const float* b_hh;    // (3f)
};

// Offsets (floats) in shared memory. Inside a step block: AL::kA0, AL::kWh,
// AL::kQ0, then the K vocab rows of qv at kQv.
struct SL {
  static constexpr int kSteps = PL::kBhh + 3 * FP;   // after the GRU
  static constexpr int kQv = AL::kQ0 + FP;           // [k][j]
  __host__ __device__ static int per(int k_vocab) {
    return kQv + k_vocab * FP;
  }
  __host__ __device__ static int step(int t, int k_vocab) {
    return kSteps + t * per(k_vocab);
  }
  // per state slot t < T: mean, s, d (FP each)
  __host__ __device__ static int stats(int tm, int k_vocab) {
    return step(tm, k_vocab);
  }
  __host__ __device__ static int after_stats(int tm, int k_vocab, int steps) {
    return stats(tm, k_vocab) + steps * 3 * FP;
  }
};

// The weights into shared memory, zero-padded: put(d, in, s) stores *s
// (in) or 0 at d — a plain copy, or an asynchronous one the caller waits
// for.
template <class Put>
__device__ void stage_atts_weights(float* sm, const AttsWeights& w, int f,
                                   int k_vocab, int tm, Put put) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < FP * 3 * FP; i += nt) {
    const int r = i / (3 * FP), gc = i % (3 * FP), g = gc / FP, c = gc % FP;
    const bool in = r < f && c < f;
    put(sm + PL::kWih + i, in, w.w_ih + r * 3 * f + g * f + c);
    put(sm + PL::kWhh + i, in, w.w_hh + r * 3 * f + g * f + c);
  }
  for (int i = tid; i < 3 * FP; i += nt) {
    const int g = i / FP, c = i % FP;
    put(sm + PL::kBih + i, c < f, w.b_ih + g * f + c);
    put(sm + PL::kBhh + i, c < f, w.b_hh + g * f + c);
  }
  const int per = SL::per(k_vocab);
  for (int i = tid; i < tm * per; i += nt) {
    const int t = i / per, o = i % per;
    float* d = sm + SL::kSteps + i;
    if (o < AL::kQ0) {                               // A0_t, then Wh_t
      const int oo = o % (FP * FP), r = oo / FP, c = oo % FP;
      const float* src = o < AL::kWh ? w.a0 : w.wh;
      put(d, r < f && c < f, src + (t * f + r) * f + c);
    } else if (o < SL::kQv) {                        // q0_t
      const int j = o - AL::kQ0;
      put(d, j < f, w.q0 + t * f + j);
    } else {                                         // qv_t[k]
      const int k = (o - SL::kQv) / FP, j = (o - SL::kQv) % FP;
      put(d, j < f, w.qv + (t * k_vocab + k) * f + j);
    }
  }
}

__device__ void stage_atts_weights(float* sm, const AttsWeights& w, int f,
                                   int k_vocab, int tm) {
  stage_atts_weights(sm, w, f, k_vocab, tm,
                     [](float* d, bool in, const float* s) {
                       *d = in ? *s : 0.f;
                     });
}

// acc[m] += Σ_n A[m][n]·v[n] for an (f, f) matrix in device memory.
template <int NF>
__device__ __forceinline__ void gmatvec_add(const float* A, int f,
                                            const float* v, float* acc) {
MPNN_UNROLL
  for (int m = 0; m < NF; ++m) {
    if (m < f) {
      float t = acc[m];
MPNN_UNROLL
      for (int n = 0; n < NF; ++n)
        if (n < f) t = fmaf(__ldg(A + m * f + n), v[n], t);
      acc[m] = t;
    }
  }
}

// acc[n] += Σ_m A[m][n]·v[m]: the transposed product.
template <int NF>
__device__ __forceinline__ void gmatvec_t_add(const float* A, int f,
                                              const float* v, float* acc) {
MPNN_UNROLL
  for (int m = 0; m < NF; ++m) {
    if (m < f) {
MPNN_UNROLL
      for (int n = 0; n < NF; ++n)
        if (n < f) acc[n] = fmaf(__ldg(A + m * f + n), v[m], acc[n]);
    }
  }
}

}  // namespace mpnn_atts
