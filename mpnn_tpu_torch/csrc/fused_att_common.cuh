// Shared pieces of the attention family's message + GRU kernels
// (fused_att_fwd.cu, fused_att_bwd.cu): the weights' layout in shared
// memory, the gate softmax over the f real features and the GRU forward.
//
// Graph phases run ONE WARP per graph, lanes over its nodes: a node's
// messages are a walk over its destination-sorted in-edges, so every edge
// of the batch belongs to exactly one node and every node to one warp —
// no float atomics, sums in a fixed order. Widths are zero-padded to FP
// (16) in shared memory, so the per-node loops are unrolled at compile
// time; kernels/fused_att.py::MAX_WIDTH, MAX_VOCAB mirror the limits.

#pragma once

#include "fused_train_common.cuh"

namespace mpnn_att {

using namespace mpnn_train;

constexpr int kMaxVocab = 64;

struct AttWeights {
  const float* aprime;  // (K, f, f): msg[m] = Σ_n aprime[k][m][n]·g[n]
  const float* a0;      // (f, f) the non-edge matrix
  const float* qv;      // (K, f) the gate's per-vocab pre-activation
  const float* q0;      // (f) the zero edge's
  const float* wh;      // (f, f): the gate's h_dst block, z = h0[dst]·wh
  const float* w_ih;    // (f, 3f), gates r|z|n
  const float* w_hh;    // (f, 3f)
  const float* b_ih;    // (3f)
  const float* b_hh;    // (3f)
};

// Offsets (floats) of the zero-padded weights in shared memory; the vocab
// tables follow, K·FP of qv then K·FP·FP of aprime.
struct AL {
  static constexpr int kA0 = 0;                  // [m][n]
  static constexpr int kWh = kA0 + FP * FP;      // [i][j]
  static constexpr int kQ0 = kWh + FP * FP;
  static constexpr int kWih = kQ0 + FP;          // [k][g·FP + j]
  static constexpr int kWhh = kWih + FP * 3 * FP;
  static constexpr int kBih = kWhh + FP * 3 * FP;
  static constexpr int kBhh = kBih + 3 * FP;
  static constexpr int kQv = kBhh + 3 * FP;      // [k][j]
  __host__ __device__ static int aprime(int k_vocab) {
    return kQv + k_vocab * FP;                   // [k][m][n]
  }
  __host__ __device__ static int total(int k_vocab) {
    return aprime(k_vocab) + k_vocab * FP * FP;
  }
};

__device__ void stage_att_weights(float* sm, const AttWeights& w, int f,
                                  int k_vocab) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < FP * FP; i += nt) {
    const int r = i / FP, c = i % FP;
    const bool in = r < f && c < f;
    sm[AL::kA0 + i] = in ? w.a0[r * f + c] : 0.f;
    sm[AL::kWh + i] = in ? w.wh[r * f + c] : 0.f;
  }
  for (int i = tid; i < FP; i += nt) sm[AL::kQ0 + i] = i < f ? w.q0[i] : 0.f;
  for (int i = tid; i < FP * 3 * FP; i += nt) {
    const int r = i / (3 * FP), gc = i % (3 * FP), g = gc / FP, c = gc % FP;
    const bool in = r < f && c < f;
    sm[AL::kWih + i] = in ? w.w_ih[r * 3 * f + g * f + c] : 0.f;
    sm[AL::kWhh + i] = in ? w.w_hh[r * 3 * f + g * f + c] : 0.f;
  }
  for (int i = tid; i < 3 * FP; i += nt) {
    const int g = i / FP, c = i % FP;
    sm[AL::kBih + i] = c < f ? w.b_ih[g * f + c] : 0.f;
    sm[AL::kBhh + i] = c < f ? w.b_hh[g * f + c] : 0.f;
  }
  for (int i = tid; i < k_vocab * FP; i += nt) {
    const int k = i / FP, c = i % FP;
    sm[AL::kQv + i] = c < f ? w.qv[k * f + c] : 0.f;
  }
  const int ap = AL::aprime(k_vocab);
  for (int i = tid; i < k_vocab * FP * FP; i += nt) {
    const int k = i / (FP * FP), rc = i % (FP * FP), r = rc / FP, c = rc % FP;
    sm[ap + i] = (r < f && c < f) ? w.aprime[(k * f + r) * f + c] : 0.f;
  }
}

// The per-node helpers below loop over NF features: FP, or a narrower
// bound a kernel is instantiated for (f <= NF), with the shared-memory
// strides FP either way.

// z[j] = Σ_i h[i]·wh[i][j]: the gate's h_dst part, once per node.
template <int NF = FP>
__device__ __forceinline__ void gate_pre(const float* w, const float* h,
                                         float* z) {
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < NF; ++i) t = fmaf(h[i], w[AL::kWh + i * FP + j], t);
    z[j] = t;
  }
}

// out = softmax over the f real features of z + b (padded features 0):
// the max-subtracted softmax the plain version takes.
template <int NF = FP>
__device__ __forceinline__ void feat_softmax(const float* z, const float* b,
                                             int f, float* out) {
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < NF; ++j)
    if (j < f) mx = fmaxf(mx, z[j] + b[j]);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    out[j] = j < f ? expf(z[j] + b[j] - mx) : 0.f;
    s += out[j];
  }
#pragma unroll
  for (int j = 0; j < NF; ++j) out[j] = out[j] / s;
}

// acc[m] += Σ_n mat[m][n]·v[n] for an (FP, FP) matrix in shared memory.
template <int NF = FP>
__device__ __forceinline__ void matvec_add(const float* mat, const float* v,
                                           float* acc) {
#pragma unroll
  for (int m = 0; m < NF; ++m) {
    float t = acc[m];
#pragma unroll
    for (int n = 0; n < NF; ++n) t = fmaf(mat[m * FP + n], v[n], t);
    acc[m] = t;
  }
}

// acc[n] += Σ_m mat[m][n]·v[m]: the transposed product.
template <int NF = FP>
__device__ __forceinline__ void matvec_t_add(const float* mat, const float* v,
                                             float* acc) {
#pragma unroll
  for (int n = 0; n < NF; ++n) {
    float t = acc[n];
#pragma unroll
    for (int m = 0; m < NF; ++m) t = fmaf(mat[m * FP + n], v[m], t);
    acc[n] = t;
  }
}

// The GRU's gate pre-activations from the message m and the hidden state
// hp (both zero-padded): r|z|n input parts gi, hidden parts gh.
__device__ __forceinline__ void gru_pre(const float* w, const float* m,
                                        const float* hp, float (&gi)[3][FP],
                                        float (&gh)[3][FP]) {
#pragma unroll
  for (int j = 0; j < FP; ++j) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      gi[g][j] = w[AL::kBih + g * FP + j];
      gh[g][j] = w[AL::kBhh + g * FP + j];
    }
#pragma unroll
    for (int k = 0; k < FP; ++k) {
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        gi[g][j] = fmaf(m[k], w[AL::kWih + k * 3 * FP + g * FP + j], gi[g][j]);
        gh[g][j] = fmaf(hp[k], w[AL::kWhh + k * 3 * FP + g * FP + j], gh[g][j]);
      }
    }
  }
}

}  // namespace mpnn_att
