// Shared pieces of the bilinear family's message + GRU kernels
// (fused_bilinear_fwd.cu, fused_bilinear_bwd.cu): the weights' layout in
// shared memory, the per-graph state buffers and the GRU's gates.
//
// Both kernels run ONE WARP per graph, lanes over its nodes. A step's
// messages come from the evolving state h_{t-1}, which every edge of the
// graph reads at both ends; edges never cross graphs, so a warp keeps its
// graph's states in shared memory and walks the T steps with __syncwarp
// between them — no grid barrier for the recurrence and no float atomics:
// each node's sums run over its destination-sorted in-edges (and, in the
// backward, its source-sorted out-edges) in a fixed order.
//
// Widths are zero-padded to FP = 4 (f 2-4: the bilinear message is
// coherent only for ef = f³, 8-64); the whole A table, K·FP·FP² floats,
// and the GRU weights are staged in shared memory.
// kernels/fused_bilinear.py::BUCKETS and MAX_GRAPH_NODES mirror the
// limits.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace mpnn_bil {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;          // 4 warps, a graph each
constexpr int kWarps = kThreads / 32;
constexpr int FP = 4;                  // f <= FP
constexpr int FP2 = FP * FP;           // φ = h_src ⊗ h_dst, index n·FP + j
constexpr int kMaxVocab = 64;
constexpr int kMaxGraphNodes = 256;    // a warp's graph in shared memory

struct BilWeights {
  const float* amat;   // (K, f, f²): msg[m] = Σ_q amat[k][m][q]·φ[q],
                       // q = n·f + j, φ[q] = h_src[n]·h_dst[j]
  const float* w_ih;   // (f, 3f), gates r|z|n
  const float* w_hh;   // (f, 3f)
  const float* b_ih;   // (3f)
  const float* b_hh;   // (3f)
};

// Offsets (floats) of the zero-padded weights in shared memory; the A
// table [k][m][n·FP + j] follows the GRU's.
struct WL {
  static constexpr int kWih = 0;                   // [k][g·FP + j]
  static constexpr int kWhh = kWih + FP * 3 * FP;
  static constexpr int kBih = kWhh + FP * 3 * FP;  // [g·FP + j]
  static constexpr int kBhh = kBih + 3 * FP;
  static constexpr int kA = kBhh + 3 * FP;
  __host__ __device__ static int total(int k_vocab) {
    return kA + k_vocab * FP * FP2;
  }
};

__device__ void stage_bil_weights(float* sm, const BilWeights& w, int f,
                                  int k_vocab) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < FP * 3 * FP; i += nt) {
    const int r = i / (3 * FP), g = (i % (3 * FP)) / FP, c = i % FP;
    const bool in = r < f && c < f;
    sm[WL::kWih + i] = in ? w.w_ih[r * 3 * f + g * f + c] : 0.f;
    sm[WL::kWhh + i] = in ? w.w_hh[r * 3 * f + g * f + c] : 0.f;
  }
  for (int i = tid; i < 3 * FP; i += nt) {
    const int g = i / FP, c = i % FP;
    sm[WL::kBih + i] = c < f ? w.b_ih[g * f + c] : 0.f;
    sm[WL::kBhh + i] = c < f ? w.b_hh[g * f + c] : 0.f;
  }
  for (int i = tid; i < k_vocab * FP * FP2; i += nt) {
    const int k = i / (FP * FP2), m = (i / FP2) % FP, n = (i % FP2) / FP,
              j = i % FP;
    sm[WL::kA + i] = (m < f && n < f && j < f)
                         ? w.amat[(size_t(k) * f + m) * f * f + n * f + j]
                         : 0.f;
  }
}

// An integer 0 the compiler cannot see through: offsetting the weight
// pointer by it in each iteration keeps loop-invariant weights in shared
// memory instead of hoisting them into registers.
__device__ __forceinline__ int opaque_zero() {
  int z = 0;
  asm volatile("" : "+r"(z));
  return z;
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// x[j] = row[j] for j < f, 0 beyond (a row-major (·, stride) array).
__device__ __forceinline__ void load_vec(const float* row, int f, float* x) {
#pragma unroll
  for (int j = 0; j < FP; ++j) x[j] = j < f ? row[j] : 0.f;
}

__device__ __forceinline__ void store_vec(float* row, int f, const float* x) {
#pragma unroll
  for (int j = 0; j < FP; ++j)
    if (j < f) row[j] = x[j];
}

// The GRU's gate pre-activations: g[gate][j] = b[gate·FP + j] +
// Σ_k x[k]·W[k][gate·FP + j], for the input (kWih, kBih) or hidden (kWhh,
// kBhh) weights.
__device__ __forceinline__ void gates(const float* sm, int wo, int bo,
                                      const float* x, float (&g)[3][FP]) {
#pragma unroll
  for (int gg = 0; gg < 3; ++gg)
#pragma unroll
    for (int j = 0; j < FP; ++j) {
      float t = sm[bo + gg * FP + j];
#pragma unroll
      for (int k = 0; k < FP; ++k)
        t = fmaf(x[k], sm[wo + k * 3 * FP + gg * FP + j], t);
      g[gg][j] = t;
    }
}

// dφ[q] = Σ_m A_k[m][q]·dm[m]: the message's VJP into the outer product.
__device__ __forceinline__ void dphi_of(const float* a, const float* dm,
                                        float* dphi) {
#pragma unroll
  for (int q = 0; q < FP2; ++q) {
    float t = 0.f;
#pragma unroll
    for (int m = 0; m < FP; ++m) t = fmaf(a[m * FP2 + q], dm[m], t);
    dphi[q] = t;
  }
}

}  // namespace mpnn_bil
