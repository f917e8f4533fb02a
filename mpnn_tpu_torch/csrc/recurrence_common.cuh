// Shared pieces of the fused recurrence kernels (recurrence_fwd.cu,
// recurrence_bwd.cu): the weights' layout in shared memory and the
// per-slot norm constants (the masked-BN constants of the whole-step
// training kernels, fused_train_common.cuh).
//
// The function (mpnn_tpu/kernels/recurrence.py::reference_recurrence, the
// lipo family's step chain with its messages constant across steps):
//
//   mb  = bn1d(msgs)                          (batch statistics, slot 0)
//   h   = h0·mask
//   T × { h̃_t = GRU(mb, h);  h = bn1d(h̃_t) } (slot t)
//
// bn1d(x) = (w·(x − μ)/(sqrt(max(var, 1e-12)) + 1e-5) + b)·mask with the
// batch mean μ and the biased variance of the masked rows, each taken in
// two passes over the nodes (the mean, then Σ(x − μ)²). The mask is 0/1
// (the loader's node mask). The four TPU variants of this function —
// monolithic, blocked, merged streaming, and the VMEM-resident reverse
// walk — differ only in how they fit VMEM; here one kernel pair computes it
// at any node count.

#pragma once

#include "fused_train_common.cuh"

namespace mpnn_rec {

using namespace mpnn_train;

struct RecWeights {
  const float* w_ih;   // (f, 3f), gates r|z|n
  const float* w_hh;   // (f, 3f)
  const float* b_ih;   // (3f)
  const float* b_hh;   // (3f)
  const float* ma_w;   // (f) message bn1d affine
  const float* ma_b;
  const float* bn_w;   // (f) state bn1d affine
  const float* bn_b;
};

// Offsets (in floats) of the zero-padded weights in shared memory, then
// the per-slot norm constants: kSlot floats a slot (mean, s =
// sqrt(max(var, clamp)), d = s + eps — fused_train_common.cuh::set_slot —
// and the gate 1[var > clamp] through which the variance takes a
// gradient).
struct RL {
  static constexpr int kWih = 0;
  static constexpr int kWhh = kWih + FP * 3 * FP;
  static constexpr int kBih = kWhh + FP * 3 * FP;
  static constexpr int kBhh = kBih + 3 * FP;
  static constexpr int kMaW = kBhh + 3 * FP;
  static constexpr int kMaB = kMaW + FP;
  static constexpr int kBnW = kMaB + FP;
  static constexpr int kBnB = kBnW + FP;
  static constexpr int kStats = kBnB + FP;
  static constexpr int kSlot = 4 * FP;
  __host__ __device__ static int after_stats(int steps) {
    return kStats + kSlot * (steps + 1);
  }
};

__device__ void stage_rec_weights(float* sm, const RecWeights& w, int f) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < FP * 3 * FP; i += nt) {
    const int r = i / (3 * FP), gc = i % (3 * FP), g = gc / FP, c = gc % FP;
    const bool in = r < f && c < f;
    sm[RL::kWih + i] = in ? w.w_ih[r * 3 * f + g * f + c] : 0.f;
    sm[RL::kWhh + i] = in ? w.w_hh[r * 3 * f + g * f + c] : 0.f;
  }
  for (int i = tid; i < 3 * FP; i += nt) {
    const int g = i / FP, c = i % FP;
    sm[RL::kBih + i] = c < f ? w.b_ih[g * f + c] : 0.f;
    sm[RL::kBhh + i] = c < f ? w.b_hh[g * f + c] : 0.f;
  }
  for (int i = tid; i < FP; i += nt) {
    const bool in = i < f;
    sm[RL::kMaW + i] = in ? w.ma_w[i] : 0.f;
    sm[RL::kMaB + i] = in ? w.ma_b[i] : 0.f;
    sm[RL::kBnW + i] = in ? w.bn_w[i] : 0.f;
    sm[RL::kBnB + i] = in ? w.bn_b[i] : 0.f;
  }
}

// The norm constants of one slot from its mean and biased var.
__device__ __forceinline__ void set_rec_slot(float* st, int j, float mean,
                                             float var) {
  set_slot(st, j, mean, var);
  st[3 * FP + j] = var > kVarClamp ? 1.f : 0.f;
}

}  // namespace mpnn_rec
