// Shared pieces of the PER-STEP family's whole-step kernels
// (fused_psteps_eval.cu, fused_psteps_fwd.cu, fused_psteps_bwd.cu): the
// weight layout in shared memory, the per-step norm constants, and the
// serving kernel's forward body (the training forward has its own,
// fused_psteps_fwd.cu).
//
// The per-step family (graph_norm, encoded) has one message network per
// step, whose A-form is T tables A_t (K, f, f), T bias-leakage matrices
// A0_t and T message biases; one GRU shared by the steps; per-step norm
// pairs. Messages come from the INITIAL state, so all T message slots are
// computed up front from one gather of h0[src] per edge.
//
// Work mapping and reductions are the shared family's
// (fused_train_common.cuh): graph phases one warp per graph, node phases
// on 128-node chunks (chunk c on block c mod gridDim.x in every phase, so
// a thread reads back its own rows), batch statistics from per-chunk
// partials combined in chunk order after grid.sync(), no float atomics.
//
// The T·K A tables are read from device memory through the read-only data
// cache, not staged in shared memory: at the loader's vocab cap of 64 and
// f = 16 they are 196 KB per step triple, which with the rest would not
// fit a block's 227 KB. Everything else sits in shared memory.

#pragma once

#include "fused_train_common.cuh"

namespace mpnn_psteps {

using mpnn_train::FP;
using mpnn_train::kChunk;
using mpnn_train::kFull;
using mpnn_train::kThreads;
using mpnn_train::kWarps;
using mpnn_train::load_row;
using mpnn_train::load_row_cg;
using mpnn_train::opaque_zero;
using mpnn_train::sigmoidf_;
using mpnn_train::store_row;
using mpnn_train::warp_sum;
namespace cg = cooperative_groups;

// The width bucket: f <= FP (fused_train_common.cuh) and od <= ODW. The
// narrow build takes f <= 16 and od <= 32 (graph_norm has od = 4·afm, 28
// at afm 7; encoded od = 16), the wide one -DMPNN_FP=32 -DMPNN_ODW=128
// (kernels/build.py::WIDE; kernels/fused_psteps.py::BUCKETS).
#ifndef MPNN_ODW
#define MPNN_ODW 32
#endif
constexpr int ODW = MPNN_ODW;
// The readout weights (2·2FP·ODW floats, 64 KB in the wide bucket) sit in
// shared memory in the narrow bucket only; the wide bucket's backward needs
// the room for its 2FP + 2ODW staged floats per node, so there the wrapper
// passes ro_iw and ro_jw zero-padded to (2FP, ODW) in device memory and
// the kernels read them through the read-only cache
// (kernels/fused_step.py::ro_table).
constexpr bool kRoInSmem = ODW <= 32;
constexpr int kMaxSteps = 8;
// steps whose messages one gather of h0[src] feeds (T <= 4: one gather)
constexpr int kStepGroup = 4;
// the norm modes and the slot constants of both eps conventions are the
// shared family's (fused_train_common.cuh)
using mpnn_train::has_stats;
using mpnn_train::kAffine;
using mpnn_train::kBatchBn;
using mpnn_train::kNone;
using mpnn_train::kStateless;
using mpnn_train::set_slot;

struct PsWeights {
  const float* amat;   // (T, K, f, f): step t's message = amat[t][k] @ h0
  const float* a0;     // (T, f, f) bias-leakage matrices
  const float* mbias;  // (T, f)
  const float* w_ih;   // (f, 3f), gates r|z|n, shared by the steps
  const float* w_hh;   // (f, 3f)
  const float* b_ih;   // (3f)
  const float* b_hh;   // (3f)
  const float* ma_w;   // (T, f) message norm: bn1d affine, or folded scale
  const float* ma_b;   // (T, f)                              / shift
  const float* bn_w;   // (T, f) state norm, likewise
  const float* bn_b;   // (T, f)
  const float* ro_iw;  // (2f, od) readout gate, input [h_T | h0]
  const float* ro_ib;  // (od)
  const float* ro_jw;  // (2f, od) readout value
  const float* ro_jb;  // (od)
};

// Offsets (in floats) of the zero-padded weights in shared memory. The
// per-step block of step t starts at step(t); the norm constants of the
// 2T slots (slot t: step t's messages, slot T + t: step t's state) follow.
struct PL {
  static constexpr int kWih = 0;
  static constexpr int kWhh = kWih + FP * 3 * FP;
  static constexpr int kBih = kWhh + FP * 3 * FP;
  static constexpr int kBhh = kBih + 3 * FP;
  static constexpr int kRiw = kBhh + 3 * FP;      // rows [h (FP) | h0 (FP)]
  static constexpr int kRo = kRoInSmem ? 2 * FP * ODW : 0;
  static constexpr int kRjw = kRiw + kRo;
  static constexpr int kRib = kRjw + kRo;
  static constexpr int kRjb = kRib + ODW;
  static constexpr int kSteps = kRjb + ODW;
  // inside a step's block: A0 (FP·FP, row m = output feature), then
  // mbias, ma_w, ma_b, bn_w, bn_b (FP each)
  static constexpr int oA0 = 0;
  static constexpr int oMb = FP * FP;
  static constexpr int oMaW = oMb + FP;
  static constexpr int oMaB = oMaW + FP;
  static constexpr int oBnW = oMaB + FP;
  static constexpr int oBnB = oBnW + FP;
  static constexpr int kPer = oBnB + FP;
  __host__ __device__ static int step(int t) { return kSteps + t * kPer; }
  // per slot: mean, s, d (FP each)
  __host__ __device__ static int stats(int steps) { return step(steps); }
  __host__ __device__ static int after_stats(int steps) {
    return stats(steps) + 2 * steps * 3 * FP;
  }
};

__device__ void stage_ps_weights(float* sm, const PsWeights& w, int f,
                                 int od, int steps) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < FP * 3 * FP; i += nt) {
    int r = i / (3 * FP), gc = i % (3 * FP), g = gc / FP, c = gc % FP;
    bool in = r < f && c < f;
    sm[PL::kWih + i] = in ? w.w_ih[r * 3 * f + g * f + c] : 0.f;
    sm[PL::kWhh + i] = in ? w.w_hh[r * 3 * f + g * f + c] : 0.f;
  }
  for (int i = tid; i < 3 * FP; i += nt) {
    int g = i / FP, c = i % FP;
    sm[PL::kBih + i] = c < f ? w.b_ih[g * f + c] : 0.f;
    sm[PL::kBhh + i] = c < f ? w.b_hh[g * f + c] : 0.f;
  }
  for (int i = tid; kRoInSmem && i < 2 * FP * ODW; i += nt) {
    int r = i / ODW, o = i % ODW, half = r / FP, k = r % FP;
    bool in = k < f && o < od;
    int srow = half * f + k;
    sm[PL::kRiw + i] = in ? w.ro_iw[srow * od + o] : 0.f;
    sm[PL::kRjw + i] = in ? w.ro_jw[srow * od + o] : 0.f;
  }
  for (int i = tid; i < ODW; i += nt) {
    sm[PL::kRib + i] = i < od ? w.ro_ib[i] : 0.f;
    sm[PL::kRjb + i] = i < od ? w.ro_jb[i] : 0.f;
  }
  for (int i = tid; i < steps * PL::kPer; i += nt) {
    const int t = i / PL::kPer, o = i % PL::kPer;
    float v = 0.f;
    if (o < PL::oMb) {
      const int r = o / FP, c = o % FP;
      if (r < f && c < f) v = w.a0[(t * f + r) * f + c];
    } else {
      const int which = (o - PL::oMb) / FP, j = (o - PL::oMb) % FP;
      const float* src = which == 0   ? w.mbias
                         : which == 1 ? w.ma_w
                         : which == 2 ? w.ma_b
                         : which == 3 ? w.bn_w
                                      : w.bn_b;
      if (j < f) v = src[t * f + j];
    }
    sm[PL::step(0) + i] = v;
  }
  // norm constants: identity until a slot is set (mean 0, s = d = 1)
  for (int i = tid; i < 2 * steps * 3 * FP; i += nt)
    sm[PL::stats(steps) + i] = (i % (3 * FP)) < FP ? 0.f : 1.f;
}

// y = norm(x) of one real node in `mode`, with the slot constants `st`
// and the per-feature pair (wv, bv); xh gets x̂ (meaningful in the batch
// modes). Padded features stay zero in every mode.
__device__ __forceinline__ void apply_norm(int mode, const float* st,
                                           const float* wv, const float* bv,
                                           const float* x, float* y,
                                           float* xh) {
MPNN_UNROLL
  for (int j = 0; j < FP; ++j) {
    const float xhat = (x[j] - st[j]) / st[2 * FP + j];
    xh[j] = xhat;
    y[j] = mode == kNone      ? x[j]
           : mode == kBatchBn ? wv[j] * xhat + bv[j]
           : mode == kAffine  ? wv[j] * x[j] + bv[j]
                              : xhat;
  }
}

// One GRU step of a real node from its message input mb and state h.
__device__ __forceinline__ void gru_forward(const float* w, const float* mb,
                                            const float* h, float* out) {
MPNN_UNROLL
  for (int j = 0; j < FP; ++j) {
    float gr = w[PL::kBih + j], gz = w[PL::kBih + FP + j],
          gn = w[PL::kBih + 2 * FP + j];
    float rh = w[PL::kBhh + j], zh = w[PL::kBhh + FP + j],
          nh = w[PL::kBhh + 2 * FP + j];
MPNN_UNROLL
    for (int k = 0; k < FP; ++k) {
      const float* wi = w + PL::kWih + k * 3 * FP;
      const float* wh = w + PL::kWhh + k * 3 * FP;
      gr = fmaf(mb[k], wi[j], gr);
      gz = fmaf(mb[k], wi[FP + j], gz);
      gn = fmaf(mb[k], wi[2 * FP + j], gn);
      rh = fmaf(h[k], wh[j], rh);
      zh = fmaf(h[k], wh[FP + j], zh);
      nh = fmaf(h[k], wh[2 * FP + j], nh);
    }
    const float r = sigmoidf_(gr + rh);
    const float z = sigmoidf_(gz + zh);
    const float nn = tanhf(gn + r * nh);
    out[j] = (1.0f - z) * nn + z * h[j];
  }
}

// The (2FP, ODW) readout gate and value weights: staged in shared memory
// (`w`) or, in the wide bucket, the zero-padded tables in device memory.
__device__ __forceinline__ const float* ro_gate(const float* w,
                                                const PsWeights& pw) {
  return kRoInSmem ? w + PL::kRiw : pw.ro_iw;
}
__device__ __forceinline__ const float* ro_value(const float* w,
                                                 const PsWeights& pw) {
  return kRoInSmem ? w + PL::kRjw : pw.ro_jw;
}

// readout of one real node: gate logits over od (softmax) times values;
// acc[o] += softmax_o · value_o
__device__ __forceinline__ void readout_accumulate(const float* w,
                                                   const PsWeights& pw,
                                                   const float* h,
                                                   const float* h0n, int od,
                                                   float* acc) {
  const float* riw = ro_gate(w, pw);
  const float* rjw = ro_value(w, pw);
  float pi[ODW];
MPNN_UNROLL
  for (int o = 0; o < ODW; ++o) {
    float ti = w[PL::kRib + o];
MPNN_UNROLL
    for (int k = 0; k < FP; ++k) {
      ti = fmaf(h[k], riw[k * ODW + o], ti);
      ti = fmaf(h0n[k], riw[(FP + k) * ODW + o], ti);
    }
    pi[o] = ti;
  }
  float mx = -INFINITY;
MPNN_UNROLL
  for (int o = 0; o < ODW; ++o)
    if (o < od) mx = fmaxf(mx, pi[o]);
  float den = 0.f;
MPNN_UNROLL
  for (int o = 0; o < ODW; ++o) {
    pi[o] = o < od ? expf(pi[o] - mx) : 0.f;
    den += pi[o];
  }
  const float inv = 1.0f / den;
MPNN_UNROLL
  for (int o = 0; o < ODW; ++o) {
    float tj = w[PL::kRjb + o];
MPNN_UNROLL
    for (int k = 0; k < FP; ++k) {
      tj = fmaf(h[k], rjw[k * ODW + o], tj);
      tj = fmaf(h0n[k], rjw[(FP + k) * ODW + o], tj);
    }
    acc[o] = fmaf(pi[o] * inv, tj, acc[o]);
  }
}

// ---------------------------------------------------------------------------
// the serving kernel's forward body (fused_psteps_eval.cu)
// ---------------------------------------------------------------------------

struct PsFwdArgs {
  PsWeights w;
  const float* h0;          // (N, f), pre-masked
  const float* labels;      // unused: null
  const float* gmask;       // unused: null
  const int* vid;           // (E)
  const int* src;           // (E)
  const int* edge_order;    // (E) edge ids, stably sorted by destination
  const int* dst_ptr;       // (N + 1) row pointers into edge_order
  const int* graph_node_ptr;  // (G + 1) node range of each graph
  float* loss;              // unused: null
  float* out;               // (G, od)
  float* stats;             // unused: null
  float* htil;              // (T + 1, N, f): the messages of each step,
                            // then one pre-norm state slot updated in place
  float* scratch;           // chunk partials (fwd_scratch_floats)
  int n_nodes, n_graphs, f, od, k_vocab, steps, msg_mode, state_mode;
};

constexpr int kPartStride = 2 * FP;   // per chunk: Σx (FP), Σ(x−m_c)² (FP)
constexpr int kStage = FP + 1;        // odd stride: conflict-free staging

__host__ __device__ inline long long fwd_scratch_floats(int n_nodes,
                                                        int n_graphs,
                                                        int steps) {
  const long long nchunks = (n_nodes + kChunk - 1) / kChunk;
  return (steps + 2) * nchunks * kPartStride + n_graphs;
}

__host__ __device__ inline size_t fwd_smem_floats(int steps) {
  return size_t(PL::after_stats(steps)) + (kThreads / FP) * FP + FP +
         size_t(kChunk) * kStage;
}

__device__ __forceinline__ int chunk_count(int c, int n_real) {
  return min(kChunk, n_real - c * kChunk);
}

// This chunk's partial moments of the staged values xs[i·kStage + j]
// (i < cnt real nodes, the rest staged as zero): part[j] = Σ x,
// part[FP + j] = Σ (x − mean_chunk)².
__device__ void chunk_moments(const float* xs, int cnt, float* red,
                              float* cmean, float* part) {
  const int tid = threadIdx.x, j = tid % FP, p = tid / FP;  // p < 8
  constexpr int kPer = kChunk / (kThreads / FP);             // 16 nodes
  float s = 0.f;
  for (int i = p * kPer; i < (p + 1) * kPer; ++i) s += xs[i * kStage + j];
  red[p * FP + j] = s;
  __syncthreads();
  if (tid < FP) {
    float t = 0.f;
    for (int q = 0; q < kThreads / FP; ++q) t += red[q * FP + tid];
    part[tid] = t;
    cmean[tid] = t / float(cnt);
  }
  __syncthreads();
  const float m = cmean[j];
  float s2 = 0.f;
  for (int i = p * kPer; i < (p + 1) * kPer; ++i)
    if (i < cnt) {
      const float d = xs[i * kStage + j] - m;
      s2 = fmaf(d, d, s2);
    }
  red[p * FP + j] = s2;
  __syncthreads();
  if (tid < FP) {
    float t = 0.f;
    for (int q = 0; q < kThreads / FP; ++q) t += red[q * FP + tid];
    part[FP + tid] = t;
  }
  __syncthreads();
}

// Batch mean and biased var of one slot from every chunk's partial, in
// chunk order (Chan's formula); sets the slot's constants in shared
// memory, and block 0 writes (mean, var) to `stats` when it is given.
__device__ void combine_slot(const float* part, int nchunks, int n_real,
                             int f, float* red, float* cmean, float* st,
                             bool stateless, float* stats, int slot) {
  const int tid = threadIdx.x, j = tid % FP, p = tid / FP;
  constexpr int kParts = kThreads / FP;                      // 8
  float s = 0.f;
  for (int c = p; c < nchunks; c += kParts)
    s += __ldcg(part + size_t(c) * kPartStride + j);
  red[p * FP + j] = s;
  __syncthreads();
  if (tid < FP) {
    float t = 0.f;
    for (int q = 0; q < kParts; ++q) t += red[q * FP + tid];
    cmean[tid] = t / float(n_real);
  }
  __syncthreads();
  const float mean = cmean[j];
  float m2 = 0.f;
  for (int c = p; c < nchunks; c += kParts) {
    const float cnt = float(chunk_count(c, n_real));
    const float sc = __ldcg(part + size_t(c) * kPartStride + j);
    const float d = sc / cnt - mean;
    m2 += __ldcg(part + size_t(c) * kPartStride + FP + j) + cnt * d * d;
  }
  red[p * FP + j] = m2;
  __syncthreads();
  if (tid < FP) {
    float t = 0.f;
    for (int q = 0; q < kParts; ++q) t += red[q * FP + tid];
    const float var = t / float(n_real);
    set_slot(st, tid, cmean[tid], var, stateless);
    if (stats != nullptr && blockIdx.x == 0 && tid < f) {
      stats[(size_t(slot) * 2) * f + tid] = cmean[tid];
      stats[(size_t(slot) * 2 + 1) * f + tid] = var;
    }
  }
  __syncthreads();
}

// The whole serving forward in one cooperative launch. Phases, with
// their grid barriers:
//   M  messages of all T steps, one warp per graph: per node, one gather
//      of h0[src] per incoming edge feeds kStepGroup steps' A tables;
//      + A0_t·S_g + mbias_t; into htil slots 0..T-1          (1 barrier)
//   R  T recurrent steps on node chunks: message norm (a folded affine)
//      → GRU → state norm; the stateless norm combines chunk partials
//      after each step               (T barriers, or 1 if no statistics)
//   O  the gated readout, one warp per graph
// The state-norm partials alternate between two buffers by step parity
// (a block that combined step t may write step t+1's partials while a
// slower block still reads step t's).
__device__ void psteps_forward(const PsFwdArgs& a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float sm[];
  const int f = a.f, od = a.od, T = a.steps, K = a.k_vocab;
  stage_ps_weights(sm, a.w, f, od, T);
  float* st = sm + PL::stats(T);                       // 2T·3·FP
  float* red = sm + PL::after_stats(T);                // 8·FP
  float* cmean = red + (kThreads / FP) * FP;           // FP
  float* xs = cmean + FP;                              // kChunk·kStage
  __syncthreads();

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int N = a.n_nodes, G = a.n_graphs;
  const int n_real = a.graph_node_ptr[G];
  const int nchunks = (n_real + kChunk - 1) / kChunk;
  // the state partials past T·nchunks rows (fwd_scratch_floats' layout)
  float* part_state = a.scratch + size_t(T) * nchunks * kPartStride;
  const size_t slot_sz = size_t(N) * f;
  const int mmode = a.msg_mode, smode = a.state_mode;
  // the pre-norm state written by each step: one slot, updated in place,
  // since a thread reads back only the rows it wrote
  auto state_slot = [&](int) { return a.htil + size_t(T) * slot_sz; };

  // ---- phase M: messages of all T steps, one warp per graph -------------
  const int gw = blockIdx.x * kWarps + warp, nw = gridDim.x * kWarps;
  for (int g = gw; g < G; g += nw) {
    const int n0 = a.graph_node_ptr[g], n1 = a.graph_node_ptr[g + 1];
    float s[FP];
MPNN_UNROLL
    for (int j = 0; j < FP; ++j) s[j] = 0.f;
    for (int n = n0 + lane; n < n1; n += 32) {
MPNN_UNROLL
      for (int j = 0; j < FP; ++j)
        if (j < f) s[j] += __ldg(a.h0 + size_t(n) * f + j);
    }
MPNN_UNROLL
    for (int j = 0; j < FP; ++j) s[j] = warp_sum(s[j]);
    for (int n = n0 + lane; n < n1; n += 32) {
      const int p0 = __ldg(a.dst_ptr + n), p1 = __ldg(a.dst_ptr + n + 1);
      for (int t0 = 0; t0 < T; t0 += kStepGroup) {
        float acc[kStepGroup][FP];
MPNN_UNROLL
        for (int q = 0; q < kStepGroup; ++q)
MPNN_UNROLL
          for (int m = 0; m < FP; ++m) acc[q][m] = 0.f;
        for (int p = p0; p < p1; ++p) {
          const int e = __ldg(a.edge_order + p);
          const int k = __ldg(a.vid + e);
          float hs[FP];
          load_row(a.h0, __ldg(a.src + e), f, hs);
MPNN_UNROLL
          for (int q = 0; q < kStepGroup; ++q) {
            if (t0 + q < T) {
              const float* am =
                  a.w.amat + (size_t(t0 + q) * K + k) * size_t(f) * f;
MPNN_UNROLL
              for (int m = 0; m < FP; ++m) {
                if (m < f) {
                  float v = 0.f;
MPNN_UNROLL
                  for (int j = 0; j < FP; ++j)
                    if (j < f) v = fmaf(__ldg(am + m * f + j), hs[j], v);
                  acc[q][m] += v;
                }
              }
            }
          }
        }
MPNN_UNROLL
        for (int q = 0; q < kStepGroup; ++q) {
          if (t0 + q < T) {
            const float* ws = sm + opaque_zero() + PL::step(t0 + q);
            float msg[FP];
MPNN_UNROLL
            for (int m = 0; m < FP; ++m) {
              float v = acc[q][m] + ws[PL::oMb + m];
MPNN_UNROLL
              for (int j = 0; j < FP; ++j)
                v = fmaf(ws[PL::oA0 + m * FP + j], s[j], v);
              msg[m] = v;
            }
            store_row(a.htil + size_t(t0 + q) * slot_sz, n, f, msg);
          }
        }
      }
    }
  }
  grid.sync();

  // ---- phase R: T recurrent steps on node chunks ------------------------
  const bool state_stats = has_stats(smode);
  for (int t = 0; t < T; ++t) {
    float* cur = state_slot(t);
    float* part_t = part_state + size_t(t & 1) * nchunks * kPartStride;
    for (int c = blockIdx.x; c < nchunks; c += gridDim.x) {
      const int n = c * kChunk + tid;
      const int cnt = chunk_count(c, n_real);
      float x[FP];
MPNN_UNROLL
      for (int j = 0; j < FP; ++j) x[j] = 0.f;
      if (n < n_real) {
        const float* w = sm + opaque_zero();
        const float* ws = w + PL::step(t);
        float m0[FP], mb[FP], xh[FP], h[FP];
        load_row_cg(a.htil + size_t(t) * slot_sz, n, f, m0);
        apply_norm(mmode, st + t * 3 * FP, ws + PL::oMaW, ws + PL::oMaB, m0,
                   mb, xh);
        if (t == 0) {
          load_row(a.h0, n, f, h);
        } else {
          float hr[FP];
          const float* wp = w + PL::step(t - 1);
          load_row(state_slot(t - 1), n, f, hr);
          apply_norm(smode, st + (T + t - 1) * 3 * FP, wp + PL::oBnW,
                     wp + PL::oBnB, hr, h, xh);
        }
        gru_forward(w, mb, h, x);
        store_row(cur, n, f, x);
      }
      if (state_stats) {
MPNN_UNROLL
        for (int j = 0; j < FP; ++j) xs[tid * kStage + j] = x[j];
        __syncthreads();
        chunk_moments(xs, cnt, red, cmean, part_t + size_t(c) * kPartStride);
      }
    }
    if (state_stats) {
      grid.sync();
      combine_slot(part_t, nchunks, n_real, f, red, cmean,
                   st + (T + t) * 3 * FP, smode == kStateless, nullptr,
                   T + t);
    }
  }
  if (!state_stats) grid.sync();         // every h̃_T visible to the readout

  // ---- phase O: gated readout per graph --------------------------------
  const float* hT = state_slot(T - 1);
  const float* stT = st + (2 * T - 1) * 3 * FP;
  for (int g = gw; g < G; g += nw) {
    const int n0 = a.graph_node_ptr[g], n1 = a.graph_node_ptr[g + 1];
    float acc[ODW];
MPNN_UNROLL
    for (int o = 0; o < ODW; ++o) acc[o] = 0.f;
    for (int n = n0 + lane; n < n1; n += 32) {
      const float* w = sm + opaque_zero();
      const float* ws = w + PL::step(T - 1);
      float hr[FP], h[FP], xh[FP], h0n[FP];
      load_row_cg(hT, n, f, hr);
      apply_norm(smode, stT, ws + PL::oBnW, ws + PL::oBnB, hr, h, xh);
      load_row(a.h0, n, f, h0n);
      readout_accumulate(w, a.w, h, h0n, od, acc);
    }
MPNN_UNROLL
    for (int o = 0; o < ODW; ++o) acc[o] = warp_sum(acc[o]);
    if (lane == 0) {
MPNN_UNROLL
      for (int o = 0; o < ODW; ++o)
        if (o < od) a.out[size_t(g) * od + o] = acc[o];
    }
  }
}

// ---------------------------------------------------------------------------
// the training backwards' reverse walk (fused_psteps_bwd.cu, the whole
// backward; ps_walk_bwd.cu, the split one)
// ---------------------------------------------------------------------------

// First element index >= off owned by this thread (e ≡ tid mod kThreads).
__device__ __forceinline__ int first_owned(int off) {
  return off + ((int(threadIdx.x) - off) % kThreads + kThreads) % kThreads;
}

// wrow[off + i] += v[i] for the elements this thread owns, i < len.
__device__ __forceinline__ void add_owned(float* wrow, int off, int len,
                                          const float* v) {
  for (int e = first_owned(off); e < off + len; e += kThreads)
    wrow[e] += v[e - off];
}

// GRU weight gradients of one chunk, per owned element of the layout's
// [wih, whh, bih, bhh] range, from the staged rows (stride kS) [mb | hprev
// | da_r | da_z | da_n | dnh] (FP each), summed in node order.
template <int kS, class Layout>
__device__ void gru_grads(float* wrow, const Layout& gl, const float* xs,
                          int f) {
  for (int e = first_owned(gl.wih); e < gl.bhh + 3 * f; e += kThreads) {
    int col_x = -1, col_d;
    if (e < gl.bih) {                                  // W_ih, W_hh
      const bool hh = e >= gl.whh;
      const int i = e - (hh ? gl.whh : gl.wih);
      const int k = i / (3 * f), g = (i % (3 * f)) / f, j = i % f;
      col_x = hh ? FP + k : k;
      col_d = (2 + (hh && g == 2 ? 3 : g)) * FP + j;
    } else {                                           // b_ih, b_hh
      const bool hh = e >= gl.bhh;
      const int i = e - (hh ? gl.bhh : gl.bih), g = i / f, j = i % f;
      col_d = (2 + (hh && g == 2 ? 3 : g)) * FP + j;
    }
    float s = 0.f;
    if (col_x >= 0) {
      for (int i = 0; i < kChunk; ++i)
        s = fmaf(xs[i * kS + col_x], xs[i * kS + col_d], s);
    } else {
      for (int i = 0; i < kChunk; ++i) s += xs[i * kS + col_d];
    }
    wrow[e] += s;
  }
}

// The closed-form norm VJP of one real node: dx = (dx̂ − S1/c)/d −
// x̂·S2/(c·s), with the slot constants st and the totals S = [S1 | S2].
__device__ __forceinline__ void norm_vjp(const float* dxh, const float* xh,
                                         const float* st, const float* S,
                                         float c, float* dx) {
MPNN_UNROLL
  for (int j = 0; j < FP; ++j)
    dx[j] = (dxh[j] - S[j] / c) / st[2 * FP + j] -
            xh[j] * S[FP + j] / (c * st[FP + j]);
}

// Step t of the reverse walk for one real node n: from gh (the cotangent
// of the state after step t's norm) through the state-norm VJP (totals
// cs over c real nodes), the GRU replayed from the stash htil (2T, N, f)
// and its VJP. Writes the node's staged row [mb | hprev | da_r | da_z |
// da_n | dnh], ghn (the cotangent of the state before step t), dmb (of
// step t's normalized messages), xhm (x̂ of its messages) and xhp (x̂ of
// the previous state's slot). w: the staged weights; st: the 2T slots'
// constants.
__device__ __forceinline__ void walk_node(
    const float* w, const float* st, const float* cs, const float* htil,
    const float* h0, size_t slot_sz, int n, int f, int t, int T, int mmode,
    int smode, float c, const float* gh, float* row, float* ghn,
    float* dmb, float* xhm, float* xhp) {
  const float* stt = st + (T + t) * 3 * FP;            // state slot t
  const float* stp = st + (T + t - 1) * 3 * FP;        // state slot t−1
  const float* stm = st + t * 3 * FP;                  // message slot t
  const float* wst = w + PL::step(t);
  const float* wsp = w + PL::step(t > 0 ? t - 1 : 0);
  float dhp[FP], hprev[FP], mb[FP];
  if (has_stats(smode)) {
    float x[FP], xh[FP], dxh[FP];
    load_row(htil + size_t(T + t) * slot_sz, n, f, x);
MPNN_UNROLL
    for (int j = 0; j < FP; ++j) {
      xh[j] = (x[j] - stt[j]) / stt[2 * FP + j];
      dxh[j] = smode == kBatchBn ? gh[j] * wst[PL::oBnW + j] : gh[j];
    }
    norm_vjp(dxh, xh, stt, cs, c, dhp);
  } else {
MPNN_UNROLL
    for (int j = 0; j < FP; ++j) dhp[j] = gh[j];
  }
  if (t > 0) {
    float x[FP];
    load_row(htil + size_t(T + t - 1) * slot_sz, n, f, x);
    apply_norm(smode, stp, wsp + PL::oBnW, wsp + PL::oBnB, x, hprev, xhp);
  } else {
    load_row(h0, n, f, hprev);
  }
  {
    float m0[FP];
    load_row(htil + size_t(t) * slot_sz, n, f, m0);
    apply_norm(mmode, stm, wst + PL::oMaW, wst + PL::oMaB, m0, mb, xhm);
  }
MPNN_UNROLL
  for (int j = 0; j < FP; ++j) {
    float gr = w[PL::kBih + j], gz = w[PL::kBih + FP + j],
          gn = w[PL::kBih + 2 * FP + j];
    float rh = w[PL::kBhh + j], zh = w[PL::kBhh + FP + j],
          nh = w[PL::kBhh + 2 * FP + j];
MPNN_UNROLL
    for (int k = 0; k < FP; ++k) {
      const float* wi = w + PL::kWih + k * 3 * FP;
      const float* wh = w + PL::kWhh + k * 3 * FP;
      gr = fmaf(mb[k], wi[j], gr);
      gz = fmaf(mb[k], wi[FP + j], gz);
      gn = fmaf(mb[k], wi[2 * FP + j], gn);
      rh = fmaf(hprev[k], wh[j], rh);
      zh = fmaf(hprev[k], wh[FP + j], zh);
      nh = fmaf(hprev[k], wh[2 * FP + j], nh);
    }
    const float sr = sigmoidf_(gr + rh);
    const float sz = sigmoidf_(gz + zh);
    const float tn = tanhf(gn + sr * nh);
    const float dz = dhp[j] * (hprev[j] - tn);
    const float da_n = dhp[j] * (1.0f - sz) * (1.0f - tn * tn);
    const float dnh = da_n * sr;
    row[2 * FP + j] = da_n * nh * sr * (1.0f - sr);       // da_r
    row[3 * FP + j] = dz * sz * (1.0f - sz);              // da_z
    row[4 * FP + j] = da_n;
    row[5 * FP + j] = dnh;
    row[j] = mb[j];
    row[FP + j] = hprev[j];
    ghn[j] = dhp[j] * sz;
  }
MPNN_UNROLL
  for (int k = 0; k < FP; ++k) {
    const float* wh = w + PL::kWhh + k * 3 * FP;
    const float* wi = w + PL::kWih + k * 3 * FP;
    float th = ghn[k], ti = 0.f;
MPNN_UNROLL
    for (int j = 0; j < FP; ++j) {
      const float dar = row[2 * FP + j], daz = row[3 * FP + j];
      th = fmaf(wh[j], dar, th);
      th = fmaf(wh[FP + j], daz, th);
      th = fmaf(wh[2 * FP + j], row[5 * FP + j], th);
      ti = fmaf(wi[j], dar, ti);
      ti = fmaf(wi[FP + j], daz, ti);
      ti = fmaf(wi[2 * FP + j], row[4 * FP + j], ti);
    }
    ghn[k] = th;
    dmb[k] = ti;
  }
}

// Blocks of a cooperative grid: all co-resident blocks of `kernel` at
// `bytes` of dynamic shared memory, capped at `need`. 0 on error.
template <typename Kernel>
int coop_grid(Kernel kernel, size_t bytes, int need) {
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(bytes)) != cudaSuccess)
    return 0;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, bytes) !=
          cudaSuccess)
    return 0;
  return min(per_sm * sms, max(need, 1));
}

// One cooperative launch of `kernel` with its argument struct; returns
// the launch's error code (0 = success).
template <typename Kernel, typename Args>
int coop_launch(Kernel kernel, Args& a, size_t bytes, int grid,
                void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((void*)kernel, dim3(grid),
                                    dim3(kThreads), args, bytes,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace mpnn_psteps
