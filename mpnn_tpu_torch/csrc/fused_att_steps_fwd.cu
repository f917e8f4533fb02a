// T-step message + GRU + stateless-norm forward of the attention model
// `att` (models/att_model.py's composition), hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel mpnn_tpu/kernels/fused_att.py::
// _att_steps_fwd_kernel with its edge body _att_steps_edge_fwd (the
// forward of make_fused_att_steps_op). With Tm message tables (Tm = T, or
// 1 when the steps share their message network), per node v of graph g
// and its destination-sorted in-edges e (src u, vocab id k):
//
//   for t < Tm:  gate_e = softmax_feat(h0[v]·Wh_t + qv_t[k])
//                m_t[v] = Σ_e A'_t[k]·(gate_e ⊙ h0[u])
//                         + A0_t·(g0_v ⊙ (S_g − Σ_e h0[u]))   ('att' only,
//                  g0_v = softmax_feat(h0[v]·Wh_t + q0_t), S_g = Σ_{w∈g} h0)
//   h = h0;  for t < T:  h̃_t = GRU(m_{min(t, Tm−1)}, h);
//                        h = (h̃_t − mean_t) / sqrt(var_t + 1e-6)
//                            (the stateless norm: mean and biased var of
//                             h̃_t over every real node of the batch; or
//                             h = h̃_t with no norm)
//
// Outputs h_T (N, f) and, for training (the backward reads them instead of
// replaying the forward), the residuals of the Pallas kernel: the Tm
// masked message slots (Tm, N, f), the T pre-norm states h̃_t (T, N, f)
// and the (mean, var) of each step (T, 2, f). Serving keeps one state
// slot, updated in place, and writes no statistics. Padded rows are zeros.
//
// Bound on an H100: per edge and message step ~2f² + 7f operations on a
// gathered row, per node and step the GRU (~6·3f² operations) and the
// norm; at the att widths (f 7, T 3) a batch of 1,024 molecules is tens of
// MFLOP and a few MB, about a microsecond, set by the bytes of the stash
// (chip_smoke.py::_atts_bounds counts it). What it costs in practice is
// the T grid barriers in series and the launch.
//
// Design: ONE cooperative launch. Phase M, one warp per graph, lanes over
// its nodes: every node's Tm message slots, each a walk over its in-edges
// (h0·Wh_t once per node, every in-edge shares it), no barrier inside, no
// atomics. One grid barrier. Phase R, the T steps on 128-node chunks
// (chunk c on block c mod gridDim.x in every phase, so a thread reads back
// the rows it wrote): GRU, then the chunk's partial moments; after a grid
// barrier every block combines the chunk partials in chunk order (Chan's
// formula) into the same statistics, double-buffered by step parity (a
// block that combined step t may write step t+1's partials while a slower
// one still reads step t's). No barrier in the chain without the norm.
// Instantiated for f <= 8 (the att model's 7) and f <= 16 in the narrow
// build, f <= 32 in the wide one (kernels/build.py::WIDE).

#include "fused_att_steps_common.cuh"

namespace {

using namespace mpnn_atts;
using mpnn_att::feat_softmax;
using mpnn_att::gate_pre;
using mpnn_att::matvec_add;
using mpnn_psteps::chunk_count;
using mpnn_psteps::kPartStride;
using mpnn_psteps::kStage;
using mpnn_train::load_row;
using mpnn_train::load_row_cg;
using mpnn_train::kFull;
using mpnn_train::opaque_zero;
using mpnn_train::store_row;
using mpnn_train::warp_sum;

struct FwdArgs {
  AttsWeights w;
  const float* h0;              // (N, f), pre-masked
  const int* vid;               // (E)
  const int* src;               // (E)
  const int* edge_order;        // (E) edge ids, stably sorted by dst
  const int* dst_ptr;           // (N + 1)
  const int* graph_node_ptr;    // (G + 1)
  float* h;                     // (N, f) h_T
  float* msgs;                  // (Tm, N, f) masked messages
  float* htil;                  // (T, N, f) pre-norm states in training,
                                // (1, N, f) at serving time
  float* stats;                 // (T, 2, f) mean, biased var (training)
  float* scratch;               // 2 · nchunks · kPartStride chunk partials
  int n_nodes, n_graphs, f, k_vocab, steps, tm, with_corr, stateless, train;
};

__host__ __device__ inline size_t fwd_smem_floats(int tm, int k_vocab,
                                                  int steps) {
  return size_t(SL::after_stats(tm, k_vocab, steps)) + (kThreads / FP) * FP +
         FP + size_t(kChunk) * kStage;
}

template <int NF>
__global__ void __launch_bounds__(kThreads, 1)
fused_att_steps_fwd_kernel(FwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float sm[];
  const int f = a.f, K = a.k_vocab, T = a.steps, Tm = a.tm;
  stage_atts_weights(sm, a.w, f, K, Tm);
  float* st = sm + SL::stats(Tm, K);                   // T·3·FP
  float* red = sm + SL::after_stats(Tm, K, T);         // 8·FP
  float* cmean = red + (kThreads / FP) * FP;           // FP
  float* xs = cmean + FP;                              // kChunk·kStage
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int N = a.n_nodes, G = a.n_graphs;
  const int n_real = a.graph_node_ptr[G];
  const int nchunks = (n_real + kChunk - 1) / kChunk;
  const size_t slot_sz = size_t(N) * f;
  const bool stateless = a.stateless != 0, train = a.train != 0;
  auto state_slot = [&](int t) {
    return a.htil + size_t(train ? t : 0) * slot_sz;
  };

  {  // padded rows of every output are zeros; no statistics without a norm
    const size_t pad = size_t(N - n_real) * f;
    const int slots = 1 + Tm + (train ? T : 0);
    for (size_t i = size_t(blockIdx.x) * kThreads + tid; i < pad * slots;
         i += size_t(gridDim.x) * kThreads) {
      const size_t s = i / pad, r = i % pad;
      float* base = s == 0    ? a.h
                    : s <= Tm ? a.msgs + (s - 1) * slot_sz
                              : a.htil + (s - 1 - Tm) * slot_sz;
      base[size_t(n_real) * f + r] = 0.f;
    }
    if (train && !stateless && blockIdx.x == 0)
      for (int i = tid; i < T * 2 * f; i += kThreads) a.stats[i] = 0.f;
  }
  __syncthreads();

  // ---- phase M: the Tm message slots, one warp per graph ----------------
  for (int g = blockIdx.x * kWarps + warp; g < G; g += gridDim.x * kWarps) {
    const int n0 = a.graph_node_ptr[g], n1 = a.graph_node_ptr[g + 1];
    // S_g as the unevaluated sum S + lo (two_sum; lo in `red`, a row a
    // warp), X_v = S_g − Σ_e h0[u] as fl(S − Σ) + (its error + lo)
    float S[NF];
    float* lo = red + warp * FP;
MPNN_UNROLL
    for (int j = 0; j < NF; ++j) S[j] = 0.f;
    if (a.with_corr) {
      float L[NF];
MPNN_UNROLL
      for (int j = 0; j < NF; ++j) L[j] = 0.f;
      for (int n = n0 + lane; n < n1; n += 32) {
        float hn[NF];
        load_row<NF>(a.h0, n, f, hn);
MPNN_UNROLL
        for (int j = 0; j < NF; ++j) L[j] += two_sum(S[j], hn[j]);
      }
MPNN_UNROLL
      for (int j = 0; j < NF; ++j)
        for (int off = 16; off > 0; off >>= 1) {
          const float ol = __shfl_xor_sync(kFull, L[j], off);
          L[j] += ol + two_sum(S[j], __shfl_xor_sync(kFull, S[j], off));
        }
      if (lane == 0)
MPNN_UNROLL
        for (int j = 0; j < NF; ++j) lo[j] = L[j];
      __syncwarp();
    }
    for (int n = n0 + lane; n < n1; n += 32) {
      float h0n[NF];
      load_row<NF>(a.h0, n, f, h0n);
      const int p0 = __ldg(a.dst_ptr + n), p1 = __ldg(a.dst_ptr + n + 1);
      for (int t = 0; t < Tm; ++t) {
        const float* blk = sm + opaque_zero() + SL::step(t, K);
        const float* at = a.w.aprime + size_t(t) * K * f * f;
        float zh[NF], acc[NF], xsum[NF];
        gate_pre<NF>(blk, h0n, zh);
MPNN_UNROLL
        for (int j = 0; j < NF; ++j) acc[j] = xsum[j] = 0.f;
        for (int p = p0; p < p1; ++p) {
          const int e = __ldg(a.edge_order + p);
          const int k = __ldg(a.vid + e);
          float hs[NF], gate[NF];
          load_row<NF>(a.h0, __ldg(a.src + e), f, hs);
          feat_softmax<NF>(zh, blk + SL::kQv + k * FP, f, gate);
MPNN_UNROLL
          for (int j = 0; j < NF; ++j) {
            xsum[j] += hs[j];
            gate[j] *= hs[j];
          }
          gmatvec_add<NF>(at + size_t(k) * f * f, f, gate, acc);
        }
        if (a.with_corr) {
          float g0[NF];
          feat_softmax<NF>(zh, blk + AL::kQ0, f, g0);
MPNN_UNROLL
          for (int j = 0; j < NF; ++j) {
            float x = S[j];
            const float e = two_sum(x, -xsum[j]);
            g0[j] *= x + (e + lo[j]);
          }
          matvec_add<NF>(blk + AL::kA0, g0, acc);
        }
        store_row<NF>(a.msgs + size_t(t) * slot_sz, n, f, acc);
      }
    }
  }
  grid.sync();

  // ---- phase R: T steps of GRU → norm on node chunks -------------------
  for (int t = 0; t < T; ++t) {
    float* cur = state_slot(t);
    float* part_t = a.scratch + size_t(t & 1) * nchunks * kPartStride;
    const float* mslot = a.msgs + size_t(min(t, Tm - 1)) * slot_sz;
    for (int c = blockIdx.x; c < nchunks; c += gridDim.x) {
      const int n = c * kChunk + tid;
      float x[FP];
MPNN_UNROLL
      for (int j = 0; j < FP; ++j) x[j] = 0.f;
      if (n < n_real) {
        float mb[FP], h[FP];
        load_row_cg(mslot, n, f, mb);
        if (t == 0) {
          load_row(a.h0, n, f, h);
        } else {
          load_row(state_slot(t - 1), n, f, h);
          if (stateless) mpnn_train::xhat_of(st + (t - 1) * 3 * FP, h, h);
        }
        mpnn_psteps::gru_forward(sm + opaque_zero(), mb, h, x);
        store_row(cur, n, f, x);
      }
      if (stateless) {
MPNN_UNROLL
        for (int j = 0; j < FP; ++j) xs[tid * kStage + j] = x[j];
        __syncthreads();
        mpnn_psteps::chunk_moments(xs, chunk_count(c, n_real), red, cmean,
                                   part_t + size_t(c) * kPartStride);
      }
    }
    if (stateless) {
      grid.sync();
      mpnn_psteps::combine_slot(part_t, nchunks, n_real, f, red, cmean,
                                st + t * 3 * FP, true,
                                train ? a.stats : nullptr, t);
    }
  }

  // ---- h_T of every real node (the rows this thread wrote) -------------
  for (int c = blockIdx.x; c < nchunks; c += gridDim.x) {
    const int n = c * kChunk + tid;
    if (n >= n_real) continue;
    float x[FP];
    load_row(state_slot(T - 1), n, f, x);
    if (stateless) mpnn_train::xhat_of(st + (T - 1) * 3 * FP, x, x);
    store_row(a.h, n, f, x);
  }
}

// The instantiation that runs width f.
const void* kernel_for(int f) {
  if constexpr (FP <= 16)               // the narrow bucket's two builds
    if (f <= 8) return (const void*)fused_att_steps_fwd_kernel<8>;
  return (const void*)fused_att_steps_fwd_kernel<FP>;
}

}  // namespace

extern "C" {

int mpnn_fused_att_steps_fwd_smem_bytes(int tm, int k_vocab, int steps) {
  return int(sizeof(float) * fwd_smem_floats(tm, k_vocab, steps));
}

long long mpnn_fused_att_steps_fwd_scratch_floats(int n_nodes) {
  return 2LL * ((n_nodes + kChunk - 1) / kChunk) * kPartStride;
}

int mpnn_fused_att_steps_fwd_grid(int f, int tm, int k_vocab, int steps,
                                  int n_nodes, int n_graphs) {
  const int need = max((n_nodes + kChunk - 1) / kChunk,
                       (n_graphs + kWarps - 1) / kWarps);
  return mpnn_psteps::coop_grid(
      kernel_for(f), sizeof(float) * fwd_smem_floats(tm, k_vocab, steps),
      need);
}

int mpnn_fused_att_steps_fwd(
    const float* aprime, const float* a0, const float* qv, const float* q0,
    const float* wh, const float* w_ih, const float* w_hh, const float* b_ih,
    const float* b_hh, const float* h0, const int* vid, const int* src,
    const int* edge_order, const int* dst_ptr, const int* graph_node_ptr,
    float* h, float* msgs, float* htil, float* stats, float* scratch,
    int n_nodes, int n_graphs, int f, int k_vocab, int steps, int tm,
    int with_corr, int stateless, int train, int grid, void* stream) {
  if (f < 1 || f > FP || k_vocab < 1 || k_vocab > kMaxVocab || steps < 1 ||
      steps > kMaxSteps || (tm != steps && tm != 1) || n_graphs < 1 ||
      grid < 1 || (train && stats == nullptr))
    return int(cudaErrorInvalidValue);
  FwdArgs a{{aprime, a0, qv, q0, wh, w_ih, w_hh, b_ih, b_hh},
            h0, vid, src, edge_order, dst_ptr, graph_node_ptr, h, msgs, htil,
            stats, scratch, n_nodes, n_graphs, f, k_vocab, steps, tm,
            with_corr, stateless, train};
  return mpnn_psteps::coop_launch(
      kernel_for(f), a, sizeof(float) * fwd_smem_floats(tm, k_vocab, steps),
      grid, stream);
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
