// T-step message + GRU + stateless-norm backward of the attention model
// `att`, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mpnn_tpu/kernels/fused_att.py::
// _att_steps_bwd_kernel (the VJP of make_fused_att_steps_op). Given
// gh = ∂L/∂h_T and the forward's residuals (the Tm masked message slots,
// the T pre-norm states h̃_t, each step's mean and var):
//
//   reverse chain, t = T−1..0:
//     stateless-norm VJP with d = s = sqrt(var_t + 1e-6), x̂ = (h̃_t − mean)/d
//       and the batch sums S1 = Σ g, S2 = Σ g·x̂ over every real node:
//       ∂h̃_t = (g − S1/c)/d − x̂·S2/(c·s)                  (g when no norm)
//     GRU VJP → ∂h_{t−1} (the next g; at t = 0, ∂h0's hidden path),
//       ∂W_ih, ∂W_hh, ∂b_ih, ∂b_hh, and ∂m summed into slot min(t, Tm−1)
//   per message step t, per node v (graph g, in-edges e: src u, vocab k):
//     dm = ∂m_t[v];  dg_e = A'_t[k]ᵀ·dm;  ∂A'_t[k] += dm ⊗ (gate_e ⊙ h0[u]);
//     dz_e = gate_e ⊙ (dg_e ⊙ h0[u] − Σ dg_e ⊙ h0[u] ⊙ gate_e) (softmax VJP)
//       → ∂qv_t[k];  ∂h0[u] += dg_e ⊙ gate_e
//     'att' correction A0_t·(g0_v ⊙ X_v), X_v = S_g − Σ_e h0[u]:
//       ∂A0_t += dm ⊗ (g0_v ⊙ X_v); dX = (A0_tᵀ·dm) ⊙ g0_v reaches every
//       node of g (through S_g, one warp sum) and, negated, each in-edge's
//       source; dz0_v (the softmax VJP of g0_v) → ∂q0_t
//     ∂Wh_t += h0[v] ⊗ (Σ_e dz_e + dz0_v);  ∂h0[v] += Wh_t·(Σ_e dz_e + dz0_v)
//
// Bound on an H100: about twice the forward's operations on the same
// rows, and the stash read once; microseconds at batch 1,024 — the T + 3
// grid barriers in series dominate (chip_smoke.py::_atts_bounds counts it).
//
// Design: ONE cooperative launch, no float atomics, sums in a fixed order.
// The chain runs on 128-node chunks (chunk c on block c mod gridDim.x, a
// thread reads back its own rows); the batch sums of step t−1 are taken in
// the same chunk pass as step t's GRU VJP, combined in chunk order after
// one grid barrier into shared memory, double-buffered by step parity (T
// barriers in all, none without the norm). Then one warp per graph walks
// each node's in-edges for every message step (A'_t read from device
// memory), writes the per-node and per-edge terms of the weight gradients
// to scratch rows and each edge's source cotangent (summed over the steps
// by the lane that owns the edge's destination), and, after a __syncwarp,
// walks its nodes' out-edges (the device-built source order) to sum them.
// Weight gradients go to a block-private row, each element owned by one
// thread: the GRU's from shared-memory rows of each chunk of the chain,
// the message tables' from node and edge chunks after a grid barrier; the
// rows are reduced in block order after a last one. Deterministic for a
// given grid. Instantiated for f <= 8 (the att model's 7) and f <= 16.

#include "fused_att_steps_common.cuh"

namespace {

using namespace mpnn_atts;
using mpnn_att::feat_softmax;
using mpnn_att::gate_pre;
using mpnn_att::matvec_add;
using mpnn_att::matvec_t_add;
using mpnn_train::block_feature_sums;
using mpnn_train::chunk_totals;
using mpnn_train::load_row;
using mpnn_train::load_row_cg;
using mpnn_train::opaque_zero;
using mpnn_train::sigmoidf_;
using mpnn_train::store_row;
using mpnn_train::warp_sum;

// Flat layout of the gradient output (and of each block's partial row):
// real shapes, in this order. kernels/fused_att_steps.py::grad_layout
// mirrors it and checks it against mpnn_fused_att_steps_bwd_layout.
struct AttsGradLayout {
  int a, a0, qv, q0, wh, wih, whh, bih, bhh, total;
  __host__ __device__ AttsGradLayout(int tm, int k, int f) {
    a = 0;
    a0 = a + tm * k * f * f;
    qv = a0 + tm * f * f;
    q0 = qv + tm * k * f;
    wh = q0 + tm * f;
    wih = wh + tm * f * f;
    whh = wih + 3 * f * f;
    bih = whh + 3 * f * f;
    bhh = bih + 3 * f;
    total = bhh + 3 * f;
  }
};

// Scratch rows, f floats per segment: per chain node [mb | hprev | da_r |
// da_z | da_n | dnh] (shared memory only); per message step and node
// [g0 ⊙ X | dz0 | dzall]; per message step and edge [gate ⊙ h0[u] | dz].
enum { kMb, kHp, kDar, kDaz, kDan, kDnh, kChainSegs };
enum { kG0x, kDz0, kDzall, kNodeSegs };
constexpr int kEdgeSegs = 2;

struct BwdArgs {
  AttsWeights w;
  const float* h0;              // (N, f), pre-masked
  const float* msgs;            // (Tm, N, f) the forward's masked messages
  const float* htil;            // (T, N, f) the forward's pre-norm states
  const float* stats;           // (T, 2, f) the forward's mean, var
  const float* gh;              // (N, f) cotangent of h_T
  const int* vid;               // (E)
  const int* src;               // (E)
  const int* dst;               // (E)
  const int* edge_order;        // (E) edge ids, stably sorted by dst
  const int* dst_ptr;           // (N + 1)
  const int* src_order;         // (E) edge ids, stably sorted by src
  const int* src_ptr;           // (N + 1)
  const int* graph_node_ptr;    // (G + 1)
  float* dh0;                   // (N, f)
  float* dw;                    // AttsGradLayout(Tm, K, f).total
  float* scratch;
  int n_nodes, n_graphs, n_edges, f, k_vocab, steps, tm, with_corr,
      stateless;
};

// shared memory after the weights and norm constants: block sums (red
// kWarps·2·FP, sums 2·FP), the state sums S1 | S2 (2·FP), the staged rows
// (kChunk · (6f + 1)) and the staged vocab ids (kChunk ints)
__host__ __device__ inline size_t bwd_smem_floats(int tm, int k_vocab,
                                                  int steps, int f) {
  return size_t(SL::after_stats(tm, k_vocab, steps)) + kWarps * 2 * FP +
         4 * FP + size_t(kChunk) * (kChainSegs * f + 1) + kChunk;
}

__host__ __device__ inline long long bwd_scratch_floats(
    int n_nodes, int n_edges, int k_vocab, int f, int steps, int tm,
    int grid) {
  const long long nchunks = (n_nodes + kChunk - 1) / kChunk;
  return (1LL + tm) * n_nodes * f                   // ghs, dms
         + 2LL * nchunks * 2 * FP                   // state-sum partials
         + (long long)tm * n_nodes * kNodeSegs * f  // node rows
         + (long long)tm * n_edges * kEdgeSegs * f  // edge rows
         + (long long)n_edges * f                   // source cotangents
         + (long long)grid * AttsGradLayout(tm, k_vocab, f).total;
}

// First element index >= off owned by this thread (e ≡ tid mod kThreads).
__device__ __forceinline__ int first_owned(int off) {
  return off + ((int(threadIdx.x) - off) % kThreads + kThreads) % kThreads;
}

// The staged weights: the launch's dynamic shared memory, behind an
// opaque offset so loop-invariant weights stay in shared memory.
__device__ __forceinline__ const float* sm_weights() {
  extern __shared__ float atts_sm[];
  return atts_sm + opaque_zero();
}

// The chain's VJP for one real node at step t: from the cotangent dhp of
// h̃_t, the GRU's inputs mb and hprev, the GRU VJP; stages the chain row
// (stride kS) and returns ∂hprev (ghn) and ∂mb (dmb).
template <int NF>
__device__ __forceinline__ void gru_backward(const float* dhp,
                                             const float* hprev,
                                             const float* mb, int f,
                                             float* row, float* ghn,
                                             float* dmb) {
  const float* w = sm_weights();
  float dar[NF], daz[NF], dan[NF], dnh[NF];
MPNN_UNROLL
  for (int j = 0; j < NF; ++j) {
    float gr = w[PL::kBih + j], gz = w[PL::kBih + FP + j],
          gn = w[PL::kBih + 2 * FP + j];
    float rh = w[PL::kBhh + j], zh = w[PL::kBhh + FP + j],
          nh = w[PL::kBhh + 2 * FP + j];
MPNN_UNROLL
    for (int k = 0; k < NF; ++k) {
      const float* wi = w + PL::kWih + k * 3 * FP;
      const float* whh = w + PL::kWhh + k * 3 * FP;
      gr = fmaf(mb[k], wi[j], gr);
      gz = fmaf(mb[k], wi[FP + j], gz);
      gn = fmaf(mb[k], wi[2 * FP + j], gn);
      rh = fmaf(hprev[k], whh[j], rh);
      zh = fmaf(hprev[k], whh[FP + j], zh);
      nh = fmaf(hprev[k], whh[2 * FP + j], nh);
    }
    const float sr = sigmoidf_(gr + rh);
    const float sz = sigmoidf_(gz + zh);
    const float tn = tanhf(gn + sr * nh);
    const float dz = dhp[j] * (hprev[j] - tn);
    dan[j] = dhp[j] * (1.0f - sz) * (1.0f - tn * tn);
    dnh[j] = dan[j] * sr;
    dar[j] = dan[j] * nh * sr * (1.0f - sr);
    daz[j] = dz * sz * (1.0f - sz);
    ghn[j] = dhp[j] * sz;
  }
MPNN_UNROLL
  for (int k = 0; k < NF; ++k) {
    const float* whh = w + PL::kWhh + k * 3 * FP;
    const float* wi = w + PL::kWih + k * 3 * FP;
    float th = ghn[k], ti = 0.f;
MPNN_UNROLL
    for (int j = 0; j < NF; ++j) {
      th = fmaf(whh[j], dar[j], th);
      th = fmaf(whh[FP + j], daz[j], th);
      th = fmaf(whh[2 * FP + j], dnh[j], th);
      ti = fmaf(wi[j], dar[j], ti);
      ti = fmaf(wi[FP + j], daz[j], ti);
      ti = fmaf(wi[2 * FP + j], dan[j], ti);
    }
    ghn[k] = th;
    dmb[k] = ti;
  }
MPNN_UNROLL
  for (int j = 0; j < NF; ++j) {
    if (j < f) {
      row[kMb * f + j] = mb[j];
      row[kHp * f + j] = hprev[j];
      row[kDar * f + j] = dar[j];
      row[kDaz * f + j] = daz[j];
      row[kDan * f + j] = dan[j];
      row[kDnh * f + j] = dnh[j];
    }
  }
}

// The GRU leaves' terms of one chunk from the staged chain rows.
__device__ void gru_grads(float* wrow, const AttsGradLayout& gl,
                          const float* xs, int kS, int f) {
  for (int e = first_owned(gl.wih); e < gl.total; e += kThreads) {
    int cx = -1, cd;
    if (e < gl.bih) {                                  // W_ih, W_hh
      const bool hh = e >= gl.whh;
      const int i = e - (hh ? gl.whh : gl.wih);
      const int k = i / (3 * f), g = (i % (3 * f)) / f, j = i % f;
      cx = (hh ? kHp : kMb) * f + k;
      cd = (hh && g == 2 ? kDnh : kDar + g) * f + j;
    } else {                                           // b_ih, b_hh
      const bool hh = e >= gl.bhh;
      const int i = e - (hh ? gl.bhh : gl.bih), g = i / f, j = i % f;
      cd = (hh && g == 2 ? kDnh : kDar + g) * f + j;
    }
    float s = 0.f;
    if (cx >= 0) {
      for (int i = 0; i < kChunk; ++i) s = fmaf(xs[i * kS + cx], xs[i * kS + cd], s);
    } else {
      for (int i = 0; i < kChunk; ++i) s += xs[i * kS + cd];
    }
    wrow[e] += s;
  }
}

// Message step t for one real node n: the in-edge walk and the correction
// VJP. Writes the node's row, its in-edges' rows, adds its in-edges' source
// cotangents (stored at t = 0) and Wh_t·dzall to ∂h0[n]; adds its dX to dS.
template <int NF>
__device__ __forceinline__ void node_backward(const BwdArgs& a, int t, int n,
                                              const float (&S)[NF],
                                              const float* dms, float* nrow,
                                              float* erow, float* dhs,
                                              float (&dS)[NF]) {
  const int f = a.f, K = a.k_vocab;
  const float* blk = sm_weights() + SL::step(t, K);
  const float* at = a.w.aprime + size_t(t) * K * f * f;
  float dm[NF], zh[NF], dwn[NF], g0[NF];
  {
    float h0n[NF];
    load_row<NF>(a.h0, n, f, h0n);
    gate_pre<NF>(blk, h0n, zh);
  }
  load_row_cg<NF>(dms, n, f, dm);
MPNN_UNROLL
  for (int j = 0; j < NF; ++j) dwn[j] = g0[j] = 0.f;
  if (a.with_corr) {
    feat_softmax<NF>(zh, blk + AL::kQ0, f, g0);
    matvec_t_add<NF>(blk + AL::kA0, dm, dwn);         // A0_tᵀ·dm
  }
  float xsum[NF], dzall[NF];
MPNN_UNROLL
  for (int j = 0; j < NF; ++j) xsum[j] = dzall[j] = 0.f;
  const int p1 = __ldg(a.dst_ptr + n + 1);
  for (int p = __ldg(a.dst_ptr + n); p < p1; ++p) {
    const float* we = sm_weights() + SL::step(t, K);
    const int e = __ldg(a.edge_order + p);
    const int k = __ldg(a.vid + e);
    float hs[NF], gate[NF], dg[NF];
    load_row<NF>(a.h0, __ldg(a.src + e), f, hs);
    feat_softmax<NF>(zh, we + SL::kQv + k * FP, f, gate);
MPNN_UNROLL
    for (int j = 0; j < NF; ++j) dg[j] = 0.f;
    gmatvec_t_add<NF>(at + size_t(k) * f * f, f, dm, dg);  // A'_t[k]ᵀ·dm
    float s = 0.f;
MPNN_UNROLL
    for (int j = 0; j < NF; ++j) s = fmaf(dg[j] * hs[j], gate[j], s);
    float* er = erow + size_t(e) * kEdgeSegs * f;
    float* dr = dhs + size_t(e) * f;
MPNN_UNROLL
    for (int j = 0; j < NF; ++j) {
      if (j < f) {
        const float dz = gate[j] * (dg[j] * hs[j] - s);
        const float d = dg[j] * gate[j] - dwn[j] * g0[j];
        er[j] = gate[j] * hs[j];
        er[f + j] = dz;
        dr[j] = t == 0 ? d : dr[j] + d;
        dzall[j] += dz;
      }
      xsum[j] += hs[j];
    }
  }
  float g0x[NF], dz0[NF];
MPNN_UNROLL
  for (int j = 0; j < NF; ++j) g0x[j] = dz0[j] = 0.f;
  if (a.with_corr) {
    float s0 = 0.f, dgx[NF];
MPNN_UNROLL
    for (int j = 0; j < NF; ++j) {
      const float x = S[j] - xsum[j];
      g0x[j] = g0[j] * x;
      dgx[j] = dwn[j] * x;                             // ∂g0
      s0 = fmaf(dgx[j], g0[j], s0);
      dS[j] = fmaf(dwn[j], g0[j], dS[j]);              // dX
    }
MPNN_UNROLL
    for (int j = 0; j < NF; ++j) {
      dz0[j] = g0[j] * (dgx[j] - s0);
      dzall[j] += dz0[j];
    }
  }
  float* row = nrow + size_t(n) * kNodeSegs * f;
MPNN_UNROLL
  for (int j = 0; j < NF; ++j) {
    if (j < f) {
      row[kG0x * f + j] = g0x[j];
      row[kDz0 * f + j] = dz0[j];
      row[kDzall * f + j] = dzall[j];
    }
  }
  float dh[NF];
  load_row_cg<NF>(a.dh0, n, f, dh);
  matvec_add<NF>(blk + AL::kWh, dzall, dh);            // Wh_t·dzall
  store_row<NF>(a.dh0, n, f, dh);
}

template <int NF>
__global__ void __launch_bounds__(kThreads, 1)
fused_att_steps_bwd_kernel(BwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float sm[];
  const int f = a.f, K = a.k_vocab, T = a.steps, Tm = a.tm;
  const bool stateless = a.stateless != 0;
  stage_atts_weights(sm, a.w, f, K, Tm);
  float* st = sm + SL::stats(Tm, K);                   // T·3·FP
  float* red = sm + SL::after_stats(Tm, K, T);         // kWarps·2·FP
  float* sums = red + kWarps * 2 * FP;                 // 2·FP
  float* cs = sums + 2 * FP;                           // S1 | S2
  float* xs = cs + 2 * FP;                             // kChunk·(6f + 1)
  int* vids = reinterpret_cast<int*>(xs + kChunk * (kChainSegs * f + 1));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int N = a.n_nodes, G = a.n_graphs, E = a.n_edges;
  const AttsGradLayout gl(Tm, K, f);
  const int NW = gl.total;
  const int n_real = a.graph_node_ptr[G];
  const float c = float(n_real);
  const int nchunks = (n_real + kChunk - 1) / kChunk;
  const size_t slot_sz = size_t(N) * f;
  float* ghs = a.scratch;                                    // (N, f)
  float* dms = ghs + slot_sz;                                // (Tm, N, f)
  float* cpart = dms + Tm * slot_sz;                         // 2·nchunks·2FP
  float* nrows = cpart + 2 * size_t(nchunks) * 2 * FP;       // Tm·N·3f
  float* erows = nrows + size_t(Tm) * N * kNodeSegs * f;     // Tm·E·2f
  float* dhs = erows + size_t(Tm) * E * kEdgeSegs * f;       // (E, f)
  float* wpart = dhs + size_t(E) * f;                        // grid·NW
  float* wrow = wpart + size_t(blockIdx.x) * NW;

  // ---- set-up: the state slots' constants, zeroed rows -------------------
  if (stateless)
    for (int i = tid; i < T * FP; i += kThreads) {
      const int s = i / FP, j = i % FP;
      const float mean = j < f ? a.stats[(size_t(s) * 2) * f + j] : 0.f;
      const float var = j < f ? a.stats[(size_t(s) * 2 + 1) * f + j] : 0.f;
      mpnn_psteps::set_slot(st + s * 3 * FP, j, mean, var, true);
    }
  for (int e = tid; e < NW; e += kThreads) wrow[e] = 0.f;
  {
    const size_t pad = size_t(N - n_real) * f;
    for (size_t i = size_t(blockIdx.x) * kThreads + tid; i < pad;
         i += size_t(gridDim.x) * kThreads)
      a.dh0[size_t(n_real) * f + i] = 0.f;
  }
  __syncthreads();

  // ---- the last step's batch sums S1 = Σ g, S2 = Σ g·x̂ -------------------
  if (stateless) {
    const float* stl = st + (T - 1) * 3 * FP;
    float* cpart_t = cpart + size_t((T - 1) & 1) * nchunks * 2 * FP;
    for (int ch = blockIdx.x; ch < nchunks; ch += gridDim.x) {
      const int n = ch * kChunk + tid;
      float v[2][FP];
MPNN_UNROLL
      for (int j = 0; j < FP; ++j) v[0][j] = v[1][j] = 0.f;
      if (n < n_real) {
        float g[FP], x[FP];
        load_row(a.gh, n, f, g);
        load_row(a.htil + size_t(T - 1) * slot_sz, n, f, x);
        mpnn_train::xhat_of(stl, x, x);
MPNN_UNROLL
        for (int j = 0; j < FP; ++j) {
          v[0][j] = g[j];
          v[1][j] = g[j] * x[j];
        }
      }
      block_feature_sums<2>(v, red, sums);
      if (tid < 2 * FP) cpart_t[size_t(ch) * 2 * FP + tid] = sums[tid];
      __syncthreads();
    }
    grid.sync();
    chunk_totals<2>(cpart_t, 2 * FP, nchunks, red, cs);
  }

  // ---- the reverse chain, t = T−1..0 ---------------------------------------
  const int kS = kChainSegs * f + 1;
  for (int t = T - 1; t >= 0; --t) {
    const float* stt = st + t * 3 * FP;
    const float* stp = st + max(t - 1, 0) * 3 * FP;
    const bool next_sums = t > 0 && stateless;
    const int ms = min(t, Tm - 1);
    // slot ms is first reached at t = T−1 (the last slot) or t = ms
    const bool first = ms < Tm - 1 || t == T - 1;
    float* cpart_t = cpart + size_t((t - 1) & 1) * nchunks * 2 * FP;
    for (int ch = blockIdx.x; ch < nchunks; ch += gridDim.x) {
      const int n = ch * kChunk + tid;
      float* row = xs + tid * kS;
      float v[2][FP];
MPNN_UNROLL
      for (int j = 0; j < FP; ++j) v[0][j] = v[1][j] = 0.f;
      if (n < n_real) {
        float g[FP], dhp[FP], hprev[FP], mb[FP], ghn[FP], dmb[FP];
        load_row(t == T - 1 ? a.gh : ghs, n, f, g);
        if (stateless) {
          float xh[FP];
          load_row(a.htil + size_t(t) * slot_sz, n, f, xh);
          mpnn_train::xhat_of(stt, xh, xh);
MPNN_UNROLL
          for (int j = 0; j < FP; ++j)
            dhp[j] = (g[j] - cs[j] / c) / stt[2 * FP + j] -
                     xh[j] * cs[FP + j] / (c * stt[FP + j]);
        } else {
MPNN_UNROLL
          for (int j = 0; j < FP; ++j) dhp[j] = g[j];
        }
        if (t > 0) {
          load_row(a.htil + size_t(t - 1) * slot_sz, n, f, hprev);
          if (stateless) mpnn_train::xhat_of(stp, hprev, hprev);
        } else {
          load_row(a.h0, n, f, hprev);
        }
        load_row(a.msgs + size_t(ms) * slot_sz, n, f, mb);
        gru_backward<NF>(dhp, hprev, mb, f, row, ghn, dmb);
        float* dmr = dms + size_t(ms) * slot_sz;
        if (!first) {
          float prev[NF];
          load_row<NF>(dmr, n, f, prev);
MPNN_UNROLL
          for (int j = 0; j < NF; ++j) dmb[j] += prev[j];
        }
        store_row<NF>(dmr, n, f, dmb);
        store_row<NF>(t > 0 ? ghs : a.dh0, n, f, ghn);
        if (next_sums) {
MPNN_UNROLL
          for (int j = 0; j < NF; ++j) {
            v[0][j] = ghn[j];
            v[1][j] = ghn[j] * hprev[j];
          }
        }
      } else {
        for (int i = 0; i < kS; ++i) row[i] = 0.f;
      }
      __syncthreads();
      gru_grads(wrow, gl, xs, kS, f);
      if (next_sums) {
        block_feature_sums<2>(v, red, sums);
        if (tid < 2 * FP) cpart_t[size_t(ch) * 2 * FP + tid] = sums[tid];
      }
      __syncthreads();
    }
    if (next_sums) {
      grid.sync();
      chunk_totals<2>(cpart_t, 2 * FP, nchunks, red, cs);
    }
  }
  grid.sync();

  // ---- the message steps' VJP, one warp per graph ---------------------------
  for (int g = blockIdx.x * kWarps + warp; g < G; g += gridDim.x * kWarps) {
    const int n0 = a.graph_node_ptr[g], n1 = a.graph_node_ptr[g + 1];
    float S[NF], dS[NF];
MPNN_UNROLL
    for (int j = 0; j < NF; ++j) S[j] = dS[j] = 0.f;
    if (a.with_corr) {
      for (int n = n0 + lane; n < n1; n += 32) {
        float hn[NF];
        load_row<NF>(a.h0, n, f, hn);
MPNN_UNROLL
        for (int j = 0; j < NF; ++j) S[j] += hn[j];
      }
MPNN_UNROLL
      for (int j = 0; j < NF; ++j) S[j] = warp_sum(S[j]);
    }
    for (int t = 0; t < Tm; ++t)
      for (int n = n0 + lane; n < n1; n += 32)
        node_backward<NF>(a, t, n, S, dms + size_t(t) * slot_sz,
                          nrows + size_t(t) * N * kNodeSegs * f,
                          erows + size_t(t) * E * kEdgeSegs * f, dhs, dS);
MPNN_UNROLL
    for (int j = 0; j < NF; ++j) dS[j] = warp_sum(dS[j]);
    __syncwarp();                     // the lanes' source cotangents
    for (int n = n0 + lane; n < n1; n += 32) {
      float d[NF];
      load_row_cg<NF>(a.dh0, n, f, d);
MPNN_UNROLL
      for (int j = 0; j < NF; ++j) d[j] += dS[j];
      const int p1 = __ldg(a.src_ptr + n + 1);
      for (int p = __ldg(a.src_ptr + n); p < p1; ++p) {
        float u[NF];
        load_row_cg<NF>(dhs, __ldg(a.src_order + p), f, u);
MPNN_UNROLL
        for (int j = 0; j < NF; ++j) d[j] += u[j];
      }
      store_row<NF>(a.dh0, n, f, d);
    }
    __syncwarp();
  }
  grid.sync();

  // ---- the message tables' gradients into the block's row -----------------
  const int ff = f * f;
  for (int t = 0; t < Tm; ++t) {
    // per node: ∂A0_t = Σ dm ⊗ g0⊙X, ∂q0_t = Σ dz0, ∂Wh_t = Σ h0 ⊗ dzall
    const int kSn = 5 * f + 1;                     // [dm | g0x | dz0 | h0 | dzall]
    const float* nr = nrows + size_t(t) * N * kNodeSegs * f;
    for (int ch = blockIdx.x; ch < nchunks; ch += gridDim.x) {
      const int n = ch * kChunk + tid;
      float* row = xs + tid * kSn;
      if (n < n_real) {
        for (int j = 0; j < f; ++j) {
          row[j] = __ldcg(dms + size_t(t) * slot_sz + size_t(n) * f + j);
          row[f + j] = __ldcg(nr + (size_t(n) * kNodeSegs + kG0x) * f + j);
          row[2 * f + j] = __ldcg(nr + (size_t(n) * kNodeSegs + kDz0) * f + j);
          row[3 * f + j] = a.h0[size_t(n) * f + j];
          row[4 * f + j] =
              __ldcg(nr + (size_t(n) * kNodeSegs + kDzall) * f + j);
        }
      } else {
        for (int i = 0; i < kSn; ++i) row[i] = 0.f;
      }
      __syncthreads();
      for (int i = tid; i < 2 * ff + f; i += kThreads) {
        int cx = -1, cd, e;
        if (i < ff) {                              // A0_t: dm ⊗ g0x
          cx = i / f;
          cd = f + i % f;
          e = gl.a0 + t * ff + i;
        } else if (i < ff + f) {                   // q0_t: Σ dz0
          cd = 2 * f + (i - ff);
          e = gl.q0 + t * f + (i - ff);
        } else {                                   // Wh_t: h0 ⊗ dzall
          const int ii = i - ff - f;
          cx = 3 * f + ii / f;
          cd = 4 * f + ii % f;
          e = gl.wh + t * ff + ii;
        }
        float s = 0.f;
        if (cx >= 0) {
          for (int r = 0; r < kChunk; ++r)
            s = fmaf(xs[r * kSn + cx], xs[r * kSn + cd], s);
        } else {
          for (int r = 0; r < kChunk; ++r) s += xs[r * kSn + cd];
        }
        wrow[e] += s;
      }
      __syncthreads();
    }
    // per edge: ∂A'_t[k] = Σ dm_dst ⊗ g, ∂qv_t[k] = Σ dz
    const int kSe = 3 * f;                         // [dm_dst | g | dz]
    const float* er = erows + size_t(t) * E * kEdgeSegs * f;
    const int nech = (E + kChunk - 1) / kChunk;
    for (int ec = blockIdx.x; ec < nech; ec += gridDim.x) {
      const int e = ec * kChunk + tid;
      float* row = xs + tid * kSe;
      vids[tid] = -1;
      if (e < E) {
        const int d = __ldg(a.dst + e);
        if (d < n_real) {
          vids[tid] = __ldg(a.vid + e);
          for (int j = 0; j < f; ++j) {
            row[j] = __ldcg(dms + size_t(t) * slot_sz + size_t(d) * f + j);
            row[f + j] = __ldcg(er + size_t(e) * kEdgeSegs * f + j);
            row[2 * f + j] = __ldcg(er + size_t(e) * kEdgeSegs * f + f + j);
          }
        }
      }
      __syncthreads();
      for (int i = tid; i < K * ff + K * f; i += kThreads) {
        float s = 0.f;
        int el;
        if (i < K * ff) {                          // A'_t[k]: dm ⊗ g
          const int k = i / ff, m = (i % ff) / f, j = i % f;
          for (int r = 0; r < kChunk; ++r)
            if (vids[r] == k) s = fmaf(xs[r * kSe + m], xs[r * kSe + f + j], s);
          el = gl.a + t * K * ff + i;
        } else {                                   // qv_t[k]: Σ dz
          const int i0 = i - K * ff, k = i0 / f, j = i0 % f;
          for (int r = 0; r < kChunk; ++r)
            if (vids[r] == k) s += xs[r * kSe + 2 * f + j];
          el = gl.qv + t * K * f + i0;
        }
        wrow[el] += s;
      }
      __syncthreads();
    }
  }
  grid.sync();

  // ---- reduce the block rows in block order ------------------------------
  for (int e = blockIdx.x * kThreads + tid; e < NW;
       e += gridDim.x * kThreads) {
    float s = 0.f;
    for (int b = 0; b < int(gridDim.x); ++b)
      s += __ldcg(wpart + size_t(b) * NW + e);
    a.dw[e] = s;
  }
}

// The instantiation that runs width f.
const void* kernel_for(int f) {
  if constexpr (FP <= 16)               // the narrow bucket's two builds
    if (f <= 8) return (const void*)fused_att_steps_bwd_kernel<8>;
  return (const void*)fused_att_steps_bwd_kernel<FP>;
}

}  // namespace

extern "C" {

int mpnn_fused_att_steps_bwd_smem_bytes(int tm, int k_vocab, int steps,
                                        int f) {
  return int(sizeof(float) * bwd_smem_floats(tm, k_vocab, steps, f));
}

// The 10 offsets of the flat gradient layout (AttsGradLayout), total last.
void mpnn_fused_att_steps_bwd_layout(int tm, int k_vocab, int f, int* out) {
  const AttsGradLayout g(tm, k_vocab, f);
  const int v[10] = {g.a, g.a0, g.qv, g.q0, g.wh, g.wih, g.whh, g.bih,
                     g.bhh, g.total};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
}

long long mpnn_fused_att_steps_bwd_scratch_floats(int n_nodes, int n_edges,
                                                  int k_vocab, int f,
                                                  int steps, int tm,
                                                  int grid) {
  return bwd_scratch_floats(n_nodes, n_edges, k_vocab, f, steps, tm, grid);
}

int mpnn_fused_att_steps_bwd_grid(int f, int tm, int k_vocab, int steps,
                                  int n_nodes, int n_graphs, int n_edges) {
  const int need = max(max((n_nodes + kChunk - 1) / kChunk,
                           (n_graphs + kWarps - 1) / kWarps),
                       (n_edges + kChunk - 1) / kChunk);
  return mpnn_psteps::coop_grid(
      kernel_for(f), sizeof(float) * bwd_smem_floats(tm, k_vocab, steps, f),
      need);
}

int mpnn_fused_att_steps_bwd(
    const float* aprime, const float* a0, const float* qv, const float* q0,
    const float* wh, const float* w_ih, const float* w_hh, const float* b_ih,
    const float* b_hh, const float* h0, const float* msgs, const float* htil,
    const float* stats, const float* gh, const int* vid, const int* src,
    const int* dst, const int* edge_order, const int* dst_ptr,
    const int* src_order, const int* src_ptr, const int* graph_node_ptr,
    float* dh0, float* dw, float* scratch, int n_nodes, int n_graphs,
    int n_edges, int f, int k_vocab, int steps, int tm, int with_corr,
    int stateless, int grid, void* stream) {
  if (f < 1 || f > FP || k_vocab < 1 || k_vocab > kMaxVocab || steps < 1 ||
      steps > kMaxSteps || (tm != steps && tm != 1) || n_graphs < 1 ||
      grid < 1)
    return int(cudaErrorInvalidValue);
  BwdArgs a{{aprime, a0, qv, q0, wh, w_ih, w_hh, b_ih, b_hh},
            h0, msgs, htil, stats, gh, vid, src, dst, edge_order, dst_ptr,
            src_order, src_ptr, graph_node_ptr, dh0, dw, scratch, n_nodes,
            n_graphs, n_edges, f, k_vocab, steps, tm, with_corr, stateless};
  return mpnn_psteps::coop_launch(
      kernel_for(f), a, sizeof(float) * bwd_smem_floats(tm, k_vocab, steps, f),
      grid, stream);
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
