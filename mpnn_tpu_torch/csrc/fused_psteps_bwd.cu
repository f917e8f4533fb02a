// Whole-step TRAINING backward of the per-step edge-network MPNN (the
// graph_norm and encoded training path), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mpnn_tpu/kernels/fused_psteps.py::_ps_bwd_kernel
// (the monolithic VJP of make_fused_psteps_op, with its reverse walk
// psteps_reverse_walk inlined). It has no node cap: the Pallas op streams
// its backward past PS_MONO_BWD_NPAD_CAP padded nodes (_ps_stream_walk_
// kernel and its helpers) only because of the TPU's VMEM; this kernel
// computes the same function at any size that fits device memory. Given
// the cotangents gl of the loss and gout of out and the forward's
// residuals (htil, the per-slot statistics, out) it computes every leaf:
//
//   dout  = gl·2(out − y)·gm/Σgm + gout
//   readout VJP per node (softmax over od) → ∂h_T, ∂h0, ∂W_i, ∂W_j, ∂b
//   for t = T−1..0:
//     state-norm VJP of step t with its batch sums S1 = Σ dx̂,
//       S2 = Σ dx̂·x̂ (closed form dx = (dx̂ − S1/c)/d − x̂·S2/(c·s); bn1d:
//       s = √max(var, 1e-12), d = s + 1e-5, dx̂ = w·g; stateless:
//       d = s = √(var + 1e-6), dx̂ = g), ∂bn_t
//     GRU VJP → ∂h_{t−1}, ∂W_ih, ∂W_hh, ∂b_ih, ∂b_hh (b_hh's n part sees
//       r·∂n), ∂(message input of step t)
//     message-norm VJP of step t (its own batch sums) → ∂m_t, ∂ma_bn_t
//   per step t: dA0_t = Σ_g (Σ_{v∈g} ∂m_t,v) ⊗ S_g, ∂mbias_t = Σ ∂m_t;
//     ∂h0_v += Σ_t A0_tᵀ·Σ_{w∈g(v)} ∂m_t,w (bias leakage)
//              + Σ_{e: src_e = v} Σ_t A_t[vid_e]ᵀ·∂m_t,dst_e;
//     dA_t[k] = Σ_{e: vid_e = k} ∂m_t,dst_e ⊗ h0_src_e.
//
// Bound on an H100 SXM: as the forward, ~2-3× its arithmetic on a few MB;
// the grid barriers dominate in practice (chip_smoke.py counts it).
//
// Design: ONE cooperative launch. Node phases on 128-node chunks, graph
// phases one warp per graph (fused_train_common.cuh). The state norm's
// batch sums of step t−1 are gathered in the same chunk pass as step t's
// GRU backward and combined after one barrier (T barriers in all); the
// message norms' sums of every step are gathered in the same passes into
// per-step buffers and combined together after the walk, where ∂m_t is
// formed per node. Weight gradients go into a block-private row of
// partials, each element owned by one thread (no races, no atomics);
// per-node terms are staged in shared memory per chunk, per-graph terms
// (A0_t, mbias_t) per graph chunk, dA_t per edge chunk; the block rows
// are reduced in block order at the end. Deterministic for a given grid.
// The state-norm partials alternate between two buffers by step parity.

#include "fused_psteps_common.cuh"

namespace {

using namespace mpnn_psteps;
using mpnn_train::block_feature_sums;
using mpnn_train::chunk_totals;

// Flat layout of the gradient output (and of each block's partial row):
// real (unpadded) shapes, in this order. kernels/fused_psteps.py::
// grad_layout mirrors it and checks it against mpnn_fused_psteps_bwd_layout.
struct PsGradLayout {
  int a, a0, mbias, wih, whh, bih, bhh, maw, mab, bnw, bnb, riw, rib, rjw,
      rjb, total;
  __host__ __device__ PsGradLayout(int k, int f, int od, int T) {
    a = 0;
    a0 = a + T * k * f * f;
    mbias = a0 + T * f * f;
    wih = mbias + T * f;
    whh = wih + 3 * f * f;
    bih = whh + 3 * f * f;
    bhh = bih + 3 * f;
    maw = bhh + 3 * f;
    mab = maw + T * f;
    bnw = mab + T * f;
    bnb = bnw + T * f;
    riw = bnb + T * f;
    rib = riw + 2 * f * od;
    rjw = rib + od;
    rjb = rjw + 2 * f * od;
    total = rjb + od;
  }
};

struct PsBwdArgs {
  PsWeights w;
  const float* h0;          // (N, f), pre-masked
  const float* labels;      // (G)
  const float* gmask;       // (G)
  const float* out;         // (G, od) forward output
  const float* gout;        // (G, od) cotangent of out
  const float* gl;          // (1) cotangent of the loss
  const float* htil;        // (2T, N, f) forward residuals
  const float* stats;       // (2T, 2, f) forward batch statistics
  const int* vid;           // (E)
  const int* src;           // (E)
  const int* dst;           // (E)
  const int* src_order;     // (E) edge ids, stably sorted by source
  const int* src_ptr;       // (N + 1) row pointers into src_order
  const int* graph_node_ptr;  // (G + 1)
  const int* node_graph;    // (N)
  float* dh0;               // (N, f)
  float* dw;                // PsGradLayout(K, f, od, T).total
  float* scratch;
  int n_nodes, n_graphs, n_edges, f, od, k_vocab, steps, msg_mode,
      state_mode;
};

// staged floats per node (odd): the GRU phases' 6 rows of FP, or the
// readout's [h | h0 | dpi | djv], whichever is wider (the readout in the
// wide bucket)
constexpr int kRoStage = 2 * FP + 2 * ODW + 1;
constexpr int kStage = 6 * FP + 1 > kRoStage ? 6 * FP + 1 : kRoStage;

__host__ __device__ inline size_t bwd_smem_floats(int steps) {
  return size_t(PL::after_stats(steps)) + kWarps * 4 * FP + 4 * FP +
         2 * FP + size_t(steps) * 2 * FP + 4 + size_t(kChunk) * kStage;
}

__host__ __device__ inline long long bwd_scratch_floats(
    int n_nodes, int n_graphs, int k_vocab, int f, int od, int steps,
    int grid) {
  const long long nchunks = (n_nodes + kChunk - 1) / kChunk;
  return (1LL + steps) * n_nodes * f + (2LL + steps) * nchunks * 2 * FP +
         (1LL + steps) * n_graphs * FP +
         (long long)grid * PsGradLayout(k_vocab, f, od, steps).total;
}

// Readout weight gradients of one chunk from the staged rows
// [h (FP) | h0 (FP) | dpi (ODW) | djv (ODW)].
__device__ void readout_grads(float* wrow, const PsGradLayout& gl,
                              const float* xs, int f, int od) {
  for (int e = first_owned(gl.riw); e < gl.rjb + od; e += kThreads) {
    int col_x = -1, col_d;
    if (e < gl.rib) {
      const int i = e - gl.riw, k = i / od;
      col_x = k < f ? k : FP + k - f;
      col_d = 2 * FP + i % od;
    } else if (e < gl.rjw) {
      col_d = 2 * FP + (e - gl.rib);
    } else if (e < gl.rjb) {
      const int i = e - gl.rjw, k = i / od;
      col_x = k < f ? k : FP + k - f;
      col_d = 2 * FP + ODW + i % od;
    } else {
      col_d = 2 * FP + ODW + (e - gl.rjb);
    }
    float s = 0.f;
    if (col_x >= 0) {
      for (int i = 0; i < kChunk; ++i)
        s = fmaf(xs[i * kStage + col_x], xs[i * kStage + col_d], s);
    } else {
      for (int i = 0; i < kChunk; ++i) s += xs[i * kStage + col_d];
    }
    wrow[e] += s;
  }
}

__global__ void __launch_bounds__(kThreads)
fused_psteps_bwd_kernel(PsBwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float sm[];
  const int f = a.f, od = a.od, T = a.steps, K = a.k_vocab;
  const int mmode = a.msg_mode, smode = a.state_mode;
  const bool msg_bn = mmode == kBatchBn, state_bn = smode == kBatchBn;
  const bool state_stats = has_stats(smode);
  stage_ps_weights(sm, a.w, f, od, T);
  float* st = sm + PL::stats(T);                       // 2T·3·FP
  float* red = sm + PL::after_stats(T);                // kWarps·4·FP
  float* sums = red + kWarps * 4 * FP;                 // 4·FP
  float* cs = sums + 4 * FP;                           // state S1, S2
  float* msum = cs + 2 * FP;                           // T × msg S1, S2
  float* misc = msum + T * 2 * FP;                     // Σ gm, …
  float* xs = misc + 4;                                // kChunk·kStage

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int N = a.n_nodes, G = a.n_graphs, E = a.n_edges;
  const PsGradLayout gl(K, f, od, T);
  const int NW = gl.total;
  const int n_real = a.graph_node_ptr[G];
  const float c = float(n_real);
  const int nchunks = (n_real + kChunk - 1) / kChunk;
  const size_t slot_sz = size_t(N) * f;
  float* ghs = a.scratch;                              // (N, f)
  float* dms = ghs + slot_sz;                          // (T, N, f)
  float* cpart = dms + T * slot_sz;                    // 2·nchunks·2FP
  float* mpart = cpart + 2 * size_t(nchunks) * 2 * FP;  // T·nchunks·2FP
  float* sg = mpart + size_t(T) * nchunks * 2 * FP;    // (G, FP)
  float* dg = sg + size_t(G) * FP;                     // (T, G, FP)
  float* wpart = dg + size_t(T) * G * FP;              // grid·NW
  float* wrow = wpart + size_t(blockIdx.x) * NW;
  const int gw = blockIdx.x * kWarps + warp, nw = gridDim.x * kWarps;

  // ---- set-up: every slot's norm constants, Σ gm, zeroed partials -------
  __syncthreads();
  for (int i = tid; i < 2 * T * FP; i += kThreads) {
    const int s = i / FP, j = i % FP;
    const bool on = s < T ? msg_bn : state_stats;
    if (!on) continue;
    const float mean = j < f ? a.stats[(size_t(s) * 2) * f + j] : 0.f;
    const float var = j < f ? a.stats[(size_t(s) * 2 + 1) * f + j] : 0.f;
    set_slot(st + s * 3 * FP, j, mean, var, s >= T && smode == kStateless);
  }
  for (int e = tid; e < NW; e += kThreads) wrow[e] = 0.f;
  {
    float s = 0.f;
    for (int g = tid; g < G; g += kThreads) s += a.gmask[g];
    xs[tid] = s;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int i = 0; i < kThreads; ++i) s += xs[i];
    misc[0] = s;
  }
  {
    // padded node slots: zero ∂h0, and zero ∂m_t (padded edges read them)
    const size_t pad = size_t(N - n_real) * f;
    for (size_t i = size_t(blockIdx.x) * kThreads + tid; i < pad * (T + 1);
         i += size_t(gridDim.x) * kThreads) {
      const size_t s = i / pad, r = i % pad;
      float* base = s == 0 ? a.dh0 : dms + (s - 1) * slot_sz;
      base[size_t(n_real) * f + r] = 0.f;
    }
  }
  __syncthreads();
  const float inv_gsum = 1.0f / misc[0];
  const float gl_v = a.gl[0];

  // ---- B0: readout + loss VJP per node, and step T−1's state-norm sums ---
  {
    const float* stT = st + (2 * T - 1) * 3 * FP;
    float* cpart_t = cpart + size_t((T - 1) & 1) * nchunks * 2 * FP;
    for (int ch = blockIdx.x; ch < nchunks; ch += gridDim.x) {
      const int n = ch * kChunk + tid;
      float v[4][FP];
MPNN_UNROLL
      for (int q = 0; q < 4; ++q)
MPNN_UNROLL
        for (int j = 0; j < FP; ++j) v[q][j] = 0.f;
      float* row = xs + tid * kStage;
      if (n < n_real) {
        const float* w = sm + opaque_zero();
        const float* ws = w + PL::step(T - 1);
        const int g = a.node_graph[n];
        float hraw[FP], h[FP], xh[FP], h0n[FP];
        load_row(a.htil + size_t(2 * T - 1) * slot_sz, n, f, hraw);
        apply_norm(smode, stT, ws + PL::oBnW, ws + PL::oBnB, hraw, h, xh);
        load_row(a.h0, n, f, h0n);
        const float* riw = ro_gate(w, a.w);
        const float* rjw = ro_value(w, a.w);
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
        const float y = a.labels[g], gmv = a.gmask[g];
        float dot = 0.f;
MPNN_UNROLL
        for (int o = 0; o < ODW; ++o) {
          float tj = w[PL::kRjb + o];
MPNN_UNROLL
          for (int k = 0; k < FP; ++k) {
            tj = fmaf(h[k], rjw[k * ODW + o], tj);
            tj = fmaf(h0n[k], rjw[(FP + k) * ODW + o], tj);
          }
          const float smx = pi[o] / den;
          float dout = 0.f;
          if (o < od)
            dout = gl_v * 2.0f * (a.out[size_t(g) * od + o] - y) * gmv *
                       inv_gsum +
                   a.gout[size_t(g) * od + o];
          pi[o] = smx;                       // pi now holds the softmax
          const float dsm = dout * tj;
          row[2 * FP + ODW + o] = dout * smx;          // djv
          row[2 * FP + o] = dsm;             // dsm, turned into dpi below
          dot = fmaf(dsm, smx, dot);
        }
MPNN_UNROLL
        for (int o = 0; o < ODW; ++o)
          row[2 * FP + o] = pi[o] * (row[2 * FP + o] - dot);     // dpi
        float gh[FP], dh[FP];
MPNN_UNROLL
        for (int k = 0; k < FP; ++k) {
          float t1 = 0.f, t2 = 0.f;
MPNN_UNROLL
          for (int o = 0; o < ODW; ++o) {
            const float dpi = row[2 * FP + o], djv = row[2 * FP + ODW + o];
            t1 = fmaf(riw[k * ODW + o], dpi, t1);
            t1 = fmaf(rjw[k * ODW + o], djv, t1);
            t2 = fmaf(riw[(FP + k) * ODW + o], dpi, t2);
            t2 = fmaf(rjw[(FP + k) * ODW + o], djv, t2);
          }
          gh[k] = t1;
          dh[k] = t2;
          row[k] = h[k];
          row[FP + k] = h0n[k];
        }
        store_row(a.dh0, n, f, dh);
        store_row(ghs, n, f, gh);
        if (state_stats) {
MPNN_UNROLL
          for (int j = 0; j < FP; ++j) {
            v[0][j] = state_bn ? gh[j] * ws[PL::oBnW + j] : gh[j];   // dx̂
            v[1][j] = v[0][j] * xh[j];
            v[2][j] = gh[j] * xh[j];               // ∂bn_{T−1}.weight
            v[3][j] = gh[j];                       // ∂bn_{T−1}.bias
          }
        }
      } else {
        for (int i = 0; i < kRoStage; ++i) row[i] = 0.f;
      }
      __syncthreads();
      readout_grads(wrow, gl, xs, f, od);
      if (state_stats) {
        block_feature_sums<4>(v, red, sums);
        if (tid < 2 * FP) cpart_t[size_t(ch) * 2 * FP + tid] = sums[tid];
        if (state_bn) {
          add_owned(wrow, gl.bnw + (T - 1) * f, f, sums + 2 * FP);
          add_owned(wrow, gl.bnb + (T - 1) * f, f, sums + 3 * FP);
        }
      }
      __syncthreads();
    }
    if (state_stats) {
      grid.sync();
      chunk_totals<2>(cpart_t, 2 * FP, nchunks, red, cs);
    }
  }

  // ---- the reverse walk, t = T−1..0 --------------------------------------
  for (int t = T - 1; t >= 0; --t) {
    const bool next_stats = t > 0 && state_stats;
    float* cpart_t = cpart + size_t((t - 1) & 1) * nchunks * 2 * FP;
    float* mpart_t = mpart + size_t(t) * nchunks * 2 * FP;
    for (int ch = blockIdx.x; ch < nchunks; ch += gridDim.x) {
      const int n = ch * kChunk + tid;
      float dmb[FP], xhm[FP], ghn[FP], xhp[FP];
MPNN_UNROLL
      for (int j = 0; j < FP; ++j) dmb[j] = xhm[j] = ghn[j] = xhp[j] = 0.f;
      float* row = xs + tid * kStage;
      const float* w = sm + opaque_zero();
      const float* wst = w + PL::step(t);
      const float* wsp = w + PL::step(t > 0 ? t - 1 : 0);
      if (n < n_real) {
        float gh[FP];
        load_row(ghs, n, f, gh);
        walk_node(w, st, cs, a.htil, a.h0, slot_sz, n, f, t, T, mmode,
                  smode, c, gh, row, ghn, dmb, xhm, xhp);
        store_row(dms + size_t(t) * slot_sz, n, f, dmb);
        if (t > 0) {
          store_row(ghs, n, f, ghn);
        } else {
          float d0[FP];
          load_row_cg(a.dh0, n, f, d0);
MPNN_UNROLL
          for (int j = 0; j < FP; ++j) d0[j] += ghn[j];
          store_row(a.dh0, n, f, d0);
        }
      } else {
        for (int i = 0; i < kStage; ++i) row[i] = 0.f;
      }
      __syncthreads();
      gru_grads<kStage>(wrow, gl, xs, f);
      if (msg_bn) {
        float v[4][FP];
MPNN_UNROLL
        for (int j = 0; j < FP; ++j) {
          v[0][j] = dmb[j] * wst[PL::oMaW + j];     // dx̂ of the messages
          v[1][j] = v[0][j] * xhm[j];
          v[2][j] = dmb[j] * xhm[j];                // ∂ma_bn_t.weight
          v[3][j] = dmb[j];                         // ∂ma_bn_t.bias
        }
        block_feature_sums<4>(v, red, sums);
        if (tid < 2 * FP) mpart_t[size_t(ch) * 2 * FP + tid] = sums[tid];
        add_owned(wrow, gl.maw + t * f, f, sums + 2 * FP);
        add_owned(wrow, gl.mab + t * f, f, sums + 3 * FP);
      }
      if (next_stats) {
        float v[4][FP];
MPNN_UNROLL
        for (int j = 0; j < FP; ++j) {
          v[0][j] = state_bn ? ghn[j] * wsp[PL::oBnW + j] : ghn[j];
          v[1][j] = v[0][j] * xhp[j];
          v[2][j] = ghn[j] * xhp[j];                // ∂bn_{t−1}.weight
          v[3][j] = ghn[j];                         // ∂bn_{t−1}.bias
        }
        block_feature_sums<4>(v, red, sums);
        if (tid < 2 * FP) cpart_t[size_t(ch) * 2 * FP + tid] = sums[tid];
        if (state_bn) {
          add_owned(wrow, gl.bnw + (t - 1) * f, f, sums + 2 * FP);
          add_owned(wrow, gl.bnb + (t - 1) * f, f, sums + 3 * FP);
        }
      }
      __syncthreads();
    }
    if (next_stats) {
      grid.sync();
      chunk_totals<2>(cpart_t, 2 * FP, nchunks, red, cs);
    }
  }
  grid.sync();

  // ---- message-norm totals of every step --------------------------------
  if (msg_bn)
    for (int t = 0; t < T; ++t)
      chunk_totals<2>(mpart + size_t(t) * nchunks * 2 * FP, 2 * FP, nchunks,
                      red, msum + t * 2 * FP);

  // ---- D: ∂m_t per node (message-norm VJP), S_g and D_t,g per graph -----
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
    for (int j = 0; j < FP; ++j) {
      s[j] = warp_sum(s[j]);
      if (lane == j) sg[size_t(g) * FP + j] = s[j];
    }
    for (int t = 0; t < T; ++t) {
      const float* stm = st + t * 3 * FP;
      const float* wst = sm + opaque_zero() + PL::step(t);
      float d[FP];
MPNN_UNROLL
      for (int j = 0; j < FP; ++j) d[j] = 0.f;
      for (int n = n0 + lane; n < n1; n += 32) {
        float dm[FP];
        load_row_cg(dms + size_t(t) * slot_sz, n, f, dm);
        if (msg_bn) {
          float m0[FP], xh[FP], dxh[FP];
          load_row(a.htil + size_t(t) * slot_sz, n, f, m0);
MPNN_UNROLL
          for (int j = 0; j < FP; ++j) {
            xh[j] = (m0[j] - stm[j]) / stm[2 * FP + j];
            dxh[j] = dm[j] * wst[PL::oMaW + j];
          }
          norm_vjp(dxh, xh, stm, msum + t * 2 * FP, c, dm);
          store_row(dms + size_t(t) * slot_sz, n, f, dm);
        }
MPNN_UNROLL
        for (int j = 0; j < FP; ++j) d[j] += dm[j];
      }
MPNN_UNROLL
      for (int j = 0; j < FP; ++j) {
        d[j] = warp_sum(d[j]);
        if (lane == j) dg[(size_t(t) * G + g) * FP + j] = d[j];
      }
    }
  }
  grid.sync();

  // ---- E1: ∂h0 from the messages: A0ᵀ (bias leakage) and the SpMMᵀ -----
  for (int ch = blockIdx.x; ch < nchunks; ch += gridDim.x) {
    const int n = ch * kChunk + tid;
    if (n >= n_real) continue;
    const int g = a.node_graph[n];
    float acc[FP];
MPNN_UNROLL
    for (int j = 0; j < FP; ++j) acc[j] = 0.f;
    for (int t = 0; t < T; ++t) {
      const float* a0t = sm + opaque_zero() + PL::step(t) + PL::oA0;
      float d[FP];
MPNN_UNROLL
      for (int j = 0; j < FP; ++j)
        d[j] = __ldcg(dg + (size_t(t) * G + g) * FP + j);
MPNN_UNROLL
      for (int j = 0; j < FP; ++j) {
        float v = acc[j];
MPNN_UNROLL
        for (int m = 0; m < FP; ++m) v = fmaf(a0t[m * FP + j], d[m], v);
        acc[j] = v;
      }
    }
    const int p1 = __ldg(a.src_ptr + n + 1);
    for (int p = __ldg(a.src_ptr + n); p < p1; ++p) {
      const int e = __ldg(a.src_order + p);
      const int k = __ldg(a.vid + e), dn = __ldg(a.dst + e);
      for (int t = 0; t < T; ++t) {
        const float* am = a.w.amat + (size_t(t) * K + k) * size_t(f) * f;
        float dd[FP];
        load_row_cg(dms + size_t(t) * slot_sz, dn, f, dd);
MPNN_UNROLL
        for (int m = 0; m < FP; ++m) {
          if (m < f) {
MPNN_UNROLL
            for (int j = 0; j < FP; ++j)
              if (j < f) acc[j] = fmaf(__ldg(am + m * f + j), dd[m], acc[j]);
          }
        }
      }
    }
    float d0[FP];
    load_row_cg(a.dh0, n, f, d0);
MPNN_UNROLL
    for (int j = 0; j < FP; ++j) d0[j] += acc[j];
    store_row(a.dh0, n, f, d0);
  }

  // ---- E2: dA0_t = Σ_g D_t,g ⊗ S_g, ∂mbias_t = Σ_g D_t,g, per graph chunk
  {
    constexpr int kS = 2 * FP + 1;
    const int ngch = (G + kChunk - 1) / kChunk;
    for (int gc = blockIdx.x; gc < ngch; gc += gridDim.x) {
      const int g = gc * kChunk + tid;
      for (int t = 0; t < T; ++t) {
        float* row = xs + tid * kS;
MPNN_UNROLL
        for (int j = 0; j < FP; ++j) {
          row[j] = g < G ? __ldcg(sg + size_t(g) * FP + j) : 0.f;
          row[FP + j] =
              g < G ? __ldcg(dg + (size_t(t) * G + g) * FP + j) : 0.f;
        }
        __syncthreads();
        const int off = gl.a0 + t * f * f;
        for (int e = first_owned(off); e < off + f * f; e += kThreads) {
          const int m = (e - off) / f, j = (e - off) % f;
          float s = 0.f;
          for (int i = 0; i < kChunk; ++i)
            s = fmaf(xs[i * kS + FP + m], xs[i * kS + j], s);
          wrow[e] += s;
        }
        const int offb = gl.mbias + t * f;
        for (int e = first_owned(offb); e < offb + f; e += kThreads) {
          float s = 0.f;
          for (int i = 0; i < kChunk; ++i) s += xs[i * kS + FP + e - offb];
          wrow[e] += s;
        }
        __syncthreads();
      }
    }
  }

  // ---- E3: dA_t[k] = Σ_{e: vid_e = k} ∂m_t,dst_e ⊗ h0_src_e, per edge
  //      chunk ---------------------------------------------------------------
  {
    constexpr int kS = 2 * FP + 1;
    int* vids = reinterpret_cast<int*>(red);     // kChunk ints
    const int nech = (E + kChunk - 1) / kChunk;
    const int ff = f * f;
    for (int ec = blockIdx.x; ec < nech; ec += gridDim.x) {
      const int e = ec * kChunk + tid;
      float* row = xs + tid * kS;
      if (e < E) {
        vids[tid] = __ldg(a.vid + e);
        load_row(a.h0, __ldg(a.src + e), f, row + FP);
      } else {
        vids[tid] = -1;
      }
      for (int t = 0; t < T; ++t) {
        if (e < E) load_row_cg(dms + size_t(t) * slot_sz, __ldg(a.dst + e),
                               f, row);
        __syncthreads();
        const int off = gl.a + t * K * ff;
        for (int el = first_owned(off); el < off + K * ff; el += kThreads) {
          const int i0 = el - off;
          const int k = i0 / ff, m = (i0 % ff) / f, j = i0 % f;
          float s = 0.f;
          for (int i = 0; i < kChunk; ++i)
            if (vids[i] == k) s = fmaf(xs[i * kS + m], xs[i * kS + FP + j], s);
          wrow[el] += s;
        }
        __syncthreads();
      }
    }
  }
  grid.sync();

  // ---- reduce the block rows in block order -------------------------------
  for (int e = blockIdx.x * kThreads + tid; e < NW;
       e += gridDim.x * kThreads) {
    float s = 0.f;
    for (int b = 0; b < int(gridDim.x); ++b)
      s += __ldcg(wpart + size_t(b) * NW + e);
    a.dw[e] = s;
  }
}

}  // namespace

extern "C" {

int mpnn_fused_psteps_bwd_smem_bytes(int steps) {
  return int(sizeof(float) * bwd_smem_floats(steps));
}

// The 16 offsets of the flat gradient layout (PsGradLayout), the total last.
void mpnn_fused_psteps_bwd_layout(int k_vocab, int f, int od, int steps,
                                  int* out) {
  const PsGradLayout g(k_vocab, f, od, steps);
  const int v[16] = {g.a, g.a0, g.mbias, g.wih, g.whh, g.bih, g.bhh, g.maw,
                     g.mab, g.bnw, g.bnb, g.riw, g.rib, g.rjw, g.rjb,
                     g.total};
  for (int i = 0; i < 16; ++i) out[i] = v[i];
}

long long mpnn_fused_psteps_bwd_scratch_floats(int n_nodes, int n_graphs,
                                               int k_vocab, int f, int od,
                                               int steps, int grid) {
  return bwd_scratch_floats(n_nodes, n_graphs, k_vocab, f, od, steps, grid);
}

int mpnn_fused_psteps_bwd_grid(int steps, int n_nodes, int n_graphs,
                               int n_edges) {
  const int need = max(max((n_nodes + kChunk - 1) / kChunk,
                           (n_graphs + kWarps - 1) / kWarps),
                       (n_edges + kChunk - 1) / kChunk);
  return coop_grid(fused_psteps_bwd_kernel,
                   sizeof(float) * bwd_smem_floats(steps), need);
}

int mpnn_fused_psteps_bwd(
    const float* amat, const float* a0, const float* mbias,
    const float* w_ih, const float* w_hh, const float* b_ih,
    const float* b_hh, const float* ma_w, const float* ma_b,
    const float* bn_w, const float* bn_b, const float* ro_iw,
    const float* ro_ib, const float* ro_jw, const float* ro_jb,
    const float* h0, const float* labels, const float* gmask,
    const float* out, const float* gout, const float* gl, const float* htil,
    const float* stats, const int* vid, const int* src, const int* dst,
    const int* src_order, const int* src_ptr, const int* graph_node_ptr,
    const int* node_graph, float* dh0, float* dw, float* scratch,
    int n_nodes, int n_graphs, int n_edges, int f, int od, int k_vocab,
    int steps, int msg_mode, int state_mode, int grid, void* stream) {
  if (f > FP || od > ODW || steps < 1 || steps > kMaxSteps || grid < 1 ||
      (msg_mode != kNone && msg_mode != kBatchBn) ||
      (state_mode != kNone && state_mode != kBatchBn &&
       state_mode != kStateless))
    return int(cudaErrorInvalidValue);
  PsBwdArgs a{{amat, a0, mbias, w_ih, w_hh, b_ih, b_hh, ma_w, ma_b, bn_w,
               bn_b, ro_iw, ro_ib, ro_jw, ro_jb},
              h0, labels, gmask, out, gout, gl, htil, stats, vid, src, dst,
              src_order, src_ptr, graph_node_ptr, node_graph, dh0, dw,
              scratch, n_nodes, n_graphs, n_edges, f, od, k_vocab, steps,
              msg_mode, state_mode};
  return coop_launch(fused_psteps_bwd_kernel, a,
                     sizeof(float) * bwd_smem_floats(steps), grid, stream);
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
