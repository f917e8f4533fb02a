// Whole-step TRAINING backward of the shared-weight edge-network MPNN (the
// flagship `lipo` training path), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mpnn_tpu/kernels/fused_step.py::_full_bwd_kernel
// (the VJP of make_fused_step_op, with the reverse walk of
// kernels/recurrence.py::vmem_reverse_walk inlined). Given the cotangents
// gl of the loss and gout of out, and the forward's residuals (htil, the
// per-slot batch statistics, out), it computes every gradient leaf:
//
//   dout  = gl·2(out − y)·gm/Σgm + gout
//   readout VJP per node (softmax over od) → ∂h_T, ∂h0, ∂W_i, ∂W_j, ∂b
//   for t = T..1: masked-norm VJP with the batch sums S1 = Σ dx̂,
//                 S2 = Σ dx̂·x̂ of slot t (closed form,
//                 dx = (dx̂ − S1/c)/d − x̂·S2/(c·s); bn1d: dx̂ = w·∂y,
//                 d = s + 1e-5; the stateless norm: dx̂ = ∂y, d = s =
//                 sqrt(var + 1e-6), so dx = (dx̂ − mean(dx̂) −
//                 x̂·mean(dx̂·x̂))/s over real nodes); GRU VJP → ∂h_{t−1},
//                 ∂W_ih, ∂W_hh, ∂b_ih, ∂b_hh (b_hh's n part sees r·∂n,
//                 b_ih's sees ∂n), ∂(message input)
//   message-BN VJP (batch sums of slot 0) → ∂m
//   dA0 = Σ_g (Σ_{v∈g} ∂m_v) ⊗ S_g;  ∂h0_v += A0ᵀ·Σ_{w∈g(v)} ∂m_w for
//   EVERY node of the graph (bias leakage), + Σ_{e: src_e = v}
//   A[vid_e]ᵀ·∂m_{dst_e};  dA[k] = Σ_{e: vid_e = k} ∂m_{dst_e} ⊗ h0_{src_e};
//   ∂mbias = Σ ∂m.
//
// Design: ONE cooperative launch. Node phases run on node chunks, graph
// phases one warp per graph (fused_train_common.cuh). The batch sums
// S1, S2 of each step come from per-chunk partials combined in chunk order
// after a grid barrier (T + 1 of them for bn1d/bn1d, plus one before the
// message backward and one before the final reduction). Every weight
// gradient is accumulated into a block-private row of partials, each
// element owned by one thread of the block (no races, no atomics):
// per-node terms are staged in shared memory per chunk and the owners sum
// them in node order; the per-graph terms of A0 and mbias are warp
// partials combined in warp order; dA is summed per edge chunk. At the
// end the block rows are reduced in block order. Results are
// deterministic for a given grid size. The chunk partials of S1, S2
// alternate between two buffers by slot parity, as in the forward.
//
// The readout VJP runs a thread per node. Up to ODP 64 its od-long
// logits sit in registers; past it (the od-128 build) they are staged in
// the node's shared-memory row, which is then 2FP + 2ODP + 1 floats, and
// the readout weights are read from device memory (ro_table).
//
// Bound on an H100 SXM: as the forward, ~2× its arithmetic on a few MB;
// the T + 3 grid barriers dominate in practice.

#include "fused_train_common.cuh"

namespace {

using namespace mpnn_train;

// Flat layout of the gradient output (and of each block's partial row):
// real (unpadded) shapes, in this order. kernels/fused_step.py::grad_layout
// mirrors it and checks it against mpnn_fused_step_bwd_layout.
struct GradLayout {
  int a, a0, mbias, wih, whh, bih, bhh, maw, mab, bnw, bnb, riw, rib, rjw,
      rjb, total;
  __host__ __device__ GradLayout(int k, int f, int od) {
    a = 0;
    a0 = a + k * f * f;
    mbias = a0 + f * f;
    wih = mbias + f;
    whh = wih + 3 * f * f;
    bih = whh + 3 * f * f;
    bhh = bih + 3 * f;
    maw = bhh + 3 * f;
    mab = maw + f;
    bnw = mab + f;
    bnb = bnw + f;
    riw = bnb + f;
    rib = riw + 2 * f * od;
    rjw = rib + od;
    rjb = rjw + 2 * f * od;
    total = rjb + od;
  }
};

struct BwdArgs {
  Weights w;
  const float* h0;          // (N, f), pre-masked
  const float* labels;      // (G)
  const float* gmask;       // (G)
  const float* out;         // (G, od) forward output
  const float* gout;        // (G, od) cotangent of out
  const float* gl;          // (1) cotangent of the loss
  const float* htil;        // (T + 1, N, f) forward residuals
  const float* stats;       // (T + 1, 2, f) forward batch statistics
  const int* vid;           // (E)
  const int* src;           // (E)
  const int* dst;           // (E)
  const int* src_order;     // (E) edge ids, stably sorted by source
  const int* src_ptr;       // (N + 1) row pointers into src_order
  const int* graph_node_ptr;  // (G + 1)
  const int* node_graph;    // (N)
  float* dh0;               // (N, f)
  float* dw;                // GradLayout(K, f, od).total
  float* scratch;
  // msg_mode in {kNone, kBatchBn}, state_mode in {kNone, kBatchBn,
  // kStateless} (fused_train_common.cuh::Mode)
  int n_nodes, n_graphs, n_edges, f, od, k_vocab, steps, msg_mode,
      state_mode;
};

// staged floats per node (odd strides): the readout VJP's rows
// [h | h0 | dpi | djv], the GRU VJP's [mb | hprev | da_r | da_z | da_n | dnh]
constexpr int kRoStage = 2 * FP + 2 * ODP + 1;
constexpr int kStage = 6 * FP + 1 > kRoStage ? 6 * FP + 1 : kRoStage;

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

// Readout weight gradients of one chunk from the staged rows
// [h (FP) | h0 (FP) | dpi (ODP) | djv (ODP)].
__device__ void readout_grads(float* wrow, const GradLayout& gl,
                              const float* xs, int f, int od) {
  constexpr int kS = kRoStage;
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
      col_d = 2 * FP + ODP + i % od;
    } else {
      col_d = 2 * FP + ODP + (e - gl.rjb);
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

// GRU weight gradients of one chunk from the staged rows
// [mb | hprev | da_r | da_z | da_n | dnh] (FP each).
__device__ void gru_grads(float* wrow, const GradLayout& gl, const float* xs,
                          int f) {
  for (int e = first_owned(gl.wih); e < gl.maw; e += kThreads) {
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
        s = fmaf(xs[i * kStage + col_x], xs[i * kStage + col_d], s);
    } else {
      for (int i = 0; i < kChunk; ++i) s += xs[i * kStage + col_d];
    }
    wrow[e] += s;
  }
}

__global__ void __launch_bounds__(kThreads)
fused_step_bwd_kernel(BwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float sm[];
  const int f = a.f, od = a.od, T = a.steps;
  const int mmode = a.msg_mode, smode = a.state_mode;
  const bool msg_stats = has_stats(mmode), state_stats = has_stats(smode);
  stage_weights(sm, a.w, f, od, a.k_vocab, smode != kStateless);
  float* st = sm + L::stats(a.k_vocab);                // (T+1)·3·FP
  float* red = sm + L::after_stats(a.k_vocab, T);      // kWarps·4·FP
  float* sums = red + kWarps * 4 * FP;                 // 4·FP
  float* cs = sums + 4 * FP;                           // S1, S2 (2·FP)
  float* misc = cs + 2 * FP;                           // Σ gm, …
  float* xs = misc + 4;                                // kChunk·kStage

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int N = a.n_nodes, G = a.n_graphs, E = a.n_edges;
  const GradLayout gl(a.k_vocab, f, od);
  const int NW = gl.total;
  const int n_real = a.graph_node_ptr[G];
  const float c = float(n_real);
  const int nchunks = (n_real + kChunk - 1) / kChunk;
  const size_t slot_sz = size_t(N) * f;
  float* ghs = a.scratch;                              // (N, f)
  float* dmbs = ghs + slot_sz;                         // (N, f)
  float* dmsgs = dmbs + slot_sz;                       // (N, f)
  float* cpart = dmsgs + slot_sz;                      // 2·nchunks·2·FP
  float* wpart = cpart + 2 * size_t(nchunks) * 2 * FP;  // grid·NW
  float* wrow = wpart + size_t(blockIdx.x) * NW;

  // ---- set-up: norm constants of every slot, Σ gm, zeroed partials ------
  for (int i = tid; i < (T + 1) * FP; i += kThreads) {
    const int s = i / FP, j = i % FP;
    const float mean = j < f ? a.stats[(size_t(s) * 2) * f + j] : 0.f;
    const float var = j < f ? a.stats[(size_t(s) * 2 + 1) * f + j] : 0.f;
    set_slot(st + s * 3 * FP, j, mean, var, s > 0 && smode == kStateless);
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
    const size_t pad = size_t(N - n_real) * f;
    for (size_t i = size_t(blockIdx.x) * kThreads + tid; i < pad;
         i += size_t(gridDim.x) * kThreads) {
      a.dh0[size_t(n_real) * f + i] = 0.f;
      dmsgs[size_t(n_real) * f + i] = 0.f;
    }
  }
  __syncthreads();
  const float inv_gsum = 1.0f / misc[0];
  const float gl_v = a.gl[0];

  // ---- B0: readout + loss VJP per node, and slot T's norm sums ----------
  {
    constexpr int kS = kRoStage;
    const float* stT = st + T * 3 * FP;
    float* cpart_t = cpart + size_t(T & 1) * nchunks * 2 * FP;
    for (int ch = blockIdx.x; ch < nchunks; ch += gridDim.x) {
      const int n = ch * kChunk + tid;
      float v[4][FP];
MPNN_UNROLL
      for (int q = 0; q < 4; ++q)
MPNN_UNROLL
        for (int j = 0; j < FP; ++j) v[q][j] = 0.f;
      float* row = xs + tid * kS;
      if (n < n_real) {
        const float* w = sm + opaque_zero();
        const int g = a.node_graph[n];
        float hraw[FP], h[FP], xh[FP], h0n[FP];
        load_row(a.htil + size_t(T) * slot_sz, n, f, hraw);
        if (state_stats) {
          xhat_of(stT, hraw, xh);
MPNN_UNROLL
          for (int j = 0; j < FP; ++j)
            h[j] = w[L::kBnW + j] * xh[j] + w[L::kBnB + j];
        } else {
MPNN_UNROLL
          for (int j = 0; j < FP; ++j) h[j] = hraw[j];
        }
        load_row(a.h0, n, f, h0n);
        const float y = a.labels[g], gmv = a.gmask[g];
        float gh[FP], dh[FP];
        if constexpr (kRoInSmem) {
          float pi[ODP], pj[ODP];
MPNN_UNROLL
          for (int o = 0; o < ODP; ++o) {
            float ti = w[L::kRib + o], tj = w[L::kRjb + o];
MPNN_UNROLL
            for (int k = 0; k < FP; ++k) {
              ti = fmaf(h[k], w[L::kRiw + k * ODP + o], ti);
              tj = fmaf(h[k], w[L::kRjw + k * ODP + o], tj);
              ti = fmaf(h0n[k], w[L::kRiw + (FP + k) * ODP + o], ti);
              tj = fmaf(h0n[k], w[L::kRjw + (FP + k) * ODP + o], tj);
            }
            pi[o] = ti;
            pj[o] = tj;
          }
          float mx = -INFINITY;
MPNN_UNROLL
          for (int o = 0; o < ODP; ++o)
            if (o < od) mx = fmaxf(mx, pi[o]);
          float den = 0.f;
MPNN_UNROLL
          for (int o = 0; o < ODP; ++o) {
            pi[o] = o < od ? expf(pi[o] - mx) : 0.f;
            den += pi[o];
          }
          float dot = 0.f;
MPNN_UNROLL
          for (int o = 0; o < ODP; ++o) {
            const float smx = pi[o] / den;
            float dout = 0.f;
            if (o < od)
              dout = gl_v * 2.0f * (a.out[size_t(g) * od + o] - y) * gmv *
                         inv_gsum +
                     a.gout[size_t(g) * od + o];
            pi[o] = smx;                       // pi now holds the softmax
            const float dsm = dout * pj[o];
            pj[o] = dout * smx;                // pj now holds djv
            row[2 * FP + ODP + o] = pj[o];
            row[2 * FP + o] = dsm;             // dsm, turned into dpi below
            dot = fmaf(dsm, smx, dot);
          }
MPNN_UNROLL
          for (int o = 0; o < ODP; ++o) {
            const float dpi = pi[o] * (row[2 * FP + o] - dot);
            row[2 * FP + o] = dpi;
            pi[o] = dpi;
          }
MPNN_UNROLL
          for (int k = 0; k < FP; ++k) {
            float t1 = 0.f, t2 = 0.f;
MPNN_UNROLL
            for (int o = 0; o < ODP; ++o) {
              t1 = fmaf(w[L::kRiw + k * ODP + o], pi[o], t1);
              t1 = fmaf(w[L::kRjw + k * ODP + o], pj[o], t1);
              t2 = fmaf(w[L::kRiw + (FP + k) * ODP + o], pi[o], t2);
              t2 = fmaf(w[L::kRjw + (FP + k) * ODP + o], pj[o], t2);
            }
            gh[k] = t1;
            dh[k] = t2;
            row[k] = h[k];
            row[FP + k] = h0n[k];
          }
        } else {
          // the logits staged in the node's row: dpi's slot holds the gate
          // logits, then their exps, then dsm, then dpi; djv's holds the
          // softmax, then djv
          const float* riw = ro_gate(w, a.w);
          const float* rjw = ro_value(w, a.w);
          float* dpi = row + 2 * FP;
          float* djv = row + 2 * FP + ODP;
          float mx = -INFINITY;
          for (int o = 0; o < ODP; ++o) {
            float ti = w[L::kRib + o];
MPNN_UNROLL
            for (int k = 0; k < FP; ++k) {
              ti = fmaf(h[k], __ldg(riw + k * ODP + o), ti);
              ti = fmaf(h0n[k], __ldg(riw + (FP + k) * ODP + o), ti);
            }
            dpi[o] = ti;
            if (o < od) mx = fmaxf(mx, ti);
          }
          float den = 0.f;
          for (int o = 0; o < ODP; ++o) {
            const float ex = o < od ? expf(dpi[o] - mx) : 0.f;
            dpi[o] = ex;
            den += ex;
          }
          // dout_o = ∂loss/∂out_go·gl + gout_go (0 past od)
          auto dout_of = [&](int o) {
            return o < od ? gl_v * 2.0f * (a.out[size_t(g) * od + o] - y) *
                                    gmv * inv_gsum +
                                a.gout[size_t(g) * od + o]
                          : 0.f;
          };
          float dot = 0.f;
          for (int o = 0; o < ODP; ++o) {
            float tj = w[L::kRjb + o];
MPNN_UNROLL
            for (int k = 0; k < FP; ++k) {
              tj = fmaf(h[k], __ldg(rjw + k * ODP + o), tj);
              tj = fmaf(h0n[k], __ldg(rjw + (FP + k) * ODP + o), tj);
            }
            const float smx = dpi[o] / den;
            const float dsm = dout_of(o) * tj;
            dpi[o] = dsm;
            djv[o] = smx;
            dot = fmaf(dsm, smx, dot);
          }
          for (int o = 0; o < ODP; ++o) {
            const float smx = djv[o];
            dpi[o] = smx * (dpi[o] - dot);
            djv[o] = dout_of(o) * smx;
          }
MPNN_UNROLL
          for (int k = 0; k < FP; ++k) {
            float t1 = 0.f, t2 = 0.f;
            for (int o = 0; o < ODP; ++o) {
              t1 = fmaf(__ldg(riw + k * ODP + o), dpi[o], t1);
              t1 = fmaf(__ldg(rjw + k * ODP + o), djv[o], t1);
              t2 = fmaf(__ldg(riw + (FP + k) * ODP + o), dpi[o], t2);
              t2 = fmaf(__ldg(rjw + (FP + k) * ODP + o), djv[o], t2);
            }
            gh[k] = t1;
            dh[k] = t2;
            row[k] = h[k];
            row[FP + k] = h0n[k];
          }
        }
        store_row(a.dh0, n, f, dh);
        store_row(ghs, n, f, gh);
        if (state_stats) {
MPNN_UNROLL
          for (int j = 0; j < FP; ++j) {
            v[0][j] = gh[j] * w[L::kBnW + j];      // dx̂
            v[1][j] = v[0][j] * xh[j];
            v[2][j] = gh[j] * xh[j];               // ∂bn.weight
            v[3][j] = gh[j];                       // ∂bn.bias
          }
        }
      } else {
        for (int i = 0; i < kS; ++i) row[i] = 0.f;
      }
      __syncthreads();
      readout_grads(wrow, gl, xs, f, od);
      if (state_stats) {
        block_feature_sums<4>(v, red, sums);
        if (tid < 2 * FP) cpart_t[size_t(ch) * 2 * FP + tid] = sums[tid];
        if (smode == kBatchBn) {
          add_owned(wrow, gl.bnw, f, sums + 2 * FP);
          add_owned(wrow, gl.bnb, f, sums + 3 * FP);
        }
      }
      __syncthreads();
    }
    if (state_stats) {
      grid.sync();
      chunk_totals<2>(cpart_t, 2 * FP, nchunks, red, cs);
    }
  }

  // ---- the reverse walk, t = T..1 ----------------------------------------
  const float* st0 = st;
  for (int t = T; t >= 1; --t) {
    const float* stt = st + t * 3 * FP;
    const float* stp = st + (t - 1) * 3 * FP;
    const bool next_bn = t > 1 ? state_stats : msg_stats;
    // the norm before step t carries an affine with gradients
    const bool next_affine = (t > 1 ? smode : mmode) == kBatchBn;
    float* cpart_t = cpart + size_t((t - 1) & 1) * nchunks * 2 * FP;
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
        float dhp[FP], hprev[FP], xhp[FP], mb[FP], xh0[FP];
        {
          float gh[FP];
          load_row(ghs, n, f, gh);
          if (state_stats) {
            float x[FP], xh[FP];
            load_row(a.htil + size_t(t) * slot_sz, n, f, x);
            xhat_of(stt, x, xh);
MPNN_UNROLL
            for (int j = 0; j < FP; ++j) {
              const float dxh = gh[j] * w[L::kBnW + j];
              dhp[j] = (dxh - cs[j] / c) / stt[2 * FP + j] -
                       xh[j] * cs[FP + j] / (c * stt[FP + j]);
            }
          } else {
MPNN_UNROLL
            for (int j = 0; j < FP; ++j) dhp[j] = gh[j];
          }
        }
        if (t > 1) {
          load_row(a.htil + size_t(t - 1) * slot_sz, n, f, hprev);
          if (state_stats) {
            xhat_of(stp, hprev, xhp);
MPNN_UNROLL
            for (int j = 0; j < FP; ++j)
              hprev[j] = w[L::kBnW + j] * xhp[j] + w[L::kBnB + j];
          }
        } else {
          load_row(a.h0, n, f, hprev);
        }
        load_row(a.htil, n, f, mb);
        if (msg_stats) {
          xhat_of(st0, mb, xh0);
MPNN_UNROLL
          for (int j = 0; j < FP; ++j)
            mb[j] = w[L::kMaW + j] * xh0[j] + w[L::kMaB + j];
        }
        float ghn[FP];
MPNN_UNROLL
        for (int j = 0; j < FP; ++j) {
          float gr = w[L::kBih + j], gz = w[L::kBih + FP + j],
                gn = w[L::kBih + 2 * FP + j];
          float rh = w[L::kBhh + j], zh = w[L::kBhh + FP + j],
                nh = w[L::kBhh + 2 * FP + j];
MPNN_UNROLL
          for (int k = 0; k < FP; ++k) {
            const float* wi = w + L::kWih + k * 3 * FP;
            const float* wh = w + L::kWhh + k * 3 * FP;
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
        float dmb[FP];
        if (t == T) {
MPNN_UNROLL
          for (int k = 0; k < FP; ++k) dmb[k] = 0.f;
        } else {
          load_row(dmbs, n, f, dmb);
        }
MPNN_UNROLL
        for (int k = 0; k < FP; ++k) {
          const float* wh = w + L::kWhh + k * 3 * FP;
          const float* wi = w + L::kWih + k * 3 * FP;
          float th = ghn[k], ti = dmb[k];
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
        store_row(dmbs, n, f, dmb);
        if (t > 1) {
          store_row(ghs, n, f, ghn);
          if (state_stats) {
MPNN_UNROLL
            for (int j = 0; j < FP; ++j) {
              v[0][j] = ghn[j] * w[L::kBnW + j];
              v[1][j] = v[0][j] * xhp[j];
              v[2][j] = ghn[j] * xhp[j];
              v[3][j] = ghn[j];
            }
          }
        } else {
          float d0[FP];
          load_row_cg(a.dh0, n, f, d0);
MPNN_UNROLL
          for (int j = 0; j < FP; ++j) d0[j] += ghn[j];
          store_row(a.dh0, n, f, d0);
          if (msg_stats) {
MPNN_UNROLL
            for (int j = 0; j < FP; ++j) {
              v[0][j] = dmb[j] * w[L::kMaW + j];    // dx̂ of the messages
              v[1][j] = v[0][j] * xh0[j];
              v[2][j] = dmb[j] * xh0[j];            // ∂ma_bn.weight
              v[3][j] = dmb[j];                     // ∂ma_bn.bias
            }
          } else {
            store_row(dmsgs, n, f, dmb);
          }
        }
      } else {
        for (int i = 0; i < kStage; ++i) row[i] = 0.f;
      }
      __syncthreads();
      gru_grads(wrow, gl, xs, f);
      if (next_bn) {
        block_feature_sums<4>(v, red, sums);
        if (tid < 2 * FP) cpart_t[size_t(ch) * 2 * FP + tid] = sums[tid];
        if (next_affine) {
          add_owned(wrow, t > 1 ? gl.bnw : gl.maw, f, sums + 2 * FP);
          add_owned(wrow, t > 1 ? gl.bnb : gl.mab, f, sums + 3 * FP);
        }
      }
      __syncthreads();
    }
    if (next_bn) {
      grid.sync();
      chunk_totals<2>(cpart_t, 2 * FP, nchunks, red, cs);
    }
  }

  // ---- message-BN VJP: ∂m per node (S1, S2 of slot 0 in cs) -------------
  if (msg_stats) {
    for (int ch = blockIdx.x; ch < nchunks; ch += gridDim.x) {
      const int n = ch * kChunk + tid;
      if (n < n_real) {
        float dmb[FP], m0[FP], xh0[FP], dm[FP];
        load_row(dmbs, n, f, dmb);
        load_row(a.htil, n, f, m0);
        xhat_of(st0, m0, xh0);
MPNN_UNROLL
        for (int j = 0; j < FP; ++j) {
          const float dxm = dmb[j] * sm[L::kMaW + j];
          dm[j] = (dxm - cs[j] / c) / st0[2 * FP + j] -
                  xh0[j] * cs[FP + j] / (c * st0[FP + j]);
        }
        store_row(dmsgs, n, f, dm);
      }
    }
  }
  grid.sync();

  // ---- message VJP per graph: A0 (bias leakage), mbias, SpMM → ∂h0 -------
  {
    const int gw = blockIdx.x * kWarps + warp, nw = gridDim.x * kWarps;
    constexpr int kPer = FP * FP / 32;
    float da0[kPer], dmbias = 0.f;
MPNN_UNROLL
    for (int r = 0; r < kPer; ++r) da0[r] = 0.f;
    for (int g = gw; g < G; g += nw) {
      const int n0 = a.graph_node_ptr[g], n1 = a.graph_node_ptr[g + 1];
      float s[FP], d[FP];
MPNN_UNROLL
      for (int j = 0; j < FP; ++j) s[j] = d[j] = 0.f;
      for (int n = n0 + lane; n < n1; n += 32) {
        float hn[FP], dn[FP];
        load_row(a.h0, n, f, hn);
        load_row_cg(dmsgs, n, f, dn);
MPNN_UNROLL
        for (int j = 0; j < FP; ++j) {
          s[j] += hn[j];
          d[j] += dn[j];
        }
      }
MPNN_UNROLL
      for (int j = 0; j < FP; ++j) {
        s[j] = warp_sum(s[j]);
        d[j] = warp_sum(d[j]);
        if (j == lane) dmbias += d[j];
      }
MPNN_UNROLL
      for (int r = 0; r < kPer; ++r) {
        const int e = lane + 32 * r;
        float dv = 0.f, sv = 0.f;
MPNN_UNROLL
        for (int j = 0; j < FP; ++j) {          // d[e / FP], s[e % FP]
          if (j == e / FP) dv = d[j];
          if (j == e % FP) sv = s[j];
        }
        da0[r] = fmaf(dv, sv, da0[r]);
      }
      float bt[FP];
MPNN_UNROLL
      for (int j = 0; j < FP; ++j) {
        float t = 0.f;
MPNN_UNROLL
        for (int m = 0; m < FP; ++m) t = fmaf(sm[L::kA0 + m * FP + j], d[m], t);
        bt[j] = t;
      }
      for (int n = n0 + lane; n < n1; n += 32) {
        const float* w = sm + opaque_zero();
        float acc[FP];
MPNN_UNROLL
        for (int j = 0; j < FP; ++j) acc[j] = bt[j];
        const int p1 = __ldg(a.src_ptr + n + 1);
        for (int p = __ldg(a.src_ptr + n); p < p1; ++p) {
          const int e = __ldg(a.src_order + p);
          const float* am = amat_of(w, a.w, __ldg(a.vid + e));
          float dd[FP];
          load_row_cg(dmsgs, __ldg(a.dst + e), f, dd);
MPNN_UNROLL
          for (int j = 0; j < FP; ++j) {
            float t = 0.f;
MPNN_UNROLL
            for (int m = 0; m < FP; ++m) t = fmaf(am[m * FP + j], dd[m], t);
            acc[j] += t;
          }
        }
        float d0[FP];
        load_row_cg(a.dh0, n, f, d0);
MPNN_UNROLL
        for (int j = 0; j < FP; ++j) d0[j] += acc[j];
        store_row(a.dh0, n, f, d0);
      }
    }
    // warp partials → the block row, in warp order
    float* wred = xs;                            // kWarps·(FP·FP + FP)
    constexpr int kW = FP * FP + FP;
MPNN_UNROLL
    for (int r = 0; r < kPer; ++r) wred[warp * kW + lane + 32 * r] = da0[r];
    if (lane < FP) wred[warp * kW + FP * FP + lane] = dmbias;
    __syncthreads();
    for (int e = first_owned(gl.a0); e < gl.wih; e += kThreads) {
      const int i = e - gl.a0;
      const int col = e < gl.mbias ? (i / f) * FP + i % f : FP * FP + (i - f * f);
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += wred[w * kW + col];
      wrow[e] += s;
    }
    __syncthreads();
  }

  // ---- dA[k] = Σ_{e: vid_e = k} ∂m_{dst_e} ⊗ h0_{src_e}, per edge chunk --
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
        load_row_cg(dmsgs, __ldg(a.dst + e), f, row);
        load_row(a.h0, __ldg(a.src + e), f, row + FP);
      } else {
        vids[tid] = -1;
      }
      __syncthreads();
      for (int el = first_owned(gl.a); el < gl.a0; el += kThreads) {
        const int k = el / ff, m = (el % ff) / f, j = el % f;
        float s = 0.f;
        for (int i = 0; i < kChunk; ++i)
          if (vids[i] == k) s = fmaf(xs[i * kS + m], xs[i * kS + FP + j], s);
        wrow[el] += s;
      }
      __syncthreads();
    }
  }
  grid.sync();

  // ---- reduce the block rows in block order -------------------------------
  for (int e = blockIdx.x * kThreads + tid; e < NW;
       e += gridDim.x * kThreads) {
    float s = 0.f;
    for (int b = 0; b < int(gridDim.x); ++b) s += __ldcg(wpart + size_t(b) * NW + e);
    a.dw[e] = s;
  }
}

size_t smem_bytes(int k_vocab, int steps) {
  return sizeof(float) *
         (size_t(L::after_stats(k_vocab, steps)) + kWarps * 4 * FP + 4 * FP +
          2 * FP + 4 + size_t(kChunk) * kStage);
}

}  // namespace

extern "C" {

int mpnn_fused_step_bwd_smem_bytes(int k_vocab, int steps) {
  return int(smem_bytes(k_vocab, steps));
}

// The 16 offsets of the flat gradient layout (GradLayout), the total last.
void mpnn_fused_step_bwd_layout(int k_vocab, int f, int od, int* out) {
  const GradLayout g(k_vocab, f, od);
  const int v[16] = {g.a, g.a0, g.mbias, g.wih, g.whh, g.bih, g.bhh, g.maw,
                     g.mab, g.bnw, g.bnb, g.riw, g.rib, g.rjw, g.rjb,
                     g.total};
  for (int i = 0; i < 16; ++i) out[i] = v[i];
}

long long mpnn_fused_step_bwd_scratch_floats(int n_nodes, int k_vocab, int f,
                                             int od, int grid) {
  const long long nchunks = (n_nodes + kChunk - 1) / kChunk;
  return 3LL * n_nodes * f + 2 * nchunks * 2 * FP +
         (long long)grid * GradLayout(k_vocab, f, od).total;
}

int mpnn_fused_step_bwd_grid(int k_vocab, int steps, int n_nodes,
                             int n_graphs, int n_edges) {
  const size_t bytes = smem_bytes(k_vocab, steps);
  if (cudaFuncSetAttribute(fused_step_bwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(bytes)) != cudaSuccess)
    return 0;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fused_step_bwd_kernel, kThreads, bytes) != cudaSuccess)
    return 0;
  const int need = max(max((n_nodes + kChunk - 1) / kChunk,
                           (n_graphs + kWarps - 1) / kWarps),
                       max((n_edges + kChunk - 1) / kChunk, 1));
  return min(per_sm * sms, need);
}

int mpnn_fused_step_bwd(
    const float* amat, const float* a0, const float* mbias, const float* h0,
    const float* w_ih, const float* w_hh, const float* b_ih,
    const float* b_hh, const float* ma_w, const float* ma_b,
    const float* bn_w, const float* bn_b, const float* ro_iw,
    const float* ro_ib, const float* ro_jw, const float* ro_jb,
    const float* labels, const float* gmask, const float* out,
    const float* gout, const float* gl, const float* htil,
    const float* stats, const int* vid, const int* src, const int* dst,
    const int* src_order, const int* src_ptr, const int* graph_node_ptr,
    const int* node_graph, float* dh0, float* dw, float* scratch,
    int n_nodes, int n_graphs, int n_edges, int f, int od, int k_vocab,
    int steps, int msg_mode, int state_mode, int grid, void* stream) {
  if (f > FP || od > ODP || steps < 1 || steps > kMaxSteps || grid < 1 ||
      (msg_mode != kNone && msg_mode != kBatchBn) ||
      (state_mode != kNone && state_mode != kBatchBn &&
       state_mode != kStateless))
    return int(cudaErrorInvalidValue);
  BwdArgs a{{amat, a0, mbias, w_ih, w_hh, b_ih, b_hh, ma_w, ma_b, bn_w,
             bn_b, ro_iw, ro_ib, ro_jw, ro_jb},
            h0, labels, gmask, out, gout, gl, htil, stats, vid, src, dst,
            src_order, src_ptr, graph_node_ptr, node_graph, dh0, dw,
            scratch, n_nodes, n_graphs, n_edges, f, od, k_vocab, steps,
            msg_mode, state_mode};
  const size_t bytes = smem_bytes(k_vocab, steps);
  cudaError_t err = cudaFuncSetAttribute(
      fused_step_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (err != cudaSuccess) return int(err);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((void*)fused_step_bwd_kernel, dim3(grid),
                                    dim3(kThreads), args, bytes,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
