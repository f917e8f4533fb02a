// The per-step family's reverse walk through its recurrence, the middle of
// its split training backward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mpnn_tpu/kernels/fused_psteps.py::
// _ps_stream_walk_kernel (the reverse walk of _streaming_bwd). Given the
// cotangent gh of h_T (csrc/ro_bwd.cu) and the forward's residuals (htil
// (2T, N, f): the masked messages of each step in slots 0..T−1, the
// pre-norm GRU outputs in slots T..2T−1; their batch statistics):
//
//   for t = T−1..0:
//     state-norm VJP of step t with its batch sums S1 = Σ dx̂,
//       S2 = Σ dx̂·x̂ (closed form dx = (dx̂ − S1/c)/d − x̂·S2/(c·s); bn1d:
//       s = √max(var, 1e-12), d = s + 1e-5, dx̂ = w·g; stateless:
//       d = s = √(var + 1e-6), dx̂ = g; none: dx = g), ∂bn_t
//     GRU VJP → ∂h_{t−1}, ∂W_ih, ∂W_hh, ∂b_ih, ∂b_hh (b_hh's n part sees
//       r·∂n), ∂mb_t
//   dh0 = ∂h_{−1}; per step the message-norm VJP (its own batch sums)
//     → dm_t (T, N, f), the cotangent of the masked messages, ∂ma_bn_t
//
// and zero rows at padded nodes. c is the real-node count.
//
// Bound on an H100 SXM: per node and step the replayed GRU gates and the
// transposed products for ∂h and ∂mb (~24f² flop) and the outer products
// of ∂W (~12f²), over the bytes of the stash, gh and the outputs: at the
// per-step family's b3584 (57.8k slots, f 8, T 3) ~3 us by bytes and
// ~0.3 us of f32 arithmetic. The grid barriers (one per step with state
// statistics, one after the walk) and the per-chunk owner sums set the
// time.
//
// Design: ONE cooperative launch, the reverse walk of the whole-step
// backward (csrc/fused_psteps_bwd.cu) without its readout and message
// phases. Node phases on 128-node chunks (chunk c on block c mod
// gridDim.x in every phase, so a thread reads back its own rows); batch
// sums from per-chunk partials combined in chunk order after a barrier,
// the state-norm partials alternating between two buffers by step parity
// and the message norms' kept per step; weight gradients in block-private
// rows of partials, each element owned by one thread, reduced in block
// order at the end. No float atomics: deterministic for a given grid.

#include "fused_psteps_common.cuh"

namespace {

using namespace mpnn_psteps;
using mpnn_train::block_feature_sums;
using mpnn_train::chunk_totals;

// Flat layout of the gradient output (and of each block's partial row):
// kernels/psteps_walk.py::grad_layout mirrors it and checks it against
// mpnn_ps_walk_bwd_layout.
struct WalkLayout {
  int wih, whh, bih, bhh, maw, mab, bnw, bnb, total;
  __host__ __device__ WalkLayout(int f, int T) {
    wih = 0;
    whh = wih + 3 * f * f;
    bih = whh + 3 * f * f;
    bhh = bih + 3 * f;
    maw = bhh + 3 * f;
    mab = maw + T * f;
    bnw = mab + T * f;
    bnb = bnw + T * f;
    total = bnb + T * f;
  }
};

struct WalkArgs {
  PsWeights w;
  const float* gh;              // (N, f) cotangent of h_T
  const float* h0;              // (N, f), pre-masked
  const float* htil;            // (2T, N, f) forward residuals
  const float* stats;           // (2T, 2, f) forward batch statistics
  const int* graph_node_ptr;    // (G + 1)
  float* dh0;                   // (N, f)
  float* dmsgs;                 // (T, N, f)
  float* dw;                    // WalkLayout(f, T).total
  float* scratch;
  int n_nodes, n_graphs, f, od, steps, msg_mode, state_mode;
};

// staged floats per node (odd): [mb | hprev | da_r | da_z | da_n | dnh]
constexpr int kStage = 6 * FP + 1;

__host__ __device__ inline size_t walk_smem_floats(int steps) {
  return size_t(PL::after_stats(steps)) + kWarps * 4 * FP + 4 * FP +
         2 * FP + size_t(steps) * 2 * FP + size_t(kChunk) * kStage;
}

__host__ __device__ inline long long walk_scratch_floats(int n_nodes, int f,
                                                         int steps,
                                                         int grid) {
  const long long nchunks = (n_nodes + kChunk - 1) / kChunk;
  return (long long)n_nodes * f + (2LL + steps) * nchunks * 2 * FP +
         (long long)grid * WalkLayout(f, steps).total;
}

__global__ void __launch_bounds__(kThreads)
ps_walk_bwd_kernel(WalkArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float sm[];
  const int f = a.f, od = a.od, T = a.steps;
  const int mmode = a.msg_mode, smode = a.state_mode;
  const bool msg_bn = mmode == kBatchBn, state_bn = smode == kBatchBn;
  const bool state_stats = has_stats(smode);
  stage_ps_weights(sm, a.w, f, od, T);
  float* st = sm + PL::stats(T);                       // 2T·3·FP
  float* red = sm + PL::after_stats(T);                // kWarps·4·FP
  float* sums = red + kWarps * 4 * FP;                 // 4·FP
  float* cs = sums + 4 * FP;                           // state S1, S2
  float* msum = cs + 2 * FP;                           // T × msg S1, S2
  float* xs = msum + T * 2 * FP;                       // kChunk·kStage

  const int tid = threadIdx.x;
  const int N = a.n_nodes;
  const WalkLayout gl(f, T);
  const int NW = gl.total;
  const int n_real = a.graph_node_ptr[a.n_graphs];
  const float c = float(n_real);
  const int nchunks = (n_real + kChunk - 1) / kChunk;
  const size_t slot_sz = size_t(N) * f;
  float* ghs = a.scratch;                              // (N, f)
  float* cpart = ghs + slot_sz;                        // 2·nchunks·2FP
  float* mpart = cpart + 2 * size_t(nchunks) * 2 * FP;  // T·nchunks·2FP
  float* wpart = mpart + size_t(T) * nchunks * 2 * FP;  // grid·NW
  float* wrow = wpart + size_t(blockIdx.x) * NW;
  float* dms = a.dmsgs;                                // ∂mb_t, then dm_t

  // ---- set-up: every slot's norm constants, zeroed partials, padding ----
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
    // padded node slots: zero dh0 and dm_t
    const size_t pad = size_t(N - n_real) * f;
    for (size_t i = size_t(blockIdx.x) * kThreads + tid; i < pad * (T + 1);
         i += size_t(gridDim.x) * kThreads) {
      const size_t s = i / pad, r = i % pad;
      float* base = s == 0 ? a.dh0 : dms + (s - 1) * slot_sz;
      base[size_t(n_real) * f + r] = 0.f;
    }
  }
  __syncthreads();

  // ---- step T−1's state-norm sums from gh --------------------------------
  if (state_stats) {
    const float* stT = st + (2 * T - 1) * 3 * FP;
    const float* ws = sm + opaque_zero() + PL::step(T - 1);
    float* cpart_t = cpart + size_t((T - 1) & 1) * nchunks * 2 * FP;
    for (int ch = blockIdx.x; ch < nchunks; ch += gridDim.x) {
      const int n = ch * kChunk + tid;
      float v[4][FP];
MPNN_UNROLL
      for (int q = 0; q < 4; ++q)
MPNN_UNROLL
        for (int j = 0; j < FP; ++j) v[q][j] = 0.f;
      if (n < n_real) {
        float g[FP], x[FP], xh[FP];
        load_row(a.gh, n, f, g);
        load_row(a.htil + size_t(2 * T - 1) * slot_sz, n, f, x);
MPNN_UNROLL
        for (int j = 0; j < FP; ++j) {
          xh[j] = (x[j] - stT[j]) / stT[2 * FP + j];
          v[0][j] = state_bn ? g[j] * ws[PL::oBnW + j] : g[j];   // dx̂
          v[1][j] = v[0][j] * xh[j];
          v[2][j] = g[j] * xh[j];                  // ∂bn_{T−1}.weight
          v[3][j] = g[j];                          // ∂bn_{T−1}.bias
        }
      }
      block_feature_sums<4>(v, red, sums);
      if (tid < 2 * FP) cpart_t[size_t(ch) * 2 * FP + tid] = sums[tid];
      if (state_bn) {
        add_owned(wrow, gl.bnw + (T - 1) * f, f, sums + 2 * FP);
        add_owned(wrow, gl.bnb + (T - 1) * f, f, sums + 3 * FP);
      }
      __syncthreads();
    }
    grid.sync();
    chunk_totals<2>(cpart_t, 2 * FP, nchunks, red, cs);
  }

  // ---- the reverse walk, t = T−1..0 --------------------------------------
  for (int t = T - 1; t >= 0; --t) {
    const bool next_stats = t > 0 && state_stats;
    const float* ghin = t == T - 1 ? a.gh : ghs;
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
        load_row(ghin, n, f, gh);
        walk_node(w, st, cs, a.htil, a.h0, slot_sz, n, f, t, T, mmode,
                  smode, c, gh, row, ghn, dmb, xhm, xhp);
        store_row(dms + size_t(t) * slot_sz, n, f, dmb);
        store_row(t > 0 ? ghs : a.dh0, n, f, ghn);
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

  // ---- the message-norm VJP of every step, per node ----------------------
  if (msg_bn) {
    for (int t = 0; t < T; ++t)
      chunk_totals<2>(mpart + size_t(t) * nchunks * 2 * FP, 2 * FP, nchunks,
                      red, msum + t * 2 * FP);
    for (int ch = blockIdx.x; ch < nchunks; ch += gridDim.x) {
      const int n = ch * kChunk + tid;
      if (n >= n_real) continue;
      for (int t = 0; t < T; ++t) {
        const float* stm = st + t * 3 * FP;
        const float* wst = sm + opaque_zero() + PL::step(t);
        float dm[FP], m0[FP], xh[FP], dxh[FP];
        load_row(dms + size_t(t) * slot_sz, n, f, dm);
        load_row(a.htil + size_t(t) * slot_sz, n, f, m0);
MPNN_UNROLL
        for (int j = 0; j < FP; ++j) {
          xh[j] = (m0[j] - stm[j]) / stm[2 * FP + j];
          dxh[j] = dm[j] * wst[PL::oMaW + j];
        }
        norm_vjp(dxh, xh, stm, msum + t * 2 * FP, c, dm);
        store_row(dms + size_t(t) * slot_sz, n, f, dm);
      }
    }
  }

  // ---- reduce the block rows in block order -------------------------------
  grid.sync();
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

int mpnn_ps_walk_bwd_smem_bytes(int steps) {
  return int(sizeof(float) * walk_smem_floats(steps));
}

// The 9 offsets of the flat gradient layout (WalkLayout), the total last.
void mpnn_ps_walk_bwd_layout(int f, int steps, int* out) {
  const WalkLayout g(f, steps);
  const int v[9] = {g.wih, g.whh, g.bih, g.bhh, g.maw, g.mab, g.bnw, g.bnb,
                    g.total};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
}

long long mpnn_ps_walk_bwd_scratch_floats(int n_nodes, int f, int steps,
                                          int grid) {
  return walk_scratch_floats(n_nodes, f, steps, grid);
}

int mpnn_ps_walk_bwd_grid(int steps, int n_nodes) {
  return coop_grid(ps_walk_bwd_kernel,
                   sizeof(float) * walk_smem_floats(steps),
                   (n_nodes + kChunk - 1) / kChunk);
}

int mpnn_ps_walk_bwd(
    const float* amat, const float* a0, const float* mbias,
    const float* w_ih, const float* w_hh, const float* b_ih,
    const float* b_hh, const float* ma_w, const float* ma_b,
    const float* bn_w, const float* bn_b, const float* ro_iw,
    const float* ro_ib, const float* ro_jw, const float* ro_jb,
    const float* gh, const float* h0, const float* htil, const float* stats,
    const int* graph_node_ptr, float* dh0, float* dmsgs, float* dw,
    float* scratch, int n_nodes, int n_graphs, int f, int od, int steps,
    int msg_mode, int state_mode, int grid, void* stream) {
  if (f < 1 || f > FP || steps < 1 || steps > kMaxSteps || grid < 1 ||
      n_graphs < 1 || (msg_mode != kNone && msg_mode != kBatchBn) ||
      (state_mode != kNone && state_mode != kBatchBn &&
       state_mode != kStateless))
    return int(cudaErrorInvalidValue);
  WalkArgs a{{amat, a0, mbias, w_ih, w_hh, b_ih, b_hh, ma_w, ma_b, bn_w,
              bn_b, ro_iw, ro_ib, ro_jw, ro_jb},
             gh, h0, htil, stats, graph_node_ptr, dh0, dmsgs, dw, scratch,
             n_nodes, n_graphs, f, od, steps, msg_mode, state_mode};
  return coop_launch(ps_walk_bwd_kernel, a,
                     sizeof(float) * walk_smem_floats(steps), grid, stream);
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
