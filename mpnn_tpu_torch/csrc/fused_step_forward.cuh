// The whole-step FORWARD body of the shared-weight edge-network MPNN,
// shared by the training forward (fused_step_fwd.cu, kTrain = true) and the
// serving kernel of the stateless state norm (fused_eval.cu, kTrain =
// false):
//
//   m_d   = Σ_{e: dst_e = d} A[vid_e]·h0[src_e] + A0·S_g + mbias   (slot 0)
//   mb    = msg_norm(m)        (bn1d on the batch statistics of slot 0, a
//                               folded affine at serving time, or m)
//   h     = h0;  T × { h̃_t = GRU(W_ihᵀ·mb + b_ih, h);  h = state_norm(h̃_t) }
//   out_g = Σ_{d ∈ g} softmax_od(W_iᵀ[h ‖ h0_d] + b_i) ⊙ (W_jᵀ[h ‖ h0_d] + b_j)
//   loss  = Σ_g Σ_o (out_go − y_g)²·gm_g / Σ_g gm_g          (training)
//
// state_norm is bn1d on the batch statistics of each step, w·(x − mean)/
// (sqrt(max(var, 1e-12)) + 1e-5) + b, the STATELESS norm on them, (x −
// mean)/sqrt(var + 1e-6) with no affine and no running state, or none.
// Training writes each slot's (mean, biased var) (the running EMAs read
// the bn1d ones) and the residual stash htil (T+1, N, f): slot 0 the
// masked messages, slot t the pre-norm state of step t — the backward
// (fused_step_bwd.cu) reads them and does not replay the forward. Serving
// keeps two slots: the messages and one state slot updated in place.
//
// Design: ONE cooperative launch (cudaLaunchCooperativeKernel, grid =
// co-resident blocks). The batch-wide statistics are the crux: a
// graph-local warp cannot finish a step alone. So the node phases run on
// node chunks (fused_train_common.cuh), each chunk writes its count-exact
// partial (Σx, Σ(x − mean_chunk)²) and, after a grid barrier, every block
// combines all chunks in chunk order (Chan's parallel-variance formula) —
// the same totals in every block, no atomics, no dependence on the grid.
// Grid barriers: messages 1, slot-0 stats 1 (training bn1d), one per step
// with a state norm on statistics (else 1), loss 1 (training). The chunk
// partials alternate between two buffers by slot parity: a block that has
// combined slot t and moved on writes slot t+1's partials while a slower
// block may still be reading slot t's; the barrier in between keeps slot
// t+2 from reusing them early.
//
// The readout runs one warp per graph. Up to ODP 64 each lane owns whole
// nodes and its od-long logits sit in registers; past it (the od-128
// build) the lanes stage 32 nodes' [h ‖ h0] rows in shared memory and the
// warp computes each node's readout with lanes over od
// (warp_readout_rows), the readout weights read from device memory.

#pragma once

#include "fused_train_common.cuh"

namespace mpnn_step {

using namespace mpnn_train;

struct FwdArgs {
  Weights w;                // ma_w/ma_b: the folded affine in kAffine mode
  const float* h0;          // (N, f), pre-masked
  const float* labels;      // (G) (training)
  const float* gmask;       // (G) (training)
  const int* vid;           // (E)
  const int* src;           // (E)
  const int* edge_order;    // (E) edge ids, stably sorted by destination
  const int* dst_ptr;       // (N + 1) row pointers into edge_order
  const int* graph_node_ptr;  // (G + 1) node range of each graph
  float* loss;              // (1) (training)
  float* out;               // (G, od)
  float* stats;             // (T + 1, 2, f): mean, biased var (training)
  float* htil;              // (T + 1, N, f) training, (2, N, f) serving
  float* scratch;           // chunk partials + per-graph loss terms
  // msg_mode in {kNone, kBatchBn (training), kAffine (serving)};
  // state_mode in {kNone, kBatchBn (training), kStateless}
  int n_nodes, n_graphs, f, od, k_vocab, steps, msg_mode, state_mode;
};

constexpr int kPartStride = 2 * FP;   // per chunk: Σx (FP), Σ(x−m_c)² (FP)
constexpr int kStage = FP + 1;        // odd stride: conflict-free staging
constexpr int kRowStride = 2 * FP + 1;  // a staged readout row [h | h0]
// the block's staging area: a chunk's values, or each warp's 32 readout
// rows in the wide-od build
constexpr int kXsFloats =
    !kRoInSmem && kWarps * 32 * kRowStride > kChunk * kStage
        ? kWarps * 32 * kRowStride
        : kChunk * kStage;

__host__ __device__ inline size_t fwd_smem_floats(int k_vocab, int steps) {
  return size_t(L::after_stats(k_vocab, steps)) + (kThreads / FP) * FP + FP +
         size_t(kXsFloats);
}

__host__ __device__ inline long long fwd_scratch_floats(int n_nodes,
                                                        int n_graphs) {
  const long long nchunks = (n_nodes + kChunk - 1) / kChunk;
  return 2 * nchunks * kPartStride + n_graphs;
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
// chunk order; sets the slot's norm constants in shared memory (the
// stateless convention with `stateless`), and block 0 writes (mean, var)
// to `stats` when it is given.
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

template <bool kTrain>
__device__ void step_forward(const FwdArgs& a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float sm[];
  const int f = a.f, od = a.od, T = a.steps;
  const int mmode = a.msg_mode, smode = a.state_mode;
  stage_weights(sm, a.w, f, od, a.k_vocab, smode != kStateless);
  float* st = sm + L::stats(a.k_vocab);                // (T+1)·3·FP
  float* red = sm + L::after_stats(a.k_vocab, T);      // 8·FP
  float* cmean = red + (kThreads / FP) * FP;           // FP
  float* xs = cmean + FP;                              // kXsFloats
  __syncthreads();

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int N = a.n_nodes, G = a.n_graphs;
  const int n_real = a.graph_node_ptr[G];
  const int nchunks = (n_real + kChunk - 1) / kChunk;
  float* part = a.scratch;                             // 2·nchunks·2·FP
  float* lossg = a.scratch + 2 * size_t(nchunks) * kPartStride;   // G
  const size_t slot_sz = size_t(N) * f;
  // slot 0 the messages; the pre-norm state of step t in its own slot in
  // training (the backward reads every step's), in slot 1 at serving time
  // (a thread reads back only the rows it wrote itself)
  auto slot = [&](int t) {
    return a.htil + size_t(kTrain || t == 0 ? t : 1) * slot_sz;
  };

  if (kTrain) {
    // padded node slots carry zero in every stash slot; the stats rows of
    // a norm without statistics are zero
    const size_t pad = size_t(N - n_real) * f;
    const size_t total = pad * (T + 1);
    for (size_t i = size_t(blockIdx.x) * kThreads + tid; i < total;
         i += size_t(gridDim.x) * kThreads) {
      const size_t s = i / pad, r = i % pad;
      a.htil[s * slot_sz + size_t(n_real) * f + r] = 0.f;
    }
    if (blockIdx.x == 0)
      for (int i = tid; i < 2 * (T + 1) * f; i += kThreads) {
        const int s = i / (2 * f);
        if (!has_stats(s == 0 ? mmode : smode)) a.stats[i] = 0.f;
      }
  }

  // ---- phase M: messages, one warp per graph -----------------------------
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
    float base[FP];
MPNN_UNROLL
    for (int m = 0; m < FP; ++m) {
      float t = 0.f;
MPNN_UNROLL
      for (int j = 0; j < FP; ++j) t = fmaf(sm[L::kA0 + m * FP + j], s[j], t);
      base[m] = t + sm[L::kMbias + m];
    }
    for (int n = n0 + lane; n < n1; n += 32) {
      const float* w = sm + opaque_zero();
      float msg[FP];
MPNN_UNROLL
      for (int m = 0; m < FP; ++m) msg[m] = 0.f;
      const int p1 = __ldg(a.dst_ptr + n + 1);
      for (int p = __ldg(a.dst_ptr + n); p < p1; ++p) {
        const int e = __ldg(a.edge_order + p);
        const int sn = __ldg(a.src + e);
        const float* am = amat_of(w, a.w, __ldg(a.vid + e));
        float hs[FP];
        load_row(a.h0, sn, f, hs);
MPNN_UNROLL
        for (int m = 0; m < FP; ++m) {
          float t = 0.f;
MPNN_UNROLL
          for (int j = 0; j < FP; ++j) t = fmaf(am[m * FP + j], hs[j], t);
          msg[m] += t;
        }
      }
MPNN_UNROLL
      for (int m = 0; m < FP; ++m) msg[m] += base[m];
      store_row(a.htil, n, f, msg);
    }
  }
  grid.sync();

  // ---- node phases: slot-0 stats, then T steps ---------------------------
  float* st0 = st;                                     // slot 0 constants
  for (int t = 0; t <= T; ++t) {
    const int mode = t == 0 ? mmode : smode;
    const bool bn = has_stats(mode);
    if (t == 0 && !bn) continue;           // slot 0 needs no stats
    float* cur = slot(t);
    float* part_t = part + size_t(t & 1) * nchunks * kPartStride;
    for (int c = blockIdx.x; c < nchunks; c += gridDim.x) {
      const int n = c * kChunk + tid;
      const int cnt = chunk_count(c, n_real);
      float x[FP];
MPNN_UNROLL
      for (int j = 0; j < FP; ++j) x[j] = 0.f;
      if (n < n_real) {
        if (t == 0) {
          load_row_cg(a.htil, n, f, x);            // written in phase M
        } else {
          const float* w = sm + opaque_zero();
          // the message input of the GRU, recomputed from slot 0
          float m0[FP], mb[FP];
          load_row_cg(a.htil, n, f, m0);
          if (mmode == kBatchBn) {
            xhat_of(st0, m0, mb);
MPNN_UNROLL
            for (int j = 0; j < FP; ++j)
              mb[j] = w[L::kMaW + j] * mb[j] + w[L::kMaB + j];
          } else if (mmode == kAffine) {
MPNN_UNROLL
            for (int j = 0; j < FP; ++j)
              mb[j] = w[L::kMaW + j] * m0[j] + w[L::kMaB + j];
          } else {
MPNN_UNROLL
            for (int j = 0; j < FP; ++j) mb[j] = m0[j];
          }
          float h[FP];
          if (t == 1) {
            load_row(a.h0, n, f, h);
          } else {
            load_row(slot(t - 1), n, f, h);
            if (has_stats(smode)) {
              // bn1d, or the stateless norm with the identity affine
              float xh[FP];
              xhat_of(st + (t - 1) * 3 * FP, h, xh);
MPNN_UNROLL
              for (int j = 0; j < FP; ++j)
                h[j] = w[L::kBnW + j] * xh[j] + w[L::kBnB + j];
            }
          }
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
              rh = fmaf(h[k], wh[j], rh);
              zh = fmaf(h[k], wh[FP + j], zh);
              nh = fmaf(h[k], wh[2 * FP + j], nh);
            }
            const float r = sigmoidf_(gr + rh);
            const float z = sigmoidf_(gz + zh);
            const float nn = tanhf(gn + r * nh);
            x[j] = (1.0f - z) * nn + z * h[j];
          }
          store_row(cur, n, f, x);
        }
      }
      if (bn) {
MPNN_UNROLL
        for (int j = 0; j < FP; ++j) xs[tid * kStage + j] = x[j];
        __syncthreads();
        chunk_moments(xs, cnt, red, cmean, part_t + size_t(c) * kPartStride);
      }
    }
    if (bn) {
      grid.sync();
      combine_slot(part_t, nchunks, n_real, f, red, cmean, st + t * 3 * FP,
                   mode == kStateless, kTrain ? a.stats : nullptr, t);
    }
  }
  if (!has_stats(smode)) grid.sync();    // every h̃_T visible to the readout

  // ---- gated readout per graph, and each graph's loss term ---------------
  const float* hT = slot(T);
  const float* stT = st + T * 3 * FP;
  // h_T after its norm, and h0, of real node n
  auto node_rows = [&](int n, float* h, float* h0n) {
    const float* w = sm + opaque_zero();
    load_row_cg(hT, n, f, h);
    if (has_stats(smode)) {
      float xh[FP];
      xhat_of(stT, h, xh);
MPNN_UNROLL
      for (int j = 0; j < FP; ++j)
        h[j] = w[L::kBnW + j] * xh[j] + w[L::kBnB + j];
    }
    load_row(a.h0, n, f, h0n);
  };
  for (int g = gw; g < G; g += nw) {
    const int n0 = a.graph_node_ptr[g], n1 = a.graph_node_ptr[g + 1];
    const float y = kTrain ? a.labels[g] : 0.f;
    const float gm = kTrain ? a.gmask[g] : 0.f;
    if constexpr (kRoInSmem) {
      float acc[ODP];
MPNN_UNROLL
      for (int o = 0; o < ODP; ++o) acc[o] = 0.f;
      for (int n = n0 + lane; n < n1; n += 32) {
        const float* w = sm + opaque_zero();
        float h[FP], h0n[FP];
        node_rows(n, h, h0n);
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
MPNN_UNROLL
        for (int o = 0; o < ODP; ++o) acc[o] += (pi[o] / den) * pj[o];
      }
MPNN_UNROLL
      for (int o = 0; o < ODP; ++o) acc[o] = warp_sum(acc[o]);
      if (lane == 0) {
        float l = 0.f;
MPNN_UNROLL
        for (int o = 0; o < ODP; ++o)
          if (o < od) {
            a.out[size_t(g) * od + o] = acc[o];
            const float d = acc[o] - y;
            l = fmaf(d * d, gm, l);
          }
        if (kTrain) lossg[g] = l;
      }
    } else {
      float acc[kOdLanes];
MPNN_UNROLL
      for (int q = 0; q < kOdLanes; ++q) acc[q] = 0.f;
      float* xr = xs + warp * 32 * kRowStride;
      for (int b = n0; b < n1; b += 32) {
        float h[FP], h0n[FP];
        if (b + lane < n1) {
          node_rows(b + lane, h, h0n);
        } else {
MPNN_UNROLL
          for (int j = 0; j < FP; ++j) h[j] = h0n[j] = 0.f;
        }
        __syncwarp();                      // the last round's rows read
MPNN_UNROLL
        for (int j = 0; j < FP; ++j) {
          xr[lane * kRowStride + j] = h[j];
          xr[lane * kRowStride + FP + j] = h0n[j];
        }
        __syncwarp();
        warp_readout_rows<kRowStride>(xr, min(32, n1 - b), ro_gate(sm, a.w),
                                      ro_value(sm, a.w), sm + L::kRib,
                                      sm + L::kRjb, od, acc);
      }
      float l = 0.f;
MPNN_UNROLL
      for (int q = 0; q < kOdLanes; ++q) {
        const int o = lane + 32 * q;
        if (o < od) {
          a.out[size_t(g) * od + o] = acc[q];
          const float d = acc[q] - y;
          l = fmaf(d * d, gm, l);
        }
      }
      l = warp_sum(l);
      if (kTrain && lane == 0) lossg[g] = l;
    }
  }
  if (!kTrain) return;
  grid.sync();

  // ---- loss = Σ_g term_g / Σ_g gm_g, in graph order, by block 0 ---------
  if (blockIdx.x == 0) {
    float num = 0.f, den = 0.f;
    for (int g = tid; g < G; g += kThreads) {
      num += __ldcg(lossg + g);
      den += a.gmask[g];
    }
    red[tid] = num;
    xs[tid] = den;
    __syncthreads();
    if (tid == 0) {
      float sn = 0.f, sd = 0.f;
      for (int i = 0; i < kThreads; ++i) {
        sn += red[i];
        sd += xs[i];
      }
      a.loss[0] = sn / sd;
    }
  }
}

// Blocks of a cooperative grid of `kernel`: all co-resident blocks, capped
// at the work's need (one warp per graph, one thread per node slot). 0 on
// error.
template <typename K>
int forward_grid(K kernel, size_t bytes, int n_nodes, int n_graphs) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(bytes)) != cudaSuccess)
    return 0;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    bytes) != cudaSuccess)
    return 0;
  const int need = max(max((n_nodes + kChunk - 1) / kChunk,
                           (n_graphs + kWarps - 1) / kWarps), 1);
  return min(per_sm * sms, need);
}

// Launch `kernel` cooperatively on `stream` with `grid` blocks; returns the
// launch's error code (0 = success). Does not synchronize.
template <typename K>
int launch_forward(K kernel, FwdArgs a, size_t bytes, int grid,
                   void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((void*)kernel, dim3(grid), dim3(kThreads),
                                    args, bytes,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace mpnn_step
