// Set2vec readout backward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mpnn_tpu/kernels/set2vec.py::_s2v_bwd_kernel (the
// VJP of make_set2vec_op). Given gm = ∂L/∂m and the forward's stash (each
// step's input carry and attention row), it walks the steps in reverse,
// with the cotangent carry (dmh, dmr, dc) per graph, starting at
// (gm[:, :w], gm[:, w:], 0):
//
//   read VJP      ∂x_v += att_v·dmr_g;  datt_v = dmr_g·x_v
//   softmax VJP   de_v = att_v·(datt_v − Σ datt·att), the sum over the
//                 whole batch (batch_softmax) or over v's graph
//   energy VJP    th = tanh(q_g + x_v):  ∂we += Σ th·de;
//                 dth = we·de·(1 − th²);  ∂x_v += dth;  dq_g = Σ_v dth
//   query VJP     ∂Wq += h ⊗ dq;  dh = dmh + Wq·dq
//   LSTM VJP      the step recomputed from the stashed carry; ∂W_x, ∂b_x,
//                 and the carry's cotangent (dmh, dmr, dc) for step t − 1
//
// Design: ONE cooperative launch, one warp per graph, lane l on features
// l + 32·r (set2vec_common.cuh). The batch-global Σ datt·att takes one grid barrier
// per step (block partials double-buffered by step parity, combined in
// block order); the per-graph mode needs none. The serial walk keeps only
// what the next step needs — de, dq and the LSTM carry — and stashes each
// step's de, dmr and q; after the walk the graph's warp sums ∂x_v and ∂we
// over the steps from those stashes, so ∂x takes no read-modify-write per
// step. In the narrow bucket the leaf gradients accumulate over all steps
// in a private row per warp in shared memory (lane l owns the columns of
// its features) and are summed over the warps in order; the wide bucket
// sums them after the walk (leaf_grads_from_stash). Then, after a last
// barrier, over the blocks in block order.
// Bound on an H100: ~3× the forward's operations and the stash read once
// (~22 MB at batch 1,024); the T + 1 barriers in series are what it
// costs.

#include "set2vec_common.cuh"

namespace {

using namespace mpnn_s2v;

// Flat layout of the gradient output, of each warp's accumulator row and
// of each block's partial row: real shapes, in this order.
// kernels/set2vec.py::grad_layout mirrors it.
struct S2vGradLayout {
  int w[4], b[4], q, e, total;
  __host__ __device__ explicit S2vGradLayout(int W) {
    for (int g = 0; g < 4; ++g) w[g] = g * 2 * W * W;
    for (int g = 0; g < 4; ++g) b[g] = 8 * W * W + g * W;
    q = 8 * W * W + 4 * W;
    e = q + W * W;
    total = e + W;
  }
};

// The leaf gradients: in the narrow bucket each warp accumulates them in a
// private row of shared memory as the walk goes (lane l owns the columns of
// its features). In the wide bucket (w <= 64) four such rows would take
// 595 KB, so the walk stashes what they are made of instead — each step's
// LSTM cotangents da (4w), h and dq per graph; the input carry [mh ‖ mr]
// is the forward's stash — and after a grid barrier every block sums the
// outer products over its slice of the (step, graph) rows, 32 rows at a
// time staged in shared memory, into a block row of shared memory.
constexpr bool kAccInSmem = WP == 32;
constexpr int kPostRows = 32;          // (step, graph) rows per staged chunk

// The launch's global scratch, in order: the cotangent carry (G, 3w), the
// per-step stashes the ∂x pass reads — de (T, N), dmr and q (T, G, w) —
// the global-softmax partials (2 · grid) and the block rows (grid · NW);
// in the wide bucket also the leaf-gradient stashes da (T, G, 4w), h and
// dq (T, G, w) and each warp's ∂we row (grid · kWarps · w).
struct BwdScratch {
  float *dcarry, *de, *dmr, *q, *part, *wpart, *da, *h, *dq, *dwe;
  long long total;
  __host__ __device__ BwdScratch(float* base, int N, int G, int W, int T,
                                 int grid) {
    const long long tg = (long long)T * G;
    const long long o_de = (long long)G * 3 * W;
    const long long o_dmr = o_de + (long long)T * N;
    const long long o_q = o_dmr + tg * W;
    const long long o_part = o_q + tg * W;
    const long long o_wpart = o_part + 2LL * grid;
    const long long o_da = o_wpart + (long long)grid * S2vGradLayout(W).total;
    const long long o_h = o_da + (kAccInSmem ? 0 : tg * 4 * W);
    const long long o_dq = o_h + (kAccInSmem ? 0 : tg * W);
    const long long o_dwe = o_dq + (kAccInSmem ? 0 : tg * W);
    total = o_dwe + (kAccInSmem ? 0 : (long long)grid * kWarps * W);
    dcarry = base;
    de = base + o_de;
    dmr = base + o_dmr;
    q = base + o_q;
    part = base + o_part;
    wpart = base + o_wpart;
    da = base + o_da;
    h = base + o_h;
    dq = base + o_dq;
    dwe = base + o_dwe;
  }
};

struct BwdArgs {
  S2vWeights w;
  const float* x;               // (N, w)
  const int* graph_node_ptr;    // (G + 1)
  const float* carry_stash;     // (T, G, 3w)
  const float* att_stash;       // (T, N)
  const float* gm;              // (G, 2w)
  float* dx;                    // (N, w)
  float* dw;                    // S2vGradLayout(w).total
  float* scratch;
  int n_nodes, n_graphs, width, steps, batch_softmax;
};

// Wide bucket: this block's sums of the leaf gradients but ∂we over its
// slice of the T·G (step, graph) rows, into acc (NW floats of shared
// memory; ∂we's W left untouched), from the stashes. Every thread of the
// block must call it.
__device__ void leaf_grads_from_stash(const BwdArgs& a, const BwdScratch& sc,
                                      const S2vGradLayout& L, float* acc,
                                      float* rows) {
  const int W = a.width, R = a.steps * a.n_graphs, tid = threadIdx.x;
  const int RW = 8 * W;                  // a row: [mh | mr | da (4w) | h | dq]
  const int r0 = int((long long)blockIdx.x * R / gridDim.x);
  const int r1 = int((long long)(blockIdx.x + 1) * R / gridDim.x);
  for (int e = tid; e < L.e; e += kThreads) acc[e] = 0.f;
  for (int c0 = r0; c0 < r1; c0 += kPostRows) {
    const int nr = min(kPostRows, r1 - c0);
    __syncthreads();                     // the previous chunk is consumed
    for (int i = tid; i < nr * RW; i += kThreads) {
      const size_t rr = size_t(c0 + i / RW);
      const int col = i % RW;
      float v;
      if (col < 2 * W) v = a.carry_stash[rr * 3 * W + col];
      else if (col < 6 * W) v = __ldcg(sc.da + rr * 4 * W + col - 2 * W);
      else if (col < 7 * W) v = __ldcg(sc.h + rr * W + col - 6 * W);
      else v = __ldcg(sc.dq + rr * W + col - 7 * W);
      rows[i] = v;
    }
    __syncthreads();
    for (int e = tid; e < L.e; e += kThreads) {
      int ca = -1, cb;                   // columns of the two factors
      if (e < L.b[0]) {                  // W_g[k][j] += x[k]·da_g[j]
        const int gg = e / (2 * W * W), i = e % (2 * W * W);
        ca = i / W;
        cb = 2 * W + gg * W + i % W;
      } else if (e < L.q) {              // b_g[j] += da_g[j]
        cb = 2 * W + (e - L.b[0]);
      } else {                           // Wq[k][j] += h[k]·dq[j]
        const int i = e - L.q;
        ca = 6 * W + i / W;
        cb = 7 * W + i % W;
      }
      float s = 0.f;
      if (ca >= 0)
        for (int i = 0; i < nr; ++i)
          s = fmaf(rows[i * RW + ca], rows[i * RW + cb], s);
      else
        for (int i = 0; i < nr; ++i) s += rows[i * RW + cb];
      acc[e] += s;
    }
  }
  __syncthreads();
}

template <int WB>
__global__ void __launch_bounds__(kThreads)
set2vec_bwd_kernel(BwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float sm[];
  const int W = a.width, G = a.n_graphs, N = a.n_nodes, T = a.steps;
  stage_s2v(sm, a.w, W);
  const S2vGradLayout L(W);
  const int NW = L.total;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  bool own[kPL];                                   // feature lane + 32·r
#pragma unroll
  for (int r = 0; r < kPL; ++r) own[r] = lane + 32 * r < W;
  float* __restrict__ acc = sm + SL::total + warp * NW;  // this warp's leaves
  float* buf = sm + SL::kBuf + warp * 2 * WP;      // [dmr | q] broadcast
  float* red = sm + SL::kRed;
  if (kAccInSmem)
    for (int i = tid; i < kWarps * NW; i += kThreads) sm[SL::total + i] = 0.f;
  const BwdScratch sc(a.scratch, N, G, W, T, gridDim.x);
  const int n_real = a.graph_node_ptr[G];
  {
    const size_t pad = size_t(N - n_real) * W;
    for (size_t i = size_t(blockIdx.x) * kThreads + tid; i < pad;
         i += size_t(gridDim.x) * kThreads)
      a.dx[size_t(n_real) * W + i] = 0.f;
  }
  int lo, hi;
  block_graphs(G, lo, hi);
  for (int g = lo + warp; g < hi; g += kWarps) {
    float* dc = sc.dcarry + size_t(g) * 3 * W;
#pragma unroll
    for (int r = 0; r < kPL; ++r) {
      if (!own[r]) continue;
      const int j = lane + 32 * r;
      dc[j] = a.gm[size_t(g) * 2 * W + j];
      dc[W + j] = a.gm[size_t(g) * 2 * W + W + j];
      dc[2 * W + j] = 0.f;
    }
  }
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const float* att = a.att_stash + size_t(t) * N;
    float* dat = sc.de + size_t(t) * N;
    // ---- datt_v = dmr·x_v and Σ datt·att ---------------------------------
    float ploc = 0.f;
    for (int g = lo + warp; g < hi; g += kWarps) {
#pragma unroll
      for (int r = 0; r < kPL; ++r) {
        const int j = lane + 32 * r;
        const float dmr = own[r] ? sc.dcarry[size_t(g) * 3 * W + W + j] : 0.f;
        buf[j] = dmr;
        if (own[r]) sc.dmr[(size_t(t) * G + g) * W + j] = dmr;
      }
      __syncwarp();
      const int n0 = a.graph_node_ptr[g], n1 = a.graph_node_ptr[g + 1];
      float gloc = 0.f;
      for (int n = n0 + lane; n < n1; n += 32) {
        const float* xv = a.x + size_t(n) * W;
        float d = 0.f;
        for (int j = 0; j < W; ++j) d = fmaf(buf[j], xv[j], d);
        dat[n] = d;
        gloc = fmaf(d, att[n], gloc);
      }
      if (a.batch_softmax) {
        ploc += gloc;
      } else {
        const float sg = warp_sum_(gloc);
        for (int n = n0 + lane; n < n1; n += 32)
          dat[n] = att[n] * (dat[n] - sg);
      }
      __syncwarp();
    }
    if (a.batch_softmax) {
      ploc = warp_sum_(ploc);
      if (lane == 0) red[warp] = ploc;
      __syncthreads();
      float* pt = sc.part + size_t(t & 1) * gridDim.x;
      if (tid == 0) {
        float sb = 0.f;
        for (int i = 0; i < kWarps; ++i) sb += red[i];
        pt[blockIdx.x] = sb;
      }
      grid.sync();
      if (warp == 0) {
        float s = 0.f;
        for (int i = lane; i < int(gridDim.x); i += 32) s += __ldcg(pt + i);
        s = warp_sum_(s);
        if (lane == 0) red[kWarps] = s;
      }
      __syncthreads();
      const float S = red[kWarps];
      for (int g = lo + warp; g < hi; g += kWarps) {
        const int n0 = a.graph_node_ptr[g], n1 = a.graph_node_ptr[g + 1];
        for (int n = n0 + lane; n < n1; n += 32)
          dat[n] = att[n] * (dat[n] - S);
      }
      __syncthreads();                             // red[] read
    }

    // ---- per graph: dq, then the query and LSTM VJPs ---------------------
    for (int g = lo + warp; g < hi; g += kWarps) {
      const float* cs = a.carry_stash + (size_t(t) * G + g) * 3 * W;
      float* dc = sc.dcarry + size_t(g) * 3 * W;
      const size_t tg = size_t(t) * G + g;
      float mh[kPL], mr[kPL], cp[kPL], dmh[kPL], dcn[kPL];
#pragma unroll
      for (int r = 0; r < kPL; ++r) {
        const int j = lane + 32 * r;
        mh[r] = own[r] ? cs[j] : 0.f;
        mr[r] = own[r] ? cs[W + j] : 0.f;
        cp[r] = own[r] ? cs[2 * W + j] : 0.f;
        dmh[r] = own[r] ? dc[j] : 0.f;
        dcn[r] = own[r] ? dc[2 * W + j] : 0.f;
      }
      float act[kPL][4], tc[kPL], h[kPL], q[kPL];
      lstm_gates<WB>(sm, mh, mr, lane, act);
#pragma unroll
      for (int r = 0; r < kPL; ++r) {
        tc[r] = tanhf(act[r][1] * cp[r] + act[r][0] * act[r][2]);
        h[r] = act[r][3] * tc[r];
      }
      query<WB>(sm, h, lane, q);
      __syncwarp();                                // dat[] of the lanes
      const int n0 = a.graph_node_ptr[g], n1 = a.graph_node_ptr[g + 1];
      // dq_g = Σ_v we·de_v·(1 − th²); ∂x and ∂we wait for the pass below
      float dq[kPL];
#pragma unroll
      for (int r = 0; r < kPL; ++r) {
        dq[r] = 0.f;
        if (!own[r]) continue;
        const int j = lane + 32 * r;
        sc.q[tg * W + j] = q[r];
        const float wej = sm[SL::kE + j];
        for (int n = n0; n < n1; ++n) {
          const float th = tanhf(q[r] + a.x[size_t(n) * W + j]);
          dq[r] += wej * dat[n] * (1.0f - th * th);
        }
      }
      // q = h·Wq
      float dh[kPL];
#pragma unroll
      for (int r = 0; r < kPL; ++r) dh[r] = dmh[r];
#pragma unroll
      for (int kr = 0; kr * 32 < WB; ++kr) {
#pragma unroll 8
        for (int kk = 0; kk < (WB < 32 ? WB : 32); ++kk) {
          const int k = kr * 32 + kk;
          const float hk = __shfl_sync(kFull, h[kr], kk);
          const float dqk = __shfl_sync(kFull, dq[kr], kk);
#pragma unroll
          for (int r = 0; r < kPL; ++r) {
            const int j = lane + 32 * r;
            if (kAccInSmem && own[r] && k < W)
              acc[L.q + k * W + j] += hk * dq[r];
            dh[r] = fmaf(sm[SL::kQ + j * WS + k], dqk, dh[r]);
          }
        }
      }
      // LSTM
      float da[kPL][4], dct[kPL];
#pragma unroll
      for (int r = 0; r < kPL; ++r) {
        const float i_ = act[r][0], f_ = act[r][1], g_ = act[r][2],
                    o_ = act[r][3];
        dct[r] = dcn[r] + dh[r] * o_ * (1.0f - tc[r] * tc[r]);
        da[r][0] = dct[r] * g_ * i_ * (1.0f - i_);
        da[r][1] = dct[r] * cp[r] * f_ * (1.0f - f_);
        da[r][2] = dct[r] * i_ * (1.0f - g_ * g_);
        da[r][3] = dh[r] * tc[r] * o_ * (1.0f - o_);
      }
      float dmh_p[kPL], dmr_p[kPL];
#pragma unroll
      for (int r = 0; r < kPL; ++r) dmh_p[r] = dmr_p[r] = 0.f;
#pragma unroll
      for (int kr = 0; kr * 32 < WB; ++kr) {
#pragma unroll 4
        for (int kk = 0; kk < (WB < 32 ? WB : 32); ++kk) {
          const int k = kr * 32 + kk;
          const float xk = __shfl_sync(kFull, mh[kr], kk);
          const float yk = __shfl_sync(kFull, mr[kr], kk);
#pragma unroll
          for (int gg = 0; gg < 4; ++gg) {
            const float dak = __shfl_sync(kFull, da[kr][gg], kk);
#pragma unroll
            for (int r = 0; r < kPL; ++r) {
              const int j = lane + 32 * r;
              if (kAccInSmem && own[r] && k < W) {
                acc[L.w[gg] + k * W + j] += xk * da[r][gg];
                acc[L.w[gg] + (W + k) * W + j] += yk * da[r][gg];
              }
              dmh_p[r] = fmaf(sm[SL::kW + (gg * 2 * WP + j) * WS + k], dak,
                              dmh_p[r]);
              dmr_p[r] = fmaf(sm[SL::kW + (gg * 2 * WP + WP + j) * WS + k],
                              dak, dmr_p[r]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kPL; ++r) {
        if (!own[r]) continue;
        const int j = lane + 32 * r;
        if (kAccInSmem) {
#pragma unroll
          for (int gg = 0; gg < 4; ++gg) acc[L.b[gg] + j] += da[r][gg];
        } else {
#pragma unroll
          for (int gg = 0; gg < 4; ++gg)
            sc.da[(tg * 4 + gg) * W + j] = da[r][gg];
          sc.h[tg * W + j] = h[r];
          sc.dq[tg * W + j] = dq[r];
        }
        dc[j] = dmh_p[r];
        dc[W + j] = dmr_p[r];
        dc[2 * W + j] = dct[r] * act[r][1];
      }
      __syncwarp();
    }
  }

  // ---- ∂x and ∂we off the serial chain: each node's sum over the steps ---
  //   ∂x_v = Σ_t att_t,v·dmr_t,g + we·de_t,v·(1 − th²),  ∂we = Σ th·de
  // from the per-step stashes; a graph's rows were written by this warp.
#pragma unroll
  for (int r = 0; r < kPL; ++r) {
    const int j = lane + 32 * r;
    if (!own[r]) continue;
    const float wej = sm[SL::kE + j];
    float dwe = 0.f;
    for (int g = lo + warp; g < hi; g += kWarps) {
      const float* qg = sc.q + size_t(g) * W + j;
      const float* dmrg = sc.dmr + size_t(g) * W + j;
      const size_t gstride = size_t(G) * W;
      for (int n = a.graph_node_ptr[g]; n < a.graph_node_ptr[g + 1]; ++n) {
        const float xv = a.x[size_t(n) * W + j];
        float d = 0.f;
        for (int t = T - 1; t >= 0; --t) {
          const float de = sc.de[size_t(t) * N + n];
          const float th = tanhf(qg[t * gstride] + xv);
          dwe = fmaf(th, de, dwe);
          d += a.att_stash[size_t(t) * N + n] * dmrg[t * gstride] +
               wej * de * (1.0f - th * th);
        }
        a.dx[size_t(n) * W + j] = d;
      }
    }
    if (kAccInSmem)
      acc[L.e + j] += dwe;
    else
      sc.dwe[(size_t(blockIdx.x) * kWarps + warp) * W + j] = dwe;
  }
  __syncthreads();

  // ---- warps in order into the block row, blocks in order into dw ---------
  float* wrow = sc.wpart + size_t(blockIdx.x) * NW;
  if (kAccInSmem) {
    for (int e = tid; e < NW; e += kThreads) {
      float s = 0.f;
      for (int i = 0; i < kWarps; ++i) s += sm[SL::total + i * NW + e];
      wrow[e] = s;
    }
  } else {
    grid.sync();                         // every block's stashes written
    leaf_grads_from_stash(a, sc, L, sm, sm + NW);
    for (int e = tid; e < NW; e += kThreads) {
      float s = sm[e];
      if (e >= L.e) {                    // ∂we: this block's warps in order
        s = 0.f;
        for (int i = 0; i < kWarps; ++i)
          s += __ldcg(sc.dwe + (size_t(blockIdx.x) * kWarps + i) * W +
                      e - L.e);
      }
      wrow[e] = s;
    }
  }
  grid.sync();
  for (int e = blockIdx.x * kThreads + tid; e < NW;
       e += gridDim.x * kThreads) {
    float s = 0.f;
    for (int b = 0; b < int(gridDim.x); ++b)
      s += __ldcg(sc.wpart + size_t(b) * NW + e);
    a.dw[e] = s;
  }
}

size_t smem_bytes(int width) {
  const size_t nw = S2vGradLayout(width).total;
  if (kAccInSmem)
    return sizeof(float) * (size_t(SL::total) + size_t(kWarps) * nw);
  // the walk's staged weights, or the leaf pass's block row and row chunk
  return sizeof(float) * max(size_t(SL::total),
                             nw + size_t(kPostRows) * 8 * width);
}

const void* kernel_for(int width) {
  return kernel_for_width(width, set2vec_bwd_kernel<16>,
                          set2vec_bwd_kernel<WP>);
}

}  // namespace

extern "C" {

int mpnn_set2vec_bwd_smem_bytes(int width) { return int(smem_bytes(width)); }

// The 11 offsets of the flat gradient layout (S2vGradLayout), total last.
void mpnn_set2vec_bwd_layout(int width, int* out) {
  const S2vGradLayout L(width);
  const int v[11] = {L.w[0], L.w[1], L.w[2], L.w[3], L.b[0], L.b[1],
                     L.b[2], L.b[3], L.q, L.e, L.total};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
}

long long mpnn_set2vec_bwd_scratch_floats(int n_nodes, int n_graphs,
                                          int width, int steps, int grid) {
  return BwdScratch(nullptr, n_nodes, n_graphs, width, steps, grid).total;
}

int mpnn_set2vec_bwd_grid(int n_graphs, int width) {
  return coop_grid(kernel_for(width), smem_bytes(width), n_graphs);
}

int mpnn_set2vec_bwd(
    const float* w_hi, const float* w_hf, const float* w_hg,
    const float* w_ho, const float* b_hi, const float* b_hf,
    const float* b_hg, const float* b_ho, const float* wq, const float* we,
    const float* x, const int* graph_node_ptr, const float* carry_stash,
    const float* att_stash, const float* gm, float* dx, float* dw,
    float* scratch, int n_nodes, int n_graphs, int width, int steps,
    int batch_softmax, int grid, void* stream) {
  if (width < 1 || width > WP || steps < 1 || n_graphs < 1 || grid < 1)
    return int(cudaErrorInvalidValue);
  BwdArgs a{{{w_hi, w_hf, w_hg, w_ho}, {b_hi, b_hf, b_hg, b_ho}, wq, we},
            x, graph_node_ptr, carry_stash, att_stash, gm, dx, dw, scratch,
            n_nodes, n_graphs, width, steps, batch_softmax};
  const size_t bytes = smem_bytes(width);
  const void* kernel = kernel_for(width);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid),
                                    dim3(kThreads), args, bytes,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
