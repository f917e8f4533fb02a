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
// Design: ONE cooperative launch, one warp per graph, lane j on feature j
// (set2vec_common.cuh). The batch-global Σ datt·att takes one grid barrier
// per step (block partials double-buffered by step parity, combined in
// block order); the per-graph mode needs none. The serial walk keeps only
// what the next step needs — de, dq and the LSTM carry — and stashes each
// step's de, dmr and q; after the walk the graph's warp sums ∂x_v and ∂we
// over the steps from those stashes, so ∂x takes no read-modify-write per
// step. The leaf gradients accumulate over all steps in a private row per
// warp in shared memory (lane j owns column j), are summed over the warps
// in order, and after a last barrier over the blocks in block order.
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

// The launch's global scratch, in order: the cotangent carry (G, 3w), the
// per-step stashes the ∂x pass reads — de (T, N), dmr and q (T, G, w) —
// the global-softmax partials (2 · grid) and the block rows (grid · NW).
struct BwdScratch {
  float *dcarry, *de, *dmr, *q, *part, *wpart;
  long long total;
  __host__ __device__ BwdScratch(float* base, int N, int G, int W, int T,
                                 int grid) {
    const long long o_de = (long long)G * 3 * W;
    const long long o_dmr = o_de + (long long)T * N;
    const long long o_q = o_dmr + (long long)T * G * W;
    const long long o_part = o_q + (long long)T * G * W;
    const long long o_wpart = o_part + 2LL * grid;
    total = o_wpart + (long long)grid * S2vGradLayout(W).total;
    dcarry = base;
    de = base + o_de;
    dmr = base + o_dmr;
    q = base + o_q;
    part = base + o_part;
    wpart = base + o_wpart;
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
  const bool own = lane < W;
  float* __restrict__ acc = sm + SL::total + warp * NW;  // this warp's leaves
  float* buf = sm + SL::kBuf + warp * 2 * WP;      // [dmr | q] broadcast
  float* red = sm + SL::kRed;
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
    if (!own) continue;
    float* dc = sc.dcarry + size_t(g) * 3 * W;
    dc[lane] = a.gm[size_t(g) * 2 * W + lane];
    dc[W + lane] = a.gm[size_t(g) * 2 * W + W + lane];
    dc[2 * W + lane] = 0.f;
  }
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const float* att = a.att_stash + size_t(t) * N;
    float* dat = sc.de + size_t(t) * N;
    // ---- datt_v = dmr·x_v and Σ datt·att ---------------------------------
    float ploc = 0.f;
    for (int g = lo + warp; g < hi; g += kWarps) {
      const float dmr = own ? sc.dcarry[size_t(g) * 3 * W + W + lane] : 0.f;
      buf[lane] = dmr;
      if (own) sc.dmr[(size_t(t) * G + g) * W + lane] = dmr;
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
      const float mh = own ? cs[lane] : 0.f, mr = own ? cs[W + lane] : 0.f;
      const float cp = own ? cs[2 * W + lane] : 0.f;
      float act[4];
      lstm_gates<WB>(sm, mh, mr, lane, act);
      const float ct = act[1] * cp + act[0] * act[2];
      const float tc = tanhf(ct);
      const float h = act[3] * tc;
      const float q = query<WB>(sm, h, lane);
      float* dc = sc.dcarry + size_t(g) * 3 * W;
      const float dmh = own ? dc[lane] : 0.f;
      const float dcn = own ? dc[2 * W + lane] : 0.f;
      __syncwarp();                                // dat[] of the lanes
      const int n0 = a.graph_node_ptr[g], n1 = a.graph_node_ptr[g + 1];
      // dq_g = Σ_v we·de_v·(1 − th²); ∂x and ∂we wait for the pass below
      float dq = 0.f;
      if (own) {
        sc.q[(size_t(t) * G + g) * W + lane] = q;
        const float wej = sm[SL::kE + lane];
        for (int n = n0; n < n1; ++n) {
          const float th = tanhf(q + a.x[size_t(n) * W + lane]);
          dq += wej * dat[n] * (1.0f - th * th);
        }
      }
      // q = h·Wq
      float dh = dmh;
#pragma unroll 8
      for (int k = 0; k < WB; ++k) {
        const float hk = __shfl_sync(kFull, h, k);
        const float dqk = __shfl_sync(kFull, dq, k);
        if (own && k < W) acc[L.q + k * W + lane] += hk * dq;
        dh = fmaf(sm[SL::kQ + lane * WS + k], dqk, dh);
      }
      // LSTM
      const float i_ = act[0], f_ = act[1], g_ = act[2], o_ = act[3];
      const float dct = dcn + dh * o_ * (1.0f - tc * tc);
      float da[4];
      da[0] = dct * g_ * i_ * (1.0f - i_);
      da[1] = dct * cp * f_ * (1.0f - f_);
      da[2] = dct * i_ * (1.0f - g_ * g_);
      da[3] = dh * tc * o_ * (1.0f - o_);
      float dmh_p = 0.f, dmr_p = 0.f;
#pragma unroll 4
      for (int k = 0; k < WB; ++k) {
        const float xk = __shfl_sync(kFull, mh, k);
        const float yk = __shfl_sync(kFull, mr, k);
#pragma unroll
        for (int gg = 0; gg < 4; ++gg) {
          const float dak = __shfl_sync(kFull, da[gg], k);
          if (own && k < W) {
            acc[L.w[gg] + k * W + lane] += xk * da[gg];
            acc[L.w[gg] + (W + k) * W + lane] += yk * da[gg];
          }
          dmh_p = fmaf(sm[SL::kW + (gg * 2 * WP + lane) * WS + k], dak, dmh_p);
          dmr_p = fmaf(sm[SL::kW + (gg * 2 * WP + WP + lane) * WS + k], dak,
                       dmr_p);
        }
      }
      if (own) {
#pragma unroll
        for (int gg = 0; gg < 4; ++gg) acc[L.b[gg] + lane] += da[gg];
        dc[lane] = dmh_p;
        dc[W + lane] = dmr_p;
        dc[2 * W + lane] = dct * f_;
      }
      __syncwarp();
    }
  }

  // ---- ∂x and ∂we off the serial chain: each node's sum over the steps ---
  //   ∂x_v = Σ_t att_t,v·dmr_t,g + we·de_t,v·(1 − th²),  ∂we = Σ th·de
  // from the per-step stashes; a graph's rows were written by this warp.
  if (own) {
    const float wej = sm[SL::kE + lane];
    float dwe = 0.f;
    for (int g = lo + warp; g < hi; g += kWarps) {
      const float* qg = sc.q + size_t(g) * W + lane;
      const float* dmrg = sc.dmr + size_t(g) * W + lane;
      const size_t gstride = size_t(G) * W;
      for (int n = a.graph_node_ptr[g]; n < a.graph_node_ptr[g + 1]; ++n) {
        const float xv = a.x[size_t(n) * W + lane];
        float d = 0.f;
        for (int t = T - 1; t >= 0; --t) {
          const float de = sc.de[size_t(t) * N + n];
          const float th = tanhf(qg[t * gstride] + xv);
          dwe = fmaf(th, de, dwe);
          d += a.att_stash[size_t(t) * N + n] * dmrg[t * gstride] +
               wej * de * (1.0f - th * th);
        }
        a.dx[size_t(n) * W + lane] = d;
      }
    }
    acc[L.e + lane] += dwe;
  }
  __syncthreads();

  // ---- warps in order into the block row, blocks in order into dw ---------
  float* wrow = sc.wpart + size_t(blockIdx.x) * NW;
  for (int e = tid; e < NW; e += kThreads) {
    float s = 0.f;
    for (int i = 0; i < kWarps; ++i) s += sm[SL::total + i * NW + e];
    wrow[e] = s;
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
  return sizeof(float) *
         (size_t(SL::total) + size_t(kWarps) * S2vGradLayout(width).total);
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
