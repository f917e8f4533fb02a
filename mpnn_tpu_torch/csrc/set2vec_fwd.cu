// Set2vec readout forward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mpnn_tpu/kernels/set2vec.py::_s2v_fwd_kernel (the
// forward of make_set2vec_op). T steps (the reference's 100) of
//
//   h, c   = LSTMhidden([mh ‖ mr], c)     per graph, no input, 2w → w
//   q      = h·Wq
//   e_v    = we·tanh(q_{g(v)} + x_v)       per real node
//   att    = softmax over ALL real nodes of the batch (batch_softmax, the
//            reference's quirk) or over each graph's nodes
//   mr     = Σ_{v∈g} att_v·x_v,  mh = h    → the output m = [mh ‖ mr]
//
// Padded nodes carry −1e8 in the reference, whose exp is exactly 0: they
// are skipped. For training the launch also writes the stash the backward
// walks: each step's input carry (mh, mr, c) per graph and its attention
// row.
//
// Design: ONE cooperative launch, one warp per graph, lane l on features
// l + 32·r (set2vec_common.cuh). The per-graph softmax needs no barrier at all. The
// batch-global one takes ONE grid barrier per step: each block writes its
// partials — the max m_b of its nodes' energies and Σ exp(e − m_b) — and
// keeps its graphs' reads unnormalized, Σ exp(e_v − m_b)·x_v; after the
// barrier every block combines all partials in block order into the global
// max M and sum Z and scales its reads by exp(m_b − M)/Z. The partials
// alternate between two buffers by step parity: a block may write step
// t+1's before a slower one has read step t's. Bound on an H100: a few
// MFLOP and a few MB at batch 1,024 (the stash, ~15 MB there, dominates
// the bytes); the T barriers in series are what it costs.

#include "set2vec_common.cuh"

namespace {

using namespace mpnn_s2v;

struct FwdArgs {
  S2vWeights w;
  const float* x;               // (N, w)
  const int* graph_node_ptr;    // (G + 1)
  float* m;                     // (G, 2w)
  float* carry_stash;           // (T, G, 3w) [mh ‖ mr ‖ c] or null
  float* att_stash;             // (T, N) or null
  float* scratch;
  int n_nodes, n_graphs, width, steps, batch_softmax;
};

template <int WB>
__global__ void __launch_bounds__(kThreads)
set2vec_fwd_kernel(FwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float sm[];
  const int W = a.width, G = a.n_graphs, N = a.n_nodes;
  stage_s2v(sm, a.w, W);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  bool own[kPL];                                   // feature lane + 32·r
#pragma unroll
  for (int r = 0; r < kPL; ++r) own[r] = lane + 32 * r < W;
  float* carry = a.scratch;                        // (G, 3w)
  float* es = carry + size_t(G) * 3 * WP;          // (N) energies, then p
  float* part = es + N;                            // 2 · grid · 2
  float* buf = sm + SL::kBuf + warp * 2 * WP;
  float* red = sm + SL::kRed;
  int lo, hi;
  block_graphs(G, lo, hi);
  for (int g = lo + warp; g < hi; g += kWarps)
#pragma unroll
    for (int r = 0; r < kPL; ++r)
      if (own[r])
        for (int s = 0; s < 3; ++s)
          carry[size_t(g) * 3 * W + s * W + lane + 32 * r] = 0.f;
  __syncthreads();

  for (int t = 0; t < a.steps; ++t) {
    float mloc = -INFINITY;
    for (int g = lo + warp; g < hi; g += kWarps) {
      float* cr = carry + size_t(g) * 3 * W;
      float mh[kPL], mr[kPL], c[kPL];
#pragma unroll
      for (int r = 0; r < kPL; ++r) {
        const int j = lane + 32 * r;
        mh[r] = own[r] ? cr[j] : 0.f;
        mr[r] = own[r] ? cr[W + j] : 0.f;
        c[r] = own[r] ? cr[2 * W + j] : 0.f;
        if (a.carry_stash && own[r]) {
          float* st = a.carry_stash + (size_t(t) * G + g) * 3 * W;
          st[j] = mh[r];
          st[W + j] = mr[r];
          st[2 * W + j] = c[r];
        }
      }
      float act[kPL][4], h[kPL], q[kPL];
      lstm_gates<WB>(sm, mh, mr, lane, act);
#pragma unroll
      for (int r = 0; r < kPL; ++r) {
        c[r] = act[r][1] * c[r] + act[r][0] * act[r][2];
        h[r] = act[r][3] * tanhf(c[r]);
      }
      query<WB>(sm, h, lane, q);
#pragma unroll
      for (int r = 0; r < kPL; ++r) {
        const int j = lane + 32 * r;
        if (own[r]) {
          cr[j] = h[r];
          cr[2 * W + j] = c[r];
        }
        buf[j] = q[r];
      }
      __syncwarp();
      const int n0 = a.graph_node_ptr[g], n1 = a.graph_node_ptr[g + 1];
      float gmax = -INFINITY;
      for (int n = n0 + lane; n < n1; n += 32) {
        const float* xv = a.x + size_t(n) * W;
        float e = 0.f;
        for (int j = 0; j < W; ++j)
          e = fmaf(sm[SL::kE + j], tanhf(buf[j] + xv[j]), e);
        es[n] = e;
        gmax = fmaxf(gmax, e);
      }
      if (a.batch_softmax) {
        mloc = fmaxf(mloc, gmax);
      } else {
        gmax = warp_max_(gmax);
        float s = 0.f;
        for (int n = n0 + lane; n < n1; n += 32) {
          const float p = expf(es[n] - gmax);
          es[n] = p;
          s += p;
        }
        s = warp_sum_(s);
        for (int n = n0 + lane; n < n1; n += 32) {
          const float at = es[n] / s;
          es[n] = at;
          if (a.att_stash) a.att_stash[size_t(t) * N + n] = at;
        }
        __syncwarp();
#pragma unroll
        for (int r = 0; r < kPL; ++r)
          if (own[r]) {
            const int j = lane + 32 * r;
            float rd = 0.f;
            for (int n = n0; n < n1; ++n)
              rd = fmaf(es[n], a.x[size_t(n) * W + j], rd);
            cr[W + j] = rd;
          }
      }
      __syncwarp();
    }
    if (!a.batch_softmax) continue;

    // ---- the batch-global softmax: block partials, one grid barrier ----
    mloc = warp_max_(mloc);
    if (lane == 0) red[warp] = mloc;
    __syncthreads();
    float mb = red[0];
    for (int i = 1; i < kWarps; ++i) mb = fmaxf(mb, red[i]);
    float sloc = 0.f;
    for (int g = lo + warp; g < hi; g += kWarps) {
      const int n0 = a.graph_node_ptr[g], n1 = a.graph_node_ptr[g + 1];
      for (int n = n0 + lane; n < n1; n += 32) {
        const float p = expf(es[n] - mb);
        es[n] = p;
        sloc += p;
      }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < kPL; ++r)
        if (own[r]) {
          const int j = lane + 32 * r;
          float rd = 0.f;
          for (int n = n0; n < n1; ++n)
            rd = fmaf(es[n], a.x[size_t(n) * W + j], rd);
          carry[size_t(g) * 3 * W + W + j] = rd;   // unnormalized read
        }
      __syncwarp();
    }
    sloc = warp_sum_(sloc);
    __syncthreads();                               // red[] read above
    if (lane == 0) red[warp] = sloc;
    __syncthreads();
    float* pt = part + size_t(t & 1) * gridDim.x * 2;
    if (tid == 0) {
      float sb = 0.f;
      for (int i = 0; i < kWarps; ++i) sb += red[i];
      pt[blockIdx.x * 2] = mb;
      pt[blockIdx.x * 2 + 1] = sb;
    }
    grid.sync();
    if (warp == 0) {
      float M = -INFINITY;
      for (int i = lane; i < int(gridDim.x); i += 32)
        M = fmaxf(M, __ldcg(pt + i * 2));
      M = warp_max_(M);
      float Z = 0.f;
      for (int i = lane; i < int(gridDim.x); i += 32) {
        const float si = __ldcg(pt + i * 2 + 1);
        if (si > 0.f) Z += si * expf(__ldcg(pt + i * 2) - M);
      }
      Z = warp_sum_(Z);
      if (lane == 0)
        red[kWarps] = (Z > 0.f && mb > -INFINITY) ? expf(mb - M) / Z : 0.f;
    }
    __syncthreads();
    const float scale = red[kWarps];
    for (int g = lo + warp; g < hi; g += kWarps) {
#pragma unroll
      for (int r = 0; r < kPL; ++r)
        if (own[r]) carry[size_t(g) * 3 * W + W + lane + 32 * r] *= scale;
      if (a.att_stash) {
        const int n0 = a.graph_node_ptr[g], n1 = a.graph_node_ptr[g + 1];
        for (int n = n0 + lane; n < n1; n += 32)
          a.att_stash[size_t(t) * N + n] = es[n] * scale;
      }
    }
    __syncthreads();                               // red[kWarps] read
  }

  for (int g = lo + warp; g < hi; g += kWarps)
#pragma unroll
    for (int r = 0; r < kPL; ++r)
      if (own[r]) {
        const int j = lane + 32 * r;
        const float* cr = carry + size_t(g) * 3 * W;
        a.m[size_t(g) * 2 * W + j] = cr[j];
        a.m[size_t(g) * 2 * W + W + j] = cr[W + j];
      }
}

size_t smem_bytes() { return sizeof(float) * SL::total; }

const void* kernel_for(int width) {
  return kernel_for_width(width, set2vec_fwd_kernel<16>,
                          set2vec_fwd_kernel<WP>);
}

}  // namespace

extern "C" {

int mpnn_set2vec_fwd_smem_bytes(int width) {
  (void)width;
  return int(smem_bytes());
}

long long mpnn_set2vec_fwd_scratch_floats(int n_nodes, int n_graphs,
                                          int grid) {
  return (long long)n_graphs * 3 * WP + n_nodes + 4LL * grid;
}

int mpnn_set2vec_fwd_grid(int n_graphs, int width) {
  return coop_grid(kernel_for(width), smem_bytes(), n_graphs);
}

int mpnn_set2vec_fwd(
    const float* w_hi, const float* w_hf, const float* w_hg,
    const float* w_ho, const float* b_hi, const float* b_hf,
    const float* b_hg, const float* b_ho, const float* wq, const float* we,
    const float* x, const int* graph_node_ptr, float* m, float* carry_stash,
    float* att_stash, float* scratch, int n_nodes, int n_graphs, int width,
    int steps, int batch_softmax, int grid, void* stream) {
  if (width < 1 || width > WP || steps < 1 || n_graphs < 1 || grid < 1)
    return int(cudaErrorInvalidValue);
  FwdArgs a{{{w_hi, w_hf, w_hg, w_ho}, {b_hi, b_hf, b_hg, b_ho}, wq, we},
            x, graph_node_ptr, m, carry_stash, att_stash, scratch,
            n_nodes, n_graphs, width, steps, batch_softmax};
  const size_t bytes = smem_bytes();
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
