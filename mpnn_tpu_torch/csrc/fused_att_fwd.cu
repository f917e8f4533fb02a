// Message + GRU forward of the collapsed attention family (the `adv`
// model), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mpnn_tpu/kernels/fused_att.py::_att_fwd_kernel
// (the forward of make_fused_att_op). Per node v of graph g, with its
// destination-sorted in-edges e (src u, vocab id k):
//
//   gate_e = softmax_feat(h0[v]·Wh + qv[k])
//   msg_v  = Σ_e A'[k]·(gate_e ⊙ h0[u])
//          + A0·(g0_v ⊙ (S_g − Σ_e h0[u]))     ('att' only: the non-edge
//            pairs, g0_v = softmax_feat(h0[v]·Wh + q0), S_g = Σ_{w∈g} h0[w])
//   h_v    = GRU(msg_v, h0[v])                 (one application: every
//                                               step of the family is the
//                                               same)
//
// and, for training, the messages the backward reads. Padded node rows
// are written as zeros.
//
// Design: one warp per graph, lanes over its nodes, no statistic crosses
// graphs — so no grid barrier and no atomics. h0·Wh is taken once per node
// (every in-edge of v shares it), the gate's vocab term and the A' tables
// come from shared memory, and the correction's Σ_e h0[u] rides the same
// edge walk. Bound on an H100: a few hundred bytes and ~2·f² operations per
// edge; at the adv widths (f 7) a batch of 1,024 molecules is a few MB and
// tens of MFLOP, microseconds of work, so the launch and the weight
// staging are what it costs.

#include "fused_att_common.cuh"

namespace {

using namespace mpnn_att;

struct FwdArgs {
  AttWeights w;
  const float* h0;              // (N, f), pre-masked
  const int* vid;               // (E)
  const int* src;               // (E)
  const int* edge_order;        // (E) edge ids, stably sorted by dst
  const int* dst_ptr;           // (N + 1)
  const int* graph_node_ptr;    // (G + 1)
  float* h;                     // (N, f)
  float* msgs;                  // (N, f) or null (serving)
  int n_nodes, n_graphs, f, k_vocab, with_corr;
};

__global__ void __launch_bounds__(kThreads)
fused_att_fwd_kernel(FwdArgs a) {
  extern __shared__ float sm[];
  const int f = a.f;
  stage_att_weights(sm, a.w, f, a.k_vocab);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = a.n_graphs, N = a.n_nodes;
  const int n_real = a.graph_node_ptr[G];
  const int ap = AL::aprime(a.k_vocab);

  {  // padded rows of the outputs are zeros
    const size_t pad = size_t(N - n_real) * f;
    for (size_t i = size_t(blockIdx.x) * kThreads + threadIdx.x; i < pad;
         i += size_t(gridDim.x) * kThreads) {
      a.h[size_t(n_real) * f + i] = 0.f;
      if (a.msgs) a.msgs[size_t(n_real) * f + i] = 0.f;
    }
  }

  for (int g = blockIdx.x * kWarps + warp; g < G; g += gridDim.x * kWarps) {
    const int n0 = a.graph_node_ptr[g], n1 = a.graph_node_ptr[g + 1];
    float S[FP];
#pragma unroll
    for (int j = 0; j < FP; ++j) S[j] = 0.f;
    if (a.with_corr) {
      for (int n = n0 + lane; n < n1; n += 32) {
        float hn[FP];
        load_row(a.h0, n, f, hn);
#pragma unroll
        for (int j = 0; j < FP; ++j) S[j] += hn[j];
      }
#pragma unroll
      for (int j = 0; j < FP; ++j) S[j] = warp_sum(S[j]);
    }
    for (int n = n0 + lane; n < n1; n += 32) {
      const float* w = sm + opaque_zero();
      float h0n[FP], zh[FP], acc[FP], xs[FP];
      load_row(a.h0, n, f, h0n);
      gate_pre(w, h0n, zh);
#pragma unroll
      for (int j = 0; j < FP; ++j) acc[j] = xs[j] = 0.f;
      const int p1 = __ldg(a.dst_ptr + n + 1);
      for (int p = __ldg(a.dst_ptr + n); p < p1; ++p) {
        const float* we = sm + opaque_zero();
        const int e = __ldg(a.edge_order + p);
        const int k = __ldg(a.vid + e);
        float hs[FP], gate[FP];
        load_row(a.h0, __ldg(a.src + e), f, hs);
        feat_softmax(zh, we + AL::kQv + k * FP, f, gate);
#pragma unroll
        for (int j = 0; j < FP; ++j) {
          xs[j] += hs[j];
          gate[j] *= hs[j];
        }
        matvec_add(we + ap + k * FP * FP, gate, acc);
      }
      if (a.with_corr) {
        float g0[FP];
        feat_softmax(zh, w + AL::kQ0, f, g0);
#pragma unroll
        for (int j = 0; j < FP; ++j) g0[j] *= S[j] - xs[j];
        matvec_add(w + AL::kA0, g0, acc);
      }
      if (a.msgs) store_row(a.msgs, n, f, acc);
      float gi[3][FP], gh[3][FP], hout[FP];
      gru_pre(w, acc, h0n, gi, gh);
#pragma unroll
      for (int j = 0; j < FP; ++j) {
        const float r = sigmoidf_(gi[0][j] + gh[0][j]);
        const float z = sigmoidf_(gi[1][j] + gh[1][j]);
        const float nn = tanhf(gi[2][j] + r * gh[2][j]);
        hout[j] = (1.0f - z) * nn + z * h0n[j];
      }
      store_row(a.h, n, f, hout);
    }
  }
}

size_t smem_bytes(int k_vocab) {
  return sizeof(float) * size_t(AL::total(k_vocab));
}

// All co-resident blocks, capped at one warp per graph (cached per size).
int grid_for(int k_vocab, int n_graphs) {
  static int cached_k = -1, cached_cap = 0;
  if (k_vocab != cached_k) {
    int dev = 0, sms = 0, per_sm = 0;
    const size_t bytes = smem_bytes(k_vocab);
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, fused_att_fwd_kernel, kThreads, bytes) != cudaSuccess)
      return 0;
    cached_k = k_vocab;
    cached_cap = per_sm * sms;
  }
  return max(1, min(cached_cap, (n_graphs + kWarps - 1) / kWarps));
}

}  // namespace

extern "C" {

int mpnn_fused_att_fwd_smem_bytes(int k_vocab) {
  return int(smem_bytes(k_vocab));
}

int mpnn_fused_att_fwd(
    const float* aprime, const float* a0, const float* qv, const float* q0,
    const float* wh, const float* w_ih, const float* w_hh, const float* b_ih,
    const float* b_hh, const float* h0, const int* vid, const int* src,
    const int* edge_order, const int* dst_ptr, const int* graph_node_ptr,
    float* h, float* msgs, int n_nodes, int n_graphs, int f, int k_vocab,
    int with_corr, void* stream) {
  if (f < 1 || f > FP || k_vocab < 1 || k_vocab > kMaxVocab || n_graphs < 1)
    return int(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(k_vocab);
  cudaError_t err = cudaFuncSetAttribute(
      fused_att_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (err != cudaSuccess) return int(err);
  const int grid = grid_for(k_vocab, n_graphs);
  if (grid < 1) return int(cudaErrorInvalidConfiguration);
  FwdArgs a{{aprime, a0, qv, q0, wh, w_ih, w_hh, b_ih, b_hh},
            h0, vid, src, edge_order, dst_ptr, graph_node_ptr, h, msgs,
            n_nodes, n_graphs, f, k_vocab, with_corr};
  fused_att_fwd_kernel<<<grid, kThreads, bytes,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
