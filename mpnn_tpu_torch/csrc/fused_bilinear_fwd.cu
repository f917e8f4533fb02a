// Message + GRU chain forward of the bilinear family (the `ecfp_bilinear`
// model), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mpnn_tpu/kernels/fused_bilinear.py::
// _bil_fwd_kernel (the forward of make_fused_bilinear_op). Per step t =
// 1..T, per node v of graph g with its destination-sorted in-edges e (src
// u, vocab id k):
//
//   msg_t[v] = Σ_e A_k·φ_e,   φ_e[n·f + j] = h_{t-1}[u][n]·h_{t-1}[v][j]
//   h_t[v]   = GRU(msg_t[v], h0[v])          (hidden = the initial state)
//
// with h_0 = h0 (pre-masked). Writes the state history hist[v][t·f + j]
// and, for training, the messages in the same layout for the backward.
// Padded node rows are written as zeros.
//
// Design: one warp per graph, lanes over its nodes; the graph's h_{t-1}
// and h_t live in shared memory, double-buffered, beside h0 and the
// hoisted hidden-side gates W_hh·h0 + b_hh (the GRU's hidden is h0 every
// step). The TPU kernel's one-hot window matmuls and row embeddings
// become plain gathers from shared memory. Bound on an H100: per edge and
// step ~2·f³ + f² operations on ~20 bytes of indices; at f 2 a batch of
// 1,024 molecules is tens of kB and a few MFLOP — microseconds, so the
// launch, the weight staging and the per-step __syncwarp dominate.

#include "fused_bilinear_common.cuh"

namespace {

using namespace mpnn_bil;

// per node of a warp's graph: h0, the hidden gates (3·FP), two state buffers
constexpr int kNodeFloats = 6 * FP;

struct FwdArgs {
  BilWeights w;
  const float* h0;              // (N, f), pre-masked
  const int* vid;               // (E)
  const int* src;               // (E)
  const int* edge_order;        // (E) edge ids, stably sorted by dst
  const int* dst_ptr;           // (N + 1)
  const int* graph_node_ptr;    // (G + 1)
  float* hist;                  // (N, T·f)
  float* msgs;                  // (N, T·f) or null (serving)
  int n_nodes, n_graphs, f, k_vocab, steps, max_nodes;
};

__global__ void __launch_bounds__(kThreads)
fused_bilinear_fwd_kernel(FwdArgs a) {
  extern __shared__ float sm[];
  const int f = a.f, T = a.steps, ld = T * f;
  stage_bil_weights(sm, a.w, f, a.k_vocab);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = a.n_graphs, N = a.n_nodes;
  const int n_real = a.graph_node_ptr[G];
  const int M = a.max_nodes;
  float* base = sm + WL::total(a.k_vocab) + size_t(warp) * M * kNodeFloats;
  float* s_h0 = base;                  // [M][FP]
  float* s_gh = s_h0 + M * FP;         // [M][3·FP]
  float* buf0 = s_gh + M * 3 * FP;     // [M][FP]
  float* buf1 = buf0 + M * FP;

  {  // padded rows of the outputs are zeros
    const size_t pad = size_t(N - n_real) * ld;
    for (size_t i = size_t(blockIdx.x) * kThreads + threadIdx.x; i < pad;
         i += size_t(gridDim.x) * kThreads) {
      a.hist[size_t(n_real) * ld + i] = 0.f;
      if (a.msgs) a.msgs[size_t(n_real) * ld + i] = 0.f;
    }
  }

  for (int g = blockIdx.x * kWarps + warp; g < G; g += gridDim.x * kWarps) {
    const int n0 = a.graph_node_ptr[g], nn = a.graph_node_ptr[g + 1] - n0;
    for (int i = lane; i < nn; i += 32) {
      const float* w = sm + opaque_zero();
      float h[FP], gh[3][FP];
      load_vec(a.h0 + size_t(n0 + i) * f, f, h);
      gates(w, WL::kWhh, WL::kBhh, h, gh);
#pragma unroll
      for (int j = 0; j < FP; ++j) {
        s_h0[i * FP + j] = buf0[i * FP + j] = h[j];
#pragma unroll
        for (int gg = 0; gg < 3; ++gg) s_gh[i * 3 * FP + gg * FP + j] = gh[gg][j];
      }
    }
    __syncwarp();
    float* cur = buf0;
    float* nxt = buf1;
    for (int t = 0; t < T; ++t) {
      for (int i = lane; i < nn; i += 32) {
        const int v = n0 + i;
        float hd[FP], msg[FP];
#pragma unroll
        for (int j = 0; j < FP; ++j) {
          hd[j] = cur[i * FP + j];
          msg[j] = 0.f;
        }
        const int p1 = __ldg(a.dst_ptr + v + 1);
        for (int p = __ldg(a.dst_ptr + v); p < p1; ++p) {
          const int e = __ldg(a.edge_order + p);
          const int u = __ldg(a.src + e) - n0;
          const float* am = sm + opaque_zero() + WL::kA +
                            __ldg(a.vid + e) * FP * FP2;
          float phi[FP2];
#pragma unroll
          for (int n = 0; n < FP; ++n) {
            const float hs = cur[u * FP + n];
#pragma unroll
            for (int j = 0; j < FP; ++j) phi[n * FP + j] = hs * hd[j];
          }
#pragma unroll
          for (int m = 0; m < FP; ++m) {
            float s = msg[m];
#pragma unroll
            for (int q = 0; q < FP2; ++q) s = fmaf(am[m * FP2 + q], phi[q], s);
            msg[m] = s;
          }
        }
        const float* w = sm + opaque_zero();
        float gi[3][FP], hnew[FP];
        gates(w, WL::kWih, WL::kBih, msg, gi);
#pragma unroll
        for (int j = 0; j < FP; ++j) {
          const float* gh = s_gh + i * 3 * FP;
          const float r = sigmoidf_(gi[0][j] + gh[j]);
          const float z = sigmoidf_(gi[1][j] + gh[FP + j]);
          const float n_ = tanhf(gi[2][j] + r * gh[2 * FP + j]);
          hnew[j] = (1.0f - z) * n_ + z * s_h0[i * FP + j];
          nxt[i * FP + j] = hnew[j];
        }
        store_vec(a.hist + size_t(v) * ld + t * f, f, hnew);
        if (a.msgs) store_vec(a.msgs + size_t(v) * ld + t * f, f, msg);
      }
      __syncwarp();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }
}

size_t smem_bytes(int k_vocab, int max_nodes) {
  return sizeof(float) * (size_t(WL::total(k_vocab)) +
                          size_t(kWarps) * max_nodes * kNodeFloats);
}

// All co-resident blocks, capped at one warp per graph (cached per size).
int grid_for(size_t bytes, int n_graphs) {
  static size_t cached_bytes = 0;
  static int cached_cap = 0;
  if (bytes != cached_bytes) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, fused_bilinear_fwd_kernel, kThreads, bytes) !=
            cudaSuccess)
      return 0;
    cached_bytes = bytes;
    cached_cap = per_sm * sms;
  }
  return min(cached_cap, (n_graphs + kWarps - 1) / kWarps);
}

}  // namespace

extern "C" {

int mpnn_fused_bilinear_fwd_smem_bytes(int k_vocab, int max_nodes) {
  return int(smem_bytes(k_vocab, max_nodes));
}

int mpnn_fused_bilinear_fwd(
    const float* amat, const float* w_ih, const float* w_hh,
    const float* b_ih, const float* b_hh, const float* h0, const int* vid,
    const int* src, const int* edge_order, const int* dst_ptr,
    const int* graph_node_ptr, float* hist, float* msgs, int n_nodes,
    int n_graphs, int f, int k_vocab, int steps, int max_nodes,
    void* stream) {
  if (f < 1 || f > FP || k_vocab < 1 || k_vocab > kMaxVocab ||
      n_graphs < 1 || steps < 1 || max_nodes < 1 ||
      max_nodes > kMaxGraphNodes)
    return int(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(k_vocab, max_nodes);
  cudaError_t err = cudaFuncSetAttribute(
      fused_bilinear_fwd_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  const int grid = grid_for(bytes, n_graphs);
  if (grid < 1) return int(cudaErrorInvalidConfiguration);
  FwdArgs a{{amat, w_ih, w_hh, b_ih, b_hh}, h0, vid, src, edge_order,
            dst_ptr, graph_node_ptr, hist, msgs, n_nodes, n_graphs, f,
            k_vocab, steps, max_nodes};
  fused_bilinear_fwd_kernel<<<grid, kThreads, bytes,
                              static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
