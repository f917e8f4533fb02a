// Message VJP of the split training backward, for T >= 1 stacked message
// networks, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels mpnn_tpu/kernels/fused_step.py::_msg_bwd_kernel
// (the shared family's split backward, T = 1) and mpnn_tpu/kernels/
// fused_psteps.py::_ps_a0_bwd_kernel and _ps_edge_bwd_kernel (the per-step
// family's, T networks). The forward's messages of network t, masked:
//
//   m_t,d = (Σ_{e: dst_e = d} A_t[vid_e]·h0_src_e + A0_t·S_g(d) + b_t)·m_d
//
// with S_g = Σ_{v ∈ g} h0_v. Given their cotangents dm_t (T, N, f), with
// dm'_t = dm_t·m (the mask; padded rows, the dummy node's among them, give
// nothing whatever dm holds there):
//
//   D_t,g  = Σ_{v ∈ g} dm'_t,v
//   dh0_v  = Σ_t A0_tᵀ·D_t,g(v) + Σ_t Σ_{e: src_e = v} A_t[vid_e]ᵀ·dm'_t,dst_e
//   dA_t[k] = Σ_{e: vid_e = k} dm'_t,dst_e ⊗ h0_src_e
//   dA0_t  = Σ_g D_t,g ⊗ S_g,   db_t = Σ_g D_t,g
//
// Bound on an H100 SXM: per edge and network 2f² flop for dh0 and 2f² for
// dA over the bytes of dm (T·N·f), h0 and the index arrays: at lipo's
// b3584 (57.8k slots, ~120k edges, f 10, T 1) ~1 us by bytes and ~0.1 us
// of f32 arithmetic; the four dependent launches and the per-item sums
// set the time.
//
// Design: four launches on the stream, no grid barrier. (1) per graph, one
// warp: S_g and D_t,g (lanes over the graph's nodes, xor butterflies).
// (2) per node, one thread: dh0 from A0ᵀ·D and the node's outgoing edges
// in the device-built source order (an edge into a padded node, which
// the padded edges all are, adds exactly zero and is passed over). (3) the
// work items, block-strided on 8 blocks an SM: dA's vocab-sorted edge
// chunks (spmm_common.cuh, shared with spmm_da.cu) and dA0's graph
// chunks, each an FP·FP row of partials. (4) each output element sums its
// items' rows in chunk order. No float atomics: the result depends on the
// data only.

#include "spmm_common.cuh"
#include "unroll.cuh"

namespace {

using namespace mpnn_spmm;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = kThreads / 32;
constexpr int kGraphChunk = kChunkEdges;   // graphs per dA0 work item
constexpr int kRow0 = FP * FP + FP;        // a dA0 item's row: dA0 | db

struct MsgArgs {
  const float* amat;          // (T, K, f, f): m = amat[t][k] @ h0[src]
  const float* a0;            // (T, f, f)
  const float* h0;            // (N, f)
  const float* mask;          // (N, 1), 0/1
  const float* dmsgs;         // (T, N, f) cotangents of the masked messages
  const int* vid;             // (E)
  const int* src;             // (E)
  const int* dst;             // (E)
  const int* src_order;       // (E) edge ids, stably sorted by source
  const int* src_ptr;         // (N + 1) row pointers into src_order
  const int* vorder;          // (E) edge ids, stably sorted by vocab id
  const int* vptr;            // (K + 1) id pointers into vorder
  const int* graph_node_ptr;  // (G + 1) node range of each graph
  const int* node_graph;      // (N), G at padded nodes
  float* dh0;                 // (N, f)
  float* dw;                  // MsgLayout(T, K, f).total
  float* sg;                  // (G, FP) S_g
  float* dg;                  // (T, G, FP) D_t,g
  float* part_a;              // (T · da_items, FP·FP) dA item rows
  float* part_0;              // (T · graph chunks, kRow0) dA0 item rows
  int n_nodes, n_edges, n_graphs, f, k_vocab, steps;
};

// Flat layout of the gradient output: kernels/msg_bwd.py::grad_layout
// mirrors it and checks it against mpnn_msg_bwd_layout.
struct MsgLayout {
  int a, a0, mbias, total;
  __host__ __device__ MsgLayout(int T, int k, int f) {
    a = 0;
    a0 = a + T * k * f * f;
    mbias = a0 + T * f * f;
    total = mbias + T * f;
  }
};

__host__ __device__ inline int graph_chunks(int n_graphs) {
  return (n_graphs + kGraphChunk - 1) / kGraphChunk;
}

__device__ __forceinline__ float warp_sum(float v) {
MPNN_UNROLL
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// (1) S_g and D_t,g, one warp per graph.
__global__ void __launch_bounds__(kThreads) graph_sums_kernel(MsgArgs a) {
  const int lane = threadIdx.x % 32;
  const int g = blockIdx.x * kWarps + threadIdx.x / 32;
  if (g >= a.n_graphs) return;
  const int f = a.f, n0 = a.graph_node_ptr[g], n1 = a.graph_node_ptr[g + 1];
  float s[FP];
MPNN_UNROLL
  for (int j = 0; j < FP; ++j) s[j] = 0.f;
  for (int n = n0 + lane; n < n1; n += 32)
MPNN_UNROLL
    for (int j = 0; j < FP; ++j)
      if (j < f) s[j] += __ldg(a.h0 + size_t(n) * f + j);
MPNN_UNROLL
  for (int j = 0; j < FP; ++j) {
    s[j] = warp_sum(s[j]);
    if (lane == j) a.sg[size_t(g) * FP + j] = s[j];
  }
  for (int t = 0; t < a.steps; ++t) {
    const float* dm = a.dmsgs + size_t(t) * a.n_nodes * f;
MPNN_UNROLL
    for (int j = 0; j < FP; ++j) s[j] = 0.f;
    for (int n = n0 + lane; n < n1; n += 32) {
      const float m = __ldg(a.mask + n);
MPNN_UNROLL
      for (int j = 0; j < FP; ++j)
        if (j < f) s[j] += m * __ldg(dm + size_t(n) * f + j);
    }
MPNN_UNROLL
    for (int j = 0; j < FP; ++j) {
      s[j] = warp_sum(s[j]);
      if (lane == j) a.dg[(size_t(t) * a.n_graphs + g) * FP + j] = s[j];
    }
  }
}

// (2) dh0 per node: the A0 term, then the node's outgoing edges.
__global__ void __launch_bounds__(kThreads) node_kernel(MsgArgs a) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= a.n_nodes) return;
  const int f = a.f, K = a.k_vocab, T = a.steps, G = a.n_graphs;
  float acc[FP];
MPNN_UNROLL
  for (int j = 0; j < FP; ++j) acc[j] = 0.f;
  const int g = a.node_graph[n];
  if (g < G) {
    for (int t = 0; t < T; ++t) {
      const float* a0t = a.a0 + size_t(t) * f * f;
      const float* d = a.dg + (size_t(t) * G + g) * FP;
      for (int m = 0; m < f; ++m) {
        const float dv = d[m];
MPNN_UNROLL
        for (int j = 0; j < FP; ++j)
          if (j < f) acc[j] = fmaf(__ldg(a0t + m * f + j), dv, acc[j]);
      }
    }
  }
  const int p1 = a.src_ptr[n + 1];
  for (int p = a.src_ptr[n]; p < p1; ++p) {
    const int e = a.src_order[p];
    const int dn = a.dst[e];
    const float md = __ldg(a.mask + dn);
    if (md == 0.f) continue;            // adds exactly zero
    const int k = a.vid[e];
    for (int t = 0; t < T; ++t) {
      const float* am = a.amat + (size_t(t) * K + k) * f * f;
      const float* dd = a.dmsgs + (size_t(t) * a.n_nodes + dn) * f;
      for (int m = 0; m < f; ++m) {
        const float dv = md * __ldg(dd + m);
MPNN_UNROLL
        for (int j = 0; j < FP; ++j)
          if (j < f) acc[j] = fmaf(__ldg(am + m * f + j), dv, acc[j]);
      }
    }
  }
MPNN_UNROLL
  for (int j = 0; j < FP; ++j)
    if (j < f) a.dh0[size_t(n) * f + j] = acc[j];
}

// (3) the work items, block-strided: a dA edge chunk of network t, or a
// dA0 graph chunk of network t.
__global__ void __launch_bounds__(kThreads) item_kernel(MsgArgs a) {
  extern __shared__ float sm[];
  float* gs = sm;                               // kChunkEdges · FP
  float* hs = gs + kChunkEdges * FP;            // kChunkEdges · FP
  const int f = a.f, tid = threadIdx.x;
  const int items = da_items(a.n_edges, a.k_vocab);
  const int gch = graph_chunks(a.n_graphs);
  const int total = a.steps * (items + gch);
  for (int b = blockIdx.x; b < total; b += gridDim.x) {
    if (b < a.steps * items) {
      const int t = b / items;
      da_item_partial(a.dmsgs + size_t(t) * a.n_nodes * f, a.mask, a.h0,
                      a.src, a.dst, a.vorder, a.vptr, a.k_vocab, f, f,
                      b % items, gs, hs, a.part_a + size_t(b) * FP * FP);
      continue;
    }
    const int r = b - a.steps * items, t = r / gch;
    const int g0 = (r % gch) * kGraphChunk;
    const int cnt = min(kGraphChunk, a.n_graphs - g0);
    __syncthreads();                            // staging free
    for (int i = tid; i < kGraphChunk * FP; i += kThreads) {
      const int row = i / FP, j = i % FP;
      const bool in = row < cnt;
      gs[i] = in ? a.dg[(size_t(t) * a.n_graphs + g0 + row) * FP + j] : 0.f;
      hs[i] = in ? a.sg[size_t(g0 + row) * FP + j] : 0.f;
    }
    __syncthreads();
    float* out = a.part_0 + size_t(r) * kRow0;
    for (int q = tid; q < kRow0; q += kThreads) {
      float s = 0.f;
      if (q < FP * FP) {
        const int m = q / FP, j = q % FP;
        for (int i = 0; i < cnt; ++i)
          s = fmaf(gs[i * FP + m], hs[i * FP + j], s);
      } else {
        for (int i = 0; i < cnt; ++i) s += gs[i * FP + q - FP * FP];
      }
      out[q] = s;
    }
  }
}

// (4) each output element (grid-strided): its items' rows summed in chunk
// order.
__global__ void __launch_bounds__(kThreads) combine_kernel(MsgArgs a) {
  const int f = a.f, K = a.k_vocab;
  const MsgLayout L(a.steps, K, f);
  const size_t items = da_items(a.n_edges, K);
  const int gch = graph_chunks(a.n_graphs);
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < L.total;
       e += gridDim.x * kThreads) {
    float s = 0.f;
    if (e < L.a0) {
      const int t = e / (K * f * f), r = e % (K * f * f);
      const int k = r / (f * f), m = (r % (f * f)) / f, j = r % f;
      s = da_item_total(a.part_a + t * items * FP * FP, a.vptr, k,
                        m * FP + j);
    } else {
      const bool bias = e >= L.mbias;
      const int i = bias ? e - L.mbias : e - L.a0;
      const int t = bias ? i / f : i / (f * f);
      const int q = bias ? FP * FP + i % f : ((i % (f * f)) / f) * FP + i % f;
      for (int c = 0; c < gch; ++c)
        s += a.part_0[(size_t(t) * gch + c) * kRow0 + q];
    }
    a.dw[e] = s;
  }
}

}  // namespace

extern "C" {

// The 4 offsets of the flat gradient layout (MsgLayout), the total last.
void mpnn_msg_bwd_layout(int steps, int k_vocab, int f, int* out) {
  const MsgLayout g(steps, k_vocab, f);
  out[0] = g.a;
  out[1] = g.a0;
  out[2] = g.mbias;
  out[3] = g.total;
}

long long mpnn_msg_bwd_scratch_floats(int steps, int k_vocab, int n_nodes,
                                      int n_edges, int n_graphs) {
  (void)n_nodes;
  return (long long)n_graphs * FP + (long long)steps * n_graphs * FP +
         (long long)steps * da_items(n_edges, k_vocab) * FP * FP +
         (long long)steps * graph_chunks(n_graphs) * kRow0;
}

// Launches the four kernels on `stream`; returns the first error code (0 =
// success). Does not synchronize and allocates nothing.
int mpnn_msg_bwd(const float* amat, const float* a0, const float* h0,
                 const float* mask, const float* dmsgs, const int* vid,
                 const int* src, const int* dst, const int* src_order,
                 const int* src_ptr, const int* vorder, const int* vptr,
                 const int* graph_node_ptr, const int* node_graph, float* dh0,
                 float* dw, float* scratch, int n_nodes, int n_edges,
                 int n_graphs, int f, int k_vocab, int steps, void* stream) {
  if (f < 1 || f > FP || k_vocab < 1 || k_vocab > kMaxVocab ||
      n_nodes < 1 || n_edges < 1 || n_graphs < 1 || steps < 1)
    return int(cudaErrorInvalidValue);
  const int items = da_items(n_edges, k_vocab);
  float* sg = scratch;
  float* dg = sg + size_t(n_graphs) * FP;
  float* part_a = dg + size_t(steps) * n_graphs * FP;
  float* part_0 = part_a + size_t(steps) * items * FP * FP;
  MsgArgs a{amat, a0, h0, mask, dmsgs, vid, src, dst, src_order, src_ptr,
            vorder, vptr, graph_node_ptr, node_graph, dh0, dw, sg, dg,
            part_a, part_0, n_nodes, n_edges, n_graphs, f, k_vocab, steps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  graph_sums_kernel<<<(n_graphs + kWarps - 1) / kWarps, kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  node_kernel<<<(n_nodes + kThreads - 1) / kThreads, kThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  // the work items on a few blocks per SM
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  const int n_items = steps * (items + graph_chunks(n_graphs));
  const size_t bytes = sizeof(float) * 2 * size_t(kChunkEdges) * FP;
  item_kernel<<<min(n_items, 8 * sms), kThreads, bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int total = MsgLayout(steps, k_vocab, f).total;
  combine_kernel<<<min((total + kThreads - 1) / kThreads, 8 * sms), kThreads,
                   0, s>>>(a);
  return int(cudaGetLastError());
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
