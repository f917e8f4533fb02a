// Vocab-indexed SpMM table gradient, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels mpnn_tpu/kernels/spmm.py::_da_kernel_vmem and
// _da_kernel_hbm (the dA half of make_spmm_op's VJP):
//
//   dA[k] = Σ_{e: vid_e = k} g[dst_e] ⊗ h[src_e]                 (K, mf, nf)
//
// The TPU kernels accumulate one-hot outer-product matmuls into a
// VMEM-resident dA across their sequential grid. Here the edges come in a
// stable vocab-sorted order (built on the device, kernels/spmm.py), cut
// into chunks of kChunkEdges: a work item is one (vocab id k, chunk c)
// pair whose edges are all k's. Item (k, c) has the index b = k + c — for
// each k the chunks it touches are consecutive and start no earlier than
// where the previous id's ended, so b is unique and b < K + chunks.
//
// Design: ONE cooperative launch. Phase 1: each block takes items b (block
// strided), stages its edges' g[dst] and h[src] rows in shared memory, and
// each thread sums the FP×FP outer-product entries it owns over the
// chunk's edges in order into the item's row of partials. A grid barrier.
// Phase 2: each entry of dA is the sum of its id's items in chunk order.
// No float atomics; the result depends on the data only, not on the grid.
//
// Bound on an H100 SXM: 2·E·mf·nf flop and the bytes of g, h, the edge
// arrays and dA: ~0.2 us by bytes at lipo's b1024 (f 10). The stage-and-
// sum of ≤ 128 edges per item and the grid barrier set the time.

#include "spmm_common.cuh"

namespace {

using namespace mpnn_spmm;

struct DaArgs {
  const float* g;       // (N, mf) cotangent of out
  const float* h;       // (N, nf)
  const int* src;       // (E)
  const int* dst;       // (E)
  const int* vorder;    // (E) edge ids, stably sorted by vocab id
  const int* vptr;      // (K + 1) id pointers into vorder
  float* da;            // (K, mf, nf)
  float* part;          // (K + chunks, FP·FP) partials of the items
  int n_edges, mf, nf, k_vocab;
};

__device__ __forceinline__ int n_chunks(int n_edges) {
  return (n_edges + kChunkEdges - 1) / kChunkEdges;
}

// The vocab id of item b: the largest k with k + vptr[k]/kChunkEdges <= b
// (that start is strictly increasing in k).
__device__ int item_id(const int* vptr, int k_vocab, int b) {
  int lo = 0, hi = k_vocab - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (mid + vptr[mid] / kChunkEdges <= b) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads) spmm_da_kernel(DaArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float sm[];
  float* gs = sm;                                   // kChunkEdges · FP
  float* hs = gs + kChunkEdges * FP;                // kChunkEdges · FP
  const int tid = threadIdx.x;
  const int items = a.k_vocab + n_chunks(a.n_edges);

  // ---- phase 1: one row of FP·FP partials per work item ------------------
  for (int b = blockIdx.x; b < items; b += gridDim.x) {
    const int k = item_id(a.vptr, a.k_vocab, b);
    const int c = b - k;
    const int lo = max(a.vptr[k], c * kChunkEdges);
    const int hi = min(a.vptr[k + 1], (c + 1) * kChunkEdges);
    if (lo >= hi) continue;                         // no item at b
    const int cnt = hi - lo;
    __syncthreads();                                // staging free
    for (int i = tid; i < kChunkEdges * FP; i += kThreads) {
      const int r = i / FP, j = i % FP;
      float gv = 0.f, hv = 0.f;
      if (r < cnt) {
        const int e = a.vorder[lo + r];
        if (j < a.mf) gv = __ldg(a.g + size_t(a.dst[e]) * a.mf + j);
        if (j < a.nf) hv = __ldg(a.h + size_t(a.src[e]) * a.nf + j);
      }
      gs[i] = gv;
      hs[i] = hv;
    }
    __syncthreads();
    for (int q = tid; q < FP * FP; q += kThreads) {
      const int m = q / FP, j = q % FP;
      float s = 0.f;
      for (int r = 0; r < cnt; ++r)
        s = fmaf(gs[r * FP + m], hs[r * FP + j], s);
      a.part[size_t(b) * FP * FP + q] = s;
    }
  }
  grid.sync();

  // ---- phase 2: dA[k][m][j] = Σ of id k's items, in chunk order ----------
  const int total = a.k_vocab * a.mf * a.nf;
  for (int i = blockIdx.x * kThreads + tid; i < total;
       i += gridDim.x * kThreads) {
    const int k = i / (a.mf * a.nf), r = i % (a.mf * a.nf);
    const int q = (r / a.nf) * FP + r % a.nf;
    const int e0 = a.vptr[k], e1 = a.vptr[k + 1];
    float s = 0.f;
    if (e1 > e0)
      for (int c = e0 / kChunkEdges; c <= (e1 - 1) / kChunkEdges; ++c)
        s += __ldcg(a.part + size_t(k + c) * FP * FP + q);
    a.da[i] = s;
  }
}

size_t smem_bytes() { return sizeof(float) * 2 * size_t(kChunkEdges) * FP; }

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes.
int mpnn_spmm_da_smem_bytes() { return int(smem_bytes()); }

// Floats of scratch (the items' partials) a launch over n_edges needs.
long long mpnn_spmm_da_scratch_floats(int n_edges, int k_vocab) {
  const long long items =
      k_vocab + (n_edges + kChunkEdges - 1) / kChunkEdges;
  return items * FP * FP;
}

// Blocks of the cooperative grid: all co-resident blocks, capped at the
// work items. 0 on error.
int mpnn_spmm_da_grid(int n_edges, int k_vocab) {
  const int most = resident_blocks(spmm_da_kernel, smem_bytes());
  const int items = k_vocab + (n_edges + kChunkEdges - 1) / kChunkEdges;
  return most < 1 ? 0 : min(items, most);
}

// Launches on `stream` and returns the launch's error code (0 = success).
// Does not synchronize and allocates nothing.
int mpnn_spmm_da(const float* g, const float* h, const int* src,
                 const int* dst, const int* vorder, const int* vptr,
                 float* da, float* part, int n_edges, int mf, int nf,
                 int k_vocab, int grid, void* stream) {
  if (mf < 1 || mf > FP || nf < 1 || nf > FP || k_vocab < 1 ||
      k_vocab > kMaxVocab || n_edges < 1 || grid < 1)
    return int(cudaErrorInvalidValue);
  DaArgs a{g, h, src, dst, vorder, vptr, da, part, n_edges, mf, nf, k_vocab};
  void* args[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (void*)spmm_da_kernel, dim3(grid), dim3(kThreads), args, smem_bytes(),
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
