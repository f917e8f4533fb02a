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

__global__ void __launch_bounds__(kThreads) spmm_da_kernel(DaArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float sm[];
  float* gs = sm;                                   // kChunkEdges · FP
  float* hs = gs + kChunkEdges * FP;                // kChunkEdges · FP
  const int tid = threadIdx.x;
  const int items = da_items(a.n_edges, a.k_vocab);

  // ---- phase 1: one row of FP·FP partials per work item ------------------
  for (int b = blockIdx.x; b < items; b += gridDim.x)
    da_item_partial(a.g, nullptr, a.h, a.src, a.dst, a.vorder, a.vptr,
                    a.k_vocab, a.mf, a.nf, b, gs, hs,
                    a.part + size_t(b) * FP * FP);
  grid.sync();

  // ---- phase 2: dA[k][m][j] = Σ of id k's items, in chunk order ----------
  const int total = a.k_vocab * a.mf * a.nf;
  for (int i = blockIdx.x * kThreads + tid; i < total;
       i += gridDim.x * kThreads) {
    const int k = i / (a.mf * a.nf), r = i % (a.mf * a.nf);
    a.da[i] = da_item_total(a.part, a.vptr, k, (r / a.nf) * FP + r % a.nf);
  }
}

size_t smem_bytes() { return sizeof(float) * 2 * size_t(kChunkEdges) * FP; }

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes.
int mpnn_spmm_da_smem_bytes() { return int(smem_bytes()); }

// Floats of scratch (the items' partials) a launch over n_edges needs.
long long mpnn_spmm_da_scratch_floats(int n_edges, int k_vocab) {
  return (long long)da_items(n_edges, k_vocab) * FP * FP;
}

// Blocks of the cooperative grid: all co-resident blocks, capped at the
// work items. 0 on error.
int mpnn_spmm_da_grid(int n_edges, int k_vocab) {
  const int most = resident_blocks(spmm_da_kernel, smem_bytes());
  return most < 1 ? 0 : min(da_items(n_edges, k_vocab), most);
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
