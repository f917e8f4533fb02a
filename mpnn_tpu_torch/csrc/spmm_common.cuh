// Shared pieces of the vocab-indexed SpMM kernels (spmm_fwd.cu,
// spmm_da.cu): the width bucket and the work mapping.
//
// The function (mpnn_tpu/kernels/spmm.py, the A-form message sum of the
// edge-network family):
//
//   out[d] = Σ_{e: dst_e = d} A[vid_e] · h[src_e]            (N, mf)
//   dh[s]  = Σ_{e: src_e = s} A[vid_e]ᵀ · g[dst_e]     (the sum on Aᵀ)
//   dA[k]  = Σ_{e: vid_e = k} g[dst_e] ⊗ h[src_e]             (K, mf, nf)
//
// A is the (K, mf, nf) table of one message matrix per distinct bond-
// feature row (the edge vocabulary, K <= 64). Every sum runs in a fixed
// order: the forward and its transpose walk each row's edges in a stable
// edge order (the loader's destination order, or the source order built
// on the device), and dA sums stable vocab-sorted edge chunks in chunk
// order. No float atomics, so results do not depend on scheduling.
//
// Width buckets (kernels/build.py::WIDE, kernels/spmm.py::BUCKETS): the
// narrow build takes mf, nf <= 16 and stages A in shared memory (64 KB at
// K 64); the wide build (-DMPNN_FP=32) reads A from device memory through
// the read-only cache (256 KB at K 64 would not fit a block).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace mpnn_spmm {

namespace cg = cooperative_groups;

#ifndef MPNN_FP
#define MPNN_FP 16
#endif
constexpr int FP = MPNN_FP;              // widest mf, nf of the bucket
static_assert(FP == 16 || FP == 32, "the buckets are 16 and 32 wide");
constexpr int kThreads = 256;
// the forward: a lane group of FP lanes per output row, lane m computes
// feature m
constexpr int kRowsPerBlock = kThreads / FP;
constexpr bool kTableInSmem = FP <= 16;
constexpr int kMaxVocab = 64;
// dA: vocab-sorted edges in chunks of kChunkEdges, one block per work item
constexpr int kChunkEdges = 128;

// All co-resident blocks of `kernel` at `smem` bytes of dynamic shared
// memory a block (what a cooperative launch may take), after setting the
// kernel's shared-memory limit to `limit` (at least `smem`): a kernel
// whose launches take several sizes sets its largest, so that no query
// lowers the limit below a size that another launch takes. 0 on error.
template <class Kernel>
int resident_blocks(Kernel kernel, size_t smem, size_t limit = 0) {
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(limit > smem ? limit : smem)) != cudaSuccess)
    return 0;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, smem) !=
          cudaSuccess)
    return 0;
  return per_sm * sms;
}

}  // namespace mpnn_spmm
