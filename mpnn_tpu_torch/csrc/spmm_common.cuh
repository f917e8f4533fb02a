// Shared pieces of the vocab-indexed SpMM table gradient (spmm_da.cu; the
// message VJP of msg_bwd.cu shares its items): the width bucket and the
// work mapping. The forward (spmm_fwd.cu) walks its edges on the SDDMM
// forward's tiles (sddmm_common.cuh).
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
// narrow build takes mf, nf <= 16, the wide build (-DMPNN_FP=32) up to
// 32.

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
constexpr int kMaxVocab = 64;
// dA: vocab-sorted edges in chunks of kChunkEdges, one block per work item
constexpr int kChunkEdges = 128;

// The dA sum over a stable vocab-sorted edge order (spmm_da.cu; the
// message VJP of msg_bwd.cu shares it), cut into chunks of kChunkEdges:
// a work item is one (vocab id k, chunk c) pair whose edges are all k's.
// Item (k, c) has the index b = k + c — for each k the chunks it touches
// are consecutive and start no earlier than where the previous id's
// ended, so b is unique and b < K + chunks.
__host__ __device__ inline int da_items(int n_edges, int k_vocab) {
  return k_vocab + (n_edges + kChunkEdges - 1) / kChunkEdges;
}

// The vocab id of item b: the largest k with k + vptr[k]/kChunkEdges <= b
// (that start is strictly increasing in k).
__device__ inline int da_item_id(const int* vptr, int k_vocab, int b) {
  int lo = 0, hi = k_vocab - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (mid + vptr[mid] / kChunkEdges <= b) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// Item b's FP·FP partial Σ_e g'[dst_e] ⊗ h[src_e] over its edges in
// order, into part_row (row-major m·FP + j); g' is g with each row scaled
// by gscale[row] (a mask; nullptr: unscaled). gs and hs are kChunkEdges·FP
// floats of shared staging each. Every thread of the block calls it with
// the same b; a b that holds no item returns without writing.
__device__ inline void da_item_partial(const float* g, const float* gscale,
                                       const float* h, const int* src,
                                       const int* dst, const int* vorder,
                                       const int* vptr, int k_vocab, int mf,
                                       int nf, int b, float* gs, float* hs,
                                       float* part_row) {
  const int tid = threadIdx.x;
  const int k = da_item_id(vptr, k_vocab, b);
  const int c = b - k;
  const int lo = max(vptr[k], c * kChunkEdges);
  const int hi = min(vptr[k + 1], (c + 1) * kChunkEdges);
  if (lo >= hi) return;                           // no item at b
  const int cnt = hi - lo;
  __syncthreads();                                // staging free
  for (int i = tid; i < kChunkEdges * FP; i += kThreads) {
    const int r = i / FP, j = i % FP;
    float gv = 0.f, hv = 0.f;
    if (r < cnt) {
      const int e = vorder[lo + r];
      const int d = dst[e];
      if (j < mf) {
        gv = __ldg(g + size_t(d) * mf + j);
        if (gscale) gv *= __ldg(gscale + d);
      }
      if (j < nf) hv = __ldg(h + size_t(src[e]) * nf + j);
    }
    gs[i] = gv;
    hs[i] = hv;
  }
  __syncthreads();
  for (int q = tid; q < FP * FP; q += kThreads) {
    const int m = q / FP, j = q % FP;
    float s = 0.f;
    for (int r = 0; r < cnt; ++r) s = fmaf(gs[r * FP + m], hs[r * FP + j], s);
    part_row[q] = s;
  }
}

// dA[k][q] (q = m·FP + j): the sum of id k's items' partials in chunk
// order; part holds one FP·FP row per item index.
__device__ inline float da_item_total(const float* part, const int* vptr,
                                      int k, int q) {
  const int e0 = vptr[k], e1 = vptr[k + 1];
  float s = 0.f;
  if (e1 > e0)
    for (int c = e0 / kChunkEdges; c <= (e1 - 1) / kChunkEdges; ++c)
      s += __ldcg(part + size_t(k + c) * FP * FP + q);
  return s;
}

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
