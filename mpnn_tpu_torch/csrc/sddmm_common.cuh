// Shared pieces of the attention SDDMM kernels (sddmm_fwd.cu,
// sddmm_bwd.cu): the width bucket, the shared-memory tables and the
// per-edge gate.
//
// The function (mpnn_tpu/kernels/sddmm.py, the unfused attention message
// of the attention models' decomposed training path):
//
//   gate_e = softmax_feat([h[dst_e] ‖ ev[vid_e]] · Wa + ba)       (nf)
//   g_e    = gate_e ⊙ h[src_e]
//   out[d] = Σ_{e: dst_e = d} A'[vid_e] · g_e                       (N, mf)
//
// A' is the (K, mf, nf) table of one message matrix per distinct bond-
// feature row (the edge vocabulary, K <= 64), ev the (K, ef) vocab rows,
// Wa (nf + ef, nf) in the JAX (in, out) layout. The logits split into a
// per-destination part u_d = h[d]·Wh + ba (Wh = Wa's first nf rows: the
// same for every edge of a row) and a per-vocab part ew_k = ev[k]·We (We
// = the last ef rows), staged in shared memory once per block; an edge
// then costs the softmax over its nf lanes and the GEMV with A'[vid].
//
// Work mapping: one warp per destination row, lane j holding feature j
// (nf, mf <= 32), the softmax's max and sum and every other lane sum a
// xor-butterfly in a fixed order. Every sum runs in a fixed order, no
// float atomics: results do not depend on scheduling.
//
// Width buckets (kernels/build.py::WIDE, kernels/sddmm.py::BUCKETS): the
// narrow build takes nf, mf <= 16 and stages A' in shared memory (64 KB
// at K 64); the wide build (-DMPNN_FP=32) reads A' from device memory
// through the read-only cache (256 KB at K 64 would not fit a block).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace mpnn_sddmm {

namespace cg = cooperative_groups;

#ifndef MPNN_FP
#define MPNN_FP 16
#endif
constexpr int FP = MPNN_FP;              // widest mf, nf of the bucket
static_assert(FP == 16 || FP == 32, "the buckets are 16 and 32 wide");
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr bool kTableInSmem = FP <= 16;
constexpr int kMaxVocab = 64;
constexpr int kMaxEdgeFeatures = 32;
constexpr unsigned kFull = 0xffffffffu;
// the logits' padding lanes: zero softmax mass, as the TPU kernels' −1e30
// bias pad gives
constexpr float kPadLogit = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// The tables every block stages (wh, whT, ew, ba; FP-strided, zero-
// padded): wh[i·FP + j] = Wa[i][j], whT[j·FP + i] = Wa[i][j] (i, j < nf),
// ew[k·FP + j] = Σ_i ev[k][i]·Wa[nf + i][j], bs[j] = ba[j].
struct Tables {
  float* wh;
  float* whT;
  float* ew;
  float* bs;
  float* next;    // the first float past them
};

inline size_t table_floats(int k_vocab) {
  return size_t(2) * FP * FP + size_t(k_vocab) * FP + FP;
}

__device__ inline Tables stage_tables(float* sm, const float* wa,
                                      const float* ba, const float* evocab,
                                      int nf, int ef, int k_vocab) {
  Tables t;
  t.wh = sm;
  t.whT = t.wh + FP * FP;
  t.ew = t.whT + FP * FP;
  t.bs = t.ew + k_vocab * FP;
  t.next = t.bs + FP;
  const int tid = threadIdx.x;
  for (int q = tid; q < FP * FP; q += kThreads) {
    const int i = q / FP, j = q % FP;
    const bool in = i < nf && j < nf;
    t.wh[q] = in ? wa[i * nf + j] : 0.f;
    t.whT[j * FP + i] = in ? wa[i * nf + j] : 0.f;
  }
  for (int q = tid; q < k_vocab * FP; q += kThreads) {
    const int k = q / FP, j = q % FP;
    float s = 0.f;
    if (j < nf)
      for (int i = 0; i < ef; ++i)
        s = fmaf(evocab[k * ef + i], wa[(nf + i) * nf + j], s);
    t.ew[q] = s;
  }
  for (int j = tid; j < FP; j += kThreads) t.bs[j] = j < nf ? ba[j] : 0.f;
  return t;
}

// u_d[j] = ba[j] + Σ_i h[d][i]·Wh[i][j] on lane j (0 past nf); hd is
// lane i's h[d][i] (0 past nf). Every lane of the warp calls it.
__device__ __forceinline__ float row_logits(const Tables& t, float hd,
                                            int lane, int nf) {
  float u = lane < nf ? t.bs[lane] : 0.f;
  for (int i = 0; i < nf; ++i) {
    const float hi = __shfl_sync(kFull, hd, i);
    if (lane < nf) u = fmaf(hi, t.wh[i * FP + lane], u);
  }
  return u;
}

// gate_e[j] on lane j (0 past nf): the softmax over the nf real lanes of
// u_d + ew_k. Every lane of the warp calls it.
__device__ __forceinline__ float edge_gate(const Tables& t, float u, int k,
                                           int lane, int nf) {
  const float logit = lane < nf ? u + t.ew[k * FP + lane] : kPadLogit;
  const float mx = warp_max(logit);
  const float ex = lane < nf ? expf(logit - mx) : 0.f;
  return ex / warp_sum(ex);
}

// All co-resident blocks of `kernel` at `smem` bytes of dynamic shared
// memory a block (what a cooperative launch may take), after setting the
// kernel's shared-memory limit to `limit` (at least `smem`): a kernel
// whose launches take several sizes sets its largest, so that no query
// lowers the limit below a size that another launch takes. 0 on error.
template <class Kernel>
int resident_blocks(Kernel kernel, size_t smem, size_t limit) {
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

}  // namespace mpnn_sddmm
