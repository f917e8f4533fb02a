// Attention SDDMM forward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels mpnn_tpu/kernels/sddmm.py::_sddmm_kernel and
// _sddmm_t_kernel (the forward of make_sddmm_op in its row and transposed
// layouts, one function):
//
//   out[d] = Σ_{e: dst_e = d} A'[vid_e] · (gate_e ⊙ h[src_e]),
//   gate_e = softmax_feat([h[d] ‖ ev[vid_e]] · Wa + ba)
//
// The TPU kernels gather and scatter with one-hot matmuls over node
// windows planned on the host, the features on a padded lane or sublane
// panel. Here each destination row walks its own edges in the loader's
// stable destination order (plan edge_order, dst_ptr).
//
// Design: one warp per destination row, rows strided over the blocks;
// lane j holds feature j. A row computes u_d = h[d]·Wh + ba once; an edge
// adds the staged ew[vid], softmaxes over the nf lanes (warp max and sum),
// gates h[src] and applies A'[vid] with g broadcast lane by lane (the
// narrow bucket reads A' transposed from shared memory, the lanes of a
// warp on consecutive words; the wide bucket from device memory). Each
// row sums its edges in order and writes its output once: no atomics,
// deterministic. Padded edges are edges like any other: they end at the
// batch's dummy node, whose row walks them all in series.
//
// Bound on an H100 SXM: per real edge the logits' (nf + ef)·nf and the
// GEMV's mf·nf FMAs and the softmax (~8 MFLOP at adv's b1024, E ≈ 26.6k,
// f 7, ef 6), and the bytes of h, out, A', the edge arrays (~1.3 MB):
// ~0.4 us by bytes. The edge gathers are irregular, a row's
// edges run in series and each costs a chain of warp shuffles, so latency,
// not either peak, sets the time.

#include "sddmm_common.cuh"

namespace {

using namespace mpnn_sddmm;

struct FwdArgs {
  const float* aprime;  // (K, mf, nf)
  const float* evocab;  // (K, ef)
  const float* wa;      // (nf + ef, nf)
  const float* ba;      // (nf)
  const float* h;       // (N, nf)
  const int* vid;       // (E) vocab id of each edge
  const int* src;       // (E)
  const int* order;     // (E) edge ids, stably sorted by destination
  const int* ptr;       // (N + 1) row pointers into order
  float* out;           // (N, mf)
  int n, mf, nf, ef, k_vocab;
};

__global__ void __launch_bounds__(kThreads) sddmm_fwd_kernel(FwdArgs a) {
  extern __shared__ float sm[];
  const Tables t = stage_tables(sm, a.wa, a.ba, a.evocab, a.nf, a.ef,
                                a.k_vocab);
  float* at = t.next;
  const int tid = threadIdx.x;
  if (kTableInSmem) {
    // at[(k·FP + j)·FP + m] = A'[k][m][j], zero-padded
    for (int i = tid; i < a.k_vocab * FP * FP; i += kThreads) {
      const int k = i / (FP * FP), r = i % (FP * FP), j = r / FP,
                m = r % FP;
      at[i] = (m < a.mf && j < a.nf)
                  ? a.aprime[(size_t(k) * a.mf + m) * a.nf + j]
                  : 0.f;
    }
  }
  __syncthreads();
  const int lane = tid % 32;
  for (int row = blockIdx.x * kWarps + tid / 32; row < a.n;
       row += gridDim.x * kWarps) {
    const int p0 = a.ptr[row], p1 = a.ptr[row + 1];
    float acc = 0.f;
    if (p1 > p0) {
      const float hd =
          lane < a.nf ? __ldg(a.h + size_t(row) * a.nf + lane) : 0.f;
      const float u = row_logits(t, hd, lane, a.nf);
      for (int p = p0; p < p1; ++p) {
        const int e = __ldg(a.order + p);
        const int k = __ldg(a.vid + e);
        const float hs =
            lane < a.nf ? __ldg(a.h + size_t(__ldg(a.src + e)) * a.nf + lane)
                        : 0.f;
        const float g = edge_gate(t, u, k, lane, a.nf) * hs;
        // msg[m] = Σ_j A'[k][m][j]·g[j] on lane m
        float msg = 0.f;
        for (int j = 0; j < a.nf; ++j) {
          const float gj = __shfl_sync(kFull, g, j);
          if (kTableInSmem) {
            if (lane < FP)
              msg = fmaf(at[(size_t(k) * FP + j) * FP + lane], gj, msg);
          } else if (lane < a.mf) {
            msg = fmaf(__ldg(a.aprime + (size_t(k) * a.mf + lane) * a.nf + j),
                       gj, msg);
          }
        }
        acc += msg;
      }
    }
    if (lane < a.mf) a.out[size_t(row) * a.mf + lane] = acc;
  }
}

size_t smem_bytes(int k_vocab) {
  return sizeof(float) *
         (table_floats(k_vocab) +
          (kTableInSmem ? size_t(k_vocab) * FP * FP : 0));
}

// Blocks of a launch: the co-resident blocks (queried once per vocab
// size, which sets the shared memory), capped at one per kWarps rows.
// Every query leaves the kernel's shared-memory limit at the largest
// vocab's, so a launch at any K fits it whatever K came before. 0 on
// error.
int grid_of(int k_vocab, int n) {
  static int resident[kMaxVocab + 1] = {};
  if (resident[k_vocab] < 1)
    resident[k_vocab] = resident_blocks(sddmm_fwd_kernel,
                                        smem_bytes(k_vocab),
                                        smem_bytes(kMaxVocab));
  const int need = (n + kWarps - 1) / kWarps;
  return resident[k_vocab] < 1 ? 0 : min(need, resident[k_vocab]);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes.
int mpnn_sddmm_fwd_smem_bytes(int k_vocab) {
  return int(smem_bytes(k_vocab));
}

// Launches on `stream` and returns the launch's error code (0 = success).
// Does not synchronize and allocates nothing.
int mpnn_sddmm_fwd(const float* aprime, const float* evocab, const float* wa,
                   const float* ba, const float* h, const int* vid,
                   const int* src, const int* order, const int* ptr,
                   float* out, int n, int mf, int nf, int ef, int k_vocab,
                   void* stream) {
  if (mf < 1 || mf > FP || nf < 1 || nf > FP || ef < 0 ||
      ef > kMaxEdgeFeatures || k_vocab < 1 || k_vocab > kMaxVocab || n < 1)
    return int(cudaErrorInvalidValue);
  FwdArgs args{aprime, evocab, wa, ba, h, vid, src, order, ptr, out,
               n, mf, nf, ef, k_vocab};
  const int grid = grid_of(k_vocab, n);
  if (grid < 1) return int(cudaErrorInvalidConfiguration);
  sddmm_fwd_kernel<<<grid, kThreads, smem_bytes(k_vocab),
                     static_cast<cudaStream_t>(stream)>>>(args);
  return int(cudaGetLastError());
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
