// Vocab-indexed SpMM forward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels mpnn_tpu/kernels/spmm.py::_fwd_kernel_vmem and
// _fwd_kernel_hbm (the forward of make_spmm_op, and its transposed use in
// the VJP):
//
//   out[r] = Σ_{p = ptr[r]}^{ptr[r+1]-1} A[vid_e] · x[gather_e],  e = order[p]
//
// With (gather, order, ptr) = (src, the destination order, dst_ptr) this
// is the message sum out[d] = Σ_{e: dst_e = d} A[vid_e]·h[src_e]; with
// (dst, the source order, src_ptr) and the transposed table Aᵀ it is the
// VJP's dh. The TPU kernels gather and scatter with one-hot matmuls over
// node windows planned on the host; here each output row walks its own
// edges.
//
// Design: a lane group of FP lanes per output row (lane m computes feature
// m), rows strided over the blocks. Each row sums its edges in the order's
// stable sequence and writes its output once: no atomics, deterministic.
// The narrow bucket stages A transposed in shared memory, so the lanes of
// a group read consecutive words; the wide bucket reads A's rows from
// device memory through the read-only cache.
//
// Bound on an H100 SXM: 2·E·mf·nf flop (3.4 MFLOP at lipo's b1024, E ≈
// 26.6k edges, f 10) and the bytes of h, out, the edge arrays and the
// plan (~1.4 MB): ~0.4 us by bytes. The edge gathers are irregular and a
// row's edges run in series, so latency, not either peak, sets the time.

#include "spmm_common.cuh"

namespace {

using namespace mpnn_spmm;

struct FwdArgs {
  const float* a;       // (K, mo, ni)
  const float* x;       // (n_in, ni)
  const int* vid;       // (E) vocab id of each edge
  const int* gather;    // (E) the row of x each edge reads
  const int* order;     // (E) edge ids grouped by output row, stable
  const int* ptr;       // (n_out + 1) row pointers into order
  float* out;           // (n_out, mo)
  int n_out, mo, ni, k_vocab;
};

__global__ void __launch_bounds__(kThreads) spmm_fwd_kernel(FwdArgs a) {
  extern __shared__ float sm[];
  const int tid = threadIdx.x;
  if (kTableInSmem) {
    // at[(k·FP + j)·FP + m] = A[k][m][j], zero-padded
    for (int i = tid; i < a.k_vocab * FP * FP; i += kThreads) {
      const int k = i / (FP * FP), r = i % (FP * FP), j = r / FP,
                m = r % FP;
      sm[i] = (m < a.mo && j < a.ni)
                  ? a.a[(size_t(k) * a.mo + m) * a.ni + j]
                  : 0.f;
    }
    __syncthreads();
  }
  const int lane = tid % FP;
  for (int row = blockIdx.x * kRowsPerBlock + tid / FP; row < a.n_out;
       row += gridDim.x * kRowsPerBlock) {
    float acc = 0.f;
    const int p1 = a.ptr[row + 1];
    for (int p = a.ptr[row]; p < p1; ++p) {
      const int e = a.order[p];
      const int k = a.vid[e];
      const float* xr = a.x + size_t(a.gather[e]) * a.ni;
      if (kTableInSmem) {
        const float* t = sm + size_t(k) * FP * FP + lane;
        for (int j = 0; j < a.ni; ++j)
          acc = fmaf(t[j * FP], __ldg(xr + j), acc);
      } else if (lane < a.mo) {
        const float* t = a.a + (size_t(k) * a.mo + lane) * a.ni;
        for (int j = 0; j < a.ni; ++j)
          acc = fmaf(__ldg(t + j), __ldg(xr + j), acc);
      }
    }
    if (lane < a.mo) a.out[size_t(row) * a.mo + lane] = acc;
  }
}

size_t smem_bytes(int k_vocab) {
  return kTableInSmem ? sizeof(float) * size_t(k_vocab) * FP * FP : 0;
}

// Blocks of a launch: the co-resident blocks (queried once per vocab
// size, which sets the shared memory), capped at one per kRowsPerBlock
// rows. Every query leaves the kernel's shared-memory limit at the
// largest vocab's, so a launch at any K fits it whatever K came before.
// 0 on error.
int grid_of(int k_vocab, int n_out) {
  static int resident[kMaxVocab + 1] = {};
  if (resident[k_vocab] < 1)
    resident[k_vocab] = resident_blocks(spmm_fwd_kernel, smem_bytes(k_vocab),
                                        smem_bytes(kMaxVocab));
  const int need = (n_out + kRowsPerBlock - 1) / kRowsPerBlock;
  return resident[k_vocab] < 1 ? 0 : min(need, resident[k_vocab]);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes.
int mpnn_spmm_fwd_smem_bytes(int k_vocab) { return int(smem_bytes(k_vocab)); }

// Launches on `stream` and returns the launch's error code (0 = success).
// Does not synchronize and allocates nothing.
int mpnn_spmm_fwd(const float* a, const float* x, const int* vid,
                  const int* gather, const int* order, const int* ptr,
                  float* out, int n_out, int mo, int ni, int k_vocab,
                  void* stream) {
  if (mo < 1 || mo > FP || ni < 1 || ni > FP || k_vocab < 1 ||
      k_vocab > kMaxVocab || n_out < 1)
    return int(cudaErrorInvalidValue);
  FwdArgs args{a, x, vid, gather, order, ptr, out, n_out, mo, ni, k_vocab};
  const int grid = grid_of(k_vocab, n_out);
  if (grid < 1) return int(cudaErrorInvalidConfiguration);
  spmm_fwd_kernel<<<grid, kThreads, smem_bytes(k_vocab),
                    static_cast<cudaStream_t>(stream)>>>(args);
  return int(cudaGetLastError());
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
