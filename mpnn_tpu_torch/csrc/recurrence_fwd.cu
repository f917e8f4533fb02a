// Fused BN→GRU→BN recurrence forward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels of mpnn_tpu/kernels/recurrence.py that compute
// the chain's forward: _fwd_kernel (make_recurrence_op, VMEM-resident),
// _blocked_kernel (the blocked streaming variant) and _merged_kernel (the
// merged streaming variant past 16,384 nodes). One function
// (recurrence_common.cuh):
//
//   mb = bn1d(msgs);  h = h0·mask;  T × { h̃_t = GRU(mb, h);  h = bn1d(h̃_t) }
//
// Outputs: h_T (N, f), the batch statistics (T + 1, 2, f) — slot 0 the
// messages', slot t step t's (mean, biased var) — for the caller's
// running EMAs, and, when the backward will run, the pre-norm states h̃_t
// (T, N, f) it reads (recurrence_bwd.cu replays nothing else).
//
// Design: ONE cooperative launch, one thread per node slot: the node
// chunks of fused_train_common.cuh (chunk c on block c mod gridDim.x in
// every phase, so a thread reads back only what it wrote). The input
// gates W_ihᵀ·mb + b_ih are computed once per node, since mb is constant.
// Each norm takes two passes — Σ m·x, a grid barrier, Σ m·(x − μ)², a
// grid barrier — with per-chunk partials summed in chunk order by every
// block (no float atomics; the statistics do not depend on the grid):
// 2T + 2 barriers. Each pass has its own partial buffer, so a block that
// runs ahead writes one while a slower block still reads the other.
//
// Bound on an H100 SXM: per node and step two f×3f GEMVs' worth of gates
// (~6f² flop) and the bytes of msgs, h0, mask, h_T and the stash: at
// lipo's b1024 (16,512 slots, f 10, T 6) ~1 us by bytes, ~0.2 us of f32
// arithmetic. The 2T + 2 grid barriers, each a few µs, set the time.

#include "recurrence_common.cuh"

namespace {

using namespace mpnn_rec;

struct FwdArgs {
  RecWeights w;
  const float* msgs;    // (N, f)
  const float* h0;      // (N, f)
  const float* mask;    // (N, 1), 0/1
  float* ht;            // (N, f) the state, updated in place; h_T at the end
  float* stats;         // (T + 1, 2, f)
  float* htil;          // (T, N, f) pre-norm states, or (N, f) scratch
  float* scratch;       // input gates (N, 3f), then the chunk partials
  int n_nodes, f, steps, stash;
};

__global__ void __launch_bounds__(kThreads)
recurrence_fwd_kernel(FwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float sm[];
  const int f = a.f, T = a.steps, N = a.n_nodes;
  stage_rec_weights(sm, a.w, f);
  float* st = sm + RL::kStats;                        // (T+1)·kSlot
  float* red = sm + RL::after_stats(T);               // kWarps·2·FP
  float* sums = red + kWarps * 2 * FP;                // 2·FP
  float* tot = sums + 2 * FP;                         // 2·FP
  __syncthreads();

  const int tid = threadIdx.x;
  const int nchunks = (N + kChunk - 1) / kChunk;
  float* gib = a.scratch;                             // (N, 3f)
  float* part_a = gib + size_t(N) * 3 * f;            // nchunks·2·FP
  float* part_b = part_a + size_t(nchunks) * 2 * FP;  // nchunks·FP
  const size_t slot_sz = size_t(N) * f;
  const float* w = sm + opaque_zero();

  // The two-pass masked statistics of slot s over the rows `src` (the
  // messages, or step s's pre-norm states), the mask count summed with
  // the first pass; sets the slot's constants and block 0 writes (mean,
  // var).
  auto statistics = [&](const float* src, int s) {
    float* sts = st + s * RL::kSlot;
    for (int ch = blockIdx.x; ch < nchunks; ch += gridDim.x) {
      const int n = ch * kChunk + tid;
      float v[2][FP];
MPNN_UNROLL
      for (int j = 0; j < FP; ++j) v[0][j] = v[1][j] = 0.f;
      if (n < N && a.mask[n] != 0.f) {
        load_row(src, n, f, v[0]);
MPNN_UNROLL
        for (int j = 0; j < FP; ++j) v[1][j] = 1.f;
      }
      block_feature_sums<2>(v, red, sums);
      if (tid < 2 * FP) part_a[size_t(ch) * 2 * FP + tid] = sums[tid];
    }
    grid.sync();
    chunk_totals<2>(part_a, 2 * FP, nchunks, red, tot);
    const float c = tot[FP];
    if (tid < FP) sts[tid] = tot[tid] / c;
    __syncthreads();
    for (int ch = blockIdx.x; ch < nchunks; ch += gridDim.x) {
      const int n = ch * kChunk + tid;
      float v[1][FP];
MPNN_UNROLL
      for (int j = 0; j < FP; ++j) v[0][j] = 0.f;
      if (n < N && a.mask[n] != 0.f) {
        float x[FP];
        load_row(src, n, f, x);
MPNN_UNROLL
        for (int j = 0; j < FP; ++j) {
          const float d = x[j] - sts[j];
          v[0][j] = d * d;
        }
      }
      block_feature_sums<1>(v, red, sums);
      if (tid < FP) part_b[size_t(ch) * FP + tid] = sums[tid];
    }
    grid.sync();
    chunk_totals<1>(part_b, FP, nchunks, red, tot + FP);
    if (tid < FP) {
      const float mean = sts[tid], var = tot[FP + tid] / c;
      set_rec_slot(sts, tid, mean, var);
      if (blockIdx.x == 0 && tid < f) {
        a.stats[(size_t(s) * 2) * f + tid] = mean;
        a.stats[(size_t(s) * 2 + 1) * f + tid] = var;
      }
    }
    __syncthreads();
  };

  // ---- slot 0: the message norm, then the input gates per node ----------
  statistics(a.msgs, 0);
  for (int ch = blockIdx.x; ch < nchunks; ch += gridDim.x) {
    const int n = ch * kChunk + tid;
    if (n < N && a.mask[n] != 0.f) {
      float x[FP], xh[FP], mb[FP];
      load_row(a.msgs, n, f, x);
      bn_row(w, RL::kMaW, RL::kMaB, st, x, xh, mb);
      input_gates(w, mb, f, gib + size_t(n) * 3 * f);
    }
  }

  // ---- the T steps -------------------------------------------------------
  for (int t = 1; t <= T; ++t) {
    float* htil_t = a.htil + (a.stash ? size_t(t - 1) * slot_sz : 0);
    for (int ch = blockIdx.x; ch < nchunks; ch += gridDim.x) {
      const int n = ch * kChunk + tid;
      if (n >= N) continue;
      float hn[FP];
MPNN_UNROLL
      for (int j = 0; j < FP; ++j) hn[j] = 0.f;
      if (a.mask[n] != 0.f) {
        float h[FP];
        load_row(t == 1 ? a.h0 : a.ht, n, f, h);
        gru_cell(w, gib + size_t(n) * 3 * f, f, h, hn);
      }
      store_row(htil_t, n, f, hn);
    }
    statistics(htil_t, t);
    const float* stt = st + t * RL::kSlot;
    for (int ch = blockIdx.x; ch < nchunks; ch += gridDim.x) {
      const int n = ch * kChunk + tid;
      if (n >= N) continue;
      float y[FP];
MPNN_UNROLL
      for (int j = 0; j < FP; ++j) y[j] = 0.f;
      if (a.mask[n] != 0.f) {
        float x[FP], xh[FP];
        load_row(htil_t, n, f, x);
        bn_row(w, RL::kBnW, RL::kBnB, stt, x, xh, y);
      }
      store_row(a.ht, n, f, y);
    }
  }
}

size_t smem_bytes(int steps) {
  return sizeof(float) *
         (size_t(RL::after_stats(steps)) + kWarps * 2 * FP + 4 * FP);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes.
int mpnn_recurrence_fwd_smem_bytes(int steps) {
  return int(smem_bytes(steps));
}

// Floats of scratch a launch needs: the input gates and the chunk partials.
long long mpnn_recurrence_fwd_scratch_floats(int n_nodes, int f) {
  const long long nchunks = (n_nodes + kChunk - 1) / kChunk;
  return 3LL * n_nodes * f + nchunks * 3 * FP;
}

// Blocks of the cooperative grid: all co-resident blocks, capped at the
// node chunks. 0 on error.
int mpnn_recurrence_fwd_grid(int steps, int n_nodes) {
  const size_t bytes = smem_bytes(steps);
  if (cudaFuncSetAttribute(recurrence_fwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(bytes)) != cudaSuccess)
    return 0;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, recurrence_fwd_kernel, kThreads, bytes) != cudaSuccess)
    return 0;
  return min(per_sm * sms, max((n_nodes + kChunk - 1) / kChunk, 1));
}

// Launches on `stream` and returns the launch's error code (0 = success).
// Does not synchronize and allocates nothing. stash != 0: htil is
// (T, N, f) and keeps every step's pre-norm state; else (N, f) scratch.
int mpnn_recurrence_fwd(const float* msgs, const float* h0,
                        const float* mask, const float* w_ih,
                        const float* w_hh, const float* b_ih,
                        const float* b_hh, const float* ma_w,
                        const float* ma_b, const float* bn_w,
                        const float* bn_b, float* ht, float* stats,
                        float* htil, float* scratch, int n_nodes, int f,
                        int steps, int stash, int grid, void* stream) {
  if (f < 1 || f > FP || steps < 1 || steps > kMaxSteps || n_nodes < 1 ||
      grid < 1)
    return int(cudaErrorInvalidValue);
  FwdArgs a{{w_ih, w_hh, b_ih, b_hh, ma_w, ma_b, bn_w, bn_b},
            msgs, h0, mask, ht, stats, htil, scratch,
            n_nodes, f, steps, stash};
  const size_t bytes = smem_bytes(steps);
  cudaError_t err = cudaFuncSetAttribute(
      recurrence_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (err != cudaSuccess) return int(err);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((void*)recurrence_fwd_kernel,
                                    dim3(grid), dim3(kThreads), args, bytes,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
