// Whole-step INFERENCE of the per-step edge-network MPNN (the serving path
// of the graph_norm and encoded models), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mpnn_tpu/kernels/fused_psteps.py::_ps_eval_kernel
// (public entry make_fused_psteps_eval_op). Same function:
//
//   m_t[d] = Σ_{e: dst_e = d} A_t[vid_e]·h0[src_e] + A0_t·S_g + mbias_t
//   h = h0;  for t < T: h = norm_t(GRU(W_ihᵀ·mnorm_t(m_t) + b_ih, h))
//   out_g  = Σ_{d ∈ g} softmax_od(W_iᵀ[h ‖ h0_d] + b_i) ⊙ (W_jᵀ[h ‖ h0_d] + b_j)
//
// mnorm_t is the folded eval-mode bn1d of step t (a per-feature affine the
// wrapper computes from ITS OWN running statistics) or the identity;
// norm_t the same, or the STATELESS norm, which normalizes by the eval
// batch's own masked mean and var at every step (eps 1e-6 inside the
// sqrt) — so a graph_norm prediction depends on the rest of its batch, a
// reference quirk kept here.
//
// Bound on an H100 SXM: float32 CUDA-core arithmetic on a few ×1e7 to 1e8
// operations and a few MB at batch 1024, so the launch, one warp per graph
// and the grid barriers set the time in practice; chip_smoke.py counts
// the bound from the run's shapes.
//
// Design: the stateless norm needs batch-wide statistics after every
// step, so a graph-local warp cannot serve a batch alone. The kernel's
// body (fused_psteps_common.cuh::psteps_forward, the training forward's
// design before fused_psteps_fwd.cu was redesigned): ONE cooperative
// launch, messages of all T steps from one gather of h0[src] per edge,
// node chunks for the recurrence, the stateless norm's statistics from
// per-chunk partials combined in chunk order after grid.sync()
// (double-buffered by step parity), no float atomics. Barriers: 2, plus T
// with the stateless norm. Scratch in device memory: the T message slots
// and ONE state slot, updated in place by each step ((T + 1)·N·f
// floats).

#include "fused_psteps_common.cuh"

namespace {

using namespace mpnn_psteps;

__global__ void __launch_bounds__(kThreads)
fused_psteps_eval_kernel(PsFwdArgs a) {
  psteps_forward(a);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes.
int mpnn_fused_psteps_eval_smem_bytes(int steps) {
  return int(sizeof(float) * fwd_smem_floats(steps));
}

long long mpnn_fused_psteps_eval_scratch_floats(int n_nodes, int n_graphs,
                                                int steps) {
  return fwd_scratch_floats(n_nodes, n_graphs, steps);
}

// Blocks of the cooperative grid (one warp per graph, one thread per node
// slot, capped at the co-resident blocks); 0 on error.
int mpnn_fused_psteps_eval_grid(int steps, int n_nodes, int n_graphs) {
  const int need = max((n_nodes + kChunk - 1) / kChunk,
                       (n_graphs + kWarps - 1) / kWarps);
  return coop_grid(fused_psteps_eval_kernel,
                   sizeof(float) * fwd_smem_floats(steps), need);
}

// Launches on `stream`; returns the launch's error code (0 = success).
// Does not synchronize and allocates nothing.
int mpnn_fused_psteps_eval(
    const float* amat, const float* a0, const float* mbias,
    const float* w_ih, const float* w_hh, const float* b_ih,
    const float* b_hh, const float* ma_w, const float* ma_b,
    const float* bn_w, const float* bn_b, const float* ro_iw,
    const float* ro_ib, const float* ro_jw, const float* ro_jb,
    const float* h0, const int* vid, const int* src, const int* edge_order,
    const int* dst_ptr, const int* graph_node_ptr, float* out, float* htil,
    float* scratch, int n_nodes, int n_graphs, int f, int od, int k_vocab,
    int steps, int msg_mode, int state_mode, int grid, void* stream) {
  if (f > FP || od > ODW || steps < 1 || steps > kMaxSteps || grid < 1 ||
      (msg_mode != kNone && msg_mode != kAffine) ||
      (state_mode != kNone && state_mode != kAffine &&
       state_mode != kStateless))
    return int(cudaErrorInvalidValue);
  PsFwdArgs a{{amat, a0, mbias, w_ih, w_hh, b_ih, b_hh, ma_w, ma_b, bn_w,
               bn_b, ro_iw, ro_ib, ro_jw, ro_jb},
              h0, nullptr, nullptr, vid, src, edge_order, dst_ptr,
              graph_node_ptr, nullptr, out, nullptr, htil, scratch,
              n_nodes, n_graphs, f, od, k_vocab, steps, msg_mode,
              state_mode};
  return coop_launch(fused_psteps_eval_kernel, a,
                     sizeof(float) * fwd_smem_floats(steps), grid, stream);
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
