// Whole-step TRAINING forward of the shared-weight edge-network MPNN (the
// flagship `lipo` training path), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mpnn_tpu/kernels/fused_step.py::_fwd_kernel
// (public entry make_fused_step_op). Same function, with the masked bn1d
// norms in TRAINING mode — normalized by the statistics of ALL real nodes
// of the batch, once for the messages and again after every GRU step:
//
//   m_d   = Σ_{e: dst_e = d} A[vid_e]·h0[src_e] + A0·S_g + mbias   (slot 0)
//   mb    = bn1d(m)          (batch stats of slot 0; or m for 'none')
//   h     = h0;  T × { h̃_t = GRU(W_ihᵀ·mb + b_ih, h);  h = bn1d(h̃_t) }
//   out_g = Σ_{d ∈ g} softmax_od(W_iᵀ[h ‖ h0_d] + b_i) ⊙ (W_jᵀ[h ‖ h0_d] + b_j)
//   loss  = Σ_g Σ_o (out_go − y_g)²·gm_g / Σ_g gm_g
//
// bn1d(x) = w·(x − mean)/(sqrt(max(var, 1e-12)) + 1e-5) + b with the
// biased var; the (mean, var) of each slot are outputs (for the running
// EMAs), and so is the residual stash htil (T+1, N, f): slot 0 the masked
// messages, slot t the pre-norm state of step t — the backward
// (fused_step_bwd.cu) reads them and does not replay the forward.
//
// The state norm may also be the stateless one, (x − mean)/sqrt(var +
// 1e-6) on the same per-step batch statistics, with no affine and no
// running state (make_fused_step_op's state_norm='stateless').
//
// Design: ONE cooperative launch; the body, its phases and barriers
// (T + 3 for bn1d/bn1d) are in fused_step_forward.cuh, which the serving
// kernel of the stateless norm (fused_eval.cu) shares.
//
// Bound on an H100 SXM: f32 CUDA-core arithmetic on ~1e8 flop and a few
// MB of traffic at batch 1024, so in practice the T + 3 grid barriers and
// the launch dominate; chip_smoke.py recounts the bound from the run's
// shapes.

#include "fused_step_forward.cuh"

namespace {

using namespace mpnn_step;

__global__ void __launch_bounds__(kThreads)
fused_step_fwd_kernel(FwdArgs a) {
  step_forward<true>(a);
}

size_t smem_bytes(int k_vocab, int steps) {
  return sizeof(float) * fwd_smem_floats(k_vocab, steps);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes.
int mpnn_fused_step_fwd_smem_bytes(int k_vocab, int steps) {
  return int(smem_bytes(k_vocab, steps));
}

// Floats of scratch the launch needs (chunk partials, per-graph terms).
long long mpnn_fused_step_fwd_scratch_floats(int n_nodes, int n_graphs) {
  return fwd_scratch_floats(n_nodes, n_graphs);
}

// Blocks of the cooperative grid: all co-resident blocks, capped at the
// work's need (one warp per graph, one thread per node slot). 0 on error.
int mpnn_fused_step_fwd_grid(int k_vocab, int steps, int n_nodes,
                             int n_graphs) {
  return forward_grid(fused_step_fwd_kernel, smem_bytes(k_vocab, steps),
                      n_nodes, n_graphs);
}

// Launches on `stream` and returns the launch's error code (0 = success).
// Does not synchronize and allocates nothing. msg_mode in {kNone,
// kBatchBn}, state_mode in {kNone, kBatchBn, kStateless}
// (fused_train_common.cuh::Mode).
int mpnn_fused_step_fwd(
    const float* amat, const float* a0, const float* mbias, const float* h0,
    const float* w_ih, const float* w_hh, const float* b_ih,
    const float* b_hh, const float* ma_w, const float* ma_b,
    const float* bn_w, const float* bn_b, const float* ro_iw,
    const float* ro_ib, const float* ro_jw, const float* ro_jb,
    const float* labels, const float* gmask, const int* vid, const int* src,
    const int* edge_order, const int* dst_ptr, const int* graph_node_ptr,
    float* loss, float* out, float* stats, float* htil, float* scratch,
    int n_nodes, int n_graphs, int f, int od, int k_vocab, int steps,
    int msg_mode, int state_mode, int grid, void* stream) {
  if (f > FP || od > ODP || steps < 1 || steps > kMaxSteps || grid < 1 ||
      (msg_mode != kNone && msg_mode != kBatchBn) ||
      (state_mode != kNone && state_mode != kBatchBn &&
       state_mode != kStateless))
    return int(cudaErrorInvalidValue);
  FwdArgs a{{amat, a0, mbias, w_ih, w_hh, b_ih, b_hh, ma_w, ma_b, bn_w,
             bn_b, ro_iw, ro_ib, ro_jw, ro_jb},
            h0, labels, gmask, vid, src, edge_order, dst_ptr,
            graph_node_ptr, loss, out, stats, htil, scratch,
            n_nodes, n_graphs, f, od, k_vocab, steps, msg_mode, state_mode};
  return launch_forward(fused_step_fwd_kernel, a,
                        smem_bytes(k_vocab, steps), grid, stream);
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
