// Whole-step TRAINING forward of the per-step edge-network MPNN (the
// graph_norm and encoded training path), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mpnn_tpu/kernels/fused_psteps.py::_ps_fwd_kernel
// (public entry make_fused_psteps_op). Same function, with the per-step
// norms in TRAINING mode — each step's message bn1d and state bn1d
// normalized by the statistics of ALL real nodes of the batch at that
// step — or the stateless norm, or none:
//
//   m_t   = Σ_{e: dst_e = d} A_t[vid_e]·h0[src_e] + A0_t·S_g + mbias_t
//   h = h0;  for t < T: h̃_t = GRU(W_ihᵀ·ma_bn_t(m_t) + b_ih, h);
//                       h = bn_t(h̃_t)
//   out_g = Σ_{d ∈ g} softmax_od(W_iᵀ[h ‖ h0_d] + b_i) ⊙ (W_jᵀ[h ‖ h0_d] + b_j)
//   loss  = Σ_g Σ_o (out_go − y_g)²·gm_g / Σ_g gm_g
//
// bn1d(x) = w·(x − mean)/(sqrt(max(var, 1e-12)) + 1e-5) + b, the stateless
// norm (x − mean)/sqrt(var + 1e-6), with the biased var. Outputs: the
// (mean, var) of every slot (2T, 2, f) — each per-step norm's EMA takes
// exactly one update from its own slot — and the residual stash htil
// (2T, N, f): slots 0..T-1 the masked messages, T..2T-1 the pre-norm GRU
// outputs, which the backward (fused_psteps_bwd.cu) reads instead of
// replaying the forward.
//
// Bound on an H100 SXM: float32 CUDA-core arithmetic on ~1e8 operations
// and a few MB at batch 1024; the grid barriers (T + 3 with every norm on
// batch statistics) and the launch dominate in practice. chip_smoke.py
// counts the bound from the run's shapes.
//
// Design: ONE cooperative launch, the body shared with the serving kernel
// (fused_psteps_common.cuh): all T message slots from one gather of
// h0[src] per edge; the message statistics of all steps from ONE chunk
// pass and one barrier (the messages do not depend on the recurrence);
// then the recurrence on node chunks with a barrier per step for the
// state norm's statistics; per-chunk partials combined in chunk order
// (Chan's formula), no float atomics.

#include "fused_psteps_common.cuh"

namespace {

using namespace mpnn_psteps;

__global__ void __launch_bounds__(kThreads)
fused_psteps_fwd_kernel(PsFwdArgs a) {
  psteps_forward<true>(a);
}

}  // namespace

extern "C" {

int mpnn_fused_psteps_fwd_smem_bytes(int steps) {
  return int(sizeof(float) * fwd_smem_floats(steps));
}

long long mpnn_fused_psteps_fwd_scratch_floats(int n_nodes, int n_graphs,
                                               int steps) {
  return fwd_scratch_floats(n_nodes, n_graphs, steps);
}

int mpnn_fused_psteps_fwd_grid(int steps, int n_nodes, int n_graphs) {
  const int need = max((n_nodes + kChunk - 1) / kChunk,
                       (n_graphs + kWarps - 1) / kWarps);
  return coop_grid(fused_psteps_fwd_kernel,
                   sizeof(float) * fwd_smem_floats(steps), need);
}

int mpnn_fused_psteps_fwd(
    const float* amat, const float* a0, const float* mbias,
    const float* w_ih, const float* w_hh, const float* b_ih,
    const float* b_hh, const float* ma_w, const float* ma_b,
    const float* bn_w, const float* bn_b, const float* ro_iw,
    const float* ro_ib, const float* ro_jw, const float* ro_jb,
    const float* h0, const float* labels, const float* gmask, const int* vid,
    const int* src, const int* edge_order, const int* dst_ptr,
    const int* graph_node_ptr, float* loss, float* out, float* stats,
    float* htil, float* scratch, int n_nodes, int n_graphs, int f, int od,
    int k_vocab, int steps, int msg_mode, int state_mode, int grid,
    void* stream) {
  if (f > FP || od > ODW || steps < 1 || steps > kMaxSteps || grid < 1 ||
      (msg_mode != kNone && msg_mode != kBatchBn) ||
      (state_mode != kNone && state_mode != kBatchBn &&
       state_mode != kStateless))
    return int(cudaErrorInvalidValue);
  PsFwdArgs a{{amat, a0, mbias, w_ih, w_hh, b_ih, b_hh, ma_w, ma_b, bn_w,
               bn_b, ro_iw, ro_ib, ro_jw, ro_jb},
              h0, labels, gmask, vid, src, edge_order, dst_ptr,
              graph_node_ptr, loss, out, stats, htil, scratch,
              n_nodes, n_graphs, f, od, k_vocab, steps, msg_mode,
              state_mode};
  return coop_launch(fused_psteps_fwd_kernel, a,
                     sizeof(float) * fwd_smem_floats(steps), grid, stream);
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
