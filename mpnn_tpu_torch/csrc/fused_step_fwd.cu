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
// Design: a node on a group of lanes, its gates and state on chip, each
// block owning whole graphs; only the per-step batch statistics and the
// loss cross blocks (one cluster through distributed shared memory, or
// co-resident blocks through per-launch flags); no grid barrier. The body,
// its routes and combines are in fused_step_forward.cuh, which the serving
// kernel of the stateless norm (fused_eval.cu) shares.
//
// Bound on an H100 SXM: f32 CUDA-core arithmetic on ~1e8 flop and a few
// MB of traffic at batch 1024; in practice the launch, the staging and
// the per-step combines (a dependent round trip each) dominate;
// chip_smoke.py recounts the bound from the run's shapes.

#include "fused_step_forward.cuh"

namespace {

using namespace mpnn_step;

__global__ void __launch_bounds__(kFT, 1)
fused_step_fwd_kernel(FwdArgs a) {
  step_forward<true>(a);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block at node capacity ncap and edge
// capacity ecap in a launch of `blocks` blocks, in bytes
// (kernels/fused_step.py::fwd_smem_floats mirrors it).
int mpnn_fused_step_fwd_smem_bytes(int k_vocab, int steps, int ncap,
                                   int ecap, int blocks) {
  return int(fwd_smem_bytes(k_vocab, steps, ncap, ecap, blocks));
}

// Floats of scratch the launch needs (spilled tiles, partial rows, the
// per-graph loss terms).
long long mpnn_fused_step_fwd_scratch_floats(int n_nodes, int n_edges,
                                             int n_graphs, int steps,
                                             int grid) {
  return (long long)Scratch(n_nodes, n_edges, n_graphs, steps, grid).total;
}

// The integer counters of the grid route (one buffer per stream, zeroed
// once; every launch leaves them zero; the serving kernel takes the same).
int mpnn_fused_step_fwd_counters() { return kCounters; }

// The co-resident blocks of the grid route at this shared memory, capped
// at kMaxGrid; 0 on error.
int mpnn_fused_step_fwd_max_grid(int bytes) {
  return forward_max_grid(fused_step_fwd_kernel, bytes);
}

// Launches on `stream` and returns the launch's error code (0 = success).
// Does not synchronize and allocates nothing. msg_mode in {kNone,
// kBatchBn}, state_mode in {kNone, kBatchBn, kStateless}
// (fused_train_common.cuh::Mode). route 0: one cluster of `grid` blocks
// (1, 2, 4 or 8); route 1: `grid` co-resident blocks with `counters`
// (mpnn_fused_step_fwd_counters ints). ncap, ecap: the node and edge
// capacity of a block's shared memory. floor != 0 launches the empty
// forward (the same grid and combines; loss, stats 0). prof: null or
// kProfSlots int64 clock64 stamps of block 0.
int mpnn_fused_step_fwd(
    const float* amat, const float* a0, const float* mbias, const float* h0,
    const float* w_ih, const float* w_hh, const float* b_ih,
    const float* b_hh, const float* ma_w, const float* ma_b,
    const float* bn_w, const float* bn_b, const float* ro_iw,
    const float* ro_ib, const float* ro_jw, const float* ro_jb,
    const float* labels, const float* gmask, const int* vid, const int* src,
    const int* edge_order, const int* dst_ptr, const int* graph_node_ptr,
    float* loss, float* out, float* stats, float* htil, float* scratch,
    int* counters, long long* prof, int n_nodes, int n_graphs, int n_edges,
    int f, int od, int k_vocab, int steps, int msg_mode, int state_mode,
    int route, int grid, int ncap, int ecap, int floor, void* stream) {
  if ((msg_mode != kNone && msg_mode != kBatchBn) ||
      (state_mode != kNone && state_mode != kBatchBn &&
       state_mode != kStateless))
    return int(cudaErrorInvalidValue);
  FwdArgs a{{amat, a0, mbias, w_ih, w_hh, b_ih, b_hh, ma_w, ma_b, bn_w,
             bn_b, ro_iw, ro_ib, ro_jw, ro_jb},
            h0, labels, gmask, vid, src, edge_order, dst_ptr,
            graph_node_ptr, loss, out, stats, htil, scratch, counters, prof,
            n_nodes, n_graphs, n_edges, f, od, k_vocab, steps, msg_mode,
            state_mode, route, route == kRouteCluster ? grid : 1, ncap, ecap,
            floor};
  if (const int err = check_route(a, grid)) return err;
  return launch_forward(fused_step_fwd_kernel, a, grid, stream);
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
