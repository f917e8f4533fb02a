// Whole-step INFERENCE kernel of the shared-weight edge-network MPNN
// (the flagship `lipo` serving path), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mpnn_tpu/kernels/fused_step.py::_eval_kernel
// (public entry make_fused_eval_op). Same function, per real node d of
// graph g, with every BatchNorm folded to a per-feature affine on the host:
//
//   m_d  = Σ_{e: dst_e = d} A[vid_e]·h0[src_e]  +  A0·S_g  +  mbias,
//          S_g = Σ_{w ∈ g} h0[w]                      (A0 bias leakage)
//   mb_d = ma_scale ⊙ m_d + ma_shift                   (msg norm, folded)
//   gi_d = W_ihᵀ·mb_d + b_ih                           (constant over steps)
//   h    = h0[d];  T × { GRU(gi_d, h);  h = s_scale ⊙ h + s_shift }
//   out_g = Σ_{d ∈ g} softmax_od(W_iᵀ[h ‖ h0_d] + b_i) ⊙ (W_jᵀ[h ‖ h0_d] + b_j)
//
// Design. Both kernels run the training forward's body
// (fused_step_forward.cuh, kTrain = false: no loss, no statistics output,
// no stash). A node is a group of FP lanes, gi = W_ihᵀ·mb + b_ih once a
// node, each block owns whole graphs (a contiguous node range balanced by
// node count) with its tile of node states in shared memory; messages are
// summed in the plan's destination-sorted order with A0·S_g from a
// per-graph sum; the readout's softmax runs over od with lanes over the
// outputs, and one thread writes each output of a graph once.
//
// With the norms folded (fused_eval_kernel) there is no statistic at all:
// nothing crosses blocks, so the launch is plain (no cluster, no flags,
// no counters) with as many blocks as kernels/fused_step.py::
// eval_launch_shape gives it — many small blocks at b16, about one wave
// of the card at b1024. The folded message norm is the body's kAffine
// message mode, the folded state norm its kAffine state mode (the
// identity affine for a norm of 'none').
//
// The STATELESS state norm normalizes by the batch's own per-step mean and
// var (eps 1e-6 inside the sqrt), so a graph's output depends on its batch.
// That mode has a kernel of its own, fused_eval_stateless_kernel, on the
// training forward's routes: the per-step statistics from block partials
// combined in block order (one cluster, or co-resident blocks through
// per-launch counters), no grid barrier, no float atomics.
//
// Bound on an H100 SXM: f32 CUDA-core arithmetic (no tensor-core shape
// fits f = 10); at the flagship batch of 1024 molecules the work is
// ~1e8 flop against ~1 MB of traffic, so operations bound it (67 TFLOP/s
// f32) and launch latency dominates in practice. chip_smoke.py recounts
// the bound from the run's own shapes.

#include <cuda_runtime.h>
#include <math.h>

#include "fused_step_forward.cuh"

namespace {

using namespace mpnn_step;

// The folded kernel's blocks never wait on each other: two a multiprocessor
// in the narrow buckets (registers held to 128), one past FP 16.
constexpr int kEvalMinBlocks = FP <= 16 ? 2 : 1;

__global__ void __launch_bounds__(kFT, kEvalMinBlocks)
fused_eval_kernel(FwdArgs a) {
  step_forward<false>(a);
}

__global__ void __launch_bounds__(kFT, 1)
fused_eval_stateless_kernel(FwdArgs a) {
  step_forward<false>(a);
}

}  // namespace

extern "C" {

// The folded-norm serving kernel: its dynamic shared memory in bytes at
// node capacity ncap and edge capacity ecap, its scratch in floats for a
// launch of `grid` blocks, and its co-resident blocks at `bytes` (0 on
// error).
int mpnn_fused_eval_smem_bytes(int k_vocab, int steps, int ncap, int ecap) {
  return int(mpnn_step::fwd_smem_bytes(k_vocab, steps, ncap, ecap, 1));
}

long long mpnn_fused_eval_scratch_floats(int n_nodes, int n_edges,
                                         int n_graphs, int steps, int grid) {
  return (long long)mpnn_step::Scratch(n_nodes, n_edges, n_graphs, steps,
                                       grid).total;
}

int mpnn_fused_eval_max_grid(int bytes) {
  return mpnn_step::forward_max_grid(fused_eval_kernel, bytes);
}

// Launches the folded-norm serving kernel on `stream` (`grid` blocks of
// the free route) and returns the launch's error code (0 = success).
// ma_scale, ma_shift and s_scale, s_shift: the folded message and state
// norms (the identity for none). ncap, ecap: a block's tile; floor and
// prof as mpnn_fused_step_fwd's. Does not synchronize and allocates
// nothing.
int mpnn_fused_eval(const float* amat, const float* a0, const float* mbias,
                    const float* h0, const float* w_ih, const float* w_hh,
                    const float* b_ih, const float* b_hh,
                    const float* ma_scale, const float* ma_shift,
                    const float* s_scale, const float* s_shift,
                    const float* ro_iw, const float* ro_ib,
                    const float* ro_jw, const float* ro_jb,
                    const int* vid, const int* src, const int* edge_order,
                    const int* dst_ptr, const int* graph_node_ptr,
                    float* out, float* scratch, long long* prof, int n_nodes,
                    int n_graphs, int n_edges, int f, int od, int k_vocab,
                    int steps, int grid, int ncap, int ecap, int floor,
                    void* stream) {
  using namespace mpnn_step;
  FwdArgs a{{amat, a0, mbias, w_ih, w_hh, b_ih, b_hh, ma_scale, ma_shift,
             s_scale, s_shift, ro_iw, ro_ib, ro_jw, ro_jb},
            h0, nullptr, nullptr, vid, src, edge_order, dst_ptr,
            graph_node_ptr, nullptr, out, nullptr, nullptr, scratch,
            nullptr, prof, n_nodes, n_graphs, n_edges, f, od, k_vocab, steps,
            kAffine, kAffine, kRouteFree, 1, ncap, ecap, floor};
  if (const int err = check_route(a, grid)) return err;
  return launch_forward(fused_eval_kernel, a, grid, stream);
}

// The serving kernel of the stateless state norm: its dynamic shared
// memory in bytes at node capacity ncap and edge capacity ecap in a
// launch of `blocks` blocks, its scratch in floats and its co-resident
// blocks (0 on error); its routes and flags are the training forward's
// (fused_step_forward.cuh).
int mpnn_fused_eval_stateless_smem_bytes(int k_vocab, int steps, int ncap,
                                         int ecap, int blocks) {
  return int(mpnn_step::fwd_smem_bytes(k_vocab, steps, ncap, ecap, blocks));
}

long long mpnn_fused_eval_stateless_scratch_floats(int n_nodes, int n_edges,
                                                   int n_graphs, int steps,
                                                   int grid) {
  return (long long)mpnn_step::Scratch(n_nodes, n_edges, n_graphs, steps,
                                       grid).total;
}

int mpnn_fused_eval_stateless_max_grid(int bytes) {
  return mpnn_step::forward_max_grid(fused_eval_stateless_kernel,
                                     bytes);
}

// Launches the stateless-norm serving kernel on `stream` and returns the
// launch's error code. msg_mode is kNone or kAffine (ma_scale, ma_shift:
// the folded eval bn1d). route, grid, counters, ncap, ecap, floor and
// prof as mpnn_fused_step_fwd's. Does not synchronize and allocates
// nothing.
int mpnn_fused_eval_stateless(
    const float* amat, const float* a0, const float* mbias, const float* h0,
    const float* w_ih, const float* w_hh, const float* b_ih,
    const float* b_hh, const float* ma_scale, const float* ma_shift,
    const float* ro_iw, const float* ro_ib, const float* ro_jw,
    const float* ro_jb, const int* vid, const int* src,
    const int* edge_order, const int* dst_ptr, const int* graph_node_ptr,
    float* out, float* scratch, int* counters, long long* prof, int n_nodes,
    int n_graphs, int n_edges, int f, int od, int k_vocab, int steps,
    int msg_mode, int route, int grid, int ncap, int ecap, int floor,
    void* stream) {
  using namespace mpnn_step;
  if (msg_mode != kNone && msg_mode != kAffine)
    return int(cudaErrorInvalidValue);
  FwdArgs a{{amat, a0, mbias, w_ih, w_hh, b_ih, b_hh, ma_scale, ma_shift,
             nullptr, nullptr, ro_iw, ro_ib, ro_jw, ro_jb},
            h0, nullptr, nullptr, vid, src, edge_order, dst_ptr,
            graph_node_ptr, nullptr, out, nullptr, nullptr, scratch,
            counters, prof, n_nodes, n_graphs, n_edges, f, od, k_vocab, steps,
            msg_mode, kStateless, route, route == kRouteCluster ? grid : 1,
            ncap, ecap, floor};
  if (const int err = check_route(a, grid)) return err;
  return launch_forward(fused_eval_stateless_kernel, a, grid, stream);
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
