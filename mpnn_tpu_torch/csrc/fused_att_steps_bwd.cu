// T-step message + GRU + stateless-norm backward of the attention model
// `att`, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mpnn_tpu/kernels/fused_att.py::
// _att_steps_bwd_kernel (the VJP of make_fused_att_steps_op). Given
// gh = ∂L/∂h_T and the forward's residuals (the Tm masked message slots,
// the T pre-norm states h̃_t, each step's mean and var):
//
//   reverse chain, t = T−1..0:
//     stateless-norm VJP with d = s = sqrt(var_t + 1e-6), x̂ = (h̃_t − mean)/d
//       and the batch sums S1 = Σ g, S2 = Σ g·x̂ over every real node:
//       ∂h̃_t = (g − S1/c)/d − x̂·S2/(c·s)                  (g when no norm)
//     GRU VJP → ∂h_{t−1} (the next g; at t = 0, ∂h0's hidden path),
//       ∂W_ih, ∂W_hh, ∂b_ih, ∂b_hh, and ∂m summed into slot min(t, Tm−1)
//   per message step t, per node v (graph g, in-edges e: src u, vocab k):
//     dm = ∂m_t[v];  dg_e = A'_t[k]ᵀ·dm;  ∂A'_t[k] += dm ⊗ (gate_e ⊙ h0[u]);
//     dz_e = gate_e ⊙ (dg_e ⊙ h0[u] − Σ dg_e ⊙ h0[u] ⊙ gate_e) (softmax VJP)
//       → ∂qv_t[k];  ∂h0[u] += dg_e ⊙ gate_e
//     'att' correction A0_t·(g0_v ⊙ X_v), X_v = S_g − Σ_e h0[u]:
//       ∂A0_t += dm ⊗ (g0_v ⊙ X_v); dX = (A0_tᵀ·dm) ⊙ g0_v reaches every
//       node of g (through S_g) and, negated, each in-edge's source; dz0_v
//       (the softmax VJP of g0_v) → ∂q0_t
//     ∂Wh_t += h0[v] ⊗ (Σ_e dz_e + dz0_v);  ∂h0[v] += Wh_t·(Σ_e dz_e + dz0_v)
//
// Design (walk_bwd.cuh, as the per-step family's fused_psteps_bwd.cu). A
// node is a GROUP of FP lanes, one feature a lane; a block of 256 threads
// owns whole graphs (a contiguous node range, balanced by node count).
// Messages flow only inside a graph, so the message VJP of every step is
// block-local: nothing of it crosses blocks but the weight gradients.
//   * The reverse chain keeps each node's walk state (∂h, ∂h0, h0, each
//     message slot's ∂m) in a shared-memory tile for the whole launch; a
//     lane keeps its columns of ∂W_hh and ∂W_ih in registers at FP 16 (at
//     FP 32 a round's rows are staged and summed an element a thread). The
//     transposed products are reduce-scatters over the group. Each step's
//     batch sums (S1, S2 and Σx̂, by which x̂ is centred on its batch mean)
//     of the NEXT slot are summed in the same pass, then combined across
//     the blocks without a grid barrier: through distributed shared memory
//     in one thread-block cluster of 1-8 blocks, or on a grid of
//     co-resident blocks through per-round flags that carry the launch's
//     tag. The batch mean S1/c, as two floats, is taken out of each node's
//     cotangent before the scaling, so its rounding does not add up over a
//     large batch.
//   * The message VJP of each step runs on sddmm_common.cuh's edge tiles:
//     the block's edges are its tile (a block owns whole graphs, so no
//     destination row crosses blocks), in the plan's destination order, a
//     group of G lanes (8, 16 or 32: the narrowest that holds f) an edge,
//     two edges a group a round: the gate (edge_gate on Wh_t and qv_t),
//     dg from A'_t staged in shared memory (when K·FP·FP fits, else read
//     from device memory; the next step's staged behind this one), the
//     softmax's VJP. A node pass, a group a node, then sums its in-edges'
//     dz in destination order, applies the correction and Wh_t (staged
//     transposed). ∂A'_t and ∂qv_t are sums over each vocab id's edges in
//     the block's vocab order (a stable counting sort per block; an
//     edge's gate row is written at its position in that order): a group
//     a run of consecutive positions, its ids' rows in registers, an id
//     that crosses runs summed from the runs' rows in run order (an
//     element a thread over the id's edges where those rows outgrow the
//     reduction scratch). A source node sums its out-edges' rows in
//     source order.
//   * The blocks' gradient rows are summed in block order: by the last
//     block of each counter group (an integer counter the block resets)
//     on the grid route, by rank-owned column chunks in the cluster. No
//     cooperative launch, no grid barrier, no memset, no float atomics;
//     the grid route's blocks are at most the card's co-resident ones.
//   A block whose graphs outgrow its tile keeps them in its region of
//   global scratch instead (the same code).
//
// Numerics: float32 FMA (the norm's mean as two floats). Every cross-thread
// sum runs in a fixed order (groups, then warps, then blocks or ranks), so
// a launch gives the same bits on every run of the same route.
//
// Bound on an H100: about twice the forward's operations on the same rows
// and the stash read once (chip_smoke.py::_atts_bounds counts it).

#include "att_steps_bwd.cuh"

namespace {

__global__ void __launch_bounds__(kBT, 1)
fused_att_steps_bwd_kernel(BwdArgs a) {
  att_bwd_block(a);
}

// Launch on `route`: one cluster of `grid` blocks, or `grid` blocks in a
// plain launch. The grid route's blocks wait on each other's flags, so it
// refuses (cudaErrorCooperativeLaunchTooLarge) a grid past the blocks
// that fit the card together at this launch's shared memory; it also
// needs the card to itself (a kernel on another stream holding SMs could
// keep a block from starting while the others wait).
int launch(const BwdArgs& a, int grid, size_t bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_att_steps_bwd_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  if (a.route == kRouteGrid && grid > 1) {
    // the occupancy query once per shared-memory size
    static int seen_bytes = -1, most = 0;
    if (int(bytes) != seen_bytes) {
      most = max_grid(fused_att_steps_bwd_kernel, int(bytes));
      seen_bytes = int(bytes);
    }
    if (grid > most) return int(cudaErrorCooperativeLaunchTooLarge);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kBT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.route == kRouteCluster && grid > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, fused_att_steps_bwd_kernel, a);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block at node capacity ncap and edge
// capacity ecap, in bytes (kernels/fused_att_steps.py::bwd_smem_floats
// mirrors it).
int mpnn_fused_att_steps_bwd_smem_bytes(int tm, int k_vocab, int steps,
                                        int ncap, int ecap) {
  return int(smem_bytes(tm, k_vocab, steps, ncap, ecap));
}

// The 10 offsets of the flat gradient layout (AttsGradLayout), total last.
void mpnn_fused_att_steps_bwd_layout(int tm, int k_vocab, int f, int* out) {
  const AttsGradLayout g(tm, k_vocab, f);
  const int v[10] = {g.a, g.a0, g.qv, g.q0, g.wh, g.wih, g.whh, g.bih,
                     g.bhh, g.total};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
}

long long mpnn_fused_att_steps_bwd_scratch_floats(int n_nodes, int n_edges,
                                                  int k_vocab, int f,
                                                  int steps, int tm,
                                                  int grid) {
  return (long long)Scratch(n_nodes, n_edges, k_vocab, f, steps, tm, grid)
      .total;
}

// The flag and counter words of the grid route (one buffer each per
// stream, zeroed once): u64 flags, int counters.
int mpnn_fused_att_steps_bwd_sync_words(int* counters) {
  *counters = kMaxGroups + 1;
  return kFlagWords;
}

// The co-resident blocks at this shared memory, capped at kMaxGrid; 0 on
// error.
int mpnn_fused_att_steps_bwd_max_grid(int bytes) {
  return max_grid(fused_att_steps_bwd_kernel, bytes);
}

// Launches on `stream` and returns the launch's error code (0 = success).
// route 0: one cluster of `grid` blocks (1, 2, 4 or 8); route 1: `grid`
// co-resident blocks with `flags` and `counters`. ncap, ecap: the node and
// edge capacity of a block's shared memory. floor != 0 launches the empty
// walk (the same grid, combines and final sum; dw gets zeros). prof: null
// or kProfSlots int64 clock64 stamps of block 0.
int mpnn_fused_att_steps_bwd(
    const float* aprime, const float* a0, const float* qv, const float* q0,
    const float* wh, const float* w_ih, const float* w_hh, const float* b_ih,
    const float* b_hh, const float* h0, const float* msgs, const float* htil,
    const float* stats, const float* gh, const int* vid, const int* src,
    const int* dst, const int* edge_order, const int* dst_ptr,
    const int* src_pos, const int* src_ptr, const int* graph_node_ptr,
    float* dh0, float* dw, float* scratch, unsigned long long* flags,
    int* counters, long long* prof, int n_nodes, int n_graphs, int n_edges,
    int f, int k_vocab, int steps, int tm, int with_corr, int stateless,
    int route, int grid, int ncap, int ecap, int floor, void* stream) {
  if (f < 1 || f > FP || k_vocab < 1 || k_vocab > kMaxVocab || steps < 1 ||
      steps > kMaxSteps || (tm != steps && tm != 1) || n_graphs < 1 ||
      grid < 1 || ncap < 1 || ecap < 0 ||
      (route == kRouteCluster &&
       (grid != 1 && grid != 2 && grid != 4 && grid != 8)) ||
      (route == kRouteGrid &&
       (grid > kMaxGrid || (grid > 1 && (!flags || !counters)))) ||
      (route != kRouteCluster && route != kRouteGrid))
    return int(cudaErrorInvalidValue);
  BwdArgs a{{aprime, a0, qv, q0, wh, w_ih, w_hh, b_ih, b_hh},
            h0, msgs, htil, stats, gh, vid, src, dst, edge_order, dst_ptr,
            src_pos, src_ptr, graph_node_ptr, dh0, dw, scratch,
            route == kRouteGrid ? flags : nullptr,
            route == kRouteGrid ? counters : nullptr, prof, n_nodes,
            n_graphs, n_edges, f, k_vocab, steps, tm, with_corr, stateless,
            route, ncap, ecap, floor};
  return launch(a, grid, smem_bytes(tm, k_vocab, steps, ncap, ecap), stream);
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
