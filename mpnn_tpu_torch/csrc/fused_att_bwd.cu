// Message + GRU backward of the collapsed attention family (the `adv`
// model), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mpnn_tpu/kernels/fused_att.py::_att_bwd_kernel
// (the VJP of make_fused_att_op). Given gh = ∂L/∂h and the forward's
// messages, per node v (graph g, in-edges e with src u, vocab id k):
//
//   GRU VJP            → ∂msg_v = dm_v, ∂h0[v] (hidden path), the GRU leaves
//   per in-edge e      gate_e, g_e = gate_e ⊙ h0[u] recomputed;
//                      dg = A'[k]ᵀ·dm_v;  dA'[k] += dm_v ⊗ g_e;
//                      dz_e = gate_e ⊙ (dg ⊙ h0[u] − Σ dg ⊙ h0[u] ⊙ gate_e)
//                      (softmax VJP); dqv[k] += dz_e; ∂h0[u] += dg ⊙ gate_e
//   'att' correction   A0·(g0_v ⊙ X_v), X_v = S_g − Σ_e h0[u]:
//                      dA0 += dm_v ⊗ (g0_v ⊙ X_v); dX = (A0ᵀ·dm_v) ⊙ g0_v
//                      reaches every node of g (through S_g) and, with a
//                      minus sign, each in-edge's source; dz0_v, the softmax
//                      VJP of g0_v, gives dq0 and ∂h0[v] through Wh
//   ∂Wh = Σ_v h0[v] ⊗ (Σ_e dz_e + dz0_v),  ∂h0[v] += Wh·(Σ_e dz_e + dz0_v)
//
// The function is the att model's T-step backward (fused_att_steps_bwd.cu)
// at T 1, one message network and no state norm, and so is the code: this
// source builds att_steps_bwd.cuh's body for that case alone
// (MPNN_ATT_ONE_STEP). A node is a group of lanes, a block of 256 threads
// owns whole graphs (a contiguous node range, balanced by node count) and
// keeps their walk state in a shared-memory tile (its region of global
// scratch when they outgrow it); the reverse chain is one GRU VJP a node;
// the message VJP runs on the block's edges as one tile in the plan's
// destination order, the A' tables staged in shared memory; ∂A' and ∂qv are
// sums over each vocab id's run of positions in the block's vocab order;
// a source node sums its out-edges' rows in source order; the 'att'
// correction's graph sums S_g are two floats. Nothing but the weight
// gradients crosses blocks, so the blocks wait on no other block (the
// free route: any number of them in a plain launch, no cluster, no flag);
// their gradient rows are summed in block order by the last block of each
// counter group (integer counters the blocks reset), then the last
// group's last block. No grid barrier, no cooperative launch, no memset,
// no float atomics; every sum runs in a fixed order, so a launch gives the
// same bits on every run of the same grid.
//
// Bound on an H100: ~4× the forward's operations per edge and the inputs
// read once; microseconds of work at batch 1,024 (chip_smoke.py::
// _att_bounds counts it).

#define MPNN_ATT_ONE_STEP 1
#include "att_steps_bwd.cuh"

namespace {

__global__ void __launch_bounds__(kBT, 1)
fused_att_bwd_kernel(BwdArgs a) {
  att_bwd_block(a);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block at node capacity ncap and edge
// capacity ecap, in bytes (kernels/fused_att.py::bwd_smem_floats mirrors
// it).
int mpnn_fused_att_bwd_smem_bytes(int k_vocab, int ncap, int ecap) {
  return int(smem_bytes(1, k_vocab, 1, ncap, ecap));
}

// The 10 offsets of the flat gradient layout, total last: the T-step
// layout at one message network (aprime, a0, qv, q0, wh, w_ih, w_hh,
// b_ih, b_hh; kernels/fused_att.py::grad_layout).
void mpnn_fused_att_bwd_layout(int k_vocab, int f, int* out) {
  const AttsGradLayout g(1, k_vocab, f);
  const int v[10] = {g.a, g.a0, g.qv, g.q0, g.wh, g.wih, g.whh, g.bih,
                     g.bhh, g.total};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
}

long long mpnn_fused_att_bwd_scratch_floats(int n_nodes, int n_edges,
                                            int k_vocab, int f, int grid) {
  return (long long)Scratch(n_nodes, n_edges, k_vocab, f, 1, 1, grid).total;
}

// The integer counters of the final sum (one buffer per device and
// stream, zeroed once; every launch leaves them zero).
int mpnn_fused_att_bwd_counters() { return kMaxGroups + 1; }

// The blocks an H100 holds at once at this shared memory, capped at
// kMaxGrid; 0 on error.
int mpnn_fused_att_bwd_max_grid(int bytes) {
  return max_grid(fused_att_bwd_kernel, bytes);
}

// Launches `grid` independent blocks (at most kMaxGrid) on `stream` and
// returns the launch's error code (0 = success). ncap, ecap: the node and
// edge capacity of a block's shared memory; counters: null for one block,
// else mpnn_fused_att_bwd_counters ints. floor != 0 launches the empty
// walk (the same grid and final sum; dw gets zeros). prof: null or
// kProfSlots int64 clock64 stamps of block 0.
int mpnn_fused_att_bwd(
    const float* aprime, const float* a0, const float* qv, const float* q0,
    const float* wh, const float* w_ih, const float* w_hh, const float* b_ih,
    const float* b_hh, const float* h0, const float* msgs, const float* gh,
    const int* vid, const int* src, const int* dst, const int* edge_order,
    const int* dst_ptr, const int* src_pos, const int* src_ptr,
    const int* graph_node_ptr, float* dh0, float* dw, float* scratch,
    int* counters, long long* prof, int n_nodes, int n_graphs, int n_edges,
    int f, int k_vocab, int with_corr, int grid, int ncap, int ecap,
    int floor, void* stream) {
  if (f < 1 || f > FP || k_vocab < 1 || k_vocab > kMaxVocab ||
      n_graphs < 1 || grid < 1 || grid > kMaxGrid || ncap < 1 || ecap < 0 ||
      (grid > 1 && !counters))
    return int(cudaErrorInvalidValue);
  BwdArgs a{{aprime, a0, qv, q0, wh, w_ih, w_hh, b_ih, b_hh},
            h0, msgs, nullptr, nullptr, gh, vid, src, dst, edge_order,
            dst_ptr, src_pos, src_ptr, graph_node_ptr, dh0, dw, scratch,
            nullptr, counters, prof, n_nodes, n_graphs, n_edges, f, k_vocab,
            1, 1, with_corr, 0, kRouteFree, ncap, ecap, floor};
  const size_t bytes = smem_bytes(1, k_vocab, 1, ncap, ecap);
  cudaError_t err = cudaFuncSetAttribute(
      fused_att_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (err != cudaSuccess) return int(err);
  fused_att_bwd_kernel<<<grid, kBT, bytes,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
