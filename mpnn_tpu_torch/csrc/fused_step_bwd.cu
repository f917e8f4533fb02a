// Whole-step TRAINING backward of the shared-weight edge-network MPNN (the
// flagship `lipo` training path and the basic shell), hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel mpnn_tpu/kernels/fused_step.py::_full_bwd_kernel
// (the VJP of make_fused_step_op, with the reverse walk of
// kernels/recurrence.py::vmem_reverse_walk inlined). Given the cotangents
// gl of the loss and gout of out, and the forward's residuals (htil, the
// per-slot batch statistics, out), it computes every gradient leaf:
//
//   dout  = gl·2(out − y)·gm/Σgm + gout
//   readout VJP per node (softmax over od) → ∂h_T, ∂h0, ∂W_i, ∂W_j, ∂b
//   for t = T..1: masked-norm VJP with the batch sums S1 = Σ dx̂,
//                 S2 = Σ dx̂·x̂ of slot t (closed form,
//                 dx = (dx̂ − S1/c)/d − x̂·S2/(c·s); bn1d: dx̂ = w·∂y,
//                 d = s + 1e-5; the stateless norm: dx̂ = ∂y, d = s =
//                 sqrt(var + 1e-6)); GRU VJP → ∂h_{t−1}, ∂W_hh, ∂b_hh
//                 (b_hh's n part sees r·∂n), and da_t = ∂(the input gates)
//   then once:    ∂mb = W_ihᵀ·Σ_t da_t, ∂W_ih = Σ_nodes mb ⊗ Σ_t da_t,
//                 ∂b_ih = Σ Σ_t da_t (the input gates gi = W_ih·mb + b_ih
//                 are the same in every step: computed once per node)
//   message-BN VJP (batch sums of slot 0) → ∂m
//   dA0 = Σ_g (Σ_{v∈g} ∂m_v) ⊗ S_g;  ∂h0_v += A0ᵀ·Σ_{w∈g(v)} ∂m_w for
//   EVERY node of the graph (bias leakage), + Σ_{e: src_e = v}
//   A[vid_e]ᵀ·∂m_{dst_e};  dA[k] = Σ_{e: vid_e = k} ∂m_{dst_e} ⊗ h0_{src_e};
//   ∂mbias = Σ ∂m; under the message bn1d (Σ ∂m = 0) dA0 −= ∂mbias ⊗ S̄,
//   S̄ the mean over the real nodes of their graph's S (center_da0).
//
// Design. A node is a GROUP of FP lanes, one feature a lane (two nodes a
// warp at FP 16, one at FP 32); a block of 256 threads holds NG groups.
// Each block owns whole graphs (a contiguous node range, balanced by node
// count), so the message VJP and dA are block-local; the per-node state of
// the walk (gi, Σ_t da_t, ∂h, x̂, h0) stays in shared memory for the whole
// launch, and each step's htil rows are staged one step ahead with
// cp.async. A lane's dot products take the other features by shuffles
// within the group; the transposed products (W_hhᵀ·da, W_ihᵀ·Σda, the
// readout's W_iᵀ·dpi) are reduce-scatters over the group's lanes. A lane
// accumulates its column of ∂W_hh and ∂W_ih in registers over its nodes;
// the readout weights' gradient is a register-tiled outer product over
// staged node rows; dA walks the block's edges in vocab order (a stable
// counting sort per block, one segment per id).
//
// Routes (kernels/fused_step.py::launch_shape decides on the host, from
// shapes alone):
//   * cluster: one thread-block cluster of C = 1, 2, 4 or 8 blocks (small
//     batches). The batch sums S1, S2 of each step are summed per block,
//     then across the cluster in rank order through distributed shared
//     memory; the weight-gradient rows are summed in rank order, a column
//     chunk per block. No grid barrier, no cooperative launch.
//   * grid: up to the co-resident blocks (a cooperative launch, for
//     co-residency only: no grid barrier). A block publishes each
//     step's partial row and a flag carrying this launch's tag; every
//     block reads all partial rows of the step in block order. The last
//     block of each group of blocks (an integer counter that the block
//     resets) sums its group's weight-gradient rows in block order, and
//     the last group's last block sums the group rows: the final sum is
//     a fixed-order pass with no barrier and no memset before the launch.
//   A block whose graphs do not fit its shared-memory node tile keeps that
//   state in its region of global scratch instead (the same code).
//
// Numerics: float32 FMA only; no float atomics. Every cross-thread sum
// runs in a fixed order (groups, then warps, then blocks or ranks), so a
// batch gives the same bits in every run of the same route. The order
// differs from the plain version's: Σ_t da_t is summed before W_ih's two
// products (which the plain version applies per step), the batch sums go
// group → warp → block → rank or block.
//
// Bound on an H100 SXM: f32 CUDA-core arithmetic (chip_smoke.py
// _step_bounds counts W_ih's products once, as this kernel runs them).

#include "walk_bwd.cuh"

namespace {

using namespace mpnn_train;
using namespace mpnn_walk;

// Flat layout of the gradient output (and of each block's partial row):
// real (unpadded) shapes, in this order. kernels/fused_step.py::grad_layout
// mirrors it and checks it against mpnn_fused_step_bwd_layout.
struct GradLayout {
  int a, a0, mbias, wih, whh, bih, bhh, maw, mab, bnw, bnb, riw, rib, rjw,
      rjb, total;
  __host__ __device__ GradLayout(int k, int f, int od) {
    a = 0;
    a0 = a + k * f * f;
    mbias = a0 + f * f;
    wih = mbias + f;
    whh = wih + 3 * f * f;
    bih = whh + 3 * f * f;
    bhh = bih + 3 * f;
    maw = bhh + 3 * f;
    mab = maw + f;
    bnw = mab + f;
    bnb = bnw + f;
    riw = bnb + f;
    rib = riw + 2 * f * od;
    rjw = rib + od;
    rjb = rjw + 2 * f * od;
    total = rjb + od;
  }
};

// the grid route's flags: a row a round (slots 0..T), the tag last
constexpr int kFlagWords = flag_words(kMaxSteps + 1);
// W_hh's column a lane: in registers at FP 16, read from shared memory
// at FP 32 (192 registers of weights and gradients would spill)
constexpr bool kWReg = FP <= 16;
// the readout: outputs a lane (contiguous), nodes a group stages a round,
// the staged row [h | h0 | 1 0 0 0 | dpi (ODP) | djv (ODP)]
constexpr int QO = ODP >= GS ? ODP / GS : 1;
constexpr int kRoR = 2;
constexpr int kXW = 2 * FP + 4;
constexpr int kRS = kXW + 2 * ODP;
constexpr int kRoRows = NG * kRoR;
// its weight-gradient tiles: 4 rows of x by 4 outputs, (gate|value) ×
// k-blocks × o-blocks; depth (the staged rows) split over idle threads
constexpr int kKB = kXW / 4;
constexpr int kOB = ODP / 4;
constexpr int kNT = 2 * kKB * kOB;
constexpr int kDS = kNT >= kBT ? 1 : kBT / kNT;
constexpr int kTPT = kDS > 1 ? 1 : (kNT + kBT - 1) / kBT;
// per-node state (floats): gi r|z|n, Σ_t da r|z|n, ∂h, x̂, h0, ∂h0 (its
// readout, step-1 and message parts, written out once). After the walk
// the gi part holds ∂mb, x̂ of the messages and ∂m.
constexpr int kGi = 0, kSda = 3 * FP, kGh = 6 * FP, kXh = 7 * FP,
              kH0 = 8 * FP, kD0 = 9 * FP, SS = 10 * FP;
constexpr int kDmb = 0, kX0 = FP, kDm = 2 * FP;
static_assert(ODP % GS == 0 || ODP < GS, "outputs a lane");
static_assert(QO == 1 || QO == 2 || QO == 4, "1, 2 or 4 outputs a lane");

struct BwdArgs {
  Weights w;
  const float* h0;          // (N, f), pre-masked
  const float* labels;      // (G)
  const float* gmask;       // (G)
  const float* out;         // (G, od) forward output
  const float* gout;        // (G, od) cotangent of out
  const float* gl;          // (1) cotangent of the loss
  const float* htil;        // (T + 1, N, f) forward residuals
  const float* stats;       // (T + 1, 2, f) forward batch statistics
  const int* vid;           // (E)
  const int* src;           // (E)
  const int* dst;           // (E)
  const int* src_order;     // (E) edge ids, stably sorted by source
  const int* src_ptr;       // (N + 1) row pointers into src_order
  const int* graph_node_ptr;  // (G + 1)
  const int* node_graph;    // (N)
  float* dh0;               // (N, f)
  float* dw;                // GradLayout(K, f, od).total
  float* scratch;           // scratch_floats(...)
  unsigned long long* flags;  // grid route: kFlagWords, zero once
  int* counters;            // grid route: kMaxGroups + 1, zero between launches
  long long* prof;          // null, or kProfSlots clock64 stamps (block 0)
  // msg_mode in {kNone, kBatchBn}, state_mode in {kNone, kBatchBn,
  // kStateless} (fused_train_common.cuh::Mode)
  int n_nodes, n_graphs, n_edges, f, od, k_vocab, steps, msg_mode,
      state_mode;
  int route, cluster, ncap, ecap, floor;
};

// ---------------------------------------------------------------------------
// shared memory and scratch layouts
// ---------------------------------------------------------------------------

// Offsets (floats) of one block's shared memory past the staged weights
// and norm constants (L::after_stats).
struct Smem {
  int tot, cpart, misc, red, tile, ints, sb, state, total;
  __host__ __device__ Smem(int k_vocab, int steps, int ncap, int ecap) {
    int off = al4(L::after_stats(k_vocab, steps));
    tot = off;            off += 4 * FP;
    cpart = off;          off += al4((steps + 1) * 2 * FP);
    misc = off;           off += 4;
    red = off;            off += kRed;
    tile = off;           off += kRoRows * kRS;
    // ints: node graphs (ncap), source pointers (ncap + 1), edges (4 ints
    // each), the sorted edge list, per-warp vocab counts, segment starts
    ints = off;
    off += al4(ncap + ncap + 1 + 5 * ecap + (kWB + 1) * k_vocab + 1);
    sb = off;             off += 2 * ncap * FP;
    state = off;          off += ncap * SS;
    total = off;
  }
};

size_t smem_bytes(int k_vocab, int steps, int ncap, int ecap) {
  return sizeof(float) * size_t(Smem(k_vocab, steps, ncap, ecap).total);
}

// Offsets (floats) of the global scratch.
struct Scratch {
  size_t state, ints, cparts, rows, gparts, total;
  __host__ __device__ Scratch(int n, int e, int k, int f, int od, int steps,
                              int grid) {
    const size_t nw = GradLayout(k, f, od).total;
    size_t off = 0;
    state = off;   off += size_t(n) * SS;            // spilled blocks' tiles
    // node graphs (n), source pointers (n + a slot a block), edges
    ints = off;    off += size_t(2 * n + grid + 1) + 5 * size_t(e);
    cparts = off;  off += size_t(steps + 1) * grid * 2 * FP;
    // a block's gradient row and its FP partials of Σ_g n_g·S_g
    rows = off;    off += size_t(grid) * (nw + FP);
    gparts = off;  off += size_t(kMaxGroups) * nw;
    total = off;
  }
};

// ---------------------------------------------------------------------------
// device helpers
// ---------------------------------------------------------------------------

// The lane-group helpers, the flag and counter protocol's final sums and
// the launch are walk_bwd.cuh's (shared with recurrence_bwd.cu and
// fused_psteps_bwd.cu). The step combine below is this kernel's own: with
// walk_bwd.cuh's (16 loads in flight, a cluster's 8 ranks unrolled)
// inside its walk the f32 build spilled 48 B instead of 24 and ran 24%
// slower (PERF.md, PR 17).

__device__ __forceinline__ void stamp(const BwdArgs& a, int slot) {
  mpnn_walk::stamp(a.prof, slot);
}

struct Ctx {
  const BwdArgs& a;
  float* sm;
  const GradLayout gl;
  float* row;               // this block's gradient row
  float* prow;              // its FP partials of Σ_g n_g·S_g (center_da0)
  int T, f, od, b, nblocks;
  int n0, n1, nb, e0, eb, lo, hi, n_real;
  float c, inv_gsum, gl_v;
  unsigned long long tag;   // the grid route's flag value this launch
  Smem L2;

  __device__ Sync sync() const {
    return Sync{a.route, nblocks, b, tag, a.flags, a.counters,
                a.flags == nullptr ? nullptr : a.flags + kFlagWords - 1};
  }
};

// The totals over the route's blocks of round s's block partial (2FP
// floats in cpart + s·2FP, written by threads < 2FP), into tot.
__device__ void combine(Ctx& x, int s) {
  const BwdArgs& a = x.a;
  float* sm = x.sm;
  float* bp = sm + x.L2.cpart + s * 2 * FP;
  float* tot = sm + x.L2.tot;
  const int tid = threadIdx.x;
  if (a.route == kRouteCluster && a.cluster > 1) {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    if (tid < 2 * FP) {
      float v = 0.f;
      for (int r = 0; r < a.cluster; ++r) v += cl.map_shared_rank(bp, r)[tid];
      tot[tid] = v;
    }
    __syncthreads();
    return;
  }
  if (a.route == kRouteCluster || x.nblocks == 1) {
    if (tid < 2 * FP) tot[tid] = bp[tid];
    __syncthreads();
    return;
  }
  const int G = x.nblocks;
  float* gp = a.scratch + Scratch(a.n_nodes, a.n_edges, a.k_vocab, a.f,
                                  a.od, a.steps, G).cparts +
              size_t(s) * G * 2 * FP;
  if (tid < 2 * FP) gp[size_t(x.b) * 2 * FP + tid] = bp[tid];
  __threadfence();
  __syncthreads();
  unsigned long long* fl = a.flags + size_t(s) * kMaxGrid * kFlagStride;
  if (tid == 0) st_flag(fl + size_t(x.b) * kFlagStride, x.tag);
  for (int bb = tid; bb < G; bb += kBT)
    while (ld_flag(fl + size_t(bb) * kFlagStride) != x.tag) spin_pause();
  __threadfence();
  __syncthreads();
  constexpr int P = kBT / (2 * FP);
  float* red = sm + x.L2.red;
  {
    // thread (p, i) sums blocks p, p + P, ... in order, 8 loads in flight
    const int p = tid / (2 * FP), i = tid % (2 * FP);
    float v = 0.f;
    for (int b0 = p; b0 < G; b0 += 8 * P) {
      float u[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int bb = b0 + r * P;
        u[r] = bb < G ? __ldcg(gp + size_t(bb) * 2 * FP + i) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (b0 + r * P < G) v += u[r];
    }
    red[p * 2 * FP + i] = v;
  }
  __syncthreads();
  if (tid < 2 * FP) {
    float v = 0.f;
    for (int p = 0; p < P; ++p) v += red[p * 2 * FP + tid];
    tot[tid] = v;
  }
  __syncthreads();
}

// The block partial of per-lane (s1, s2) over its groups (in order) into
// round s's cpart slot, then the route's totals into tot.
__device__ void batch_sums(Ctx& x, int s, float s1, float s2) {
  float v[2] = {s1, s2};
  float* bp = x.sm + x.L2.cpart + s * 2 * FP;
  groups_to<2>(v, x.sm + x.L2.red,
               [&](int i, int j, float t) { bp[i * FP + j] = t; });
  combine(x, s);
}

// Under the message bn1d Σ_g D_g = 0 (Σ ∂m over the batch), so dA0 =
// Σ_g D_g ⊗ (S_g − S̄) for any S̄. With S̄ = Σ_g n_g·S_g / c (the mean over
// the real nodes of their graph's Σh0) a shift common to every node's ∂m,
// which the norm's rounding leaves (the forward's mean, S1), cancels
// instead of growing with a large graph's S: on the totals, dA0 −=
// (Σ_g D_g) ⊗ S̄, i.e. ∂mbias ⊗ S̄. `prows` holds nrows partials of
// Σ n_g·S_g (stride ld; global memory when `global`), summed in row order.
// dw's A0 and mbias entries are complete; one block's threads call it.
__device__ void center_da0(Ctx& x, const float* prows, int nrows, size_t ld,
                           bool global) {
  const BwdArgs& a = x.a;
  const int tid = threadIdx.x, f = x.f;
  float* sbar = x.sm + x.L2.tot + 2 * FP;
  if (tid < f) {
    float s = 0.f;
    for (int r = 0; r < nrows; ++r)
      s += global ? __ldcg(prows + r * ld + tid) : prows[r * ld + tid];
    sbar[tid] = s / x.c;
  }
  __syncthreads();
  for (int e = tid; e < f * f; e += kBT)
    a.dw[x.gl.a0 + e] = __ldcg(a.dw + x.gl.a0 + e) -
                        __ldcg(a.dw + x.gl.mbias + e / f) * sbar[e % f];
  __syncthreads();
}

// The blocks' rows summed into dw in block order (the grid route:
// walk_bwd.cuh's counter groups), then dA0 centred by the block that
// finished dw. Rows are complete before the call; every thread calls it.
__device__ void final_sum_grid(Ctx& x) {
  const BwdArgs& a = x.a;
  const int G = x.nblocks, NW = x.gl.total;
  const Scratch sc(a.n_nodes, a.n_edges, a.k_vocab, a.f, a.od, a.steps, G);
  const float* rows = a.scratch + sc.rows;
  if (mpnn_walk::final_sum_grid(x.sync(), a.dw, rows, NW, NW + FP,
                                a.scratch + sc.gparts) &&
      has_stats(a.msg_mode) && !a.floor) {
    __syncthreads();
    center_da0(x, rows + NW, G, NW + FP, true);
  }
}

// The rows of a cluster summed in rank order, a column chunk per block.
__device__ void final_sum_cluster(Ctx& x) {
  const BwdArgs& a = x.a;
  if (a.cluster == 1) return;           // the row was dw itself
  const int C = a.cluster, NW = x.gl.total;
  const float* rows = a.scratch + Scratch(a.n_nodes, a.n_edges, a.k_vocab,
                                          a.f, a.od, a.steps, C).rows;
  mpnn_walk::final_sum_cluster(x.sync(), a.dw, rows, NW, NW + FP);
  if (has_stats(a.msg_mode) && !a.floor) {
    __threadfence();
    cg::this_cluster().sync();
    if (x.b == 0) center_da0(x, rows + NW, C, NW + FP, true);
  }
}

// The first graphs g in [0, G] with graph_node_ptr[g] >= t0 and >= t1,
// found by the block's threads together (one latency).
__device__ void first_graphs_at(const BwdArgs& a, int t0, int t1, int* slot,
                                int& g0, int& g1) {
  const int G = a.n_graphs;
  if (threadIdx.x == 0) slot[0] = slot[1] = G;
  __syncthreads();
  for (int g = threadIdx.x; g <= G; g += kBT) {
    const int p = __ldg(a.graph_node_ptr + g);
    const int prev = g > 0 ? __ldg(a.graph_node_ptr + g - 1) : -1;
    if (p >= t0 && prev < t0) slot[0] = g;
    if (p >= t1 && prev < t1) slot[1] = g;
  }
  __syncthreads();
  g0 = slot[0];
  g1 = slot[1];
  __syncthreads();
}

// The readout weights' gradient tiles: thread tiles over the staged rows.
struct RoTiles {
  float acc[kTPT][16];
  __device__ RoTiles() {
#pragma unroll
    for (int v = 0; v < kTPT; ++v)
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[v][c] = 0.f;
  }
  __device__ static int tile_of(int v) {
    return kDS > 1 ? int(threadIdx.x) % kNT : int(threadIdx.x) + kBT * v;
  }
  __device__ static int depth() {
    return kDS > 1 ? int(threadIdx.x) / kNT : 0;
  }
  // += the outer products of the staged rows (kRoRows of them)
  __device__ void add(const float* tile) {
    const int d = depth();
    if (d >= kDS) return;
#pragma unroll
    for (int v = 0; v < kTPT; ++v) {
      const int tau = tile_of(v);
      if (tau >= kNT) continue;
      const int which = tau / (kKB * kOB), rem = tau % (kKB * kOB);
      const int kb = rem / kOB, ob = rem % kOB;
      for (int r = d; r < kRoRows; r += kDS) {
        const float4 x4 = *reinterpret_cast<const float4*>(
            tile + r * kRS + kb * 4);
        const float4 d4 = *reinterpret_cast<const float4*>(
            tile + r * kRS + kXW + which * ODP + ob * 4);
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
        const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int oo = 0; oo < 4; ++oo)
            acc[v][kk * 4 + oo] = fmaf(xv[kk], dv[oo], acc[v][kk * 4 + oo]);
      }
    }
  }
  // the depth partials summed in order, each element into the row
  __device__ void store(Ctx& x, float* red) {
    if constexpr (kDS > 1) {
#pragma unroll
      for (int c = 0; c < 16; ++c) red[threadIdx.x * 16 + c] = acc[0][c];
      __syncthreads();
      if (int(threadIdx.x) < kNT) {
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          float s = 0.f;
          for (int d = 0; d < kDS; ++d) s += red[(d * kNT + threadIdx.x) * 16 + c];
          acc[0][c] = s;
        }
      }
      __syncthreads();
    }
    if (depth() != 0) return;
    const int f = x.f, od = x.od;
#pragma unroll
    for (int v = 0; v < kTPT; ++v) {
      const int tau = tile_of(v);
      if (tau >= kNT) continue;
      const int which = tau / (kKB * kOB), rem = tau % (kKB * kOB);
      const int kb = rem / kOB, ob = rem % kOB;
      const int wo = which ? x.gl.rjw : x.gl.riw;
      const int bo = which ? x.gl.rjb : x.gl.rib;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = kb * 4 + kk;
#pragma unroll
        for (int oo = 0; oo < 4; ++oo) {
          const int o = ob * 4 + oo;
          if (o >= od) continue;
          const float s = acc[v][kk * 4 + oo];
          if (k < f)
            x.row[wo + k * od + o] = s;
          else if (k >= FP && k < FP + f)
            x.row[wo + (f + k - FP) * od + o] = s;
          else if (k == 2 * FP)
            x.row[bo + o] = s;
        }
      }
    }
  }
};

// The body of one block, its per-node state in shared memory (kSm) or in
// its region of global scratch.
template <bool kSm>
__device__ void body(Ctx& x) {
  const BwdArgs& a = x.a;
  float* sm = x.sm;
  const int tid = threadIdx.x, q = tid / GS, j = tid % GS;
  const int f = x.f, od = x.od, T = x.T, N = a.n_nodes;
  const int n0 = x.n0, nb = x.nb, e0 = x.e0, eb = x.eb;
  const int mmode = a.msg_mode, smode = a.state_mode;
  const bool msg_stats = has_stats(mmode), state_stats = has_stats(smode);
  const Scratch sc(N, a.n_edges, a.k_vocab, f, od, T, x.nblocks);
  const size_t slot_sz = size_t(N) * f;
  const GradLayout& gl = x.gl;
  float* st = sm + L::stats(a.k_vocab);
  float* red = sm + x.L2.red;
  float* tile = sm + x.L2.tile;
  float* state = kSm ? sm + x.L2.state : a.scratch + sc.state + size_t(n0) * SS;
  float* sbuf = sm + x.L2.sb;            // slot rows (kSm only)
  int* ibase = kSm ? reinterpret_cast<int*>(sm + x.L2.ints)
                   : reinterpret_cast<int*>(a.scratch + sc.ints);
  // node graphs and local source pointers of the block's nodes; the
  // edges (in source order) as (src, dst, vid) local; the sorted list
  const size_t ge = size_t(2 * N + x.nblocks + 1);   // spilled edges
  int* ngl = ibase + (kSm ? 0 : n0);
  int* sptr = kSm ? ibase + x.a.ncap : ibase + N + n0 + x.b;
  int* einfo = kSm ? ibase + 2 * x.a.ncap + 1 : ibase + ge + 4 * size_t(e0);
  int* slist = kSm ? einfo + 4 * x.a.ecap
                   : ibase + ge + 4 * size_t(a.n_edges) + e0;
  int* vcnt = reinterpret_cast<int*>(sm + x.L2.ints) +
              (kSm ? 2 * x.a.ncap + 1 + 5 * x.a.ecap : 0);
  const int K = a.k_vocab;
  int* seg = vcnt + kWB * K;             // K + 1 segment starts
  const float* w = sm;

  // ---- staging: the block's nodes, edges and slot T's rows ---------------
  for (int i = tid; i < nb; i += kBT) ngl[i] = __ldg(a.node_graph + n0 + i);
  for (int i = tid; i <= nb; i += kBT) sptr[i] = __ldg(a.src_ptr + n0 + i) - e0;
  for (int p = tid; p < eb; p += kBT) {
    const int e = __ldg(a.src_order + e0 + p);
    einfo[4 * p] = __ldg(a.src + e) - n0;
    einfo[4 * p + 1] = __ldg(a.dst + e) - n0;
    einfo[4 * p + 2] = __ldg(a.vid + e);
    einfo[4 * p + 3] = 0;
  }
  for (int i = tid; i < nb * FP; i += kBT) {
    const int v = i / FP, jj = i % FP;
    float* s = state + size_t(v) * SS;
    const size_t g = size_t(n0 + v) * f + jj;
    if (jj < f) {
      copy4<kSm>(s + kXh + jj, a.htil + size_t(T) * slot_sz + g);
      copy4<kSm>(s + kH0 + jj, a.h0 + g);
      copy4<kSm>(s + kSda + jj, a.htil + g);   // slot 0, for gi
    } else {
      s[kXh + jj] = 0.f;
      s[kH0 + jj] = 0.f;
      s[kSda + jj] = 0.f;
    }
  }
  // the walk's first staged slot: T − 1 (slot 0 when T is 1)
  auto stage_slot = [&](int s) {
    if constexpr (kSm) {
      float* buf = sbuf + (s & 1) * x.a.ncap * FP;
      for (int i = tid; i < nb * FP; i += kBT) {
        const int v = i / FP, jj = i % FP;
        if (jj < f)
          cp_async4(buf + i, a.htil + size_t(s) * slot_sz + size_t(n0 + v) * f + jj);
        else
          buf[i] = 0.f;
      }
    }
  };
  stage_slot(T - 1);
  cp_async_wait_all();
  __syncthreads();

  // ---- the block's edges in vocab order: a stable counting sort ----------
  {
    const int warp = tid / 32, lane = tid % 32;
    const int per = (eb + kWB - 1) / kWB;
    const int p0 = min(eb, warp * per), p1 = min(eb, p0 + per);
    for (int i = tid; i < kWB * K; i += kBT) vcnt[i] = 0;
    __syncthreads();
    // pass 0 counts, pass 1 places; per chunk of 32 edges the lanes of an
    // id find their peers and the lowest one updates the warp's count
    for (int pass = 0; pass < 2; ++pass) {
      for (int c0 = p0; c0 < p1; c0 += 32) {
        const int p = c0 + lane;
        const int v = p < p1 ? einfo[4 * p + 2] : -1;
        unsigned peers = 0;
        for (int l = 0; l < 32; ++l)
          peers |= (__shfl_sync(kFull, v, l) == v ? 1u : 0u) << l;
        const int rank = __popc(peers & ((1u << lane) - 1u));
        const int lead = __ffs(peers) - 1;
        int base = 0;
        if (lane == lead && v >= 0) {
          base = vcnt[warp * K + v];
          vcnt[warp * K + v] = base + __popc(peers);
        }
        base = __shfl_sync(kFull, base, lead);
        if (pass == 1 && v >= 0) slist[base + rank] = p;
        __syncwarp();
      }
      __syncthreads();
      if (pass == 0) {
        // segment starts (ids in order) and each warp's cursor in them:
        // warp 0 scans the ids' totals, 32 ids a round
        if (warp == 0) {
          int base = 0;
          for (int k0 = 0; k0 < K; k0 += 32) {
            const int k = k0 + lane;
            int t = 0;
            if (k < K)
              for (int ww = 0; ww < kWB; ++ww) t += vcnt[ww * K + k];
            int incl = t;
            for (int off = 1; off < 32; off <<= 1) {
              const int u = __shfl_up_sync(kFull, incl, off);
              if (lane >= off) incl += u;
            }
            if (k < K) {
              int run = base + incl - t;
              seg[k] = run;
              for (int ww = 0; ww < kWB; ++ww) {
                const int cnt = vcnt[ww * K + k];
                vcnt[ww * K + k] = run;
                run += cnt;
              }
            }
            base += __shfl_sync(kFull, incl, 31);
          }
          if (lane == 0) seg[K] = base;
        }
        __syncthreads();
      }
    }
  }
  stamp(a, 1);

  // ---- the readout + loss VJP, gi once per node, slot T's batch sums -----
  const float* stT = st + T * 3 * FP;
  const float* st0 = st;
  const float bnw = w[L::kBnW + j], bnb = w[L::kBnB + j];
  const float maw = w[L::kMaW + j], mab = w[L::kMaB + j];
  float s1 = 0.f, s2 = 0.f, bnw_acc = 0.f, bnb_acc = 0.f;
  {
    RoTiles rt;
    const float* riw = ro_gate(w, a.w);
    const float* rjw = ro_value(w, a.w);
    for (int r0 = 0; r0 < nb; r0 += kRoRows) {
#pragma unroll
      for (int u = 0; u < kRoR; ++u) {
        // every lane of a warp runs each node's shuffles: a slot past
        // the block's nodes computes on node 0 and writes nothing
        const int rr = u * NG + q, i = r0 + rr;
        const bool ok = i < nb;
        float* xr = tile + rr * kRS;
        float* s = state + size_t(ok ? i : 0) * SS;
        const int n = n0 + i, g = ngl[ok ? i : 0];
        // h = the state norm of slot T (x̂ kept for the walk), h0
        const float raw = s[kXh + j];
        float xh = 0.f, h = raw;
        if (state_stats) {
          xh = (raw - stT[j]) / stT[2 * FP + j];
          h = bnw * xh + bnb;
        }
        const float h0 = s[kH0 + j];
        __syncwarp();
        if (ok) s[kXh + j] = xh;
        xr[j] = h;
        xr[FP + j] = h0;
        if (j < 4) xr[2 * FP + j] = j == 0 ? 1.f : 0.f;
        __syncwarp();
        // logits of the lane's QO outputs o = j·QO + u
        float pi[QO], pj[QO];
#pragma unroll
        for (int uo = 0; uo < QO; ++uo) {
          const int o = j * QO + uo;
          pi[uo] = o < ODP ? w[L::kRib + o] : 0.f;
          pj[uo] = o < ODP ? w[L::kRjb + o] : 0.f;
        }
        if (j * QO < ODP) {
#pragma unroll 8
          for (int k = 0; k < 2 * FP; ++k) {
            const float xk = xr[k];
            const float* wi = riw + k * ODP + j * QO;
            const float* wj = rjw + k * ODP + j * QO;
#pragma unroll
            for (int uo = 0; uo < QO; ++uo) {
              pi[uo] = fmaf(xk, wi[uo], pi[uo]);
              pj[uo] = fmaf(xk, wj[uo], pj[uo]);
            }
          }
        }
        float mx = -INFINITY;
#pragma unroll
        for (int uo = 0; uo < QO; ++uo)
          if (j * QO + uo < od) mx = fmaxf(mx, pi[uo]);
        mx = gmax(mx);
        float den = 0.f;
#pragma unroll
        for (int uo = 0; uo < QO; ++uo) {
          pi[uo] = j * QO + uo < od ? expf(pi[uo] - mx) : 0.f;
          den += pi[uo];
        }
        den = gsum(den);
        const float y = __ldg(a.labels + g), gmv = __ldg(a.gmask + g);
        float dot = 0.f, dsm[QO];
#pragma unroll
        for (int uo = 0; uo < QO; ++uo) {
          const int o = j * QO + uo;
          float dout = 0.f;
          if (o < od)
            dout = x.gl_v * 2.0f * (__ldg(a.out + size_t(g) * od + o) - y) *
                       gmv * x.inv_gsum +
                   __ldg(a.gout + size_t(g) * od + o);
          const float smx = pi[uo] / den;
          dsm[uo] = dout * pj[uo];
          pj[uo] = dout * smx;                 // djv
          pi[uo] = smx;
          dot = fmaf(dsm[uo], smx, dot);
        }
        dot = gsum(dot);
#pragma unroll
        for (int uo = 0; uo < QO; ++uo) {
          pi[uo] = pi[uo] * (dsm[uo] - dot);   // dpi
          const int o = j * QO + uo;
          if (o < ODP) {
            xr[kXW + o] = pi[uo];
            xr[kXW + ODP + o] = pj[uo];
          }
        }
        // ∂h_T and ∂h0 (readout part): p[2k] the h row k, p[2k+1] the h0
        // row k, reduce-scattered to lane k
        float p[2 * FP];
#pragma unroll
        for (int k = 0; k < FP; ++k) {
          float th = 0.f, t0 = 0.f;
          if (j * QO < ODP) {
#pragma unroll
            for (int uo = 0; uo < QO; ++uo) {
              const int o = j * QO + uo;
              th = fmaf(riw[k * ODP + o], pi[uo], th);
              th = fmaf(rjw[k * ODP + o], pj[uo], th);
              t0 = fmaf(riw[(FP + k) * ODP + o], pi[uo], t0);
              t0 = fmaf(rjw[(FP + k) * ODP + o], pj[uo], t0);
            }
          }
          p[2 * k] = th;
          p[2 * k + 1] = t0;
        }
        reduce_scatter<2 * FP>(p, j);
        const float gh = p[0];
        if (ok) s[kGh + j] = gh;
        if (ok) s[kD0 + j] = p[1];
        if (ok && state_stats) {
          const float v0 = gh * bnw;
          s1 += v0;
          s2 = fmaf(v0, xh, s2);
          bnw_acc = fmaf(gh, xh, bnw_acc);
          bnb_acc += gh;
        }
        // gi = W_ih·mb + b_ih, once per node (slot 0 staged in Σda's place)
        const float raw0 = s[kSda + j];
        const float mb =
            msg_stats ? maw * ((raw0 - st0[j]) / st0[2 * FP + j]) + mab : raw0;
        float gr = w[L::kBih + j], gz = w[L::kBih + FP + j],
              gn = w[L::kBih + 2 * FP + j];
#pragma unroll
        for (int k = 0; k < FP; ++k) {
          const float mk = gshfl(mb, k);
          const float* wi = w + L::kWih + k * 3 * FP;
          gr = fmaf(mk, wi[j], gr);
          gz = fmaf(mk, wi[FP + j], gz);
          gn = fmaf(mk, wi[2 * FP + j], gn);
        }
        __syncwarp();
        if (ok) {
          s[kGi + j] = gr;
          s[kGi + FP + j] = gz;
          s[kGi + 2 * FP + j] = gn;
          s[kSda + j] = 0.f;
          s[kSda + FP + j] = 0.f;
          s[kSda + 2 * FP + j] = 0.f;
        } else {
          for (int c = j; c < kRS; c += GS) xr[c] = 0.f;
        }
      }
      __syncthreads();
      rt.add(tile);
      __syncthreads();
    }
    rt.store(x, red);
  }
  stamp(a, 2);
  if (state_stats) batch_sums(x, T, s1, s2);
  stamp(a, 3);

  // ---- the reverse walk, t = T..1 ----------------------------------------
  float dwh[3][FP], bhh_acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int k = 0; k < FP; ++k) dwh[g][k] = 0.f;
  float wc[3][kWReg ? FP : 1];
  if constexpr (kWReg) {
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int k = 0; k < FP; ++k) wc[g][k] = w[L::kWhh + k * 3 * FP + g * FP + j];
  }
  const float bhr = w[L::kBhh + j], bhz = w[L::kBhh + FP + j],
              bhn = w[L::kBhh + 2 * FP + j];
  for (int t = T; t >= 1; --t) {
    const float* stt = st + t * 3 * FP;
    const float* stp = st + (t - 1) * 3 * FP;
    if (t >= 2) stage_slot(t - 2);
    const float* sb = sbuf + ((t - 1) & 1) * x.a.ncap * FP;
    const float* tot = sm + x.L2.tot;
    // the norm VJP of slot t as dhp = ∂h·bnw·rd − ca − x̂·cb, and x̂ of
    // slot t − 1 as (raw − mean)·rdp: reciprocals once a step
    const float rd = 1.0f / stt[2 * FP + j];
    const float ca = tot[j] / x.c * rd;
    const float cb = tot[FP + j] / (x.c * stt[FP + j]);
    const float rdp = 1.0f / stp[2 * FP + j], meanp = stp[j];
    s1 = 0.f;
    s2 = 0.f;
    for (int i0 = 0; i0 < nb; i0 += NG) {
      // warp-uniform rounds: a slot past the nodes runs on node 0 with
      // ∂h = 0 and writes nothing
      const int i = i0 + q;
      const bool ok = i < nb;
      float* s = state + size_t(ok ? i : 0) * SS;
      const int n = n0 + i;
      const float gh = s[kGh + j];
      const float dhp =
          !ok ? 0.f
          : state_stats ? fmaf(gh * bnw, rd, -ca) - s[kXh + j] * cb : gh;
      float hprev, xhp = 0.f;
      if (t > 1) {
        const float raw = kSm ? sb[(ok ? i : 0) * FP + j]
                              : (j < f ? __ldg(a.htil + size_t(t - 1) * slot_sz +
                                               size_t(ok ? n : n0) * f + j)
                                       : 0.f);
        hprev = raw;
        if (state_stats) {
          xhp = (raw - meanp) * rdp;
          hprev = bnw * xhp + bnb;
        }
      } else {
        hprev = s[kH0 + j];
      }
      float hb[FP];
#pragma unroll
      for (int k = 0; k < FP; ++k) hb[k] = gshfl(hprev, k);
      const float* wv = w + opaque_zero();
      float ghr = bhr, ghz = bhz, ghn = bhn;
#pragma unroll
      for (int k = 0; k < FP; ++k) {
        if constexpr (kWReg) {
          ghr = fmaf(wc[0][k], hb[k], ghr);
          ghz = fmaf(wc[1][k], hb[k], ghz);
          ghn = fmaf(wc[2][k], hb[k], ghn);
        } else {
          const float* wh = wv + L::kWhh + k * 3 * FP + j;
          ghr = fmaf(wh[0], hb[k], ghr);
          ghz = fmaf(wh[FP], hb[k], ghz);
          ghn = fmaf(wh[2 * FP], hb[k], ghn);
        }
      }
      const float sr = sigmoidf_(s[kGi + j] + ghr);
      const float sz = sigmoidf_(s[kGi + FP + j] + ghz);
      const float tn = tanhf(s[kGi + 2 * FP + j] + sr * ghn);
      const float dz = dhp * (hprev - tn);
      const float da_n = dhp * (1.0f - sz) * (1.0f - tn * tn);
      const float dnh = da_n * sr;
      const float da_r = da_n * ghn * sr * (1.0f - sr);
      const float da_z = dz * sz * (1.0f - sz);
      const float sdr = s[kSda + j], sdz = s[kSda + FP + j],
                  sdn = s[kSda + 2 * FP + j];
      __syncwarp();
      if (ok) {
        s[kSda + j] = sdr + da_r;
        s[kSda + FP + j] = sdz + da_z;
        s[kSda + 2 * FP + j] = sdn + da_n;
      }
      bhh_acc[0] += da_r;
      bhh_acc[1] += da_z;
      bhh_acc[2] += dnh;
      float p[FP];
#pragma unroll
      for (int k = 0; k < FP; ++k) {
        dwh[0][k] = fmaf(hb[k], da_r, dwh[0][k]);
        dwh[1][k] = fmaf(hb[k], da_z, dwh[1][k]);
        dwh[2][k] = fmaf(hb[k], dnh, dwh[2][k]);
        float v;
        if constexpr (kWReg) {
          v = wc[0][k] * da_r;
          v = fmaf(wc[1][k], da_z, v);
          v = fmaf(wc[2][k], dnh, v);
        } else {
          const float* wh = wv + L::kWhh + k * 3 * FP + j;
          v = wh[0] * da_r;
          v = fmaf(wh[FP], da_z, v);
          v = fmaf(wh[2 * FP], dnh, v);
        }
        p[k] = v;
      }
      reduce_scatter<FP>(p, j);
      const float gprev = fmaf(dhp, sz, p[0]);
      if (!ok) {
      } else if (t > 1) {
        s[kGh + j] = gprev;
        s[kXh + j] = xhp;
        if (state_stats) {
          const float v0 = gprev * bnw;
          s1 += v0;
          s2 = fmaf(v0, xhp, s2);
          bnw_acc = fmaf(gprev, xhp, bnw_acc);
          bnb_acc += gprev;
        }
      } else {
        s[kD0 + j] += gprev;
      }
    }
    cp_async_wait_all();
    stamp(a, 4 + 2 * (T - t));
    if (t > 1 && state_stats)
      batch_sums(x, t - 1, s1, s2);
    else
      __syncthreads();
    stamp(a, 5 + 2 * (T - t));
  }
  // ∂W_hh, ∂b_hh and the state norm's affine into the row
  {
    float* row = x.row;
#pragma unroll
    for (int g = 0; g < 3; ++g)
      groups_to<FP>(dwh[g], red, [&](int k, int jj, float v) {
        if (k < f && jj < f) row[gl.whh + k * 3 * f + g * f + jj] = v;
      });
    float v[5] = {bhh_acc[0], bhh_acc[1], bhh_acc[2],
                  smode == kBatchBn ? bnw_acc : 0.f,
                  smode == kBatchBn ? bnb_acc : 0.f};
    groups_to<5>(v, red, [&](int i, int jj, float s) {
      if (jj >= f) return;
      if (i < 3)
        row[gl.bhh + i * f + jj] = s;
      else
        row[(i == 3 ? gl.bnw : gl.bnb) + jj] = s;
    });
  }
  stamp(a, 70);

  // ---- W_ih's two products once, on Σ_t da_t; the message norm's sums ----
  {
    float dwi[3][FP], bih_acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int k = 0; k < FP; ++k) dwi[g][k] = 0.f;
    float maw_acc = 0.f, mab_acc = 0.f;
    s1 = 0.f;
    s2 = 0.f;
    for (int i0 = 0; i0 < nb; i0 += NG) {
      const int i = i0 + q;
      const bool ok = i < nb;
      const int ic = ok ? i : 0;
      float* s = state + size_t(ic) * SS;
      const float raw0 =
          kSm ? sbuf[ic * FP + j]
              : (j < f ? __ldg(a.htil + size_t(n0 + ic) * f + j) : 0.f);
      const float x0 = msg_stats ? (raw0 - st0[j]) / st0[2 * FP + j] : 0.f;
      const float mb = msg_stats ? maw * x0 + mab : raw0;
      const float dr = ok ? s[kSda + j] : 0.f,
                  dz = ok ? s[kSda + FP + j] : 0.f,
                  dn = ok ? s[kSda + 2 * FP + j] : 0.f;
      bih_acc[0] += dr;
      bih_acc[1] += dz;
      bih_acc[2] += dn;
      const float* wv = w + opaque_zero();
      float p[FP];
#pragma unroll
      for (int k = 0; k < FP; ++k) {
        const float mk = gshfl(mb, k);
        dwi[0][k] = fmaf(mk, dr, dwi[0][k]);
        dwi[1][k] = fmaf(mk, dz, dwi[1][k]);
        dwi[2][k] = fmaf(mk, dn, dwi[2][k]);
        const float* wi = wv + L::kWih + k * 3 * FP + j;
        float v = wi[0] * dr;
        v = fmaf(wi[FP], dz, v);
        v = fmaf(wi[2 * FP], dn, v);
        p[k] = v;
      }
      reduce_scatter<FP>(p, j);
      const float dmb = p[0];
      __syncwarp();
      if (ok) {
        s[kDmb + j] = dmb;
        s[kX0 + j] = x0;
      }
      if (ok && msg_stats) {
        const float v0 = dmb * maw;
        s1 += v0;
        s2 = fmaf(v0, x0, s2);
        maw_acc = fmaf(dmb, x0, maw_acc);
        mab_acc += dmb;
      }
    }
    float* row = x.row;
#pragma unroll
    for (int g = 0; g < 3; ++g)
      groups_to<FP>(dwi[g], red, [&](int k, int jj, float v) {
        if (k < f && jj < f) row[gl.wih + k * 3 * f + g * f + jj] = v;
      });
    float v[5] = {bih_acc[0], bih_acc[1], bih_acc[2], maw_acc, mab_acc};
    groups_to<5>(v, red, [&](int i, int jj, float s) {
      if (jj >= f) return;
      if (i < 3)
        row[gl.bih + i * f + jj] = s;
      else
        row[(i == 3 ? gl.maw : gl.mab) + jj] = s;
    });
  }
  stamp(a, 71);
  if (msg_stats) batch_sums(x, 0, s1, s2);
  stamp(a, 72);
  {
    const float* tot = sm + x.L2.tot;
    const float S1 = tot[j], S2 = tot[FP + j];
    for (int i = q; i < nb; i += NG) {
      float* s = state + size_t(i) * SS;
      const float dmb = s[kDmb + j];
      s[kDm + j] = msg_stats ? (dmb * maw - S1 / x.c) / st0[2 * FP + j] -
                                   s[kX0 + j] * S2 / (x.c * st0[FP + j])
                             : dmb;
    }
  }
  __syncthreads();

  // ---- the message VJP per graph: A0 (bias leakage), mbias, Aᵀ → ∂h0 -----
  {
    float da0[FP], dmbias = 0.f, pacc = 0.f;
#pragma unroll
    for (int m = 0; m < FP; ++m) da0[m] = 0.f;
    // per graph (a group each): Σ ∂m, Σ h0, the A0 terms; A0ᵀ·Σ∂m into
    // each of the graph's nodes' (spent) Σda slot
    for (int g0 = x.lo; g0 < x.hi; g0 += NG) {
      // warp-uniform rounds: a slot past the graphs sums no nodes
      const int g = g0 + q;
      const int v0 = g < x.hi ? __ldg(a.graph_node_ptr + g) - n0 : 0;
      const int v1 = g < x.hi ? __ldg(a.graph_node_ptr + g + 1) - n0 : 0;
      // four interleaved partial sums: a long graph's rounding grows
      // with the length of each chain
      float D0 = 0.f, D1 = 0.f, D2 = 0.f, D3 = 0.f;
      float S0 = 0.f, S1 = 0.f, S2 = 0.f, S3 = 0.f;
      int v = v0;
      for (; v + 4 <= v1; v += 4) {
        const float* r = state + size_t(v) * SS + j;
        D0 += r[kDm];
        D1 += r[SS + kDm];
        D2 += r[2 * SS + kDm];
        D3 += r[3 * SS + kDm];
        S0 += r[kH0];
        S1 += r[SS + kH0];
        S2 += r[2 * SS + kH0];
        S3 += r[3 * SS + kH0];
      }
      if (v < v1) {
        D0 += state[size_t(v) * SS + kDm + j];
        S0 += state[size_t(v) * SS + kH0 + j];
      }
      if (v + 1 < v1) {
        D1 += state[size_t(v + 1) * SS + kDm + j];
        S1 += state[size_t(v + 1) * SS + kH0 + j];
      }
      if (v + 2 < v1) {
        D2 += state[size_t(v + 2) * SS + kDm + j];
        S2 += state[size_t(v + 2) * SS + kH0 + j];
      }
      const float D = (D0 + D1) + (D2 + D3);
      const float S = (S0 + S1) + (S2 + S3);
      dmbias += D;
      pacc = fmaf(float(v1 - v0), S, pacc);
      float bt = 0.f;
#pragma unroll
      for (int m = 0; m < FP; ++m) {
        const float dm = gshfl(D, m);
        da0[m] = fmaf(dm, S, da0[m]);
        bt = fmaf(w[L::kA0 + m * FP + j], dm, bt);
      }
      for (int u = v0; u < v1; ++u) state[size_t(u) * SS + kSda + j] = bt;
    }
    __syncthreads();
    // per node (every group): + Σ_{e: src = v} A[vid_e]ᵀ·∂m_{dst_e}
    for (int v = q; v < nb; v += NG) {
      float acc0 = state[size_t(v) * SS + kSda + j], acc1 = 0.f;
      for (int p = sptr[v]; p < sptr[v + 1]; ++p) {
        const int wd = einfo[4 * p + 1], k = einfo[4 * p + 2];
        const float* am = amat_of(w, a.w, k) + j;
        const float* dmr = state + size_t(wd) * SS + kDm;
#pragma unroll 8
        for (int m = 0; m < FP; m += 2) {
          acc0 = fmaf(am[m * FP], dmr[m], acc0);
          acc1 = fmaf(am[(m + 1) * FP], dmr[m + 1], acc1);
        }
      }
      state[size_t(v) * SS + kD0 + j] += acc0 + acc1;
    }
    float* row = x.row;
    groups_to<FP>(da0, red, [&](int m, int jj, float v) {
      if (m < f && jj < f) row[gl.a0 + m * f + jj] = v;
    });
    float v[2] = {dmbias, pacc};
    groups_to<2>(v, red, [&](int i, int jj, float s) {
      if (jj >= f) return;
      if (i == 0)
        row[gl.mbias + jj] = s;
      else
        x.prow[jj] = s;
    });
    if (msg_stats && x.nblocks == 1) center_da0(x, x.prow, 1, 0, false);
    // ∂h0 of the block's nodes, coalesced
    for (int i = tid; i < nb * f; i += kBT)
      a.dh0[size_t(n0) * f + i] = state[size_t(i / f) * SS + kD0 + i % f];
  }
  stamp(a, 73);

  // ---- dA[k]: the block's edges in vocab order, one segment an id --------
  {
    constexpr int kPer = FP * FP >= kBT ? FP * FP / kBT : 1;
    for (int k = 0; k < K; ++k) {
      const int p0 = seg[k], p1 = seg[k + 1];
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int el = tid + kBT * r;
        const int m = el / FP, jj = el % FP;
        if (el >= FP * FP || m >= f || jj >= f) continue;
        // four interleaved partial sums, the edges in vocab order
        float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
        auto term = [&](int pp) {
          const int p = slist[pp];
          return state[size_t(einfo[4 * p + 1]) * SS + kDm + m] *
                 state[size_t(einfo[4 * p]) * SS + kH0 + jj];
        };
        int pp = p0;
        for (; pp + 4 <= p1; pp += 4) {
          c0 += term(pp);
          c1 += term(pp + 1);
          c2 += term(pp + 2);
          c3 += term(pp + 3);
        }
        if (pp < p1) c0 += term(pp);
        if (pp + 1 < p1) c1 += term(pp + 1);
        if (pp + 2 < p1) c2 += term(pp + 2);
        x.row[gl.a + (k * f + m) * f + jj] = (c0 + c1) + (c2 + c3);
      }
    }
  }
  stamp(a, 74);
}

// The empty walk: the route's grid, staging of nothing, each round's
// combine of zero partials and the final sum of a zero row.
__device__ void floor_body(Ctx& x) {
  const BwdArgs& a = x.a;
  const bool msg_stats = has_stats(a.msg_mode),
             state_stats = has_stats(a.state_mode);
  for (int e = threadIdx.x; e < x.gl.total; e += kBT) x.row[e] = 0.f;
  __syncthreads();
  if (state_stats) batch_sums(x, x.T, 0.f, 0.f);
  for (int t = x.T; t >= 1; --t) {
    if (t > 1 && state_stats)
      batch_sums(x, t - 1, 0.f, 0.f);
    else
      __syncthreads();
  }
  if (msg_stats) batch_sums(x, 0, 0.f, 0.f);
}

__global__ void __launch_bounds__(kBT, 1)
fused_step_bwd_kernel(BwdArgs a) {
  extern __shared__ float sm[];
  const int tid = threadIdx.x;
  const int nblocks = a.route == kRouteCluster ? a.cluster : int(gridDim.x);
  Ctx x{a, sm, GradLayout(a.k_vocab, a.f, a.od), nullptr, nullptr, a.steps,
        a.f,
        a.od, int(blockIdx.x), nblocks, 0, 0, 0, 0, 0, 0, 0, 0,
        0.f, 0.f, 0.f, 0ull,
        Smem(a.k_vocab, a.steps, a.ncap, a.ecap)};
  stamp(a, 0);
  if (a.route == kRouteGrid && nblocks > 1) {
    if (tid == 0) {
      const unsigned long long e = ld_flag(a.flags + kFlagWords - 1);
      reinterpret_cast<unsigned long long*>(sm + x.L2.misc)[0] = e + 1;
    }
  }
  stage_weights(sm, a.w, a.f, a.od, a.k_vocab, a.state_mode != kStateless);
  float* st = sm + L::stats(a.k_vocab);
  for (int i = tid; i < (x.T + 1) * FP; i += kBT) {
    const int s = i / FP, jj = i % FP;
    const float mean = jj < a.f ? a.stats[(size_t(s) * 2) * a.f + jj] : 0.f;
    const float var = jj < a.f ? a.stats[(size_t(s) * 2 + 1) * a.f + jj] : 0.f;
    set_slot(st + s * 3 * FP, jj, mean, var, s > 0 && a.state_mode == kStateless);
  }
  {
    float* red = sm + x.L2.red;
    float s = 0.f;
    for (int g = tid; g < a.n_graphs; g += kBT) s += __ldg(a.gmask + g);
    red[tid] = s;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int i = 0; i < kBT; ++i) s += sm[x.L2.red + i];
    sm[x.L2.misc + 2] = s;
  }
  __syncthreads();
  if (a.route == kRouteGrid && nblocks > 1)
    x.tag = reinterpret_cast<unsigned long long*>(sm + x.L2.misc)[0];
  x.inv_gsum = 1.0f / sm[x.L2.misc + 2];
  x.gl_v = a.gl[0];
  x.n_real = __ldg(a.graph_node_ptr + a.n_graphs);
  x.c = float(x.n_real);
  // this block's graphs and nodes, balanced by node count
  {
    int* slot = reinterpret_cast<int*>(sm + x.L2.red);
    const long long nr = x.n_real;
    first_graphs_at(a, int(nr * x.b / nblocks),
                    x.b + 1 == nblocks ? x.n_real + 1
                                       : int(nr * (x.b + 1) / nblocks),
                    slot, x.lo, x.hi);
    x.n0 = __ldg(a.graph_node_ptr + x.lo);
    x.n1 = __ldg(a.graph_node_ptr + x.hi);
    x.nb = x.n1 - x.n0;
    x.e0 = __ldg(a.src_ptr + x.n0);
    x.eb = __ldg(a.src_ptr + x.n1) - x.e0;
  }
  // padded node slots: ∂h0 = 0
  for (size_t i = size_t(blockIdx.x) * kBT + tid;
       i < size_t(a.n_nodes - x.n_real) * a.f; i += size_t(gridDim.x) * kBT)
    a.dh0[size_t(x.n_real) * a.f + i] = 0.f;
  const bool alone = nblocks == 1;
  x.row = alone ? a.dw
                : a.scratch + Scratch(a.n_nodes, a.n_edges, a.k_vocab, a.f,
                                      a.od, a.steps, nblocks).rows +
                      size_t(x.b) * (x.gl.total + FP);
  x.prow = alone ? sm + x.L2.tot + 2 * FP : x.row + x.gl.total;
  if (a.floor)
    floor_body(x);
  else if (x.nb <= a.ncap && x.eb <= a.ecap)
    body<true>(x);
  else
    body<false>(x);
  if (a.route == kRouteCluster)
    final_sum_cluster(x);
  else if (!alone)
    final_sum_grid(x);
  stamp(a, 75);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block at node capacity ncap and edge
// capacity ecap, in bytes (kernels/fused_step.py::bwd_smem_floats mirrors
// it).
int mpnn_fused_step_bwd_smem_bytes(int k_vocab, int steps, int ncap,
                                   int ecap) {
  return int(smem_bytes(k_vocab, steps, ncap, ecap));
}

// The 16 offsets of the flat gradient layout (GradLayout), the total last.
void mpnn_fused_step_bwd_layout(int k_vocab, int f, int od, int* out) {
  const GradLayout g(k_vocab, f, od);
  const int v[16] = {g.a, g.a0, g.mbias, g.wih, g.whh, g.bih, g.bhh, g.maw,
                     g.mab, g.bnw, g.bnb, g.riw, g.rib, g.rjw, g.rjb,
                     g.total};
  for (int i = 0; i < 16; ++i) out[i] = v[i];
}

long long mpnn_fused_step_bwd_scratch_floats(int n_nodes, int n_edges,
                                             int k_vocab, int f, int od,
                                             int steps, int grid) {
  return (long long)Scratch(n_nodes, n_edges, k_vocab, f, od, steps, grid)
      .total;
}

// The flag and counter words of the grid route (one buffer each per
// stream, zeroed once): u64 flags, int counters.
int mpnn_fused_step_bwd_sync_words(int* counters) {
  *counters = kMaxGroups + 1;
  return kFlagWords;
}

// The co-resident blocks of the grid route at this shared memory, capped
// at kMaxGrid; 0 on error.
int mpnn_fused_step_bwd_max_grid(int bytes) {
  return max_grid(fused_step_bwd_kernel, bytes);
}

// Launches on `stream` and returns the launch's error code (0 = success).
// route 0: one cluster of `cluster` blocks (1, 2, 4 or 8); route 1: `grid`
// co-resident blocks with `flags` and `counters`. ncap, ecap: the node and
// edge capacity of a block's shared memory. floor != 0 launches the empty
// walk (the same grid, combines and final sum; dw gets zeros). prof: null
// or kProfSlots int64 clock64 stamps of block 0.
int mpnn_fused_step_bwd(
    const float* amat, const float* a0, const float* mbias, const float* h0,
    const float* w_ih, const float* w_hh, const float* b_ih,
    const float* b_hh, const float* ma_w, const float* ma_b,
    const float* bn_w, const float* bn_b, const float* ro_iw,
    const float* ro_ib, const float* ro_jw, const float* ro_jb,
    const float* labels, const float* gmask, const float* out,
    const float* gout, const float* gl, const float* htil,
    const float* stats, const int* vid, const int* src, const int* dst,
    const int* src_order, const int* src_ptr, const int* graph_node_ptr,
    const int* node_graph, float* dh0, float* dw, float* scratch,
    unsigned long long* flags, int* counters, long long* prof,
    int n_nodes, int n_graphs, int n_edges, int f, int od, int k_vocab,
    int steps, int msg_mode, int state_mode, int route, int grid,
    int ncap, int ecap, int floor, void* stream) {
  if (f > FP || od > ODP || steps < 1 || steps > kMaxSteps || grid < 1 ||
      ncap < 1 || ecap < 0 ||
      (msg_mode != kNone && msg_mode != kBatchBn) ||
      (state_mode != kNone && state_mode != kBatchBn &&
       state_mode != kStateless) ||
      (route == kRouteCluster &&
       (grid != 1 && grid != 2 && grid != 4 && grid != 8)) ||
      (route == kRouteGrid &&
       (grid > kMaxGrid || (grid > 1 && (!flags || !counters)))) ||
      (route != kRouteCluster && route != kRouteGrid))
    return int(cudaErrorInvalidValue);
  BwdArgs a{{amat, a0, mbias, w_ih, w_hh, b_ih, b_hh, ma_w, ma_b, bn_w,
             bn_b, ro_iw, ro_ib, ro_jw, ro_jb},
            h0, labels, gmask, out, gout, gl, htil, stats, vid, src, dst,
            src_order, src_ptr, graph_node_ptr, node_graph, dh0, dw,
            scratch, flags, counters, prof, n_nodes, n_graphs, n_edges, f,
            od, k_vocab, steps, msg_mode, state_mode, route,
            route == kRouteCluster ? grid : 1, ncap, ecap, floor};
  return launch_route(fused_step_bwd_kernel, a, route, grid,
                      smem_bytes(k_vocab, steps, ncap, ecap), stream);
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
