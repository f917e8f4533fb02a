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
// exactly one update from its own slot; zero for a norm without
// statistics — and the residual stash htil (2T, N, f): slots 0..T-1 the
// masked messages, T..2T-1 the pre-norm GRU outputs, padded node slots
// zero, which the backwards (fused_psteps_bwd.cu, ps_walk_bwd.cu) read
// instead of replaying the forward.
//
// Design: the shared family's forward (fused_step_forward.cuh, whose lane
// helpers this file takes) with what the per-step family adds. A node is
// a GROUP of FP lanes, one feature a lane; a block of 256 threads holds
// NG groups. Each block owns whole graphs (a contiguous node range,
// balanced by node count), so the messages, the A0 terms and the readout
// are block-local. A block stages its nodes' h0 and its incoming edges
// (dst-sorted, as local source and vocab id), and each node's state — h0,
// its current pre-norm slot and its T messages — stays in a shared-memory
// tile for the whole launch (in the block's region of global scratch
// when its graphs outgrow the tile: the same code).
//   * T message tables: one walk of a node's edges reads h0[src] from the
//     tile once and feeds TG steps' tables (A_t staged in shared memory
//     when the T·K tables fit kAmatSmemFloats, else read through the
//     read-only cache); a message is a reduce-scatter over the group's
//     lanes, lane m output m.
//   * One combine for the message norms: the messages do not depend on
//     the recurrence, so the T slots' statistics cross blocks in one
//     round.
//   * Input gates every step: gi_t = W_ihᵀ·ma_bn_t(m_t) + b_ih, a second
//     GEMV a node a step beside W_hhᵀ·h; both take h's and mb's other
//     features by shuffles within the group, the weight columns of a lane
//     in registers at FP 16.
//   * A state-norm combine every step (bn1d on batch statistics, the
//     stateless norm).
// The readout computes a node's gated row with lanes over od into its
// spent tile row; then a group a graph sums its nodes' rows in node order.
//
// Only the per-slot batch statistics and the loss cross blocks. Each
// block sums its nodes' Σx, then (second pass over the tile) Σ(x −
// mean_block)², with compensated (Kahan) sums, and the route combines the
// block partials in block order by Chan's formula, compensated too.
// Routes (kernels/fused_psteps.py::fwd_launch_shape, row 2's policy):
//   * cluster: one thread-block cluster of C = 1, 2, 4 or 8 blocks; the
//     partials go through distributed shared memory in rank order.
//   * grid: up to the co-resident blocks, launched cooperatively only so
//     that they are co-resident (no grid barrier). A block publishes each
//     round's partial rows and counts itself in the round's integer
//     arrival counter; once it reads the block count there, it stages
//     every row and sums them in block order. The last block to finish
//     (one more counter) sums the loss in graph order and sets every
//     counter back to zero: no memset before the launch.
// No float atomics; every cross-thread sum runs in a fixed order, so a
// batch gives the same bits in every run of the same route.
//
// Bound: chip_smoke.py::_ps_bounds (~1 us by bytes at encoded's b1024).

#include "fused_psteps_common.cuh"
#include "fused_step_forward.cuh"

namespace mpnn_psfwd {

using namespace mpnn_psteps;
using mpnn_step::cp_async4;
using mpnn_step::cp_async_wait_all;
using mpnn_step::first_graphs_at;
using mpnn_step::gmax;
using mpnn_step::groups_sum;
using mpnn_step::GS;
using mpnn_step::gshfl;
using mpnn_step::gsum;
using mpnn_step::kFT;
using mpnn_step::kFW;
using mpnn_step::KSum;
using mpnn_step::kRouteCluster;
using mpnn_step::kRouteGrid;
using mpnn_step::ld_count;
using mpnn_step::NG;
using mpnn_step::reduce_scatter;
using mpnn_step::spin_pause;

constexpr int kMaxGrid = 512;         // kernels/fused_psteps.py::FWD_MAX_GRID
// the grid route's integer counters: the T + 1 rounds' arrivals (the
// messages', each step's), the launch's
constexpr int kCounters = kMaxSteps + 2;
constexpr int kDone = kMaxSteps + 1;
constexpr int kProfSlots = 80;        // block 0's clock64 stamps
// the weight columns of a lane (W_ih, W_hh): in registers at FP 16, read
// from shared memory at FP 32
constexpr bool kWReg = FP <= 16;
// readout outputs a lane: o = j + GS·u
constexpr int QO = ODW >= GS ? ODW / GS : 1;
// steps a walk of a node's edges feeds: TG·FP partials in registers
constexpr int TG = 64 / FP;
// the T·K message tables staged in shared memory up to this many floats
// (kernels/fused_psteps.py::AMAT_SMEM_FLOATS)
constexpr int kAmatSmemFloats = 16384;
// a node's tile row: h0, the current pre-norm state x, the T messages;
// the readout's gated row (ODW) overwrites it
constexpr int kH0 = 0, kX = FP, kM = 2 * FP;
// a block's partial row of one slot: Σx (FP), Σ(x − mean_block)² (FP),
// mean_block (FP), its node count; and as the combine stages it from
// every block: mean_block (FP), Σ(x − mean_block)² (FP), the count
constexpr int kRow = 3 * FP + 4;
constexpr int kStaged = 2 * FP + 4;
constexpr int kRed = 2 * kFT;
static_assert(QO * GS >= ODW, "a lane's outputs cover od");
static_assert(TG * FP == 64 && TG >= 1, "a walk's partials");

__host__ __device__ inline int node_floats(int steps) {
  return (2 + steps) * FP > ODW ? (2 + steps) * FP : ODW;
}

__host__ __device__ constexpr int al4(int n) { return (n + 3) & ~3; }

struct FwdArgs {
  PsWeights w;              // ro_iw/ro_jw zero-padded (2FP, ODW) when wide
  const float* h0;          // (N, f), pre-masked
  const float* labels;      // (G)
  const float* gmask;       // (G)
  const int* vid;           // (E)
  const int* src;           // (E)
  const int* edge_order;    // (E) edge ids, stably sorted by destination
  const int* dst_ptr;       // (N + 1) row pointers into edge_order
  const int* graph_node_ptr;  // (G + 1) node range of each graph
  float* loss;              // (1)
  float* out;               // (G, od)
  float* stats;             // (2T, 2, f): mean, biased var
  float* htil;              // (2T, N, f)
  float* scratch;           // Scratch(...).total floats
  int* counters;            // grid route: kCounters, zero between launches
  long long* prof;          // null, or kProfSlots clock64 stamps (block 0)
  // msg_mode in {kNone, kBatchBn}; state_mode in {kNone, kBatchBn,
  // kStateless}
  int n_nodes, n_graphs, n_edges, f, od, k_vocab, steps, msg_mode,
      state_mode;
  int route, cluster, ncap, ecap, amat_smem, floor;
};

// Offsets (floats) of one block's shared memory past the staged weights
// and the 2T slots' norm constants (PL::after_stats), for a launch of
// `nrows` blocks.
struct Smem {
  int amat, cpart, red, rows, ints, state, total;
  __host__ __device__ Smem(int k_vocab, int steps, int ncap, int ecap,
                           int nrows, bool amat_smem) {
    int off = al4(PL::after_stats(steps));
    amat = off;   off += amat_smem ? steps * k_vocab * FP * FP : 0;
    cpart = off;  off += al4(2 * steps * kRow);
    red = off;    off += kRed;
    // every block's partial row of the slot being combined
    rows = off;   off += (nrows > 1 ? nrows : 1) * kStaged;
    // ints: local edge pointers (ncap + 1), edges as (local src, vid)
    ints = off;   off += al4(ncap + 1 + 2 * ecap);
    state = off;  off += ncap * node_floats(steps);
    total = off;
  }
};

inline size_t fwd_smem_bytes(int k_vocab, int steps, int ncap, int ecap,
                             int nrows, bool amat_smem) {
  return sizeof(float) *
         size_t(Smem(k_vocab, steps, ncap, ecap, nrows, amat_smem).total);
}

// Offsets (floats) of the global scratch.
struct Scratch {
  size_t state, ints, cparts, lossg, total;
  __host__ __device__ Scratch(int n, int e, int g, int steps, int grid) {
    size_t off = 0;
    state = off;   off += size_t(n) * node_floats(steps);  // spilled tiles
    // local edge pointers (a slot a block more), edges (2 ints each)
    ints = off;    off += size_t(n + grid + 1) + 2 * size_t(e);
    cparts = off;  off += size_t(2 * steps) * grid * kRow;
    lossg = off;   off += size_t(g);
    total = off;
  }
};

__device__ __forceinline__ void stamp(const FwdArgs& a, int slot) {
  if (a.prof != nullptr && blockIdx.x == 0 && threadIdx.x == 0 &&
      slot < kProfSlots)
    a.prof[slot] = clock64();
}

// fused_psteps_common.cuh::stage_ps_weights with each real element an
// asynchronous 4-byte copy (padded elements stored as zeros), the norm
// constants set to the identity, and the T·K message tables zero-padded
// to (FP, FP) at `at` when they are staged. The caller waits
// (cp_async_wait_all) before its barrier.
__device__ void stage_weights_async(float* sm, float* at, const FwdArgs& a) {
  const PsWeights& w = a.w;
  const int tid = threadIdx.x, nt = blockDim.x, f = a.f, od = a.od,
            T = a.steps;
  auto put = [&](float* d, bool in, const float* src) {
    if (in)
      cp_async4(d, src);
    else
      *d = 0.f;
  };
  for (int i = tid; i < FP * 3 * FP; i += nt) {
    const int r = i / (3 * FP), gc = i % (3 * FP), g = gc / FP, c = gc % FP;
    const bool in = r < f && c < f;
    put(sm + PL::kWih + i, in, w.w_ih + r * 3 * f + g * f + c);
    put(sm + PL::kWhh + i, in, w.w_hh + r * 3 * f + g * f + c);
  }
  for (int i = tid; i < 3 * FP; i += nt) {
    const int g = i / FP, c = i % FP;
    put(sm + PL::kBih + i, c < f, w.b_ih + g * f + c);
    put(sm + PL::kBhh + i, c < f, w.b_hh + g * f + c);
  }
  for (int i = tid; kRoInSmem && i < 2 * FP * ODW; i += nt) {
    const int r = i / ODW, o = i % ODW, half = r / FP, k = r % FP;
    const bool in = k < f && o < od;
    const int srow = half * f + k;
    put(sm + PL::kRiw + i, in, w.ro_iw + srow * od + o);
    put(sm + PL::kRjw + i, in, w.ro_jw + srow * od + o);
  }
  for (int i = tid; i < ODW; i += nt) {
    put(sm + PL::kRib + i, i < od, w.ro_ib + i);
    put(sm + PL::kRjb + i, i < od, w.ro_jb + i);
  }
  for (int i = tid; i < T * PL::kPer; i += nt) {
    const int t = i / PL::kPer, o = i % PL::kPer;
    float* d = sm + PL::step(0) + i;
    if (o < PL::oMb) {
      const int r = o / FP, c = o % FP;
      put(d, r < f && c < f, w.a0 + (t * f + r) * f + c);
    } else {
      const int which = (o - PL::oMb) / FP, j = (o - PL::oMb) % FP;
      const float* src = which == 0   ? w.mbias
                         : which == 1 ? w.ma_w
                         : which == 2 ? w.ma_b
                         : which == 3 ? w.bn_w
                                      : w.bn_b;
      put(d, j < f, src + t * f + j);
    }
  }
  for (int i = tid; i < 2 * T * 3 * FP; i += nt)
    sm[PL::stats(T) + i] = (i % (3 * FP)) < FP ? 0.f : 1.f;
  for (int i = tid; a.amat_smem && i < T * a.k_vocab * FP * FP; i += nt) {
    const int tk = i / (FP * FP), r = (i / FP) % FP, c = i % FP;
    put(at + i, r < f && c < f, w.amat + (size_t(tk) * f + r) * f + c);
  }
}

struct Ctx {
  const FwdArgs& a;
  float* sm;
  int T, f, od, b, nblocks, ss;
  int lo, hi, n0, nb, e0, eb, n_real;
  Smem L2;
};

// Slot s's block partial row (cpart + s·kRow) from the tile's values at
// offset `off` of each node's row: the count, Σx, then (a second pass)
// Σ(x − mean_block)², each a compensated sum a lane over its group's
// nodes, then over the groups in order. Every thread calls it.
__device__ void block_partial(Ctx& x, int s, const float* state, int off) {
  float* bp = x.sm + x.L2.cpart + s * kRow;
  float* red = x.sm + x.L2.red;
  const int tid = threadIdx.x, q = tid / GS, j = tid % GS;
  KSum sx;
  for (int i = q; i < x.nb; i += NG) sx.add(state[size_t(i) * x.ss + off + j]);
  if (tid == 0) bp[3 * FP] = float(x.nb);
  groups_sum(sx.s, red, bp);
  const float mb = x.nb > 0 ? bp[j] / float(x.nb) : 0.f;
  if (tid < FP) bp[2 * FP + tid] = mb;
  KSum m2;
  for (int i = q; i < x.nb; i += NG) {
    const float d = state[size_t(i) * x.ss + off + j] - mb;
    m2.add(d * d);
  }
  groups_sum(m2.s, red, bp + FP);
}

// One round of the route for slots [s0, s1): every block's partial rows
// there to read (the cluster's shared memory, or published to global
// scratch and counted in the round's arrival counter until it reads the
// block count). Every thread calls it.
__device__ void arrive(Ctx& x, int s0, int s1, int round) {
  const FwdArgs& a = x.a;
  const int G = x.nblocks, tid = threadIdx.x;
  if (G == 1) {
    __syncthreads();
    return;
  }
  if (a.route == kRouteCluster) {
    cg::this_cluster().sync();
    return;
  }
  // the published row holds the real features only: mean_block (f),
  // Σ(x − mean_block)² (f), the count
  const int f = x.f, wr = 2 * f + 1;
  const Scratch sc(a.n_nodes, a.n_edges, a.n_graphs, a.steps, G);
  for (int e = tid; e < (s1 - s0) * wr; e += kFT) {
    const int s = s0 + e / wr, c = e % wr;
    const float* bp = x.sm + x.L2.cpart + s * kRow;
    a.scratch[sc.cparts + (size_t(s) * G + x.b) * wr + c] =
        bp[c < f ? 2 * FP + c : c < 2 * f ? FP + c - f : 3 * FP];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    atomicAdd(a.counters + round, 1);
    while (ld_count(a.counters + round) < G) spin_pause();
    __threadfence();
  }
  __syncthreads();
}

// The batch mean and biased var of slot s from every block's partial row
// (after its round's arrive): the rows staged in shared memory, then
// Chan's formula over the blocks in order, compensated: the P lanes of a
// feature take every P-th block in order and combine in a fixed xor
// tree. Sets the slot's norm constants (the stateless convention with
// `stateless`); block 0 writes (mean, var) to `stats`. Every thread calls
// it.
__device__ void combine_slot(Ctx& x, int s, bool stateless) {
  const FwdArgs& a = x.a;
  float* sm = x.sm;
  const int tid = threadIdx.x, G = x.nblocks;
  float* bp = sm + x.L2.cpart + s * kRow;
  float* rows = sm + x.L2.rows;           // G rows of kStaged
  if (G > 1 && a.route == kRouteCluster) {
    cg::cluster_group cl = cg::this_cluster();
    for (int e = tid; e < G * (2 * FP + 1); e += kFT) {
      const int r = e / (2 * FP + 1), c = e % (2 * FP + 1);
      // mean_block, then Σ(x − mean_block)², then the count
      const int from = c < FP ? 2 * FP + c : c < 2 * FP ? c : 3 * FP;
      rows[r * kStaged + c] = cl.map_shared_rank(bp, r)[from];
    }
  } else if (G > 1) {
    const int f = x.f, wr = 2 * f + 1;
    auto col = [&](int c) { return (c / f) * FP + c % f; };
    const float* gp = a.scratch +
                      Scratch(a.n_nodes, a.n_edges, a.n_graphs, a.steps, G)
                          .cparts + size_t(s) * G * wr;
    // 8 loads in flight a thread
    for (int e0 = tid; e0 < G * wr; e0 += 8 * kFT) {
      float u[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int e = e0 + r * kFT;
        u[r] = e < G * wr ? __ldcg(gp + e) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int e = e0 + r * kFT;
        if (e < G * wr) rows[(e / wr) * kStaged + col(e % wr)] = u[r];
      }
    }
  } else if (tid < 2 * FP + 1) {
    rows[tid] = bp[tid < FP ? 2 * FP + tid : tid < 2 * FP ? tid : 3 * FP];
  }
  __syncthreads();
  // lane p of feature i takes blocks p, p + P, ... (padded features: zero)
  constexpr int P = kFT / FP;
  const int i = tid / P, p = tid % P;
  const bool real = i < x.f;
  const float n = float(x.n_real);
  auto psum = [](float v) {
#pragma unroll
    for (int off = P / 2; off > 0; off >>= 1)
      v += __shfl_xor_sync(kFull, v, off);
    return v;
  };
  KSum v;
  for (int bb = p; real && bb < G; bb += P) {
    const float* row = rows + bb * kStaged;
    v.add(row[2 * FP] * row[i]);          // count · mean_block
  }
  const float mean = psum(v.s) / n;
  KSum w;
  for (int bb = p; real && bb < G; bb += P) {
    const float* row = rows + bb * kStaged;
    const float c = row[2 * FP];
    if (c > 0.f) {
      const float d = row[i] - mean;
      w.add(row[FP + i] + c * d * d);
    }
  }
  const float var = psum(w.s) / n;
  if (p == 0) {
    set_slot(sm + PL::stats(x.T) + s * 3 * FP, i, mean, var, stateless);
    if (x.b == 0 && real && !a.floor) {
      a.stats[(size_t(s) * 2) * x.f + i] = mean;
      a.stats[(size_t(s) * 2 + 1) * x.f + i] = var;
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// the body of one block
// ---------------------------------------------------------------------------

template <bool kSm>
__device__ void body(Ctx& x) {
  const FwdArgs& a = x.a;
  float* sm = x.sm;
  const int tid = threadIdx.x, q = tid / GS, j = tid % GS;
  const int f = x.f, od = x.od, T = x.T, N = a.n_nodes, K = a.k_vocab;
  const int ss = x.ss;
  const int n0 = x.n0, nb = x.nb, e0 = x.e0, eb = x.eb;
  const int mmode = a.msg_mode, smode = a.state_mode;
  const bool msg_stats = has_stats(mmode), state_stats = has_stats(smode);
  const Scratch sc(N, a.n_edges, a.n_graphs, T, x.nblocks);
  const size_t slot_sz = size_t(N) * f;
  const float* st = sm + PL::stats(T);
  float* state =
      kSm ? sm + x.L2.state : a.scratch + sc.state + size_t(n0) * ss;
  int* ibase = kSm ? reinterpret_cast<int*>(sm + x.L2.ints)
                   : reinterpret_cast<int*>(a.scratch + sc.ints);
  int* eptr = kSm ? ibase : ibase + n0 + x.b;             // nb + 1
  int* einfo = kSm ? ibase + a.ncap + 1
                   : ibase + (N + x.nblocks + 1) + 2 * size_t(e0);
  const float* w = sm;
  const float* at = sm + x.L2.amat;

  // ---- staging: the block's nodes' h0, its edges as (local src, vid) ----
  for (int i = tid; i <= nb; i += kFT) eptr[i] = __ldg(a.dst_ptr + n0 + i) - e0;
  for (int p = tid; p < eb; p += kFT) {
    const int e = __ldg(a.edge_order + e0 + p);
    einfo[2 * p] = __ldg(a.src + e) - n0;
    einfo[2 * p + 1] = __ldg(a.vid + e);
  }
  for (int i = tid; i < nb * FP; i += kFT) {
    const int v = i / FP, jj = i % FP;
    float* d = state + size_t(v) * ss + kH0 + jj;
    const float* src = a.h0 + size_t(n0 + v) * f + jj;
    if (jj >= f)
      *d = 0.f;
    else if constexpr (kSm)
      cp_async4(d, src);
    else
      *d = __ldg(src);
  }
  cp_async_wait_all();                  // these rows and the weights
  __syncthreads();
  stamp(a, 1);

  // ---- A0_t·S_g + mbias_t per graph (a group a graph) into its nodes'
  //      message slots -------------------------------------------------------
  for (int g0 = x.lo; g0 < x.hi; g0 += NG) {
    // warp-uniform rounds: a slot past the graphs sums no nodes
    const int g = g0 + q;
    const int v0 = g < x.hi ? __ldg(a.graph_node_ptr + g) - n0 : 0;
    const int v1 = g < x.hi ? __ldg(a.graph_node_ptr + g + 1) - n0 : 0;
    KSum ks;
    for (int v = v0; v < v1; ++v) ks.add(state[size_t(v) * ss + kH0 + j]);
    const float S = ks.s;
    for (int t = 0; t < T; ++t) {
      const float* ws = w + opaque_zero() + PL::step(t);
      float p[FP];
#pragma unroll
      for (int m = 0; m < FP; ++m) p[m] = ws[PL::oA0 + m * FP + j] * S;
      reduce_scatter<FP>(p, j);
      const float base = p[0] + ws[PL::oMb + j];
      for (int u = v0; u < v1; ++u)
        state[size_t(u) * ss + kM + t * FP + j] = base;
    }
  }
  __syncthreads();

  // ---- messages: a group a node, a lane a source feature; one walk of
  //      the node's edges feeds TG steps, then a reduce-scatter to a lane
  //      an output -----------------------------------------------------------
  // the two groups of a warp read their ids' tables in opposite row order
  // (the same rows at FP 16 would share banks)
  const int par = GS < 32 ? (tid / GS) & 1 : 0;
  for (int t0 = 0; t0 < T; t0 += TG) {
    for (int i0 = 0; i0 < nb; i0 += NG) {
      const int i = i0 + q;
      const bool ok = i < nb;
      float p[FP * TG];                  // p[m·TG + u]: output m, step t0 + u
#pragma unroll
      for (int m = 0; m < FP * TG; ++m) p[m] = 0.f;
      const int pa = ok ? eptr[i] : 0, pe = ok ? eptr[i + 1] : 0;
      for (int pp = pa; pp < pe; ++pp) {
        const int sl = einfo[2 * pp], k = einfo[2 * pp + 1];
        const float hs = state[size_t(sl) * ss + kH0 + j];
#pragma unroll
        for (int u = 0; u < TG; ++u) {
          const int t = t0 + u;
          if (t >= T) break;
          if (a.amat_smem) {
            const float* am = at + (size_t(t) * K + k) * FP * FP + j;
#pragma unroll
            for (int m = 0; m < FP; m += 2) {
              const float u0 = am[(m + par) * FP], u1 = am[(m + 1 - par) * FP];
              p[m * TG + u] = fmaf(par ? u1 : u0, hs, p[m * TG + u]);
              p[(m + 1) * TG + u] = fmaf(par ? u0 : u1, hs,
                                         p[(m + 1) * TG + u]);
            }
          } else if (j < f) {
            const float* am = a.w.amat + (size_t(t) * K + k) * f * f + j;
#pragma unroll
            for (int m = 0; m < FP; ++m)
              if (m < f)
                p[m * TG + u] = fmaf(__ldg(am + m * f), hs, p[m * TG + u]);
          }
        }
      }
      reduce_scatter<FP * TG>(p, j);
      if (ok) {
        float* s = state + size_t(i) * ss;
#pragma unroll
        for (int u = 0; u < TG; ++u) {
          const int t = t0 + u;
          if (t >= T) break;
          const float m = p[u] + s[kM + t * FP + j];
          s[kM + t * FP + j] = m;
          if (j < f) a.htil[size_t(t) * slot_sz + size_t(n0 + i) * f + j] = m;
        }
      }
    }
  }
  __syncthreads();
  stamp(a, 2);
  // the T message norms' statistics: one round
  if (msg_stats) {
    for (int t = 0; t < T; ++t) block_partial(x, t, state, kM + t * FP);
    arrive(x, 0, T, 0);
    for (int t = 0; t < T; ++t) combine_slot(x, t, false);
  }
  stamp(a, 3);

  // ---- T steps: the message norm and gi_t, the GRU, the state norm ------
  const float bhr = w[PL::kBhh + j], bhz = w[PL::kBhh + FP + j],
              bhn = w[PL::kBhh + 2 * FP + j];
  const float bir = w[PL::kBih + j], biz = w[PL::kBih + FP + j],
              bin = w[PL::kBih + 2 * FP + j];
  float wh[3][kWReg ? FP : 1], wi[3][kWReg ? FP : 1];
  if constexpr (kWReg) {
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int k = 0; k < FP; ++k) {
        wh[g][k] = w[PL::kWhh + k * 3 * FP + g * FP + j];
        wi[g][k] = w[PL::kWih + k * 3 * FP + g * FP + j];
      }
  }
  for (int t = 0; t < T; ++t) {
    const float* stm = st + t * 3 * FP;                 // message slot t
    const float* stp = st + (T + t - 1) * 3 * FP;       // state slot t−1
    const float* wst = w + PL::step(t);
    const float* wsp = w + PL::step(t > 0 ? t - 1 : 0);
    const float meanm = stm[j], dm = stm[2 * FP + j];
    const float maw = wst[PL::oMaW + j], mab = wst[PL::oMaB + j];
    const float meanp = t > 0 ? stp[j] : 0.f, dp = t > 0 ? stp[2 * FP + j] : 1.f;
    const float bnw = wsp[PL::oBnW + j], bnb = wsp[PL::oBnB + j];
    // two nodes a group a round, interleaved (U of them); warp-uniform
    // rounds: a slot past the nodes runs on the round's first node (or
    // node 0) and writes nothing
    constexpr int U = 2;
    for (int i0 = 0; i0 < nb; i0 += U * NG) {
      int iu[U];
      bool ok[U];
      float* s[U];
      float mb[U], hprev[U], gr[U], gz[U], gn[U], ghr[U], ghz[U], ghn[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        iu[u] = i0 + u * NG + q;
        ok[u] = iu[u] < nb;
        s[u] = ok[u] ? state + size_t(iu[u]) * ss : u > 0 ? s[0] : state;
        const float m = s[u][kM + t * FP + j];
        mb[u] = msg_stats ? maw * ((m - meanm) / dm) + mab : m;
        if (t == 0) {
          hprev[u] = s[u][kH0 + j];
        } else {
          const float xr = s[u][kX + j];
          hprev[u] = smode == kBatchBn     ? bnw * ((xr - meanp) / dp) + bnb
                     : smode == kStateless ? (xr - meanp) / dp
                                           : xr;
        }
        gr[u] = bir;
        gz[u] = biz;
        gn[u] = bin;
        ghr[u] = bhr;
        ghz[u] = bhz;
        ghn[u] = bhn;
      }
      const float* wv = w + opaque_zero();
#pragma unroll
      for (int k = 0; k < FP; ++k) {
        float i0w, i1w, i2w, h0w, h1w, h2w;
        if constexpr (kWReg) {
          i0w = wi[0][k];
          i1w = wi[1][k];
          i2w = wi[2][k];
          h0w = wh[0][k];
          h1w = wh[1][k];
          h2w = wh[2][k];
        } else {
          const float* wik = wv + PL::kWih + k * 3 * FP + j;
          const float* whk = wv + PL::kWhh + k * 3 * FP + j;
          i0w = wik[0];
          i1w = wik[FP];
          i2w = wik[2 * FP];
          h0w = whk[0];
          h1w = whk[FP];
          h2w = whk[2 * FP];
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float mk = gshfl(mb[u], k), hk = gshfl(hprev[u], k);
          gr[u] = fmaf(mk, i0w, gr[u]);
          gz[u] = fmaf(mk, i1w, gz[u]);
          gn[u] = fmaf(mk, i2w, gn[u]);
          ghr[u] = fmaf(h0w, hk, ghr[u]);
          ghz[u] = fmaf(h1w, hk, ghz[u]);
          ghn[u] = fmaf(h2w, hk, ghn[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float r = sigmoidf_(gr[u] + ghr[u]);
        const float z = sigmoidf_(gz[u] + ghz[u]);
        const float nn = tanhf(gn[u] + r * ghn[u]);
        const float hn = (1.0f - z) * nn + z * hprev[u];
        if (ok[u]) {
          s[u][kX + j] = hn;
          if (j < f)
            a.htil[size_t(T + t) * slot_sz + size_t(n0 + iu[u]) * f + j] =
                hn;
        }
      }
    }
    stamp(a, 4 + 2 * t);
    if (state_stats) {
      __syncthreads();
      block_partial(x, T + t, state, kX);
      arrive(x, T + t, T + t + 1, 1 + t);
      combine_slot(x, T + t, smode == kStateless);
    }
    stamp(a, 5 + 2 * t);
  }
  __syncthreads();

  // ---- the readout: a group a node (its gated row over its spent tile
  //      row), then a group a graph sums its nodes' rows in order ---------
  {
    const float* stT = st + (2 * T - 1) * 3 * FP;
    const float* wsT = w + PL::step(T - 1);
    const float meanT = stT[j], dT = stT[2 * FP + j];
    const float bnw = wsT[PL::oBnW + j], bnb = wsT[PL::oBnB + j];
    const float* riw = ro_gate(w, a.w);
    const float* rjw = ro_value(w, a.w);
    // two nodes a group a round, as the steps; a weight read serves both
    constexpr int U = 2;
    for (int i0 = 0; i0 < nb; i0 += U * NG) {
      bool ok[U];
      float* s[U];
      float h[U], h0v[U], pi[U][QO], pj[U][QO];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * NG + q;
        ok[u] = i < nb;
        s[u] = ok[u] ? state + size_t(i) * ss : u > 0 ? s[0] : state;
        const float raw = s[u][kX + j];
        h[u] = smode == kBatchBn     ? bnw * ((raw - meanT) / dT) + bnb
               : smode == kStateless ? (raw - meanT) / dT
                                     : raw;
        h0v[u] = s[u][kH0 + j];
#pragma unroll
        for (int v = 0; v < QO; ++v) {
          const int o = j + GS * v;
          pi[u][v] = o < ODW ? w[PL::kRib + o] : 0.f;
          pj[u][v] = o < ODW ? w[PL::kRjb + o] : 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < FP; ++k) {
        float hk[U], h0k[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          hk[u] = gshfl(h[u], k);
          h0k[u] = gshfl(h0v[u], k);
        }
#pragma unroll
        for (int v = 0; v < QO; ++v) {
          const int o = j + GS * v;
          if (o < ODW) {
            const float wi0 = riw[k * ODW + o], wj0 = rjw[k * ODW + o];
            const float wi1 = riw[(FP + k) * ODW + o],
                        wj1 = rjw[(FP + k) * ODW + o];
#pragma unroll
            for (int u = 0; u < U; ++u) {
              pi[u][v] = fmaf(hk[u], wi0, pi[u][v]);
              pj[u][v] = fmaf(hk[u], wj0, pj[u][v]);
              pi[u][v] = fmaf(h0k[u], wi1, pi[u][v]);
              pj[u][v] = fmaf(h0k[u], wj1, pj[u][v]);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float mx = -INFINITY;
#pragma unroll
        for (int v = 0; v < QO; ++v)
          if (j + GS * v < od) mx = fmaxf(mx, pi[u][v]);
        mx = gmax(mx);
        float den = 0.f;
#pragma unroll
        for (int v = 0; v < QO; ++v) {
          pi[u][v] = j + GS * v < od ? expf(pi[u][v] - mx) : 0.f;
          den += pi[u][v];
        }
        den = gsum(den);
        if (ok[u]) {
#pragma unroll
          for (int v = 0; v < QO; ++v) {
            const int o = j + GS * v;
            if (o < ODW) s[u][o] = (pi[u][v] / den) * pj[u][v];
          }
        }
      }
    }
    stamp(a, 70);
    __syncthreads();
    float* lossg = a.scratch + sc.lossg;
    for (int g0 = x.lo; g0 < x.hi; g0 += NG) {
      const int g = g0 + q;
      const bool ok = g < x.hi;
      const int v0 = ok ? __ldg(a.graph_node_ptr + g) - n0 : 0;
      const int v1 = ok ? __ldg(a.graph_node_ptr + g + 1) - n0 : 0;
      float l = 0.f;
#pragma unroll
      for (int u = 0; u < QO; ++u) {
        const int o = j + GS * u;
        if (o >= od) continue;
        KSum ks;
        for (int v = v0; v < v1; ++v) ks.add(state[size_t(v) * ss + o]);
        const float acc = ks.s;
        if (ok) {
          a.out[size_t(g) * od + o] = acc;
          const float d = acc - __ldg(a.labels + g);
          l = fmaf(d * d, __ldg(a.gmask + g), l);
        }
      }
      l = gsum(l);
      if (ok && j == 0) lossg[g] = l;
    }
  }
  stamp(a, 71);
}

// The empty forward: the route's grid, each round's combine of zero
// partials and the route's finish; no staging and no arithmetic.
__device__ void floor_body(Ctx& x) {
  const FwdArgs& a = x.a;
  float* bp = x.sm + x.L2.cpart;
  for (int i = threadIdx.x; i < 2 * x.T * kRow; i += kFT) bp[i] = 0.f;
  __syncthreads();
  if (has_stats(a.msg_mode)) {
    arrive(x, 0, x.T, 0);
    for (int t = 0; t < x.T; ++t) combine_slot(x, t, false);
  }
  for (int t = 0; t < x.T; ++t)
    if (has_stats(a.state_mode)) {
      arrive(x, x.T + t, x.T + t + 1, 1 + t);
      combine_slot(x, x.T + t, a.state_mode == kStateless);
    }
}

// loss = Σ_g term_g / Σ_g gm_g in graph order, by one block
__device__ void loss_sum(Ctx& x) {
  const FwdArgs& a = x.a;
  const float* lossg = a.scratch + Scratch(a.n_nodes, a.n_edges, a.n_graphs,
                                           a.steps, x.nblocks).lossg;
  float* red = x.sm + x.L2.red;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  KSum num, den;
  if (!a.floor)
    for (int g = tid; g < a.n_graphs; g += kFT) {
      num.add(__ldcg(lossg + g));
      den.add(__ldg(a.gmask + g));
    }
  const float sn0 = mpnn_train::warp_sum(num.s),
              sd0 = mpnn_train::warp_sum(den.s);
  if (lane == 0) {
    red[warp] = sn0;
    red[kFW + warp] = sd0;
  }
  __syncthreads();
  if (tid == 0) {
    float sn = 0.f, sd = 0.f;
    for (int w = 0; w < kFW; ++w) {
      sn += red[w];
      sd += red[kFW + w];
    }
    a.loss[0] = a.floor ? 0.f : sn / sd;
  }
}

// The route's end: the loss by the last block of the grid (an integer
// counter), cluster rank 0 or the one block; the grid's last block sets
// every counter back to zero (every block has passed every round).
__device__ void finish(Ctx& x) {
  const FwdArgs& a = x.a;
  const int tid = threadIdx.x;
  __threadfence();
  if (a.route == kRouteCluster && a.cluster > 1) {
    // also keeps every block's shared memory alive until its peers have
    // read its partial rows
    cg::this_cluster().sync();
    if (x.b == 0) loss_sum(x);
    return;
  }
  if (x.nblocks == 1) {
    __syncthreads();
    loss_sum(x);
    return;
  }
  __syncthreads();
  int last = 0;
  if (tid == 0) last = atomicAdd(a.counters + kDone, 1) == x.nblocks - 1;
  if (!__syncthreads_or(last)) return;
  if (tid < kCounters) a.counters[tid] = 0;
  __threadfence();
  loss_sum(x);
}

__global__ void __launch_bounds__(kFT) fused_psteps_fwd_kernel(FwdArgs a) {
  extern __shared__ float sm[];
  const int tid = threadIdx.x;
  const int nblocks = a.route == kRouteCluster ? a.cluster : int(gridDim.x);
  Ctx x{a, sm, a.steps, a.f, a.od, int(blockIdx.x), nblocks,
        node_floats(a.steps), 0, 0, 0, 0, 0, 0, 0,
        Smem(a.k_vocab, a.steps, a.ncap, a.ecap, nblocks, a.amat_smem)};
  stamp(a, 0);
  if (!a.floor) stage_weights_async(sm, sm + x.L2.amat, a);
  else
    for (int i = tid; i < 2 * a.steps * 3 * FP; i += kFT)
      sm[PL::stats(a.steps) + i] = (i % (3 * FP)) < FP ? 0.f : 1.f;
  x.n_real = __ldg(a.graph_node_ptr + a.n_graphs);
  {
    int* slot = reinterpret_cast<int*>(sm + x.L2.red);
    const long long nr = x.n_real;
    first_graphs_at(a.graph_node_ptr, a.n_graphs,
                    int(nr * x.b / nblocks),
                    x.b + 1 == nblocks ? x.n_real + 1
                                       : int(nr * (x.b + 1) / nblocks),
                    slot, x.lo, x.hi);
    x.n0 = __ldg(a.graph_node_ptr + x.lo);
    x.nb = __ldg(a.graph_node_ptr + x.hi) - x.n0;
    x.e0 = __ldg(a.dst_ptr + x.n0);
    x.eb = __ldg(a.dst_ptr + x.n0 + x.nb) - x.e0;
  }
  {
    // padded node slots carry zero in every stash slot; the stats rows of
    // a norm without statistics are zero
    const int N = a.n_nodes, f = a.f, T = a.steps;
    const size_t slot_sz = size_t(N) * f;
    const size_t pad = size_t(N - x.n_real) * f;
    for (size_t i = size_t(blockIdx.x) * kFT + tid; i < pad * (2 * T);
         i += size_t(gridDim.x) * kFT)
      a.htil[(i / pad) * slot_sz + size_t(x.n_real) * f + i % pad] = 0.f;
    if (blockIdx.x == 0)
      for (int i = tid; i < 2 * T * 2 * f; i += kFT) {
        const int s = i / (2 * f);
        if (a.floor || !has_stats(s < T ? a.msg_mode : a.state_mode))
          a.stats[i] = 0.f;
      }
  }
  __syncthreads();
  if (a.floor)
    floor_body(x);
  else if (x.nb <= a.ncap && x.eb <= a.ecap)
    body<true>(x);
  else
    body<false>(x);
  finish(x);
  stamp(a, 75);
}

// Checks the route's arguments; 0 when they hold.
inline int check_args(const FwdArgs& a, int grid) {
  if (a.f < 1 || a.f > FP || a.od < 1 || a.od > ODW || a.steps < 1 ||
      a.steps > kMaxSteps || grid < 1 || a.ncap < 1 || a.ecap < 0 ||
      (a.msg_mode != kNone && a.msg_mode != kBatchBn) ||
      (a.state_mode != kNone && a.state_mode != kBatchBn &&
       a.state_mode != kStateless) ||
      (a.amat_smem &&
       a.steps * a.k_vocab * FP * FP > kAmatSmemFloats) ||
      (a.route == kRouteCluster &&
       (grid != 1 && grid != 2 && grid != 4 && grid != 8)) ||
      (a.route == kRouteGrid &&
       (grid > kMaxGrid || (grid > 1 && !a.counters))) ||
      (a.route != kRouteCluster && a.route != kRouteGrid))
    return int(cudaErrorInvalidValue);
  return 0;
}

}  // namespace mpnn_psfwd

using mpnn_psfwd::FwdArgs;

extern "C" {

// Dynamic shared memory of one block, in bytes, for a tile of ncap nodes
// and ecap edges in a launch of `blocks` blocks (kernels/fused_psteps.py::
// fwd_smem_floats mirrors it).
int mpnn_fused_psteps_fwd_smem_bytes(int k_vocab, int steps, int ncap,
                                     int ecap, int blocks, int amat_smem) {
  return int(mpnn_psfwd::fwd_smem_bytes(k_vocab, steps, ncap, ecap, blocks,
                                        amat_smem != 0));
}

long long mpnn_fused_psteps_fwd_scratch_floats(int n_nodes, int n_edges,
                                               int n_graphs, int steps,
                                               int grid) {
  return (long long)mpnn_psfwd::Scratch(n_nodes, n_edges, n_graphs, steps,
                                        grid).total;
}

// The co-resident blocks at this much dynamic shared memory a block,
// capped at the grid route's kMaxGrid; 0 on error.
int mpnn_fused_psteps_fwd_max_grid(int bytes) {
  static_assert(mpnn_psfwd::kMaxGrid == mpnn_step::kMaxGrid,
                "forward_max_grid caps at the grid route's rows");
  return mpnn_step::forward_max_grid(mpnn_psfwd::fused_psteps_fwd_kernel,
                                     bytes);
}

// Ints of the grid route's counter buffer.
int mpnn_fused_psteps_fwd_counters() { return mpnn_psfwd::kCounters; }

// Launches on `stream` and returns the launch's error code (0 = success).
// Does not synchronize and allocates nothing. route 0: one cluster of
// `grid` blocks (1, 2, 4 or 8); route 1: `grid` co-resident blocks (a
// cooperative launch, for co-residency only). counters: the grid route's
// kCounters ints, zero (every launch leaves them zero). prof: null or
// kProfSlots int64. floor: the empty forward (the same grid and
// combines, no staging or arithmetic).
int mpnn_fused_psteps_fwd(
    const float* amat, const float* a0, const float* mbias,
    const float* w_ih, const float* w_hh, const float* b_ih,
    const float* b_hh, const float* ma_w, const float* ma_b,
    const float* bn_w, const float* bn_b, const float* ro_iw,
    const float* ro_ib, const float* ro_jw, const float* ro_jb,
    const float* h0, const float* labels, const float* gmask, const int* vid,
    const int* src, const int* edge_order, const int* dst_ptr,
    const int* graph_node_ptr, float* loss, float* out, float* stats,
    float* htil, float* scratch, int* counters, long long* prof,
    int n_nodes, int n_graphs, int n_edges, int f, int od, int k_vocab,
    int steps, int msg_mode, int state_mode, int route, int grid, int ncap,
    int ecap, int amat_smem, int floor, void* stream) {
  FwdArgs a{{amat, a0, mbias, w_ih, w_hh, b_ih, b_hh, ma_w, ma_b, bn_w,
             bn_b, ro_iw, ro_ib, ro_jw, ro_jb},
            h0, labels, gmask, vid, src, edge_order, dst_ptr,
            graph_node_ptr, loss, out, stats, htil, scratch, counters, prof,
            n_nodes, n_graphs, n_edges, f, od, k_vocab, steps, msg_mode,
            state_mode, route, grid, ncap, ecap, amat_smem, floor};
  if (const int err = mpnn_psfwd::check_args(a, grid)) return err;
  const size_t bytes = mpnn_psfwd::fwd_smem_bytes(k_vocab, steps, ncap,
                                                  ecap, grid, amat_smem);
  auto kernel = mpnn_psfwd::fused_psteps_fwd_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == mpnn_psfwd::kRouteGrid) {
    void* args[] = {&a};
    err = cudaLaunchCooperativeKernel((void*)kernel, dim3(grid),
                                      dim3(mpnn_psfwd::kFT), args, bytes, s);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(mpnn_psfwd::kFT);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = grid;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = grid > 1 ? 1 : 0;
    err = cudaLaunchKernelEx(&cfg, kernel, a);
  }
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
