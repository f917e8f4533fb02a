// Whole-step TRAINING backward of the per-step edge-network MPNN (the
// graph_norm and encoded training path), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mpnn_tpu/kernels/fused_psteps.py::_ps_bwd_kernel
// (the monolithic VJP of make_fused_psteps_op, with its reverse walk
// psteps_reverse_walk inlined). It has no node cap: the Pallas op streams
// its backward past PS_MONO_BWD_NPAD_CAP padded nodes (_ps_stream_walk_
// kernel and its helpers) only because of the TPU's VMEM; this kernel
// computes the same function at any size that fits device memory. Given
// the cotangents gl of the loss and gout of out and the forward's
// residuals (htil, the per-slot statistics, out) it computes every leaf:
//
//   dout  = gl·2(out − y)·gm/Σgm + gout
//   readout VJP per node (softmax over od) → ∂h_T, ∂h0, ∂W_i, ∂W_j, ∂b
//   for t = T−1..0:
//     state-norm VJP of step t with its batch sums S1 = Σ dx̂,
//       S2 = Σ dx̂·x̂ (closed form dx = (dx̂ − S1/c)/d − x̂·S2/(c·s); bn1d:
//       s = √max(var, 1e-12), d = s + 1e-5, dx̂ = w·g; stateless:
//       d = s = √(var + 1e-6), dx̂ = g), ∂bn_t
//     GRU VJP → ∂h_{t−1}, ∂W_ih, ∂W_hh, ∂b_ih, ∂b_hh (b_hh's n part sees
//       r·∂n), ∂(message input of step t)
//   after the walk, each step's message-norm VJP (its own batch sums, all
//     T combined in one round) → ∂m_t, ∂ma_bn_t
//   per step t: dA0_t = Σ_g (Σ_{v∈g} ∂m_t,v) ⊗ S_g, ∂mbias_t = Σ ∂m_t;
//     ∂h0_v += Σ_t A0_tᵀ·Σ_{w∈g(v)} ∂m_t,w (bias leakage)
//              + Σ_{e: src_e = v} Σ_t A_t[vid_e]ᵀ·∂m_t,dst_e;
//     dA_t[k] = Σ_{e: vid_e = k} ∂m_t,dst_e ⊗ h0_src_e;
//     under the message bn1d (Σ ∂m_t = 0) dA0_t −= ∂mbias_t ⊗ S̄, S̄ the
//     mean over the real nodes of their graph's S (center_da0).
//
// Design (walk_bwd.cuh, as the shared family's fused_step_bwd.cu). A node
// is a GROUP of FP lanes, one feature a lane; a block of 256 threads owns
// whole graphs (a contiguous node range, balanced by node count), so the
// message VJP, dA_t and dA0_t are block-local. The walk's per-node state
// (∂h, x̂, h0, ∂h0 and each step's ∂mb_t) stays in a shared-memory tile for
// the whole launch; each step's two stash rows (the previous state, the
// step's messages) are staged one step ahead with cp.async. The input
// gates of step t are formed from its normalized messages per node. A
// lane keeps its column of ∂W_hh (and, in the narrow build, of ∂W_ih) in
// registers over its nodes; the wide build sums ∂W_ih from rows staged a
// round at a time, an element a thread. The transposed products W_hhᵀ·da
// and W_ihᵀ·da are reduce-scatters over the group. The readout's weight
// gradient is a register-tiled outer product over staged node rows; dA_t
// walks the block's edges in vocab order (a stable counting sort per
// block, one segment per id).
//
// Routes (kernels/fused_psteps.py::launch_shape decides on the host, from
// shapes alone): one thread-block cluster of 1-8 blocks whose state-norm
// sums of each step go through distributed shared memory, or a grid of
// co-resident blocks whose sums go through per-round flags in global
// memory (a cooperative launch, for co-residency only: no grid barrier).
// The T message norms' sums combine in ONE round after the walk. The
// blocks' gradient rows are summed in block order by the last block of
// each counter group (an integer counter the block resets): no memset
// before the launch, no float atomics. A block whose graphs do not fit
// its tile keeps that state in its region of global scratch instead (the
// same code).
//
// Numerics: float32 FMA only. Every cross-thread sum runs in a fixed order
// (groups, then warps, then blocks or ranks), so a launch gives the same
// bits on every run of the same route; per-graph sums over nodes take
// four interleaved partials.
//
// Bound on an H100 SXM: f32 CUDA-core arithmetic on a few MB
// (chip_smoke.py::_ps_bounds).

#include "fused_psteps_common.cuh"
#include "walk_bwd.cuh"

namespace {

using namespace mpnn_psteps;
using namespace mpnn_walk;

// Flat layout of the gradient output (and of each block's partial row):
// real (unpadded) shapes, in this order. kernels/fused_psteps.py::
// grad_layout mirrors it and checks it against mpnn_fused_psteps_bwd_layout.
struct PsGradLayout {
  int a, a0, mbias, wih, whh, bih, bhh, maw, mab, bnw, bnb, riw, rib, rjw,
      rjb, total;
  __host__ __device__ PsGradLayout(int k, int f, int od, int T) {
    a = 0;
    a0 = a + T * k * f * f;
    mbias = a0 + T * f * f;
    wih = mbias + T * f;
    whh = wih + 3 * f * f;
    bih = whh + 3 * f * f;
    bhh = bih + 3 * f;
    maw = bhh + 3 * f;
    mab = maw + T * f;
    bnw = mab + T * f;
    bnb = bnw + T * f;
    riw = bnb + T * f;
    rib = riw + 2 * f * od;
    rjw = rib + od;
    rjb = rjw + 2 * f * od;
    total = rjb + od;
  }
};

// rounds of batch sums: the T state slots, then the T message slots in one
constexpr int kRounds = kMaxSteps + 1;
constexpr int kFlagWords = flag_words(kRounds);
// the readout: outputs a lane (contiguous), nodes a group stages a round,
// the staged row [h | h0 | 1 0 0 0 | dpi (ODW) | djv (ODW)]
constexpr int QO = ODW >= GS ? ODW / GS : 1;
constexpr int kRoR = 2;
constexpr int kXW = 2 * FP + 4;
constexpr int kRS = kXW + 2 * ODW;
constexpr int kRoRows = NG * kRoR;
// its weight-gradient tiles: 4 rows of x by 4 outputs, (gate|value) ×
// k-blocks × o-blocks; depth (the staged rows) split over idle threads
constexpr int kKB = kXW / 4;
constexpr int kOB = ODW / 4;
constexpr int kNT = 2 * kKB * kOB;
constexpr int kDS = kNT >= kBT ? 1 : kBT / kNT;
constexpr int kTPT = kDS > 1 ? 1 : (kNT + kBT - 1) / kBT;
static_assert(ODW % GS == 0 || ODW < GS, "outputs a lane");
static_assert(QO == 1 || QO == 2 || QO == 4, "1, 2 or 4 outputs a lane");
// per-node state (floats): ∂h, x̂ (of the state slot being walked), h0,
// ∂h0 (its readout, step-0 and message parts, written out once), then
// ∂mb_t of each step t (∂m_t once the message norms' sums are in): a
// node's stride is (4 + T)·FP
constexpr int kGh = 0, kXh = FP, kH0 = 2 * FP, kD0 = 3 * FP, kDm = 4 * FP;
// ∂W_ih's and ∂W_hh's columns a lane in registers at FP 16; at FP 32
// (192 registers) a round's messages, previous states and gates are
// staged as rows [mb | h | da_r | da_z | da_n | r·∂n] and the padded
// W_ih, W_hh, b_ih, b_hh summed an element a thread
constexpr bool kWReg = FP <= 16;
constexpr int kWS = 6 * FP;                            // a staged row
constexpr int kGruEl = 6 * FP * FP + 6 * FP;
constexpr int kOwn = kWReg ? 1 : (kGruEl + kBT - 1) / kBT;

struct PsBwdArgs {
  PsWeights w;
  const float* h0;          // (N, f), pre-masked
  const float* labels;      // (G)
  const float* gmask;       // (G)
  const float* out;         // (G, od) forward output
  const float* gout;        // (G, od) cotangent of out
  const float* gl;          // (1) cotangent of the loss
  const float* htil;        // (2T, N, f) forward residuals
  const float* stats;       // (2T, 2, f) forward batch statistics
  const int* vid;           // (E)
  const int* src;           // (E)
  const int* dst;           // (E)
  const int* src_order;     // (E) edge ids, stably sorted by source
  const int* src_ptr;       // (N + 1) row pointers into src_order
  const int* graph_node_ptr;  // (G + 1)
  const int* node_graph;    // (N)
  float* dh0;               // (N, f)
  float* dw;                // PsGradLayout(K, f, od, T).total
  float* scratch;           // scratch_floats(...)
  unsigned long long* flags;  // grid route: kFlagWords, zero once
  int* counters;            // grid route: kMaxGroups + 1, zero between launches
  long long* prof;          // null, or kProfSlots clock64 stamps (block 0)
  int n_nodes, n_graphs, n_edges, f, od, k_vocab, steps, msg_mode,
      state_mode;
  int route, ncap, ecap, floor;
};

// ---------------------------------------------------------------------------
// shared memory and scratch layouts
// ---------------------------------------------------------------------------

// Offsets (floats) of one block's shared memory past the staged weights
// and the 2T slots' norm constants (PL::after_stats).
struct Smem {
  int tot, sbar, cpart, misc, red, tile, wst, ints, sb, state, total;
  __host__ __device__ Smem(int k_vocab, int steps, int ncap, int ecap) {
    int off = al4(PL::after_stats(steps));
    tot = off;    off += al4(3 * FP * steps);
    sbar = off;   off += FP;
    // the state rounds' partials, then the message round's: [S1 | S2 |
    // Σx̂] a slot
    cpart = off;  off += 6 * FP * steps;
    misc = off;   off += 4;
    red = off;    off += kRed;
    tile = off;   off += kRoRows * kRS;
    wst = off;    off += kWReg ? 0 : NG * kWS;
    // ints: node graphs (ncap), source pointers (ncap + 1), edges (4 ints
    // each), the sorted edge list, per-warp vocab counts, segment starts
    ints = off;
    off += al4(ncap + ncap + 1 + 5 * ecap + (kWB + 1) * k_vocab + 1);
    sb = off;     off += 2 * ncap * 2 * FP;
    state = off;  off += ncap * (4 + steps) * FP;
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
    const size_t nw = PsGradLayout(k, f, od, steps).total;
    size_t off = 0;
    state = off;   off += size_t(n) * (4 + steps) * FP;  // spilled tiles
    // node graphs (n), source pointers (n + a slot a block), edges
    ints = off;    off += size_t(2 * n + grid + 1) + 5 * size_t(e);
    cparts = off;  off += size_t(6) * FP * steps * grid;
    // a block's gradient row and its FP partials of Σ_g n_g·S_g
    rows = off;    off += size_t(grid) * (nw + FP);
    gparts = off;  off += size_t(kMaxGroups) * nw;
    total = off;
  }
};

struct Ctx {
  const PsBwdArgs& a;
  float* sm;
  Smem L2;
  Sync y;
  const PsGradLayout gl;
  float* row;               // this block's gradient row
  float* prow;              // its FP partials of Σ_g n_g·S_g (center_da0)
  int T, f, od, SS;
  int n0, n1, nb, e0, eb, lo, hi, n_real;
  float c, inv_gsum, gl_v;
};

// The totals over the launch's blocks of state round r's block partial
// (3f floats packed to the real features, cpart + r·3FP) into tot.
__device__ void combine_state(Ctx& x, int r) {
  const PsBwdArgs& a = x.a;
  const int G = x.y.nblocks;
  float* gp = a.scratch +
              Scratch(a.n_nodes, a.n_edges, a.k_vocab, a.f, a.od, a.steps,
                      G).cparts + size_t(r) * G * 3 * FP;
  combine(x.y, x.sm + x.L2.cpart + r * 3 * FP, x.sm + x.L2.tot, 3 * x.f, gp,
          a.flags + size_t(r) * kMaxGrid * kFlagStride, x.sm + x.L2.red);
}

// The totals of the T message slots' block partials (T·3f floats packed
// to the real features, one round) into tot.
__device__ void combine_messages(Ctx& x) {
  const PsBwdArgs& a = x.a;
  const int G = x.y.nblocks, T = x.T;
  float* gp = a.scratch +
              Scratch(a.n_nodes, a.n_edges, a.k_vocab, a.f, a.od, T, G)
                  .cparts + size_t(T) * G * 3 * FP;
  combine(x.y, x.sm + x.L2.cpart + T * 3 * FP, x.sm + x.L2.tot, 3 * x.f * T,
          gp, a.flags + size_t(T) * kMaxGrid * kFlagStride, x.sm + x.L2.red);
}

// Under the message bn1d Σ_g D_t,g = 0 (Σ ∂m_t over the batch), so dA0_t =
// Σ_g D_t,g ⊗ (S_g − S̄) for any S̄. With S̄ = Σ_g n_g·S_g / c (the mean
// over the real nodes of their graph's Σh0) a shift common to every
// node's ∂m_t, which the norm's rounding leaves, cancels instead of
// growing with a large graph's S: on the totals, dA0_t −= ∂mbias_t ⊗ S̄.
// `prows` holds nrows partials of Σ n_g·S_g (stride ld; global memory
// when `global`), summed in row order. dw's A0 and mbias entries are
// complete; one block's threads call it.
__device__ void center_da0(Ctx& x, const float* prows, int nrows, size_t ld,
                           bool global) {
  const PsBwdArgs& a = x.a;
  const int tid = threadIdx.x, f = x.f;
  float* sbar = x.sm + x.L2.sbar;
  if (tid < f) {
    float s = 0.f;
    for (int r = 0; r < nrows; ++r)
      s += global ? __ldcg(prows + r * ld + tid) : prows[r * ld + tid];
    sbar[tid] = s / x.c;
  }
  __syncthreads();
  for (int e = tid; e < x.T * f * f; e += kBT) {
    const int t = e / (f * f), mj = e % (f * f);
    a.dw[x.gl.a0 + e] = __ldcg(a.dw + x.gl.a0 + e) -
                        __ldcg(a.dw + x.gl.mbias + t * f + mj / f) *
                            sbar[mj % f];
  }
  __syncthreads();
}

// A norm's x̂ has mean zero over the real nodes; the batch mean x̄ that
// the stash and its statistics leave (a large graph's messages share a
// large offset) is taken out: S2 = Σ dx̂·(x̂ − x̄) = S2 − S1·x̄ on the
// totals, x̂ − x̄ per node, and ∂w −= ∂b·x̄ on each block's row (the
// affine's gradients at `ow`, `ob`), which sums to the same on the
// totals. `tot` holds [S1 | S2 | Σx̂] of the slot (f each); returns x̄ of
// lane j's feature and corrects tot's S2. Every thread calls it.
__device__ float center_xhat(Ctx& x, float* tot, int ow, int ob,
                             bool affine) {
  const int tid = threadIdx.x, j = tid % GS, f = x.f;
  const float xbar = j < f ? tot[2 * f + j] / x.c : 0.f;
  __syncthreads();
  if (tid < f) {
    const float xb = tot[2 * f + tid] / x.c;
    tot[f + tid] -= tot[tid] * xb;
    if (affine) x.row[ow + tid] -= x.row[ob + tid] * xb;
  }
  __syncthreads();
  return xbar;
}

// The first graphs g in [0, G] with graph_node_ptr[g] >= t0 and >= t1,
// found by the block's threads together (one latency).
__device__ void first_graphs_at(const PsBwdArgs& a, int t0, int t1,
                                int* slot, int& g0, int& g1) {
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
            tile + r * kRS + kXW + which * ODW + ob * 4);
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

// y = the state norm of slot mode `smode` from x̂ or the raw value
__device__ __forceinline__ float state_norm(int smode, float raw, float xh,
                                            float w, float b) {
  return smode == kBatchBn ? fmaf(w, xh, b) : smode == kStateless ? xh : raw;
}

// The batch sums of a state slot's norm VJP from the tile (∂h and x̂ as
// the pass before left them, each group its own nodes): S1 = Σ dx̂,
// S2 = Σ dx̂·x̂ with dx̂ = ∂h·dxw, Σ x̂ (center_xhat), and the affine's
// Σ ∂h·x̂, Σ ∂h, as compensated per-lane sums over the block's nodes,
// then over its groups in order, into round r's partial and the row (the
// affine of step r, under bn1d; zero otherwise). Every thread calls it.
__device__ void state_sums(Ctx& x, const float* state, int nb, int r,
                           float dxw) {
  const int q = threadIdx.x / GS, j = threadIdx.x % GS, SS = x.SS;
  const int f = x.f;
  Ksum s1, s2, sx, sw, sb;
  if (has_stats(x.a.state_mode))
    for (int i = q; i < nb; i += NG) {
      const float* s = state + size_t(i) * SS;
      const float gh = s[kGh + j], xh = s[kXh + j];
      const float v0 = gh * dxw;
      s1.add(v0);
      s2.add(v0 * xh);
      sx.add(j < f ? xh : 0.f);
      sw.add(gh * xh);
      sb.add(gh);
    }
  float v[5] = {s1.s, s2.s, sx.s, sw.s, sb.s};
  float* cpart = x.sm + x.L2.cpart + r * 3 * FP;
  const bool bn = x.a.state_mode == kBatchBn;
  groups_to<5>(v, x.sm + x.L2.red, [&](int i, int jj, float t) {
    if (jj >= f) return;
    if (i < 3)
      cpart[i * f + jj] = t;
    else
      x.row[(i == 3 ? x.gl.bnw : x.gl.bnb) + r * f + jj] = bn ? t : 0.f;
  });
}

// The same for the message norm of step t from ∂mb_t in the tile and x̂
// of the step's messages (the stash's slot t), with Σ x̂ beside S1 and S2
// (center_xhat), into the message round's partial and the row.
__device__ void message_sums(Ctx& x, const float* state, int nb, int t) {
  const PsBwdArgs& a = x.a;
  const int q = threadIdx.x / GS, j = threadIdx.x % GS, SS = x.SS, f = x.f;
  const float* stm = x.sm + PL::stats(x.T) + t * 3 * FP;
  const float maw = x.sm[PL::step(t) + PL::oMaW + j];
  const float rdm = 1.0f / stm[2 * FP + j], meanm = stm[j];
  const size_t slot = size_t(t) * a.n_nodes * f;
  Ksum s1, s2, sx, sw, sb;
  for (int i = q; i < nb; i += NG) {
    const float dmb = state[size_t(i) * SS + kDm + t * FP + j];
    const float mraw =
        j < f ? __ldg(a.htil + slot + size_t(x.n0 + i) * f + j) : 0.f;
    const float xm = (mraw - meanm) * rdm;
    const float v0 = dmb * maw;
    s1.add(v0);
    s2.add(v0 * xm);
    sx.add(j < f ? xm : 0.f);
    sw.add(dmb * xm);
    sb.add(dmb);
  }
  float v[5] = {s1.s, s2.s, sx.s, sw.s, sb.s};
  float* cpart = x.sm + x.L2.cpart + 3 * FP * x.T + t * 3 * f;
  groups_to<5>(v, x.sm + x.L2.red, [&](int i, int jj, float s) {
    if (jj >= f) return;
    if (i < 3)
      cpart[i * f + jj] = s;
    else
      x.row[(i == 3 ? x.gl.maw : x.gl.mab) + t * f + jj] = s;
  });
}

// The body of one block, its per-node state in shared memory (kSm) or in
// its region of global scratch.
template <bool kSm>
__device__ void body(Ctx& x) {
  const PsBwdArgs& a = x.a;
  float* sm = x.sm;
  const int tid = threadIdx.x, q = tid / GS, j = tid % GS;
  const int f = x.f, od = x.od, T = x.T, N = a.n_nodes, SS = x.SS;
  const int n0 = x.n0, nb = x.nb, e0 = x.e0, eb = x.eb;
  const int mmode = a.msg_mode, smode = a.state_mode;
  const bool msg_bn = mmode == kBatchBn, state_stats = has_stats(smode);
  const Scratch sc(N, a.n_edges, a.k_vocab, f, od, T, x.y.nblocks);
  const size_t slot_sz = size_t(N) * f;
  const PsGradLayout& gl = x.gl;
  const float* w = sm;
  const float* st = sm + PL::stats(T);
  float* red = sm + x.L2.red;
  float* tile = sm + x.L2.tile;
  float* state = kSm ? sm + x.L2.state
                     : a.scratch + sc.state + size_t(n0) * SS;
  float* sbuf = sm + x.L2.sb;            // staged stash rows (kSm only)
  const int ncap = a.ncap, ecap = a.ecap;
  int* ibase = kSm ? reinterpret_cast<int*>(sm + x.L2.ints)
                   : reinterpret_cast<int*>(a.scratch + sc.ints);
  // node graphs and local source pointers of the block's nodes; the
  // edges (in source order) as (src, dst, vid) local; the sorted list
  const size_t ge = size_t(2 * N + x.y.nblocks + 1);   // spilled edges
  int* ngl = ibase + (kSm ? 0 : n0);
  int* sptr = kSm ? ibase + ncap : ibase + N + n0 + x.y.b;
  int* einfo = kSm ? ibase + 2 * ncap + 1 : ibase + ge + 4 * size_t(e0);
  int* slist = kSm ? einfo + 4 * ecap : ibase + ge + 4 * size_t(a.n_edges) + e0;
  int* vcnt = reinterpret_cast<int*>(sm + x.L2.ints) +
              (kSm ? 2 * ncap + 1 + 5 * ecap : 0);
  const int K = a.k_vocab;
  int* seg = vcnt + kWB * K;             // K + 1 segment starts
  float* row = x.row;

  // ---- staging: the block's nodes, edges and the last state slot ----------
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
      copy4<kSm>(s + kXh + jj, a.htil + size_t(2 * T - 1) * slot_sz + g);
      copy4<kSm>(s + kH0 + jj, a.h0 + g);
    } else {
      s[kXh + jj] = 0.f;
      s[kH0 + jj] = 0.f;
    }
  }
  // step t's stash rows into buffer t & 1: [the previous state slot
  // T + t − 1 (step t > 0) | the messages of slot t]
  auto stage_step = [&](int t) {
    if constexpr (kSm) {
      float* buf = sbuf + (t & 1) * ncap * 2 * FP;
      for (int i = tid; i < nb * 2 * FP; i += kBT) {
        const int v = i / (2 * FP), c = i % (2 * FP);
        const int jj = c % FP, half = c / FP;
        if (jj < f && (half == 1 || t > 0))
          cp_async4(buf + i,
                    a.htil + size_t(half ? t : T + t - 1) * slot_sz +
                        size_t(n0 + v) * f + jj);
        else
          buf[i] = 0.f;
      }
    }
  };
  stage_step(T - 1);
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
  stamp(a.prof, 1);

  // ---- the readout + loss VJP ---------------------------------------------
  {
    const float* stT = st + (2 * T - 1) * 3 * FP;
    const float* wsT = w + PL::step(T - 1);
    const float bnw = wsT[PL::oBnW + j], bnb = wsT[PL::oBnB + j];
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
        const int g = ngl[ok ? i : 0];
        // h = the state norm of the last slot (x̂ kept for the walk), h0
        const float raw = s[kXh + j];
        const float xh = state_stats ? (raw - stT[j]) / stT[2 * FP + j] : 0.f;
        const float h = state_norm(smode, raw, xh, bnw, bnb);
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
          pi[uo] = o < ODW ? w[PL::kRib + o] : 0.f;
          pj[uo] = o < ODW ? w[PL::kRjb + o] : 0.f;
        }
        if (j * QO < ODW) {
#pragma unroll 8
          for (int k = 0; k < 2 * FP; ++k) {
            const float xk = xr[k];
            const float* wi = riw + k * ODW + j * QO;
            const float* wj = rjw + k * ODW + j * QO;
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
          if (o < ODW) {
            xr[kXW + o] = pi[uo];
            xr[kXW + ODW + o] = pj[uo];
          }
        }
        // ∂h_T and ∂h0 (readout part): p[2k] the h row k, p[2k+1] the h0
        // row k, reduce-scattered to lane k
        float p[2 * FP];
#pragma unroll
        for (int k = 0; k < FP; ++k) {
          float th = 0.f, t0 = 0.f;
          if (j * QO < ODW) {
#pragma unroll
            for (int uo = 0; uo < QO; ++uo) {
              const int o = j * QO + uo;
              th = fmaf(riw[k * ODW + o], pi[uo], th);
              th = fmaf(rjw[k * ODW + o], pj[uo], th);
              t0 = fmaf(riw[(FP + k) * ODW + o], pi[uo], t0);
              t0 = fmaf(rjw[(FP + k) * ODW + o], pj[uo], t0);
            }
          }
          p[2 * k] = th;
          p[2 * k + 1] = t0;
        }
        reduce_scatter<2 * FP>(p, j);
        const float gh = p[0];
        __syncwarp();
        if (ok) {
          s[kGh + j] = gh;
          s[kD0 + j] = p[1];
        } else {
          for (int cc = j; cc < kRS; cc += GS) xr[cc] = 0.f;
        }
      }
      __syncthreads();
      rt.add(tile);
      __syncthreads();
    }
    rt.store(x, red);
  }
  stamp(a.prof, 2);

  // ---- the reverse walk, t = T−1..0 --------------------------------------
  constexpr int kCol = kWReg ? FP : 1;
  float dwh[3][kCol], dwi[3][kCol], own[kOwn];
  float bhh_acc[3] = {0.f, 0.f, 0.f}, bih_acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int k = 0; k < kCol; ++k) dwh[g][k] = dwi[g][k] = 0.f;
#pragma unroll
  for (int i = 0; i < kOwn; ++i) own[i] = 0.f;
  const float* tot = sm + x.L2.tot;
  float* cpart = sm + x.L2.cpart;
  for (int t = T - 1; t >= 0; --t) {
    // the state sums of slot T + t (the tile as the pass before left it)
    // into round t's partial and the row; their combine
    state_sums(x, state, nb,  t,
               smode == kBatchBn ? w[PL::step(t) + PL::oBnW + j] : 1.f);
    float xbar = 0.f;
    if (state_stats) {
      combine_state(x, t);
      xbar = center_xhat(x, sm + x.L2.tot, gl.bnw + t * f, gl.bnb + t * f,
                         smode == kBatchBn);
    }
    stamp(a.prof, t == T - 1 ? 3 : 5 + 2 * (T - 2 - t));
    if (t >= 1) stage_step(t - 1);
    const float* sb = sbuf + (t & 1) * ncap * 2 * FP;
    const float* stt = st + (T + t) * 3 * FP;      // state slot T + t
    const float* stp = st + (T + t - 1) * 3 * FP;  // state slot T + t − 1
    const float* stm = st + t * 3 * FP;            // message slot t
    const float* wst = w + PL::step(t);
    const float* wsp = w + PL::step(t > 0 ? t - 1 : 0);
    // the norm VJP of slot T + t as dhp = (∂h·dxw − S1/c)·rd − x̂·cb: the
    // reciprocals once a step; the mean S1/c in two floats (Mean2), taken
    // out of each node's dx̂ before the scaling, so that its rounding does
    // not add up over the batch in the next step's sums.
    const float dxw = smode == kBatchBn ? wst[PL::oBnW + j] : 1.f;
    const float rd = 1.0f / stt[2 * FP + j];
    const bool on = state_stats && j < f;
    const Mean2 m1 = on ? Mean2(tot[j], x.c) : Mean2();
    const float cb = on ? tot[f + j] / (x.c * stt[FP + j]) : 0.f;
    const float rdp = 1.0f / stp[2 * FP + j], meanp = stp[j];
    const float bnwp = wsp[PL::oBnW + j], bnbp = wsp[PL::oBnB + j];
    const float rdm = 1.0f / stm[2 * FP + j], meanm = stm[j];
    const float maw = wst[PL::oMaW + j], mab = wst[PL::oMaB + j];
    for (int i0 = 0; i0 < nb; i0 += NG) {
      // warp-uniform rounds: a slot past the nodes runs on node 0 with
      // ∂h = 0 and writes nothing
      const int i = i0 + q;
      const bool ok = i < nb;
      const int ic = ok ? i : 0;
      float* s = state + size_t(ic) * SS;
      const int n = n0 + ic;
      const float gh = s[kGh + j];
      const float dhp =
          !ok ? 0.f
          : state_stats ? m1.off_times(gh * dxw, rd) - (s[kXh + j] - xbar) * cb
                        : gh;
      // the previous state, the step's normalized messages
      float hprev, xhp = 0.f;
      if (t > 0) {
        const float raw =
            kSm ? sb[ic * 2 * FP + j]
                : (j < f ? __ldg(a.htil + size_t(T + t - 1) * slot_sz +
                                 size_t(n) * f + j)
                         : 0.f);
        if (state_stats) xhp = (raw - meanp) * rdp;
        hprev = state_norm(smode, raw, xhp, bnwp, bnbp);
      } else {
        hprev = s[kH0 + j];
      }
      const float mraw =
          kSm ? sb[ic * 2 * FP + FP + j]
              : (j < f ? __ldg(a.htil + size_t(t) * slot_sz + size_t(n) * f +
                               j)
                       : 0.f);
      const float xm = msg_bn ? (mraw - meanm) * rdm : 0.f;
      const float mb = msg_bn ? fmaf(maw, xm, mab) : mraw;
      const float* wv = w + opaque_zero();
      float hb[kCol];
      float gir = wv[PL::kBih + j], giz = wv[PL::kBih + FP + j],
            gin = wv[PL::kBih + 2 * FP + j];
      float ghr = wv[PL::kBhh + j], ghz = wv[PL::kBhh + FP + j],
            ghn = wv[PL::kBhh + 2 * FP + j];
#pragma unroll
      for (int k = 0; k < FP; ++k) {
        const float hk = gshfl(hprev, k);
        if constexpr (kWReg) hb[k] = hk;
        const float mk = gshfl(mb, k);
        const float* wi = wv + PL::kWih + k * 3 * FP + j;
        const float* wh = wv + PL::kWhh + k * 3 * FP + j;
        gir = fmaf(mk, wi[0], gir);
        giz = fmaf(mk, wi[FP], giz);
        gin = fmaf(mk, wi[2 * FP], gin);
        ghr = fmaf(hk, wh[0], ghr);
        ghz = fmaf(hk, wh[FP], ghz);
        ghn = fmaf(hk, wh[2 * FP], ghn);
      }
      const float sr = sigmoidf_(gir + ghr);
      const float sz = sigmoidf_(giz + ghz);
      const float tn = tanhf(gin + sr * ghn);
      const float dz = dhp * (hprev - tn);
      const float da_n = dhp * (1.0f - sz) * (1.0f - tn * tn);
      const float dnh = da_n * sr;
      const float da_r = da_n * ghn * sr * (1.0f - sr);
      const float da_z = dz * sz * (1.0f - sz);
      bhh_acc[0] += da_r;
      bhh_acc[1] += da_z;
      bhh_acc[2] += dnh;
      bih_acc[0] += da_r;
      bih_acc[1] += da_z;
      bih_acc[2] += da_n;
      float p[FP];
#pragma unroll
      for (int k = 0; k < FP; ++k) {
        if constexpr (kWReg) {
          const float mk = gshfl(mb, k);
          dwh[0][k] = fmaf(hb[k], da_r, dwh[0][k]);
          dwh[1][k] = fmaf(hb[k], da_z, dwh[1][k]);
          dwh[2][k] = fmaf(hb[k], dnh, dwh[2][k]);
          dwi[0][k] = fmaf(mk, da_r, dwi[0][k]);
          dwi[1][k] = fmaf(mk, da_z, dwi[1][k]);
          dwi[2][k] = fmaf(mk, da_n, dwi[2][k]);
        }
        const float* wh = wv + PL::kWhh + k * 3 * FP + j;
        float v = wh[0] * da_r;
        v = fmaf(wh[FP], da_z, v);
        v = fmaf(wh[2 * FP], dnh, v);
        p[k] = v;
      }
      reduce_scatter<FP>(p, j);
      const float gprev = fmaf(dhp, sz, p[0]);
#pragma unroll
      for (int k = 0; k < FP; ++k) {
        const float* wi = wv + PL::kWih + k * 3 * FP + j;
        float v = wi[0] * da_r;
        v = fmaf(wi[FP], da_z, v);
        v = fmaf(wi[2 * FP], da_n, v);
        p[k] = v;
      }
      reduce_scatter<FP>(p, j);
      const float dmb = p[0];
      if constexpr (!kWReg) {
        // this round's rows staged; the W_ih, W_hh, b_ih, b_hh elements
        // a thread owns summed over the round's nodes in order
        float* wr = sm + x.L2.wst + q * kWS;
        wr[j] = mb;
        wr[FP + j] = hprev;
        wr[2 * FP + j] = da_r;
        wr[3 * FP + j] = da_z;
        wr[4 * FP + j] = da_n;
        wr[5 * FP + j] = dnh;
        __syncthreads();
        const float* ws = sm + x.L2.wst;
#pragma unroll
        for (int u = 0; u < kOwn; ++u) {
          const int e = tid + u * kBT;
          if (e >= kGruEl) continue;
          // the input column (−1: a bias) and the gate column of e
          int cx = -1, cd;
          if (e < 6 * FP * FP) {
            const bool hh = e >= 3 * FP * FP;
            const int i = hh ? e - 3 * FP * FP : e;
            const int k = i / (3 * FP), c = i % (3 * FP);
            cx = hh ? FP + k : k;
            cd = hh && c >= 2 * FP ? 5 * FP + c - 2 * FP : 2 * FP + c;
          } else {
            const bool hh = e >= 6 * FP * FP + 3 * FP;
            const int c = e - 6 * FP * FP - (hh ? 3 * FP : 0);
            cd = hh && c >= 2 * FP ? 5 * FP + c - 2 * FP : 2 * FP + c;
          }
          float acc = own[u];
          if (cx >= 0) {
            for (int r = 0; r < NG; ++r)
              acc = fmaf(ws[r * kWS + cx], ws[r * kWS + cd], acc);
          } else {
            for (int r = 0; r < NG; ++r) acc += ws[r * kWS + cd];
          }
          own[u] = acc;
        }
        __syncthreads();
      }
      __syncwarp();
      if (ok) {
        s[kDm + t * FP + j] = dmb;
        if (t > 0) {
          s[kGh + j] = gprev;
          s[kXh + j] = xhp;
        } else {
          s[kD0 + j] += gprev;
        }
      }
    }
    cp_async_wait_all();
    stamp(a.prof, 4 + 2 * (T - 1 - t));
  }
  // ∂W_hh, ∂W_ih, both biases into the row
  if constexpr (kWReg) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      groups_to<kCol>(dwh[g], red, [&](int k, int jj, float v) {
        if (k < f && jj < f) row[gl.whh + k * 3 * f + g * f + jj] = v;
      });
      groups_to<kCol>(dwi[g], red, [&](int k, int jj, float v) {
        if (k < f && jj < f) row[gl.wih + k * 3 * f + g * f + jj] = v;
      });
    }
    float v[6] = {bhh_acc[0], bhh_acc[1], bhh_acc[2],
                  bih_acc[0], bih_acc[1], bih_acc[2]};
    groups_to<6>(v, red, [&](int i, int jj, float s) {
      if (jj < f) row[(i < 3 ? gl.bhh : gl.bih) + (i % 3) * f + jj] = s;
    });
  } else {
#pragma unroll
    for (int u = 0; u < kOwn; ++u) {
      const int e = tid + u * kBT;
      if (e < 6 * FP * FP) {
        const bool hh = e >= 3 * FP * FP;
        const int i = hh ? e - 3 * FP * FP : e;
        const int k = i / (3 * FP), g = (i % (3 * FP)) / FP, jj = i % FP;
        if (k < f && jj < f)
          row[(hh ? gl.whh : gl.wih) + k * 3 * f + g * f + jj] = own[u];
      } else if (e < kGruEl) {
        const bool hh = e >= 6 * FP * FP + 3 * FP;
        const int c = e - 6 * FP * FP - (hh ? 3 * FP : 0);
        if (c % FP < f)
          row[(hh ? gl.bhh : gl.bih) + (c / FP) * f + c % FP] = own[u];
      }
    }
  }
  stamp(a.prof, 70);

  // ---- the T message norms' sums in one round, ∂m_t per node -------------
  if (msg_bn) {
    for (int t = 0; t < T; ++t) message_sums(x, state, nb, t);
    combine_messages(x);
    stamp(a.prof, 71);
    for (int t = 0; t < T; ++t) {
      const float* stm = st + t * 3 * FP;
      const float maw = w[PL::step(t) + PL::oMaW + j];
      const float xbar = center_xhat(x, sm + x.L2.tot + t * 3 * f,
                                     gl.maw + t * f, gl.mab + t * f, true);
      const float S1 = j < f ? tot[t * 3 * f + j] : 0.f;
      const float S2 = j < f ? tot[t * 3 * f + f + j] : 0.f;
      const float rdm = 1.0f / stm[2 * FP + j];
      const float cb = S2 / (x.c * stm[FP + j]);
      const Mean2 m1(S1, x.c);                       // as the state norm's
      for (int i = q; i < nb; i += NG) {
        float* s = state + size_t(i) * SS;
        const float mraw =
            j < f ? __ldg(a.htil + size_t(t) * slot_sz + size_t(n0 + i) * f +
                          j)
                  : 0.f;
        const float xm = (mraw - stm[j]) * rdm - xbar;
        s[kDm + t * FP + j] =
            m1.off_times(s[kDm + t * FP + j] * maw, rdm) - xm * cb;
      }
    }
  } else {
    for (int e = tid; e < T * f; e += kBT) {
      row[gl.maw + e] = 0.f;
      row[gl.mab + e] = 0.f;
    }
    stamp(a.prof, 71);
  }
  __syncthreads();
  stamp(a.prof, 72);

  // ---- the message VJP per graph and step: A0_t (bias leakage), mbias_t --
  {
    float pacc = 0.f;
    for (int t = 0; t < T; ++t) {
      const float* a0t = w + PL::step(t) + PL::oA0;
      float da0[FP], dmbias = 0.f;
#pragma unroll
      for (int m = 0; m < FP; ++m) da0[m] = 0.f;
      // per graph (a group each): Σ ∂m_t, Σ h0, the A0_t terms; A0_tᵀ·Σ∂m_t
      // into each of the graph's nodes' ∂h0
      for (int g0 = x.lo; g0 < x.hi; g0 += NG) {
        // warp-uniform rounds: a slot past the graphs sums no nodes
        const int g = g0 + q;
        const int v0 = g < x.hi ? __ldg(a.graph_node_ptr + g) - n0 : 0;
        const int v1 = g < x.hi ? __ldg(a.graph_node_ptr + g + 1) - n0 : 0;
        // four interleaved partial sums: a long graph's rounding grows
        // with the length of each chain
        const int kd = kDm + t * FP;
        float D0 = 0.f, D1 = 0.f, D2 = 0.f, D3 = 0.f;
        float S0 = 0.f, S1 = 0.f, S2 = 0.f, S3 = 0.f;
        int v = v0;
        for (; v + 4 <= v1; v += 4) {
          const float* r = state + size_t(v) * SS + j;
          D0 += r[kd];
          D1 += r[SS + kd];
          D2 += r[2 * SS + kd];
          D3 += r[3 * SS + kd];
          S0 += r[kH0];
          S1 += r[SS + kH0];
          S2 += r[2 * SS + kH0];
          S3 += r[3 * SS + kH0];
        }
        if (v < v1) {
          D0 += state[size_t(v) * SS + kd + j];
          S0 += state[size_t(v) * SS + kH0 + j];
        }
        if (v + 1 < v1) {
          D1 += state[size_t(v + 1) * SS + kd + j];
          S1 += state[size_t(v + 1) * SS + kH0 + j];
        }
        if (v + 2 < v1) {
          D2 += state[size_t(v + 2) * SS + kd + j];
          S2 += state[size_t(v + 2) * SS + kH0 + j];
        }
        const float D = (D0 + D1) + (D2 + D3);
        const float S = (S0 + S1) + (S2 + S3);
        dmbias += D;
        if (t == 0) pacc = fmaf(float(v1 - v0), S, pacc);
        float bt = 0.f;
#pragma unroll
        for (int m = 0; m < FP; ++m) {
          const float dm = gshfl(D, m);
          da0[m] = fmaf(dm, S, da0[m]);
          bt = fmaf(a0t[m * FP + j], dm, bt);
        }
        for (int u = v0; u < v1; ++u) state[size_t(u) * SS + kD0 + j] += bt;
      }
      groups_to<FP>(da0, red, [&](int m, int jj, float v) {
        if (m < f && jj < f) row[gl.a0 + (t * f + m) * f + jj] = v;
      });
      float v[2] = {dmbias, pacc};
      groups_to<2>(v, red, [&](int i, int jj, float s) {
        if (jj >= f) return;
        if (i == 0)
          row[gl.mbias + t * f + jj] = s;
        else if (t == 0)
          x.prow[jj] = s;
      });
    }
    // per node (every group): + Σ_{e: src = v} Σ_t A_t[vid_e]ᵀ·∂m_t,dst_e
    for (int v = q; v < nb; v += NG) {
      float acc0 = 0.f, acc1 = 0.f;
      if (j < f) {
        for (int p = sptr[v]; p < sptr[v + 1]; ++p) {
          const int wd = einfo[4 * p + 1], k = einfo[4 * p + 2];
          for (int t = 0; t < T; ++t) {
            const float* am = a.w.amat + (size_t(t) * K + k) * f * f + j;
            const float* dmr = state + size_t(wd) * SS + kDm + t * FP;
            int m = 0;
            for (; m + 2 <= f; m += 2) {
              acc0 = fmaf(__ldg(am + m * f), dmr[m], acc0);
              acc1 = fmaf(__ldg(am + (m + 1) * f), dmr[m + 1], acc1);
            }
            if (m < f) acc0 = fmaf(__ldg(am + m * f), dmr[m], acc0);
          }
        }
      }
      state[size_t(v) * SS + kD0 + j] += acc0 + acc1;
    }
    if (msg_bn && x.y.nblocks == 1) center_da0(x, x.prow, 1, 0, false);
    __syncthreads();
    // ∂h0 of the block's nodes, coalesced
    for (int i = tid; i < nb * f; i += kBT)
      a.dh0[size_t(n0) * f + i] = state[size_t(i / f) * SS + kD0 + i % f];
  }
  stamp(a.prof, 73);

  // ---- dA_t[k]: the block's edges in vocab order, one segment an id ------
  {
    constexpr int kPer = FP * FP >= kBT ? FP * FP / kBT : 1;
    for (int t = 0; t < T; ++t) {
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
            return state[size_t(einfo[4 * p + 1]) * SS + kDm + t * FP + m] *
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
          row[gl.a + ((t * K + k) * f + m) * f + jj] = (c0 + c1) + (c2 + c3);
        }
      }
    }
  }
  stamp(a.prof, 74);
}

// The empty walk: the route's grid, staging of nothing, each round's
// combine of zero partials and the final sum of a zero row.
__device__ void floor_body(Ctx& x) {
  const PsBwdArgs& a = x.a;
  for (int e = threadIdx.x; e < x.gl.total; e += kBT) x.row[e] = 0.f;
  for (int e = threadIdx.x; e < 6 * FP * x.T; e += kBT)
    x.sm[x.L2.cpart + e] = 0.f;
  if (threadIdx.x < FP) x.prow[threadIdx.x] = 0.f;
  __syncthreads();
  if (has_stats(a.state_mode))
    for (int t = x.T - 1; t >= 0; --t) combine_state(x, t);
  if (a.msg_mode == kBatchBn) combine_messages(x);
}

__global__ void __launch_bounds__(kBT, 1)
fused_psteps_bwd_kernel(PsBwdArgs a) {
  extern __shared__ float sm[];
  const int tid = threadIdx.x;
  const int nblocks = int(gridDim.x);
  Ctx x{a, sm, Smem(a.k_vocab, a.steps, a.ncap, a.ecap),
        Sync{a.route, nblocks, int(blockIdx.x), 0ull, a.flags, a.counters,
             a.flags == nullptr ? nullptr : a.flags + kFlagWords - 1},
        PsGradLayout(a.k_vocab, a.f, a.od, a.steps), nullptr, nullptr,
        a.steps, a.f, a.od, (4 + a.steps) * FP,
        0, 0, 0, 0, 0, 0, 0, 0, 0.f, 0.f, 0.f};
  stamp(a.prof, 0);
  const bool flagged = a.route == kRouteGrid && nblocks > 1;
  if (flagged && tid == 0)
    reinterpret_cast<unsigned long long*>(sm + x.L2.misc)[0] =
        ld_flag(x.y.last) + 1;
  stage_ps_weights(sm, a.w, a.f, a.od, a.steps);
  __syncthreads();
  const int T = a.steps, smode = a.state_mode;
  float* st = sm + PL::stats(T);
  for (int i = tid; i < 2 * T * FP; i += kBT) {
    const int s = i / FP, jj = i % FP;
    const bool on = s < T ? a.msg_mode == kBatchBn : has_stats(smode);
    if (!on) continue;
    const float mean = jj < a.f ? a.stats[(size_t(s) * 2) * a.f + jj] : 0.f;
    const float var = jj < a.f ? a.stats[(size_t(s) * 2 + 1) * a.f + jj] : 0.f;
    set_slot(st + s * 3 * FP, jj, mean, var, s >= T && smode == kStateless);
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
  if (flagged)
    x.y.tag = reinterpret_cast<unsigned long long*>(sm + x.L2.misc)[0];
  x.inv_gsum = 1.0f / sm[x.L2.misc + 2];
  x.gl_v = a.gl[0];
  x.n_real = __ldg(a.graph_node_ptr + a.n_graphs);
  x.c = float(x.n_real);
  // this block's graphs and nodes, balanced by node count
  {
    int* slot = reinterpret_cast<int*>(sm + x.L2.red);
    first_graphs_at(a, split_at(x.n_real, nblocks, x.y.b),
                    x.y.b + 1 == nblocks
                        ? x.n_real + 1
                        : split_at(x.n_real, nblocks, x.y.b + 1),
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
  const Scratch sc(a.n_nodes, a.n_edges, a.k_vocab, a.f, a.od, T, nblocks);
  const int NW = x.gl.total;
  x.row = alone ? a.dw : a.scratch + sc.rows + size_t(x.y.b) * (NW + FP);
  x.prow = alone ? sm + x.L2.sbar : x.row + NW;
  if (a.floor)
    floor_body(x);
  else if (x.nb <= a.ncap && x.eb <= a.ecap)
    body<true>(x);
  else
    body<false>(x);
  const bool center = a.msg_mode == kBatchBn && !a.floor;
  if (alone) {
  } else if (a.route == kRouteCluster) {
    final_sum_cluster(x.y, a.dw, a.scratch + sc.rows, NW, NW + FP);
    if (center) {
      __threadfence();
      cg::this_cluster().sync();
      if (x.y.b == 0)
        center_da0(x, a.scratch + sc.rows + NW, nblocks, NW + FP, true);
    }
  } else if (final_sum_grid(x.y, a.dw, a.scratch + sc.rows, NW, NW + FP,
                            a.scratch + sc.gparts) && center) {
    center_da0(x, a.scratch + sc.rows + NW, nblocks, NW + FP, true);
  }
  stamp(a.prof, 75);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block at node capacity ncap and edge
// capacity ecap, in bytes (kernels/fused_psteps.py::bwd_smem_floats
// mirrors it).
int mpnn_fused_psteps_bwd_smem_bytes(int k_vocab, int steps, int ncap,
                                     int ecap) {
  return int(smem_bytes(k_vocab, steps, ncap, ecap));
}

// The 16 offsets of the flat gradient layout (PsGradLayout), the total last.
void mpnn_fused_psteps_bwd_layout(int k_vocab, int f, int od, int steps,
                                  int* out) {
  const PsGradLayout g(k_vocab, f, od, steps);
  const int v[16] = {g.a, g.a0, g.mbias, g.wih, g.whh, g.bih, g.bhh, g.maw,
                     g.mab, g.bnw, g.bnb, g.riw, g.rib, g.rjw, g.rjb,
                     g.total};
  for (int i = 0; i < 16; ++i) out[i] = v[i];
}

long long mpnn_fused_psteps_bwd_scratch_floats(int n_nodes, int n_edges,
                                               int k_vocab, int f, int od,
                                               int steps, int grid) {
  return (long long)Scratch(n_nodes, n_edges, k_vocab, f, od, steps, grid)
      .total;
}

// The flag and counter words of the grid route (one buffer each per
// stream, zeroed once): u64 flags, int counters.
int mpnn_fused_psteps_bwd_sync_words(int* counters) {
  *counters = kMaxGroups + 1;
  return kFlagWords;
}

// The co-resident blocks of the grid route at this shared memory, capped
// at kMaxGrid; 0 on error.
int mpnn_fused_psteps_bwd_max_grid(int bytes) {
  return max_grid(fused_psteps_bwd_kernel, bytes);
}

// Launches on `stream` and returns the launch's error code (0 = success).
// route 0: one cluster of `grid` blocks (1, 2, 4 or 8); route 1: `grid`
// co-resident blocks with `flags` and `counters`. ncap, ecap: the node and
// edge capacity of a block's shared memory. floor != 0 launches the empty
// walk (the same grid, combines and final sum; dw gets zeros). prof: null
// or kProfSlots int64 clock64 stamps of block 0.
int mpnn_fused_psteps_bwd(
    const float* amat, const float* a0, const float* mbias,
    const float* w_ih, const float* w_hh, const float* b_ih,
    const float* b_hh, const float* ma_w, const float* ma_b,
    const float* bn_w, const float* bn_b, const float* ro_iw,
    const float* ro_ib, const float* ro_jw, const float* ro_jb,
    const float* h0, const float* labels, const float* gmask,
    const float* out, const float* gout, const float* gl, const float* htil,
    const float* stats, const int* vid, const int* src, const int* dst,
    const int* src_order, const int* src_ptr, const int* graph_node_ptr,
    const int* node_graph, float* dh0, float* dw, float* scratch,
    unsigned long long* flags, int* counters, long long* prof,
    int n_nodes, int n_graphs, int n_edges, int f, int od, int k_vocab,
    int steps, int msg_mode, int state_mode, int route, int grid, int ncap,
    int ecap, int floor, void* stream) {
  if (f > FP || od > ODW || steps < 1 || steps > kMaxSteps || grid < 1 ||
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
  PsBwdArgs a{{amat, a0, mbias, w_ih, w_hh, b_ih, b_hh, ma_w, ma_b, bn_w,
               bn_b, ro_iw, ro_ib, ro_jw, ro_jb},
              h0, labels, gmask, out, gout, gl, htil, stats, vid, src, dst,
              src_order, src_ptr, graph_node_ptr, node_graph, dh0, dw,
              scratch, route == kRouteGrid ? flags : nullptr,
              route == kRouteGrid ? counters : nullptr, prof, n_nodes,
              n_graphs, n_edges, f, od, k_vocab, steps, msg_mode,
              state_mode, route, ncap, ecap, floor};
  return launch_route(fused_psteps_bwd_kernel, a, route, grid,
                      smem_bytes(k_vocab, steps, ncap, ecap), stream);
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
