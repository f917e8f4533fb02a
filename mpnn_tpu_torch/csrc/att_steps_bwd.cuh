// The body of the attention family's training backward, shared by the
// T-step kernel of the `att` model (fused_att_steps_bwd.cu) and the
// collapsed one of the `adv` model (fused_att_bwd.cu), whose function is
// the T-step one at T 1, one message network and no state norm: a
// source that defines MPNN_ATT_ONE_STEP to 1 before including this
// header builds that case alone (kOne: the reverse chain is one GRU VJP
// a node, no batch sum crosses blocks, no flag is read). The design is
// fused_att_steps_bwd.cu's; each source keeps its own kernel, launch and
// C entry points.

#pragma once

#ifndef MPNN_ATT_ONE_STEP
#define MPNN_ATT_ONE_STEP 0
#endif

#include "fused_att_steps_common.cuh"
#include "sddmm_common.cuh"
#include "walk_bwd.cuh"

namespace {

using namespace mpnn_atts;
using namespace mpnn_walk;
using mpnn_train::kFull;
using mpnn_train::opaque_zero;
using mpnn_train::set_slot;
using mpnn_train::sigmoidf_;
namespace sd = mpnn_sddmm;

// Flat layout of the gradient output (and of each block's partial row):
// real shapes, in this order. kernels/fused_att_steps.py::grad_layout
// mirrors it and checks it against mpnn_fused_att_steps_bwd_layout.
struct AttsGradLayout {
  int a, a0, qv, q0, wh, wih, whh, bih, bhh, total;
  __host__ __device__ AttsGradLayout(int tm, int k, int f) {
    a = 0;
    a0 = a + tm * k * f * f;
    qv = a0 + tm * f * f;
    q0 = qv + tm * k * f;
    wh = q0 + tm * f;
    wih = wh + tm * f * f;
    whh = wih + 3 * f * f;
    bih = whh + 3 * f * f;
    bhh = bih + 3 * f;
    total = bhh + 3 * f;
  }
};

// the collapsed model's build: T 1, Tm 1, no state norm (see the top)
constexpr bool kOne = MPNN_ATT_ONE_STEP != 0;
constexpr int kFlagWords = flag_words(kMaxSteps);
// per-node state (floats): ∂h of the state being walked, ∂h0, h0, S_g of
// its graph (then X_v = S_g − Σ_e h0[src] over its in-edges), Σ_t dX, then
// ∂m_t of each message slot: (5 + Tm)·FP
constexpr int kGh = 0, kD0 = FP, kH0 = 2 * FP, kSg = 3 * FP, kDX = 4 * FP,
              kDm = 5 * FP;
// per-edge rows (floats): gate ⊙ h0[src] of the message step being walked
// (row r: the edge at position r of the block's vocab order), dz of that
// step and the source cotangent Σ_t dg ⊙ gate (row p: the edge at position
// p of the destination order)
constexpr int kEg = 0, kEz = FP, kEd = 2 * FP, ES = 3 * FP;
// ∂W_ih's and ∂W_hh's columns a lane in registers at FP 16; at FP 32 a
// round's rows [mb | h | da_r | da_z | da_n | r·∂n] are staged and the
// padded W_ih, W_hh, b_ih, b_hh summed an element a thread
constexpr bool kWReg = FP <= 16;
constexpr int kWS = 6 * FP;
constexpr int kGruEl = 6 * FP * FP + 6 * FP;
constexpr int kOwn = kWReg ? 1 : (kGruEl + kBT - 1) / kBT;
// A'_t is staged in shared memory when its K tables take at most this
__host__ __device__ constexpr bool aprime_staged(int k_vocab) {
  return k_vocab * FP * FP <= 16384;
}

struct BwdArgs {
  AttsWeights w;
  const float* h0;              // (N, f), pre-masked
  const float* msgs;            // (Tm, N, f) the forward's masked messages
  const float* htil;            // (T, N, f) the forward's pre-norm states
  const float* stats;           // (T, 2, f) the forward's mean, var
  const float* gh;              // (N, f) cotangent of h_T
  const int* vid;               // (E)
  const int* src;               // (E)
  const int* dst;               // (E)
  const int* edge_order;        // (E) edge ids, stably sorted by dst
  const int* dst_ptr;           // (N + 1)
  const int* src_pos;           // (E) positions in edge_order by source
  const int* src_ptr;           // (N + 1) row pointers into src_pos
  const int* graph_node_ptr;    // (G + 1)
  float* dh0;                   // (N, f)
  float* dw;                    // AttsGradLayout(Tm, K, f).total
  float* scratch;               // Scratch(...).total
  unsigned long long* flags;    // grid route: kFlagWords, zero once
  int* counters;                // grid route: kMaxGroups + 1, zero between
  long long* prof;              // null, or kProfSlots clock64 stamps
  int n_nodes, n_graphs, n_edges, f, k_vocab, steps, tm, with_corr,
      stateless;
  int route, ncap, ecap, floor;
};

// Offsets (floats) of one block's shared memory past the staged weights
// and the T slots' norm constants (SL::after_stats).
struct Smem {
  int tot, cpart, misc, red, wst, tab, ap, ints, state, edges, total;
  __host__ __device__ Smem(int tm, int k_vocab, int steps, int ncap,
                           int ecap) {
    int off = al4(SL::after_stats(tm, k_vocab, steps));
    tot = off;    off += al4(3 * FP);
    // each state round's partial [S1 | S2 | Σx̂]
    cpart = off;  off += 3 * FP * steps;
    misc = off;   off += 4;
    red = off;    off += kRed;
    wst = off;    off += kWReg ? 0 : NG * kWS;
    tab = off;    off += FP * FP + FP;          // Wh_tᵀ, a zero bias
    ap = off;     off += aprime_staged(k_vocab) ? k_vocab * FP * FP : 0;
    // ints: dst and src pointers (ncap + 1 each), edges (src, dst, vid),
    // positions by source, the vocab order (edges, their positions in it,
    // their destinations), per-warp vocab counts, segment starts
    ints = off;
    off += al4(2 * (ncap + 1) + 7 * ecap + (kWB + 1) * k_vocab + 1);
    state = off;  off += ncap * (5 + tm) * FP;
    edges = off;  off += ecap * ES;
    total = off;
  }
};

size_t smem_bytes(int tm, int k_vocab, int steps, int ncap, int ecap) {
  return sizeof(float) * size_t(Smem(tm, k_vocab, steps, ncap, ecap).total);
}

// Offsets (floats) of the global scratch.
struct Scratch {
  size_t state, edges, ints, cparts, rows, gparts, total;
  __host__ __device__ Scratch(int n, int e, int k, int f, int steps, int tm,
                              int grid) {
    const size_t nw = AttsGradLayout(tm, k, f).total;
    size_t off = 0;
    state = off;   off += size_t(n) * (5 + tm) * FP;   // spilled tiles
    edges = off;   off += size_t(e) * ES;
    // pointers (2 (n + grid + 1)), edges (3e), by source (e), the vocab
    // order (3e)
    ints = off;    off += 2 * size_t(n + grid + 1) + 7 * size_t(e);
    cparts = off;  off += size_t(3) * FP * steps * grid;
    rows = off;    off += size_t(grid) * nw;
    gparts = off;  off += size_t(kMaxGroups) * nw;
    total = off;
  }
};

struct Ctx {
  const BwdArgs& a;
  float* sm;
  Smem L2;
  Sync y;
  const AttsGradLayout gl;
  float* row;               // this block's gradient row
  int T, Tm, K, f, SS;
  int lo, hi, n0, nb, e0, eb, s0, n_real;
  float c;
};

// The first graphs g in [0, G] with graph_node_ptr[g] >= t0 and >= t1,
// into g0 and g1 (every thread); `slot` holds 2 ints.
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

// The totals over the launch's blocks of state round r's block partial
// (3f floats packed to the real features, cpart + r·3FP) into tot.
__device__ void combine_state(Ctx& x, int r) {
  const BwdArgs& a = x.a;
  const int G = x.y.nblocks;
  float* gp = a.scratch +
              Scratch(a.n_nodes, a.n_edges, a.k_vocab, a.f, a.steps, a.tm,
                      G).cparts + size_t(r) * G * 3 * FP;
  combine(x.y, x.sm + x.L2.cpart + r * 3 * FP, x.sm + x.L2.tot, 3 * x.f, gp,
          a.flags + size_t(r) * kMaxGrid * kFlagStride, x.sm + x.L2.red);
}

// Per-lane compensated sums of a state slot's VJP (S1 = Σ g, S2 = Σ g·x̂,
// Σ x̂ over the block's nodes) into round r's partial, over the groups in
// order. Every thread calls it.
__device__ void state_partial(Ctx& x, int r, const Ksum& s1, const Ksum& s2,
                              const Ksum& sx) {
  float v[3] = {s1.s, s2.s, sx.s};
  float* cpart = x.sm + x.L2.cpart + r * 3 * FP;
  const int f = x.f;
  groups_to<3>(v, x.sm + x.L2.red, [&](int i, int jj, float t) {
    if (jj < f) cpart[i * f + jj] = t;
  });
}

// One message step's VJP over the block's edges and nodes (below, in
// body). The gate's tables are sddmm_common.cuh's: wh = Wh_t, whT its
// transpose, ew = qv_t, bs zero, ap = A'_t staged (or null).
struct MsgStep {
  float* state;
  float* erow;
  const int* eptr;
  const int* einfo;
  const int* vpos;          // an edge's position in the block's vocab order
  sd::Tables tb;
  const float* agl;         // A'_t in device memory (K, f, f)
  int SS, f, nb, eb, t;
  bool corr, aps;
};

// The edges of step t, a group of G lanes an edge (lane j feature j), two
// edges a group a round where A'_t is staged (their chains interleave;
// one in the wide bucket, whose A'_t may come from device memory): the
// gate on h0[dst] (sddmm_common.cuh's edge_gate), dg = A'_t[k]ᵀ·∂m_t[dst]
// and the softmax's VJP dz. Writes gate ⊙ h0[src] at the edge's vocab
// position, dz at its destination position, and adds dg ⊙ gate to its
// source cotangent.
template <int G>
__device__ void message_edges(const MsgStep& ms) {
  constexpr int NE = kBT / G;
  constexpr int U = FP <= 16 ? 2 : 1;
  const int tid = threadIdx.x, j = tid % G, gi = tid / G;
  const int f = ms.f, t = ms.t, SS = ms.SS, eb = ms.eb;
  if (eb == 0) return;
  for (int p0 = 0; p0 < eb; p0 += U * NE) {
    // every group runs each round (the group sums take the whole warp); a
    // slot past the edges runs on the last one and writes nothing
    float eg[U], dz[U], dgg[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pc = min(p0 + u * NE + gi, eb - 1);
      const int* ei = ms.einfo + 3 * pc;
      const int k = ei[2];
      const float* sv = ms.state + size_t(ei[1]) * SS;
      const float gate = sd::edge_gate<G>(ms.tb, sv + kH0, k, j, f);
      const float hs = ms.state[size_t(ei[0]) * SS + kH0 + j];
      const float* dmv = sv + kDm + t * FP;
      float dg = 0.f;
      if (ms.aps) {
        const float* am = ms.tb.ap + k * FP * FP + j;
#pragma unroll
        for (int m = 0; m < G; ++m) dg = fmaf(am[m * FP], dmv[m], dg);
      } else {
        const float* am = ms.agl + size_t(k) * f * f + j;
#pragma unroll
        for (int m = 0; m < G; ++m)
          if (m < f && j < f) dg = fmaf(__ldg(am + m * f), dmv[m], dg);
      }
      const float x = dg * hs;
      dz[u] = gate * (x - sd::group_sum<G>(x * gate));
      eg[u] = gate * hs;
      dgg[u] = dg * gate;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u * NE + gi;
      if (p >= eb) continue;
      float* er = ms.erow + size_t(p) * ES;
      ms.erow[size_t(ms.vpos[p]) * ES + kEg + j] = eg[u];
      er[kEz + j] = dz[u];
      er[kEd + j] = t == 0 ? dgg[u] : er[kEd + j] + dgg[u];
    }
  }
}

// The nodes of step t, a group of G lanes a node: Σ dz over the node's
// in-edges in destination order, the correction (the gate g0 of Wh_tᵀ·
// h0[v] + q0_t, X_v, dz0; Σ_t A0_tᵀ·∂m ⊙ g0 into the node's dX row), and
// ∂h0[v] += Wh_t·(Σ dz + dz0); sums ∂A0_t and ∂Wh_t (lane j: column j,
// into acc[k] and acc[G + k]) and ∂q0_t (acc[2G]) over the group's nodes.
template <int G>
__device__ void message_nodes(const MsgStep& ms, const float* wv,
                              float (&acc)[2 * G + 1]) {
  constexpr int NE = kBT / G;
  const int tid = threadIdx.x, j = tid % G, gi = tid / G;
  const int base = (tid % 32) - j;
  const int f = ms.f, t = ms.t, SS = ms.SS, nb = ms.nb;
  const bool in = j < f;
  const float q0j = wv[AL::kQ0 + j];
  for (int i0 = 0; i0 < nb; i0 += NE) {
    // every group runs each round; a slot past the nodes runs on node 0
    // with ∂m = 0 and no edges, and writes nothing
    const int i = i0 + gi;
    const bool ok = i < nb;
    float* s = ms.state + size_t(ok ? i : 0) * SS;
    const float dm = ok ? s[kDm + t * FP + j] : 0.f;
    const float h0v = s[kH0 + j];
    float dzall = 0.f;
    if (ok)
      for (int p = ms.eptr[i]; p < ms.eptr[i + 1]; ++p)
        dzall += ms.erow[size_t(p) * ES + kEz + j];
    float g0x = 0.f, dz0 = 0.f;
    if (ms.corr) {
      float z = 0.f, d = 0.f;
#pragma unroll
      for (int k = 0; k < G; ++k) {
        z = fmaf(__shfl_sync(kFull, h0v, base + k), wv[AL::kWh + k * FP + j],
                 z);
        d = fmaf(wv[AL::kA0 + k * FP + j], __shfl_sync(kFull, dm, base + k),
                 d);
      }
      const float zz = in ? z + q0j : sd::kPadLogit;
      const float mx = sd::group_max<G>(zz);
      const float ex = in ? expf(zz - mx) : 0.f;
      const float g0 = ex / sd::group_sum<G>(ex);
      const float xv = s[kSg + j];
      g0x = g0 * xv;
      const float dgx = d * xv;                        // ∂g0
      dz0 = g0 * (dgx - sd::group_sum<G>(dgx * g0));
      dzall += dz0;
      if (ok) s[kDX + j] += d * g0;
    }
    // ∂h0[v] += Wh_t·dzall (lane i: Σ_jj Wh_t[i][jj]·dzall[jj])
    float hv = 0.f;
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const float dzk = __shfl_sync(kFull, dzall, base + k);
      hv = fmaf(ms.tb.whT[k * FP + j], dzk, hv);
      if (ms.corr)
        acc[k] = fmaf(__shfl_sync(kFull, dm, base + k), g0x, acc[k]);
      acc[G + k] = fmaf(__shfl_sync(kFull, h0v, base + k), dzall, acc[G + k]);
    }
    acc[2 * G] += dz0;
    if (ok) s[kD0 + j] += hv;
  }
}

// A'_t zero-padded to (K, FP, FP) into shared memory, asynchronously (the
// caller waits).
__device__ void stage_aprime(const BwdArgs& a, float* apt, int t, int K,
                             int f) {
  for (int i = threadIdx.x; i < K * FP * FP; i += kBT) {
    const int k = i / (FP * FP), m = (i / FP) % FP, n = i % FP;
    if (m < f && n < f)
      cp_async4(apt + i, a.w.aprime + ((size_t(t) * K + k) * f + m) * f + n);
    else
      apt[i] = 0.f;
  }
}

// The message VJP of step t on G-lane groups: Wh_tᵀ staged (A'_t is on
// its way: started by the previous step, or before the first), the edges,
// then A'_{t+1} started, the nodes, ∂A0_t, ∂Wh_t, ∂q0_t, and the vocab
// sums ∂A'_t, ∂qv_t into the block's row. Every thread calls it.
template <int G>
__device__ void message_step(Ctx& x, const MsgStep& ms, const int* slist,
                             const int* vdst, const int* seg) {
  constexpr int NE = kBT / G;
  const BwdArgs& a = x.a;
  const int tid = threadIdx.x, f = x.f, K = x.K, SS = x.SS, t = ms.t;
  const AttsGradLayout& gl = x.gl;
  float* row = x.row;
  float* red = x.sm + x.L2.red;
  const float* wv = x.sm + opaque_zero() + SL::step(t, K);
  // Wh_tᵀ and the zero bias
  float* whT = x.sm + x.L2.tab;
  for (int i = tid; i < FP * FP + FP; i += kBT)
    whT[i] = i < FP * FP ? wv[AL::kWh + (i % FP) * FP + i / FP] : 0.f;
  cp_async_wait_all();
  __syncthreads();
  if (t < 6) stamp(a.prof, 61 + 3 * t);
  message_edges<G>(ms);
  __syncthreads();
  if (!kOne && ms.aps && t + 1 < x.Tm)
    stage_aprime(a, x.sm + x.L2.ap, t + 1, K, f);
  if (t < 6) stamp(a.prof, 62 + 3 * t);
  float acc[2 * G + 1];
#pragma unroll
  for (int m = 0; m < 2 * G + 1; ++m) acc[m] = 0.f;
  message_nodes<G>(ms, wv, acc);
  if (t < 6) stamp(a.prof, 63 + 3 * t);
  // the group sums, in one round where `red` holds them
  auto put = [&](int i, int jj, float v) {
    if (jj >= f) return;
    if (i < G) {
      if (i < f) row[gl.a0 + (t * f + i) * f + jj] = v;
    } else if (i < 2 * G) {
      if (i - G < f) row[gl.wh + (t * f + i - G) * f + jj] = v;
    } else {
      row[gl.q0 + t * f + jj] = v;
    }
  };
  if constexpr ((2 * G + 1) * G * kWB <= kRed) {
    groups_to<2 * G + 1, G>(acc, red, put);
  } else {
    float v0[G], v1[G], v2[1] = {acc[2 * G]};
#pragma unroll
    for (int m = 0; m < G; ++m) {
      v0[m] = acc[m];
      v1[m] = acc[G + m];
    }
    groups_to<G, G>(v0, red, put);
    groups_to<G, G>(v1, red, [&](int i, int jj, float v) {
      put(G + i, jj, v);
    });
    groups_to<1, G>(v2, red, [&](int, int jj, float v) {
      put(2 * G, jj, v);
    });
  }
  // ∂A'_t[k] = Σ ∂m_t[dst] ⊗ (gate ⊙ h0[src]), ∂qv_t[k] = Σ dz over the
  // block's edges of id k in vocab order (the edges' gate rows sit at
  // their vocab positions); W = f·f + f elements an id
  const int ff = f * f, W = ff + f;
  auto out = [&](int k, int o, float v) {
    row[o < ff ? gl.a + (t * K + k) * ff + o
               : gl.qv + (t * K + k) * f + o - ff] = v;
  };
  if (2 * NE * W <= kRed) {
    // a group of G lanes a run of `per` consecutive vocab positions: lane
    // j keeps column j of its current id's ∂A'_t (acc[m]) and ∂qv_t (aq);
    // an id inside the run goes to the row, an id crossing runs to the
    // run's slot in `red` (two a run: 0 for an id that began in an
    // earlier run, 1 for one that goes on), then is summed from its runs'
    // slots in run order
    const int eb = ms.eb, per = (eb + NE - 1) / NE;
    const int j = tid % G, g = tid / G;
    const int r0 = min(eb, g * per), r1 = min(eb, r0 + per);
    if (r0 < r1) {
      int lo = 0, hi = K;                  // seg[lo] <= r0 < seg[lo + 1]
      while (hi - lo > 1) {
        const int mid = (lo + hi) / 2;
        if (seg[mid] <= r0) lo = mid; else hi = mid;
      }
      int k = lo;
      float aq = 0.f;
#pragma unroll
      for (int m = 0; m < G; ++m) acc[m] = 0.f;
      auto flush = [&]() {
        if (j >= f) return;
        const bool began = seg[k] < r0, goes = seg[k + 1] > r1;
        float* o = began || goes ? red + (2 * g + (began ? 0 : 1)) * W
                                 : row + gl.a + (t * K + k) * ff;
        float* oq = began || goes ? o + ff : row + gl.qv + (t * K + k) * f;
#pragma unroll
        for (int m = 0; m < G; ++m)
          if (m < f) o[m * f + j] = acc[m];
        oq[j] = aq;
      };
      for (int r = r0; r < r1; ++r) {
        if (r == seg[k + 1]) {             // the next nonempty id
          flush();
#pragma unroll
          for (int m = 0; m < G; ++m) acc[m] = 0.f;
          aq = 0.f;
          do ++k; while (seg[k + 1] == r);
        }
        const float* dmr = ms.state + size_t(vdst[r]) * SS + kDm + t * FP;
        const float e = ms.erow[size_t(r) * ES + kEg + j];
#pragma unroll
        for (int m = 0; m < G; ++m) acc[m] = fmaf(dmr[m], e, acc[m]);
        aq += ms.erow[size_t(slist[r]) * ES + kEz + j];
      }
      flush();
    }
    __syncthreads();
    // the ids that cross runs (and the empty ones), an element a thread
    for (int el = tid; el < K * W; el += kBT) {
      const int k = el / W, o = el % W;
      const int s0 = seg[k], s1 = seg[k + 1];
      if (s1 == s0) {
        out(k, o, 0.f);
        continue;
      }
      const int g0 = s0 / per, g1 = (s1 - 1) / per;
      if (g0 == g1) continue;              // its run wrote it
      float v = red[(2 * g0 + 1) * W + o];
      for (int gg = g0 + 1; gg <= g1; ++gg) v += red[2 * gg * W + o];
      out(k, o, v);
    }
  } else {
    // the runs' slots outgrow `red` (the wider groups): a thread an
    // element sums the id's positions, four interleaved sums joined in a
    // fixed order
    for (int el = tid; el < K * W; el += kBT) {
      const int k = el / W, o = el % W;
      const bool isa = o < ff;
      const int m = isa ? o / f : 0, n = isa ? o % f : o - ff;
      auto term = [&](int r) {
        return isa ? ms.state[size_t(vdst[r]) * SS + kDm + t * FP + m] *
                         ms.erow[size_t(r) * ES + kEg + n]
                   : ms.erow[size_t(slist[r]) * ES + kEz + n];
      };
      float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
      const int r1 = seg[k + 1];
      int r = seg[k];
      for (; r + 4 <= r1; r += 4) {
        c0 += term(r);
        c1 += term(r + 1);
        c2 += term(r + 2);
        c3 += term(r + 3);
      }
      if (r < r1) c0 += term(r);
      if (r + 1 < r1) c1 += term(r + 1);
      if (r + 2 < r1) c2 += term(r + 2);
      out(k, o, (c0 + c1) + (c2 + c3));
    }
  }
  __syncthreads();
}

// The body of one block, its per-node state in shared memory (kSm) or in
// its region of global scratch.
template <bool kSm>
__device__ void body(Ctx& x) {
  const BwdArgs& a = x.a;
  float* sm = x.sm;
  const int tid = threadIdx.x, q = tid / GS, j = tid % GS;
  const int f = x.f, T = kOne ? 1 : x.T, Tm = kOne ? 1 : x.Tm, K = x.K,
            N = a.n_nodes, SS = x.SS;
  const int n0 = x.n0, nb = x.nb, e0 = x.e0, eb = x.eb;
  const bool stateless = !kOne && a.stateless != 0, corr = a.with_corr != 0;
  const Scratch sc(N, a.n_edges, K, f, T, Tm, x.y.nblocks);
  const size_t slot_sz = size_t(N) * f;
  const AttsGradLayout& gl = x.gl;
  const float* st = sm + SL::stats(Tm, K);
  float* red = sm + x.L2.red;
  float* tot = sm + x.L2.tot;
  float* state = kSm ? sm + x.L2.state
                     : a.scratch + sc.state + size_t(n0) * SS;
  float* erow = kSm ? sm + x.L2.edges : a.scratch + sc.edges + size_t(e0) * ES;
  const int ncap = a.ncap, ecap = a.ecap;
  int* ibase = kSm ? reinterpret_cast<int*>(sm + x.L2.ints)
                   : reinterpret_cast<int*>(a.scratch + sc.ints);
  const size_t gp = size_t(N + x.y.nblocks + 1);      // a pointer region
  int* eptr = kSm ? ibase : ibase + n0 + x.y.b;
  int* sptr = kSm ? ibase + ncap + 1 : ibase + gp + n0 + x.y.b;
  int* einfo = kSm ? ibase + 2 * (ncap + 1) : ibase + 2 * gp + 3 * size_t(e0);
  int* spos = kSm ? einfo + 3 * ecap
                  : ibase + 2 * gp + 3 * size_t(a.n_edges) + e0;
  int* slist = kSm ? spos + ecap
                   : ibase + 2 * gp + 4 * size_t(a.n_edges) + e0;
  int* vpos = kSm ? slist + ecap
                  : ibase + 2 * gp + 5 * size_t(a.n_edges) + e0;
  int* vdst = kSm ? vpos + ecap
                  : ibase + 2 * gp + 6 * size_t(a.n_edges) + e0;
  int* vcnt = reinterpret_cast<int*>(sm + x.L2.ints) +
              (kSm ? 2 * (ncap + 1) + 7 * ecap : 0);
  int* seg = vcnt + kWB * K;             // K + 1 segment starts
  float* row = x.row;

  // ---- staging: the block's nodes and edges ------------------------------
  for (int i = tid; i <= nb; i += kBT) {
    eptr[i] = __ldg(a.dst_ptr + n0 + i) - e0;
    sptr[i] = __ldg(a.src_ptr + n0 + i) - x.s0;
  }
  for (int p = tid; p < eb; p += kBT) {
    const int e = __ldg(a.edge_order + e0 + p);
    einfo[3 * p] = __ldg(a.src + e) - n0;
    einfo[3 * p + 1] = __ldg(a.dst + e) - n0;
    einfo[3 * p + 2] = __ldg(a.vid + e);
    spos[p] = __ldg(a.src_pos + x.s0 + p) - e0;
  }
  for (int i = tid; i < nb * FP; i += kBT) {
    const int v = i / FP, jj = i % FP;
    float* s = state + size_t(v) * SS;
    const size_t g = size_t(n0 + v) * f + jj;
    if (jj < f) {
      copy4<kSm>(s + kGh + jj, a.gh + g);
      copy4<kSm>(s + kH0 + jj, a.h0 + g);
    } else {
      s[kGh + jj] = 0.f;
      s[kH0 + jj] = 0.f;
    }
    s[kD0 + jj] = 0.f;
    s[kDX + jj] = 0.f;
  }
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
        const int v = p < p1 ? einfo[3 * p + 2] : -1;
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
        if (pass == 1 && v >= 0) {
          slist[base + rank] = p;
          vpos[p] = base + rank;
        }
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
    for (int p = tid; p < eb; p += kBT) vdst[vpos[p]] = einfo[3 * p + 1];
    __syncthreads();
  }
  stamp(a.prof, 1);

  // ---- the last slot's batch sums: g = gh, x̂ of h̃_{T−1} -----------------
  if (stateless) {
    const float* stl = st + (T - 1) * 3 * FP;
    Ksum s1, s2, sx;
    for (int i = q; i < nb; i += NG) {
      const float g = state[size_t(i) * SS + kGh + j];
      const float raw =
          j < f ? __ldg(a.htil + size_t(T - 1) * slot_sz +
                        size_t(n0 + i) * f + j)
                : 0.f;
      const float xh = (raw - stl[j]) * (1.0f / stl[2 * FP + j]);
      s1.add(g);
      s2.add(g * xh);
      sx.add(j < f ? xh : 0.f);
    }
    state_partial(x, T - 1, s1, s2, sx);
  }

  // ---- the reverse chain, t = T−1..0 ---------------------------------------
  const float* w = sm;
  float dwh[3][kWReg ? FP : 1], dwi[3][kWReg ? FP : 1], own[kOwn];
  float bhh_acc[3] = {0.f, 0.f, 0.f}, bih_acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int k = 0; k < (kWReg ? FP : 1); ++k) dwh[g][k] = dwi[g][k] = 0.f;
#pragma unroll
  for (int i = 0; i < kOwn; ++i) own[i] = 0.f;
  for (int t = T - 1; t >= 0; --t) {
    const float* stt = st + t * 3 * FP;
    const float* stp = st + (t > 0 ? t - 1 : 0) * 3 * FP;
    const int ms = min(t, Tm - 1);
    // slot ms is first reached at t = T−1 (the last slot) or t = ms
    const bool first = ms < Tm - 1 || t == T - 1;
    // the norm VJP of slot t as dhp = (g − S1/c)·rd − (x̂ − x̄)·cb; the mean
    // S1/c in two floats (Mean2) taken out before the scaling, so that its
    // rounding does not add up over a large batch in the next step's sums
    float xbar = 0.f, cb = 0.f, rd = 1.f, meant = 0.f;
    Mean2 m1;
    if (stateless) {
      __syncthreads();
      combine_state(x, t);
      // x̂'s batch mean x̄ taken out: S2 −= S1·x̄
      xbar = j < f ? tot[2 * f + j] / x.c : 0.f;
      __syncthreads();
      if (tid < f) tot[f + tid] -= tot[tid] * (tot[2 * f + tid] / x.c);
      __syncthreads();
      const bool on = j < f;
      rd = 1.0f / stt[2 * FP + j];
      meant = stt[j];
      if (on) m1 = Mean2(tot[j], x.c);
      cb = on ? tot[f + j] / (x.c * stt[FP + j]) : 0.f;
    }
    stamp(a.prof, 2 + 2 * (T - 1 - t));
    const float rdp = 1.0f / stp[2 * FP + j], meanp = stp[j];
    const size_t mslot = size_t(ms) * slot_sz;
    Ksum s1, s2, sx;
    for (int i0 = 0; i0 < nb; i0 += NG) {
      // warp-uniform rounds: a slot past the nodes runs on node 0 with
      // ∂h = 0 and writes nothing
      const int i = i0 + q;
      const bool ok = i < nb;
      const int ic = ok ? i : 0;
      float* s = state + size_t(ic) * SS;
      const size_t gi = size_t(n0 + ic) * f + j;
      const bool in = j < f;
      const float g = ok ? s[kGh + j] : 0.f;
      float dhp = g;
      if (stateless) {
        const float raw = in ? __ldg(a.htil + size_t(t) * slot_sz + gi) : 0.f;
        const float xh = (raw - meant) * rd;
        dhp = ok ? m1.off_times(g, rd) - (xh - xbar) * cb : 0.f;
      }
      // the previous state (x̂ of h̃_{t−1}, h̃_{t−1} or h0), the messages
      float hprev;
      if (t > 0) {
        const float raw =
            in ? __ldg(a.htil + size_t(t - 1) * slot_sz + gi) : 0.f;
        hprev = stateless ? (raw - meanp) * rdp : raw;
      } else {
        hprev = s[kH0 + j];
      }
      const float mb = in ? __ldg(a.msgs + mslot + gi) : 0.f;
      const float* wv = w + opaque_zero();
      float hb[kWReg ? FP : 1];
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
            const int ii = hh ? e - 3 * FP * FP : e;
            const int k = ii / (3 * FP), cc = ii % (3 * FP);
            cx = hh ? FP + k : k;
            cd = hh && cc >= 2 * FP ? 5 * FP + cc - 2 * FP : 2 * FP + cc;
          } else {
            const bool hh = e >= 6 * FP * FP + 3 * FP;
            const int cc = e - 6 * FP * FP - (hh ? 3 * FP : 0);
            cd = hh && cc >= 2 * FP ? 5 * FP + cc - 2 * FP : 2 * FP + cc;
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
        float* dmr = s + kDm + ms * FP + j;
        *dmr = first ? dmb : *dmr + dmb;
        if (t > 0)
          s[kGh + j] = gprev;
        else
          s[kD0 + j] = gprev;
        if (stateless && t > 0) {
          // the next slot's sums: g = ∂h_t, x̂ = hprev
          s1.add(gprev);
          s2.add(gprev * hprev);
          sx.add(in ? hprev : 0.f);
        }
      }
    }
    if (stateless && t > 0) state_partial(x, t - 1, s1, s2, sx);
    stamp(a.prof, 3 + 2 * (T - 1 - t));
  }
  // A'_0 on its way to shared memory while the GRU rows and X_v are summed
  if (aprime_staged(K)) stage_aprime(a, sm + x.L2.ap, 0, K, f);
  // ∂W_hh, ∂W_ih, both biases into the row
  if constexpr (kWReg) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      groups_to<FP>(dwh[g], red, [&](int k, int jj, float v) {
        if (k < f && jj < f) row[gl.whh + k * 3 * f + g * f + jj] = v;
      });
      groups_to<FP>(dwi[g], red, [&](int k, int jj, float v) {
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
        const int ii = hh ? e - 3 * FP * FP : e;
        const int k = ii / (3 * FP), g = (ii % (3 * FP)) / FP, jj = ii % FP;
        if (k < f && jj < f)
          row[(hh ? gl.whh : gl.wih) + k * 3 * f + g * f + jj] = own[u];
      } else if (e < kGruEl) {
        const bool hh = e >= 6 * FP * FP + 3 * FP;
        const int cc = e - 6 * FP * FP - (hh ? 3 * FP : 0);
        if (cc % FP < f)
          row[(hh ? gl.bhh : gl.bih) + (cc / FP) * f + cc % FP] = own[u];
      }
    }
  }
  stamp(a.prof, 40);

  // ---- X_v = S_g − Σ_e h0[src] of each node (a group a graph, then a
  // group a node over its in-edges in destination order) ------------------
  if (corr) {
    for (int g0 = x.lo; g0 < x.hi; g0 += NG) {
      // warp-uniform rounds: a slot past the graphs sums no nodes
      const int g = g0 + q;
      const int v0 = g < x.hi ? __ldg(a.graph_node_ptr + g) - n0 : 0;
      const int v1 = g < x.hi ? __ldg(a.graph_node_ptr + g + 1) - n0 : 0;
      Ksum ks;
      for (int v = v0; v < v1; ++v) ks.add(state[size_t(v) * SS + kH0 + j]);
      // S_g = s − c, c (its rounding) parked in the node's dX slot
      for (int v = v0; v < v1; ++v) {
        state[size_t(v) * SS + kSg + j] = ks.s;
        state[size_t(v) * SS + kDX + j] = ks.c;
      }
    }
    __syncthreads();
    // X_v = fl(s − Σ_e h0[src]) + (its error − c), as the forward's
    for (int v = q; v < nb; v += NG) {
      float xs = 0.f;
      for (int p = eptr[v]; p < eptr[v + 1]; ++p)
        xs += state[size_t(einfo[3 * p]) * SS + kH0 + j];
      float* sv = state + size_t(v) * SS;
      float x = sv[kSg + j];
      const float e = two_sum(x, -xs);
      sv[kSg + j] = x + (e - sv[kDX + j]);
      sv[kDX + j] = 0.f;
    }
  }
  __syncthreads();

  // ---- the message VJP of each message step --------------------------------
  const bool aps = aprime_staged(K);
  for (int t = 0; t < Tm; ++t) {
    const float* wv = sm + SL::step(t, K);
    const MsgStep ms{state, erow, eptr, einfo, vpos,
                     sd::Tables{const_cast<float*>(wv) + AL::kWh,
                                sm + x.L2.tab, const_cast<float*>(wv) + SL::kQv,
                                sm + x.L2.tab + FP * FP, sm + x.L2.ap},
                     a.w.aprime + size_t(t) * K * f * f, SS, f, nb, eb, t,
                     corr, aps};
    if (FP == 16 && f <= 8)
      message_step<8>(x, ms, slist, vdst, seg);
    else
      message_step<FP>(x, ms, slist, vdst, seg);
    stamp(a.prof, 41 + t);
  }

  // ---- ∂h0: Σ_t dX over each graph into its nodes, then an element a
  // thread, its out-edges' source cotangents less Σ_t dX of their
  // destinations, in source order ---------------------------------------------
  if (corr) {
    for (int g0 = x.lo; g0 < x.hi; g0 += NG) {
      const int g = g0 + q;
      const int v0 = g < x.hi ? __ldg(a.graph_node_ptr + g) - n0 : 0;
      const int v1 = g < x.hi ? __ldg(a.graph_node_ptr + g + 1) - n0 : 0;
      Ksum ks;
      for (int v = v0; v < v1; ++v) ks.add(state[size_t(v) * SS + kDX + j]);
      for (int v = v0; v < v1; ++v) state[size_t(v) * SS + kD0 + j] += ks.s;
    }
    __syncthreads();
  }
  for (int i = tid; i < nb * f; i += kBT) {
    const int v = i / f, jj = i % f;
    float acc = state[size_t(v) * SS + kD0 + jj];
    for (int pq = sptr[v]; pq < sptr[v + 1]; ++pq) {
      const int p = spos[pq];
      acc += erow[size_t(p) * ES + kEd + jj];
      if (corr) acc -= state[size_t(einfo[3 * p + 1]) * SS + kDX + jj];
    }
    a.dh0[size_t(n0) * f + i] = acc;
  }
  stamp(a.prof, 60);
}

// The empty walk: the route's grid, staging of nothing, each round's
// combine of zero partials and the final sum of a zero row.
__device__ void floor_body(Ctx& x) {
  cp_async_wait_all();
  for (int e = threadIdx.x; e < x.gl.total; e += kBT) x.row[e] = 0.f;
  for (int e = threadIdx.x; e < 3 * FP * x.T; e += kBT)
    x.sm[x.L2.cpart + e] = 0.f;
  __syncthreads();
  if (!kOne && x.a.stateless)
    for (int t = x.T - 1; t >= 0; --t) {
      combine_state(x, t);
      __syncthreads();
    }
}

// One block of the backward (each source's kernel is this call).
__device__ void att_bwd_block(const BwdArgs& a) {
  extern __shared__ float sm[];
  const int tid = threadIdx.x;
  const int nblocks = int(gridDim.x);
  Ctx x{a, sm, Smem(a.tm, a.k_vocab, a.steps, a.ncap, a.ecap),
        Sync{a.route, nblocks, int(blockIdx.x), 0ull, a.flags, a.counters,
             a.flags == nullptr ? nullptr : a.flags + kFlagWords - 1},
        AttsGradLayout(a.tm, a.k_vocab, a.f), nullptr,
        a.steps, a.tm, a.k_vocab, a.f, (5 + a.tm) * FP,
        0, 0, 0, 0, 0, 0, 0, 0, 0.f};
  stamp(a.prof, 0);
  const bool flagged = !kOne && a.route == kRouteGrid && nblocks > 1;
  if (flagged && tid == 0)
    reinterpret_cast<unsigned long long*>(sm + x.L2.misc)[0] =
        ld_flag(x.y.last) + 1;
  // the weights staged asynchronously; waited for with the node tile
  stage_atts_weights(sm, a.w, a.f, a.k_vocab, a.tm,
                     [](float* d, bool in, const float* s) {
                       if (in)
                         cp_async4(d, s);
                       else
                         *d = 0.f;
                     });
  const int T = a.steps;
  float* st = sm + SL::stats(a.tm, a.k_vocab);
  if (!kOne && a.stateless)
    for (int i = tid; i < T * FP; i += kBT) {
      const int s = i / FP, jj = i % FP;
      const float mean = jj < a.f ? a.stats[(size_t(s) * 2) * a.f + jj] : 0.f;
      const float var =
          jj < a.f ? a.stats[(size_t(s) * 2 + 1) * a.f + jj] : 0.f;
      set_slot(st + s * 3 * FP, jj, mean, var, true);
    }
  __syncthreads();
  if (flagged)
    x.y.tag = reinterpret_cast<unsigned long long*>(sm + x.L2.misc)[0];
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
    const int n1 = __ldg(a.graph_node_ptr + x.hi);
    x.nb = n1 - x.n0;
    x.e0 = __ldg(a.dst_ptr + x.n0);
    x.eb = __ldg(a.dst_ptr + n1) - x.e0;
    x.s0 = __ldg(a.src_ptr + x.n0);
  }
  // padded node slots: ∂h0 = 0
  for (size_t i = size_t(blockIdx.x) * kBT + tid;
       i < size_t(a.n_nodes - x.n_real) * a.f; i += size_t(gridDim.x) * kBT)
    a.dh0[size_t(x.n_real) * a.f + i] = 0.f;
  const bool alone = nblocks == 1;
  const Scratch sc(a.n_nodes, a.n_edges, a.k_vocab, a.f, T, a.tm, nblocks);
  const int NW = x.gl.total;
  x.row = alone ? a.dw : a.scratch + sc.rows + size_t(x.y.b) * NW;
  if (a.floor)
    floor_body(x);
  else if (x.nb <= a.ncap && x.eb <= a.ecap)
    body<true>(x);
  else
    body<false>(x);
  if (alone) {
  } else if (a.route == kRouteCluster) {
    final_sum_cluster(x.y, a.dw, a.scratch + sc.rows, NW, NW);
  } else {
    final_sum_grid(x.y, a.dw, a.scratch + sc.rows, NW, NW,
                   a.scratch + sc.gparts);
  }
  stamp(a.prof, kProfSlots - 1);
}

}  // namespace
