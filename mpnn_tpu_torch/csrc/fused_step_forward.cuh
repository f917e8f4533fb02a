// The whole-step FORWARD body of the shared-weight edge-network MPNN,
// shared by the training forward (fused_step_fwd.cu, kTrain = true) and the
// two serving kernels (fused_eval.cu, kTrain = false: the stateless state
// norm's, and the folded norms' on the free route):
//
//   m_d   = Σ_{e: dst_e = d} A[vid_e]·h0[src_e] + A0·S_g + mbias   (slot 0)
//   mb    = msg_norm(m)        (bn1d on the batch statistics of slot 0, a
//                               folded affine at serving time, or m)
//   gi    = W_ihᵀ·mb + b_ih    (the same in every step: computed once)
//   h     = h0;  T × { h̃_t = GRU(gi, h);  h = state_norm(h̃_t) }
//   out_g = Σ_{d ∈ g} softmax_od(W_iᵀ[h ‖ h0_d] + b_i) ⊙ (W_jᵀ[h ‖ h0_d] + b_j)
//   loss  = Σ_g Σ_o (out_go − y_g)²·gm_g / Σ_g gm_g          (training)
//
// state_norm is bn1d on the batch statistics of each step, w·(x − mean)/
// (sqrt(max(var, 1e-12)) + 1e-5) + b, the STATELESS norm on them, (x −
// mean)/sqrt(var + 1e-6) with no affine and no running state, a folded
// affine w·x + b at serving time, or none.
// Training writes each slot's (mean, biased var) (the running EMAs read
// the bn1d ones) and the residual stash htil (T+1, N, f): slot 0 the
// masked messages, slot t the pre-norm state of step t, padded node slots
// zero — the backward (fused_step_bwd.cu) reads them and does not replay
// the forward. Serving writes only out.
//
// Design. A node is a GROUP of FP lanes, one feature a lane (two nodes a
// warp at FP 16, one at FP 32); a block of 256 threads holds NG groups.
// Each block owns whole graphs (a contiguous node range, balanced by node
// count), so the messages, the A0 term and the readout are block-local.
// A block stages its nodes' h0 and its incoming edges (dst-sorted, as
// local source and vocab id), and each node's state — its input gates gi,
// its current pre-norm slot and h0 — stays in shared memory for the whole
// launch (in the block's region of global scratch when its graphs outgrow
// the tile: the same code). A group's node visits the same group in every
// phase, so the steps need no barrier of their own. A message is a
// reduce-scatter: lane j sums A[vid][m][j]·h0[src][j] for every output m
// over the node's edges, then the group's lanes exchange partials, so
// lane m holds output m. The GRU's products take h's other features by
// shuffles within the group; W_hh's column of a lane sits in registers at
// FP 16. The readout computes a node's gated row with lanes over od and
// stores it in the node's spent gi; then a group a graph sums its nodes'
// rows in node order.
//
// Only the per-slot batch statistics and the loss cross blocks. Each
// block sums its nodes' Σx, then (second pass over the tile) Σ(x −
// mean_block)², and the route combines the block partials in block order
// by Chan's formula — no atomics, no Σx² − n·mean². Routes
// (kernels/fused_step.py::fwd_launch_shape decides on the host, from
// shapes alone):
//   * cluster: one thread-block cluster of C = 1, 2, 4 or 8 blocks (small
//     batches); the partials go through distributed shared memory in rank
//     order. No cooperative launch.
//   * grid: up to the co-resident blocks, launched cooperatively only so
//     that they are co-resident (no grid barrier). A block publishes each
//     slot's partial row and counts itself in the slot's integer arrival
//     counter; once it reads the block count there, it stages every row
//     and sums them in block order. The last block to finish (one more
//     counter) sums the loss in graph order and sets every counter back
//     to zero: no memset before the launch.
//   * free (serving with folded norms: no statistics, no loss): any number
//     of blocks in a plain launch; nothing crosses blocks, so there is no
//     cluster, no flag and no counter, and blocks past the co-resident
//     ones simply run in a later wave.
//   Without a norm on batch statistics no slot crosses blocks at all.
//
// Numerics: float32 FMA only; every cross-thread sum runs in a fixed
// order, so a batch gives the same bits in every run of the same route.

#pragma once

#include "fused_train_common.cuh"

namespace mpnn_step {

using namespace mpnn_train;

constexpr int kFT = 256;               // threads a block
constexpr int GS = FP;                 // lanes a node (a group)
constexpr int NG = kFT / GS;           // groups a block
constexpr int kFW = kFT / 32;          // warps a block
constexpr int kMaxGrid = 512;          // kernels/fused_step.py::FWD_MAX_GRID
// the grid route's integer counters: each slot's arrivals, the launch's
constexpr int kCounters = kMaxSteps + 2;
constexpr int kDone = kMaxSteps + 1;
constexpr int kProfSlots = 80;         // block 0's clock64 stamps
// W_hh's column a lane: in registers at FP 16, read from shared memory at
// FP 32
constexpr bool kWReg = FP <= 16;
// outputs a lane in the readout: o = j + GS·u
constexpr int QO = ODP >= GS ? ODP / GS : 1;
// per-node state (floats): gi r|z|n, the current pre-norm slot x, h0; the
// readout's gated row (ODP) overwrites gi and x
constexpr int kGi = 0, kX = 3 * FP, kH0 = 4 * FP, SS = 5 * FP;
// a block's partial row of one slot: Σx (FP), Σ(x − mean_block)² (FP),
// mean_block (FP), its node count; and as the combine stages it from
// every block: mean_block (FP), Σ(x − mean_block)² (FP), the count
constexpr int kRow = 3 * FP + 4;
constexpr int kStaged = 2 * FP + 4;
constexpr int kRed = 2 * kFT;
static_assert(ODP <= 4 * FP, "a node's gated row fits its gi and x");
static_assert(QO * GS >= ODP, "a lane's outputs cover od");

enum Route { kRouteCluster = 0, kRouteGrid = 1, kRouteFree = 2 };

struct FwdArgs {
  Weights w;                // ma_w/ma_b: the folded affine in kAffine mode
  const float* h0;          // (N, f), pre-masked
  const float* labels;      // (G) (training)
  const float* gmask;       // (G) (training)
  const int* vid;           // (E)
  const int* src;           // (E)
  const int* edge_order;    // (E) edge ids, stably sorted by destination
  const int* dst_ptr;       // (N + 1) row pointers into edge_order
  const int* graph_node_ptr;  // (G + 1) node range of each graph
  float* loss;              // (1) (training)
  float* out;               // (G, od)
  float* stats;             // (T + 1, 2, f): mean, biased var (training)
  float* htil;              // (T + 1, N, f) (training)
  float* scratch;           // Scratch(...).total floats
  int* counters;            // grid route: kCounters, zero between launches
  long long* prof;          // null, or kProfSlots clock64 stamps (block 0)
  // msg_mode in {kNone, kBatchBn (training), kAffine (serving)};
  // state_mode in {kNone, kBatchBn (training), kAffine (serving: bn_w,
  // bn_b the folded affine), kStateless}
  int n_nodes, n_graphs, n_edges, f, od, k_vocab, steps, msg_mode,
      state_mode;
  int route, cluster, ncap, ecap, floor;
};

__host__ __device__ constexpr int al4(int n) { return (n + 3) & ~3; }

// Offsets (floats) of one block's shared memory past the staged weights
// and norm constants (L::after_stats), for a launch of `nrows` blocks.
struct Smem {
  int cpart, red, rows, ints, state, total;
  __host__ __device__ Smem(int k_vocab, int steps, int ncap, int ecap,
                           int nrows) {
    int off = al4(L::after_stats(k_vocab, steps));
    cpart = off;          off += al4((steps + 1) * kRow);
    red = off;            off += kRed;
    // every block's partial row of the slot being combined
    rows = off;           off += (nrows > 1 ? nrows : 1) * kStaged;
    // ints: local edge pointers (ncap + 1), edges as (local src, vid)
    ints = off;           off += al4(ncap + 1 + 2 * ecap);
    state = off;          off += ncap * SS;
    total = off;
  }
};

inline size_t fwd_smem_bytes(int k_vocab, int steps, int ncap, int ecap,
                             int nrows) {
  return sizeof(float) *
         size_t(Smem(k_vocab, steps, ncap, ecap, nrows).total);
}

// Offsets (floats) of the global scratch.
struct Scratch {
  size_t state, ints, cparts, lossg, total;
  __host__ __device__ Scratch(int n, int e, int g, int steps, int grid) {
    size_t off = 0;
    state = off;   off += size_t(n) * SS;            // spilled blocks' tiles
    // local edge pointers (a slot a block more), edges (2 ints each)
    ints = off;    off += size_t(n + grid + 1) + 2 * size_t(e);
    cparts = off;  off += size_t(steps + 1) * grid * kRow;
    lossg = off;   off += size_t(g);
    total = off;
  }
};

// ---------------------------------------------------------------------------
// device helpers
// ---------------------------------------------------------------------------

#ifdef MPNN_CUDA_EMU
__device__ inline int ld_count(const int* p) {
  return __atomic_load_n(p, __ATOMIC_RELAXED);
}
#else
__device__ __forceinline__ int ld_count(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
#endif

#ifdef MPNN_CUDA_EMU
__device__ inline void cp_async4(float* d, const float* s) {
  emu_cp_async4(d, s);
}
__device__ inline void cp_async_wait_all() { emu_cp_async_wait_all(); }
__device__ inline void spin_pause() { emu_spin_pause(); }
#else
__device__ __forceinline__ void cp_async4(float* d, const float* s) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(d))),
               "l"(s)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void spin_pause() {}
#endif

// lane j of a group takes value v of the group's lane k
__device__ __forceinline__ float gshfl(float v, int k) {
  const int base = int(threadIdx.x % 32) & ~(GS - 1);
  return __shfl_sync(kFull, v, base + k);
}

// sums and maxima over a group's lanes (the same in every lane)
__device__ __forceinline__ float gsum(float v) {
#pragma unroll
  for (int off = GS / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}
__device__ __forceinline__ float gmax(float v) {
#pragma unroll
  for (int off = GS / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Reduce-scatter over the group's lanes: every lane holds NV partials p;
// afterwards lane j holds the group's sums of p[j·NV/GS + i] in p[i],
// i < NV/GS. Each round halves the live values; the order of the adds is
// fixed.
template <int NV, int OFF = GS / 2>
__device__ __forceinline__ void reduce_scatter(float* p, int j) {
  if constexpr (OFF >= 1) {
    constexpr int H = NV * OFF / GS;
    const bool up = (j & OFF) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = up ? p[i] : p[H + i];
      const float keep = up ? p[H + i] : p[i];
      p[i] = keep + __shfl_xor_sync(kFull, send, OFF);
    }
    reduce_scatter<NV, OFF / 2>(p, j);
  }
}

// ---------------------------------------------------------------------------
// the GRU on a group's lanes (lane j: feature j of U nodes, interleaved)
// ---------------------------------------------------------------------------

// W_hh's column of lane j (whh = the staged W_hh + j, rows of 3·FP) in
// registers at FP 16; nothing at FP 32, where gru_step reads it from
// shared memory.
__device__ __forceinline__ void whh_columns(const float* whh,
                                            float (&wc)[3][kWReg ? FP : 1]) {
  if constexpr (kWReg) {
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int k = 0; k < FP; ++k)
        wc[g][k] = whh[k * 3 * FP + g * FP];
  }
}

// The input gates (r, z, n) = W_ihᵀ·mb + b_ih of U nodes at lane j: wih =
// the staged W_ih + j (rows of 3·FP), bih = the staged b_ih + j; mb's
// other features by shuffles within the group.
template <int U>
__device__ __forceinline__ void input_gates(const float* wih,
                                            const float* bih,
                                            const float (&mb)[U],
                                            float (&gr)[U], float (&gz)[U],
                                            float (&gn)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    gr[u] = bih[0];
    gz[u] = bih[FP];
    gn[u] = bih[2 * FP];
  }
#pragma unroll
  for (int k = 0; k < FP; ++k) {
    const float* wi = wih + k * 3 * FP;
    const float w0 = wi[0], w1 = wi[FP], w2 = wi[2 * FP];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float mk = gshfl(mb[u], k);
      gr[u] = fmaf(mk, w0, gr[u]);
      gz[u] = fmaf(mk, w1, gz[u]);
      gn[u] = fmaf(mk, w2, gn[u]);
    }
  }
}

// One GRU step of U nodes at lane j: the hidden gates W_hhᵀ·h + b_hh (W_hh's
// column in wc at FP 16, else read at whh = the staged W_hh + j; h's other
// features by shuffles), then h̃ = (1 − z)·n + z·h with r = σ(gi_r + gh_r),
// z = σ(gi_z + gh_z), n = tanh(gi_n + r·gh_n), into hn.
template <int U>
__device__ __forceinline__ void gru_step(const float (&wc)[3][kWReg ? FP : 1],
                                         const float* whh, float bhr,
                                         float bhz, float bhn,
                                         const float (&gr)[U],
                                         const float (&gz)[U],
                                         const float (&gn)[U],
                                         const float (&hprev)[U],
                                         float (&hn)[U]) {
  float ghr[U], ghz[U], ghn[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    ghr[u] = bhr;
    ghz[u] = bhz;
    ghn[u] = bhn;
  }
#pragma unroll
  for (int k = 0; k < FP; ++k) {
    float w0, w1, w2;
    if constexpr (kWReg) {
      w0 = wc[0][k];
      w1 = wc[1][k];
      w2 = wc[2][k];
    } else {
      const float* wh = whh + k * 3 * FP;
      w0 = wh[0];
      w1 = wh[FP];
      w2 = wh[2 * FP];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float hk = gshfl(hprev[u], k);
      ghr[u] = fmaf(w0, hk, ghr[u]);
      ghz[u] = fmaf(w1, hk, ghz[u]);
      ghn[u] = fmaf(w2, hk, ghn[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float r = sigmoidf_(gr[u] + ghr[u]);
    const float z = sigmoidf_(gz[u] + ghz[u]);
    const float nn = tanhf(gn[u] + r * ghn[u]);
    hn[u] = (1.0f - z) * nn + z * hprev[u];
  }
}

// The first graphs g in [0, G] with graph_node_ptr[g] >= t0 and >= t1,
// found by the block's threads together (one latency).
__device__ inline void first_graphs_at(const int* graph_node_ptr, int G,
                                       int t0, int t1, int* slot, int& g0,
                                       int& g1) {
  if (threadIdx.x == 0) slot[0] = slot[1] = G;
  __syncthreads();
  for (int g = threadIdx.x; g <= G; g += blockDim.x) {
    const int p = __ldg(graph_node_ptr + g);
    const int prev = g > 0 ? __ldg(graph_node_ptr + g - 1) : -1;
    if (p >= t0 && prev < t0) slot[0] = g;
    if (p >= t1 && prev < t1) slot[1] = g;
  }
  __syncthreads();
  g0 = slot[0];
  g1 = slot[1];
  __syncthreads();
}

// fused_train_common.cuh's stage_weights with each real element an
// asynchronous 4-byte copy, so that its loops issue without waiting on
// their loads (padded elements are stored as zeros). The caller waits
// (cp_async_wait_all) before its barrier.
__device__ void stage_weights_async(float* sm, const Weights& w, int f,
                                    int od, int k_vocab, bool state_affine) {
  const int tid = threadIdx.x, nt = blockDim.x;
  auto put = [&](float* d, bool in, const float* src) {
    if (in)
      cp_async4(d, src);
    else
      *d = 0.f;
  };
  for (int i = tid; i < FP * FP; i += nt) {
    const int r = i / FP, c = i % FP;
    put(sm + L::kA0 + i, r < f && c < f, w.a0 + r * f + c);
  }
  for (int i = tid; i < FP * 3 * FP; i += nt) {
    const int r = i / (3 * FP), gc = i % (3 * FP), g = gc / FP, c = gc % FP;
    const bool in = r < f && c < f;
    put(sm + L::kWih + i, in, w.w_ih + r * 3 * f + g * f + c);
    put(sm + L::kWhh + i, in, w.w_hh + r * 3 * f + g * f + c);
  }
  for (int i = tid; i < 3 * FP; i += nt) {
    const int g = i / FP, c = i % FP;
    put(sm + L::kBih + i, c < f, w.b_ih + g * f + c);
    put(sm + L::kBhh + i, c < f, w.b_hh + g * f + c);
  }
  for (int i = tid; i < FP; i += nt) {
    const bool in = i < f;
    put(sm + L::kMbias + i, in, w.mbias + i);
    put(sm + L::kMaW + i, in, w.ma_w + i);
    put(sm + L::kMaB + i, in, w.ma_b + i);
    if (state_affine)
      put(sm + L::kBnW + i, in, w.bn_w + i);
    else
      sm[L::kBnW + i] = in ? 1.f : 0.f;
    put(sm + L::kBnB + i, in && state_affine, w.bn_b + i);
  }
  for (int i = tid; kRoInSmem && i < 2 * FP * ODP; i += nt) {
    const int r = i / ODP, o = i % ODP, half = r / FP, k = r % FP;
    const bool in = k < f && o < od;
    const int srow = half * f + k;
    put(sm + L::kRiw + i, in, w.ro_iw + srow * od + o);
    put(sm + L::kRjw + i, in, w.ro_jw + srow * od + o);
  }
  for (int i = tid; i < ODP; i += nt) {
    put(sm + L::kRib + i, i < od, w.ro_ib + i);
    put(sm + L::kRjb + i, i < od, w.ro_jb + i);
  }
  for (int i = tid; kVocabInSmem && i < k_vocab * FP * FP; i += nt) {
    const int k = i / (FP * FP), rc = i % (FP * FP), r = rc / FP,
              c = rc % FP;
    put(sm + L::kAmat + i, r < f && c < f, w.amat + (k * f + r) * f + c);
  }
}

// The per-lane value v of every group summed over the block's groups in
// order (at FP 16 the two groups of a warp first), into out[j] for the
// FP features. Every thread calls it.
__device__ void groups_sum(float v, float* red, float* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if constexpr (GS < 32) v += __shfl_xor_sync(kFull, v, 16);
  if (lane < FP) red[warp * FP + lane] = v;
  __syncthreads();
  if (int(threadIdx.x) < FP) {
    float s = 0.f;
    for (int w = 0; w < kFW; ++w) s += red[w * FP + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// A compensated (Kahan) running sum: a long chain (a block's thousands of
// nodes, a graph of thousands) keeps float32 accuracy in a fixed order.
struct KSum {
  float s = 0.f, c = 0.f;
  __device__ __forceinline__ void add(float v) {
    const float y = v - c;
    const float t = s + y;
    c = (t - s) - y;
    s = t;
  }
};

__device__ __forceinline__ void stamp(const FwdArgs& a, int slot) {
  if (a.prof != nullptr && blockIdx.x == 0 && threadIdx.x == 0 &&
      slot < kProfSlots)
    a.prof[slot] = clock64();
}

struct Ctx {
  const FwdArgs& a;
  float* sm;
  int T, f, od, b, nblocks;
  int lo, hi, n0, nb, e0, eb, n_real;
  Smem L2;
};

// How the block partial rows of a slot meet (combine_slot): the route,
// the launch's blocks and this one, the real features, the grid route's
// arrival counters (a slot each), and block 0's clock64 stamps of the
// combine (null: none).
struct SlotSync {
  int route, nblocks, b, f;
  int* counters;
  long long* prof;
};

__device__ __forceinline__ void stamp_at(long long* prof, int slot) {
  if (prof != nullptr && blockIdx.x == 0 && threadIdx.x == 0 &&
      slot < kProfSlots)
    prof[slot] = clock64();
}

// The batch mean and biased var of slot s from the route's block partial
// rows (this block's at bp: Σx (FP), Σ(x − mean_block)² (FP), mean_block
// (FP), its count; the same offset in every block): every row staged in
// shared memory (`rows`, nblocks·kStaged floats) in one round trip (from
// the cluster's peers, or, on the grid route, published to `gp`, the
// slot's nblocks·(2f + 1) floats of global scratch, and read back once the
// slot's arrival counter reads the block count), then Chan's formula over
// the blocks in order: the P lanes of a feature take every P-th block in
// order and combine in a fixed xor tree. `n`: the batch's real rows (0:
// summed from the rows' counts, into n). Every thread calls it and gets
// the (mean, var) of feature threadIdx.x / P (zero past f).
__device__ float2 combine_slot(const SlotSync& y, int s, const float* bp,
                               float* rows, float* gp, float& n) {
  const int tid = threadIdx.x;
  const int G = y.nblocks;
  if (G > 1 && y.route == kRouteCluster) {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    stamp_at(y.prof, 77);
    for (int e = tid; e < G * (2 * FP + 1); e += kFT) {
      const int r = e / (2 * FP + 1), c = e % (2 * FP + 1);
      // mean_block, then Σ(x − mean_block)², then the count
      const int from = c < FP ? 2 * FP + c : c < 2 * FP ? c : 3 * FP;
      rows[r * kStaged + c] = cl.map_shared_rank(bp, r)[from];
    }
  } else if (G > 1) {
    // the published row holds the real features only: mean_block (f),
    // Σ(x − mean_block)² (f), the count
    const int f = y.f, wr = 2 * f + 1;
    auto col = [&](int c) { return (c / f) * FP + c % f; };
    if (tid < wr)
      gp[size_t(y.b) * wr + tid] =
          bp[tid < f ? 2 * FP + tid : tid < 2 * f ? FP + tid - f : 3 * FP];
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      atomicAdd(y.counters + s, 1);
      while (ld_count(y.counters + s) < G) spin_pause();
      __threadfence();
    }
    __syncthreads();
    stamp_at(y.prof, 77);
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
  stamp_at(y.prof, 78);
  // lane p of feature i takes blocks p, p + P, ... (padded features: zero)
  constexpr int P = kFT / FP;
  const int i = tid / P, p = tid % P;
  const bool real = i < y.f;
  auto psum = [](float v) {
#pragma unroll
    for (int off = P / 2; off > 0; off >>= 1)
      v += __shfl_xor_sync(kFull, v, off);
    return v;
  };
  if (n <= 0.f) {
    float c = 0.f;
    for (int bb = p; bb < G; bb += P) c += rows[bb * kStaged + 2 * FP];
    n = psum(c);
  }
  float v = 0.f;
  for (int bb = p; real && bb < G; bb += P) {
    const float* row = rows + bb * kStaged;
    v = fmaf(row[2 * FP], row[i], v);     // count · mean_block
  }
  const float mean = psum(v) / n;
  float w = 0.f;
  for (int bb = p; real && bb < G; bb += P) {
    const float* row = rows + bb * kStaged;
    const float c = row[2 * FP];
    if (c > 0.f) {
      const float d = row[i] - mean;
      w += row[FP + i] + c * d * d;
    }
  }
  return make_float2(mean, psum(w) / n);
}

// The batch mean and biased var of slot s from the route's block partial
// rows (this block's in cpart + s·kRow; combine_slot), then the slot's
// norm constants (the stateless convention with `stateless`); block 0
// writes (mean, var) to `stats` when it is given. Every thread calls it.
__device__ void finish_slot(Ctx& x, int s, bool stateless, float* stats) {
  const FwdArgs& a = x.a;
  float* sm = x.sm;
  const int tid = threadIdx.x;
  const int G = x.nblocks;
  // block 0's stamps of the first step's combine: its row complete, every
  // block's row there, staged, summed
  const bool probe = s == 1;
  if (probe) stamp(a, 76);
  float n = float(x.n_real);
  const float2 mv = combine_slot(
      SlotSync{a.route, G, x.b, x.f, a.counters, probe ? a.prof : nullptr},
      s, sm + x.L2.cpart + s * kRow, sm + x.L2.rows,
      a.scratch + Scratch(a.n_nodes, a.n_edges, a.n_graphs, a.steps, G)
                      .cparts + size_t(s) * G * kRow,
      n);
  constexpr int P = kFT / FP;
  const int i = tid / P, p = tid % P;
  const bool real = i < x.f;
  if (p == 0) {
    set_slot(sm + L::stats(a.k_vocab) + s * 3 * FP, i, mv.x, mv.y,
             stateless);
    if (stats != nullptr && x.b == 0 && real) {
      stats[(size_t(s) * 2) * x.f + i] = mv.x;
      stats[(size_t(s) * 2 + 1) * x.f + i] = mv.y;
    }
  }
  __syncthreads();
  if (probe) stamp(a, 79);
}

// Slot s's block partial row from the lanes' Σx (`sx`) and a second pass
// over the tile's slot values (Σ(x − mean_block)²), then the batch
// constants of the slot.
__device__ void slot_stats(Ctx& x, int s, float sx, const float* state,
                           bool stateless, float* stats) {
  float* sm = x.sm;
  float* bp = sm + x.L2.cpart + s * kRow;
  float* red = sm + x.L2.red;
  const int tid = threadIdx.x, q = tid / GS, j = tid % GS;
  if (tid == 0) bp[3 * FP] = float(x.nb);
  groups_sum(sx, red, bp);
  const float c = float(x.nb);
  const float mb = x.nb > 0 ? bp[j] / c : 0.f;
  if (tid < FP) bp[2 * FP + tid] = mb;
  KSum m2;
  for (int i = q; i < x.nb; i += NG) {
    const float d = state[size_t(i) * SS + kX + j] - mb;
    m2.add(d * d);
  }
  groups_sum(m2.s, red, bp + FP);
  finish_slot(x, s, stateless, stats);
}

// ---------------------------------------------------------------------------
// the body of one block
// ---------------------------------------------------------------------------

template <bool kTrain, bool kSm>
__device__ void body(Ctx& x) {
  const FwdArgs& a = x.a;
  float* sm = x.sm;
  const int tid = threadIdx.x, q = tid / GS, j = tid % GS;
  const int f = x.f, od = x.od, T = x.T, N = a.n_nodes;
  const int n0 = x.n0, nb = x.nb, e0 = x.e0, eb = x.eb;
  const int mmode = a.msg_mode, smode = a.state_mode;
  const bool msg_stats = has_stats(mmode), state_stats = has_stats(smode);
  const Scratch sc(N, a.n_edges, a.n_graphs, T, x.nblocks);
  const size_t slot_sz = size_t(N) * f;
  const float* st = sm + L::stats(a.k_vocab);
  float* state =
      kSm ? sm + x.L2.state : a.scratch + sc.state + size_t(n0) * SS;
  int* ibase = kSm ? reinterpret_cast<int*>(sm + x.L2.ints)
                   : reinterpret_cast<int*>(a.scratch + sc.ints);
  int* eptr = kSm ? ibase : ibase + n0 + x.b;             // nb + 1
  int* einfo = kSm ? ibase + a.ncap + 1
                   : ibase + (N + x.nblocks + 1) + 2 * size_t(e0);
  const float* w = sm;

  // ---- staging: the block's nodes' h0, its edges as (local src, vid) ----
  for (int i = tid; i <= nb; i += kFT) eptr[i] = __ldg(a.dst_ptr + n0 + i) - e0;
  for (int p = tid; p < eb; p += kFT) {
    const int e = __ldg(a.edge_order + e0 + p);
    einfo[2 * p] = __ldg(a.src + e) - n0;
    einfo[2 * p + 1] = __ldg(a.vid + e);
  }
  for (int i = tid; i < nb * FP; i += kFT) {
    const int v = i / FP, jj = i % FP;
    float* d = state + size_t(v) * SS + kH0 + jj;
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

  // ---- A0·S_g + mbias per graph (a group a graph) into its nodes' x ------
  for (int g0 = x.lo; g0 < x.hi; g0 += NG) {
    // warp-uniform rounds: a slot past the graphs sums no nodes
    const int g = g0 + q;
    const int v0 = g < x.hi ? __ldg(a.graph_node_ptr + g) - n0 : 0;
    const int v1 = g < x.hi ? __ldg(a.graph_node_ptr + g + 1) - n0 : 0;
    KSum ks;
    for (int v = v0; v < v1; ++v) ks.add(state[size_t(v) * SS + kH0 + j]);
    const float S = ks.s;
    float p[FP];
#pragma unroll
    for (int m = 0; m < FP; ++m) p[m] = w[L::kA0 + m * FP + j] * S;
    reduce_scatter<FP>(p, j);
    const float base = p[0] + w[L::kMbias + j];
    for (int u = v0; u < v1; ++u) state[size_t(u) * SS + kX + j] = base;
  }
  __syncthreads();

  // ---- messages: a group a node, a lane a source feature, then a
  //      reduce-scatter to a lane an output ---------------------------------
  KSum sx;
  // the two groups of a warp read their ids' tables in opposite row order
  // (the same rows at FP 16 would share banks)
  const int par = (GS < 32 && kVocabInSmem) ? (tid / GS) & 1 : 0;
  for (int i0 = 0; i0 < nb; i0 += NG) {
    const int i = i0 + q;
    const bool ok = i < nb;
    float p[FP];
#pragma unroll
    for (int m = 0; m < FP; ++m) p[m] = 0.f;
    const int pa = ok ? eptr[i] : 0, pe = ok ? eptr[i + 1] : 0;
    for (int pp = pa; pp < pe; ++pp) {
      const int sl = einfo[2 * pp], k = einfo[2 * pp + 1];
      const float hs = state[size_t(sl) * SS + kH0 + j];
      const float* am = amat_of(w, a.w, k) + j;
#pragma unroll
      for (int m = 0; m < FP; m += 2) {
        const float u0 = am[(m + par) * FP], u1 = am[(m + 1 - par) * FP];
        p[m] = fmaf(par ? u1 : u0, hs, p[m]);
        p[m + 1] = fmaf(par ? u0 : u1, hs, p[m + 1]);
      }
    }
    reduce_scatter<FP>(p, j);
    if (ok) {
      float* s = state + size_t(i) * SS;
      const float m = p[0] + s[kX + j];
      s[kX + j] = m;
      if (kTrain && j < f) a.htil[size_t(n0 + i) * f + j] = m;
      sx.add(m);
    }
  }
  stamp(a, 2);
  if (msg_stats) {
    __syncthreads();
    slot_stats(x, 0, sx.s, state, false, kTrain ? a.stats : nullptr);
  }
  stamp(a, 3);

  // ---- T steps: gi once (step 1), then the GRU on the tile ---------------
  const float* st0 = st;
  const float maw = w[L::kMaW + j], mab = w[L::kMaB + j];
  const float bnw = w[L::kBnW + j], bnb = w[L::kBnB + j];
  const float bhr = w[L::kBhh + j], bhz = w[L::kBhh + FP + j],
              bhn = w[L::kBhh + 2 * FP + j];
  float wc[3][kWReg ? FP : 1];
  whh_columns(w + L::kWhh + j, wc);
  for (int t = 1; t <= T; ++t) {
    const float* stp = st + (t - 1) * 3 * FP;
    const float meanp = stp[j], dp = stp[2 * FP + j];
    sx = KSum();
    // two nodes a group a round, interleaved (U of them); warp-uniform
    // rounds: a slot past the nodes runs on the round's first node (or
    // node 0) and writes nothing
    constexpr int U = 2;
    for (int i0 = 0; i0 < nb; i0 += U * NG) {
      int iu[U];
      bool ok[U];
      float* s[U];
      float raw[U], gr[U], gz[U], gn[U], hprev[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        iu[u] = i0 + u * NG + q;
        ok[u] = iu[u] < nb;
        s[u] = ok[u] ? state + size_t(iu[u]) * SS
               : u > 0 ? s[0] : state;
        raw[u] = s[u][kX + j];
      }
      const float* wv = w + opaque_zero();
      if (t == 1) {
        // the message norm, then gi = W_ihᵀ·mb + b_ih, kept for every step
        float mb[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          mb[u] = msg_stats ? maw * ((raw[u] - st0[j]) / st0[2 * FP + j]) + mab
                  : mmode == kAffine ? maw * raw[u] + mab
                                     : raw[u];
        }
        input_gates<U>(wv + L::kWih + j, wv + L::kBih + j, mb, gr, gz, gn);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (ok[u]) {
            s[u][kGi + j] = gr[u];
            s[u][kGi + FP + j] = gz[u];
            s[u][kGi + 2 * FP + j] = gn[u];
          }
          hprev[u] = s[u][kH0 + j];
        }
      } else {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          gr[u] = s[u][kGi + j];
          gz[u] = s[u][kGi + FP + j];
          gn[u] = s[u][kGi + 2 * FP + j];
          hprev[u] = state_stats     ? bnw * ((raw[u] - meanp) / dp) + bnb
                     : smode == kAffine ? fmaf(bnw, raw[u], bnb)
                                        : raw[u];
        }
      }
      float hnu[U];
      gru_step<U>(wc, wv + L::kWhh + j, bhr, bhz, bhn, gr, gz, gn, hprev,
                  hnu);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float hn = hnu[u];
        if (ok[u]) {
          s[u][kX + j] = hn;
          if (kTrain && j < f)
            a.htil[size_t(t) * slot_sz + size_t(n0 + iu[u]) * f + j] = hn;
          sx.add(hn);
        }
      }
    }
    stamp(a, 4 + 2 * (t - 1));
    if (state_stats) {
      __syncthreads();
      slot_stats(x, t, sx.s, state, smode == kStateless,
                 kTrain ? a.stats : nullptr);
    }
    stamp(a, 5 + 2 * (t - 1));
  }
  __syncthreads();

  // ---- the readout: a group a node (its gated row over its spent gi),
  //      then a group a graph sums its nodes' rows in order -------------------
  {
    const float* stT = st + T * 3 * FP;
    const float meanT = stT[j], dT = stT[2 * FP + j];
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
        s[u] = ok[u] ? state + size_t(i) * SS : u > 0 ? s[0] : state;
        const float raw = s[u][kX + j];
        h[u] = state_stats     ? bnw * ((raw - meanT) / dT) + bnb
               : smode == kAffine ? fmaf(bnw, raw, bnb)
                                  : raw;
        h0v[u] = s[u][kH0 + j];
#pragma unroll
        for (int v = 0; v < QO; ++v) {
          const int o = j + GS * v;
          pi[u][v] = o < ODP ? w[L::kRib + o] : 0.f;
          pj[u][v] = o < ODP ? w[L::kRjb + o] : 0.f;
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
          if (o < ODP) {
            const float wi = riw[k * ODP + o], wj = rjw[k * ODP + o];
            const float wi0 = riw[(FP + k) * ODP + o],
                        wj0 = rjw[(FP + k) * ODP + o];
#pragma unroll
            for (int u = 0; u < U; ++u) {
              pi[u][v] = fmaf(hk[u], wi, pi[u][v]);
              pj[u][v] = fmaf(hk[u], wj, pj[u][v]);
              pi[u][v] = fmaf(h0k[u], wi0, pi[u][v]);
              pj[u][v] = fmaf(h0k[u], wj0, pj[u][v]);
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
            if (o < ODP) s[u][o] = (pi[u][v] / den) * pj[u][v];
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
        for (int v = v0; v < v1; ++v) ks.add(state[size_t(v) * SS + o]);
        const float acc = ks.s;
        if (ok) a.out[size_t(g) * od + o] = acc;
        if (kTrain && ok) {
          const float d = acc - __ldg(a.labels + g);
          l = fmaf(d * d, __ldg(a.gmask + g), l);
        }
      }
      if (kTrain) {
        l = gsum(l);
        if (ok && j == 0) lossg[g] = l;
      }
    }
  }
  stamp(a, 71);
}

// The empty forward: the route's grid, each slot's combine of zero
// partials and the route's finish; no staging and no arithmetic.
__device__ void floor_body(Ctx& x) {
  const FwdArgs& a = x.a;
  float* bp = x.sm + x.L2.cpart;
  for (int i = threadIdx.x; i < (x.T + 1) * kRow; i += kFT) bp[i] = 0.f;
  __syncthreads();
  if (has_stats(a.msg_mode)) finish_slot(x, 0, false, nullptr);
  for (int t = 1; t <= x.T; ++t)
    if (has_stats(a.state_mode))
      finish_slot(x, t, a.state_mode == kStateless, nullptr);
}

// loss = Σ_g term_g / Σ_g gm_g in graph order, by one block
__device__ void loss_sum(Ctx& x) {
  const FwdArgs& a = x.a;
  const float* lossg = a.scratch + Scratch(a.n_nodes, a.n_edges, a.n_graphs,
                                           a.steps, x.nblocks).lossg;
  float* red = x.sm + x.L2.red;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float num = 0.f, den = 0.f;
  if (!a.floor)
    for (int g = tid; g < a.n_graphs; g += kFT) {
      num += __ldcg(lossg + g);
      den += __ldg(a.gmask + g);
    }
  num = warp_sum(num);
  den = warp_sum(den);
  if (lane == 0) {
    red[warp] = num;
    red[kFW + warp] = den;
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

// The route's end: the loss (training) by the last block of the grid (an
// integer counter), cluster rank 0 or the one block; the grid's last block
// sets every counter back to zero (every block has passed every slot).
// The free route has nothing to finish.
template <bool kTrain>
__device__ void finish(Ctx& x) {
  const FwdArgs& a = x.a;
  const int tid = threadIdx.x;
  if (a.route == kRouteFree) return;
  __threadfence();
  if (a.route == kRouteCluster && a.cluster > 1) {
    // also keeps every block's shared memory alive until its peers have
    // read its partial rows
    cg::this_cluster().sync();
    if (kTrain && x.b == 0) loss_sum(x);
    return;
  }
  if (x.nblocks == 1) {
    __syncthreads();
    if (kTrain) loss_sum(x);
    return;
  }
  __syncthreads();
  int last = 0;
  if (tid == 0) last = atomicAdd(a.counters + kDone, 1) == x.nblocks - 1;
  if (!__syncthreads_or(last)) return;
  if (tid < kCounters) a.counters[tid] = 0;
  __threadfence();
  if (kTrain) loss_sum(x);
}

// The partial rows a block stages for a slot's combine: one a block of
// the launch; none cross blocks on the free route.
__host__ __device__ inline int staged_rows(int route, int nblocks) {
  return route == kRouteFree ? 1 : nblocks;
}

template <bool kTrain>
__device__ void step_forward(const FwdArgs& a) {
  extern __shared__ float sm[];
  const int tid = threadIdx.x;
  const int nblocks = a.route == kRouteCluster ? a.cluster : int(gridDim.x);
  Ctx x{a, sm, a.steps, a.f, a.od, int(blockIdx.x), nblocks, 0, 0, 0, 0, 0,
        0, 0, Smem(a.k_vocab, a.steps, a.ncap, a.ecap,
             staged_rows(a.route, nblocks))};
  stamp(a, 0);
  if (!a.floor)
    stage_weights_async(sm, a.w, a.f, a.od, a.k_vocab,
                        a.state_mode != kStateless);
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
  if (kTrain) {
    // padded node slots carry zero in every stash slot; the stats rows of
    // a norm without statistics are zero
    const int N = a.n_nodes, f = a.f, T = a.steps;
    const size_t slot_sz = size_t(N) * f;
    const size_t pad = size_t(N - x.n_real) * f;
    for (size_t i = size_t(blockIdx.x) * kFT + tid; i < pad * (T + 1);
         i += size_t(gridDim.x) * kFT)
      a.htil[(i / pad) * slot_sz + size_t(x.n_real) * f + i % pad] = 0.f;
    if (blockIdx.x == 0)
      for (int i = tid; i < 2 * (T + 1) * f; i += kFT) {
        const int s = i / (2 * f);
        if (a.floor || !has_stats(s == 0 ? a.msg_mode : a.state_mode))
          a.stats[i] = 0.f;
      }
  }
  __syncthreads();
  if (a.floor)
    floor_body(x);
  else if (x.nb <= a.ncap && x.eb <= a.ecap)
    body<kTrain, true>(x);
  else
    body<kTrain, false>(x);
  finish<kTrain>(x);
  stamp(a, 75);
}

// ---------------------------------------------------------------------------
// host side: the C entry points of both libraries share these
// ---------------------------------------------------------------------------

// The co-resident blocks of `kernel` at this shared memory, capped at
// kMaxGrid; 0 on error.
template <typename K>
int forward_max_grid(K kernel, int bytes) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess)
    return 0;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kFT,
                                                    size_t(bytes)) !=
          cudaSuccess)
    return 0;
  return min(per_sm * sms, kMaxGrid);
}

// Checks the route's arguments; 0 when they hold.
inline int check_route(const FwdArgs& a, int grid) {
  if (a.f > FP || a.od > ODP || a.steps < 1 || a.steps > kMaxSteps ||
      grid < 1 || a.ncap < 1 || a.ecap < 0 ||
      (a.route == kRouteCluster &&
       (grid != 1 && grid != 2 && grid != 4 && grid != 8)) ||
      (a.route == kRouteGrid &&
       (grid > kMaxGrid || (grid > 1 && !a.counters))) ||
      (a.route == kRouteFree &&
       (has_stats(a.msg_mode) || has_stats(a.state_mode) || a.loss)) ||
      (a.route != kRouteCluster && a.route != kRouteGrid &&
       a.route != kRouteFree))
    return int(cudaErrorInvalidValue);
  return 0;
}

// Launch `kernel` on `stream`: one cluster of `grid` blocks, `grid`
// co-resident blocks (a cooperative launch, for co-residency only), or on
// the free route `grid` blocks in a plain launch. Returns the launch's
// error code (0 = success). Does not synchronize.
template <typename K>
int launch_forward(K kernel, FwdArgs a, int grid, void* stream) {
  const size_t bytes = fwd_smem_bytes(a.k_vocab, a.steps, a.ncap, a.ecap,
                                      staged_rows(a.route, grid));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.route == kRouteGrid) {
    void* args[] = {&a};
    err = cudaLaunchCooperativeKernel((void*)kernel, dim3(grid), dim3(kFT),
                                      args, bytes, s);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(kFT);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = grid;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = a.route == kRouteCluster && grid > 1 ? 1 : 0;
    err = cudaLaunchKernelEx(&cfg, kernel, a);
  }
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace mpnn_step
