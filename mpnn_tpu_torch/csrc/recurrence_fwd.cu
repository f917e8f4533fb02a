// Fused BN→GRU→BN recurrence forward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels of mpnn_tpu/kernels/recurrence.py that compute
// the chain's forward: _fwd_kernel (make_recurrence_op, VMEM-resident),
// _blocked_kernel (the blocked streaming variant) and _merged_kernel (the
// merged streaming variant past 16,384 nodes). One function
// (recurrence_common.cuh):
//
//   mb = bn1d(msgs);  h = h0·mask;  T × { h̃_t = GRU(mb, h);  h = bn1d(h̃_t) }
//
// Outputs: h_T (N, f), the batch statistics (T + 1, 2, f) — slot 0 the
// messages', slot t step t's (mean, biased var) — for the caller's
// running EMAs, and, when the backward will run, the pre-norm states h̃_t
// (T, N, f) it reads (recurrence_bwd.cu replays nothing else).
//
// Design: the whole-step training forward's (fused_step_forward.cuh, whose
// lane helpers, GRU step and slot combine this file takes). A node is a
// GROUP of FP lanes, one feature a lane (two nodes a warp at FP 16, one
// at FP 32, two nodes a group a round, interleaved); a block of 256
// threads owns a contiguous range of node slots, and its tile — each
// node's input gates gi = W_ihᵀ·mb + b_ih (computed once, at step 1) and
// its current pre-norm slot, and the mask — stays in shared memory for
// all T steps (in the block's region of global scratch when the range
// outgrows the tile: the same code). The weights are staged with
// asynchronous copies. Nothing couples nodes but the T + 1 norms'
// statistics: each block sums its real rows' Σx, then (a second pass over
// the tile) Σ(x − mean_block)², compensated, and the route combines the
// block partials in block order by Chan's formula (combine_slot), without
// a grid barrier:
//   * cluster: one thread-block cluster of C = 1, 2, 4 or 8 blocks; the
//     partials go through distributed shared memory in rank order.
//   * grid: at most the co-resident blocks, in a plain launch (the launch
//     refuses a grid the card cannot hold at once: its blocks wait on each
//     other's arrivals). A block publishes each slot's partial row and
//     counts itself in the slot's integer arrival counter; once it reads
//     the block count there, it stages every row and sums them in block
//     order. The last block to finish (one more counter) sets every
//     counter back to zero: no memset before the launch.
// No cooperative launch, no grid barrier, no float atomics; every
// cross-thread sum runs in a fixed order, so a batch gives the same bits in
// every run of the same route.
//
// Bound on an H100 SXM: per node and step two f×3f GEMVs' worth of gates
// (~6f² flop) and the bytes of msgs, h0, mask, h_T and the stash: at
// lipo's b1024 (16,512 slots, f 10, T 6) ~1 us by bytes, ~0.2 us of f32
// arithmetic (chip_smoke.py counts it from the run's shapes). The T + 1
// dependent combines set the time.

#include "fused_step_forward.cuh"
#include "recurrence_common.cuh"

namespace {

using mpnn_rec::RecWeights;
using mpnn_rec::RL;
using mpnn_rec::set_rec_slot;
using mpnn_step::al4;
using mpnn_step::combine_slot;
using mpnn_step::cp_async4;
using mpnn_step::cp_async_wait_all;
using mpnn_step::GS;
using mpnn_step::groups_sum;
using mpnn_step::gru_step;
using mpnn_step::input_gates;
using mpnn_step::kCounters;
using mpnn_step::kDone;
using mpnn_step::kFT;
using mpnn_step::kMaxGrid;
using mpnn_step::kProfSlots;
using mpnn_step::kRed;
using mpnn_step::kRouteCluster;
using mpnn_step::kRouteGrid;
using mpnn_step::kRow;
using mpnn_step::kStaged;
using mpnn_step::KSum;
using mpnn_step::kWReg;
using mpnn_step::NG;
using mpnn_step::SlotSync;
using mpnn_step::stamp_at;
using mpnn_step::whh_columns;
using namespace mpnn_train;

// a node's tile row: gi r|z|n (3·FP), the current pre-norm slot x (FP)
constexpr int kGi = 0, kX = 3 * FP, RS = 4 * FP;
struct RecFwdArgs {
  RecWeights w;
  const float* msgs;    // (N, f)
  const float* h0;      // (N, f)
  const float* mask;    // (N, 1), 0/1
  float* ht;            // (N, f) h_T
  float* stats;         // (T + 1, 2, f)
  float* htil;          // (T, N, f) pre-norm states, or null (serving)
  float* scratch;       // Scratch(...).total floats
  int* counters;        // grid route: kCounters, zero between launches
  long long* prof;      // null, or kProfSlots clock64 stamps (block 0)
  int n_nodes, f, steps, route, cluster, ncap, floor;
};

// Offsets (floats) of one block's shared memory past the staged weights
// and the T + 1 slots' norm constants (RL::after_stats), for a launch of
// `nrows` blocks.
struct Smem {
  int cpart, red, rows, mask, state, total;
  __host__ __device__ Smem(int steps, int ncap, int nrows) {
    int off = al4(RL::after_stats(steps));
    cpart = off;  off += al4((steps + 1) * kRow);
    red = off;    off += kRed;
    // every block's partial row of the slot being combined
    rows = off;   off += (nrows > 1 ? nrows : 1) * kStaged;
    mask = off;   off += al4(ncap);
    state = off;  off += ncap * RS;
    total = off;
  }
};

size_t smem_bytes(int steps, int ncap, int nrows) {
  return sizeof(float) * size_t(Smem(steps, ncap, nrows).total);
}

// Offsets (floats) of the global scratch.
struct Scratch {
  size_t state, cparts, total;
  __host__ __device__ Scratch(int n, int steps, int grid) {
    size_t off = 0;
    state = off;   off += size_t(n) * RS;              // spilled tiles
    cparts = off;  off += size_t(steps + 1) * grid * kRow;
    total = off;
  }
};

__device__ __forceinline__ void stamp(const RecFwdArgs& a, int slot) {
  stamp_at(a.prof, slot);
}

struct Ctx {
  const RecFwdArgs& a;
  float* sm;
  Smem L2;
  int b, nblocks, n0, nb;
  float cb;      // the block's real rows
  float n;       // the batch's real rows (from slot 0's combine)
};

// The weights into shared memory, zero-padded, each real element an
// asynchronous 4-byte copy (the caller waits before its barrier).
__device__ void stage_weights_async(float* sm, const RecWeights& w, int f) {
  const int tid = threadIdx.x, nt = blockDim.x;
  auto put = [&](float* d, bool in, const float* src) {
    if (in)
      cp_async4(d, src);
    else
      *d = 0.f;
  };
  for (int i = tid; i < FP * 3 * FP; i += nt) {
    const int r = i / (3 * FP), gc = i % (3 * FP), g = gc / FP, c = gc % FP;
    const bool in = r < f && c < f;
    put(sm + RL::kWih + i, in, w.w_ih + r * 3 * f + g * f + c);
    put(sm + RL::kWhh + i, in, w.w_hh + r * 3 * f + g * f + c);
  }
  for (int i = tid; i < 3 * FP; i += nt) {
    const int g = i / FP, c = i % FP;
    put(sm + RL::kBih + i, c < f, w.b_ih + g * f + c);
    put(sm + RL::kBhh + i, c < f, w.b_hh + g * f + c);
  }
  for (int i = tid; i < FP; i += nt) {
    const bool in = i < f;
    put(sm + RL::kMaW + i, in, w.ma_w + i);
    put(sm + RL::kMaB + i, in, w.ma_b + i);
    put(sm + RL::kBnW + i, in, w.bn_w + i);
    put(sm + RL::kBnB + i, in, w.bn_b + i);
  }
}

// The batch (mean, var) of slot s on the launch's route (combine_slot).
__device__ float2 combine(Ctx& x, int s, const float* bp, bool probe) {
  const RecFwdArgs& a = x.a;
  const int G = x.nblocks;
  float* gp = a.scratch + Scratch(a.n_nodes, a.steps, G).cparts +
              size_t(s) * G * kRow;
  return combine_slot(
      SlotSync{a.route, G, x.b, a.f, a.counters, probe ? a.prof : nullptr},
      s, bp, x.sm + x.L2.rows, gp, x.n);
}

// Slot s's block partial row (cpart + s·kRow) from the lanes' Σx over the
// block's real rows (`sx`) and a second pass over the tile's slot values
// (Σ(x − mean_block)² of the real rows, compensated), then the batch
// constants of the slot: combine_slot over the route, the norm constants
// in the slot's RL row, (mean, var) to `stats` by block 0. Every thread
// calls it.
__device__ void slot_stats(Ctx& x, int s, float sx, const float* state,
                           const float* mk) {
  const RecFwdArgs& a = x.a;
  float* sm = x.sm;
  float* bp = sm + x.L2.cpart + s * kRow;
  float* red = sm + x.L2.red;
  const int tid = threadIdx.x, q = tid / GS, j = tid % GS;
  const bool probe = s == 1;
  if (tid == 0) bp[3 * FP] = x.cb;
  groups_sum(sx, red, bp);
  const float mb = x.cb > 0.f ? bp[j] / x.cb : 0.f;
  if (tid < FP) bp[2 * FP + tid] = mb;
  KSum m2;
  for (int i = q; i < x.nb; i += NG) {
    if (mk[i] == 0.f) continue;
    const float d = state[size_t(i) * RS + kX + j] - mb;
    m2.add(d * d);
  }
  groups_sum(m2.s, red, bp + FP);
  if (probe) stamp(a, 76);
  const float2 mv = combine(x, s, bp, probe);
  constexpr int P = kFT / FP;
  const int i = tid / P, p = tid % P;
  if (p == 0) {
    set_rec_slot(sm + RL::kStats + s * RL::kSlot, i, mv.x, mv.y);
    if (x.b == 0 && i < a.f && !a.floor) {
      a.stats[(size_t(s) * 2) * a.f + i] = mv.x;
      a.stats[(size_t(s) * 2 + 1) * a.f + i] = mv.y;
    }
  }
  __syncthreads();
  if (probe) stamp(a, 79);
}

// The body of one block, its tile in shared memory (kSm) or in its region
// of global scratch.
template <bool kSm>
__device__ void body(Ctx& x) {
  const RecFwdArgs& a = x.a;
  float* sm = x.sm;
  const int tid = threadIdx.x, q = tid / GS, j = tid % GS;
  const int f = a.f, T = a.steps, N = a.n_nodes;
  const int n0 = x.n0, nb = x.nb;
  const size_t slot_sz = size_t(N) * f;
  float* state = kSm ? sm + x.L2.state
                     : a.scratch + Scratch(N, T, x.nblocks).state +
                           size_t(n0) * RS;
  float* mks = sm + x.L2.mask;
  const float* mk = kSm ? mks : a.mask + n0;
  const float* st = sm + RL::kStats;
  const float* w = sm;

  // ---- staging: the block's mask and messages ----------------------------
  for (int i = tid; kSm && i < nb; i += kFT) cp_async4(mks + i, a.mask + n0 + i);
  for (int i = tid; i < nb * FP; i += kFT) {
    const int v = i / FP, jj = i % FP;
    float* d = state + size_t(v) * RS + kX + jj;
    const float* src = a.msgs + size_t(n0 + v) * f + jj;
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

  // ---- slot 0: the block's real rows and their messages' Σx --------------
  {
    float c = 0.f;
    KSum sx;
    for (int i = q; i < nb; i += NG) {
      if (mk[i] == 0.f) continue;
      c += 1.f;
      sx.add(state[size_t(i) * RS + kX + j]);
    }
    // every lane of a group counts the same rows: one lane's count a group
    float* red = sm + x.L2.red;
    float* cnt = sm + x.L2.rows;
    groups_sum(c, red, cnt);
    x.cb = cnt[0];
    __syncthreads();
    stamp(a, 2);
    slot_stats(x, 0, sx.s, state, mk);
  }
  stamp(a, 3);

  // ---- T steps: gi once (step 1), then the GRU on the tile ---------------
  const float* st0 = st;
  const float mean0 = st0[j], d0 = st0[2 * FP + j];
  const float maw = w[RL::kMaW + j], mab = w[RL::kMaB + j];
  const float bnw = w[RL::kBnW + j], bnb = w[RL::kBnB + j];
  const float bhr = w[RL::kBhh + j], bhz = w[RL::kBhh + FP + j],
              bhn = w[RL::kBhh + 2 * FP + j];
  float wc[3][kWReg ? FP : 1];
  whh_columns(w + RL::kWhh + j, wc);
  for (int t = 1; t <= T; ++t) {
    const float* stp = st + (t - 1) * RL::kSlot;
    const float meanp = stp[j], dp = stp[2 * FP + j];
    KSum sx;
    // two nodes a group a round, interleaved; warp-uniform rounds: a slot
    // past the nodes runs on the round's first node (or node 0) and writes
    // nothing
    constexpr int U = 2;
    for (int i0 = 0; i0 < nb; i0 += U * NG) {
      int iu[U];
      bool ok[U];
      float* s[U];
      float m[U], raw[U], gr[U], gz[U], gn[U], hprev[U], hn[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        iu[u] = i0 + u * NG + q;
        ok[u] = iu[u] < nb;
        const int ic = ok[u] ? iu[u] : u > 0 && i0 + q < nb ? i0 + q : 0;
        s[u] = state + size_t(ic) * RS;
        m[u] = ok[u] ? mk[iu[u]] : 0.f;
        raw[u] = s[u][kX + j];
      }
      const float* wv = w + opaque_zero();
      if (t == 1) {
        // the message norm, then gi = W_ihᵀ·mb + b_ih, kept for every step
        float mb[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          mb[u] = m[u] != 0.f ? maw * ((raw[u] - mean0) / d0) + mab : 0.f;
        input_gates<U>(wv + RL::kWih + j, wv + RL::kBih + j, mb, gr, gz,
                       gn);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (ok[u]) {
            s[u][kGi + j] = gr[u];
            s[u][kGi + FP + j] = gz[u];
            s[u][kGi + 2 * FP + j] = gn[u];
          }
          hprev[u] = m[u] != 0.f && j < f
                         ? __ldg(a.h0 + size_t(n0 + iu[u]) * f + j)
                         : 0.f;
        }
      } else {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          gr[u] = s[u][kGi + j];
          gz[u] = s[u][kGi + FP + j];
          gn[u] = s[u][kGi + 2 * FP + j];
          hprev[u] =
              m[u] != 0.f ? bnw * ((raw[u] - meanp) / dp) + bnb : 0.f;
        }
      }
      gru_step<U>(wc, wv + RL::kWhh + j, bhr, bhz, bhn, gr, gz, gn, hprev,
                  hn);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float h = m[u] != 0.f && j < f ? hn[u] : 0.f;
        if (ok[u]) {
          s[u][kX + j] = h;
          if (a.htil != nullptr && j < f)
            a.htil[size_t(t - 1) * slot_sz + size_t(n0 + iu[u]) * f + j] =
                h;
          sx.add(h);
        }
      }
    }
    stamp(a, 4 + 2 * (t - 1));
    __syncthreads();
    slot_stats(x, t, sx.s, state, mk);
    stamp(a, 5 + 2 * (t - 1));
  }

  // ---- h_T = bn1d(h̃_T) -----------------------------------------------------
  {
    const float* stT = st + T * RL::kSlot;
    const float meanT = stT[j], dT = stT[2 * FP + j];
    for (int i = q; j < f && i < nb; i += NG) {
      const float raw = state[size_t(i) * RS + kX + j];
      a.ht[size_t(n0 + i) * f + j] =
          mk[i] != 0.f ? bnw * ((raw - meanT) / dT) + bnb : 0.f;
    }
  }
  stamp(a, 70);
}

// The empty forward: the route's grid, each slot's combine of zero
// partials and the route's finish; no staging and no arithmetic.
__device__ void floor_body(Ctx& x) {
  const RecFwdArgs& a = x.a;
  float* bp = x.sm + x.L2.cpart;
  for (int i = threadIdx.x; i < (a.steps + 1) * kRow; i += kFT) bp[i] = 0.f;
  __syncthreads();
  x.n = 1.f;
  for (int s = 0; s <= a.steps; ++s) combine(x, s, bp + s * kRow, false);
  __syncthreads();
}

// The route's end: the cluster's blocks meet once more (a block's shared
// memory stays alive until its peers have read its rows); on the grid the
// last block to finish (an integer counter) sets every counter back to
// zero (every block has passed every slot).
__device__ void finish(Ctx& x) {
  const RecFwdArgs& a = x.a;
  const int tid = threadIdx.x;
  __threadfence();
  if (a.route == kRouteCluster) {
    if (a.cluster > 1) cg::this_cluster().sync();
    return;
  }
  if (x.nblocks == 1) return;
  __syncthreads();
  int last = 0;
  if (tid == 0) last = atomicAdd(a.counters + kDone, 1) == x.nblocks - 1;
  if (!__syncthreads_or(last)) return;
  if (tid < kCounters) a.counters[tid] = 0;
}

__global__ void __launch_bounds__(kFT, 1)
recurrence_fwd_kernel(RecFwdArgs a) {
  extern __shared__ float sm[];
  const int nblocks = a.route == kRouteCluster ? a.cluster : int(gridDim.x);
  Ctx x{a, sm, Smem(a.steps, a.ncap, nblocks), int(blockIdx.x), nblocks,
        0, 0, 0.f, 0.f};
  stamp(a, 0);
  if (!a.floor) stage_weights_async(sm, a.w, a.f);
  // this block's node slots, balanced by count
  const long long N = a.n_nodes;
  x.n0 = int(N * x.b / nblocks);
  x.nb = int(N * (x.b + 1) / nblocks) - x.n0;
  if (a.floor)
    floor_body(x);
  else if (x.nb <= a.ncap)
    body<true>(x);
  else
    body<false>(x);
  finish(x);
  stamp(a, 75);
}

// Launch on `route`: one cluster of `grid` blocks, or `grid` blocks in a
// plain launch. The grid route's blocks wait on each other's arrivals,
// so it refuses (cudaErrorCooperativeLaunchTooLarge) a grid past the
// blocks that fit the card together at this launch's shared memory; it
// also needs the card to itself (a kernel on another stream holding SMs
// could keep a block from starting while the others wait).
int launch(const RecFwdArgs& a, int grid, void* stream) {
  const size_t bytes = smem_bytes(a.steps, a.ncap, grid);
  cudaError_t err = cudaFuncSetAttribute(
      recurrence_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (err != cudaSuccess) return int(err);
  if (a.route == kRouteGrid && grid > 1) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, recurrence_fwd_kernel, kFT, bytes) != cudaSuccess)
      return int(cudaErrorInvalidConfiguration);
    if (grid > per_sm * sms) return int(cudaErrorCooperativeLaunchTooLarge);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kFT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.route == kRouteCluster && grid > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, recurrence_fwd_kernel, a);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block at node capacity ncap in a launch of
// `blocks` blocks, in bytes (kernels/recurrence.py::fwd_smem_floats
// mirrors it).
int mpnn_recurrence_fwd_smem_bytes(int steps, int ncap, int blocks) {
  return int(smem_bytes(steps, ncap, blocks));
}

// Floats of scratch a launch needs: spilled tiles and the partial rows.
long long mpnn_recurrence_fwd_scratch_floats(int n_nodes, int steps,
                                             int grid) {
  return (long long)Scratch(n_nodes, steps, grid).total;
}

// The integer counters of the grid route (one buffer per device and
// stream, zeroed once; every launch leaves them zero).
int mpnn_recurrence_fwd_counters() { return kCounters; }

// The co-resident blocks at this shared memory, capped at kMaxGrid; 0 on
// error.
int mpnn_recurrence_fwd_max_grid(int bytes) {
  return mpnn_step::forward_max_grid(recurrence_fwd_kernel, bytes);
}

// Launches on `stream` and returns the launch's error code (0 = success).
// Does not synchronize and allocates nothing. htil: (T, N, f), every
// step's pre-norm state, or null (serving). route 0: one cluster of
// `grid` blocks (1, 2, 4 or 8); route 1: `grid` co-resident blocks with
// `counters` (mpnn_recurrence_fwd_counters ints). ncap: the node capacity
// of a block's shared memory. floor != 0 launches the empty forward (the
// same grid and combines; stats not written). prof: null or kProfSlots
// int64 clock64 stamps of block 0.
int mpnn_recurrence_fwd(const float* msgs, const float* h0,
                        const float* mask, const float* w_ih,
                        const float* w_hh, const float* b_ih,
                        const float* b_hh, const float* ma_w,
                        const float* ma_b, const float* bn_w,
                        const float* bn_b, float* ht, float* stats,
                        float* htil, float* scratch, int* counters,
                        long long* prof, int n_nodes, int f, int steps,
                        int route, int grid, int ncap, int floor,
                        void* stream) {
  if (f < 1 || f > FP || steps < 1 || steps > kMaxSteps || n_nodes < 1 ||
      grid < 1 || ncap < 1 ||
      (route == kRouteCluster &&
       (grid != 1 && grid != 2 && grid != 4 && grid != 8)) ||
      (route == kRouteGrid &&
       (grid > kMaxGrid || (grid > 1 && !counters))) ||
      (route != kRouteCluster && route != kRouteGrid))
    return int(cudaErrorInvalidValue);
  RecFwdArgs a{{w_ih, w_hh, b_ih, b_hh, ma_w, ma_b, bn_w, bn_b},
               msgs, h0, mask, ht, stats, htil, scratch, counters, prof,
               n_nodes, f, steps, route, route == kRouteCluster ? grid : 1,
               ncap, floor};
  return launch(a, grid, stream);
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
