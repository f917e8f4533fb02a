// Set2vec readout backward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mpnn_tpu/kernels/set2vec.py::_s2v_bwd_kernel (the
// VJP of make_set2vec_op). Given gm = ∂L/∂m and the forward's stash (a row
// per step and graph: input carry, gates, query; each step's attention
// row), it walks the steps in reverse, with the cotangent carry (dmh, dmr,
// dc) per graph, starting at (gm[:, :w], gm[:, w:], 0):
//
//   read VJP      ∂x_v += att_v·dmr_g;  datt_v = dmr_g·x_v
//   softmax VJP   de_v = att_v·(datt_v − S), S = Σ datt·att over the whole
//                 batch (batch_softmax) or over v's graph
//   energy VJP    th = tanh(q_g + x_v):  ∂we += Σ th·de;
//                 dth = we·de·(1 − th²);  ∂x_v += dth;  dq_g = Σ_v dth
//   query VJP     ∂Wq += h ⊗ dq;  dh = dmh + Wq·dq
//   LSTM VJP      from the stashed gates; ∂W_x += [mh ‖ mr] ⊗ da, ∂b_x,
//                 and the carry's cotangent (dmh, dmr, dc) for step t − 1
//
// Bound on an H100: ~3× the forward's operations and its stash read once,
// microseconds; the T steps in series are what it costs. The design keeps
// each step's chain on chip, with the forward's mapping
// (set2vec_common.cuh): the cotangent carry in the graph's slot of shared
// memory; x rows staged once and ∂x accumulated beside them (the chunked
// route streams both); the stash rows of step t − 1 (and, resident, its
// attention row) brought in by TMA bulk copies while step t runs, double
// buffered against two mbarriers. The leaf gradients accumulate per block
// in shared memory (in the block's row of global scratch when its graphs'
// slots leave no room: w 32 past ~40 graphs a block): after each step the
// block adds every graph's outer products in graph order (each thread
// owns its elements), overlapping the cross-block combine; ∂we from each
// lane's sum. Blocks are summed in block order after the one grid barrier
// at the end. The wide bucket (w <= 64) has no room for its 145 KB
// accumulator beside the weights' 151: its accumulator is the block's row
// of global scratch. A block with more graphs than its shared memory
// holds slots for (w 54 past ~9 a block) keeps the cotangent slots and
// leaf operands in its region of global scratch and reads the stash rows
// where they lie: the spilled route. No float atomics anywhere.

#include "set2vec_common.cuh"

namespace {

using namespace mpnn_s2v;

// Flat layout of the gradient output and of each block's accumulator:
// real shapes, in this order. kernels/set2vec.py::grad_layout mirrors it.
struct S2vGradLayout {
  int w[4], b[4], q, e, total;
  __host__ __device__ explicit S2vGradLayout(int W) {
    for (int g = 0; g < 4; ++g) w[g] = g * 2 * W * W;
    for (int g = 0; g < 4; ++g) b[g] = 8 * W * W + g * W;
    q = 8 * W * W + 4 * W;
    e = q + W * W;
    total = e + W;
  }
};

// Shared memory (floats): the weights (WL<WB>), [the leaf accumulator,]
// [per graph a cotangent slot — dmh | dmr | dc | dq (WB each), Σ datt·att
// — and the leaf products' operands — mh | mr | da_i..da_o | h | dq (WB
// each) —, the two stash-row buffers (all three in global scratch on the
// spilled route),] two mbarriers, each warp's ∂we, the combine's total,
// the graphs' node pointers, then per row: x and ∂x (XS apart), datt /
// de, and the two attention buffers.
struct BwdSmem {
  int W8, XS, RSt, SC, S2, AB, acc, cot, op, pbuf, mbar, wd, red, gp, xs,
      dxs, db, ab, total;
  __host__ __device__ BwdSmem(int W, int WB, int gpb, int warps, int cap,
                              bool acc_smem, bool slots_smem) {
    W8 = pad8(W);
    XS = W8 + 1;
    RSt = stash_width(W);
    SC = 4 * WB + 4;
    S2 = 8 * WB;
    AB = al4(cap + 8);
    acc = weights_floats(WB);
    cot = acc + (acc_smem ? al4(S2vGradLayout(W).total) : 0);
    const int g = slots_smem ? gpb : 0;
    op = cot + g * SC;
    pbuf = op + g * S2;
    mbar = pbuf + 2 * g * RSt;
    wd = mbar + 4;
    red = wd + warps * W8;
    gp = red + 4;
    xs = gp + al4(gpb + 1);
    dxs = xs + al4(cap * XS);
    db = dxs + al4(cap * XS);
    ab = db + al4(cap);
    total = ab + 2 * AB;
  }
};

// Global scratch: the published words (T, grid, kWordStride), each
// block's leaf row (grid, NW), then on the spilled route each block's
// cotangent slots and leaf operands (grid, gpb, SC + S2).
struct BwdScratch {
  unsigned long long* part;
  float* rows;
  float* slots;
  long long total;
  __host__ __device__ BwdScratch(float* base, int W, int WB, int T,
                                 int grid, int gpb, bool slots_smem) {
    const long long words = 2LL * T * grid * kWordStride;
    // the slots start 16-byte aligned (float4 loads)
    const long long nrows =
        ((long long)grid * S2vGradLayout(W).total + 3) & ~3LL;
    part = reinterpret_cast<unsigned long long*>(base);
    rows = base + words;
    slots = rows + nrows;
    total = words + nrows +
            (slots_smem ? 0 : (long long)grid * gpb * (12 * WB + 4));
  }
};

constexpr int kBwdPhases = 6;   // clock64 stamps a step (block 0)

struct BwdArgs {
  S2vWeights w;
  const float* x;               // (N, w)
  const int* graph_node_ptr;    // (G + 1)
  const float* carry_stash;     // (T, G, stash_width(w))
  const float* att_stash;       // (T, al4(N))
  const float* gm;              // (G, 2w)
  float* dx;                    // (N, w)
  float* dw;                    // S2vGradLayout(w).total
  float* scratch;
  long long* stamps;            // (T, kBwdPhases) or null
  int n_nodes, n_graphs, width, steps, batch_softmax, gpb, cap;
  int acc_smem;   // the leaf accumulator in shared memory, else in the
                  // block's row of global scratch (graphs too many for both)
};

// The leaf gradients of one step added to the block's accumulator: each
// element's sum over the block's graphs in graph order, each thread its
// own elements, kLeafBatch of them at a time so that their read-modify-
// writes overlap (the wide bucket's accumulator is in global memory).
// Threads walk the operands' padded layout (da_g[j] at (2 + g)·WB + j), so
// a warp's loads meet no bank conflict. Every thread of the block calls
// it.
constexpr int kLeafBatch = 4;

__device__ __forceinline__ void add_batch(float* __restrict__ acc,
                                          const int (&idx)[kLeafBatch],
                                          const float (&v)[kLeafBatch]) {
  float old[kLeafBatch];
#pragma unroll
  for (int b = 0; b < kLeafBatch; ++b)
    if (idx[b] >= 0) old[b] = acc[idx[b]];
#pragma unroll
  for (int b = 0; b < kLeafBatch; ++b)
    if (idx[b] >= 0) acc[idx[b]] = old[b] + v[b];
}

__device__ void leaf_products(float* __restrict__ acc,
                              const float* __restrict__ op, int nb, int S2,
                              int W, int WB, const S2vGradLayout& GL) {
  const int nt = blockDim.x, tid = threadIdx.x;
  // ∂W_g[k][j] += Σ_i in_i[k]·da_i[g][j], in = [mh | mr]: element (k, c),
  // c = g·WB + j over the padded columns
  const int C = 4 * WB, E = 2 * W * C;
  for (int e0 = tid; e0 < E; e0 += kLeafBatch * nt) {
    int idx[kLeafBatch];
    float v[kLeafBatch];
#pragma unroll
    for (int b = 0; b < kLeafBatch; ++b) {
      const int e = e0 + b * nt, k = e / C, c = e - k * C;
      const int g = c / WB, j = c - g * WB;
      idx[b] = -1;
      v[b] = 0.f;
      if (e >= E || j >= W) continue;
      const float* pa = op + (k < W ? k : WB + k - W);
      const float* pb = op + 2 * WB + c;
      for (int i = 0; i < nb; ++i) v[b] = fmaf(pa[i * S2], pb[i * S2], v[b]);
      idx[b] = GL.w[g] + k * W + j;
    }
    add_batch(acc, idx, v);
  }
  // ∂b_g[j] += Σ_i da_i[g][j]; ∂Wq[k][j] += Σ_i h_i[k]·dq_i[j]
  const int E2 = C + W * WB;
  for (int e0 = tid; e0 < E2; e0 += kLeafBatch * nt) {
    int idx[kLeafBatch];
    float v[kLeafBatch];
#pragma unroll
    for (int b = 0; b < kLeafBatch; ++b) {
      const int e = e0 + b * nt;
      idx[b] = -1;
      v[b] = 0.f;
      if (e >= E2) continue;
      if (e < C) {
        const int g = e / WB, j = e - g * WB;
        if (j >= W) continue;
        for (int i = 0; i < nb; ++i) v[b] += op[i * S2 + 2 * WB + e];
        idx[b] = GL.b[g] + j;
      } else {
        const int kq = (e - C) / WB, j = e - C - kq * WB;
        if (j >= W) continue;
        const float *pa = op + 6 * WB + kq, *pb = op + 7 * WB + j;
        for (int i = 0; i < nb; ++i)
          v[b] = fmaf(pa[i * S2], pb[i * S2], v[b]);
        idx[b] = GL.q + kq * W + j;
      }
    }
    add_batch(acc, idx, v);
  }
}

// kSlotsSmem: the graphs' slots in shared memory, else in the block's
// region of global scratch (the spilled route); a compile-time choice, so
// that the shared-memory route's accesses stay shared-space ones
template <int WB, bool kSlotsSmem>
__global__ void __launch_bounds__(kMaxThreads, 1)
set2vec_bwd_kernel(BwdArgs a) {
  using LN = Lanes<WB>;
  using WLB = WL<WB>;
  constexpr int KP = kpl(WB), NG = LN::NG, RSQ = WLB::RSQ;
  constexpr int NS = WB <= 16 ? 2 : 1;       // pass B's node split
  extern __shared__ __align__(16) float sm[];
  const int W = a.width, G = a.n_graphs, T = a.steps;
  const int N = a.n_nodes, N4 = al4(N);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5, grid = gridDim.x, nt = blockDim.x;
  const BwdSmem L(W, WB, a.gpb, nw, a.cap, a.acc_smem != 0, kSlotsSmem);
  const S2vGradLayout GL(W);
  const BwdScratch sc(a.scratch, W, WB, T, grid, a.gpb, kSlotsSmem);
  const int W8 = L.W8, RSt = L.RSt;
  const bool global_sm = a.batch_softmax != 0, multi = grid > 1;
  int lo, hi;
  block_graphs(G, lo, hi);
  const int nb = hi - lo;

  // ---- prologue -----------------------------------------------------------
  int* gp = reinterpret_cast<int*>(sm + L.gp);
  for (int i = tid; i <= nb; i += nt) gp[i] = a.graph_node_ptr[lo + i];
  stage_weights<WB>(sm, a.w, W);
  float* acc = a.acc_smem ? sm + L.acc
                          : sc.rows + size_t(blockIdx.x) * GL.total;
  for (int i = tid; i < GL.total; i += nt) acc[i] = 0.f;
  float* const cots =
      kSlotsSmem
          ? sm + L.cot
          : sc.slots + size_t(blockIdx.x) * a.gpb * (L.SC + L.S2);
  float* const ops = kSlotsSmem ? sm + L.op : cots + a.gpb * L.SC;
  for (int e = tid; e < nb * L.SC; e += nt) {    // the cotangent from gm
    const int i = e / L.SC, o = e - i * L.SC;
    const int part = o / WB, j = o - part * WB;
    float v = 0.f;
    if (part < 2 && j < W) v = a.gm[size_t(lo + i) * 2 * W + part * W + j];
    cots[e] = v;
  }
  // the operands' padding past w is read (times zero weights) by the
  // float4 broadcasts: zero
  for (int e = tid; e < nb * L.S2; e += nt) ops[e] = 0.f;
  if (multi && global_sm)
    for (int t = tid; t < T; t += nt)
      sc.part[word_at(t, grid, blockIdx.x)] = kEmpty;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L.mbar);
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    mbar_fence_init();
  }
  {
    const int n_real = a.graph_node_ptr[G];   // padded rows: ∂x = 0
    for (size_t i = size_t(blockIdx.x) * nt + tid;
         i < size_t(N - n_real) * W; i += size_t(grid) * nt)
      a.dx[size_t(n_real) * W + i] = 0.f;
  }
  __syncthreads();
  const int bn0 = gp[0], bn1 = gp[nb];
  const bool resident = bn1 - bn0 <= a.cap;
  const int nchunks = resident ? 1 : (bn1 - bn0 + a.cap - 1) / a.cap;
  if (resident) {
    stage_rows(sm + L.xs, a.x, bn0, bn1, W, W8, L.XS);
    for (int i = tid; i < (bn1 - bn0) * L.XS; i += nt) sm[L.dxs + i] = 0.f;
  } else {
    for (int i = tid; i < (bn1 - bn0) * W; i += nt)
      a.dx[size_t(bn0) * W + i] = 0.f;
  }
  cp_async_wait_all();
  if (multi && global_sm)
    cg::this_grid().sync();    // every block's words reset
  else
    __syncthreads();

  // the stash rows of step t (unless spilled) and, resident, its attention
  // row into buffer t & 1: one thread, TMA bulk copies, one mbarrier phase
  const int a4 = bn0 & ~3, z4 = al4(bn1);
  auto issue = [&](int t) {
    const int b = t & 1;
    const unsigned cbytes = kSlotsSmem ? unsigned(nb) * RSt * 4 : 0u;
    const unsigned abytes = resident && bn1 > bn0 ? unsigned(z4 - a4) * 4 : 0;
    mbar_arrive_tx(bar + b, cbytes + abytes);
    if (cbytes)
      bulk_g2s(sm + L.pbuf + b * a.gpb * RSt,
               a.carry_stash + (size_t(t) * G + lo) * RSt, cbytes, bar + b);
    if (abytes)
      bulk_g2s(sm + L.ab + b * L.AB, a.att_stash + size_t(t) * N4 + a4,
               abytes, bar + b);
  };
  if (tid == 0) issue(T - 1);
  unsigned phase[2] = {0u, 0u};

  const float* we = sm + WLB::we;
  const float* xs = sm + L.xs;
  float* dxs = sm + L.dxs;
  float* db = sm + L.db;
  float* red = sm + L.red;
  const LN ln(lane);
  int kc[KP];                      // this lane's feature (or row), clamped
#pragma unroll
  for (int r = 0; r < KP; ++r) kc[r] = min(ln.j0 + 32 * r, W - 1);
  const int sub = NS == 2 ? lane >> 4 : 0;
  const int jl = NS == 2 ? lane & 15 : lane;
  float dwe[KP];
#pragma unroll
  for (int r = 0; r < KP; ++r) dwe[r] = 0.f;
  const bool stamp = a.stamps && blockIdx.x == 0 && tid == 0;
  auto cot = [&](int i) { return cots + i * L.SC; };
  auto opr = [&](int i) { return ops + i * L.S2; };
  // this lane's rows of the gate weights, from gate 2·gh (its half's
  // first: W_g[half][k][j] at wrow[r][WL::row(g − 2·gh, half, 0) + j]),
  // and of Wq (Wq[k][j] at qrow[r][j])
  const float* wrow[KP];
  const float* qrow[KP];
#pragma unroll
  for (int r = 0; r < KP; ++r) {
    wrow[r] = sm + WLB::gates + WLB::row(2 * ln.gh, 0, kc[r]);
    qrow[r] = sm + WLB::wq + kc[r] * RSQ;
  }
  // load rows [c0, c1) of x, their attention values of step t and (with
  // `dx`) their ∂x rows into shared memory: the chunked route
  auto stage_chunk = [&](int t, int c0, int c1, bool dx) {
    __syncthreads();
    stage_rows(sm + L.xs, a.x, c0, c1, W, W8, L.XS);
    for (int v = c0 + tid; v < c1; v += nt)
      cp_async4(sm + L.ab + v - c0, a.att_stash + size_t(t) * N4 + v);
    if (dx)          // plain loads: the block itself wrote these rows
      for (int i = tid; i < (c1 - c0) * W8; i += nt) {
        const int r = i / W8, j = i - r * W8;
        if (j < W) dxs[r * L.XS + j] = a.dx[size_t(c0 + r) * W + j];
      }
    cp_async_wait_all();
    __syncthreads();
  };

  for (int t = T - 1; t >= 0; --t) {
    const int b = t & 1;
    if (stamp) a.stamps[t * kBwdPhases] = clock64();
    mbar_wait(bar + b, phase[b]);
    phase[b] ^= 1u;
    const float* pb =                              // row i: graph lo + i
        kSlotsSmem ? sm + L.pbuf + b * a.gpb * RSt
                     : a.carry_stash + (size_t(t) * G + lo) * RSt;
    // the attention value of node v (resident: the prefetched row)
    const float* atr = sm + L.ab + b * L.AB - a4;
    if (stamp) a.stamps[t * kBwdPhases + 1] = clock64();
    for (int i = warp; i < nb; i += nw) {
      float* ct = cot(i);
#pragma unroll
      for (int r = 0; r < KP; ++r)
        if (lane + 32 * r < W) ct[3 * WB + lane + 32 * r] = 0.f;  // dq
      if (lane == 0) ct[4 * WB] = 0.f;
    }
    __syncwarp();

    // ---- pass A: datt_v = dmr·x_v and Σ datt·att per graph ----------------
    for (int ch = 0; ch < nchunks; ++ch) {
      const int c0 = bn0 + ch * a.cap, c1 = min(bn1, c0 + a.cap);
      if (!resident) stage_chunk(t, c0, c1, false);
      const float* at = resident ? atr : sm + L.ab - c0;
      for (int i = warp; i < nb; i += nw) {
        const int n0 = max(gp[i], c0), n1 = min(gp[i + 1], c1);
        if (n0 >= n1) continue;
        float* ct = cot(i);
        float gl = 0.f;
        for (int v = n0 + lane; v < n1; v += 32) {
          const float d = dot8(ct + WB, xs + (v - c0) * L.XS, W8);
          if (resident) db[v - c0] = d;
          gl = fmaf(d, at[v], gl);
        }
        gl = warp_sum_(gl);
        if (lane == 0) ct[4 * WB] += gl;
        __syncwarp();
      }
    }
    if (stamp) a.stamps[t * kBwdPhases + 2] = clock64();
    // every graph's Σ datt·att and the last step's leaf operands are
    // written; the buffer of step t + 1 is free
    __syncthreads();
    if (tid == 0 && t > 0) issue(t - 1);
    float S = 0.f;
    unsigned long long* row = sc.part + word_at(t, grid, 0);
    if (global_sm && warp == 0) {
      for (int i = lane; i < nb; i += 32) S += cot(i)[4 * WB];
      S = warp_sum_(S);
      if (multi && lane == 0)
        st_relaxed(row + blockIdx.x * kWordStride, pack2(S, 0.f));
    }
    if (t < T - 1) leaf_products(acc, ops, nb, L.S2, W, WB, GL);
    if (global_sm && warp == 0) {
      if (multi) S = sum_words(row, grid, lane);
      if (lane == 0) red[0] = S;
    }
    __syncthreads();           // the total; the leaf operands consumed
    if (stamp) a.stamps[t * kBwdPhases + 3] = clock64();
    const float S_all = global_sm ? red[0] : 0.f;

    // ---- pass B: de, ∂x, dq and ∂we --------------------------------------
    for (int ch = 0; ch < nchunks; ++ch) {
      const int c0 = bn0 + ch * a.cap, c1 = min(bn1, c0 + a.cap);
      if (!resident) stage_chunk(t, c0, c1, true);
      const float* at = resident ? atr : sm + L.ab - c0;
      for (int i = warp; i < nb; i += nw) {
        const int n0 = max(gp[i], c0), n1 = min(gp[i + 1], c1);
        if (n0 >= n1) continue;
        float* ct = cot(i);
        const float Sg = global_sm ? S_all : ct[4 * WB];
        for (int v = n0 + lane; v < n1; v += 32) {
          const float d = resident ? db[v - c0]
                                   : dot8(ct + WB, xs + (v - c0) * L.XS, W8);
          db[v - c0] = at[v] * (d - Sg);
        }
        __syncwarp();
        const float* q = pb + i * RSt + 7 * W;
#pragma unroll
        for (int r = 0; r < KP; ++r) {
          const int j = jl + 32 * r, jc = min(j, W - 1);
          const float qj = q[jc], dmrj = ct[WB + jc], wej = we[jc];
          float dq = 0.f, dwl = 0.f;
          for (int v = n0 + sub; v < n1; v += NS) {
            const int row = v - c0;
            const float th = tanh_fast(qj + xs[row * L.XS + jc]);
            const float de = db[row], dd = de * (1.0f - th * th);
            dq = fmaf(wej, dd, dq);
            dwl = fmaf(th, de, dwl);
            if (j < W)
              dxs[row * L.XS + j] += at[v] * dmrj + wej * dd;
          }
          if (NS == 2) dq += __shfl_xor_sync(kFull, dq, 16);
          if (j < W) {
            dwe[r] += dwl;
            if (sub == 0) ct[3 * WB + j] += dq;
          }
        }
        __syncwarp();
      }
      if (!resident) {
        __syncthreads();                   // every warp's ∂x of the chunk
        for (int i = tid; i < (c1 - c0) * W8; i += nt) {
          const int r = i / W8, j = i - r * W8;
          if (j < W) a.dx[size_t(c0 + r) * W + j] = dxs[r * L.XS + j];
        }
      }
    }
    if (stamp) a.stamps[t * kBwdPhases + 4] = clock64();

    // ---- the query and LSTM VJPs; the cotangent carry of step t − 1 ------
    for (int i = warp; i < nb; i += nw) {
      const float* st = pb + i * RSt;      // [mh | mr | c | i f g o | q]
      float* ct = cot(i);
      float* op = opr(i);
      // dh[k] = dmh[k] + Σ_j Wq[k][j]·dq[j]: lane over k, dq a float4
      // broadcast; at WB 16 half gh takes the j of parity gh
      float dh[KP];
#pragma unroll
      for (int r = 0; r < KP; ++r) dh[r] = 0.f;
#pragma unroll
      for (int j0 = 0; j0 < WB; j0 += 4) {
        if (j0 >= W) break;
        float d4[4];
        ld4(ct + 3 * WB + j0, d4);
        if constexpr (LN::kHalf) {
#pragma unroll
          for (int m = 0; m < 2; ++m)
            dh[0] = fmaf(qrow[0][j0 + 2 * m + ln.gh],
                         ln.gh ? d4[2 * m + 1] : d4[2 * m], dh[0]);
        } else {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int r = 0; r < KP; ++r)
              dh[r] = fmaf(qrow[r][j0 + jj], d4[jj], dh[r]);
        }
      }
      if constexpr (LN::kHalf) dh[0] += __shfl_xor_sync(kFull, dh[0], 16);
      // the LSTM VJP at this lane's feature, from the stashed gates
      float da[KP][4], h[KP], dcp[KP];
#pragma unroll
      for (int r = 0; r < KP; ++r) {
        const int j = kc[r];
        const float i_ = st[3 * W + j], f_ = st[4 * W + j],
                    g_ = st[5 * W + j], o_ = st[6 * W + j], cp = st[2 * W + j];
        const float tc = tanhf(f_ * cp + i_ * g_), dhr = ct[j] + dh[r];
        const float dct = ct[2 * WB + j] + dhr * o_ * (1.0f - tc * tc);
        h[r] = o_ * tc;
        da[r][0] = dct * g_ * i_ * (1.0f - i_);
        da[r][1] = dct * cp * f_ * (1.0f - f_);
        da[r][2] = dct * i_ * (1.0f - g_ * g_);
        da[r][3] = dhr * tc * o_ * (1.0f - o_);
        dcp[r] = dct * f_;
      }
      // the leaf operands, da among them for the products below
#pragma unroll
      for (int r = 0; r < KP; ++r) {
        const int j = ln.j0 + 32 * r;
        if (ln.gh || j >= W) continue;
        op[j] = st[j];
        op[WB + j] = st[W + j];
#pragma unroll
        for (int g = 0; g < 4; ++g) op[(2 + g) * WB + j] = da[r][g];
        op[6 * WB + j] = h[r];
        op[7 * WB + j] = ct[3 * WB + j];
      }
      __syncwarp();
      // [dmh ‖ dmr] of step t − 1 = W·da: lane over k, da a float4
      // broadcast; at WB 16 each half takes two gates
      float dmh_p[KP], dmr_p[KP];
#pragma unroll
      for (int r = 0; r < KP; ++r) dmh_p[r] = dmr_p[r] = 0.f;
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
        const float* dag = op + (2 + 2 * ln.gh + gi) * WB;
#pragma unroll
        for (int j0 = 0; j0 < WB; j0 += 4) {
          if (j0 >= W) break;
          float d4[4];
          ld4(dag + j0, d4);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int r = 0; r < KP; ++r) {
              dmh_p[r] = fmaf(wrow[r][WLB::row(gi, 0, 0) + j0 + jj], d4[jj],
                              dmh_p[r]);
              dmr_p[r] = fmaf(wrow[r][WLB::row(gi, 1, 0) + j0 + jj], d4[jj],
                              dmr_p[r]);
            }
        }
      }
      if constexpr (LN::kHalf) {
        dmh_p[0] += __shfl_xor_sync(kFull, dmh_p[0], 16);
        dmr_p[0] += __shfl_xor_sync(kFull, dmr_p[0], 16);
      }
#pragma unroll
      for (int r = 0; r < KP; ++r) {
        const int j = ln.j0 + 32 * r;
        if (ln.gh || j >= W) continue;
        ct[j] = dmh_p[r];
        ct[WB + j] = dmr_p[r];
        ct[2 * WB + j] = dcp[r];
      }
    }
    __syncwarp();
    if (stamp) a.stamps[t * kBwdPhases + 5] = clock64();
  }

  // ---- the last step's leaf products, ∂we, ∂x rows; blocks in order -----
  __syncthreads();
  leaf_products(acc, ops, nb, L.S2, W, WB, GL);
  float* wd = sm + L.wd + warp * W8;
#pragma unroll
  for (int r = 0; r < KP; ++r) {
    float v = dwe[r];
    if (NS == 2) v += __shfl_xor_sync(kFull, v, 16);
    const int j = jl + 32 * r;
    if (sub == 0 && j < W8) wd[j] = j < W ? v : 0.f;
  }
  __syncthreads();
  for (int j = tid; j < W; j += nt) {
    float s = 0.f;
    for (int w = 0; w < nw; ++w) s += sm[L.wd + w * W8 + j];
    acc[GL.e + j] += s;
  }
  if (resident)
    for (int i = tid; i < (bn1 - bn0) * W8; i += nt) {
      const int r = i / W8, j = i - r * W8;
      if (j < W) a.dx[size_t(bn0 + r) * W + j] = dxs[r * L.XS + j];
    }
  __syncthreads();
  if (multi) {
    if (a.acc_smem) {
      float* row = sc.rows + size_t(blockIdx.x) * GL.total;
      for (int e = tid; e < GL.total; e += nt) row[e] = acc[e];
    }
    cg::this_grid().sync();
    for (int e = blockIdx.x * nt + tid; e < GL.total; e += grid * nt) {
      float s = 0.f;
      for (int bb = 0; bb < grid; ++bb)
        s += __ldcg(sc.rows + size_t(bb) * GL.total + e);
      a.dw[e] = s;
    }
  } else {
    for (int e = tid; e < GL.total; e += nt) a.dw[e] = acc[e];
  }
}

const void* kernel_for(int width, bool slots_smem) {
  return slots_smem ? kernel_for_width(width, set2vec_bwd_kernel<16, true>,
                                       set2vec_bwd_kernel<WP, true>)
                    : kernel_for_width(width, set2vec_bwd_kernel<16, false>,
                                       set2vec_bwd_kernel<WP, false>);
}

}  // namespace

extern "C" {

int mpnn_set2vec_bwd_smem_bytes(int width, int gpb, int warps, int cap,
                                int acc_smem, int slots_smem) {
  return int(sizeof(float) * BwdSmem(width, wb_of(width), gpb, warps, cap,
                                     acc_smem != 0, slots_smem != 0)
                                 .total);
}

// The 11 offsets of the flat gradient layout (S2vGradLayout), total last.
void mpnn_set2vec_bwd_layout(int width, int* out) {
  const S2vGradLayout L(width);
  const int v[11] = {L.w[0], L.w[1], L.w[2], L.w[3], L.b[0], L.b[1],
                     L.b[2], L.b[3], L.q, L.e, L.total};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
}

long long mpnn_set2vec_bwd_scratch_floats(int width, int steps, int grid,
                                          int gpb, int slots_smem) {
  return BwdScratch(nullptr, width, wb_of(width), steps, grid, gpb,
                    slots_smem != 0)
      .total;
}

int mpnn_set2vec_bwd(
    const float* w_hi, const float* w_hf, const float* w_hg,
    const float* w_ho, const float* b_hi, const float* b_hf,
    const float* b_hg, const float* b_ho, const float* wq, const float* we,
    const float* x, const int* graph_node_ptr, const float* carry_stash,
    const float* att_stash, const float* gm, float* dx, float* dw,
    float* scratch, long long* stamps, int n_nodes, int n_graphs, int width,
    int steps, int batch_softmax, int grid, int warps, int gpb, int cap,
    int acc_smem, int slots_smem, void* stream) {
  if (width < 1 || width > WP || steps < 1 || n_graphs < 1 || grid < 1 ||
      grid > n_graphs || grid > kMaxGrid || warps < 1 || warps > kMaxWarps ||
      cap < 1 || (long long)gpb * grid < n_graphs)
    return int(cudaErrorInvalidValue);
  BwdArgs a{{{w_hi, w_hf, w_hg, w_ho}, {b_hi, b_hf, b_hg, b_ho}, wq, we},
            x, graph_node_ptr, carry_stash, att_stash, gm, dx, dw, scratch,
            stamps, n_nodes, n_graphs, width, steps, batch_softmax, gpb,
            cap, acc_smem};
  void* args[] = {&a};
  return int(launch_coop(
      kernel_for(width, slots_smem != 0), grid, warps,
      sizeof(float) * BwdSmem(width, wb_of(width), gpb, warps, cap,
                              acc_smem != 0, slots_smem != 0)
                          .total,
      args, stream));
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
