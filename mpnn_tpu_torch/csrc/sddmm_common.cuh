// Shared pieces of the attention SDDMM kernels (sddmm_fwd.cu,
// sddmm_bwd.cu): the width bucket, the shared-memory tables, the tiles of
// edges, the per-edge gate on a group of lanes, the in-tile row sums and
// the fixed-order combines across tiles. The vocab SpMM forward
// (spmm_fwd.cu) walks its edges on the same tiles, row sums and combines.
//
// The function (mpnn_tpu/kernels/sddmm.py, the unfused attention message
// of the attention models' decomposed training path):
//
//   gate_e = softmax_feat([h[dst_e] ‖ ev[vid_e]] · Wa + ba)       (nf)
//   g_e    = gate_e ⊙ h[src_e]
//   out[d] = Σ_{e: dst_e = d} A'[vid_e] · g_e                       (N, mf)
//
// A' is the (K, mf, nf) table of one message matrix per distinct bond-
// feature row (the edge vocabulary, K <= 64), ev the (K, ef) vocab rows,
// Wa (nf + ef, nf) in the JAX (in, out) layout. The logits split into a
// per-destination part u_d = h[d]·Wh + ba (Wh = Wa's first nf rows) and a
// per-vocab part ew_k = ev[k]·We (We = the last ef rows), staged in shared
// memory once per block.
//
// Work mapping: edges, not rows, go to the workers. A kernel walks a
// sorted order of positions (an edge, or an edge's end) cut into tiles of
// TE consecutive positions; a tile is one block's, and within it a group
// of G lanes (G = 8, 16 or 32: the narrowest that holds mf and nf) takes
// `per` positions, lane j feature j. A tile first stages its positions'
// indices and their h and cotangent rows in shared memory (three rounds
// of independent loads by the whole block), then each group computes its
// positions' contributions from shared memory, the softmax a segmented
// xor-butterfly over the group's lanes. A row (the positions of one key:
// a destination, a node or a vocab id) inside a tile is summed in order
// by the group that holds its first position; a row that crosses tiles
// is summed from its tiles' partial sums in tile order. A block takes one
// tile; each tile writes its first row's partial (when that row began in
// an earlier tile) and its last row's (when that row goes on into a later
// tile) to global scratch, then adds one to the row's integer counter
// (indexed by the row's first tile); the tile that brings it to the row's
// tile count sums the partials in tile order and sets the counter back to
// zero, so the counters stay zero between launches (no memset). No grid
// barrier, no cooperative launch.
// Every sum runs in a fixed order and there are no float atomics: a batch
// gives the same bits in every run.
//
// Width buckets (kernels/build.py::WIDE, kernels/sddmm.py::BUCKETS): the
// narrow build takes nf, mf <= 16 and stages A' in shared memory (64 KB
// at K 64); the wide build (-DMPNN_FP=32) reads A' from device memory
// through the read-only cache (256 KB at K 64 would not fit a block).

#pragma once

#include <cuda_runtime.h>

#include "smem_limit.cuh"

namespace mpnn_sddmm {

using mpnn_smem::allow_smem;

#ifndef MPNN_FP
#define MPNN_FP 16
#endif
constexpr int FP = MPNN_FP;              // widest mf, nf of the bucket
static_assert(FP == 16 || FP == 32, "the buckets are 16 and 32 wide");
constexpr int kThreads = 256;
constexpr bool kTableInSmem = FP <= 16;
constexpr int kMaxVocab = 64;
constexpr int kMaxEdgeFeatures = 32;
constexpr int kMaxPer = 8;               // positions a group takes in a tile
// a combine of more partials than this splits them over 2, 4 or 8 lanes,
// joined by xor shuffles (sum_partials)
constexpr int kChain = 16;
constexpr unsigned kFull = 0xffffffffu;
// the logits' padding lanes: zero softmax mass, as the TPU kernels' −1e30
// bias pad gives
constexpr float kPadLogit = -1e30f;
// clock64 stamp slots of a launch's `prof` buffer (kernels/sddmm.py::
// PROF_SLOTS)
constexpr int kProfSlots = 24;

// ---- lane groups -----------------------------------------------------------

template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <int G>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// ---- the tables every block stages ------------------------------------------

// wh, whT, ew, ba (FP-strided, zero-padded): wh[i·FP + j] = Wa[i][j],
// whT[j·FP + i] = Wa[i][j] (i, j < nf), ew[k·FP + j] = Σ_i ev[k][i]·
// Wa[nf + i][j], bs[j] = ba[j]; then A' in the narrow bucket (`at`: the
// forward's transposed layout at[(k·FP + j)·FP + m] = A'[k][m][j], or the
// backward's ab[(k·FP + m)·FP + j] = A'[k][m][j]).
struct Tables {
  float* wh;
  float* whT;
  float* ew;
  float* bs;
  float* ap;      // A' (narrow bucket), else unused
};

__host__ __device__ inline int al4(int n) { return (n + 3) & ~3; }

__host__ __device__ inline int table_floats(int k_vocab) {
  return al4(2 * FP * FP + k_vocab * FP + FP) +
         (kTableInSmem ? k_vocab * FP * FP : 0);
}

__device__ inline Tables carve_tables(float* sm, int k_vocab) {
  Tables t;
  t.wh = sm;
  t.whT = t.wh + FP * FP;
  t.ew = t.whT + FP * FP;
  t.bs = t.ew + k_vocab * FP;
  t.ap = sm + al4(2 * FP * FP + k_vocab * FP + FP);
  return t;
}

// Stage the tables; `transposed` picks A''s layout (forward: true).
__device__ __forceinline__ void stage_tables(const Tables& t, const float* aprime,
                                    const float* wa, const float* ba,
                                    const float* evocab, int mf, int nf,
                                    int ef, int k_vocab, bool transposed) {
  const int tid = threadIdx.x;
  for (int q = tid; q < FP * FP; q += kThreads) {
    const int i = q / FP, j = q % FP;
    const bool in = i < nf && j < nf;
    t.wh[q] = in ? __ldg(wa + i * nf + j) : 0.f;
    t.whT[j * FP + i] = in ? __ldg(wa + i * nf + j) : 0.f;
  }
  for (int q = tid; q < k_vocab * FP; q += kThreads) {
    const int k = q / FP, j = q % FP;
    float s = 0.f;
    if (j < nf)
      for (int i = 0; i < ef; ++i)
        s = fmaf(__ldg(evocab + k * ef + i), __ldg(wa + (nf + i) * nf + j),
                 s);
    t.ew[q] = s;
  }
  for (int j = tid; j < FP; j += kThreads)
    t.bs[j] = j < nf ? __ldg(ba + j) : 0.f;
  if (kTableInSmem) {
    constexpr int kBatch = 8;
    auto at = [&](int i) {
      const int k = i / (FP * FP), r = i % (FP * FP);
      const int m = transposed ? r % FP : r / FP;
      const int j = transposed ? r / FP : r % FP;
      return i < k_vocab * FP * FP && m < mf && j < nf
                 ? __ldg(aprime + (size_t(k) * mf + m) * nf + j)
                 : 0.f;
    };
    for (int i0 = tid; i0 < k_vocab * FP * FP; i0 += kThreads * kBatch) {
      float v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) v[b] = at(i0 + b * kThreads);
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (i0 + b * kThreads < k_vocab * FP * FP)
          t.ap[i0 + b * kThreads] = v[b];
    }
  }
}

// ---- a tile's staged positions ------------------------------------------------

// Shared memory of a tile of te positions: five int arrays (the order's
// entry, the row key, the edge's src, dst and vid), then `rows` float
// rows of te·FP each.
struct Stage {
  int* ent;
  int* key;
  int* src;
  int* dst;
  int* vid;
  float* row;     // row r of position p: row + (r·te + p)·FP
  int te;
  __device__ float* at(int r, int p) const {
    return row + (size_t(r) * te + p) * FP;
  }
};

__host__ __device__ inline int stage_floats(int te, int rows) {
  return al4(5 * te) + rows * te * FP;
}

__device__ inline Stage carve_stage(float* sm, int te) {
  Stage s;
  int* ip = reinterpret_cast<int*>(sm);
  s.ent = ip;
  s.key = ip + te;
  s.src = ip + 2 * te;
  s.dst = ip + 3 * te;
  s.vid = ip + 4 * te;
  s.row = sm + al4(5 * te);
  s.te = te;
  return s;
}

// Load rows of x (`width` wide, zero-padded to FP) at the positions' nodes
// `idx` into staged row r, all threads of the block: thread t takes column
// t % FP of every (kThreads / FP)-th position, kBatch loads in flight
// before their stores.
__device__ __forceinline__ void stage_rows(const Stage& s, int r, const int* idx,
                                  const float* x, int width, int cnt) {
  constexpr int kStep = kThreads / FP, kBatch = 8;
  const int i = threadIdx.x % FP;
  for (int p0 = threadIdx.x / FP; p0 < cnt; p0 += kStep * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int p = p0 + b * kStep;
      v[b] = p < cnt && i < width ? __ldg(x + size_t(idx[p]) * width + i)
                                  : 0.f;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (p0 + b * kStep < cnt) s.at(r, p0 + b * kStep)[i] = v[b];
  }
}

// u_d + ew_k and the softmax over the nf real lanes of a group: the gate
// on lane j (0 past nf). hd: the destination's staged h row. Its loops,
// as every per-edge loop's, run to the group width over zero-padded rows
// (the same sums): unrolled, so that a group's two edges interleave.
template <int G>
__device__ __forceinline__ float edge_gate(const Tables& t, const float* hd,
                                           int k, int j, int nf) {
  float u = t.bs[j];
#pragma unroll
  for (int i = 0; i < G; ++i) u = fmaf(hd[i], t.wh[i * FP + j], u);
  const float logit = j < nf ? u + t.ew[k * FP + j] : kPadLogit;
  const float mx = group_max<G>(logit);
  const float ex = j < nf ? expf(logit - mx) : 0.f;
  return ex / group_sum<G>(ex);
}

// ---- fixed-order sums of partial rows -------------------------------------------

// out(o, Σ_{u < n} part(u, o)) for o < width, the u in order: every
// thread of the block calls it. A sum of more than kChain partials is
// split over S = 2, 4 or 8 lanes, each a run of consecutive partials,
// joined by an xor butterfly (a fixed order).
template <class Part, class Out>
__device__ __forceinline__ void sum_partials(int n, int width, Part part, Out out) {
  int S = 1;
  while (S < 8 && (n + S - 1) / S > kChain) S *= 2;
  const int len = (n + S - 1) / S, ls = threadIdx.x % S;
  const int u0 = ls * len, u1 = min(n, u0 + len);
  for (int o0 = 0; o0 < width; o0 += kThreads / S) {
    const int o = o0 + threadIdx.x / S;
    float s = 0.f;
    if (o < width) {
#pragma unroll 4
      for (int u = u0; u < u1; ++u) s += part(u, o);
    }
    for (int off = S / 2; off > 0; off >>= 1)
      s += __shfl_xor_sync(kFull, s, off);
    if (o < width && ls == 0) out(o, s);
  }
}

// ---- rows of vectors: the forward's out, the backward's dh ------------------------

// A row view: the rows' pointers into the positions' order, the output
// (width floats a row), the partial slots (two FP-wide rows a tile: the
// tile's first row when it began in an earlier tile, its last row when it
// goes on into a later one), the counters (one a tile), the tile length.
struct RowView {
  const int* ptr;
  float* out;
  float* slots;
  int* counters;
  int width, te;
};

// Row r's partials summed in tile order into out[r] (all threads of the
// block), its counter set back to zero first.
__device__ __forceinline__ void finish_row(const RowView& v, int r) {
  const int rs = __ldg(v.ptr + r), re = __ldg(v.ptr + r + 1);
  const int t0 = rs / v.te, t1 = (re - 1) / v.te;
  if (threadIdx.x == 0) v.counters[t0] = 0;
  __threadfence();
  sum_partials(
      t1 - t0 + 1, v.width,
      [&](int u, int o) {
        return __ldcg(v.slots + (2 * size_t(t0 + u) + (u == 0)) * FP + o);
      },
      [&](int o, float x) { v.out[size_t(r) * v.width + o] = x; });
}

// A tile's rows after its contributions are in staged row `cr`: each row's
// positions in order, summed by the group that holds its first one; a row
// inside the tile is written to out, a row crossing it to its slot. The
// tile then counts the crossing rows it takes part in and finishes those
// it completes (all threads call it; `flag`: 2 ints of shared memory).
template <int G>
__device__ __forceinline__ void tile_rows(const RowView& v, const Stage& s, int cr, int tile,
                          int cnt, int per, int* flag) {
  const int ts = tile * v.te, j = threadIdx.x % G, gi = threadIdx.x / G;
  for (int i = 0; i < per; ++i) {
    const int p = gi * per + i;
    if (p >= cnt || (p > 0 && s.key[p - 1] == s.key[p])) continue;
    const int r = s.key[p];
    float sum = 0.f;
    int q = p;
    for (; q < cnt && s.key[q] == r; ++q) sum += s.at(cr, q)[j];
    if (j < v.width) {
      // only the tile's first and last rows can cross it
      const int rs = p > 0 ? ts : __ldg(v.ptr + r);
      const int re = q < cnt ? ts + cnt : __ldg(v.ptr + r + 1);
      if (rs >= ts && re <= ts + cnt)
        v.out[size_t(r) * v.width + j] = sum;
      else
        v.slots[(2 * size_t(tile) + (rs < ts ? 0 : 1)) * FP + j] = sum;
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    flag[0] = flag[1] = -1;
    const int r0 = s.key[0], r1 = s.key[cnt - 1];
    const int rs0 = __ldg(v.ptr + r0), re0 = __ldg(v.ptr + r0 + 1);
    if (rs0 < ts) {                    // the first row began earlier
      const int t0 = rs0 / v.te, t1 = (re0 - 1) / v.te;
      if (atomicAdd(v.counters + t0, 1) == t1 - t0) flag[0] = r0;
    }
    const int rs1 = __ldg(v.ptr + r1), re1 = __ldg(v.ptr + r1 + 1);
    if (rs1 >= ts && re1 > ts + cnt) {  // the last row goes on
      const int t1 = (re1 - 1) / v.te;
      if (atomicAdd(v.counters + tile, 1) == t1 - tile) flag[1] = r1;
    }
  }
  __syncthreads();
  for (int w = 0; w < 2; ++w)
    if (flag[w] >= 0) finish_row(v, flag[w]);
}

// Zero the rows that have no position (all blocks, strided).
__device__ __forceinline__ void zero_empty_rows(const int* ptr, float* out, int n,
                                       int width) {
  for (int r = blockIdx.x * kThreads + threadIdx.x; r < n;
       r += gridDim.x * kThreads)
    if (__ldg(ptr + r) == __ldg(ptr + r + 1))
      for (int o = 0; o < width; ++o) out[size_t(r) * width + o] = 0.f;
}

// ---- host side -------------------------------------------------------------------

// Launch `kernel` on `grid` blocks of kThreads with `bytes` of dynamic
// shared memory.
template <class Kernel, class Args>
cudaError_t launch(Kernel kernel, int grid, size_t bytes,
                   cudaStream_t stream, Args args) {
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, stream>>>(args);
  return cudaGetLastError();
}

// The group width of (mf, nf): the narrowest of 8, 16, 32 that holds both;
// 0 past the bucket.
inline int group_of(int mf, int nf) {
  const int f = mf > nf ? mf : nf;
  if (f > FP) return 0;
  return FP == 32 ? 32 : f <= 8 ? 8 : 16;
}

}  // namespace mpnn_sddmm
