// Attention SDDMM backward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels mpnn_tpu/kernels/sddmm.py::_sddmm_bwd_kernel
// and _sddmm_t_bwd_kernel (the VJP of make_sddmm_op in its row and
// transposed layouts, one function): for the cotangent gout (N, mf) of
// out, with gate_e, g_e recomputed per edge as the forward has them,
//
//   dg_e   = A'[vid_e]ᵀ · gout[dst_e],   dgate_e = dg_e ⊙ h[src_e]
//   dlog_e = gate_e ⊙ (dgate_e − Σ gate_e ⊙ dgate_e)
//   dh[s]  = Σ_{e: src_e = s} dg_e ⊙ gate_e  +  Σ_{e: dst_e = s} Wh · dlog_e
//   dA'[k] = Σ_{e: vid_e = k} gout[dst_e] ⊗ g_e                 (K, mf, nf)
//   dWh    = Σ_k dWh_k,  dWh_k = Σ_{e: vid_e = k} h[dst_e] ⊗ dlog_e
//   dba    = Σ_k Dv_k,   Dv_k = Σ_{e: vid_e = k} dlog_e
//   dev[k] = We · Dv_k,   dWe = Σ_k ev[k] ⊗ Dv_k
//
// (Wa = [Wh; We], dWa = [dWh; dWe].) The TPU kernels recompute the gate in
// node windows and accumulate every gradient across their sequential grid
// in VMEM; here the tiles run in parallel and every sum has a fixed order.
//
// Design: one launch, no grid barrier, two views of the edges, each cut
// into tiles as sddmm_common.cuh describes and each recomputing the gate:
//   - the node view walks the 2E edge ends stably sorted by node (the
//     wrapper's sort of [dst; src]): an end contributes Wh·dlog_e at its
//     destination or dg_e ⊙ gate_e at its source, and a node's ends,
//     summed in order, are its dh row (a row crossing tiles from the
//     tiles' partials in tile order) — dh's two halves in one sum;
//   - the vocab view walks the edges stably sorted by vocab id: a tile
//     stages gout[dst], g, h[dst] and dlog of its edges and forms each of
//     its ids' dA'_k, dWh_k and Dv_k as dot products over the id's edges
//     in order; an id crossing tiles is summed from the tiles' partial
//     rows in tile order (split over 2-8 lanes past 16 partials). An id's
//     dA'_k goes to the output, its dWh_k and Dv_k to a row of scratch;
//     the block that completes the last id (an integer count of finished
//     ids) forms dWh, dba, dev and dWe from those K rows, each sum over
//     the ids in order.
// Vocab tiles first, then node tiles, a block each; the counters return
// to zero by the end of every launch, so there is no memset.
//
// Padded edges are computed as the forward has them (they end at the
// batch's dummy node; A'[k0] is not zero): they feed dA', dWa and dba
// through gout at the dummy row, exactly as the plain version does.
//
// Bound: chip_smoke.py::_sddmm_bounds (the gate's recompute, the two
// GEMVs with A'[vid] and Wh and the outer products of dA' and dWa per
// real edge against the bytes of h, gout, dh, the edge arrays and the
// tables). The tiles' three rounds of dependent loads, the shuffle chains,
// the combines' L2 round trips and the launch set the time.

#include "sddmm_common.cuh"

namespace {

using namespace mpnn_sddmm;

struct BwdArgs {
  const float* aprime;  // (K, mf, nf)
  const float* evocab;  // (K, ef)
  const float* wa;      // (nf + ef, nf)
  const float* ba;      // (nf)
  const float* h;       // (N, nf)
  const float* gout;    // (N, mf) cotangent of out
  const int* vid;       // (E)
  const int* src;       // (E)
  const int* dst;       // (E)
  const int* norder;    // (2E) ends by node: x < E edge x's destination
                        // end, else edge x − E's source end
  const int* nptr;      // (N + 1) row pointers into norder
  const int* vorder;    // (E) edge ids, stably sorted by vocab id
  const int* vptr;      // (K + 1) id pointers into vorder
  float* da;            // (K, mf, nf)
  float* devocab;       // (K, ef)
  float* dwa;           // (nf + ef, nf)
  float* dba;           // (nf)
  float* dh;            // (N, nf)
  float* nslots;        // (2·ntiles, FP) partials of dh rows crossing tiles
  float* vslots;        // (2·vtiles, R) partials of ids crossing tiles
  float* idrows;        // (K, nf·nf + nf) each id's dWh_k and Dv_k
  float* grows;         // (groups, nf·nf + nf) each id group's sums
  int* counters;        // ntiles + vtiles + groups + 1, zero between
                        // launches
  long long* prof;      // null, or kProfSlots clock64 stamps
  int n, n_edges, mf, nf, ef, k_vocab, nper, vper, ntiles, vtiles, floor;
};

// the last sums go through groups of kIdGroup consecutive ids: a group's
// nonempty id rows summed in id order, then the groups in group order
constexpr int kIdGroup = 8;

__host__ __device__ inline int id_groups(int k_vocab) {
  return (k_vocab + kIdGroup - 1) / kIdGroup;
}

// edges a lane group computes at a time: two where A' sits in shared
// memory (their chains interleave); the wide bucket's A' column takes the
// registers a second edge would
constexpr int kTwo = kTableInSmem ? 2 : 1;

// a vocab id's partial row: dA'_k (mf·nf), dWh_k (nf·nf), Dv_k (nf)
__host__ __device__ inline int id_width(int mf, int nf) {
  return mf * nf + nf * nf + nf;
}

__host__ __device__ inline int bwd_smem_floats(int k_vocab, int te_n,
                                               int te_v) {
  const int sn = stage_floats(te_n, 4), sv = stage_floats(te_v, 5);
  return table_floats(k_vocab) + (sn > sv ? sn : sv) + 8 +
         k_vocab * FP + al4(k_vocab) + kIdGroup;
}

template <int G>
struct Bwd {
  const BwdArgs& a;
  Tables t;
  float* area;     // the tile's staging area
  int* flag;       // 8 ints
  float* dv;       // (K, FP) the last sums' Dv
  int* nz;         // (K) nonempty ids
  int* gnz;        // (kIdGroup) nonempty ids a group
  int n_groups;    // groups with a nonempty id

  __device__ bool nonempty(int k) const {
    return __ldg(a.vptr + k + 1) > __ldg(a.vptr + k);
  }

  // dg (lane j), the gate and dlog of the staged position p (all lanes of
  // the warp call it; lanes past nf give 0). The wide bucket loads its
  // A' column before the gate, all loads in flight together.
  __device__ __forceinline__ void grads(const Stage& s, int p, int j, float& gate,
                        float& dg, float& dl) const {
    const int k = s.vid[p];
    const float* go = s.at(2, p);
    float ar[kTableInSmem ? 1 : FP];
    if constexpr (!kTableInSmem) {
#pragma unroll
      for (int m = 0; m < FP; ++m)
        ar[m] = m < a.mf && j < a.nf
                    ? __ldg(a.aprime + (size_t(k) * a.mf + m) * a.nf + j)
                    : 0.f;
    }
    gate = edge_gate<G>(t, s.at(1, p), k, j, a.nf);
    dg = 0.f;
#pragma unroll
    for (int m = 0; m < G; ++m)
      dg = fmaf(kTableInSmem ? t.ap[(k * FP + m) * FP + j] : ar[m], go[m],
                dg);
    const float dgate = dg * s.at(0, p)[j];
    dl = gate * (dgate - group_sum<G>(gate * dgate));
  }

  // indices of the tile's positions (a thread a position: the order's
  // entry, the edge's src, dst and vid, and key, the row), then hs, hd
  // and gout[dst] rows
  // (the tables are staged while the index loads are in flight)
  template <class Key>
  __device__ __forceinline__ void stage(const Stage& s, const int* order, int ts, int cnt,
                        Key key, long long* st) const {
    const int tid = threadIdx.x;
    int x = 0, sv = 0, dv_ = 0, kv = 0;
    if (tid < cnt) {
      x = __ldg(order + ts + tid);
      const int e = x < a.n_edges ? x : x - a.n_edges;
      sv = __ldg(a.src + e);
      dv_ = __ldg(a.dst + e);
      kv = __ldg(a.vid + e);
    }
    if (!a.floor)
      stage_tables(t, a.aprime, a.wa, a.ba, a.evocab, a.mf, a.nf, a.ef,
                   a.k_vocab, false);
    if (tid < cnt) {
      s.ent[tid] = x;
      s.src[tid] = sv;
      s.dst[tid] = dv_;
      s.vid[tid] = kv;
      s.key[tid] = key(x, sv, dv_, kv);
    }
    __syncthreads();
    if (st) st[1] = clock64();
    if (!a.floor) {
      stage_rows(s, 0, s.src, a.h, a.nf, cnt);
      stage_rows(s, 1, s.dst, a.h, a.nf, cnt);
      stage_rows(s, 2, s.dst, a.gout, a.mf, cnt);
    }
    __syncthreads();
    if (st) st[2] = clock64();
  }

  // ---- the node view: dh ------------------------------------------------
  __device__ RowView node_rows() const {
    return RowView{a.nptr, a.dh, a.nslots, a.counters, a.nf,
                   (kThreads / G) * a.nper};
  }

  __device__ void node_tile(int tile, long long* st) const {
    const int te = (kThreads / G) * a.nper, ts = tile * te;
    const int cnt = min(te, 2 * a.n_edges - ts);
    const Stage s = carve_stage(area, te);
    const int tid = threadIdx.x, j = tid % G, gi = tid / G;
    const int base = (tid % 32) - j;
    if (st) st[0] = clock64();
    const int E = a.n_edges;
    stage(s, a.norder, ts, cnt,
          [E](int x, int sv, int dv_, int) { return x < E ? dv_ : sv; },
          st);
    // an end's term: Wh·dlog on lane i at its destination, dg ⊙ gate at
    // its source
    auto term = [&](int pc) {
      float gate, dg, dl;
      grads(s, pc, j, gate, dg, dl);
      float wd = 0.f;
#pragma unroll
      for (int jj = 0; jj < G; ++jj)
        wd = fmaf(t.whT[jj * FP + j], __shfl_sync(kFull, dl, base + jj), wd);
      return s.ent[pc] < E ? wd : dg * gate;
    };
    for (int i = 0; i < a.nper; i += kTwo) {
      const int pa = gi * a.nper + i,
                pb = kTwo == 2 && i + 1 < a.nper ? pa + 1 : pa;
      float ca = 0.f, cb = 0.f;
      if (!a.floor) {
        ca = term(min(pa, cnt - 1));
        if constexpr (kTwo == 2) cb = term(min(pb, cnt - 1));
      }
      if (pa < cnt) s.at(3, pa)[j] = ca;
      if (pb != pa && pb < cnt) s.at(3, pb)[j] = cb;
    }
    __syncthreads();
    if (st) st[3] = clock64();
    tile_rows<G>(node_rows(), s, 3, tile, cnt, a.nper, flag);
    if (st) st[4] = clock64();
  }

  // ---- the vocab view: dA', dWh_k, Dv_k ---------------------------------
  __device__ void write_id(int k, int o, float x) const {
    const int mn = a.mf * a.nf;
    if (o < mn)
      a.da[size_t(k) * mn + o] = x;
    else
      a.idrows[size_t(k) * (a.nf * a.nf + a.nf) + o - mn] = x;
  }

  // id k's partials summed in tile order (all threads), its counter set
  // back to zero first
  __device__ __forceinline__ void finish_id(int k) const {
    const int te = (kThreads / G) * a.vper, R = id_width(a.mf, a.nf);
    const int vs = __ldg(a.vptr + k), ve = __ldg(a.vptr + k + 1);
    const int t0 = vs / te, t1 = (ve - 1) / te;
    int* vcnt = a.counters + a.ntiles;
    if (threadIdx.x == 0) vcnt[t0] = 0;
    __threadfence();
    sum_partials(
        t1 - t0 + 1, R,
        [&](int u, int o) {
          return __ldcg(a.vslots + (2 * size_t(t0 + u) + (u == 0)) * R + o);
        },
        [&](int o, float x) { write_id(k, o, x); });
  }

  // group g's nonempty id rows summed in id order (all threads)
  __device__ __forceinline__ void group_rows(int g) const {
    const int RW = a.nf * a.nf + a.nf, k0 = g * kIdGroup;
    const int n = min(kIdGroup, a.k_vocab - k0);
    sum_partials(
        n, RW,
        [&](int u, int o) {
          return nz[k0 + u] ? __ldcg(a.idrows + size_t(k0 + u) * RW + o)
                            : 0.f;
        },
        [&](int o, float x) { a.grows[size_t(g) * RW + o] = x; });
  }

  __device__ void vocab_tile(int tile, long long* st) const {
    const int te = (kThreads / G) * a.vper, ts = tile * te;
    const int cnt = min(te, a.n_edges - ts);
    const int R = id_width(a.mf, a.nf), mn = a.mf * a.nf;
    const Stage s = carve_stage(area, te);
    const int tid = threadIdx.x, j = tid % G, gi = tid / G;
    if (st) st[0] = clock64();
    stage(s, a.vorder, ts, cnt, [](int, int, int, int k) { return k; },
          st);
    // an edge's g and dlog
    auto edge = [&](int pc, float& g, float& dl) {
      float gate, dg;
      grads(s, pc, j, gate, dg, dl);
      g = gate * s.at(0, pc)[j];
    };
    for (int i = 0; i < a.vper; i += kTwo) {
      const int pa = gi * a.vper + i,
                pb = kTwo == 2 && i + 1 < a.vper ? pa + 1 : pa;
      float ga = 0.f, la = 0.f, gb = 0.f, lb = 0.f;
      if (!a.floor) {
        edge(min(pa, cnt - 1), ga, la);
        if constexpr (kTwo == 2) edge(min(pb, cnt - 1), gb, lb);
      }
      if (pa < cnt) {
        s.at(3, pa)[j] = ga;
        s.at(4, pa)[j] = la;
      }
      if (pb != pa && pb < cnt) {
        s.at(3, pb)[j] = gb;
        s.at(4, pb)[j] = lb;
      }
    }
    __syncthreads();
    if (st) st[3] = clock64();
    // the tile's ids: dot products over each id's positions, in order
    const int k0 = s.key[0], k1 = s.key[cnt - 1];
    for (int k = k0; k <= k1; ++k) {
      const int vs = __ldg(a.vptr + k), ve = __ldg(a.vptr + k + 1);
      const int q0 = max(vs, ts) - ts, q1 = min(ve, ts + cnt) - ts;
      if (q1 <= q0) continue;
      const bool whole = vs >= ts && ve <= ts + cnt;
      for (int o = tid; o < R; o += kThreads) {
        float x = 0.f;
        if (!a.floor) {
          if (o < mn) {
            const float* u = s.at(2, 0) + o / a.nf;
            const float* w = s.at(3, 0) + o % a.nf;
            for (int q = q0; q < q1; ++q) x = fmaf(u[q * FP], w[q * FP], x);
          } else if (o < mn + a.nf * a.nf) {
            const int r = o - mn;
            const float* u = s.at(1, 0) + r / a.nf;
            const float* w = s.at(4, 0) + r % a.nf;
            for (int q = q0; q < q1; ++q) x = fmaf(u[q * FP], w[q * FP], x);
          } else {
            const float* w = s.at(4, 0) + o - mn - a.nf * a.nf;
            for (int q = q0; q < q1; ++q) x += w[q * FP];
          }
        }
        if (whole)
          write_id(k, o, x);
        else
          a.vslots[(2 * size_t(tile) + (vs < ts ? 0 : 1)) * R + o] = x;
      }
    }
    if (st) st[4] = clock64();
    // the ids crossing the tile, counted; the ids this tile completes,
    // counted by group; the groups it completes, summed; the block that
    // completes the last group forms the last sums
    __threadfence();
    __syncthreads();
    int* vcnt = a.counters + a.ntiles;
    if (tid == 0) {
      flag[0] = flag[1] = -1;
      const int vs0 = __ldg(a.vptr + k0), ve0 = __ldg(a.vptr + k0 + 1);
      if (vs0 < ts) {                  // the first id began earlier
        const int t0 = vs0 / te, t1 = (ve0 - 1) / te;
        if (atomicAdd(vcnt + t0, 1) == t1 - t0) flag[0] = k0;
      }
      const int vs1 = __ldg(a.vptr + k1), ve1 = __ldg(a.vptr + k1 + 1);
      if (vs1 >= ts && ve1 > ts + cnt) {  // the last id goes on
        const int t1 = (ve1 - 1) / te;
        if (atomicAdd(vcnt + tile, 1) == t1 - tile) flag[1] = k1;
      }
    }
    __syncthreads();
    for (int w = 0; w < 2; ++w)
      if (flag[w] >= 0) finish_id(flag[w]);
    if (st) st[5] = clock64();
    __threadfence();
    __syncthreads();
    int* gcnt = vcnt + a.vtiles;
    const int groups = id_groups(a.k_vocab);
    if (tid == 0) {
      int add[kMaxVocab / kIdGroup] = {};
      for (int k = k0; k <= k1; ++k) {
        const int vs = __ldg(a.vptr + k), ve = __ldg(a.vptr + k + 1);
        add[k / kIdGroup] += ve > vs && vs >= ts && ve <= ts + cnt;
      }
      for (int w = 0; w < 2; ++w)
        if (flag[w] >= 0) ++add[flag[w] / kIdGroup];
      int fin = 0;
      for (int g = 0; g < groups; ++g)
        if (add[g] > 0 && atomicAdd(gcnt + g, add[g]) + add[g] == gnz[g]) {
          fin |= 1 << g;
          gcnt[g] = 0;                 // every id of the group counted
        }
      flag[2] = fin;
    }
    __syncthreads();
    const int fin = flag[2];
    if (fin == 0) return;
    for (int g = 0; g < groups; ++g)
      if (fin >> g & 1) group_rows(g);
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      int* top = gcnt + groups;
      const int nf_ = __popc(unsigned(fin));
      flag[3] = atomicAdd(top, nf_) + nf_ == n_groups;
      if (flag[3]) *top = 0;
    }
    __syncthreads();
    if (flag[3]) final_sums();
  }

  // ---- the last sums: dWh, dba from the group rows; dev, dWe from the K
  // Dv_k rows ---------------------------------------------------------------
  __device__ void final_sums() const {
    const int K = a.k_vocab, nf = a.nf, ef = a.ef, RW = nf * nf + nf;
    const int tid = threadIdx.x;
    if (a.prof != nullptr && tid == 0) a.prof[16] = clock64();
    __threadfence();
#pragma unroll 8
    for (int q = tid; q < K * FP; q += kThreads) {
      const int k = q / FP, jj = q % FP;
      dv[q] = jj < nf && nz[k]
                  ? __ldcg(a.idrows + size_t(k) * RW + nf * nf + jj)
                  : 0.f;
    }
    sum_partials(
        id_groups(K), RW,
        [&](int u, int o) {
          return gnz[u] ? __ldcg(a.grows + size_t(u) * RW + o) : 0.f;
        },
        [&](int o, float x) {
          if (o < nf * nf)
            a.dwa[o] = x;
          else
            a.dba[o - nf * nf] = x;
        });
    __syncthreads();
    // dWe[x][j] = Σ_k ev[k][x]·Dv_k[j], the ids in order
    for (int q = tid; q < ef * nf; q += kThreads) {
      const int x = q / nf, jj = q % nf;
      float s = 0.f;
#pragma unroll 8
      for (int k = 0; k < K; ++k)
        s = fmaf(__ldg(a.evocab + k * ef + x), dv[k * FP + jj], s);
      a.dwa[nf * nf + q] = s;
    }
    // dev[k][x] = Σ_j We[x][j]·Dv_k[j]
    for (int q = tid; q < K * ef; q += kThreads) {
      const int k = q / ef, x = q % ef;
      float s = 0.f;
#pragma unroll 8
      for (int jj = 0; jj < nf; ++jj)
        s = fmaf(__ldg(a.wa + (nf + x) * nf + jj), dv[k * FP + jj], s);
      a.devocab[q] = s;
    }
    const int mn = a.mf * nf;
    for (int k = 0; k < K; ++k)        // dA' of the ids with no edge
      if (!nz[k])
        for (int q = tid; q < mn; q += kThreads) a.da[k * mn + q] = 0.f;
    if (a.prof != nullptr && tid == 0) a.prof[17] = clock64();
  }
};

// A block a tile: vocab tiles first, then node tiles. `floor`: the same
// grid, staging of the indices and combines, no tables, rows or
// arithmetic.
template <int G>
__global__ void __launch_bounds__(kThreads) sddmm_bwd_kernel(BwdArgs a) {
  extern __shared__ float sm[];
  const int te_n = (kThreads / G) * a.nper, te_v = (kThreads / G) * a.vper;
  Bwd<G> b{a};
  b.t = carve_tables(sm, a.k_vocab);
  b.area = sm + table_floats(a.k_vocab);
  const int sn = stage_floats(te_n, 4), sv = stage_floats(te_v, 5);
  b.flag = reinterpret_cast<int*>(b.area + (sn > sv ? sn : sv));
  b.dv = reinterpret_cast<float*>(b.flag + 8);
  b.nz = reinterpret_cast<int*>(b.dv + a.k_vocab * FP);
  b.gnz = b.nz + al4(a.k_vocab);
  const int tid = threadIdx.x, groups = id_groups(a.k_vocab);
  const bool prof = a.prof != nullptr && tid == 0;
  if (prof && blockIdx.x == 0) a.prof[20] = clock64();
  for (int k = tid; k < a.k_vocab; k += kThreads) b.nz[k] = b.nonempty(k);
  __syncthreads();
  if (tid < groups) {
    int c = 0;
    for (int k = tid * kIdGroup; k < min(a.k_vocab, (tid + 1) * kIdGroup);
         ++k)
      c += b.nz[k];
    b.gnz[tid] = c;
  }
  b.n_groups = __syncthreads_count(tid < groups && b.gnz[tid] > 0);
  if (prof && blockIdx.x == 0) a.prof[21] = clock64();
  const int w = blockIdx.x;
  if (w < a.vtiles)
    b.vocab_tile(w, prof && w == 0 ? a.prof : nullptr);
  else
    b.node_tile(w - a.vtiles, prof && w == a.vtiles ? a.prof + 8 : nullptr);
  zero_empty_rows(a.nptr, a.dh, a.n, a.nf);
}

using BwdKernel = void (*)(BwdArgs);

// The kernel of a group width; null for a width the bucket does not
// build.
BwdKernel bwd_kernel(int g) {
  if constexpr (FP == 32) {
    if (g == 32) return sddmm_bwd_kernel<32>;
  } else {
    if (g == 8) return sddmm_bwd_kernel<8>;
    if (g == 16) return sddmm_bwd_kernel<16>;
  }
  return nullptr;
}

int tiles_of(int n_pos, int g, int per) {
  const int te = (kThreads / g) * per;
  return (n_pos + te - 1) / te;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes.
int mpnn_sddmm_bwd_smem_bytes(int k_vocab, int group, int nper, int vper) {
  return int(sizeof(float) * bwd_smem_floats(k_vocab, (kThreads / group) *
                                                          nper,
                                             (kThreads / group) * vper));
}

// Floats of scratch a launch needs: the node tiles' partial dh rows (2·FP
// a tile), the vocab tiles' partial id rows (2·R a tile), the ids' and
// the id groups' dWh and Dv rows.
long long mpnn_sddmm_bwd_scratch_floats(int n_edges, int mf, int nf,
                                        int k_vocab, int group, int nper,
                                        int vper) {
  return 2LL * tiles_of(2 * n_edges, group, nper) * FP +
         2LL * tiles_of(n_edges, group, vper) * id_width(mf, nf) +
         (long long)(k_vocab + id_groups(k_vocab)) * (nf * nf + nf);
}

// Ints of counters a launch needs: a node tile's, a vocab tile's, an id
// group's and one for the groups.
int mpnn_sddmm_bwd_counters(int n_edges, int k_vocab, int group, int nper,
                            int vper) {
  return tiles_of(2 * n_edges, group, nper) +
         tiles_of(n_edges, group, vper) + id_groups(k_vocab) + 1;
}

// Launches on `stream` and returns the launch's error code (0 = success).
// Does not synchronize and allocates nothing. (group, nper, vper) from
// kernels/sddmm.py::launch_shape: lanes an edge, positions a group in a
// node and a vocab tile; a block a tile. counters:
// mpnn_sddmm_bwd_counters ints, zero (every launch leaves them zero).
// prof: null or kProfSlots int64.
int mpnn_sddmm_bwd(const float* aprime, const float* evocab, const float* wa,
                   const float* ba, const float* h, const float* gout,
                   const int* vid, const int* src, const int* dst,
                   const int* norder, const int* nptr, const int* vorder,
                   const int* vptr, float* da, float* devocab, float* dwa,
                   float* dba, float* dh, float* scratch, int* counters,
                   long long* prof, int n, int n_edges, int mf, int nf,
                   int ef, int k_vocab, int group, int nper, int vper,
                   int floor, void* stream) {
  if (mf < 1 || mf > FP || nf < 1 || nf > FP || ef < 0 ||
      ef > kMaxEdgeFeatures || k_vocab < 1 || k_vocab > kMaxVocab || n < 1 ||
      n_edges < 1 || group != group_of(mf, nf) || nper < 1 ||
      nper > kMaxPer || vper < 1 || vper > kMaxPer || counters == nullptr)
    return int(cudaErrorInvalidValue);
  const int ntiles = tiles_of(2 * n_edges, group, nper);
  const int vtiles = tiles_of(n_edges, group, vper);
  float* nslots = scratch;
  float* vslots = nslots + 2 * size_t(ntiles) * FP;
  float* idrows = vslots + 2 * size_t(vtiles) * id_width(mf, nf);
  float* grows = idrows + size_t(k_vocab) * (nf * nf + nf);
  BwdArgs args{aprime, evocab, wa, ba, h, gout, vid, src, dst, norder, nptr,
               vorder, vptr, da, devocab, dwa, dba, dh, nslots, vslots,
               idrows, grows, counters, prof, n, n_edges, mf, nf, ef,
               k_vocab, nper, vper, ntiles, vtiles, floor};
  const BwdKernel kernel = bwd_kernel(group);
  if (kernel == nullptr) return int(cudaErrorInvalidValue);
  const int te_n = (kThreads / group) * nper, te_v = (kThreads / group) * vper;
  return int(launch(kernel, ntiles + vtiles,
                    sizeof(float) * bwd_smem_floats(k_vocab, te_n, te_v),
                    static_cast<cudaStream_t>(stream), args));
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
