// Attention SDDMM backward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels mpnn_tpu/kernels/sddmm.py::_sddmm_bwd_kernel
// and _sddmm_t_bwd_kernel (the VJP of make_sddmm_op in its row and
// transposed layouts, one function): for the cotangent gout (N, mf) of
// out, with gate_e, g_e recomputed per edge as the forward has them,
//
//   dg_e   = A'[vid_e]ᵀ · gout[dst_e],   dgate_e = dg_e ⊙ h[src_e]
//   dlog_e = gate_e ⊙ (dgate_e − Σ gate_e ⊙ dgate_e)
//   dh[s]  = Σ_{e: src_e = s} dg_e ⊙ gate_e  +  Wh · Σ_{e: dst_e = s} dlog_e
//   dA'[k] = Σ_{e: vid_e = k} gout[dst_e] ⊗ g_e                 (K, mf, nf)
//   dWh    = Σ_d h[d] ⊗ D_d,   dba = Σ_d D_d,   D_d = Σ_{e: dst_e = d} dlog_e
//   dev[k] = We · Dv_k,   dWe = Σ_k ev[k] ⊗ Dv_k,
//   Dv_k   = Σ_{e: vid_e = k} dlog_e
//
// (Wa = [Wh; We], dWa = [dWh; dWe].) The TPU kernels recompute the gate in
// node windows and accumulate every gradient across their sequential grid
// in VMEM; here the grid runs in parallel and every sum has a fixed order.
//
// Design: ONE cooperative launch, two grid barriers.
//   Phase 1 (one warp per destination row, lane j = feature j, as the
//     forward): per edge in the stable destination order, recompute gate
//     and g, form dg, dlog (the softmax's closed-form VJP, its Σ a warp
//     sum) and dg ⊙ gate, write g, dlog and dg ⊙ gate to edge-ordered
//     scratch, and sum D_d in edge order. The row writes dh[d] = Wh·D_d and
//     adds h[d] ⊗ D_d and D_d to its warp's registers; the block sums its
//     warps in order into its row of partials.
//   Grid barrier.
//   Phase 2: (a) dh[s] += Σ dg ⊙ gate over s's outgoing edges in the
//     device-built stable source order (one warp per node); (b) dA' and
//     Dv from stable vocab-sorted chunks of kChunkEdges edges, as
//     spmm_da.cu takes dA: work item (k, c) at index k + c stages its
//     edges' gout[dst], g and dlog in shared memory and sums them in order
//     into its row of partials; (c) dWh and dba: the blocks' partials
//     summed in block order.
//   Grid barrier.
//   Phase 3: dA' = each id's items summed in chunk order; dev and dWe from
//     Dv, each Dv_k summed from its items in chunk order where it is read.
// Every scratch buffer is written in one phase and read only in later
// ones: none is reused across a barrier. No float atomics.
//
// Padded edges are computed as the forward has them (they end at the
// batch's dummy node; A'[k0] is not zero): they feed dA', dWa and dba
// through gout at the dummy row, exactly as the plain version does.
//
// Bound on an H100 SXM: per real edge the gate's recompute, the two
// GEMVs with A'[vid] and Wh and the outer products of dA' and dWa (~20
// MFLOP at adv's b1024, f 7, ef 6), and the bytes of h, gout, dh, the
// edge arrays and the tables (~2 MB): ~0.6 us by bytes. Latency of the
// row walks (in series on the dummy row), the shuffle chains and the two
// grid barriers sets the time.

#include "sddmm_common.cuh"

namespace {

using namespace mpnn_sddmm;

// dA': vocab-sorted edges in chunks of kChunkEdges, one block per item
constexpr int kChunkEdges = 128;
// a row of partials: FP·FP of an outer-product sum, then FP of a vector's
constexpr int kPart = FP * FP + FP;

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
  const int* order;     // (E) edge ids, stably sorted by destination
  const int* ptr;       // (N + 1) row pointers into order
  const int* sorder;    // (E) edge ids, stably sorted by source
  const int* sptr;      // (N + 1) row pointers into sorder
  const int* vorder;    // (E) edge ids, stably sorted by vocab id
  const int* vptr;      // (K + 1) id pointers into vorder
  float* da;            // (K, mf, nf)
  float* devocab;       // (K, ef)
  float* dwa;           // (nf + ef, nf)
  float* dba;           // (nf)
  float* dh;            // (N, nf)
  float* edge_g;        // (E, nf) scratch: g_e
  float* edge_dl;       // (E, nf) scratch: dlog_e
  float* edge_dhs;      // (E, nf) scratch: dg_e ⊙ gate_e
  float* part_w;        // (grid, kPart) the blocks' dWh and dba partials
  float* part_v;        // (K + chunks, kPart) the items' dA' and Dv
  int n, n_edges, mf, nf, ef, k_vocab;
};

__device__ __forceinline__ int n_chunks(int n_edges) {
  return (n_edges + kChunkEdges - 1) / kChunkEdges;
}

// The vocab id of item b: the largest k with k + vptr[k]/kChunkEdges <= b
// (that start is strictly increasing in k).
__device__ int item_id(const int* vptr, int k_vocab, int b) {
  int lo = 0, hi = k_vocab - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (mid + vptr[mid] / kChunkEdges <= b) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// Dv_k[j]: id k's items summed in chunk order (0 for an id with no edge).
__device__ float vocab_dlog(const BwdArgs& a, int k, int j) {
  const int e0 = a.vptr[k], e1 = a.vptr[k + 1];
  float s = 0.f;
  if (e1 > e0)
    for (int c = e0 / kChunkEdges; c <= (e1 - 1) / kChunkEdges; ++c)
      s += __ldcg(a.part_v + size_t(k + c) * kPart + FP * FP + j);
  return s;
}

__global__ void __launch_bounds__(kThreads) sddmm_bwd_kernel(BwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float sm[];
  const Tables t = stage_tables(sm, a.wa, a.ba, a.evocab, a.nf, a.ef,
                                a.k_vocab);
  // narrow: A' as it is, ab[(k·FP + m)·FP + j] = A'[k][m][j], zero-padded
  float* ab = t.next;
  float* work = ab + (kTableInSmem ? a.k_vocab * FP * FP : 0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (kTableInSmem)
    for (int i = tid; i < a.k_vocab * FP * FP; i += kThreads) {
      const int k = i / (FP * FP), r = i % (FP * FP), m = r / FP,
                j = r % FP;
      ab[i] = (m < a.mf && j < a.nf)
                  ? a.aprime[(size_t(k) * a.mf + m) * a.nf + j]
                  : 0.f;
    }
  __syncthreads();

  // ---- phase 1: per destination row --------------------------------------
  float pw[FP];                  // this lane's column of Σ h[d] ⊗ D_d
#pragma unroll
  for (int i = 0; i < FP; ++i) pw[i] = 0.f;
  float pb = 0.f;                // Σ D_d on this lane
  for (int row = blockIdx.x * kWarps + warp; row < a.n;
       row += gridDim.x * kWarps) {
    const int p0 = a.ptr[row], p1 = a.ptr[row + 1];
    if (p1 == p0) {
      if (lane < a.nf) a.dh[size_t(row) * a.nf + lane] = 0.f;
      continue;
    }
    const float hd =
        lane < a.nf ? __ldg(a.h + size_t(row) * a.nf + lane) : 0.f;
    const float go =
        lane < a.mf ? __ldg(a.gout + size_t(row) * a.mf + lane) : 0.f;
    const float u = row_logits(t, hd, lane, a.nf);
    float dsum = 0.f;
    for (int p = p0; p < p1; ++p) {
      const int e = __ldg(a.order + p);
      const int k = __ldg(a.vid + e);
      const float hs =
          lane < a.nf ? __ldg(a.h + size_t(__ldg(a.src + e)) * a.nf + lane)
                      : 0.f;
      const float gate = edge_gate(t, u, k, lane, a.nf);
      // dg[j] = Σ_m A'[k][m][j]·gout[d][m] on lane j
      float dg = 0.f;
      for (int m = 0; m < a.mf; ++m) {
        const float gm = __shfl_sync(kFull, go, m);
        if (kTableInSmem) {
          if (lane < FP)
            dg = fmaf(ab[(size_t(k) * FP + m) * FP + lane], gm, dg);
        } else if (lane < a.nf) {
          dg = fmaf(__ldg(a.aprime + (size_t(k) * a.mf + m) * a.nf + lane),
                    gm, dg);
        }
      }
      const float dgate = dg * hs;
      const float dl = gate * (dgate - warp_sum(gate * dgate));
      dsum += dl;
      if (lane < a.nf) {
        const size_t o = size_t(e) * a.nf + lane;
        a.edge_g[o] = gate * hs;
        a.edge_dl[o] = dl;
        a.edge_dhs[o] = dg * gate;
      }
    }
    // dh[d][i] = Σ_j Wh[i][j]·D_d[j] on lane i (the source half is added
    // in phase 2)
    float dhd = 0.f;
    for (int j = 0; j < a.nf; ++j) {
      const float dj = __shfl_sync(kFull, dsum, j);
      if (lane < a.nf) dhd = fmaf(t.whT[j * FP + lane], dj, dhd);
    }
    if (lane < a.nf) a.dh[size_t(row) * a.nf + lane] = dhd;
#pragma unroll
    for (int i = 0; i < FP; ++i)
      pw[i] = fmaf(__shfl_sync(kFull, hd, i), dsum, pw[i]);
    pb += dsum;
  }
  // the block's partials: its warps' sums in warp order
  float* red = work;             // kWarps · kPart
  if (lane < FP) {
#pragma unroll
    for (int i = 0; i < FP; ++i) red[warp * kPart + i * FP + lane] = pw[i];
    red[warp * kPart + FP * FP + lane] = pb;
  }
  __syncthreads();
  for (int q = tid; q < kPart; q += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * kPart + q];
    a.part_w[size_t(blockIdx.x) * kPart + q] = s;
  }
  grid.sync();

  // ---- phase 2a: dh[s] += Σ over s's outgoing edges, in source order ----
  for (int s = blockIdx.x * kWarps + warp; s < a.n;
       s += gridDim.x * kWarps) {
    if (lane >= a.nf) continue;
    float acc = 0.f;
    const int p1 = a.sptr[s + 1];
    for (int p = a.sptr[s]; p < p1; ++p)
      acc += __ldcg(a.edge_dhs + size_t(a.sorder[p]) * a.nf + lane);
    const size_t o = size_t(s) * a.nf + lane;
    a.dh[o] = __ldcg(a.dh + o) + acc;
  }

  // ---- phase 2b: one row of partials per vocab work item ----------------
  float* gs = work;                            // kChunkEdges · FP: gout[dst]
  float* vs = gs + kChunkEdges * FP;           // kChunkEdges · FP: g
  float* ls = vs + kChunkEdges * FP;           // kChunkEdges · FP: dlog
  const int items = a.k_vocab + n_chunks(a.n_edges);
  for (int b = blockIdx.x; b < items; b += gridDim.x) {
    const int k = item_id(a.vptr, a.k_vocab, b);
    const int c = b - k;
    const int lo = max(a.vptr[k], c * kChunkEdges);
    const int hi = min(a.vptr[k + 1], (c + 1) * kChunkEdges);
    if (lo >= hi) continue;                    // no item at b
    const int cnt = hi - lo;
    __syncthreads();                           // staging free
    for (int i = tid; i < kChunkEdges * FP; i += kThreads) {
      const int r = i / FP, j = i % FP;
      float gv = 0.f, vv = 0.f, lv = 0.f;
      if (r < cnt) {
        const int e = a.vorder[lo + r];
        if (j < a.mf) gv = __ldg(a.gout + size_t(a.dst[e]) * a.mf + j);
        if (j < a.nf) {
          vv = __ldcg(a.edge_g + size_t(e) * a.nf + j);
          lv = __ldcg(a.edge_dl + size_t(e) * a.nf + j);
        }
      }
      gs[i] = gv;
      vs[i] = vv;
      ls[i] = lv;
    }
    __syncthreads();
    for (int q = tid; q < kPart; q += kThreads) {
      float s = 0.f;
      if (q < FP * FP) {
        const int m = q / FP, j = q % FP;
        for (int r = 0; r < cnt; ++r)
          s = fmaf(gs[r * FP + m], vs[r * FP + j], s);
      } else {
        for (int r = 0; r < cnt; ++r) s += ls[r * FP + q - FP * FP];
      }
      a.part_v[size_t(b) * kPart + q] = s;
    }
  }

  // ---- phase 2c: dWh and dba, the blocks' partials in block order -------
  const int nwh = a.nf * a.nf + a.nf;
  for (int i = blockIdx.x * kThreads + tid; i < nwh;
       i += gridDim.x * kThreads) {
    const int q = i < a.nf * a.nf ? (i / a.nf) * FP + i % a.nf
                                  : FP * FP + i - a.nf * a.nf;
    float s = 0.f;
    for (int blk = 0; blk < int(gridDim.x); ++blk)
      s += __ldcg(a.part_w + size_t(blk) * kPart + q);
    if (i < a.nf * a.nf) a.dwa[i] = s;
    else a.dba[i - a.nf * a.nf] = s;
  }
  grid.sync();

  // ---- phase 3: dA', dev and dWe -----------------------------------------
  const int nda = a.k_vocab * a.mf * a.nf;
  const int ndev = a.k_vocab * a.ef;
  const int total = nda + ndev + a.ef * a.nf;
  for (int i = blockIdx.x * kThreads + tid; i < total;
       i += gridDim.x * kThreads) {
    if (i < nda) {
      const int k = i / (a.mf * a.nf), r = i % (a.mf * a.nf);
      const int q = (r / a.nf) * FP + r % a.nf;
      const int e0 = a.vptr[k], e1 = a.vptr[k + 1];
      float s = 0.f;
      if (e1 > e0)
        for (int c = e0 / kChunkEdges; c <= (e1 - 1) / kChunkEdges; ++c)
          s += __ldcg(a.part_v + size_t(k + c) * kPart + q);
      a.da[i] = s;
    } else if (i < nda + ndev) {
      // dev[k][x] = Σ_j We[x][j]·Dv_k[j]
      const int k = (i - nda) / a.ef, x = (i - nda) % a.ef;
      float s = 0.f;
      for (int j = 0; j < a.nf; ++j)
        s = fmaf(a.wa[(a.nf + x) * a.nf + j], vocab_dlog(a, k, j), s);
      a.devocab[i - nda] = s;
    } else {
      // dWe[x][j] = Σ_k ev[k][x]·Dv_k[j]
      const int r = i - nda - ndev, x = r / a.nf, j = r % a.nf;
      float s = 0.f;
      for (int k = 0; k < a.k_vocab; ++k)
        s = fmaf(a.evocab[k * a.ef + x], vocab_dlog(a, k, j), s);
      a.dwa[(a.nf + x) * a.nf + j] = s;
    }
  }
}

size_t smem_bytes(int k_vocab) {
  const size_t work = kWarps * kPart > 3 * kChunkEdges * FP
                          ? size_t(kWarps) * kPart
                          : size_t(3) * kChunkEdges * FP;
  return sizeof(float) *
         (table_floats(k_vocab) +
          (kTableInSmem ? size_t(k_vocab) * FP * FP : 0) + work);
}

long long items_of(int n_edges, int k_vocab) {
  return k_vocab + (n_edges + kChunkEdges - 1) / kChunkEdges;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes.
int mpnn_sddmm_bwd_smem_bytes(int k_vocab) {
  return int(smem_bytes(k_vocab));
}

// Floats of scratch a launch needs: the edges' three rows (3·E·nf), then
// the blocks' partials (grid rows), then the vocab items' (K + chunks
// rows), each row kPart floats.
long long mpnn_sddmm_bwd_scratch_floats(int n_edges, int nf, int k_vocab,
                                        int grid) {
  return 3LL * n_edges * nf + (grid + items_of(n_edges, k_vocab)) * kPart;
}

// Blocks of the cooperative grid: all co-resident blocks at this vocab
// size, capped at the work (a warp per node row, a block per vocab item).
// The kernel's shared-memory limit stays at the largest vocab's. 0 on
// error.
int mpnn_sddmm_bwd_grid(int n, int n_edges, int k_vocab) {
  if (k_vocab < 1 || k_vocab > kMaxVocab) return 0;
  const int most = resident_blocks(sddmm_bwd_kernel, smem_bytes(k_vocab),
                                   smem_bytes(kMaxVocab));
  const int rows = (n + kWarps - 1) / kWarps;
  const int items = int(items_of(n_edges, k_vocab));
  const int need = rows > items ? rows : items;
  return most < 1 ? 0 : (most < need ? most : need);
}

// Launches on `stream` and returns the launch's error code (0 = success).
// Does not synchronize and allocates nothing.
int mpnn_sddmm_bwd(const float* aprime, const float* evocab, const float* wa,
                   const float* ba, const float* h, const float* gout,
                   const int* vid, const int* src, const int* dst,
                   const int* order, const int* ptr, const int* sorder,
                   const int* sptr, const int* vorder, const int* vptr,
                   float* da, float* devocab, float* dwa, float* dba,
                   float* dh, float* scratch, int n, int n_edges, int mf,
                   int nf, int ef, int k_vocab, int grid, void* stream) {
  if (mf < 1 || mf > FP || nf < 1 || nf > FP || ef < 0 ||
      ef > kMaxEdgeFeatures || k_vocab < 1 || k_vocab > kMaxVocab || n < 1 ||
      n_edges < 1 || grid < 1)
    return int(cudaErrorInvalidValue);
  float* edge_g = scratch;
  float* edge_dl = edge_g + size_t(n_edges) * nf;
  float* edge_dhs = edge_dl + size_t(n_edges) * nf;
  float* part_w = edge_dhs + size_t(n_edges) * nf;
  float* part_v = part_w + size_t(grid) * kPart;
  BwdArgs a{aprime, evocab, wa, ba, h, gout, vid, src, dst, order, ptr,
            sorder, sptr, vorder, vptr, da, devocab, dwa, dba, dh,
            edge_g, edge_dl, edge_dhs, part_w, part_v,
            n, n_edges, mf, nf, ef, k_vocab};
  void* args[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (void*)sddmm_bwd_kernel, dim3(grid), dim3(kThreads), args,
      smem_bytes(k_vocab), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
