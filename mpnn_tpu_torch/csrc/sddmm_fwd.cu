// Attention SDDMM forward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels mpnn_tpu/kernels/sddmm.py::_sddmm_kernel and
// _sddmm_t_kernel (the forward of make_sddmm_op in its row and transposed
// layouts, one function):
//
//   out[d] = Σ_{e: dst_e = d} A'[vid_e] · (gate_e ⊙ h[src_e]),
//   gate_e = softmax_feat([h[d] ‖ ev[vid_e]] · Wa + ba)
//
// The TPU kernels gather and scatter with one-hot matmuls over node
// windows planned on the host, the features on a padded lane or sublane
// panel. Here the edges, in the loader's stable destination order (plan
// edge_order, dst_ptr), are cut into tiles (sddmm_common.cuh): a tile
// stages its edges' indices and h rows in shared memory, a group of G
// lanes computes an edge's message (the softmax over the group's lanes,
// the gated row through A'[vid]: the narrow bucket reads A' transposed
// from shared memory, the wide one from device memory), and the tile's
// rows are summed in edge order; a row that crosses tiles, as the batch's
// dummy row does with every padded edge, is summed from the tiles'
// partials in tile order. No row is walked by one warp; no atomics on
// floats; deterministic.
//
// Bound: chip_smoke.py::_sddmm_bounds (the logits', softmax's and GEMV's
// operations per real edge against the bytes of h, out, A' and the edge
// arrays). The edge gathers are irregular: three rounds of dependent loads
// a tile, the shuffle chains and the launch set the time.

#include "sddmm_common.cuh"

namespace {

using namespace mpnn_sddmm;

struct FwdArgs {
  const float* aprime;  // (K, mf, nf)
  const float* evocab;  // (K, ef)
  const float* wa;      // (nf + ef, nf)
  const float* ba;      // (nf)
  const float* h;       // (N, nf)
  const int* vid;       // (E) vocab id of each edge
  const int* src;       // (E)
  const int* dst;       // (E)
  const int* order;     // (E) edge ids, stably sorted by destination
  const int* ptr;       // (N + 1) row pointers into order
  float* out;           // (N, mf)
  float* slots;         // (2·tiles, FP) partials of rows crossing tiles
  int* counters;        // (tiles) zero between launches
  long long* prof;      // null, or kProfSlots clock64 stamps of block 0
  int n, n_edges, mf, nf, ef, k_vocab, per, tiles, floor;
};

__host__ __device__ inline int fwd_smem_floats(int k_vocab, int te) {
  return table_floats(k_vocab) + stage_floats(te, 3) + 4;
}

// A block a tile. `floor`: the same grid, staging of the indices and
// combines, no tables, rows or arithmetic.
template <int G>
__global__ void __launch_bounds__(kThreads) sddmm_fwd_kernel(FwdArgs a) {
  extern __shared__ float sm[];
  const int te = (kThreads / G) * a.per;       // at most kThreads
  const Tables t = carve_tables(sm, a.k_vocab);
  const Stage s = carve_stage(sm + table_floats(a.k_vocab), te);
  int* flag = reinterpret_cast<int*>(sm + table_floats(a.k_vocab) +
                                     stage_floats(te, 3));
  const int tid = threadIdx.x, j = tid % G, gi = tid / G;
  const int base = (tid % 32) - j;       // the group's first lane
  const bool st = a.prof != nullptr && blockIdx.x == 0 && tid == 0;
  auto stamp = [&](int i) {
    if (st) a.prof[i] = clock64();
  };
  stamp(0);
  const RowView v{a.ptr, a.out, a.slots, a.counters, a.mf, te};
  const int tile = blockIdx.x, ts = tile * te,
            cnt = min(te, a.n_edges - ts);
  // a thread a position: its edge, then the edge's indices; the block's
  // tables are staged while the first loads are in flight
  const int e = tid < cnt ? __ldg(a.order + ts + tid) : 0;
  if (!a.floor)
    stage_tables(t, a.aprime, a.wa, a.ba, a.evocab, a.mf, a.nf, a.ef,
                 a.k_vocab, true);
  if (tid < cnt) {
    s.key[tid] = __ldg(a.dst + e);
    s.src[tid] = __ldg(a.src + e);
    s.vid[tid] = __ldg(a.vid + e);
  }
  __syncthreads();
  stamp(1);
  if (!a.floor) {
    stage_rows(s, 0, s.src, a.h, a.nf, cnt);
    stage_rows(s, 1, s.key, a.h, a.nf, cnt);
  }
  __syncthreads();
  stamp(2);
  // each group its positions: the message A'[k]·(gate ⊙ h[src]) on lane
  // m; a position past the tile computes on the tile's last, writes
  // nothing. The wide bucket loads its A' row before the gate, all loads
  // in flight together.
  auto message = [&](int pc) {
    const int k = s.vid[pc];
    float ar[kTableInSmem ? 1 : FP];
    if constexpr (!kTableInSmem) {
#pragma unroll
      for (int jj = 0; jj < FP; ++jj)
        ar[jj] = j < a.mf && jj < a.nf
                     ? __ldg(a.aprime + (size_t(k) * a.mf + j) * a.nf + jj)
                     : 0.f;
    }
    const float g =
        edge_gate<G>(t, s.at(1, pc), k, j, a.nf) * s.at(0, pc)[j];
    float msg = 0.f;
#pragma unroll
    for (int jj = 0; jj < G; ++jj) {
      const float gj = __shfl_sync(kFull, g, base + jj);
      msg = fmaf(kTableInSmem ? t.ap[(k * FP + jj) * FP + j] : ar[jj], gj,
                 msg);
    }
    return msg;
  };
  // (two at a time where A' sits in shared memory; the wide bucket's A'
  // rows take the registers a second edge would)
  constexpr int kTwo = kTableInSmem ? 2 : 1;
  for (int i = 0; i < a.per; i += kTwo) {
    const int pa = gi * a.per + i,
              pb = kTwo == 2 && i + 1 < a.per ? pa + 1 : pa;
    float ma = 0.f, mb = 0.f;
    if (!a.floor) {
      ma = message(min(pa, cnt - 1));
      if constexpr (kTwo == 2) mb = message(min(pb, cnt - 1));
    }
    if (pa < cnt) s.at(2, pa)[j] = ma;
    if (pb != pa && pb < cnt) s.at(2, pb)[j] = mb;
  }
  __syncthreads();
  stamp(3);
  tile_rows<G>(v, s, 2, tile, cnt, a.per, flag);
  stamp(4);
  zero_empty_rows(a.ptr, a.out, a.n, a.mf);
  stamp(5);
}

using FwdKernel = void (*)(FwdArgs);

// The kernel of a group width; null for a width the bucket does not
// build.
FwdKernel fwd_kernel(int g) {
  if constexpr (FP == 32) {
    if (g == 32) return sddmm_fwd_kernel<32>;
  } else {
    if (g == 8) return sddmm_fwd_kernel<8>;
    if (g == 16) return sddmm_fwd_kernel<16>;
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
int mpnn_sddmm_fwd_smem_bytes(int k_vocab, int group, int per) {
  return int(sizeof(float) * fwd_smem_floats(k_vocab, (kThreads / group) *
                                                          per));
}

// Floats of scratch a launch needs: two FP-wide partial rows a tile.
long long mpnn_sddmm_fwd_scratch_floats(int n_edges, int group, int per) {
  return 2LL * tiles_of(n_edges, group, per) * FP;
}

// Launches on `stream` and returns the launch's error code (0 = success).
// Does not synchronize and allocates nothing. (group, per) from
// kernels/sddmm.py::launch_shape: lanes an edge and edges a group in a
// tile; a block a tile. counters: a tile's int each, zero (every launch
// leaves them zero). prof: null or kProfSlots int64.
int mpnn_sddmm_fwd(const float* aprime, const float* evocab, const float* wa,
                   const float* ba, const float* h, const int* vid,
                   const int* src, const int* dst, const int* order,
                   const int* ptr, float* out, float* scratch,
                   int* counters, long long* prof, int n, int n_edges,
                   int mf, int nf, int ef, int k_vocab, int group, int per,
                   int floor, void* stream) {
  if (mf < 1 || mf > FP || nf < 1 || nf > FP || ef < 0 ||
      ef > kMaxEdgeFeatures || k_vocab < 1 || k_vocab > kMaxVocab || n < 1 ||
      n_edges < 1 || group != group_of(mf, nf) || per < 1 ||
      per > kMaxPer || counters == nullptr)
    return int(cudaErrorInvalidValue);
  const int tiles = tiles_of(n_edges, group, per);
  FwdArgs args{aprime, evocab, wa, ba, h, vid, src, dst, order, ptr, out,
               scratch, counters, prof, n, n_edges, mf, nf, ef, k_vocab,
               per, tiles, floor};
  const FwdKernel kernel = fwd_kernel(group);
  if (kernel == nullptr) return int(cudaErrorInvalidValue);
  return int(launch(kernel, tiles,
                    sizeof(float) * fwd_smem_floats(
                                        k_vocab, (kThreads / group) * per),
                    static_cast<cudaStream_t>(stream), args));
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
