// Vocab-indexed SpMM forward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels mpnn_tpu/kernels/spmm.py::_fwd_kernel_vmem and
// _fwd_kernel_hbm (the forward of make_spmm_op, and its transposed use in
// the VJP):
//
//   out[r] = Σ_{p = ptr[r]}^{ptr[r+1]-1} A[vid_e] · x[gather_e],  e = order[p]
//
// With (gather, key, order, ptr) = (src, dst, the destination order,
// dst_ptr) this is the message sum out[d] = Σ_{e: dst_e = d} A[vid_e]·
// h[src_e]; with (dst, src, the source order, src_ptr) and the transposed
// table Aᵀ it is the VJP's dh. key[e] is the output row of edge e. The TPU
// kernels gather and scatter with one-hot matmuls over node windows
// planned on the host.
//
// Design: edges, not rows, go to the workers — row 11's forward
// (sddmm_fwd.cu) without the gate, on the tile pieces of
// sddmm_common.cuh. The order's positions are cut into tiles of te
// consecutive positions, one block a tile (kernels/spmm.py::launch_shape
// sizes them). A block stages its positions' indices (the order's edge,
// then the edge's vocab id, gathered row and output row: independent
// loads, a thread a position) and their x rows, and the A tables of the
// vocab ids its positions use, compacted and transposed (lane m reads
// consecutive words): every id in the narrow bucket, up to kStageIds in
// the wide one, whose tiles with more read A's rows through the read-only
// cache. A group of G lanes (8, 16 or 32: the narrowest that
// holds mo and ni) computes a position's A[vid]·x row, lane m output m,
// `per` positions a group. A row inside the tile is summed in position
// order; a row that crosses tiles — the batch's dummy row, which every
// padded edge ends at, and any high in-degree node — is summed from its
// tiles' partials in tile order by the tile that completes the row's
// integer counter, which sets it back to zero (spmm_tile_rows: the
// boundary rows' pointers loaded with the indices, the two counters
// counted at once, only the threads that wrote a partial fenced). No
// grid barrier, no
// cooperative launch, no memset, no float atomics: the same bits in
// every run.
//
// Bound: chip_smoke.py::_spmm_bounds (a GEMV per real edge against the
// bytes of A, x, out and the edge arrays; ~0.4 us by bytes at lipo's
// b1024). The gathers are irregular: three rounds of dependent loads a
// tile, the row sums and the launch set the time.

#include "sddmm_common.cuh"

namespace {

using namespace mpnn_sddmm;

// The vocab ids a block stages, their tables compacted in id order: every
// id in the narrow bucket (64 KB at K 64), up to 16 in the wide one
// (64 KB); a wide tile that uses more reads A's rows through the
// read-only cache.
constexpr int kStageIds = FP <= 16 ? kMaxVocab : 16;
static_assert(FP > 16 || FP * FP == kThreads,
              "the narrow bucket stages an entry of each table a thread");

struct FwdArgs {
  const float* a;       // (K, mo, ni)
  const float* x;       // (n_in, ni)
  const int* vid;       // (E) vocab id of each edge
  const int* gather;    // (E) the row of x each edge reads
  const int* key;       // (E) the output row of each edge
  const int* order;     // (E) edge ids grouped by output row, stable
  const int* ptr;       // (n_out + 1) row pointers into order
  float* out;           // (n_out, mo)
  float* slots;         // (2·tiles, FP) partials of rows crossing tiles
  int* counters;        // (tiles) zero between launches
  long long* prof;      // null, or kProfSlots clock64 stamps of block 0
  int n_out, n_pos, mo, ni, k_vocab, per, floor;
};

__host__ __device__ inline int table_floats_of(int k_vocab) {
  return (k_vocab < kStageIds ? k_vocab : kStageIds) * FP * FP;
}

// the used-id mask, the boundary rows' pointers and the combine's flags
// follow the staging
__host__ __device__ inline int fwd_smem_floats(int k_vocab, int te) {
  return table_floats_of(k_vocab) + stage_floats(te, 2) + 8;
}

#ifdef MPNN_CUDA_EMU
__device__ inline void cp_async4(float* d, const float* s) {
  emu_cp_async4(d, s);
}
__device__ inline void cp_async_wait_all() { emu_cp_async_wait_all(); }
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
#endif

// The slot of used id k among the used ids (in id order).
__device__ __forceinline__ int slot_of(unsigned w0, unsigned w1, int k) {
  return k < 32 ? __popc(w0 & ((1u << k) - 1u))
                : __popc(w0) + __popc(w1 & ((1u << (k - 32)) - 1u));
}

// A tile's rows after its products are in staged row `cr`: each row's
// positions in order, summed by the group that holds its first one; a row
// inside the tile is written to out, a row crossing it to its slot (the
// tile's first row when it began in an earlier tile, its last when it
// goes on into a later one), fenced by the threads that wrote it. Then
// threads 0 and 32 count the two crossing rows in their counters at once
// (the rows' pointers, `bp`, were loaded at the start), and the tile that
// completes a row sums its partials in tile order (sddmm_common.cuh's
// sum_partials) and sets its counter back to zero. Every thread calls it;
// `flag`: 2 ints of shared memory.
template <int G>
__device__ __forceinline__ void spmm_tile_rows(const RowView& v,
                                               const Stage& s, int cr,
                                               int tile, int cnt, int per,
                                               const int* bp, int* flag) {
  const int ts = tile * v.te, j = threadIdx.x % G, gi = threadIdx.x / G;
  bool wrote = false;
  for (int i = 0; i < per; ++i) {
    const int p = gi * per + i;
    if (p >= cnt || (p > 0 && s.key[p - 1] == s.key[p])) continue;
    const int r = s.key[p];
    float sum = 0.f;
    int q = p;
    for (; q < cnt && s.key[q] == r; ++q) sum += s.at(cr, q)[j];
    if (j < v.width) {
      const bool first = p == 0 && bp[0] < ts;
      const bool last = q == cnt && bp[3] > ts + cnt && !first;
      if (!first && !last) {
        v.out[size_t(r) * v.width + j] = sum;
      } else {
        v.slots[(2 * size_t(tile) + (first ? 0 : 1)) * FP + j] = sum;
        wrote = true;
      }
    }
  }
  if (wrote) __threadfence();
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid == 0 || tid == 32) {
    const bool first = tid == 0;
    int done = -1;
    if (first && bp[0] < ts) {              // the first row began earlier
      const int t0 = bp[0] / v.te, t1 = (bp[1] - 1) / v.te;
      if (atomicAdd(v.counters + t0, 1) == t1 - t0) done = s.key[0];
    }
    if (!first && bp[2] >= ts && bp[3] > ts + cnt) {   // the last goes on
      const int t1 = (bp[3] - 1) / v.te;
      if (atomicAdd(v.counters + tile, 1) == t1 - tile) done = s.key[cnt - 1];
    }
    flag[first ? 0 : 1] = done;
  }
  __syncthreads();
  for (int w = 0; w < 2; ++w)
    if (flag[w] >= 0) finish_row(v, flag[w]);
}

// A block a tile. `floor`: the same grid, staging of the indices and
// combines, no tables, rows or arithmetic.
// The narrow build held to 64 registers a thread: 4 blocks an SM, so that
// the rule's tiles (up to GRID_WAVE = 3 a SM, more at the largest tiles)
// run in one wave; the wide build keeps the compiler's choice.
#if MPNN_FP <= 16
#define MPNN_SPMM_BOUNDS __launch_bounds__(kThreads, 4)
#else
#define MPNN_SPMM_BOUNDS __launch_bounds__(kThreads)
#endif
template <int G>
__global__ void MPNN_SPMM_BOUNDS spmm_fwd_kernel(FwdArgs a) {
  extern __shared__ float sm[];
  const int te = (kThreads / G) * a.per;       // at most kThreads
  float* at = sm;        // at[(slot·FP + j)·FP + m] = A[k][m][j]
  const Stage s = carve_stage(sm + table_floats_of(a.k_vocab), te);
  int* ints = reinterpret_cast<int*>(sm + table_floats_of(a.k_vocab) +
                                     stage_floats(te, 2));
  int* flag = ints;                            // 2
  unsigned* used = reinterpret_cast<unsigned*>(ints + 2);   // 2
  int* bp = ints + 4;                          // 4: the boundary rows' ptr
  const int tid = threadIdx.x, j = tid % G, gi = tid / G;
  const bool st = a.prof != nullptr && blockIdx.x == 0 && tid == 0;
  auto stamp = [&](int i) {
    if (st) a.prof[i] = clock64();
  };
  stamp(0);
  const RowView v{a.ptr, a.out, a.slots, a.counters, a.mo, te};
  const int tile = blockIdx.x, ts = tile * te,
            cnt = min(te, a.n_pos - ts);
  // a thread a position: its edge, then the edge's indices
  const int e = tid < cnt ? __ldg(a.order + ts + tid) : 0;
  if (tid < 2) used[tid] = 0u;
  __syncthreads();
  if (tid < cnt) {
    const int k = __ldg(a.vid + e);
    s.key[tid] = __ldg(a.key + e);
    s.src[tid] = __ldg(a.gather + e);
    s.vid[tid] = k;
    atomicOr(used + (k >> 5), 1u << (k & 31));
  }
  __syncthreads();
  // the first and the last row's pointers, in flight under the staging
  int rp = 0;
  if (tid < 4) {
    const int r = s.key[tid < 2 ? 0 : cnt - 1];
    rp = __ldg(a.ptr + r + (tid & 1));
  }
  stamp(1);
  const unsigned w0 = used[0], w1 = used[1];
  const bool staged = __popc(w0) + __popc(w1) <= kStageIds;
  if (!a.floor) {
    // the used ids' tables, compacted, their loads in flight with the x
    // rows': in the narrow bucket a thread loads one entry of each id's
    // table, kBatch ids at a time; in the wide one, asynchronous copies
    if constexpr (FP <= 16) {
      constexpr int kBatch = 8;
      const int jt = tid / FP, mt = tid % FP;
      const bool in = mt < a.mo && jt < a.ni;
      unsigned m0 = w0, m1 = w1;
      bool first = true;
      for (int slot = 0; first || (m0 | m1); slot += kBatch) {
        int ks[kBatch];
        float tv[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          ks[b] = -1;
          if (m0) {
            ks[b] = __ffs(m0) - 1;
            m0 &= m0 - 1;
          } else if (m1) {
            ks[b] = 32 + __ffs(m1) - 1;
            m1 &= m1 - 1;
          }
          tv[b] = ks[b] >= 0 && in
                      ? __ldg(a.a + (size_t(ks[b]) * a.mo + mt) * a.ni + jt)
                      : 0.f;
        }
        if (first) stage_rows(s, 0, s.src, a.x, a.ni, cnt);
        first = false;
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
          if (ks[b] >= 0) at[size_t(slot + b) * FP * FP + tid] = tv[b];
      }
    } else {
      if (staged) {
        unsigned m0 = w0, m1 = w1;
        for (int slot = 0; m0 | m1; ++slot) {
          const int k = m0 ? __ffs(m0) - 1 : 32 + __ffs(m1) - 1;
          if (m0)
            m0 &= m0 - 1;
          else
            m1 &= m1 - 1;
          for (int r = tid; r < FP * FP; r += kThreads) {
            const int jt = r / FP, mt = r % FP;
            float* d = at + size_t(slot) * FP * FP + r;
            if (mt < a.mo && jt < a.ni)
              cp_async4(d, a.a + (size_t(k) * a.mo + mt) * a.ni + jt);
            else
              *d = 0.f;
          }
        }
      }
      stage_rows(s, 0, s.src, a.x, a.ni, cnt);
      cp_async_wait_all();
    }
  }
  if (tid < 4) bp[tid] = rp;
  __syncthreads();
  stamp(2);
  // each group its positions, two at a time: A[k]·x on lane m; a position
  // past the tile computes on the tile's last and writes nothing. A wide
  // tile of more than kStageIds ids loads its A rows before the products.
  auto message = [&](int pc) {
    const int k = s.vid[pc];
    const float* xr = s.at(0, pc);
    float msg = 0.f;
    if (staged) {
      const float* t = at + size_t(slot_of(w0, w1, k)) * FP * FP + j;
#pragma unroll
      for (int jj = 0; jj < G; ++jj) msg = fmaf(t[jj * FP], xr[jj], msg);
    } else {
      float ar[FP];
#pragma unroll
      for (int jj = 0; jj < FP; ++jj)
        ar[jj] = j < a.mo && jj < a.ni
                     ? __ldg(a.a + (size_t(k) * a.mo + j) * a.ni + jj)
                     : 0.f;
#pragma unroll
      for (int jj = 0; jj < G; ++jj) msg = fmaf(ar[jj], xr[jj], msg);
    }
    return msg;
  };
  for (int i = 0; i < a.per; i += 2) {
    const int pa = gi * a.per + i, pb = i + 1 < a.per ? pa + 1 : pa;
    float ma = 0.f, mb = 0.f;
    if (!a.floor) {
      ma = message(min(pa, cnt - 1));
      mb = message(min(pb, cnt - 1));
    }
    if (pa < cnt) s.at(1, pa)[j] = ma;
    if (pb != pa && pb < cnt) s.at(1, pb)[j] = mb;
  }
  __syncthreads();
  stamp(3);
  spmm_tile_rows<G>(v, s, 1, tile, cnt, a.per, bp, flag);
  stamp(4);
  zero_empty_rows(a.ptr, a.out, a.n_out, a.mo);
  stamp(5);
}

using FwdKernel = void (*)(FwdArgs);

// The kernel of a group width; null for a width the bucket does not
// build.
FwdKernel fwd_kernel(int g) {
  if constexpr (FP == 32) {
    if (g == 32) return spmm_fwd_kernel<32>;
  } else {
    if (g == 8) return spmm_fwd_kernel<8>;
    if (g == 16) return spmm_fwd_kernel<16>;
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
int mpnn_spmm_fwd_smem_bytes(int k_vocab, int group, int per) {
  return int(sizeof(float) *
             fwd_smem_floats(k_vocab, (kThreads / group) * per));
}

// Floats of scratch a launch needs: two FP-wide partial rows a tile.
long long mpnn_spmm_fwd_scratch_floats(int n_pos, int group, int per) {
  return 2LL * tiles_of(n_pos, group, per) * FP;
}

// Launches on `stream` and returns the launch's error code (0 = success).
// Does not synchronize and allocates nothing. (group, per) from
// kernels/spmm.py::launch_shape: lanes a position and positions a group
// in a tile; a block a tile. counters: a tile's int each, zero (every
// launch leaves them zero). prof: null or kProfSlots int64.
int mpnn_spmm_fwd(const float* a, const float* x, const int* vid,
                  const int* gather, const int* key, const int* order,
                  const int* ptr, float* out, float* scratch, int* counters,
                  long long* prof, int n_out, int n_pos, int mo, int ni,
                  int k_vocab, int group, int per, int floor, void* stream) {
  if (mo < 1 || mo > FP || ni < 1 || ni > FP || k_vocab < 1 ||
      k_vocab > kMaxVocab || n_out < 1 || n_pos < 1 ||
      group != group_of(mo, ni) || per < 1 || per > kMaxPer ||
      counters == nullptr)
    return int(cudaErrorInvalidValue);
  const int tiles = tiles_of(n_pos, group, per);
  FwdArgs args{a, x, vid, gather, key, order, ptr, out, scratch, counters,
               prof, n_out, n_pos, mo, ni, k_vocab, per, floor};
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
