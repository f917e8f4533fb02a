// Shared pieces of the reverse-walk backwards that spread a node over a
// group of lanes and combine their batch sums without a grid barrier
// (fused_step_bwd.cu, the shared family's whole step; recurrence_bwd.cu,
// the decomposed path's chain; fused_psteps_bwd.cu, the per-step family's
// whole step).
//
//   * a node is a GROUP of FP lanes, one feature a lane (two nodes a warp
//     at FP 16, one at FP 32) in blocks of kBT threads; dot products take
//     the other features by shuffles within the group, transposed products
//     are reduce-scatters over the group's lanes;
//   * per-lane vectors are summed over a block's groups in a fixed order
//     (groups_to);
//   * a round's block partials are summed across the launch's blocks in
//     block order (combine): through distributed shared memory within one
//     thread-block cluster, or, on a grid of co-resident blocks, through
//     global scratch behind per-round flags that carry the launch's tag,
//     with no grid barrier;
//   * the blocks' gradient rows are summed in block order by the last
//     block of each counter group (an integer counter the block resets),
//     then by the last group's last block: no memset before a launch, no
//     float atomics.
// Every cross-thread sum runs in a fixed order, so a launch gives the same
// bits on every run of the same route.

#pragma once

#include "fused_train_common.cuh"

namespace mpnn_walk {

using mpnn_train::FP;
using mpnn_train::kFull;
namespace cg = cooperative_groups;

constexpr int kBT = 256;              // threads a block
constexpr int GS = FP;                // lanes a node (a group)
constexpr int NG = kBT / GS;          // groups a block
constexpr int kWB = kBT / 32;         // warps a block
constexpr int kMaxGrid = 512;         // blocks of the grid route at most
constexpr int kFlagStride = 4;        // u64 words: a flag a 32-byte sector
constexpr int kMaxGroups = 32;        // counter groups of the final sum
constexpr int kProfSlots = 80;        // block 0's clock64 stamps
constexpr int kRed = kWB * FP * FP > kBT * 16 ? kWB * FP * FP : kBT * 16;

// cluster: one thread-block cluster; grid: co-resident blocks that meet
// through flags; free: independent blocks (no batch sum crosses them, only
// the final sum of the gradient rows, through counters), any number
enum Route { kRouteCluster = 0, kRouteGrid = 1, kRouteFree = 2 };

// u64 flag words of `rounds` combine rounds, the last word the tag of the
// launch that used them last
__host__ __device__ constexpr int flag_words(int rounds) {
  return rounds * kMaxGrid * kFlagStride + 1;
}

__host__ __device__ inline int al4(int n) { return (n + 3) & ~3; }

#ifdef MPNN_CUDA_EMU
__device__ inline void cp_async4(float* d, const float* s) {
  emu_cp_async4(d, s);
}
__device__ inline void cp_async_wait_all() { emu_cp_async_wait_all(); }
__device__ inline unsigned long long ld_flag(const unsigned long long* p) {
  return emu_ld_relaxed(p);
}
__device__ inline void st_flag(unsigned long long* p, unsigned long long v) {
  emu_st_relaxed(p, v);
}
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
__device__ __forceinline__ unsigned long long ld_flag(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_flag(unsigned long long* p,
                                        unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}
__device__ __forceinline__ void spin_pause() {}
#endif

// 4 bytes into a node tile: cp.async into shared memory, a plain copy
// into a spilled block's global scratch
template <bool kSm>
__device__ __forceinline__ void copy4(float* d, const float* s) {
  if constexpr (kSm)
    cp_async4(d, s);
  else
    *d = __ldg(s);
}

__device__ __forceinline__ void stamp(long long* prof, int slot) {
  if (prof != nullptr && blockIdx.x == 0 && threadIdx.x == 0 &&
      slot < kProfSlots)
    prof[slot] = clock64();
}

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

// Per-lane vectors v[LEN] of every group of G lanes (by default a node's
// GS) summed over the block's groups in order (a warp's groups first, by
// xor shuffles), into out(idx, j) for idx < LEN, j < G. Every thread calls
// it; `red` holds kRed floats.
template <int LEN, int G = GS, class Out>
__device__ void groups_to(const float (&v)[LEN], float* red, Out out) {
  static_assert(LEN * G * kWB <= kRed, "red holds a warp's row");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < LEN; ++i) {
    float s = v[i];
#pragma unroll
    for (int off = 16; off >= G; off >>= 1)
      s += __shfl_xor_sync(kFull, s, off);
    if (lane < G) red[(warp * LEN + i) * G + lane] = s;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < LEN * G; e += kBT) {
    float s = 0.f;
    for (int w = 0; w < kWB; ++w) s += red[w * LEN * G + e];
    out(e / G, e % G, s);
  }
  __syncthreads();
}

// A compensated (Kahan) sum: a lane's chain over thousands of nodes (a
// large graph in one block) keeps near float64 where a plain chain drifts.
struct Ksum {
  float s = 0.f, c = 0.f;
  __device__ __forceinline__ void add(float v) {
    const float y = v - c;
    const float t = s + y;
    c = (t - s) - y;
    s = t;
  }
};

// A batch mean s/c as the unevaluated sum hi + lo of two floats (lo the
// rounding of hi, from the division's exact residual). A node's x − hi −
// lo rounds relative to the node's own value; x − fl(s/c) would carry
// fl's rounding, common to every node, into a sum over the batch, where
// it adds up (a large graph's cotangents share a large offset).
struct Mean2 {
  float hi = 0.f, lo = 0.f;
  __device__ Mean2() {}
  __device__ Mean2(float s, float c) : hi(s / c), lo(fmaf(-hi, c, s) / c) {}
  // (x − s/c)·r: x − hi exactly as d + e (Knuth's two-sum), then one
  // rounding of d·r + (e − lo)·r
  __device__ __forceinline__ float off_times(float x, float r) const {
    const float d = x - hi;
    const float xv = d + hi, bv = d - xv;
    const float e = (x - xv) + (-hi - bv);
    return fmaf(d, r, (e - lo) * r);
  }
};

// The launch's blocks and how they meet.
struct Sync {
  int route;                    // kRouteCluster or kRouteGrid
  int nblocks, b;               // blocks of the launch, this block
  unsigned long long tag;       // the grid route's flag value this launch
  unsigned long long* flags;    // grid route: a row of kMaxGrid flags a round
  int* counters;                // grid route: kMaxGroups + 1, zero between
  unsigned long long* last;     // the flag word that holds the last tag
};

// The totals over the launch's blocks of a round's block partial bp[0, W)
// (shared memory, written and synced before the call; the same offset in
// every block), in block order, into tot[0, W). `gp`: the round's nblocks·W
// floats of global scratch (grid route), `fl`: its row of flags. `red`:
// kRed floats. Every thread calls it.
__device__ void combine(const Sync& y, const float* bp, float* tot, int W,
                        float* gp, unsigned long long* fl, float* red) {
  const int tid = threadIdx.x, G = y.nblocks;
  if (G == 1) {
    for (int i = tid; i < W; i += kBT) tot[i] = bp[i];
    __syncthreads();
    return;
  }
  if (y.route == kRouteCluster) {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    // the peers' loads issued together, summed in rank order
    for (int i = tid; i < W; i += kBT) {
      float u[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        u[r] = r < G ? cl.map_shared_rank(bp, r)[i] : 0.f;
      float v = 0.f;
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (r < G) v += u[r];
      tot[i] = v;
    }
    __syncthreads();
    return;
  }
  for (int i = tid; i < W; i += kBT) gp[size_t(y.b) * W + i] = bp[i];
  __threadfence();
  __syncthreads();
  if (tid == 0) st_flag(fl + size_t(y.b) * kFlagStride, y.tag);
  for (int bb = tid; bb < G; bb += kBT)
    while (ld_flag(fl + size_t(bb) * kFlagStride) != y.tag) spin_pause();
  __threadfence();
  __syncthreads();
  // thread (p, i) sums blocks p, p + P, ... in order, 16 loads in
  // flight; P = kBT / W partial sums an element (one past kBT elements)
  const int P = W < kBT ? kBT / W : 1;
  for (int it = tid; it < P * W; it += kBT) {
    const int p = it / W, i = it % W;
    float v = 0.f;
    for (int b0 = p; b0 < G; b0 += 16 * P) {
      float u[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int bb = b0 + r * P;
        u[r] = bb < G ? __ldcg(gp + size_t(bb) * W + i) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 16; ++r)
        if (b0 + r * P < G) v += u[r];
    }
    if (P > 1)
      red[p * W + i] = v;
    else
      tot[i] = v;
  }
  if (P > 1) {
    __syncthreads();
    if (tid < W) {
      float v = 0.f;
      for (int q = 0; q < P; ++q) v += red[q * W + tid];
      tot[tid] = v;
    }
  }
  __syncthreads();
}

// dst[e] = Σ_{r < nrows} rows[r·ld + e] in row order, for this block's
// threads' elements e in [e0, e1): a thread takes 4 elements at once and
// issues 8 rows' loads of each together before their adds.
__device__ void ordered_row_sums(float* dst, const float* rows, int nrows,
                                 size_t ld, int e0, int e1) {
  for (int e = e0 + int(threadIdx.x); e < e1; e += 4 * kBT) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r0 = 0; r0 < nrows; r0 += 8) {
      float v[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int ec = e + c * kBT;
          v[i][c] = r0 + i < nrows && ec < e1
                        ? __ldcg(rows + size_t(r0 + i) * ld + ec)
                        : 0.f;
        }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (r0 + i < nrows) s[c] += v[i][c];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (e + c * kBT < e1) dst[e + c * kBT] = s[c];
  }
}

// The grid route's final sum: the last block of each counter group sums
// its group's rows (NW floats, stride ld) in block order into `gparts`
// (kMaxGroups·NW floats), and the last group's last block sums the group
// rows into dw. Rows are complete before the call; every thread calls it.
// Returns true in the block that finished dw, which also records the
// launch's tag (the next launch tags its flags with the next value).
__device__ bool final_sum_grid(const Sync& y, float* dw, const float* rows,
                               int NW, size_t ld, float* gparts) {
  const int tid = threadIdx.x, G = y.nblocks;
  int gsz = 1;
  while (gsz * gsz < G) ++gsz;
  const int ngroups = (G + gsz - 1) / gsz;
  const int g = y.b / gsz, b0 = g * gsz, b1 = min(G, b0 + gsz);
  __threadfence();
  __syncthreads();
  int last = 0;
  if (tid == 0) last = atomicAdd(y.counters + g, 1) == b1 - b0 - 1;
  if (!__syncthreads_or(last)) return false;
  if (tid == 0) y.counters[g] = 0;
  __threadfence();
  ordered_row_sums(ngroups == 1 ? dw : gparts + size_t(g) * NW,
                   rows + size_t(b0) * ld, b1 - b0, ld, 0, NW);
  if (ngroups > 1) {
    __threadfence();
    __syncthreads();
    last = 0;
    if (tid == 0) last = atomicAdd(y.counters + kMaxGroups, 1) == ngroups - 1;
    if (!__syncthreads_or(last)) return false;
    if (tid == 0) y.counters[kMaxGroups] = 0;
    __threadfence();
    ordered_row_sums(dw, gparts, ngroups, NW, 0, NW);
  }
  // dw complete for this block's threads; no fence before the tag: the
  // next launch on this stream reads it only after this one has ended (a
  // launch without flags has no tag)
  __syncthreads();
  if (tid == 0 && y.last != nullptr) st_flag(y.last, y.tag);
  return true;
}

// The cluster route's final sum: the rows of the cluster's blocks summed
// in rank order into dw, a column chunk per block. Every thread of every
// block calls it (a cluster of more than one block).
__device__ void final_sum_cluster(const Sync& y, float* dw, const float* rows,
                                  int NW, size_t ld) {
  const int C = y.nblocks;
  __threadfence();
  cg::this_cluster().sync();
  const int per = (NW + C - 1) / C;
  const int e0 = y.b * per;
  ordered_row_sums(dw, rows, C, ld, e0, min(NW, e0 + per));
}

// The balanced split point of `total` items over `parts` at part b.
__device__ __forceinline__ int split_at(int total, int parts, int b) {
  return int((long long)total * b / parts);
}

// Launch helpers of the host entry points: a launch on `route` with
// `grid` blocks (the cluster route: one cluster of `grid` blocks; the grid
// route: a cooperative launch, for co-residency only).
template <typename Kernel, typename Args>
int launch_route(Kernel kernel, const Args& a, int route, int grid,
                 size_t bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteGrid) {
    Args copy = a;
    void* args[] = {&copy};
    err = cudaLaunchCooperativeKernel((void*)kernel, dim3(grid), dim3(kBT),
                                      args, bytes, s);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(kBT);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = grid;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = grid > 1 ? 1 : 0;
    err = cudaLaunchKernelEx(&cfg, kernel, a);
  }
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

// The co-resident blocks of `kernel` at `bytes` of dynamic shared memory,
// capped at kMaxGrid; 0 on error.
template <typename Kernel>
int max_grid(Kernel kernel, int bytes) {
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess)
    return 0;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBT,
                                                    bytes) != cudaSuccess)
    return 0;
  return min(per_sm * sms, kMaxGrid);
}

}  // namespace mpnn_walk
