// Shared pieces of the edge-MLP chain kernels (edge_mlp_fwd.cu,
// edge_mlp_bwd.cu): the argument layout, the shared-memory plan, and the
// chain's layers, which the forward kernel and the backward's recompute
// both run (one code, one summation order: the backward's relu masks are
// those of the pen the forward returned).
//
// The chain runs on the R = K + 1 edge-vocab rows (the K distinct edge
// feature rows of a batch plus the zero row), ef wide:
//
//   x = relu(x·W_h + b_h)    for the H head layers (ef → … → pf)
//   x = relu(x·W_s)          T times (the reference's 50), one shared W_s
//
// Its time is the serial chain of 1 + H + T dependent layers, not the
// arithmetic (R·T·pf² multiply-adds, a few µs of float32 FMA throughput).
// So a block holds `rb` rows (chosen on the host, kernels/edge_mlp.py::
// launch_shape) and everything they need for the whole chain on chip, and
// every layer is one dot per output and one barrier:
//
// * the register route (pf <= 64): thread c of a row (a warp, two past pf
//   32) owns output column c and keeps column c of W_s (KP = pf rounded up
//   to 8 floats) in registers for all T layers; the row arrives as 16-byte
//   shared-memory broadcasts, and a layer ends with the row's own barrier.
//   The backward reloads the same registers with row c of W_s for the
//   reverse walk.
// * the panel route (pf > 64): W_s does not fit registers (and at pf 256
//   not one SM), so a cluster of C blocks each stages a panel of P columns
//   of W_s in shared memory and computes those output columns; each layer's
//   output rows go to every block of the cluster through distributed
//   shared memory, under one cluster barrier a layer. C = 1 is a plain
//   block with all of W_s in shared memory.
// * the l2 route (past what a cluster of 8 holds: pf ~468 in the backward,
//   whose stash grows with pf, ~640 in the forward): the panel route's
//   cluster of 8 and its code, with each block's W_s panel read in every
//   layer from device memory (L2-resident: 0.9-3.7 MB at pf 484-961) and
//   the backward's stash in the block's region of global scratch. The
//   exchange rows and the head stay in shared memory. Its sums are the
//   panel route's, in the same order, so the forward's panel route and
//   the backward's l2 route give the same relu masks.
//
// The forward (and the backward's recompute: the same code) sums each
// output in k order, one FMA chain, as a plain float32 matrix product
// does: a 51-layer relu chain flips masks at rounding level, and a split
// sum moved the models' first-step gradients off the plain path's by
// more than their check allows. The reverse walk, whose masks come from
// the stash, splits each dot into four partial sums (k mod 4), combined
// as (a0 + a1) + (a2 + a3). The head layers (each run once) read their
// weights from shared memory, staged once per block. No tensor cores:
// TF32 would break the chain's float32 tolerance.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "smem_limit.cuh"

namespace mpnn_mlp {

namespace cg = cooperative_groups;

constexpr int kMaxHead = 4;       // head layers (ef 2 at pf 256 takes 3)
constexpr int kRegMaxPf = 64;     // widest W_s kept in registers
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kPanelThreads = 256;
constexpr int kRT = 4;            // rows a thread computes on the panel route
constexpr int kProfSlots = 20;    // clock64 stamps (block 0, thread 0)

struct MlpArgs {
  const float* x;                 // (R, ef)
  const float* hw[kMaxHead];      // head layer i: (d_i, d_{i+1})
  const float* hb[kMaxHead];      // (d_{i+1})
  const float* ws;                // (pf, pf)
  int dims[kMaxHead + 1];         // ef = d_0, d_1, …, d_H = pf
  int rows, n_head, tail;
  int rb;                         // rows a block (a cluster) holds
  int cluster;                    // blocks a cluster (1 on the register route)
  int l2;                         // the l2 route: W_s (and the backward's
                                  // stash) in device memory
  long long* prof;                // clock64 stamps, or null
};

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }
__host__ __device__ inline int round8(int v) { return (v + 7) & ~7; }
__host__ __device__ inline int pf_of(const MlpArgs& a) {
  return a.dims[a.n_head];
}

// Threads of a register-route row: one output column each, a warp at pf
// <= 32, two warps above.
__host__ __device__ constexpr int reg_lanes(int kp) {
  return kp > 32 ? 64 : 32;
}

// The most threads a register-route block may have: a thread's W_s column
// costs KP registers (255 at most a thread, 65,536 an SM).
__host__ __device__ constexpr int reg_max_threads(int kp) {
  return kp <= 32 ? 1024 : kp <= 48 ? 640 : 512;
}

// Where each buffer of a block lies in dynamic shared memory (floats; every
// region starts on 16 bytes). `kp` > 0 is the register route (its W_s
// column of kp floats), 0 the panel route. Full rows are `ld` floats apart,
// the block's own tail columns (its panel) `pp` apart; a block computes
// `rbp` rows (the panel route rounds rb up to kRT; the rows past R are
// zero inputs whose outputs are never written out and whose cotangents are
// zero). The l2 route has no W_s region and no tail stash (ty, tg: its
// stash_floats lie in global scratch, laid out alike).
// kernels/edge_mlp.py::smem_floats mirrors the sizes.
struct Plan {
  int ld, own, pp, wld, rbp, c0;
  int hw[kMaxHead], hld[kMaxHead], hb[kMaxHead];
  int wp;                         // W_s (its panel), round4(pf) rows of wld
  int xb;                         // 2 exchange buffers of rbp full rows
  // backward only
  int hy[kMaxHead + 1];           // head inputs and y_H, rbp × round4(d_h)
  int hg[kMaxHead];               // head cotangents gz_h, rbp × round4(d_h+1)
  int ty, tg;                     // own tail outputs (T + 1) and gz (T)
  int stash;                      // floats of ty and tg (the l2 route's
                                  // region of global scratch a block)
  int total;

  __host__ __device__ Plan(const MlpArgs& m, int kp, bool bwd, int rank) {
    const int pf = pf_of(m), H = m.n_head, T = m.tail;
    const int c = kp > 0 ? 1 : m.cluster;
    ld = kp > 0 ? kp : round4(pf);
    const int panel = round4((pf + c - 1) / c);
    c0 = rank * panel;
    own = kp > 0 ? pf : (pf - c0 < panel ? pf - c0 : panel);
    if (own < 0) own = 0;
    pp = kp > 0 ? kp : panel;
    // the register route's lanes read W_s's rows as 16-byte loads: rows
    // kp + 4 apart put a quarter-warp's eight rows on distinct banks
    wld = kp > 0 ? kp + 4 : panel;
    rbp = kp > 0 ? m.rb : round4(m.rb);
    int off = 0;
    auto take = [&](int n) {
      const int at = off;
      off += round4(n);
      return at;
    };
    for (int h = 0; h < H; ++h) {
      hld[h] = m.dims[h + 1] | 1;           // odd: the reverse reads rows
      hw[h] = take(round4(m.dims[h]) * hld[h]);
      hb[h] = take(m.dims[h + 1]);
    }
    wp = m.l2 ? 0 : take(round4(pf) * wld);
    xb = take(2 * rbp * ld);
    for (int h = 0; h <= H; ++h)
      hy[h] = bwd ? take(rbp * round4(m.dims[h])) : 0;
    for (int h = 0; h < H; ++h)
      hg[h] = bwd ? take(rbp * round4(m.dims[h + 1])) : 0;
    stash = bwd ? round4((T + 1) * rbp * pp) + round4(T * rbp * pp) : 0;
    ty = bwd && !m.l2 ? take((T + 1) * rbp * pp) : 0;
    tg = bwd && !m.l2 ? take(T * rbp * pp) : 0;
    total = off;
  }
};

// The cluster's view: rank, size, and a peer's copy of a shared-memory
// address. A register-route block is a cluster of one and calls no
// cluster function.
template <bool kCluster>
struct Cta {
  int rank = 0, size = 1;
  __device__ Cta() {
    if constexpr (kCluster) {
      cg::cluster_group cl = cg::this_cluster();
      rank = int(cl.block_rank());
      size = int(cl.num_blocks());
    }
  }
  __device__ float* peer(float* p, int q) const {
    if constexpr (kCluster) {
      return cg::this_cluster().map_shared_rank(p, q);
    } else {
      return p;
    }
  }
  // every block of the cluster past this point; shared-memory writes
  // (local and remote) before it are visible after it
  __device__ void sync() const {
    if constexpr (kCluster) {
      cg::this_cluster().sync();
    } else {
      __syncthreads();
    }
  }
  __device__ int cluster_id() const { return int(blockIdx.x) / size; }
};

__device__ __forceinline__ void stamp(const MlpArgs& m, int slot) {
  if (m.prof != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    m.prof[slot] = clock64();
}

// 4 bytes global → shared, landed by cp_async_wait_all (the stand-in's in
// scripts/cuda_emu/cuda_runtime.h)
#ifdef MPNN_CUDA_EMU
__device__ inline void cp_async4(float* d, const float* s) {
  emu_cp_async4(d, s);
}
__device__ inline void cp_async16(float* d, const float* s) {
  for (int i = 0; i < 4; ++i) emu_cp_async4(d + i, s + i);
}
__device__ inline void cp_async_wait_all() { emu_cp_async_wait_all(); }
#else
__device__ __forceinline__ void cp_async4(float* d, const float* s) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(d))),
               "l"(s)
               : "memory");
}
// 16 bytes, both addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(float* d, const float* s) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(d))),
               "l"(s)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
#endif

// The block's W_s panel, by asynchronous copies: transposed = false puts
// column panel W[k][c0 + j] at wp[k·pp + j] (the forward; on the register
// route all of W_s, whose lanes then take their columns and rows from
// it), true puts row panel W[c0 + j][k] there (the panel route's reverse
// walk: g = gz·W_sᵀ). Complete after cp_async_wait_all.
__device__ inline void copy_panel(const MlpArgs& m, const Plan& p, float* sm,
                                  bool transposed) {
  const int pf = pf_of(m), n = pf * p.own;
  if (!transposed && pf % 4 == 0 && p.own % 4 == 0 &&
      (reinterpret_cast<size_t>(m.ws) & 15) == 0) {   // rows of 16 bytes
    const int q = p.own / 4;
    for (int i = threadIdx.x; i < pf * q; i += blockDim.x) {
      const int k = i / q, j = 4 * (i % q);
      cp_async16(sm + p.wp + k * p.wld + j, m.ws + size_t(k) * pf + p.c0 + j);
    }
    return;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int k = i / p.own, j = i % p.own;
    cp_async4(sm + p.wp + k * p.wld + j,
              transposed ? m.ws + size_t(p.c0 + j) * pf + k
                         : m.ws + size_t(k) * pf + p.c0 + j);
  }
}

// Stage a block: zero its shared memory where padding columns and rows
// must read as zero (all of it but the register route's stash, whose every
// slot the chain writes whole), then copy in the head weights (rows past
// d_h zero) and biases, W_s's panel and the block's input rows (zero past
// R) — one round of asynchronous copies, all in flight together.
__device__ inline void stage(const MlpArgs& m, const Plan& p, float* sm,
                             int row0, bool reg_bwd) {
  float4* sm4 = reinterpret_cast<float4*>(sm);
  const int zero_end = reg_bwd ? p.ty : p.total;
  for (int i = threadIdx.x; i < zero_end / 4; i += blockDim.x)
    sm4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  for (int h = 0; h < m.n_head; ++h) {
    const int n_in = m.dims[h], n_out = m.dims[h + 1];
    for (int i = threadIdx.x; i < n_in * n_out; i += blockDim.x)
      cp_async4(sm + p.hw[h] + (i / n_out) * p.hld[h] + i % n_out,
                m.hw[h] + i);
    for (int i = threadIdx.x; i < n_out; i += blockDim.x)
      cp_async4(sm + p.hb[h] + i, m.hb[h] + i);
  }
  if (!m.l2) copy_panel(m, p, sm, false);
  const int ef = m.dims[0], nr = min(p.rbp, m.rows - row0);
  for (int i = threadIdx.x; i < nr * ef; i += blockDim.x)
    cp_async4(sm + p.xb + (i / ef) * p.ld + i % ef,
              m.x + size_t(row0) * ef + i);
  cp_async_wait_all();
  __syncthreads();
}

// The dot of a 16-byte aligned row `in` with n4·4 weights `w(k)`. kSeq
// (the forward): one FMA chain in k order, as a plain float32 matrix
// product sums; else (the reverse walk) four partial sums over k mod 4,
// combined (a0 + a1) + (a2 + a3).
template <bool kSeq, class W>
__device__ __forceinline__ float dot4(const float* in, int n4, W w) {
  const float4* row = reinterpret_cast<const float4*>(in);
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
  for (int j = 0; j < n4; ++j) {
    const float4 v = row[j];
    if constexpr (kSeq) {
      a0 = fmaf(v.x, w(4 * j), a0);
      a0 = fmaf(v.y, w(4 * j + 1), a0);
      a0 = fmaf(v.z, w(4 * j + 2), a0);
      a0 = fmaf(v.w, w(4 * j + 3), a0);
    } else {
      a0 = fmaf(v.x, w(4 * j), a0);
      a1 = fmaf(v.y, w(4 * j + 1), a1);
      a2 = fmaf(v.z, w(4 * j + 2), a2);
      a3 = fmaf(v.w, w(4 * j + 3), a3);
    }
  }
  return kSeq ? a0 : (a0 + a1) + (a2 + a3);
}

// One head layer on the block's rows: out[r][c] = relu(b[c] + Σ_k in[r][k]·
// W_h[k][c]), from exchange buffer `src` into `dst`, every row. With `hy`
// (the backward), the layer's input rows are also kept there. Both the
// forward kernel and the backward's recompute run it.
__device__ inline void head_layer(const MlpArgs& m, const Plan& p, float* sm,
                                  int h, const float* src, float* dst) {
  const int n_in = m.dims[h], n_out = m.dims[h + 1];
  const float* w = sm + p.hw[h];
  const int ldw = p.hld[h];
  for (int i = threadIdx.x; i < p.rbp * n_out; i += blockDim.x) {
    const int r = i / n_out, c = i % n_out;
    const float s = dot4<true>(src + r * p.ld, round4(n_in) / 4,
                         [&](int k) { return w[k * ldw + c]; });
    dst[r * p.ld + c] = fmaxf(s + sm[p.hb[h] + c], 0.f);
  }
}

// The scalars and pointers the layer loops use, taken out of Plan once:
// Plan's per-head offsets are indexed at run time, so it lives in local
// memory, and every barrier would reload what a loop reads from it; these
// stay in registers. The panel route's weight w(k, j) is wp[k·wk + j·wj]:
// the staged panel (wk = wld, wj = 1), or on the l2 route W_s in device
// memory (use_device_memory).
struct Geom {
  int pf, ld, pp, wld, wk, wj, rbp, c0, own;
  float *xb0, *xb1, *ty, *tg;
  const float* wp;
  __device__ Geom(const Plan& p, float* sm, int pf_)
      : pf(pf_), ld(p.ld), pp(p.pp), wld(p.wld), wk(p.wld), wj(1),
        rbp(p.rbp), c0(p.c0), own(p.own),
        xb0(sm + p.xb), xb1(sm + p.xb + p.rbp * p.ld), ty(sm + p.ty),
        tg(sm + p.tg), wp(sm + p.wp) {}
  // exchange buffer of layer l (by parity)
  __device__ float* xb(int l) const { return (l & 1) ? xb1 : xb0; }
  // the l2 route: the block's columns of W_s where they lie (transposed:
  // its rows, for the reverse walk), and its stash at `stash` (the
  // backward's; Plan.stash floats)
  __device__ void use_device_memory(const MlpArgs& m, bool transposed,
                                    float* stash, const Plan& p) {
    wp = m.ws + (transposed ? size_t(c0) * pf : size_t(c0));
    wk = transposed ? 1 : pf;
    wj = transposed ? pf : 1;
    if (stash != nullptr) {
      ty = stash;
      tg = stash + round4((m.tail + 1) * p.rbp * p.pp);
    }
  }
};

// The register route's dot of a 16-byte aligned row (a broadcast: every
// thread of the row reads it) with the thread's KP weights, in dot4's
// orders (kSeq: the forward's one chain in k order).
template <int KP, bool kSeq>
__device__ __forceinline__ float reg_dot(const float* src,
                                         const float (&w)[KP]) {
  const float4* row = reinterpret_cast<const float4*>(src);
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int j = 0; j < KP / 4; ++j) {
    const float4 v = row[j];
    if constexpr (kSeq) {
      a0 = fmaf(v.x, w[4 * j], a0);
      a0 = fmaf(v.y, w[4 * j + 1], a0);
      a0 = fmaf(v.z, w[4 * j + 2], a0);
      a0 = fmaf(v.w, w[4 * j + 3], a0);
    } else {
      a0 = fmaf(v.x, w[4 * j], a0);
      a1 = fmaf(v.y, w[4 * j + 1], a1);
      a2 = fmaf(v.z, w[4 * j + 2], a2);
      a3 = fmaf(v.w, w[4 * j + 3], a3);
    }
  }
  return kSeq ? a0 : (a0 + a1) + (a2 + a3);
}

// The barrier of register-route row r's threads: the warp's own, or a
// named barrier (1 + r; 0 is __syncthreads) over the row's two warps.
#ifdef MPNN_CUDA_EMU
template <int KP>
__device__ inline void row_sync(int r) {
  if constexpr (reg_lanes(KP) == 32) {
    __syncwarp();
  } else {
    emu_named_sync(1 + r, reg_lanes(KP));
  }
}
#else
template <int KP>
__device__ __forceinline__ void row_sync(int r) {
  if constexpr (reg_lanes(KP) == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + r), "n"(reg_lanes(KP))
                 : "memory");
  }
}
#endif

// The panel route's layer: for every (own column j, group of kRT rows) of
// the block, epi(r, j, Σ_k src[r][k]·w(k, j)) over round4(pf) inputs, in
// dot4's orders (kSeq: the forward's); the weights come from the staged
// panel (kL2: from device memory, zero past pf, the staged panel's
// padding), one load serving kRT rows; the k loop is unrolled by 4 so
// that its loads are in flight together.
template <bool kSeq, bool kL2, class Epi>
__device__ __forceinline__ void panel_layer(const Geom& g, const float* src,
                                            Epi epi) {
  const int groups = g.rbp / kRT, n4 = round4(g.pf) / 4, sk = g.wk;
  const int ld4 = g.ld / 4;
  for (int item = threadIdx.x; item < g.own * groups; item += blockDim.x) {
    const int j = item % g.own, r0 = (item / g.own) * kRT;
    const float* wj = g.wp + j * g.wj;
    const float4* rows = reinterpret_cast<const float4*>(src) + r0 * ld4;
    float a[kRT][4];
#pragma unroll
    for (int r = 0; r < kRT; ++r)
      a[r][0] = a[r][1] = a[r][2] = a[r][3] = 0.f;
#pragma unroll 4
    for (int k4 = 0; k4 < n4; ++k4) {
      const float* wk = wj + 4 * k4 * sk;
      float w0, w1, w2, w3;
      if constexpr (kL2) {
        const int k = 4 * k4;
        w0 = __ldg(wk);
        w1 = k + 1 < g.pf ? __ldg(wk + sk) : 0.f;
        w2 = k + 2 < g.pf ? __ldg(wk + 2 * sk) : 0.f;
        w3 = k + 3 < g.pf ? __ldg(wk + 3 * sk) : 0.f;
      } else {
        w0 = wk[0];
        w1 = wk[sk];
        w2 = wk[2 * sk];
        w3 = wk[3 * sk];
      }
#pragma unroll
      for (int r = 0; r < kRT; ++r) {
        const float4 v = rows[r * ld4 + k4];
        if constexpr (kSeq) {
          a[r][0] = fmaf(v.x, w0, a[r][0]);
          a[r][0] = fmaf(v.y, w1, a[r][0]);
          a[r][0] = fmaf(v.z, w2, a[r][0]);
          a[r][0] = fmaf(v.w, w3, a[r][0]);
        } else {
          a[r][0] = fmaf(v.x, w0, a[r][0]);
          a[r][1] = fmaf(v.y, w1, a[r][1]);
          a[r][2] = fmaf(v.z, w2, a[r][2]);
          a[r][3] = fmaf(v.w, w3, a[r][3]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRT; ++r)
      epi(r0 + r, j, kSeq ? a[r][0]
                          : (a[r][0] + a[r][1]) + (a[r][2] + a[r][3]));
  }
}

// A register-route thread's weights, from the staged W_s (wp, rows wld
// apart, zero past pf) once: its column c (the forward) or row c (the
// reverse walk, in 16-byte loads); zero past pf.
template <int KP>
__device__ inline void load_w(const Geom& g, bool row, float (&w)[KP]) {
  const int c = int(threadIdx.x) % reg_lanes(KP);
  if (row && c < g.pf) {
    const float4* wr = reinterpret_cast<const float4*>(g.wp + c * g.wld);
#pragma unroll
    for (int j = 0; j < KP / 4; ++j) {
      const float4 v = wr[j];
      w[4 * j] = v.x;
      w[4 * j + 1] = v.y;
      w[4 * j + 2] = v.z;
      w[4 * j + 3] = v.w;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < KP; ++k)
    w[k] = !row && k < g.pf && c < g.pf ? g.wp[k * g.wld + c] : 0.f;
}

// The probe layer's input-row loads alone (block 0, thread 0, the register
// route), stamped into m.prof[slot]: the branch on their sum waits for
// every load.
template <int KP>
__device__ inline void probe_loads(const MlpArgs& m, const float* src,
                                   int slot) {
  if (m.prof == nullptr || blockIdx.x != 0 || threadIdx.x != 0) return;
  const float4* row = reinterpret_cast<const float4*>(src);
  unsigned u = 0;                      // an OR tree: no add chain to wait on
#pragma unroll
  for (int j = 0; j < KP / 4; ++j) {
    const float4 v = row[j];
    u |= __float_as_uint(v.x) | __float_as_uint(v.y) | __float_as_uint(v.z) |
         __float_as_uint(v.w);
  }
  if (u == 0x12345u) m.prof[kProfSlots - 1] = 0;
  m.prof[slot] = clock64();
}

// The forward chain from exchange buffer 0 (the input rows, staged): H head
// layers, one block barrier after each, then T tail layers; the pen rows
// end in exchange buffer (H + T) mod 2 of every block of the cluster. On
// the register route a row's threads (one warp, or two past pf 32)
// compute it alone, thread c its column c (W_s's column in `w`), so a
// tail layer ends with the row's own barrier; on the panel route a
// layer's rows go to every block of the cluster and end with a cluster
// barrier (the l2 route: kL2, W_s's panel read from device memory). With
// `stash` (the backward's recompute) each head layer's input is kept in hy,
// y_H and every tail output's own columns in ty. Block 0's thread 0 stamps
// the probe layer T / 2 into m.prof[3..6].
template <int KP, bool kCluster, bool kL2>
__device__ inline void chain_forward(
    const MlpArgs& m, const Plan& p, const Geom& g, const Cta<kCluster>& cta,
    float* sm, const float (&w)[KP > 0 ? KP : 1], bool stash) {
  const int H = m.n_head, T = m.tail, probe_t = m.prof ? T / 2 : -1;
  auto keep = [&](int h) {             // a head layer's input rows
    if (!stash) return;
    const int wd = m.dims[h], ldh = round4(wd);
    for (int i = threadIdx.x; i < g.rbp * wd; i += blockDim.x)
      sm[p.hy[h] + (i / wd) * ldh + i % wd] =
          g.xb(h)[(i / wd) * g.ld + i % wd];
  };
  for (int h = 0; h < H; ++h) {
    keep(h);
    head_layer(m, p, sm, h, g.xb(h), g.xb(h + 1));
    __syncthreads();
  }
  keep(H);
  if (stash) {                         // y_H's own columns: tail slot 0
    for (int i = threadIdx.x; i < g.rbp * g.pp; i += blockDim.x) {
      const int r = i / g.pp, j = i % g.pp;
      g.ty[i] = j < g.own ? g.xb(H)[r * g.ld + g.c0 + j] : 0.f;
    }
  }
  // the head ran in each block alone: no peer may write the next buffer
  // (a head layer's input) before every block is past it
  cta.sync();
  const int slot = g.rbp * g.pp;       // floats of a stash slot
  if constexpr (KP > 0) {
    const int r = int(threadIdx.x) / reg_lanes(KP);
    const int c = int(threadIdx.x) % reg_lanes(KP);
    float* const row0 = g.xb0 + r * g.ld;
    float* const row1 = g.xb1 + r * g.ld;
    float* st = g.ty + slot + r * g.pp + c;
    for (int t = 0; t < T; ++t) {
      const bool odd = (H + t) & 1;
      const float* src = odd ? row1 : row0;
      if (t == probe_t) {
        stamp(m, 3);
        probe_loads<KP>(m, src, 4);
      }
      const float v =
          c < g.pf ? fmaxf(reg_dot<KP, true>(src, w), 0.f) : 0.f;
      if (c < g.pf) (odd ? row0 : row1)[c] = v;
      if (stash && c < KP) *st = v;    // the stash's padding gets zeros
      st += slot;
      if (t == probe_t) stamp(m, 5);
      row_sync<KP>(r);
      if (t == probe_t) stamp(m, 6);
    }
    __syncthreads();
  } else {
    for (int t = 0; t < T; ++t) {
      const int l = (H + t) & 1;
      float* const st = g.ty + (t + 1) * slot;
      float* const dst = g.xb(l ^ 1) + g.c0;
      if (t == probe_t) {
        stamp(m, 3);
        stamp(m, 4);
      }
      panel_layer<true, kL2>(g, g.xb(l), [&](int r, int j, float s) {
        const float v = fmaxf(s, 0.f);
        for (int q = 0; q < cta.size; ++q)
          cta.peer(dst, q)[r * g.ld + j] = v;
        if (stash) st[r * g.pp + j] = v;
      });
      if (t == probe_t) stamp(m, 5);
      cta.sync();
      if (t == probe_t) stamp(m, 6);
    }
  }
}

// ---- host side: the launch ------------------------------------------------

// The chain's arguments; the weight pointers may be null (for the layout,
// shared-memory and scratch queries, which read only the widths).
inline MlpArgs mlp_args(const float* x, const float* const* hw,
                        const float* const* hb, const float* ws,
                        const int* dims, int n_head, int rows, int tail,
                        int rb, int cluster, int l2, long long* prof) {
  MlpArgs m{};
  for (int i = 0; hw != nullptr && i < n_head; ++i) {
    m.hw[i] = hw[i];
    m.hb[i] = hb[i];
  }
  for (int i = 0; i <= n_head; ++i) m.dims[i] = dims[i];
  m.x = x;
  m.ws = ws;
  m.rows = rows;
  m.n_head = n_head;
  m.tail = tail;
  m.rb = rb;
  m.cluster = cluster;
  m.l2 = l2;
  m.prof = prof;
  return m;
}

// Whether (kp, rb, cluster, l2) is a launch of the kernels'
// (kernels/edge_mlp.py::launch_shape picks it): a register-route block
// has at most 15 rows, one named barrier each; the l2 route runs in
// clusters of more than one block.
inline bool shape_ok(const MlpArgs& m, int kp) {
  const int pf = pf_of(m);
  if (m.n_head < 0 || m.n_head > kMaxHead || m.rows < 1 || m.tail < 0 ||
      m.rb < 1 || (m.l2 != 0 && m.l2 != 1))
    return false;
  if (kp > 0)
    return kp == round8(pf) && pf <= kRegMaxPf && m.cluster == 1 &&
           !m.l2 && reg_lanes(kp) * m.rb <= reg_max_threads(kp) && m.rb < 16;
  return pf > kRegMaxPf && (m.cluster == 1 || m.cluster == 2 ||
                            m.cluster == 4 || m.cluster == 8) &&
         (!m.l2 || m.cluster > 1);
}

inline int threads_of(const MlpArgs& m, int kp) {
  return kp > 0 ? reg_lanes(kp) * m.rb : kPanelThreads;
}

__host__ __device__ inline int clusters_of(const MlpArgs& m) {
  return (m.rows + m.rb - 1) / m.rb;
}

using mpnn_smem::allow_smem;

// Launch `kernel` on `grid` blocks of `threads` with `bytes` of dynamic
// shared memory: in clusters of `cdim` blocks (the panel route), or plain.
template <class Kernel, class Args>
cudaError_t launch(Kernel kernel, bool cluster, int grid, int threads,
                   size_t bytes, cudaStream_t stream, int cdim, Args args) {
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  if (!cluster) {
    kernel<<<grid, threads, bytes, stream>>>(args);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cdim;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The empty-chain floor: the grid, block, cluster and shared memory of a
// launch, and `layers` layers that do nothing but the launch's barrier: a
// register-route row's (`lanes` 32 or 64 threads), else the block's or
// the cluster's.
struct FloorArgs {
  int layers, lanes;
};

template <bool kCluster>
__global__ void edge_mlp_floor_kernel(FloorArgs a) {
  const Cta<kCluster> cta;
  const int r = int(threadIdx.x) / (a.lanes > 0 ? a.lanes : 1);
  for (int l = 0; l < a.layers; ++l) {
    if (a.lanes == 32)
      __syncwarp();
    else if (a.lanes == 64)
      row_sync<64>(r);
    else
      cta.sync();
  }
}

// Launch the empty-chain floor of a launch shape: `layers` layers.
inline int launch_floor(const MlpArgs& m, int kp, size_t bytes, int layers,
                        void* stream) {
  const FloorArgs a{layers, kp > 0 ? reg_lanes(kp) : 0};
  const int cl = m.cluster;
  return int(launch(cl > 1 ? edge_mlp_floor_kernel<true>
                           : edge_mlp_floor_kernel<false>,
                    cl > 1, clusters_of(m) * cl, threads_of(m, kp), bytes,
                    static_cast<cudaStream_t>(stream), cl, a));
}

}  // namespace mpnn_mlp
