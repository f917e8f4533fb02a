// Shared pieces of the set2vec readout kernels (set2vec_fwd.cu,
// set2vec_bwd.cu).
//
// Work mapping, the same in every step and in both kernels: block b owns a
// contiguous range of graphs, [b·G/grid, (b+1)·G/grid), and the node rows
// of those graphs; the graph at offset i of the range belongs to warp
// i mod warps. A graph's LSTM and query run on its warp with lane l on
// features l + 32·r (r < KP); its nodes' energies with a lane per node; its
// read with a lane per feature (two half-warps over alternate nodes when
// w <= 16).
//
// Everything a step's serial chain reads is on chip: the weights, the
// block's x rows (staged once per launch with cp.async), each graph's
// carry and softmax statistics (a slot in shared memory), the energies.
// A block whose rows do not fit its staging capacity (`cap` rows, fixed by
// the host from the shapes: kernels/set2vec.py::launch_shape) streams them
// through it in chunks of `cap` rows every step: the chunked route. A block
// with more graphs than its shared memory holds slots for keeps the slots
// in its own region of global scratch instead (the spilled route; the
// backward then reads the stash rows where they lie): the same code through
// generic pointers, for batches past ~1,000 graphs at w 64.
//
// The batch-global softmax is the one statistic that crosses blocks. A
// block publishes its partial for step t as ONE 64-bit word in its own
// slot of a (T, grid) array, reset to kEmpty at launch (then one grid
// barrier); the word carries its own validity, so the combine is the only
// wait that crosses blocks: warp 0 of every block reads all blocks' words
// of step t, spinning on the ones still empty, and combines them in a
// fixed order — every block computes the same totals. One block (the whole
// batch, G <= 32) combines in shared memory. No float atomics anywhere.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mpnn_s2v {

namespace cg = cooperative_groups;

// the widest set of the build: kernels/set2vec.py::BUCKETS
#ifndef MPNN_WP
#define MPNN_WP 32
#endif
constexpr int WP = MPNN_WP;
static_assert(WP == 32 || WP == 64, "a bucket is 32 or 64 features wide");
constexpr int kMaxWarps = 16;                 // kernels/set2vec.py::MAX_WARPS
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kEmpty = ~0ull;  // a partial not yet published

// Sizes in floats; every region of shared memory is a multiple of 4
// floats, so each starts 16-byte aligned (the bulk copies' rule).
__host__ __device__ constexpr int al4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int pad8(int n) { return (n + 7) & ~7; }
// The forward's training stash, one row per (step, graph): the step's
// input carry and what the backward would otherwise recompute,
// [mh | mr | c | i f g o | q], each w wide.
__host__ __device__ constexpr int stash_width(int W) { return al4(8 * W); }
// features a lane holds in the LSTM mapping
__host__ __device__ constexpr int kpl(int WB) { return (WB + 31) / 32; }

struct S2vWeights {
  const float* w[4];   // w_h{i,f,g,o} (2w, w): gate = [mh ‖ mr]·W + b
  const float* b[4];   // b_h{i,f,g,o} (1, w)
  const float* wq;     // (w, w): q = h·Wq
  const float* we;     // (w, 1): e = tanh(q + x)·we
};

// ---------------------------------------------------------------------------
// staging
// ---------------------------------------------------------------------------

// The weights in shared memory for a kernel's width bound WB (16, 32 or
// 64), zero-padded to WB, all offsets compile-time: the gate matrices in
// two pairs (i, f) and (g, o), rows [g][half][k] RSB = WB + 1 floats apart
// (odd: a warp reading a column, lane k at row k, hits 32 banks; half 0
// the inputs mh, 1 mr), the biases [g][j], Wq [k][j] and we [j]. At WB 16
// the two half-warps read the two pairs (or Wq's two halves) at once, so
// the second pair starts 16 floats past a bank-row boundary and Wq's rows
// are 18 floats apart: no access of the kernels meets a bank conflict.
// kernels/set2vec.py::smem_floats mirrors the size.
__host__ __device__ constexpr int gate_pair(int WB) {
  return 4 * WB * (WB + 1) + (WB == 16 ? 16 : 0);
}
__host__ __device__ constexpr int wq_stride(int WB) {
  return WB == 16 ? 18 : WB + 1;
}
__host__ __device__ constexpr int weights_floats(int WB) {
  return al4(2 * gate_pair(WB)) + 4 * WB + al4(WB * wq_stride(WB)) + WB;
}

template <int WB>
struct WL {
  static constexpr int RSB = WB + 1, RSQ = wq_stride(WB);
  static constexpr int PAIR = gate_pair(WB);
  static constexpr int gates = 0;
  static constexpr int bias = al4(2 * PAIR);
  static constexpr int wq = bias + 4 * WB;
  static constexpr int we = wq + al4(WB * RSQ);
  static constexpr int total = we + WB;
  static_assert(total == weights_floats(WB), "the weights' layout");
  __host__ __device__ static constexpr int row(int g, int half, int k) {
    return (g >> 1) * PAIR + (((g & 1) * 2 + half) * WB + k) * RSB;
  }
};

// Every thread of the block stages the weights of WL<WB> at sw.
template <int WB>
__device__ void stage_weights(float* sw, const S2vWeights& w, int W) {
  using L = WL<WB>;
  constexpr int RSB = L::RSB, RSQ = L::RSQ, PAIR = L::PAIR;
  for (int i = threadIdx.x; i < 2 * PAIR; i += blockDim.x) {
    const int p = i / PAIR, o = i - p * PAIR;
    const int r = o / RSB, j = o - r * RSB;    // row in the pair
    const int gh = r / WB, k = r - gh * WB;      // gate of the pair, half
    const bool in = r < 4 * WB && k < W && j < W;
    sw[L::gates + i] =
        in ? w.w[2 * p + (gh >> 1)][((gh & 1) * W + k) * W + j] : 0.f;
  }
  for (int i = threadIdx.x; i < 4 * WB; i += blockDim.x) {
    const int g = i / WB, j = i - g * WB;
    sw[L::bias + i] = j < W ? w.b[g][j] : 0.f;
  }
  for (int i = threadIdx.x; i < WB * RSQ; i += blockDim.x) {
    const int k = i / RSQ, j = i - k * RSQ;
    sw[L::wq + i] = (k < W && j < W) ? w.wq[k * W + j] : 0.f;
  }
  for (int i = threadIdx.x; i < WB; i += blockDim.x)
    sw[L::we + i] = i < W ? w.we[i] : 0.f;
}

// ---------------------------------------------------------------------------
// asynchronous copies, barriers, the published partials
// (scripts/cuda_emu/cuda_runtime.h has the CPU stand-ins)
// ---------------------------------------------------------------------------

#ifdef MPNN_CUDA_EMU
__device__ inline void cp_async4(float* d, const float* s) {
  emu_cp_async4(d, s);
}
__device__ inline void cp_async_wait_all() { emu_cp_async_wait_all(); }
__device__ inline void mbar_init(uint64_t* bar, unsigned count) {
  emu_mbar_init(bar, count);
}
__device__ inline void mbar_fence_init() {}
__device__ inline void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
  emu_mbar_arrive_tx(bar, bytes);
}
__device__ inline bool mbar_try_wait(uint64_t* bar, unsigned parity) {
  return emu_mbar_try_wait(bar, parity);
}
__device__ inline void bulk_g2s(void* dst, const void* src, unsigned bytes,
                                uint64_t* bar) {
  emu_bulk_g2s(dst, src, bytes, bar);
}
__device__ inline unsigned long long ld_relaxed(
    const unsigned long long* p) {
  return emu_ld_relaxed(p);
}
__device__ inline void st_relaxed(unsigned long long* p,
                                  unsigned long long v) {
  emu_st_relaxed(p, v);
}
__device__ inline void spin_pause() { emu_spin_pause(); }
#else
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 4 bytes global → shared, completed by cp_async_wait_all
__device__ __forceinline__ void cp_async4(float* d, const float* s) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(d)),
               "l"(s)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also expects `bytes` of bulk copies in this phase
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n"
      " .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}
// a TMA bulk copy global → shared (16-byte aligned, a multiple of 16
// bytes), completing `bytes` of the barrier's expected transactions
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}
__device__ __forceinline__ void spin_pause() {}
#endif

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  while (!mbar_try_wait(bar, parity)) spin_pause();
}

// Rows [r0, r1) of x (N, W) into xs, row stride XS, zero-padded to W8
// features; complete after cp_async_wait_all. Every thread calls it.
__device__ void stage_rows(float* xs, const float* x, int r0, int r1, int W,
                           int W8, int XS) {
  const int n = (r1 - r0) * W8;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / W8, j = i - r * W8;
    float* d = xs + r * XS + j;
    if (j < W)
      cp_async4(d, x + size_t(r0 + r) * W + j);
    else
      *d = 0.f;
  }
}

__device__ __forceinline__ float warp_sum_(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_max_(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Two floats as one published word; a NaN takes one canonical pattern, so
// no word equals kEmpty.
__device__ __forceinline__ unsigned long long pack2(float lo, float hi) {
  const unsigned nan = 0x7fc00000u;
  const unsigned a = lo != lo ? nan : __float_as_uint(lo);
  const unsigned b = hi != hi ? nan : __float_as_uint(hi);
  return (static_cast<unsigned long long>(b) << 32) | a;
}
__device__ __forceinline__ float word_lo(unsigned long long v) {
  return __uint_as_float(static_cast<unsigned>(v));
}
__device__ __forceinline__ float word_hi(unsigned long long v) {
  return __uint_as_float(static_cast<unsigned>(v >> 32));
}

// The most blocks a launch takes (kernels/set2vec.py::MAX_GRID): a lane
// of warp 0 reads kWords published words of a step. Each word has a
// 128-byte line of its own (kWordStride words apart): all blocks poll a
// step's row at once, and on a few shared lines they would queue.
constexpr int kMaxGrid = 256;
constexpr int kWords = kMaxGrid / 32;
constexpr int kWordStride = 16;
__host__ __device__ constexpr size_t word_at(int t, int grid, int b) {
  return (size_t(t) * grid + b) * kWordStride;
}

// Warp 0 of a block: every block's word of a step (row: word_at(t, grid,
// 0)) into v — word
// lane + 32·k in v[k], 0 past the grid — each lane's loads issued
// together, the ones still empty issued again until none is.
__device__ __forceinline__ void gather_words(unsigned long long* row,
                                             int grid, int lane,
                                             unsigned long long (&v)[kWords]) {
#pragma unroll
  for (int k = 0; k < kWords; ++k)
    v[k] = lane + 32 * k < grid
               ? ld_relaxed(row + (lane + 32 * k) * kWordStride)
               : 0ull;
  for (;;) {
    bool empty = false;
#pragma unroll
    for (int k = 0; k < kWords; ++k) empty |= v[k] == kEmpty;
    if (!empty) break;
    spin_pause();
#pragma unroll
    for (int k = 0; k < kWords; ++k)
      if (v[k] == kEmpty)
        v[k] = ld_relaxed(row + (lane + 32 * k) * kWordStride);
  }
}

// Warp 0 of a block: this block's softmax partial (m, s) published in its
// slot of the step's row (row = part + word_at(t, grid, 0)).
__device__ __forceinline__ void publish(unsigned long long* row, int lane,
                                        float m, float s) {
  if (lane == 0) st_relaxed(row + blockIdx.x * kWordStride, pack2(m, s));
}

// Warp 0 of a block: the softmax totals over every block's published
// partial of the step: m = the largest maximum, s = Σ s_b·exp(m_b − m)
// over blocks with s_b > 0; lanes take blocks lane, lane + 32, ... and the
// butterflies finish, the same order in every block.
__device__ void gather_softmax(unsigned long long* row, int grid, int lane,
                               float& m, float& s) {
  unsigned long long v[kWords];
  gather_words(row, grid, lane, v);
  float mm = -INFINITY;
#pragma unroll
  for (int k = 0; k < kWords; ++k)
    if (lane + 32 * k < grid) mm = fmaxf(mm, word_lo(v[k]));
  mm = warp_max_(mm);
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const float sb = word_hi(v[k]);
    if (lane + 32 * k < grid && sb > 0.f)
      ss += sb * expf(word_lo(v[k]) - mm);
  }
  m = mm;
  s = warp_sum_(ss);
}

// Warp 0 of a block: the sum of every block's published value of a step
// (lanes over blocks, then the butterflies: one order in every block).
__device__ float sum_words(unsigned long long* row, int grid, int lane) {
  unsigned long long v[kWords];
  gather_words(row, grid, lane, v);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kWords; ++k)
    if (lane + 32 * k < grid) s += word_lo(v[k]);
  return warp_sum_(s);
}

__device__ __forceinline__ float sigmoid_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// a float4 from 16-byte aligned shared memory, as four floats
__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// Two half-warps share a graph's features at WB 16: lane l works for
// feature l & 15, half l >> 4 on half of the gates (or of a sum's terms).
template <int WB>
struct Lanes {
  static constexpr bool kHalf = WB == 16;
  static constexpr int KP = kpl(WB);       // features a lane holds
  static constexpr int NG = kHalf ? 2 : 4;  // gates a lane computes
  int j0, gh;                              // feature lane's (r = 0), half
  __device__ explicit Lanes(int lane)
      : j0(kHalf ? lane & 15 : lane), gh(kHalf ? lane >> 4 : 0) {}
};

// A graph's gate pre-activations at this lane (features j0 + 32·r, its
// NG gates): from the carry's mh and from its mr, two independent chains of
// sums.
template <int WB>
struct Pre {
  float h[kpl(WB)][Lanes<WB>::NG], r[kpl(WB)][Lanes<WB>::NG];
};

// The pre-activations of one graph's LSTM step on its warp, from its slot
// s ([mh | mr | c | q], WB each, zero past w; weights staged by
// stage_weights at sw): the carry read as float4 broadcasts, unrolled to
// WB in fours; at WB 16 half 0 computes gates i, f and half 1 g, o.
template <int WB>
__device__ __forceinline__ void lstm_pre(const float* sw, const float* s,
                                         int W, int lane, Pre<WB>& p) {
  using L = WL<WB>;
  using LN = Lanes<WB>;
  constexpr int KP = LN::KP, NG = LN::NG;
  const LN ln(lane);
  const float* wl = sw + L::gates + L::row(2 * ln.gh, 0, 0) + ln.j0;
#pragma unroll
  for (int r = 0; r < KP; ++r)
#pragma unroll
    for (int gi = 0; gi < NG; ++gi) {
      p.h[r][gi] = sw[L::bias + (2 * ln.gh + gi) * WB + ln.j0 + 32 * r];
      p.r[r][gi] = 0.f;
    }
#pragma unroll
  for (int k0 = 0; k0 < WB; k0 += 4) {
    if (k0 >= W) break;
    float xh[4], xr[4];
    ld4(s + k0, xh);
    ld4(s + WB + k0, xr);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < KP; ++r)
#pragma unroll
        for (int gi = 0; gi < NG; ++gi) {
          p.h[r][gi] = fmaf(xh[kk], wl[L::row(gi, 0, k0 + kk) + 32 * r],
                            p.h[r][gi]);
          p.r[r][gi] = fmaf(xr[kk], wl[L::row(gi, 1, k0 + kk) + 32 * r],
                            p.r[r][gi]);
        }
  }
}

// The rest of the step from the pre-activations: the activations — at WB 16 exchanged between the halves — c, h
// and q = h·Wq (at WB 16 the halves split the k range). Every lane ends
// with its features' input carry, gates and query, for the training
// stash; s holds h, c and q (mr is left to the node phase).
template <int WB>
__device__ __forceinline__ void lstm_post(
    const float* sw, float* s, int W, int lane, const Pre<WB>& p,
    float (&mh)[kpl(WB)], float (&mr)[kpl(WB)],
    float (&c)[kpl(WB)], float (&act)[kpl(WB)][4], float (&q)[kpl(WB)]) {
  using L = WL<WB>;
  using LN = Lanes<WB>;
  constexpr int KP = LN::KP, NG = LN::NG;
  const LN ln(lane);
#pragma unroll
  for (int r = 0; r < KP; ++r) {
    float av[NG];
#pragma unroll
    for (int gi = 0; gi < NG; ++gi) {
      const float x = p.h[r][gi] + p.r[r][gi];
      av[gi] = 2 * ln.gh + gi == 2 ? tanhf(x) : sigmoid_(x);
    }
    if constexpr (LN::kHalf) {
      const float o0 = __shfl_xor_sync(kFull, av[0], 16);
      const float o1 = __shfl_xor_sync(kFull, av[1], 16);
      act[r][0] = ln.gh ? o0 : av[0];
      act[r][1] = ln.gh ? o1 : av[1];
      act[r][2] = ln.gh ? av[0] : o0;
      act[r][3] = ln.gh ? av[1] : o1;
    } else {
#pragma unroll
      for (int g = 0; g < 4; ++g) act[r][g] = av[g];
    }
  }
  float h[KP], cn[KP];
#pragma unroll
  for (int r = 0; r < KP; ++r) {
    const int j = ln.j0 + 32 * r;
    mh[r] = s[j];
    mr[r] = s[WB + j];
    c[r] = s[2 * WB + j];
    cn[r] = act[r][1] * c[r] + act[r][0] * act[r][2];
    h[r] = act[r][3] * tanhf(cn[r]);
  }
  __syncwarp();                            // every lane's reads of s done
#pragma unroll
  for (int r = 0; r < KP; ++r) {
    const int j = ln.j0 + 32 * r;
    if (ln.gh == 0 && j < W) {
      s[j] = h[r];
      s[2 * WB + j] = cn[r];
    }
  }
  __syncwarp();
  // q = h·Wq from the new h, a float4 broadcast at a time
  constexpr int KQ = LN::kHalf ? WB / 2 : WB;    // k range of a half
  constexpr int RSQ = L::RSQ;
  const int kb = ln.gh * KQ;
  const float* wq = sw + L::wq + kb * RSQ + ln.j0;
#pragma unroll
  for (int r = 0; r < KP; ++r) q[r] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < KQ; k0 += 4) {
    if (kb + k0 >= W) break;
    float hk[4];
    ld4(s + kb + k0, hk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < KP; ++r)
        q[r] = fmaf(hk[kk], wq[(k0 + kk) * RSQ + 32 * r], q[r]);
  }
  if constexpr (LN::kHalf) q[0] += __shfl_xor_sync(kFull, q[0], 16);
}

// tanh for the energies and their VJP, 1 − 2/(e^{2x} + 1) from the
// hardware's exp2 and reciprocal: within ~2^-22 of tanh, absolute (the
// energies it sums are held to 1e-4 relative), five instructions where
// tanhf takes about twenty.
__device__ __forceinline__ float tanh_fast(float x) {
  x = fminf(fmaxf(x, -15.f), 15.f);
  return 1.0f - __fdividef(2.0f, __expf(2.0f * x) + 1.0f);
}

// e = Σ_j we[j]·tanh(q[j] + xr[j]) over the zero-padded W8 features, in
// chunks of 8 unrolled.
__device__ __forceinline__ float energy(const float* we, const float* q,
                                        const float* xr, int W8) {
  float e = 0.f;
  for (int j0 = 0; j0 < W8; j0 += 8) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      e = fmaf(we[j0 + jj], tanh_fast(q[j0 + jj] + xr[j0 + jj]), e);
  }
  return e;
}

// d = Σ_j a[j]·xr[j] over the zero-padded W8 features, chunks of 8.
__device__ __forceinline__ float dot8(const float* a, const float* xr,
                                      int W8) {
  float d = 0.f;
  for (int j0 = 0; j0 < W8; j0 += 8) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) d = fmaf(a[j0 + jj], xr[j0 + jj], d);
  }
  return d;
}

// This block's graphs: [lo, hi).
__device__ __forceinline__ void block_graphs(int G, int& lo, int& hi) {
  lo = int((long long)blockIdx.x * G / gridDim.x);
  hi = int((long long)(blockIdx.x + 1) * G / gridDim.x);
}

// The kernels are instantiated for a width bound WB (w <= WB): 16 or 32 in
// the narrow bucket, 64 in the wide one (kernels/set2vec.py::width_bound).
inline int wb_of(int width) { return WP == 32 && width <= 16 ? 16 : WP; }

template <typename Kernel16, typename KernelWP>
const void* kernel_for_width(int width, Kernel16 k16, KernelWP kwp) {
  return wb_of(width) == 16 ? (const void*)k16 : (const void*)kwp;
}

// A cooperative launch of `grid` blocks of `warps` warps and `bytes` of
// dynamic shared memory, refused (cudaErrorCooperativeLaunchTooLarge)
// when the blocks cannot all be resident at once.
inline cudaError_t launch_coop(const void* kernel, int grid, int warps,
                               size_t bytes, void** args, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, 32 * warps, bytes)) != cudaSuccess)
    return err;
  if (per_sm * sms < grid) return cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(32 * warps),
                                    args, bytes,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace mpnn_s2v
