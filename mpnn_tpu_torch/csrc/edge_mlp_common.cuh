// Shared pieces of the edge-MLP chain kernels (edge_mlp_fwd.cu,
// edge_mlp_bwd.cu): the argument layout, the row-group work mapping and
// the forward chain that the backward recomputes.
//
// The chain runs on the R = K + 1 edge-vocab rows (the K distinct edge
// feature rows of a batch plus the zero row), ef wide:
//
//   x = relu(x·W_h + b_h)    for the H head layers (ef → … → pf)
//   x = relu(x·W_s)          T times (the reference's 50), one shared W_s
//
// Work mapping: a block owns groups of kRows rows (group i on block
// i mod gridDim.x); the rows of a group live in shared memory for the whole
// chain, and every layer is one pass in which thread c computes output
// column c (c += kThreads) of the group's kRows rows from the staged inputs
// — kRows independent sums per weight read. W_s (pf·pf) is staged in
// shared memory with rows padded to pf + 1 when it fits (pf <= kSmemPf,
// the design point pf <= 64 and up to 128); a wider chain reads W_s from
// device memory through the read-only cache. The head weights are read
// from device memory (each is used once per row). One __syncthreads() per
// layer. No tensor cores: at pf <= 64 a step is 4·64·64 multiply-adds per
// group, and the chain's 51 dependent layers, not the arithmetic, set the
// time.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace mpnn_mlp {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;
constexpr int kRows = 4;          // rows per group
constexpr int kMaxHead = 4;       // head layers (ef 2 at f 32 takes 3)
constexpr int kSmemPf = 128;      // widest W_s staged in shared memory

struct MlpArgs {
  const float* x;                 // (R, ef)
  const float* hw[kMaxHead];      // head layer i: (d_i, d_{i+1})
  const float* hb[kMaxHead];      // (d_{i+1})
  const float* ws;                // (pf, pf)
  int dims[kMaxHead + 1];         // ef = d_0, d_1, …, d_H = pf
  int rows, n_head, tail;
};

__host__ __device__ inline int pf_of(const MlpArgs& a) {
  return a.dims[a.n_head];
}

// Widest layer of the chain (the dims only grow: ef < d_1 < … < pf).
__host__ __device__ inline int max_width(const MlpArgs& a) {
  int w = a.dims[0];
  for (int i = 1; i <= a.n_head; ++i) w = w > a.dims[i] ? w : a.dims[i];
  return w;
}

__host__ __device__ inline bool ws_in_smem(int pf) { return pf <= kSmemPf; }

// Row stride of W_s in shared memory: pf + 1, so a warp reading a row
// (the backward's transposed product) hits distinct banks, as a column
// read does.
__host__ __device__ inline int ws_ld(int pf) { return pf + 1; }

// Stage W_s (pf, pf) into shared memory at `dst`, rows ws_ld(pf) apart.
__device__ inline void stage_ws(const float* ws, int pf, float* dst) {
  const int ld = ws_ld(pf);
  for (int i = threadIdx.x; i < pf * pf; i += blockDim.x)
    dst[(i / pf) * ld + i % pf] = ws[i];
}

// W[k][c] of a layer's weights: in shared memory, rows `ldw` apart, or
// (kGlobal) in device memory through the read-only cache.
template <bool kGlobal>
__device__ __forceinline__ float weight(const float* w, int ldw, int k,
                                        int c) {
  return kGlobal ? __ldg(w + size_t(k) * ldw + c) : w[k * ldw + c];
}

// One layer on a group's staged rows: out[r][c] = relu(Σ_k in[r][k]·W[k][c]
// + b[c]) for c < n_out, rows of `in` and `out` `ld_x` floats apart; W as
// weight<kGlobal> reads it. The k loop is unrolled by 8 so that the loads
// of eight k are in flight together: the layer is one dependent chain, and
// its time is load latency. Every thread of the block calls it; no
// barrier inside.
template <bool kGlobal>
__device__ inline void layer(const float* in, int n_in, float* out,
                             int n_out, int ld_x, const float* w, int ldw,
                             const float* b) {
  for (int c = threadIdx.x; c < n_out; c += blockDim.x) {
    float acc[kRows];
    const float b0 = b ? __ldg(b + c) : 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = b0;
#pragma unroll 8
    for (int k = 0; k < n_in; ++k) {
      const float wk = weight<kGlobal>(w, ldw, k, c);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        acc[r] = fmaf(in[r * ld_x + k], wk, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) out[r * ld_x + c] = fmaxf(acc[r], 0.f);
  }
}

// The forward chain of one row group, from its input rows (zero past R)
// in `buf0`. With `acts` (device memory, (1 + H + T) slots of R rows of
// the widest layer, rows mw apart), every layer's output of the group's
// real rows is also written there, slot 0 the input. Returns the buffer
// that holds the pen rows. `wsm` is the staged W_s or null.
__device__ inline float* chain_forward(const MlpArgs& a, int r0, float* buf0,
                                       float* buf1, int mw, const float* wsm,
                                       float* acts) {
  const int pf = pf_of(a);
  const int nr = min(kRows, a.rows - r0);
  auto stash = [&](int slot, const float* x, int width) {
    if (acts == nullptr) return;
    for (int i = threadIdx.x; i < nr * width; i += blockDim.x) {
      const int r = i / width, c = i % width;
      acts[(size_t(slot) * a.rows + r0 + r) * mw + c] = x[r * mw + c];
    }
  };
  float* in = buf0;
  float* out = buf1;
  stash(0, in, a.dims[0]);
  for (int h = 0; h < a.n_head; ++h) {
    layer<true>(in, a.dims[h], out, a.dims[h + 1], mw, a.hw[h],
                a.dims[h + 1], a.hb[h]);
    __syncthreads();
    stash(1 + h, out, a.dims[h + 1]);
    float* t = in;
    in = out;
    out = t;
  }
  for (int t = 0; t < a.tail; ++t) {
    if (wsm == nullptr)
      layer<true>(in, pf, out, pf, mw, a.ws, pf, nullptr);
    else
      layer<false>(in, pf, out, pf, mw, wsm, ws_ld(pf), nullptr);
    __syncthreads();
    stash(1 + a.n_head + t, out, pf);
    float* s = in;
    in = out;
    out = s;
  }
  return in;
}

// Load the group's input rows (zero past R and past ef) into buf.
__device__ inline void load_rows(const MlpArgs& a, int r0, int mw,
                                 float* buf) {
  const int ef = a.dims[0];
  for (int i = threadIdx.x; i < kRows * mw; i += blockDim.x) {
    const int r = i / mw, c = i % mw;
    buf[i] = (r0 + r < a.rows && c < ef) ? a.x[size_t(r0 + r) * ef + c]
                                         : 0.f;
  }
}

__host__ __device__ inline int n_groups(int rows) {
  return (rows + kRows - 1) / kRows;
}

}  // namespace mpnn_mlp
