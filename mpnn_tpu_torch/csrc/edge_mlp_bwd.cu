// Edge-MLP chain backward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mpnn_tpu/kernels/edge_mlp.py::_bwd_kernel (the
// VJP of make_edge_mlp_op). Given g = ∂L/∂pen (R, pf) it recomputes the
// forward chain, stashing the 1 + H + T layer outputs in device memory
// (52·65·64 floats, 0.87 MB, at the design point), then walks it in
// reverse:
//
//   tail, t = T−1..0:  gz = (y_t > 0) ⊙ g;  ∂W_s += x_tᵀ·gz;  g = gz·W_sᵀ
//   head, h = H−1..0:  gz = (y_h > 0) ⊙ g;  ∂W_h += x_hᵀ·gz;  ∂b_h += Σ gz;
//                      g = gz·W_hᵀ
//   ∂x = g            (the per-step family's vocab rows come from its tanh
//                      encoder and input bn1d, so the rows need it)
//
// Design: ONE cooperative launch with the forward's work mapping
// (edge_mlp_common.cuh: a block per group of 4 rows, the rows' activations
// and cotangents in shared memory, one __syncthreads() per layer). Each
// weight-gradient element is owned by one thread of the block, which adds
// its group's kRows rows in order: ∂W_s in shared memory (pf <= 128) or the
// block's row of device memory, the head gradients in that row. After one
// grid barrier every element is summed over the blocks in block order. No
// float atomics: the sums do not depend on the schedule.
//
// Bound on an H100: about twice the forward's multiply-adds plus ∂x (~55
// MFLOP at the design point) and ~1 MB of stash written and read; the
// 2·(1 + H + T) dependent layers in series are what it costs.

#include "edge_mlp_common.cuh"

namespace {

using namespace mpnn_mlp;

// Flat layout of the gradient output and of each block's partial row, in
// make_edge_mlp_op's order: the head weights, the head biases, W_s.
// kernels/edge_mlp.py::grad_layout mirrors it.
struct GradLayout {
  int hw[kMaxHead], hb[kMaxHead], ws, total;
  __host__ __device__ explicit GradLayout(const MlpArgs& m) {
    int off = 0;
    for (int i = 0; i < m.n_head; ++i) {
      hw[i] = off;
      off += m.dims[i] * m.dims[i + 1];
    }
    for (int i = 0; i < m.n_head; ++i) {
      hb[i] = off;
      off += m.dims[i + 1];
    }
    ws = off;
    total = off + pf_of(m) * pf_of(m);
  }
};

struct BwdArgs {
  MlpArgs m;
  const float* gpen;              // (R, pf)
  float* dx;                      // (R, ef)
  float* dw;                      // GradLayout.total
  float* scratch;                 // acts (1+H+T)·R·mw, then grid·total
};

__host__ __device__ inline size_t acts_floats(const MlpArgs& m) {
  return size_t(1 + m.n_head + m.tail) * m.rows * max_width(m);
}

// Stage the group's cotangents gz = (y > 0) ⊙ g of one layer (width n_out,
// outputs in stash slot `sy`) and the layer's inputs (width n_in, slot
// `sx`), zero on padded rows.
__device__ inline void stage_layer(const MlpArgs& m, const float* acts,
                                   int r0, int mw, int sy, int n_out, int sx,
                                   int n_in, const float* g, float* gz,
                                   float* xin) {
  const int nr = min(kRows, m.rows - r0);
  for (int i = threadIdx.x; i < kRows * n_out; i += blockDim.x) {
    const int r = i / n_out, c = i % n_out;
    const float y =
        r < nr ? acts[(size_t(sy) * m.rows + r0 + r) * mw + c] : 0.f;
    gz[r * mw + c] = y > 0.f ? g[r * mw + c] : 0.f;
  }
  for (int i = threadIdx.x; i < kRows * n_in; i += blockDim.x) {
    const int r = i / n_in, k = i % n_in;
    xin[r * mw + k] =
        r < nr ? acts[(size_t(sx) * m.rows + r0 + r) * mw + k] : 0.f;
  }
}

// dW[k·n_out + c] += Σ_r xin[r][k]·gz[r][c] (rows in order), for the
// elements this thread owns (e ≡ tid mod blockDim).
__device__ inline void add_weight_grad(const float* xin, const float* gz,
                                       int n_in, int n_out, int mw,
                                       float* dW) {
#pragma unroll 4
  for (int e = threadIdx.x; e < n_in * n_out; e += blockDim.x) {
    const int k = e / n_out, c = e % n_out;
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      s = fmaf(xin[r * mw + k], gz[r * mw + c], s);
    dW[e] += s;
  }
}

// g[r][k] = Σ_c gz[r][c]·W[k][c], k < n_in, W as weight<kGlobal> reads
// it; the c loop unrolled by 8 as layer()'s k loop is.
template <bool kGlobal>
__device__ inline void back_layer(const float* gz, int n_in, int n_out,
                                  int mw, const float* w, int ldw,
                                  float* g) {
  for (int k = threadIdx.x; k < n_in; k += blockDim.x) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
#pragma unroll 8
    for (int c = 0; c < n_out; ++c) {
      const float wk = weight<kGlobal>(w, ldw, k, c);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        acc[r] = fmaf(gz[r * mw + c], wk, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) g[r * mw + k] = acc[r];
  }
}

__global__ void __launch_bounds__(kThreads)
edge_mlp_bwd_kernel(BwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float sm[];
  const MlpArgs& m = a.m;
  const int pf = pf_of(m), mw = max_width(m), H = m.n_head;
  const GradLayout L(m);
  const bool smem_w = ws_in_smem(pf);
  float* buf0 = sm;                                  // kRows · mw each
  float* buf1 = buf0 + kRows * mw;
  float* g = buf1 + kRows * mw;
  float* xin = g + kRows * mw;
  float* wsm = xin + kRows * mw;                     // pf · (pf + 1)
  float* dws = wsm + size_t(pf) * ws_ld(pf);         // pf · pf
  float* acts = a.scratch;
  float* part = acts + acts_floats(m) + size_t(blockIdx.x) * L.total;
  if (smem_w) {
    stage_ws(m.ws, pf, wsm);
    for (int e = threadIdx.x; e < pf * pf; e += kThreads) dws[e] = 0.f;
  }
  for (int e = threadIdx.x; e < L.total; e += kThreads) part[e] = 0.f;
  float* dW_s = smem_w ? dws : part + L.ws;

  for (int grp = blockIdx.x; grp < n_groups(m.rows); grp += gridDim.x) {
    const int r0 = grp * kRows, nr = min(kRows, m.rows - r0);
    __syncthreads();                                 // buffers free
    load_rows(m, r0, mw, buf0);
    __syncthreads();
    chain_forward(m, r0, buf0, buf1, mw, smem_w ? wsm : nullptr, acts);
    float* gz = buf0;                                // the chain is done
    for (int i = threadIdx.x; i < kRows * pf; i += kThreads) {
      const int r = i / pf, c = i % pf;
      g[r * mw + c] = r < nr ? a.gpen[size_t(r0 + r) * pf + c] : 0.f;
    }
    for (int t = m.tail - 1; t >= 0; --t) {
      __syncthreads();                               // g written
      stage_layer(m, acts, r0, mw, 1 + H + t, pf, H + t, pf, g, gz, xin);
      __syncthreads();
      add_weight_grad(xin, gz, pf, pf, mw, dW_s);
      if (smem_w)
        back_layer<false>(gz, pf, pf, mw, wsm, ws_ld(pf), g);
      else
        back_layer<true>(gz, pf, pf, mw, m.ws, pf, g);
    }
    for (int h = H - 1; h >= 0; --h) {
      const int n_in = m.dims[h], n_out = m.dims[h + 1];
      __syncthreads();
      stage_layer(m, acts, r0, mw, 1 + h, n_out, h, n_in, g, gz, xin);
      __syncthreads();
      add_weight_grad(xin, gz, n_in, n_out, mw, part + L.hw[h]);
      for (int c = threadIdx.x; c < n_out; c += kThreads) {
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) s += gz[r * mw + c];
        part[L.hb[h] + c] += s;
      }
      back_layer<true>(gz, n_in, n_out, mw, m.hw[h], n_out, g);
    }
    __syncthreads();
    const int ef = m.dims[0];
    for (int i = threadIdx.x; i < nr * ef; i += kThreads)
      a.dx[size_t(r0) * ef + i] = g[(i / ef) * mw + i % ef];
  }
  if (smem_w) {
    __syncthreads();
    for (int e = threadIdx.x; e < pf * pf; e += kThreads)
      part[L.ws + e] = dws[e];
  }

  // ---- the blocks' rows summed in block order ---------------------------
  grid.sync();
  float* parts = acts + acts_floats(m);
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < L.total;
       e += gridDim.x * kThreads) {
    float s = 0.f;
    for (int b = 0; b < int(gridDim.x); ++b)
      s += __ldcg(parts + size_t(b) * L.total + e);
    a.dw[e] = s;
  }
}

size_t smem_bytes(const MlpArgs& m) {
  const int pf = pf_of(m);
  return sizeof(float) *
         (4 * size_t(kRows) * max_width(m) +
          (ws_in_smem(pf) ? size_t(pf) * ws_ld(pf) + size_t(pf) * pf : 0));
}

// The chain's arguments; the weight pointers may be null (for the layout,
// grid and scratch queries, which read only the widths).
MlpArgs mlp_args(const float* x, const float* const* hw,
                 const float* const* hb, const float* ws, const int* dims,
                 int n_head, int rows, int tail) {
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
  return m;
}

bool valid(int n_head, int rows, int tail) {
  return n_head >= 0 && n_head <= kMaxHead && rows >= 1 && tail >= 0;
}

}  // namespace

extern "C" {

// The n_head offsets of the head weights, of the head biases, of W_s and
// the total of the flat gradient layout (GradLayout), into `out`.
void mpnn_edge_mlp_bwd_layout(const int* dims, int n_head, int* out) {
  const MlpArgs m = mlp_args(nullptr, nullptr, nullptr, nullptr, dims,
                             n_head, 1, 0);
  const GradLayout L(m);
  int i = 0;
  for (int h = 0; h < n_head; ++h) out[i++] = L.hw[h];
  for (int h = 0; h < n_head; ++h) out[i++] = L.hb[h];
  out[i++] = L.ws;
  out[i] = L.total;
}

// Blocks of the cooperative launch: all co-resident blocks, capped at the
// row groups. 0 on error.
int mpnn_edge_mlp_bwd_grid(const int* dims, int n_head, int rows) {
  if (!valid(n_head, rows, 0)) return 0;
  const MlpArgs m = mlp_args(nullptr, nullptr, nullptr, nullptr, dims,
                             n_head, rows, 0);
  const size_t bytes = smem_bytes(m);
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaFuncSetAttribute(edge_mlp_bwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(bytes)) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, edge_mlp_bwd_kernel, kThreads, bytes) != cudaSuccess)
    return 0;
  return min(per_sm * sms, n_groups(rows));
}

long long mpnn_edge_mlp_bwd_scratch_floats(const int* dims, int n_head,
                                           int rows, int tail, int grid) {
  const MlpArgs m = mlp_args(nullptr, nullptr, nullptr, nullptr, dims,
                             n_head, rows, tail);
  return (long long)acts_floats(m) + (long long)grid * GradLayout(m).total;
}

// Launches on `stream` and returns the launch's error code (0 = success).
int mpnn_edge_mlp_bwd(const float* x, const float* const* hw,
                      const float* const* hb, const float* ws,
                      const int* dims, int n_head, int rows, int tail,
                      const float* gpen, float* dx, float* dw, float* scratch,
                      int grid, void* stream) {
  if (!valid(n_head, rows, tail) || grid < 1)
    return int(cudaErrorInvalidValue);
  BwdArgs a{mlp_args(x, hw, hb, ws, dims, n_head, rows, tail), gpen, dx, dw,
            scratch};
  const size_t bytes = smem_bytes(a.m);
  cudaError_t err = cudaFuncSetAttribute(
      edge_mlp_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (err != cudaSuccess) return int(err);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((void*)edge_mlp_bwd_kernel, dim3(grid),
                                    dim3(kThreads), args, bytes,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
