// Edge-MLP chain forward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mpnn_tpu/kernels/edge_mlp.py::_fwd_kernel (the
// forward of make_edge_mlp_op): the edge network's head layers and its
// weight-shared relu tail on the R = K + 1 edge-vocab rows,
//
//   x = relu(x·W_h + b_h)  (H head layers),  then  x = relu(x·W_s)  T times
//
// → pen (R, pf). Design (edge_mlp_common.cuh): one launch, a block per
// group of 4 rows held in shared memory through all 1 + H + T layers, one
// __syncthreads() per layer, W_s staged once per block. The rows are
// independent, so no block waits for another.
//
// Bound on an H100: at the design point (K + 1 = 65 rows, pf 36-64, T 50)
// 2·R·(Σ head in·out + T·pf²) ≈ 27 MFLOP, a few µs of float32 issue; the
// bytes are tens of KB. The 51 dependent layers in series — a barrier and
// a pf-long dot product each — are what it costs.

#include "edge_mlp_common.cuh"

namespace {

using namespace mpnn_mlp;

struct FwdArgs {
  MlpArgs m;
  float* out;                     // (R, pf)
};

__global__ void __launch_bounds__(kThreads)
edge_mlp_fwd_kernel(FwdArgs a) {
  extern __shared__ float sm[];
  const MlpArgs& m = a.m;
  const int pf = pf_of(m), mw = max_width(m);
  float* buf0 = sm;                                  // kRows · mw
  float* buf1 = buf0 + kRows * mw;                   // kRows · mw
  float* wsm = nullptr;
  if (ws_in_smem(pf)) {
    wsm = buf1 + kRows * mw;                         // pf · (pf + 1)
    stage_ws(m.ws, pf, wsm);
  }
  for (int grp = blockIdx.x; grp < n_groups(m.rows); grp += gridDim.x) {
    const int r0 = grp * kRows;
    __syncthreads();                                 // buffers free
    load_rows(m, r0, mw, buf0);
    __syncthreads();
    const float* pen = chain_forward(m, r0, buf0, buf1, mw, wsm, nullptr);
    const int nr = min(kRows, m.rows - r0);
    for (int i = threadIdx.x; i < nr * pf; i += kThreads)
      a.out[size_t(r0) * pf + i] = pen[(i / pf) * mw + i % pf];
  }
}

size_t smem_bytes(const MlpArgs& m) {
  const int pf = pf_of(m);
  return sizeof(float) *
         (2 * size_t(kRows) * max_width(m) +
          (ws_in_smem(pf) ? size_t(pf) * ws_ld(pf) : 0));
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() of the launch
// (0 = success). hw, hb: n_head pointers each; dims: n_head + 1 widths.
int mpnn_edge_mlp_fwd(const float* x, const float* const* hw,
                      const float* const* hb, const float* ws,
                      const int* dims, int n_head, int rows, int tail,
                      float* out, void* stream) {
  if (n_head < 0 || n_head > kMaxHead || rows < 1 || tail < 0)
    return int(cudaErrorInvalidValue);
  FwdArgs a{};
  for (int i = 0; i < n_head; ++i) {
    a.m.hw[i] = hw[i];
    a.m.hb[i] = hb[i];
  }
  for (int i = 0; i <= n_head; ++i) a.m.dims[i] = dims[i];
  a.m.x = x;
  a.m.ws = ws;
  a.m.rows = rows;
  a.m.n_head = n_head;
  a.m.tail = tail;
  a.out = out;
  const size_t bytes = smem_bytes(a.m);
  cudaError_t err = cudaFuncSetAttribute(
      edge_mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (err != cudaSuccess) return int(err);
  edge_mlp_fwd_kernel<<<n_groups(rows), kThreads, bytes,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
