// Edge-MLP chain forward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mpnn_tpu/kernels/edge_mlp.py::_fwd_kernel (the
// forward of make_edge_mlp_op): the edge network's head layers and its
// weight-shared relu tail on the R = K + 1 edge-vocab rows,
//
//   x = relu(x·W_h + b_h)  (H head layers),  then  x = relu(x·W_s)  T times
//
// → pen (R, pf). Design (edge_mlp_common.cuh): a block (on the panel route
// a cluster) holds rb rows and every weight of the chain on chip for all
// 1 + H + T layers; each layer is one short dot per output — at pf <= 64
// a thread per output column, W_s's column in its registers, and the
// row's own barrier; above, a panel of W_s in each cluster block's shared
// memory and one cluster barrier. The rows are independent: no block waits
// for another.
//
// Bound on an H100: at the design point (R 9-65, pf 36-64, T 50)
// 2·R·(Σ head in·out + T·pf²) is 1-27 MFLOP, under 0.5 µs of float32
// throughput; the bytes are tens of KB. The 51 dependent layers in series
// — a barrier and a pf-long dot each — are what it costs (chip_smoke.py's
// mlp-times prints the empty-chain floor of the same grid).

#include "edge_mlp_common.cuh"

namespace {

using namespace mpnn_mlp;

struct FwdArgs {
  MlpArgs m;
  float* out;                     // (R, pf)
};

// KP > 0: the register route (W_s's column of KP floats in registers);
// 0: the panel route, in clusters (kCluster) or in plain blocks; kL2: the
// l2 route (the panel route's clusters, W_s read from device memory).
template <int KP, bool kCluster, bool kL2>
__global__ void __launch_bounds__(KP > 0 ? reg_max_threads(KP)
                                         : kPanelThreads)
edge_mlp_fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  const MlpArgs& m = a.m;
  stamp(m, 0);
  const Cta<kCluster> cta;
  const Plan p(m, KP, false, cta.rank);
  const int row0 = cta.cluster_id() * m.rb, pf = pf_of(m);
  Geom g(p, sm, pf);
  if constexpr (kL2) g.use_device_memory(m, false, nullptr, p);
  stage(m, p, sm, row0, false);
  float w[KP > 0 ? KP : 1];
  if constexpr (KP > 0) load_w<KP>(g, false, w);
  stamp(m, 1);
  chain_forward<KP, kCluster, kL2>(m, p, g, cta, sm, w, false);
  stamp(m, 7);
  const float* pen = g.xb(m.n_head + m.tail);
  const int nr = min(m.rb, m.rows - row0);
  for (int i = threadIdx.x; i < nr * g.own; i += blockDim.x) {
    const int r = i / g.own, j = i % g.own;
    a.out[size_t(row0 + r) * pf + g.c0 + j] = pen[r * g.ld + g.c0 + j];
  }
  stamp(m, 8);
}

// The kernel instance of a route: KP (8..64 by 8), or 0 (panel) in
// clusters of more than one block or not, or the l2 route.
using FwdKernel = void (*)(FwdArgs);
FwdKernel fwd_kernel(int kp, int cluster, int l2) {
  switch (kp) {
    case 0: return l2 ? edge_mlp_fwd_kernel<0, true, true>
                      : cluster > 1 ? edge_mlp_fwd_kernel<0, true, false>
                                    : edge_mlp_fwd_kernel<0, false, false>;
    case 8: return edge_mlp_fwd_kernel<8, false, false>;
    case 16: return edge_mlp_fwd_kernel<16, false, false>;
    case 24: return edge_mlp_fwd_kernel<24, false, false>;
    case 32: return edge_mlp_fwd_kernel<32, false, false>;
    case 40: return edge_mlp_fwd_kernel<40, false, false>;
    case 48: return edge_mlp_fwd_kernel<48, false, false>;
    case 56: return edge_mlp_fwd_kernel<56, false, false>;
    case 64: return edge_mlp_fwd_kernel<64, false, false>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of a launch (bytes), 0 if the shape is not one of
// the kernels'.
int mpnn_edge_mlp_fwd_smem_bytes(const int* dims, int n_head, int rows,
                                 int tail, int rb, int cluster, int kp,
                                 int l2) {
  const MlpArgs m = mlp_args(nullptr, nullptr, nullptr, nullptr, dims, n_head,
                             rows, tail, rb, cluster, l2, nullptr);
  if (!shape_ok(m, kp)) return 0;
  return int(sizeof(float) * Plan(m, kp, false, 0).total);
}

// Launches on `stream` and returns the launch's error code (0 = success).
// hw, hb: n_head pointers each; dims: n_head + 1 widths; (rb, cluster, kp,
// l2) from kernels/edge_mlp.py::launch_shape; prof: null, or 20 int64
// slots for block 0's clock64 stamps.
int mpnn_edge_mlp_fwd(const float* x, const float* const* hw,
                      const float* const* hb, const float* ws,
                      const int* dims, int n_head, int rows, int tail, int rb,
                      int cluster, int kp, int l2, float* out,
                      long long* prof, void* stream) {
  FwdArgs a{mlp_args(x, hw, hb, ws, dims, n_head, rows, tail, rb, cluster,
                     l2, prof),
            out};
  if (!shape_ok(a.m, kp)) return int(cudaErrorInvalidValue);
  const size_t bytes = sizeof(float) * Plan(a.m, kp, false, 0).total;
  return int(launch(fwd_kernel(kp, cluster, l2), cluster > 1,
                    clusters_of(a.m) * cluster,
                    threads_of(a.m, kp), bytes,
                    static_cast<cudaStream_t>(stream), cluster, a));
}

// The empty-chain floor of the same launch: `layers` barriers.
int mpnn_edge_mlp_fwd_floor(const int* dims, int n_head, int rows, int tail,
                            int rb, int cluster, int kp, int l2, int layers,
                            void* stream) {
  const MlpArgs m = mlp_args(nullptr, nullptr, nullptr, nullptr, dims, n_head,
                             rows, tail, rb, cluster, l2, nullptr);
  if (!shape_ok(m, kp)) return int(cudaErrorInvalidValue);
  return launch_floor(m, kp, sizeof(float) * Plan(m, kp, false, 0).total,
                      layers, stream);
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
