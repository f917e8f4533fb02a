// Edge-MLP chain backward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mpnn_tpu/kernels/edge_mlp.py::_bwd_kernel (the
// VJP of make_edge_mlp_op). Given g = ∂L/∂pen (R, pf) it recomputes the
// forward chain (edge_mlp_common.cuh::chain_forward, the forward kernel's
// own code and summation order, so the relu masks are those of the pen
// served), keeping every layer's output rows in shared memory, then walks
// it in reverse:
//
//   tail, t = T−1..0:  gz_t = (y_t+1 > 0) ⊙ g;  g = gz_t·W_sᵀ
//   head, h = H−1..0:  gz_h = (y_h+1 > 0) ⊙ g;  g = gz_h·W_hᵀ
//   ∂x = g            (the per-step family's vocab rows come from its tanh
//                      encoder and input bn1d, so the rows need it)
//   ∂W_s = Σ_t y_tᵀ·gz_t,  ∂W_h = y_hᵀ·gz_h,  ∂b_h = Σ_rows gz_h
//
// Design: the forward's launch shape (a block, or a cluster on the panel
// route, holds rb rows; kernels/edge_mlp.py::launch_shape), with the
// block's stash — each layer's output rows (its own columns) and each
// layer's gz — in shared memory, so nothing of the chain leaves the SM.
// On the serial walk each reverse layer is one dot per output (W_s's row
// in the thread's registers at pf <= 64, a transposed panel in shared
// memory above) whose epilogue masks the result into the next gz, and one
// barrier. The weight gradient is off that chain: after the walk every
// thread of the block forms ∂W_s's tiles as one product of depth T·rows
// over the stashed y and gz, in (t, row) order. A launch of one block or
// cluster writes the gradient itself; past one, each block writes its
// partial row to scratch, and the last block of each cluster rank to
// finish (an integer counter) sums the rows in block order, then sets its
// counter back to zero for the next launch: the counters are zeroed once,
// when the caller allocates them, and a backward is one kernel launch. No
// float atomics and no grid barrier: the sums do not depend on the
// schedule. The l2 route (edge_mlp_common.cuh) keeps the stash in each
// block's region of global scratch instead.
//
// Bound on an H100: about twice the forward's multiply-adds plus ∂x (2-55
// MFLOP at the design point) and tens of KB; the 2·(1 + H + T) dependent
// layers in series are what it costs.

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
  float* scratch;                 // the l2 route's stash (Plan.stash a
                                  // block), then a partial row a cluster
                                  // (more than one cluster)
  int* counters;                  // kMaxCluster, zero between launches
};

// Floats of global scratch before the partial rows: the l2 route's stash.
__host__ __device__ inline size_t stash_scratch(const MlpArgs& m,
                                                const Plan& p) {
  return m.l2 ? size_t(clusters_of(m)) * m.cluster * p.stash : 0;
}

// KP, kCluster and kL2 as the forward kernel's.
template <int KP, bool kCluster, bool kL2>
__global__ void __launch_bounds__(KP > 0 ? reg_max_threads(KP)
                                         : kPanelThreads)
edge_mlp_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  const MlpArgs& m = a.m;
  stamp(m, 0);
  const Cta<kCluster> cta;
  const Plan p(m, KP, true, cta.rank);
  const GradLayout L(m);
  const int H = m.n_head, T = m.tail, pf = pf_of(m), ef = m.dims[0];
  const int ncl = clusters_of(m), cid = cta.cluster_id();
  const int row0 = cid * m.rb, nr = min(m.rb, m.rows - row0);
  const int pfl = round4(pf);          // hy[H] / hg[H-1] row stride
  const int probe_t = m.prof ? T / 2 : -1;
  Geom g(p, sm, pf);
  // the l2 route: block b's stash at scratch + b·Plan.stash
  float* const stash_of_block =
      kL2 ? a.scratch + size_t(blockIdx.x) * p.stash : nullptr;
  if constexpr (kL2) g.use_device_memory(m, false, stash_of_block, p);
  stage(m, p, sm, row0, KP > 0);
  float w[KP > 0 ? KP : 1];
  if constexpr (KP > 0) load_w<KP>(g, false, w);
  stamp(m, 1);
  chain_forward<KP, kCluster, kL2>(m, p, g, cta, sm, w, true);
  stamp(m, 7);

  // ---- the reverse walk ---------------------------------------------------
  // every block is past the chain (its last barrier): W_s's rows replace
  // its columns, and the exchange buffers carry gz (gx(t) = xb(t))
  if constexpr (KP > 0) {
    load_w<KP>(g, true, w);
  } else if constexpr (kL2) {
    g.use_device_memory(m, true, stash_of_block, p);
  } else {
    copy_panel(m, p, sm, true);
    cp_async_wait_all();
    __syncthreads();
  }
  const int slot = g.rbp * g.pp;       // floats of a stash slot
  auto cot = [&](int r, int c) {       // ∂L/∂pen[r][c], zero past R
    return r < nr ? a.gpen[size_t(row0 + r) * pf + c] : 0.f;
  };
  if (T > 0) {                         // gz of the last tail layer
    float* const to = g.xb(T - 1) + g.c0;
    const float* y = g.ty + T * slot;
    float* gz = g.tg + (T - 1) * slot;
    for (int i = threadIdx.x; i < g.rbp * g.pp; i += blockDim.x) {
      const int r = i / g.pp, j = i % g.pp;
      const float v =
          j < g.own && y[i] > 0.f ? cot(r, g.c0 + j) : 0.f;
      gz[i] = v;                       // the padding columns get zeros
      if (j < g.own)
        for (int q = 0; q < cta.size; ++q) cta.peer(to, q)[r * g.ld + j] = v;
    }
  } else if (H > 0) {                  // gz of the last head layer
    for (int i = threadIdx.x; i < g.rbp * pf; i += blockDim.x) {
      const int r = i / pf, c = i % pf;
      sm[p.hg[H - 1] + r * pfl + c] =
          sm[p.hy[H] + r * pfl + c] > 0.f ? cot(r, c) : 0.f;
    }
  } else if (cta.rank == 0) {          // no layer: ∂x = g
    for (int i = threadIdx.x; i < nr * pf; i += blockDim.x)
      a.dx[size_t(row0) * ef + i] = cot(i / pf, i % pf);
  }
  cta.sync();
  stamp(m, 8);
  // a reverse layer's g[r][c0 + j] (the cotangent of its input) masked
  // into gz of layer t − 1, kept and sent to every block; at t = 0 into
  // the head's last gz (rank 0's), or, with no head, ∂x
  float* const hg_last = H > 0 ? cta.peer(sm + p.hg[H - 1], 0) + g.c0
                               : nullptr;
  float* const dx = a.dx + size_t(row0) * ef + g.c0;
  auto epi = [&](int t, int r, int j, float gv) {
    const float* y = g.ty + t * slot;
    if (t > 0) {
      const float v = y[r * g.pp + j] > 0.f ? gv : 0.f;
      g.tg[(t - 1) * slot + r * g.pp + j] = v;
      float* const to = g.xb(t - 1) + g.c0;
      for (int q = 0; q < cta.size; ++q) cta.peer(to, q)[r * g.ld + j] = v;
    } else if (H > 0) {
      hg_last[r * pfl + j] = y[r * g.pp + j] > 0.f ? gv : 0.f;
    } else if (r < nr) {
      dx[size_t(r) * ef + j] = gv;
    }
  };
  if constexpr (KP > 0) {              // a row's threads walk it alone
    const int r = int(threadIdx.x) / reg_lanes(KP);
    const int c = int(threadIdx.x) % reg_lanes(KP);
    const float* const row0_ = g.xb0 + r * g.ld;
    const float* const row1_ = g.xb1 + r * g.ld;
    const float* ys = g.ty + r * g.pp + c;         // slot t: + t·slot
    float* gzs = g.tg + r * g.pp + c;
    for (int t = T - 1; t >= 0; --t) {
      const float* src = (t & 1) ? row1_ : row0_;
      // the mask, loaded before the dot
      const float ym = c < KP ? ys[t * slot] : 0.f;
      if (t == probe_t) {
        stamp(m, 9);
        probe_loads<KP>(m, src, 10);
      }
      const float gv = c < pf ? reg_dot<KP, false>(src, w) : 0.f;
      const float v = ym > 0.f ? gv : 0.f;
      if (t > 0) {                     // gz of layer t − 1 (padding zero)
        if (c < KP) {
          gzs[(t - 1) * slot] = v;
          ((t & 1) ? g.xb0 : g.xb1)[r * g.ld + c] = v;
        }
      } else if (c < pf) {
        if (H > 0)
          hg_last[r * pfl + c] = v;
        else if (r < nr)
          dx[size_t(r) * ef + c] = gv;
      }
      if (t == probe_t) stamp(m, 11);
      row_sync<KP>(r);
      if (t == probe_t) stamp(m, 12);
    }
    __syncthreads();
  } else {
    for (int t = T - 1; t >= 0; --t) {
      if (t == probe_t) {
        stamp(m, 9);
        stamp(m, 10);
      }
      panel_layer<false, kL2>(g, g.xb(t),
                  [&](int r, int j, float gv) { epi(t, r, j, gv); });
      if (t == probe_t) stamp(m, 11);
      cta.sync();
      if (t == probe_t) stamp(m, 12);
    }
  }
  stamp(m, 13);

  // ---- ∂W_s: this block's columns, every k, over (t, row) in order -------
  // tiles of 4 k × 4 columns; each tile's depth (the T·rbp stashed rows of
  // y and gz; the padded rows' gz is zero, so they add exact zeros) split
  // over S consecutive lanes, whose sums combine in a fixed xor tree
  float* const parts = a.scratch + stash_scratch(m, p);
  float* part = ncl == 1 ? a.dw : parts + size_t(cid) * L.total;
  {
    const int kq = (pf + 3) / 4, cq = (g.own + 3) / 4, tiles = kq * cq;
    int S = 1;
    while (S < 8 && 2 * S * tiles <= int(blockDim.x)) S *= 2;
    const int panel = KP > 0 ? pf : g.pp;           // columns a rank owns
    const int depth = T * g.rbp, chunk = (depth + S - 1) / S, pp = g.pp;
    for (int base = 0; base < tiles * S; base += blockDim.x) {
      const int idx = base + threadIdx.x, tile = idx / S, s = idx % S;
      float acc[4][4] = {};
      if (tile < tiles) {
        const int k = 4 * (tile / cq), j = 4 * (tile % cq);
        const int q = k / panel;                    // the rank holding y[k]
        const float* ty_q =
            kL2 ? a.scratch + size_t(cid * cta.size + q) * p.stash
                : cta.peer(g.ty, q);
        const float* ys = ty_q + (k - q * panel);
        const float* gs = g.tg + j;
        const int d1 = min(depth, (s + 1) * chunk);
#pragma unroll 8
        for (int d = s * chunk; d < d1; ++d) {
          const float4 y = *reinterpret_cast<const float4*>(ys + d * pp);
          const float4 z = *reinterpret_cast<const float4*>(gs + d * pp);
          const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][0] = fmaf(yv[i], z.x, acc[i][0]);
            acc[i][1] = fmaf(yv[i], z.y, acc[i][1]);
            acc[i][2] = fmaf(yv[i], z.z, acc[i][2]);
            acc[i][3] = fmaf(yv[i], z.w, acc[i][3]);
          }
        }
      }
      for (int o = 1; o < S; o *= 2)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            acc[i][jj] += __shfl_xor_sync(0xffffffffu, acc[i][jj], o);
      if (tile < tiles && s == 0) {
        const int k = 4 * (tile / cq), j = 4 * (tile % cq);
        for (int i = 0; i < 4; ++i)
          for (int jj = 0; jj < 4; ++jj)
            if (k + i < pf && j + jj < g.own)
              part[L.ws + size_t(k + i) * pf + g.c0 + j + jj] = acc[i][jj];
      }
    }
  }
  stamp(m, 14);
  cta.sync();                          // no block reads a peer's stash now

  // ---- the head, in the cluster's rank 0 --------------------------------
  if (cta.rank == 0) {
    for (int h = H - 1; h >= 0; --h) {
      const int n_in = m.dims[h], n_out = m.dims[h + 1];
      const int li = round4(n_in), lo = round4(n_out);
      const float* gz = sm + p.hg[h];
      const float* y = sm + p.hy[h];
      for (int e = threadIdx.x; e < n_in * n_out; e += blockDim.x) {
        const int k = e / n_out, c = e % n_out;
        float s = 0.f;
        for (int r = 0; r < nr; ++r)
          s = fmaf(y[r * li + k], gz[r * lo + c], s);
        part[L.hw[h] + e] = s;
      }
      for (int c = threadIdx.x; c < n_out; c += blockDim.x) {
        float s = 0.f;
        for (int r = 0; r < nr; ++r) s += gz[r * lo + c];
        part[L.hb[h] + c] = s;
      }
      const float* wh = sm + p.hw[h];
      const int ldw = p.hld[h];
      for (int i = threadIdx.x; i < g.rbp * n_in; i += blockDim.x) {
        const int r = i / n_in, k = i % n_in;
        const float gv = dot4<false>(gz + r * lo, lo / 4,
                              [&](int c) { return c < n_out ? wh[k * ldw + c]
                                                            : 0.f; });
        if (h > 0)
          sm[p.hg[h - 1] + r * li + k] = y[r * li + k] > 0.f ? gv : 0.f;
        else if (r < nr)
          a.dx[size_t(row0 + r) * ef + k] = gv;
      }
      __syncthreads();
    }
  }
  stamp(m, 15);

  // ---- past one cluster: the partial rows summed in block order ----------
  if (ncl > 1) {
    __threadfence();
    int* counter = a.counters + cta.rank;
    const bool last = __syncthreads_or(
        threadIdx.x == 0 && atomicAdd(counter, 1) == ncl - 1);
    if (last) {
      // every block of this rank has counted: ready for the next launch
      if (threadIdx.x == 0) *counter = 0;
      __threadfence();
      auto sum = [&](int e) {          // in block order, loads in flight
        float s = 0.f;
#pragma unroll 8
        for (int b = 0; b < ncl; ++b)
          s += __ldcg(parts + size_t(b) * L.total + e);
        a.dw[e] = s;
      };
      for (int i = threadIdx.x; i < pf * g.own; i += blockDim.x)
        sum(L.ws + (i / g.own) * pf + g.c0 + i % g.own);
      if (cta.rank == 0)
        for (int e = threadIdx.x; e < L.ws; e += blockDim.x) sum(e);
    }
  }
  stamp(m, 16);
}

using BwdKernel = void (*)(BwdArgs);
BwdKernel bwd_kernel(int kp, int cluster, int l2) {
  switch (kp) {
    case 0: return l2 ? edge_mlp_bwd_kernel<0, true, true>
                      : cluster > 1 ? edge_mlp_bwd_kernel<0, true, false>
                                    : edge_mlp_bwd_kernel<0, false, false>;
    case 8: return edge_mlp_bwd_kernel<8, false, false>;
    case 16: return edge_mlp_bwd_kernel<16, false, false>;
    case 24: return edge_mlp_bwd_kernel<24, false, false>;
    case 32: return edge_mlp_bwd_kernel<32, false, false>;
    case 40: return edge_mlp_bwd_kernel<40, false, false>;
    case 48: return edge_mlp_bwd_kernel<48, false, false>;
    case 56: return edge_mlp_bwd_kernel<56, false, false>;
    case 64: return edge_mlp_bwd_kernel<64, false, false>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// The n_head offsets of the head weights, of the head biases, of W_s and
// the total of the flat gradient layout (GradLayout), into `out`.
void mpnn_edge_mlp_bwd_layout(const int* dims, int n_head, int* out) {
  const MlpArgs m = mlp_args(nullptr, nullptr, nullptr, nullptr, dims,
                             n_head, 1, 0, 1, 1, 0, nullptr);
  const GradLayout L(m);
  int i = 0;
  for (int h = 0; h < n_head; ++h) out[i++] = L.hw[h];
  for (int h = 0; h < n_head; ++h) out[i++] = L.hb[h];
  out[i++] = L.ws;
  out[i] = L.total;
}

// Dynamic shared memory of a launch (bytes), 0 if the shape is not one of
// the kernels'.
int mpnn_edge_mlp_bwd_smem_bytes(const int* dims, int n_head, int rows,
                                 int tail, int rb, int cluster, int kp,
                                 int l2) {
  const MlpArgs m = mlp_args(nullptr, nullptr, nullptr, nullptr, dims,
                             n_head, rows, tail, rb, cluster, l2, nullptr);
  if (!shape_ok(m, kp)) return 0;
  return int(sizeof(float) * Plan(m, kp, true, 0).total);
}

// Floats of global scratch a launch needs: the l2 route's stash, and past
// one cluster a partial gradient row a cluster.
long long mpnn_edge_mlp_bwd_scratch_floats(const int* dims, int n_head,
                                           int rows, int tail, int rb,
                                           int cluster, int kp, int l2) {
  const MlpArgs m = mlp_args(nullptr, nullptr, nullptr, nullptr, dims,
                             n_head, rows, tail, rb, cluster, l2, nullptr);
  if (!shape_ok(m, kp)) return 0;
  const int ncl = clusters_of(m);
  return (long long)stash_scratch(m, Plan(m, kp, true, 0)) +
         (ncl == 1 ? 0 : (long long)ncl * GradLayout(m).total);
}

// Launches on `stream` and returns the launch's error code (0 = success).
// (rb, cluster, kp, l2) from kernels/edge_mlp.py::launch_shape; scratch as
// mpnn_edge_mlp_bwd_scratch_floats sizes it; counters: kMaxCluster ints,
// zero before the first launch (each launch leaves them zero), needed
// past one cluster; prof: null, or 20 int64 slots for block 0's clock64
// stamps.
int mpnn_edge_mlp_bwd(const float* x, const float* const* hw,
                      const float* const* hb, const float* ws,
                      const int* dims, int n_head, int rows, int tail, int rb,
                      int cluster, int kp, int l2, const float* gpen,
                      float* dx, float* dw, float* scratch, int* counters,
                      long long* prof, void* stream) {
  BwdArgs a{mlp_args(x, hw, hb, ws, dims, n_head, rows, tail, rb, cluster,
                     l2, prof),
            gpen, dx, dw, scratch, counters};
  if (!shape_ok(a.m, kp)) return int(cudaErrorInvalidValue);
  const int ncl = clusters_of(a.m);
  if ((ncl > 1 || l2) && scratch == nullptr) return int(cudaErrorInvalidValue);
  if (ncl > 1 && counters == nullptr) return int(cudaErrorInvalidValue);
  const size_t bytes = sizeof(float) * Plan(a.m, kp, true, 0).total;
  return int(launch(bwd_kernel(kp, cluster, l2), cluster > 1, ncl * cluster,
                    threads_of(a.m, kp), bytes,
                    static_cast<cudaStream_t>(stream), cluster, a));
}

// The empty-chain floor of the same launch: `layers` barriers.
int mpnn_edge_mlp_bwd_floor(const int* dims, int n_head, int rows, int tail,
                            int rb, int cluster, int kp, int l2, int layers,
                            void* stream) {
  const MlpArgs m = mlp_args(nullptr, nullptr, nullptr, nullptr, dims,
                             n_head, rows, tail, rb, cluster, l2, nullptr);
  if (!shape_ok(m, kp)) return int(cudaErrorInvalidValue);
  return launch_floor(m, kp, sizeof(float) * Plan(m, kp, true, 0).total,
                      layers, stream);
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
