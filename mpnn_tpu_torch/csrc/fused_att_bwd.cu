// Message + GRU backward of the collapsed attention family (the `adv`
// model), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mpnn_tpu/kernels/fused_att.py::_att_bwd_kernel
// (the VJP of make_fused_att_op). Given gh = ∂L/∂h and the forward's
// messages, per node v (graph g, in-edges e with src u, vocab id k):
//
//   GRU VJP            → ∂msg_v = dm_v, ∂h0[v] (hidden path), the GRU leaves
//   per in-edge e      gate_e, g_e = gate_e ⊙ h0[u] recomputed;
//                      dg = A'[k]ᵀ·dm_v;  dA'[k] += dm_v ⊗ g_e;
//                      dz_e = gate_e ⊙ (dg ⊙ h0[u] − Σ dg ⊙ h0[u] ⊙ gate_e)
//                      (softmax VJP); dqv[k] += dz_e; ∂h0[u] += dg ⊙ gate_e
//   'att' correction   A0·(g0_v ⊙ X_v), X_v = S_g − Σ_e h0[u]:
//                      dA0 += dm_v ⊗ (g0_v ⊙ X_v); dX = (A0ᵀ·dm_v) ⊙ g0_v
//                      reaches every node of g (through S_g) and, with a
//                      minus sign, each in-edge's source; dz0_v, the softmax
//                      VJP of g0_v, gives dq0 and ∂h0[v] through Wh
//   ∂Wh = Σ_v h0[v] ⊗ (Σ_e dz_e + dz0_v),  ∂h0[v] += Wh·(Σ_e dz_e + dz0_v)
//
// Design: ONE cooperative launch. Phase 1, one warp per graph (every edge
// lies inside its graph): each lane walks its nodes' in-edges, writes the
// per-edge source cotangent to scratch, and, after a __syncwarp, walks its
// nodes' out-edges (the device-built source order) to sum them — ∂h0 needs
// no atomics and no grid barrier. The per-node and per-edge terms of the
// weight gradients go to scratch rows; after one grid barrier each block
// sums node chunks and edge chunks into its private gradient row, every
// element owned by one thread, in node and edge order; after a second the
// rows are reduced in block order. Deterministic for a given grid.
//
// Bound on an H100: ~4× the forward's operations per edge, and the scratch
// rows written once and read once (~0.5 KB per node); microseconds of work
// at batch 1,024 — the two grid barriers and the staging dominate.

#include "fused_att_common.cuh"

namespace {

using namespace mpnn_att;

// Flat layout of the gradient output (and of each block's partial row):
// real shapes, in this order. kernels/fused_att.py::grad_layout mirrors it
// and checks it against mpnn_fused_att_bwd_layout.
struct AttGradLayout {
  int a, a0, qv, q0, wh, wih, whh, bih, bhh, total;
  __host__ __device__ AttGradLayout(int k, int f) {
    a = 0;
    a0 = a + k * f * f;
    qv = a0 + f * f;
    q0 = qv + k * f;
    wh = q0 + f;
    wih = wh + f * f;
    whh = wih + 3 * f * f;
    bih = whh + 3 * f * f;
    bhh = bih + 3 * f;
    total = bhh + 3 * f;
  }
};

// Per-node scratch row, FP floats per segment: the GRU VJP's
// [mb | h0 | da_r | da_z | da_n | dnh], then [dm | g0⊙X | dz0 | dzall].
enum { kMb, kH0, kDar, kDaz, kDan, kDnh, kDm, kG0x, kDz0, kDzall, kSegs };
constexpr int kNodeRow = kSegs * FP;
constexpr int kEdgeRow = 2 * FP;        // [g | dz]

struct BwdArgs {
  AttWeights w;
  const float* h0;              // (N, f), pre-masked
  const float* msgs;            // (N, f) the forward's masked messages
  const float* gh;              // (N, f) cotangent of h
  const int* vid;               // (E)
  const int* src;               // (E)
  const int* dst;               // (E)
  const int* edge_order;        // (E) edge ids, stably sorted by dst
  const int* dst_ptr;           // (N + 1)
  const int* src_order;         // (E) edge ids, stably sorted by src
  const int* src_ptr;           // (N + 1)
  const int* graph_node_ptr;    // (G + 1)
  float* dh0;                   // (N, f)
  float* dw;                    // AttGradLayout(K, f).total
  float* scratch;
  int n_nodes, n_graphs, n_edges, f, k_vocab, with_corr;
};

// The staged weights: the launch's dynamic shared memory, behind an
// opaque offset so loop-invariant weights stay in shared memory.
__device__ __forceinline__ const float* sm_weights() {
  extern __shared__ float att_sm[];
  return att_sm + opaque_zero();
}

// First element index >= off owned by this thread (e ≡ tid mod kThreads).
__device__ __forceinline__ int first_owned(int off) {
  return off + ((int(threadIdx.x) - off) % kThreads + kThreads) % kThreads;
}

template <int NF>
__device__ __forceinline__ void store_seg(float* row, int seg, int f,
                                          const float* x) {
MPNN_UNROLL
  for (int j = 0; j < NF; ++j)
    if (j < f) row[seg * FP + j] = x[j];
}

// Phase 1 for one node: GRU VJP, in-edge walk, correction VJP. Writes the
// node's scratch row, its in-edges' rows and source cotangents, and its
// ∂h0 without the graph-wide and out-edge terms; adds its dX to dS (for
// ∂S_g). Inlined, so the per-node arrays stay in registers.
template <int NF>
__device__ __forceinline__ void node_backward(const BwdArgs& a, int n,
                                              const float (&S)[NF],
                                              float* nodes, float* edges,
                                              float* dhs, float (&dS)[NF]) {
  const int f = a.f;
  const float* w = sm_weights();
  float* row = nodes + size_t(n) * kNodeRow;
  float dm[NF], zh[NF];
  {
    float mb[NF], hp[NF], gin[NF], dh[NF];
    load_row<NF>(a.msgs, n, f, mb);
    load_row<NF>(a.h0, n, f, hp);
    load_row<NF>(a.gh, n, f, gin);
    // the gates one feature at a time, so only the products stay live
    float dar[NF], daz[NF], dan[NF], dnh[NF];
MPNN_UNROLL
    for (int j = 0; j < NF; ++j) {
      float gr = w[AL::kBih + j], gz = w[AL::kBih + FP + j],
            gn = w[AL::kBih + 2 * FP + j];
      float rh = w[AL::kBhh + j], zh2 = w[AL::kBhh + FP + j],
            nh = w[AL::kBhh + 2 * FP + j];
MPNN_UNROLL
      for (int k = 0; k < NF; ++k) {
        const float* wi_ = w + AL::kWih + k * 3 * FP;
        const float* wh_ = w + AL::kWhh + k * 3 * FP;
        gr = fmaf(mb[k], wi_[j], gr);
        gz = fmaf(mb[k], wi_[FP + j], gz);
        gn = fmaf(mb[k], wi_[2 * FP + j], gn);
        rh = fmaf(hp[k], wh_[j], rh);
        zh2 = fmaf(hp[k], wh_[FP + j], zh2);
        nh = fmaf(hp[k], wh_[2 * FP + j], nh);
      }
      const float sr = sigmoidf_(gr + rh);
      const float sz = sigmoidf_(gz + zh2);
      const float tn = tanhf(gn + sr * nh);
      const float dz = gin[j] * (hp[j] - tn);
      const float da_n = gin[j] * (1.0f - sz) * (1.0f - tn * tn);
      dan[j] = da_n;
      dnh[j] = da_n * sr;
      dar[j] = da_n * nh * sr * (1.0f - sr);
      daz[j] = dz * sz * (1.0f - sz);
      dh[j] = gin[j] * sz;
    }
MPNN_UNROLL
    for (int k = 0; k < NF; ++k) {
      const float* wh_ = w + AL::kWhh + k * 3 * FP;
      const float* wi_ = w + AL::kWih + k * 3 * FP;
      float th = dh[k], ti = 0.f;
MPNN_UNROLL
      for (int j = 0; j < NF; ++j) {
        th = fmaf(wh_[j], dar[j], th);
        th = fmaf(wh_[FP + j], daz[j], th);
        th = fmaf(wh_[2 * FP + j], dnh[j], th);
        ti = fmaf(wi_[j], dar[j], ti);
        ti = fmaf(wi_[FP + j], daz[j], ti);
        ti = fmaf(wi_[2 * FP + j], dan[j], ti);
      }
      dh[k] = th;
      dm[k] = ti;
    }
    store_seg<NF>(row, kMb, f, mb);
    store_seg<NF>(row, kH0, f, hp);
    store_seg<NF>(row, kDar, f, dar);
    store_seg<NF>(row, kDaz, f, daz);
    store_seg<NF>(row, kDan, f, dan);
    store_seg<NF>(row, kDnh, f, dnh);
    store_row<NF>(a.dh0, n, f, dh);
    gate_pre<NF>(w, hp, zh);
  }
  float dx_[NF];
MPNN_UNROLL
  for (int j = 0; j < NF; ++j) dx_[j] = 0.f;
  if (a.with_corr) {
    float g0[NF];
    feat_softmax<NF>(zh, w + AL::kQ0, f, g0);
    matvec_t_add<NF>(w + AL::kA0, dm, dx_);          // A0ᵀ·dm
MPNN_UNROLL
    for (int j = 0; j < NF; ++j) dx_[j] *= g0[j];
  }
  float xs[NF], dzall[NF];
MPNN_UNROLL
  for (int j = 0; j < NF; ++j) xs[j] = dzall[j] = 0.f;
  const int p1 = __ldg(a.dst_ptr + n + 1);
  for (int p = __ldg(a.dst_ptr + n); p < p1; ++p) {
    const float* we = sm_weights();
    const int e = __ldg(a.edge_order + p);
    const int k = __ldg(a.vid + e);
    float hs[NF], gate[NF], dg[NF];
    load_row<NF>(a.h0, __ldg(a.src + e), f, hs);
    feat_softmax<NF>(zh, we + AL::kQv + k * FP, f, gate);
MPNN_UNROLL
    for (int j = 0; j < NF; ++j) dg[j] = 0.f;
    matvec_t_add<NF>(aprime_of(we, a.w, a.k_vocab, k), dm,
                     dg);                           // A'[k]ᵀ·dm
    float s = 0.f;
MPNN_UNROLL
    for (int j = 0; j < NF; ++j) s = fmaf(dg[j] * hs[j], gate[j], s);
    float* erow = edges + size_t(e) * kEdgeRow;
    float* drow = dhs + size_t(e) * FP;
MPNN_UNROLL
    for (int j = 0; j < NF; ++j) {
      if (j < f) {
        const float dz = gate[j] * (dg[j] * hs[j] - s);
        erow[j] = gate[j] * hs[j];
        erow[FP + j] = dz;
        drow[j] = dg[j] * gate[j] - dx_[j];
        dzall[j] += dz;
      }
      xs[j] += hs[j];
    }
  }
  float g0x[NF], dz0[NF];
MPNN_UNROLL
  for (int j = 0; j < NF; ++j) g0x[j] = dz0[j] = 0.f;
  if (a.with_corr) {
    float g0[NF], dwn[NF];
    feat_softmax<NF>(zh, w + AL::kQ0, f, g0);
MPNN_UNROLL
    for (int j = 0; j < NF; ++j) dwn[j] = 0.f;
    matvec_t_add<NF>(w + AL::kA0, dm, dwn);
    float s0 = 0.f;
MPNN_UNROLL
    for (int j = 0; j < NF; ++j) {
      const float x = S[j] - xs[j];
      g0x[j] = g0[j] * x;
      dwn[j] *= x;                                 // ∂g0
      s0 = fmaf(dwn[j], g0[j], s0);
    }
MPNN_UNROLL
    for (int j = 0; j < NF; ++j) {
      dz0[j] = g0[j] * (dwn[j] - s0);
      dzall[j] += dz0[j];
    }
  }
  store_seg<NF>(row, kDm, f, dm);
  store_seg<NF>(row, kG0x, f, g0x);
  store_seg<NF>(row, kDz0, f, dz0);
  store_seg<NF>(row, kDzall, f, dzall);
  float dh[NF];
  load_row<NF>(a.dh0, n, f, dh);
  matvec_add<NF>(w + AL::kWh, dzall, dh);              // Wh·dzall
  store_row<NF>(a.dh0, n, f, dh);
MPNN_UNROLL
  for (int j = 0; j < NF; ++j) dS[j] += dx_[j];
}

// Instantiated for NF = 8 (f <= 8, adv's 7) and NF = FP (16) in the
// narrow build, NF = FP (32) alone in the wide one: the per-node vectors
// of node_backward live in registers, ~20 of them, and at NF = 16 they
// spill. (kThreads, 1): without the minimum of one block per SM,
// ptxas caps this large kernel at 32 registers.
template <int NF>
__global__ void __launch_bounds__(kThreads, 1)
fused_att_bwd_kernel(BwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float sm[];
  const int f = a.f, K = a.k_vocab;
  stage_att_weights(sm, a.w, f, K);
  float* xs = sm + AL::total(K);                   // kThreads·(10f + 1)
  int* vids = reinterpret_cast<int*>(xs + kThreads * (kSegs * f + 1));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int N = a.n_nodes, G = a.n_graphs, E = a.n_edges;
  const int n_real = a.graph_node_ptr[G];
  const AttGradLayout gl(K, f);
  const int NW = gl.total;
  float* nodes = a.scratch;                                   // N·kNodeRow
  float* edges = nodes + size_t(N) * kNodeRow;                // E·kEdgeRow
  float* dhs = edges + size_t(E) * kEdgeRow;                  // E·FP
  float* wpart = dhs + size_t(E) * FP;                        // grid·NW
  float* wrow = wpart + size_t(blockIdx.x) * NW;
  for (int e = tid; e < NW; e += kThreads) wrow[e] = 0.f;
  {
    const size_t pad = size_t(N - n_real) * f;
    for (size_t i = size_t(blockIdx.x) * kThreads + tid; i < pad;
         i += size_t(gridDim.x) * kThreads)
      a.dh0[size_t(n_real) * f + i] = 0.f;
  }
  __syncthreads();

  // ---- phase 1: one warp per graph -------------------------------------
  for (int g = blockIdx.x * kWarps + warp; g < G; g += gridDim.x * kWarps) {
    const int n0 = a.graph_node_ptr[g], n1 = a.graph_node_ptr[g + 1];
    float S[NF], dS[NF];
MPNN_UNROLL
    for (int j = 0; j < NF; ++j) S[j] = dS[j] = 0.f;
    if (a.with_corr) {
      for (int n = n0 + lane; n < n1; n += 32) {
        float hn[NF];
        load_row<NF>(a.h0, n, f, hn);
MPNN_UNROLL
        for (int j = 0; j < NF; ++j) S[j] += hn[j];
      }
MPNN_UNROLL
      for (int j = 0; j < NF; ++j) S[j] = warp_sum(S[j]);
    }
    for (int n = n0 + lane; n < n1; n += 32)
      node_backward(a, n, S, nodes, edges, dhs, dS);
MPNN_UNROLL
    for (int j = 0; j < NF; ++j) dS[j] = warp_sum(dS[j]);
    __syncwarp();                     // the lanes' source cotangents
    for (int n = n0 + lane; n < n1; n += 32) {
      float d[NF];
      load_row<NF>(a.dh0, n, f, d);
MPNN_UNROLL
      for (int j = 0; j < NF; ++j) d[j] += dS[j];
      const int p1 = __ldg(a.src_ptr + n + 1);
      for (int p = __ldg(a.src_ptr + n); p < p1; ++p) {
        float t[NF];
        load_row_cg<NF>(dhs + size_t(__ldg(a.src_order + p)) * FP, 0, f, t);
MPNN_UNROLL
        for (int j = 0; j < NF; ++j) d[j] += t[j];
      }
      store_row<NF>(a.dh0, n, f, d);
    }
    __syncwarp();
  }
  grid.sync();

  // ---- phase 2: weight gradients into the block's row ------------------
  const int kS = kSegs * f + 1;
  const int nchunks = (n_real + kThreads - 1) / kThreads;
  for (int ch = blockIdx.x; ch < nchunks; ch += gridDim.x) {
    const int n = ch * kThreads + tid;
    float* row = xs + tid * kS;
    if (n < n_real) {
      const float* src = nodes + size_t(n) * kNodeRow;
      for (int s = 0; s < kSegs; ++s)
        for (int j = 0; j < f; ++j) row[s * f + j] = __ldcg(src + s * FP + j);
    } else {
      for (int i = 0; i < kS; ++i) row[i] = 0.f;
    }
    __syncthreads();
    for (int e = first_owned(gl.a0); e < NW; e += kThreads) {
      if (e >= gl.qv && e < gl.q0) continue;       // dqv: per edge below
      int cx = -1, cd;
      if (e < gl.qv) {                             // A0: dm ⊗ g0⊙X
        const int i = e - gl.a0;
        cx = kDm * f + i / f;
        cd = kG0x * f + i % f;
      } else if (e < gl.wh) {                      // q0: Σ dz0
        cd = kDz0 * f + (e - gl.q0);
      } else if (e < gl.wih) {                     // Wh: h0 ⊗ dzall
        const int i = e - gl.wh;
        cx = kH0 * f + i / f;
        cd = kDzall * f + i % f;
      } else if (e < gl.bih) {                     // W_ih, W_hh
        const bool hh = e >= gl.whh;
        const int i = e - (hh ? gl.whh : gl.wih);
        const int k = i / (3 * f), gg = (i % (3 * f)) / f, j = i % f;
        cx = (hh ? kH0 : kMb) * f + k;
        cd = (hh && gg == 2 ? kDnh : kDar + gg) * f + j;
      } else {                                     // b_ih, b_hh
        const bool hh = e >= gl.bhh;
        const int i = e - (hh ? gl.bhh : gl.bih), gg = i / f, j = i % f;
        cd = (hh && gg == 2 ? kDnh : kDar + gg) * f + j;
      }
      float s = 0.f;
      if (cx >= 0) {
        for (int i = 0; i < kThreads; ++i)
          s = fmaf(xs[i * kS + cx], xs[i * kS + cd], s);
      } else {
        for (int i = 0; i < kThreads; ++i) s += xs[i * kS + cd];
      }
      wrow[e] += s;
    }
    __syncthreads();
  }
  const int kSe = 3 * f;                           // [dm_dst | g | dz]
  const int nech = (E + kThreads - 1) / kThreads;
  for (int ec = blockIdx.x; ec < nech; ec += gridDim.x) {
    const int e = ec * kThreads + tid;
    float* row = xs + tid * kSe;
    vids[tid] = -1;
    if (e < E) {
      const int d = __ldg(a.dst + e);
      if (d < n_real) {
        vids[tid] = __ldg(a.vid + e);
        const float* nrow = nodes + size_t(d) * kNodeRow + kDm * FP;
        const float* erow = edges + size_t(e) * kEdgeRow;
        for (int j = 0; j < f; ++j) {
          row[j] = __ldcg(nrow + j);
          row[f + j] = __ldcg(erow + j);
          row[2 * f + j] = __ldcg(erow + FP + j);
        }
      }
    }
    __syncthreads();
    const int ff = f * f;
    for (int el = first_owned(gl.a); el < gl.q0; el += kThreads) {
      if (el >= gl.a0 && el < gl.qv) continue;     // dA0: per node above
      float s = 0.f;
      if (el < gl.a0) {                            // A'[k]: dm ⊗ g
        const int k = el / ff, m = (el % ff) / f, j = el % f;
        for (int i = 0; i < kThreads; ++i)
          if (vids[i] == k) s = fmaf(xs[i * kSe + m], xs[i * kSe + f + j], s);
      } else {                                     // qv[k]: Σ dz
        const int i0 = el - gl.qv, k = i0 / f, j = i0 % f;
        for (int i = 0; i < kThreads; ++i)
          if (vids[i] == k) s += xs[i * kSe + 2 * f + j];
      }
      wrow[el] += s;
    }
    __syncthreads();
  }
  grid.sync();

  // ---- reduce the block rows in block order ------------------------------
  for (int e = blockIdx.x * kThreads + tid; e < NW;
       e += gridDim.x * kThreads) {
    float s = 0.f;
    for (int b = 0; b < int(gridDim.x); ++b)
      s += __ldcg(wpart + size_t(b) * NW + e);
    a.dw[e] = s;
  }
}

size_t smem_bytes(int k_vocab, int f) {
  return sizeof(float) * (size_t(AL::total(k_vocab)) +
                          size_t(kThreads) * (kSegs * f + 1)) +
         sizeof(int) * kThreads;
}

// The instantiation that runs width f.
const void* kernel_for(int f) {
  if constexpr (FP <= 16)               // the narrow bucket's two builds
    if (f <= 8) return (const void*)fused_att_bwd_kernel<8>;
  return (const void*)fused_att_bwd_kernel<FP>;
}

}  // namespace

extern "C" {

int mpnn_fused_att_bwd_smem_bytes(int k_vocab) {
  return int(smem_bytes(k_vocab, FP));
}

// The 10 offsets of the flat gradient layout (AttGradLayout), total last.
void mpnn_fused_att_bwd_layout(int k_vocab, int f, int* out) {
  const AttGradLayout g(k_vocab, f);
  const int v[10] = {g.a, g.a0, g.qv, g.q0, g.wh, g.wih, g.whh, g.bih,
                     g.bhh, g.total};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
}

long long mpnn_fused_att_bwd_scratch_floats(int n_nodes, int n_edges,
                                            int k_vocab, int f, int grid) {
  return (long long)n_nodes * kNodeRow + (long long)n_edges * kEdgeRow +
         (long long)n_edges * FP +
         (long long)grid * AttGradLayout(k_vocab, f).total;
}

int mpnn_fused_att_bwd_grid(int k_vocab, int n_nodes, int n_graphs,
                            int n_edges) {
  const size_t bytes = smem_bytes(k_vocab, FP);
  int dev = 0, sms = 0, per_sm = 1 << 30;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  // co-resident blocks of either instantiation: the fewer
  for (const void* k : {kernel_for(1), kernel_for(FP)}) {
    int n = 0;
    if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(bytes)) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, kThreads,
                                                      bytes) != cudaSuccess)
      return 0;
    per_sm = min(per_sm, n);
  }
  const int need = max(max((n_nodes + kThreads - 1) / kThreads,
                           (n_graphs + kWarps - 1) / kWarps),
                       max((n_edges + kThreads - 1) / kThreads, 1));
  return min(per_sm * sms, need);
}

int mpnn_fused_att_bwd(
    const float* aprime, const float* a0, const float* qv, const float* q0,
    const float* wh, const float* w_ih, const float* w_hh, const float* b_ih,
    const float* b_hh, const float* h0, const float* msgs, const float* gh,
    const int* vid, const int* src, const int* dst, const int* edge_order,
    const int* dst_ptr, const int* src_order, const int* src_ptr,
    const int* graph_node_ptr, float* dh0, float* dw, float* scratch,
    int n_nodes, int n_graphs, int n_edges, int f, int k_vocab,
    int with_corr, int grid, void* stream) {
  if (f < 1 || f > FP || k_vocab < 1 || k_vocab > kMaxVocab || grid < 1)
    return int(cudaErrorInvalidValue);
  BwdArgs a{{aprime, a0, qv, q0, wh, w_ih, w_hh, b_ih, b_hh},
            h0, msgs, gh, vid, src, dst, edge_order, dst_ptr, src_order,
            src_ptr, graph_node_ptr, dh0, dw, scratch, n_nodes, n_graphs,
            n_edges, f, k_vocab, with_corr};
  // sized for the widest f the grid was computed for
  const size_t bytes = smem_bytes(k_vocab, FP);
  const void* kernel = kernel_for(f);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid),
                                    dim3(kThreads), args, bytes,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
