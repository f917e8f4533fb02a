// Message + GRU chain backward of the bilinear family (the
// `ecfp_bilinear` model), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mpnn_tpu/kernels/fused_bilinear.py::
// _bil_bwd_kernel (the VJP of make_fused_bilinear_op). Given ghist =
// ∂L/∂hist, the forward's messages and states, walking the steps in
// reverse, per node v of graph g:
//
//   ∂h_t[v]  = ghist[v][t] + carry_t[v]         (carry_T = 0)
//   GRU VJP  (the input gates recomputed from msg_t[v]; the hidden gates
//            W_hh·h0[v] + b_hh, the same at every step, once) → dmsg_t[v], the
//            hidden path's ∂h0[v], and the GRU leaves' terms
//   carry_{t-1}[v] = Σ_{e: dst=v} Σ_n dφ_e[n·f + ·]·h_{t-1}[u][n]
//                  + Σ_{e: src=v} Σ_j dφ_e[· ·f + j]·h_{t-1}[w][j],
//            dφ_e = A_kᵀ·dmsg_t[dst_e]           (u = src_e, w = dst_e)
//   ∂h0[v]   = Σ_t hidden path + carry_0[v]      (h_0 = h0)
//
// and the GRU gradient: ∂W_ih = Σ msg ⊗ da, ∂W_hh = Σ h0 ⊗ da (the n gate
// through r·(W_hn·h0 + b_hn)), ∂b_ih, ∂b_hh (whose r and z parts equal
// b_ih's). amat takes no gradient here (the wrapper returns zeros).
//
// Design: ONE cooperative launch. One warp per graph, lanes over its
// nodes, the graph's h0, its hidden gates, h_{t-1}, dmsg_t and both carries
// in shared memory:
// each step's edge terms are computed twice — by the destination's lane
// over its in-edges and by the source's lane over its out-edges (the
// device-built source order) — so every node's carry is written by its own
// lane, with no scratch and no atomics. Each thread sums its nodes' GRU
// weight terms into its own shared-memory row; after the graphs, each
// block sums its threads' rows in thread order into a block row, and
// after the one grid barrier the rows are reduced in block order.
// Deterministic for a given grid. The function's work per edge and step
// is one dφ (2f³) and its two contractions (2f² each), about the
// forward's; computing dφ at both ends doubles the 2f³ term, the price of
// writing no scratch. Its bytes are the residuals read once (hist, msgs,
// ghist: 3·T·f floats a node); microseconds at batch 1,024.

#include "fused_bilinear_common.cuh"

namespace {

using namespace mpnn_bil;

// per node of a warp's graph: h0, its hidden gates (3·FP), h_{t-1},
// dmsg_t, carry in, carry out, the hidden path's ∂h0
constexpr int kNodeFloats = 9 * FP;
// a thread's GRU gradient row (zero-padded): W_ih [k][g·FP + j], W_hh,
// b_ih [g·FP + j], b_hh's n part [j]
enum { kAWih = 0, kAWhh = FP * 3 * FP, kABih = 2 * FP * 3 * FP,
       kABhn = kABih + 3 * FP, kAcc = kABhn + FP };
constexpr int kAccStride = kAcc + 1;   // conflict-free rows

// Flat layout of the gradient output: real shapes, in this order.
// kernels/fused_bilinear.py::grad_layout mirrors it and checks it against
// mpnn_fused_bilinear_bwd_layout.
struct BilGradLayout {
  int wih, whh, bih, bhh, total;
  __host__ __device__ explicit BilGradLayout(int f) {
    wih = 0;
    whh = wih + 3 * f * f;
    bih = whh + 3 * f * f;
    bhh = bih + 3 * f;
    total = bhh + 3 * f;
  }
  // the padded accumulator element of flat element e
  __host__ __device__ int padded(int e, int f) const {
    if (e < bih) {
      const bool hh = e >= whh;
      const int i = e - (hh ? whh : wih);
      const int k = i / (3 * f), g = (i % (3 * f)) / f, j = i % f;
      return (hh ? kAWhh : kAWih) + k * 3 * FP + g * FP + j;
    }
    const bool hh = e >= bhh;
    const int i = e - (hh ? bhh : bih), g = i / f, j = i % f;
    return (hh && g == 2) ? kABhn + j : kABih + g * FP + j;
  }
};

struct BwdArgs {
  BilWeights w;
  const float* h0;              // (N, f), pre-masked
  const float* hist;            // (N, T·f) the forward's states h_1..h_T
  const float* msgs;            // (N, T·f) the forward's messages
  const float* ghist;           // (N, T·f) cotangent of hist
  const int* vid;               // (E)
  const int* src;               // (E)
  const int* dst;               // (E)
  const int* edge_order;        // (E) edge ids, stably sorted by dst
  const int* dst_ptr;           // (N + 1)
  const int* src_order;         // (E) edge ids, stably sorted by src
  const int* src_ptr;           // (N + 1)
  const int* graph_node_ptr;    // (G + 1)
  float* dh0;                   // (N, f)
  float* dw;                    // BilGradLayout(f).total
  float* scratch;               // grid·kAcc block rows
  int n_nodes, n_graphs, f, k_vocab, steps, max_nodes;
};

// The GRU VJP of one node at one step: ∂h (gin) → dmsg; the hidden path's
// ∂h0 added to dh0; the weight terms added to the thread's row `acc`.
// `hg` holds the node's hidden gates [gate·FP + j], hoisted out of the
// steps.
__device__ __forceinline__ void gru_backward(const float* w, const float* mb,
                                             const float* hp, const float* hg,
                                             const float* gin, float* dmsg,
                                             float* dh0, float* acc) {
  float gi[3][FP], gh[3][FP];
  gates(w, WL::kWih, WL::kBih, mb, gi);
#pragma unroll
  for (int gg = 0; gg < 3; ++gg)
#pragma unroll
    for (int j = 0; j < FP; ++j) gh[gg][j] = hg[gg * FP + j];
  float dar[FP], daz[FP], dan[FP], dnh[FP], dh[FP];
#pragma unroll
  for (int j = 0; j < FP; ++j) {
    const float sr = sigmoidf_(gi[0][j] + gh[0][j]);
    const float sz = sigmoidf_(gi[1][j] + gh[1][j]);
    const float tn = tanhf(gi[2][j] + sr * gh[2][j]);
    const float dz = gin[j] * (hp[j] - tn);
    dan[j] = gin[j] * (1.0f - sz) * (1.0f - tn * tn);
    dnh[j] = dan[j] * sr;
    dar[j] = dan[j] * gh[2][j] * sr * (1.0f - sr);
    daz[j] = dz * sz * (1.0f - sz);
    dh[j] = gin[j] * sz;
  }
#pragma unroll
  for (int k = 0; k < FP; ++k) {
    const float* wi = w + WL::kWih + k * 3 * FP;
    const float* wh = w + WL::kWhh + k * 3 * FP;
    float th = dh[k], ti = 0.f;
#pragma unroll
    for (int j = 0; j < FP; ++j) {
      th = fmaf(wh[j], dar[j], th);
      th = fmaf(wh[FP + j], daz[j], th);
      th = fmaf(wh[2 * FP + j], dnh[j], th);
      ti = fmaf(wi[j], dar[j], ti);
      ti = fmaf(wi[FP + j], daz[j], ti);
      ti = fmaf(wi[2 * FP + j], dan[j], ti);
      float* ai = acc + kAWih + k * 3 * FP;
      float* ah = acc + kAWhh + k * 3 * FP;
      ai[j] = fmaf(mb[k], dar[j], ai[j]);
      ai[FP + j] = fmaf(mb[k], daz[j], ai[FP + j]);
      ai[2 * FP + j] = fmaf(mb[k], dan[j], ai[2 * FP + j]);
      ah[j] = fmaf(hp[k], dar[j], ah[j]);
      ah[FP + j] = fmaf(hp[k], daz[j], ah[FP + j]);
      ah[2 * FP + j] = fmaf(hp[k], dnh[j], ah[2 * FP + j]);
    }
    dh0[k] += th;
    dmsg[k] = ti;
  }
#pragma unroll
  for (int j = 0; j < FP; ++j) {
    acc[kABih + j] += dar[j];
    acc[kABih + FP + j] += daz[j];
    acc[kABih + 2 * FP + j] += dan[j];
    acc[kABhn + j] += dnh[j];
  }
}

__global__ void __launch_bounds__(kThreads)
fused_bilinear_bwd_kernel(BwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float sm[];
  const int f = a.f, T = a.steps, ld = T * f, K = a.k_vocab;
  stage_bil_weights(sm, a.w, f, K);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = a.n_graphs, N = a.n_nodes, M = a.max_nodes;
  const int n_real = a.graph_node_ptr[G];
  float* accs = sm + WL::total(K);                   // kThreads·kAccStride
  float* acc = accs + tid * kAccStride;
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  float* base = accs + kThreads * kAccStride + size_t(warp) * M * kNodeFloats;
  float* s_h0 = base;                // [M][FP] each but s_gh
  float* s_gh = s_h0 + M * FP;       // [M][3·FP]
  float* s_hp = s_gh + M * 3 * FP;
  float* s_dm = s_hp + M * FP;
  float* s_in = s_dm + M * FP;
  float* s_out = s_in + M * FP;
  float* s_d0 = s_out + M * FP;
  {
    const size_t pad = size_t(N - n_real) * f;
    for (size_t i = size_t(blockIdx.x) * kThreads + tid; i < pad;
         i += size_t(gridDim.x) * kThreads)
      a.dh0[size_t(n_real) * f + i] = 0.f;
  }
  __syncthreads();

  for (int g = blockIdx.x * kWarps + warp; g < G; g += gridDim.x * kWarps) {
    const int n0 = a.graph_node_ptr[g], nn = a.graph_node_ptr[g + 1] - n0;
    for (int i = lane; i < nn; i += 32) {
      load_vec(a.h0 + size_t(n0 + i) * f, f, s_h0 + i * FP);
      float gh[3][FP];
      gates(sm + opaque_zero(), WL::kWhh, WL::kBhh, s_h0 + i * FP, gh);
#pragma unroll
      for (int j = 0; j < FP; ++j) {
        s_in[i * FP + j] = s_d0[i * FP + j] = 0.f;
#pragma unroll
        for (int gg = 0; gg < 3; ++gg)
          s_gh[i * 3 * FP + gg * FP + j] = gh[gg][j];
      }
    }
    __syncwarp();
    float* cin = s_in;
    float* cout = s_out;
    for (int t = T - 1; t >= 0; --t) {
      // the GRU VJP of every node, and h_{t-1} for the edge terms
      for (int i = lane; i < nn; i += 32) {
        const int v = n0 + i;
        const float* row = a.hist + size_t(v) * ld;
        float mb[FP], gin[FP];
        if (t > 0) load_vec(row + (t - 1) * f, f, s_hp + i * FP);
        else load_vec(s_h0 + i * FP, FP, s_hp + i * FP);
        load_vec(a.msgs + size_t(v) * ld + t * f, f, mb);
        load_vec(a.ghist + size_t(v) * ld + t * f, f, gin);
#pragma unroll
        for (int j = 0; j < FP; ++j) gin[j] += cin[i * FP + j];
        gru_backward(sm + opaque_zero(), mb, s_h0 + i * FP,
                     s_gh + i * 3 * FP, gin, s_dm + i * FP, s_d0 + i * FP,
                     acc);
      }
      __syncwarp();
      // the message's VJP into both endpoints of h_{t-1}
      for (int i = lane; i < nn; i += 32) {
        const int v = n0 + i;
        float d[FP], dmv[FP];
#pragma unroll
        for (int j = 0; j < FP; ++j) {
          d[j] = 0.f;
          dmv[j] = s_dm[i * FP + j];
        }
        int p1 = __ldg(a.dst_ptr + v + 1);
        for (int p = __ldg(a.dst_ptr + v); p < p1; ++p) {      // v = dst
          const int e = __ldg(a.edge_order + p);
          const int u = __ldg(a.src + e) - n0;
          float dphi[FP2];
          dphi_of(sm + opaque_zero() + WL::kA + __ldg(a.vid + e) * FP * FP2,
                  dmv, dphi);
#pragma unroll
          for (int n = 0; n < FP; ++n) {
            const float hs = s_hp[u * FP + n];
#pragma unroll
            for (int j = 0; j < FP; ++j) d[j] = fmaf(dphi[n * FP + j], hs, d[j]);
          }
        }
        p1 = __ldg(a.src_ptr + v + 1);
        for (int p = __ldg(a.src_ptr + v); p < p1; ++p) {      // v = src
          const int e = __ldg(a.src_order + p);
          const int w = __ldg(a.dst + e) - n0;
          float dphi[FP2], dmw[FP];
#pragma unroll
          for (int m = 0; m < FP; ++m) dmw[m] = s_dm[w * FP + m];
          dphi_of(sm + opaque_zero() + WL::kA + __ldg(a.vid + e) * FP * FP2,
                  dmw, dphi);
#pragma unroll
          for (int n = 0; n < FP; ++n) {
            float s = d[n];
#pragma unroll
            for (int j = 0; j < FP; ++j)
              s = fmaf(dphi[n * FP + j], s_hp[w * FP + j], s);
            d[n] = s;
          }
        }
#pragma unroll
        for (int j = 0; j < FP; ++j) cout[i * FP + j] = d[j];
      }
      __syncwarp();
      float* tmp = cin;
      cin = cout;
      cout = tmp;
    }
    for (int i = lane; i < nn; i += 32) {
      float d[FP];
#pragma unroll
      for (int j = 0; j < FP; ++j) d[j] = s_d0[i * FP + j] + cin[i * FP + j];
      store_vec(a.dh0 + size_t(n0 + i) * f, f, d);
    }
    __syncwarp();
  }

  // ---- the GRU gradient: thread rows → block row → block order ----------
  __syncthreads();
  float* wpart = a.scratch;                                   // grid·kAcc
  for (int e = tid; e < kAcc; e += kThreads) {
    float s = 0.f;
    for (int i = 0; i < kThreads; ++i) s += accs[i * kAccStride + e];
    wpart[size_t(blockIdx.x) * kAcc + e] = s;
  }
  grid.sync();
  const BilGradLayout gl(f);
  for (int e = blockIdx.x * kThreads + tid; e < gl.total;
       e += gridDim.x * kThreads) {
    const int pe = gl.padded(e, f);
    float s = 0.f;
    for (int b = 0; b < int(gridDim.x); ++b)
      s += __ldcg(wpart + size_t(b) * kAcc + pe);
    a.dw[e] = s;
  }
}

size_t smem_bytes(int k_vocab, int max_nodes) {
  return sizeof(float) * (size_t(WL::total(k_vocab)) +
                          size_t(kThreads) * kAccStride +
                          size_t(kWarps) * max_nodes * kNodeFloats);
}

}  // namespace

extern "C" {

int mpnn_fused_bilinear_bwd_smem_bytes(int k_vocab, int max_nodes) {
  return int(smem_bytes(k_vocab, max_nodes));
}

// The 5 offsets of the flat gradient layout (BilGradLayout), total last.
void mpnn_fused_bilinear_bwd_layout(int f, int* out) {
  const BilGradLayout g(f);
  const int v[5] = {g.wih, g.whh, g.bih, g.bhh, g.total};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
}

long long mpnn_fused_bilinear_bwd_scratch_floats(int grid) {
  return (long long)grid * kAcc;
}

int mpnn_fused_bilinear_bwd_grid(int k_vocab, int max_nodes, int n_graphs) {
  const size_t bytes = smem_bytes(k_vocab, max_nodes);
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaFuncSetAttribute(fused_bilinear_bwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(bytes)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fused_bilinear_bwd_kernel, kThreads, bytes) !=
          cudaSuccess)
    return 0;
  return min(per_sm * sms, max((n_graphs + kWarps - 1) / kWarps, 1));
}

int mpnn_fused_bilinear_bwd(
    const float* amat, const float* w_ih, const float* w_hh,
    const float* b_ih, const float* b_hh, const float* h0,
    const float* hist, const float* msgs, const float* ghist,
    const int* vid, const int* src, const int* dst, const int* edge_order,
    const int* dst_ptr, const int* src_order, const int* src_ptr,
    const int* graph_node_ptr, float* dh0, float* dw, float* scratch,
    int n_nodes, int n_graphs, int f, int k_vocab, int steps, int max_nodes,
    int grid, void* stream) {
  if (f < 1 || f > FP || k_vocab < 1 || k_vocab > kMaxVocab ||
      n_graphs < 1 || steps < 1 || max_nodes < 1 ||
      max_nodes > kMaxGraphNodes || grid < 1)
    return int(cudaErrorInvalidValue);
  BwdArgs a{{amat, w_ih, w_hh, b_ih, b_hh}, h0, hist, msgs, ghist, vid,
            src, dst, edge_order, dst_ptr, src_order, src_ptr,
            graph_node_ptr, dh0, dw, scratch, n_nodes, n_graphs, f,
            k_vocab, steps, max_nodes};
  const size_t bytes = smem_bytes(k_vocab, max_nodes);
  cudaError_t err = cudaFuncSetAttribute(
      fused_bilinear_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (err != cudaSuccess) return int(err);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)fused_bilinear_bwd_kernel,
                                    dim3(grid), dim3(kThreads), args, bytes,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
