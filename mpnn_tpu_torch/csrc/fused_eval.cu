// Whole-step INFERENCE kernel of the shared-weight edge-network MPNN
// (the flagship `lipo` serving path), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mpnn_tpu/kernels/fused_step.py::_eval_kernel
// (public entry make_fused_eval_op). Same function, per real node d of
// graph g, with every BatchNorm folded to a per-feature affine on the host:
//
//   m_d  = Σ_{e: dst_e = d} A[vid_e]·h0[src_e]  +  A0·S_g  +  mbias,
//          S_g = Σ_{w ∈ g} h0[w]                      (A0 bias leakage)
//   mb_d = ma_scale ⊙ m_d + ma_shift                   (msg norm, folded)
//   gi_d = W_ihᵀ·mb_d + b_ih                           (constant over steps)
//   h    = h0[d];  T × { GRU(gi_d, h);  h = s_scale ⊙ h + s_shift }
//   out_g = Σ_{d ∈ g} softmax_od(W_iᵀ[h ‖ h0_d] + b_i) ⊙ (W_jᵀ[h ‖ h0_d] + b_j)
//
// Design. Messages flow only inside a graph, and the packed batch lays a
// graph's nodes and edges out contiguously, so ONE WARP owns ONE GRAPH:
// no cross-warp dependency, no atomics, and each graph's output is written
// once by lane 0 — the result does not depend on launch order. Each lane
// owns whole nodes (lane, lane+32, ...) and carries its node through the
// message sum, the T recurrent steps and the readout in registers: with
// the norms folded there is no cross-node statistic inside the
// recurrence. Per-graph sums (S_g and the readout) are xor-butterfly warp
// reductions, which give every lane the bit-identical total. Incoming
// edges are summed in the host plan's stable destination-sorted order
// (edge_order / dst_ptr), the order the plain version's index_add_ takes
// on the CPU. All weights (amat K·f·f, A0, GRU 2·f·3f, affines, readout
// 2·(2f)·od) live in shared memory, zero-padded to FP/ODP: padded features
// stay exactly 0 through every stage, and padded readout outputs are kept
// out of the softmax.
//
// Past ODP 64 (the od-128 build) the readout weights are read, zero-padded,
// from device memory (kernels/fused_step.py::ro_table), and a lane's
// od-long logits would spill: the lanes stage 32 nodes' [h ‖ h0] rows in
// shared memory and the warp computes each node's readout with lanes over
// od (fused_train_common.cuh::warp_readout_rows).
//
// The STATELESS state norm normalizes by the batch's own per-step mean and
// var (eps 1e-6 inside the sqrt), so a graph's output depends on its batch
// and a warp cannot serve its graph alone. That mode has a kernel of its
// own, fused_eval_stateless_kernel: the training forward's body
// (fused_step_forward.cuh) without the loss, the stats output and the
// stash — a node on a group of lanes, each block owning whole graphs, the
// per-step statistics from block partials combined in block order (one
// cluster, or co-resident blocks through per-launch flags), no grid
// barrier, no float atomics.
//
// Bound on an H100 SXM: f32 CUDA-core arithmetic (no tensor-core shape
// fits f = 10); at the flagship batch of 1024 molecules the work is
// ~1e8 flop against ~1 MB of traffic, so operations bound it (67 TFLOP/s
// f32) and launch latency dominates in practice. chip_smoke.py recounts
// the bound from the run's own shapes.

#include <cuda_runtime.h>
#include <math.h>

#include "fused_step_forward.cuh"
#include "unroll.cuh"

namespace {

constexpr int kWarps = 4;            // graphs per block
constexpr unsigned kFull = 0xffffffffu;

struct EvalArgs {
  const float* amat;       // (K, f, f): message = amat[k] @ h0[src]
  const float* a0;         // (f, f)
  const float* mbias;      // (f)
  const float* h0;         // (N, f), pre-masked
  const float* w_ih;       // (f, 3f), gates r|z|n
  const float* w_hh;       // (f, 3f)
  const float* b_ih;       // (3f)
  const float* b_hh;       // (3f)
  const float* ma_scale;   // (f) folded message norm
  const float* ma_shift;
  const float* s_scale;    // (f) folded state norm
  const float* s_shift;
  const float* ro_iw;      // (2f, od)
  const float* ro_ib;      // (od)
  const float* ro_jw;      // (2f, od)
  const float* ro_jb;      // (od)
  const int* vid;          // (E)
  const int* src;          // (E)
  const int* edge_order;   // (E) edge ids, stably sorted by destination
  const int* dst_ptr;      // (N + 1) row pointers into edge_order
  const int* graph_node_ptr;  // (G + 1) node range of each graph
  float* out;              // (G, od)
  int n_graphs, f, od, k_vocab, steps;
};

template <int FP, int ODP>
struct Smem {
  // offsets (in floats) of each zero-padded weight block
  static constexpr int kA0 = 0;
  static constexpr int kWih = kA0 + FP * FP;
  static constexpr int kWhh = kWih + FP * 3 * FP;
  static constexpr int kBih = kWhh + FP * 3 * FP;
  static constexpr int kBhh = kBih + 3 * FP;
  static constexpr int kVec = kBhh + 3 * FP;     // mbias, ma_scale,
  static constexpr int kRiw = kVec + 5 * FP;     // ma_shift, s_scale, s_shift
  // the readout weights in shared memory up to ODP 64; past it in device
  // memory, and each warp's 32 staged rows [h | h0] in their place
  static constexpr bool kRoInSmem = ODP <= 64;
  static constexpr int kRo = kRoInSmem ? 2 * FP * ODP : 0;
  static constexpr int kRowStride = 2 * FP + 1;
  static constexpr int kOdLanes = ODP >= 32 ? ODP / 32 : 1;
  static constexpr int kRjw = kRiw + kRo;
  static constexpr int kRib = kRjw + kRo;
  static constexpr int kRjb = kRib + ODP;
  static constexpr int kRows = kRjb + ODP;
  static constexpr int kAmat =                   // then K·FP·FP (narrow)
      kRows + (kRoInSmem ? 0 : kWarps * 32 * kRowStride);
  // past FP 16 the vocab tables are read, zero-padded, from device memory
  static constexpr bool kVocabInSmem = FP <= 16;
  static size_t bytes(int k_vocab) {
    return sizeof(float) *
           (size_t(kAmat) + (kVocabInSmem ? size_t(k_vocab) * FP * FP : 0));
  }
};

// An integer 0 the compiler cannot see through.
__device__ __forceinline__ int opaque_zero() {
  int z = 0;
  asm volatile("" : "+r"(z));
  return z;
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Messages, GRU input gates and the T recurrent steps of real node n of a
// graph whose A0·S_g is `base`: h = h_T (after the folded state norm) and
// h0n = h0[n], in registers.
template <int FP, int ODP>
__device__ __forceinline__ void node_forward(const EvalArgs& a,
                                             const float* sm, int n,
                                             const float* base, float* h,
                                             float* h0n) {
  using L = Smem<FP, ODP>;
  const int f = a.f;
  const float* __restrict__ h0 = a.h0;
  const float* w = sm + opaque_zero();
  // ---- messages: edges into n, destination-sorted order ---------------
  float msg[FP];
MPNN_UNROLL
  for (int m = 0; m < FP; ++m) msg[m] = 0.f;
  const int p1 = __ldg(a.dst_ptr + n + 1);
  for (int p = __ldg(a.dst_ptr + n); p < p1; ++p) {
    const int e = __ldg(a.edge_order + p);
    const int sn = __ldg(a.src + e);
    const float* am = (L::kVocabInSmem ? w + L::kAmat : a.amat) +
                      __ldg(a.vid + e) * FP * FP;
    float hs[FP];
MPNN_UNROLL
    for (int j = 0; j < FP; ++j)
      hs[j] = j < f ? __ldg(h0 + size_t(sn) * f + j) : 0.f;
MPNN_UNROLL
    for (int m = 0; m < FP; ++m) {
      float t = 0.f;
MPNN_UNROLL
      for (int j = 0; j < FP; ++j) t = fmaf(am[m * FP + j], hs[j], t);
      msg[m] += t;
    }
  }
  // ---- + A0·S_g + bias, folded msg norm, GRU input gates --------------
  float mb[FP];
MPNN_UNROLL
  for (int m = 0; m < FP; ++m) {
    float v = (msg[m] + base[m]) + w[L::kVec + m];
    mb[m] = w[L::kVec + FP + m] * v + w[L::kVec + 2 * FP + m];
  }
  float gi[3 * FP];
MPNN_UNROLL
  for (int c = 0; c < 3 * FP; ++c) {
    float t = 0.f;
MPNN_UNROLL
    for (int k = 0; k < FP; ++k) t = fmaf(mb[k], w[L::kWih + k * 3 * FP + c], t);
    gi[c] = t + w[L::kBih + c];
  }
MPNN_UNROLL
  for (int j = 0; j < FP; ++j) {
    h0n[j] = j < f ? __ldg(h0 + size_t(n) * f + j) : 0.f;
    h[j] = h0n[j];
  }
  // ---- T × [GRU → folded state norm] ----------------------------------
  for (int t = 0; t < a.steps; ++t) {
    const float* ws = w + opaque_zero();
    float hn[FP];
MPNN_UNROLL
    for (int j = 0; j < FP; ++j) {
      float rh = 0.f, zh = 0.f, nh = 0.f;
MPNN_UNROLL
      for (int k = 0; k < FP; ++k) {
        const float* wr = ws + L::kWhh + k * 3 * FP;
        rh = fmaf(h[k], wr[j], rh);
        zh = fmaf(h[k], wr[FP + j], zh);
        nh = fmaf(h[k], wr[2 * FP + j], nh);
      }
      rh += ws[L::kBhh + j];
      zh += ws[L::kBhh + FP + j];
      nh += ws[L::kBhh + 2 * FP + j];
      const float r = sigmoidf_(gi[j] + rh);
      const float z = sigmoidf_(gi[FP + j] + zh);
      const float nn = tanhf(gi[2 * FP + j] + r * nh);
      const float hp = (1.0f - z) * nn + z * h[j];
      hn[j] = ws[L::kVec + 3 * FP + j] * hp + ws[L::kVec + 4 * FP + j];
    }
MPNN_UNROLL
    for (int j = 0; j < FP; ++j) h[j] = hn[j];
  }
}

template <int FP, int ODP>
__global__ void __launch_bounds__(32 * kWarps)
fused_eval_kernel(EvalArgs a) {
  using L = Smem<FP, ODP>;
  extern __shared__ float sm[];
  const int f = a.f, od = a.od;

  // ---- stage every weight into shared memory, zero-padded -------------
  for (int i = threadIdx.x; i < FP * FP; i += blockDim.x) {
    int r = i / FP, c = i % FP;
    sm[L::kA0 + i] = (r < f && c < f) ? a.a0[r * f + c] : 0.f;
  }
  for (int i = threadIdx.x; i < FP * 3 * FP; i += blockDim.x) {
    int r = i / (3 * FP), gc = i % (3 * FP), g = gc / FP, c = gc % FP;
    bool in = r < f && c < f;
    sm[L::kWih + i] = in ? a.w_ih[r * 3 * f + g * f + c] : 0.f;
    sm[L::kWhh + i] = in ? a.w_hh[r * 3 * f + g * f + c] : 0.f;
  }
  for (int i = threadIdx.x; i < 3 * FP; i += blockDim.x) {
    int g = i / FP, c = i % FP;
    sm[L::kBih + i] = c < f ? a.b_ih[g * f + c] : 0.f;
    sm[L::kBhh + i] = c < f ? a.b_hh[g * f + c] : 0.f;
  }
  for (int i = threadIdx.x; i < FP; i += blockDim.x) {
    bool in = i < f;
    sm[L::kVec + 0 * FP + i] = in ? a.mbias[i] : 0.f;
    sm[L::kVec + 1 * FP + i] = in ? a.ma_scale[i] : 0.f;
    sm[L::kVec + 2 * FP + i] = in ? a.ma_shift[i] : 0.f;
    sm[L::kVec + 3 * FP + i] = in ? a.s_scale[i] : 0.f;
    sm[L::kVec + 4 * FP + i] = in ? a.s_shift[i] : 0.f;
  }
  for (int i = threadIdx.x; L::kRoInSmem && i < 2 * FP * ODP;
       i += blockDim.x) {
    // padded row r: [h (FP) | h0 (FP)] → source row (r < FP ? r : f + r - FP)
    int r = i / ODP, o = i % ODP, half = r / FP, k = r % FP;
    bool in = k < f && o < od;
    int srow = half * f + k;
    sm[L::kRiw + i] = in ? a.ro_iw[srow * od + o] : 0.f;
    sm[L::kRjw + i] = in ? a.ro_jw[srow * od + o] : 0.f;
  }
  for (int i = threadIdx.x; i < ODP; i += blockDim.x) {
    sm[L::kRib + i] = i < od ? a.ro_ib[i] : 0.f;
    sm[L::kRjb + i] = i < od ? a.ro_jb[i] : 0.f;
  }
  for (int i = threadIdx.x; L::kVocabInSmem && i < a.k_vocab * FP * FP;
       i += blockDim.x) {
    int k = i / (FP * FP), rc = i % (FP * FP), r = rc / FP, c = rc % FP;
    sm[L::kAmat + i] =
        (r < f && c < f) ? a.amat[(k * f + r) * f + c] : 0.f;
  }
  __syncthreads();
  // Weights are read from shared memory at each use (a broadcast: every
  // lane reads the same address). Offsetting the weight pointer by
  // opaque_zero() in every node and step iteration hides that it is the
  // same pointer each time: otherwise the compiler hoists hundreds of
  // loop-invariant weights into registers and spills them to local
  // memory. Within an iteration it still schedules the loads freely.
  const float* w = sm;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = blockIdx.x * kWarps + warp;
  if (g >= a.n_graphs) return;
  const int n0 = a.graph_node_ptr[g], n1 = a.graph_node_ptr[g + 1];
  const float* __restrict__ h0 = a.h0;

  // ---- S_g = Σ_{w∈g} h0[w], then base = A0·S_g -------------------------
  float s[FP];
MPNN_UNROLL
  for (int j = 0; j < FP; ++j) s[j] = 0.f;
  for (int n = n0 + lane; n < n1; n += 32) {
MPNN_UNROLL
    for (int j = 0; j < FP; ++j)
      if (j < f) s[j] += __ldg(h0 + size_t(n) * f + j);
  }
MPNN_UNROLL
  for (int j = 0; j < FP; ++j) {
MPNN_UNROLL
    for (int off = 16; off > 0; off >>= 1)
      s[j] += __shfl_xor_sync(kFull, s[j], off);
  }
  float base[FP];
MPNN_UNROLL
  for (int m = 0; m < FP; ++m) {
    float t = 0.f;
MPNN_UNROLL
    for (int j = 0; j < FP; ++j) t = fmaf(w[L::kA0 + m * FP + j], s[j], t);
    base[m] = t;
  }

  if constexpr (L::kRoInSmem) {
    float acc[ODP];
MPNN_UNROLL
    for (int o = 0; o < ODP; ++o) acc[o] = 0.f;
    for (int n = n0 + lane; n < n1; n += 32) {
      const float* w = sm + opaque_zero();
      float h[FP], h0n[FP];
      node_forward<FP, ODP>(a, sm, n, base, h, h0n);
      // ---- gated readout over [h_T ‖ h0], softmax over od ------------------
      float pi[ODP], pj[ODP];
MPNN_UNROLL
      for (int o = 0; o < ODP; ++o) {
        float ti = 0.f, tj = 0.f;
MPNN_UNROLL
        for (int k = 0; k < FP; ++k) {
          ti = fmaf(h[k], w[L::kRiw + k * ODP + o], ti);
          tj = fmaf(h[k], w[L::kRjw + k * ODP + o], tj);
        }
MPNN_UNROLL
        for (int k = 0; k < FP; ++k) {
          ti = fmaf(h0n[k], w[L::kRiw + (FP + k) * ODP + o], ti);
          tj = fmaf(h0n[k], w[L::kRjw + (FP + k) * ODP + o], tj);
        }
        pi[o] = ti + w[L::kRib + o];
        pj[o] = tj + w[L::kRjb + o];
      }
      float mx = -INFINITY;
MPNN_UNROLL
      for (int o = 0; o < ODP; ++o)
        if (o < od) mx = fmaxf(mx, pi[o]);
      float den = 0.f;
MPNN_UNROLL
      for (int o = 0; o < ODP; ++o) {
        pi[o] = o < od ? expf(pi[o] - mx) : 0.f;
        den += pi[o];
      }
MPNN_UNROLL
      for (int o = 0; o < ODP; ++o) acc[o] += (pi[o] / den) * pj[o];
    }

    // ---- per-graph sum of the gated rows ----------------------------------
MPNN_UNROLL
    for (int o = 0; o < ODP; ++o) {
MPNN_UNROLL
      for (int off = 16; off > 0; off >>= 1)
        acc[o] += __shfl_xor_sync(kFull, acc[o], off);
    }
    if (lane == 0) {
MPNN_UNROLL
      for (int o = 0; o < ODP; ++o)
        if (o < od) a.out[size_t(g) * od + o] = acc[o];
    }
  } else {
    float acc[L::kOdLanes];
MPNN_UNROLL
    for (int q = 0; q < L::kOdLanes; ++q) acc[q] = 0.f;
    float* xr = sm + L::kRows + warp * 32 * L::kRowStride;
    for (int b = n0; b < n1; b += 32) {
      float h[FP], h0n[FP];
      if (b + lane < n1) {
        node_forward<FP, ODP>(a, sm, b + lane, base, h, h0n);
      } else {
MPNN_UNROLL
        for (int j = 0; j < FP; ++j) h[j] = h0n[j] = 0.f;
      }
      __syncwarp();                        // the last round's rows read
MPNN_UNROLL
      for (int j = 0; j < FP; ++j) {
        xr[lane * L::kRowStride + j] = h[j];
        xr[lane * L::kRowStride + FP + j] = h0n[j];
      }
      __syncwarp();
      mpnn_train::warp_readout_rows<L::kRowStride>(
          xr, min(32, n1 - b), a.ro_iw, a.ro_jw, sm + L::kRib, sm + L::kRjb,
          od, acc);
    }
MPNN_UNROLL
    for (int q = 0; q < L::kOdLanes; ++q)
      if (lane + 32 * q < od) a.out[size_t(g) * od + lane + 32 * q] = acc[q];
  }
}

template <int FP, int ODP>
cudaError_t launch(const EvalArgs& a, cudaStream_t stream) {
  const size_t bytes = Smem<FP, ODP>::bytes(a.k_vocab);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_eval_kernel<FP, ODP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (a.n_graphs + kWarps - 1) / kWarps;
  if (blocks > 0)
    fused_eval_kernel<FP, ODP><<<blocks, 32 * kWarps, bytes, stream>>>(a);
  return cudaGetLastError();
}

// The width bucket, zero-padded: f <= kMaxWidth, od <= kMaxOut
// (fused_train_common.cuh's MPNN_FP, MPNN_ODP). The narrow build takes 16
// and 16 (the flagship at bench widths: f = 10, od = 14), the others of
// kernels/fused_step.py::BUCKETS their -D defines (kernels/build.py). Past
// f 16 `amat` arrives zero-padded to (K, 32, 32); past od 64 the readout
// weights to (2·FP, ODP).
constexpr int kMaxWidth = mpnn_train::FP;
constexpr int kMaxOut = mpnn_train::ODP;

}  // namespace

namespace stateless {

using namespace mpnn_step;

__global__ void __launch_bounds__(kFT, 1)
fused_eval_stateless_kernel(FwdArgs a) {
  step_forward<false>(a);
}

}  // namespace stateless

extern "C" {

// Dynamic shared memory of one block, in bytes, for a vocab of k_vocab.
int mpnn_fused_eval_smem_bytes(int k_vocab) {
  return int(Smem<kMaxWidth, kMaxOut>::bytes(k_vocab));
}

// Launches on `stream` and returns cudaGetLastError() of the launch
// (0 = success). Does not synchronize and allocates nothing.
int mpnn_fused_eval(const float* amat, const float* a0, const float* mbias,
                    const float* h0, const float* w_ih, const float* w_hh,
                    const float* b_ih, const float* b_hh,
                    const float* ma_scale, const float* ma_shift,
                    const float* s_scale, const float* s_shift,
                    const float* ro_iw, const float* ro_ib,
                    const float* ro_jw, const float* ro_jb,
                    const int* vid, const int* src, const int* edge_order,
                    const int* dst_ptr, const int* graph_node_ptr,
                    float* out, int n_graphs, int f, int od, int k_vocab,
                    int steps, void* stream) {
  EvalArgs a{amat, a0, mbias, h0, w_ih, w_hh, b_ih, b_hh,
             ma_scale, ma_shift, s_scale, s_shift,
             ro_iw, ro_ib, ro_jw, ro_jb,
             vid, src, edge_order, dst_ptr, graph_node_ptr, out,
             n_graphs, f, od, k_vocab, steps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f > kMaxWidth || od > kMaxOut) return int(cudaErrorInvalidValue);
  return int(launch<kMaxWidth, kMaxOut>(a, s));
}

// The serving kernel of the stateless state norm: its dynamic shared
// memory in bytes at node capacity ncap and edge capacity ecap in a
// launch of `blocks` blocks, its scratch in floats and its co-resident
// blocks (0 on error); its routes and flags are the training forward's
// (fused_step_forward.cuh).
int mpnn_fused_eval_stateless_smem_bytes(int k_vocab, int steps, int ncap,
                                         int ecap, int blocks) {
  return int(mpnn_step::fwd_smem_bytes(k_vocab, steps, ncap, ecap, blocks));
}

long long mpnn_fused_eval_stateless_scratch_floats(int n_nodes, int n_edges,
                                                   int n_graphs, int steps,
                                                   int grid) {
  return (long long)mpnn_step::Scratch(n_nodes, n_edges, n_graphs, steps,
                                       grid).total;
}

int mpnn_fused_eval_stateless_max_grid(int bytes) {
  return mpnn_step::forward_max_grid(stateless::fused_eval_stateless_kernel,
                                     bytes);
}

// Launches the stateless-norm serving kernel on `stream` and returns the
// launch's error code. msg_mode is kNone or kAffine (ma_scale, ma_shift:
// the folded eval bn1d). route, grid, counters, ncap, ecap, floor and
// prof as mpnn_fused_step_fwd's. Does not synchronize and allocates
// nothing.
int mpnn_fused_eval_stateless(
    const float* amat, const float* a0, const float* mbias, const float* h0,
    const float* w_ih, const float* w_hh, const float* b_ih,
    const float* b_hh, const float* ma_scale, const float* ma_shift,
    const float* ro_iw, const float* ro_ib, const float* ro_jw,
    const float* ro_jb, const int* vid, const int* src,
    const int* edge_order, const int* dst_ptr, const int* graph_node_ptr,
    float* out, float* scratch, int* counters, long long* prof, int n_nodes,
    int n_graphs, int n_edges, int f, int od, int k_vocab, int steps,
    int msg_mode, int route, int grid, int ncap, int ecap, int floor,
    void* stream) {
  using namespace mpnn_step;
  if (msg_mode != kNone && msg_mode != kAffine)
    return int(cudaErrorInvalidValue);
  FwdArgs a{{amat, a0, mbias, w_ih, w_hh, b_ih, b_hh, ma_scale, ma_shift,
             nullptr, nullptr, ro_iw, ro_ib, ro_jw, ro_jb},
            h0, nullptr, nullptr, vid, src, edge_order, dst_ptr,
            graph_node_ptr, nullptr, out, nullptr, nullptr, scratch,
            counters, prof, n_nodes, n_graphs, n_edges, f, od, k_vocab, steps,
            msg_mode, kStateless, route, route == kRouteCluster ? grid : 1,
            ncap, ecap, floor};
  if (const int err = check_route(a, grid)) return err;
  return launch_forward(stateless::fused_eval_stateless_kernel, a, grid,
                        stream);
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
