// Readout + loss VJP of the split training backward, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel mpnn_tpu/kernels/fused_step.py::_ro_bwd_kernel,
// the first launch of both JAX families' split backwards (make_fused_step_
// op's and, through _streaming_bwd, make_fused_psteps_op's). Per real node
// v of graph g (mask m_v = 1), with x = [h_T,v | h0_v]:
//
//   dout_g = gl·2(out_g − y_g)·gm_g/Σgm + gout_g
//   sm     = softmax_od(x·W_i + b_i),  pj = x·W_j + b_j
//   djv    = dout_g ⊙ sm,  dsm = dout_g ⊙ pj,  dpi = sm ⊙ (dsm − Σ dsm·sm)
//   gh_v   = W_i[:f]·dpi + W_j[:f]·djv,  dh0_v = W_i[f:]·dpi + W_j[f:]·djv
//   dW_i   = Σ_v xᵀ·dpi, db_i = Σ_v dpi; dW_j, db_j likewise with djv
//
// and zero rows at padded nodes (mask 0, the dummy node among them). h_T
// is rebuilt from its pre-norm slot x̃ and the slot's (mean, var) through
// the state norm (bn1d with its affine, the stateless norm, or none), as
// the forward normalized it.
//
// Bound on an H100 SXM: per node 4·2f·od flop of products (the logits,
// the values, gh and dh0) and 2·2f·od of weight-gradient sums, over the
// bytes of x̃, h0, gh and dh0 (16f bytes a node): at the per-step family's
// b3584 (57.8k slots, f 8, od 16) ~1.5 us by bytes and ~0.5 us of f32
// arithmetic; at od 128 the arithmetic bounds it.
//
// Design: one thread per node on 128-node chunks (the layout of the
// whole-step backward's readout phase, csrc/fused_psteps_bwd.cu, whose
// arithmetic this repeats). A node's terms [h | h0 | dpi | djv] are staged
// in shared memory per chunk; each weight-gradient element is owned by one
// thread of the block, which sums them in node order into the block's row
// of partials. A second launch sums the rows in block order. No float
// atomics: the result depends on the data and the grid only.

#include "fused_psteps_common.cuh"

namespace {

using namespace mpnn_psteps;

struct RoArgs {
  const float* x;           // (N, f) h_T's pre-norm slot
  const float* stats;       // (2, f) that slot's mean, biased var
  const float* norm_w;      // (f) state-norm affine (bn1d)
  const float* norm_b;      // (f)
  const float* h0;          // (N, f)
  const float* mask;        // (N, 1), 0/1
  const int* node_graph;    // (N)
  const float* iw;          // (2f, od); (2FP, ODW) zero-padded if !kWInSmem
  const float* ib;          // (od)
  const float* jw;
  const float* jb;
  const float* labels;      // (G)
  const float* gmask;       // (G)
  const float* out;         // (G, od) forward output
  const float* gout;        // (G, od) cotangent of out
  const float* gl;          // (1) cotangent of the loss
  float* gh;                // (N, f)
  float* dh0;               // (N, f)
  float* dw;                // RoLayout(f, od).total
  float* part;              // (grid, RoLayout.total) block partial rows
  int n_nodes, n_graphs, f, od, state_mode;
};

struct CombineArgs {
  const float* part;
  float* dw;
  int rows, width;
};

// Flat layout of the weight gradient (and of each partial row):
// kernels/readout_bwd.py::grad_layout mirrors it.
struct RoLayout {
  int iw, ib, jw, jb, total;
  __host__ __device__ RoLayout(int f, int od) {
    iw = 0;
    ib = iw + 2 * f * od;
    jw = ib + od;
    jb = jw + 2 * f * od;
    total = jb + od;
  }
};

// The readout weights sit in shared memory in the narrow bucket; the wide
// one (ODW 128: 64 KB of them) leaves the room to the staged rows and
// reads them zero-padded from device memory (kernels/fused_step.py::
// ro_table).
constexpr bool kWInSmem = ODW <= 32;
constexpr int kW = kWInSmem ? 2 * 2 * FP * ODW : 0;
// staged per node: [h (FP) | h0 (FP) | dpi (ODW) | djv (ODW)], odd stride
constexpr int kRoStage = 2 * FP + 2 * ODW + 1;

// shared memory: [W_i | W_j] (kW), b_i, b_j (ODW each), the slot's mean,
// s, d and the norm's affine (FP each), the block's Σ gm scratch
// (kThreads), the staged rows (kChunk · kRoStage)
constexpr int kOffB = kW;
constexpr int kOffSt = kOffB + 2 * ODW;
constexpr int kOffRed = kOffSt + 5 * FP;
constexpr int kOffXs = kOffRed + kThreads;

__host__ __device__ inline size_t ro_smem_floats() {
  return size_t(kOffXs) + size_t(kChunk) * kRoStage;
}

__global__ void __launch_bounds__(kThreads) ro_bwd_kernel(RoArgs a) {
  extern __shared__ float sm[];
  const int f = a.f, od = a.od, N = a.n_nodes, G = a.n_graphs;
  const int tid = threadIdx.x;
  const RoLayout L(f, od);
  float* wrow = a.part + size_t(blockIdx.x) * L.total;
  float* st = sm + kOffSt;
  float* red = sm + kOffRed;
  float* xs = sm + kOffXs;

  // ---- set-up: weights, the slot's constants, Σ gm, a zeroed row --------
  for (int i = tid; kWInSmem && i < 2 * FP * ODW; i += kThreads) {
    const int r = i / ODW, o = i % ODW, half = r / FP, k = r % FP;
    const bool in = k < f && o < od;
    const int srow = half * f + k;
    sm[i] = in ? a.iw[srow * od + o] : 0.f;
    sm[2 * FP * ODW + i] = in ? a.jw[srow * od + o] : 0.f;
  }
  for (int o = tid; o < ODW; o += kThreads) {
    sm[kOffB + o] = o < od ? a.ib[o] : 0.f;
    sm[kOffB + ODW + o] = o < od ? a.jb[o] : 0.f;
  }
  for (int j = tid; j < FP; j += kThreads) {
    const bool in = j < f;
    if (has_stats(a.state_mode))
      set_slot(st, j, in ? a.stats[j] : 0.f, in ? a.stats[f + j] : 0.f,
               a.state_mode == kStateless);
    else
      set_slot(st, j, 0.f, 1.f, true);          // unused: mean 0, d 1
    st[3 * FP + j] = in ? a.norm_w[j] : 0.f;
    st[4 * FP + j] = in ? a.norm_b[j] : 0.f;
  }
  for (int e = first_owned(0); e < L.total; e += kThreads) wrow[e] = 0.f;
  {
    float s = 0.f;
    for (int g = tid; g < G; g += kThreads) s += a.gmask[g];
    red[tid] = s;
  }
  __syncthreads();
  float gsum = 0.f;
  for (int i = 0; i < kThreads; ++i) gsum += red[i];
  const float inv_gsum = 1.0f / gsum;
  const float gl_v = a.gl[0];
  const float* riw = kWInSmem ? sm : a.iw;
  const float* rjw = kWInSmem ? sm + 2 * FP * ODW : a.jw;
  const float* rib = sm + kOffB;
  const float* rjb = sm + kOffB + ODW;

  const int nchunks = (N + kChunk - 1) / kChunk;
  for (int ch = blockIdx.x; ch < nchunks; ch += gridDim.x) {
    const int n = ch * kChunk + tid;
    float* row = xs + tid * kRoStage;
    const float m = n < N ? a.mask[n] : 0.f;
    if (m != 0.f) {
      const int g = a.node_graph[n];
      float xr[FP], h[FP], xh[FP], h0n[FP];
      load_row(a.x, n, f, xr);
      apply_norm(a.state_mode, st, st + 3 * FP, st + 4 * FP, xr, h, xh);
      load_row(a.h0, n, f, h0n);
MPNN_UNROLL
      for (int k = 0; k < FP; ++k) {
        h[k] *= m;
        h0n[k] *= m;
      }
      // the logits, their softmax and the cotangents go through the
      // node's staged row (its dpi and djv columns), not an ODW-long
      // register array: at od 32 that array and the unrolled loops over
      // it spilled 4.5 KB a thread
      float* rp = row + 2 * FP;                        // logits → dpi
      float* rj = row + 2 * FP + ODW;                  // dsm → djv
      float mx = -INFINITY;
#pragma unroll 4
      for (int o = 0; o < ODW; ++o) {
        float ti = rib[o];
MPNN_UNROLL
        for (int k = 0; k < FP; ++k) {
          ti = fmaf(h[k], riw[k * ODW + o], ti);
          ti = fmaf(h0n[k], riw[(FP + k) * ODW + o], ti);
        }
        rp[o] = ti;
        if (o < od) mx = fmaxf(mx, ti);
      }
      float den = 0.f;
#pragma unroll 4
      for (int o = 0; o < ODW; ++o) {
        const float ex = o < od ? expf(rp[o] - mx) : 0.f;
        rp[o] = ex;
        den += ex;
      }
      const float y = a.labels[g], gmv = a.gmask[g];
      const float* outg = a.out + size_t(g) * od;
      const float* goutg = a.gout + size_t(g) * od;
      auto dout_of = [&](int o) {
        return o < od ? m * (gl_v * 2.0f * (outg[o] - y) * gmv * inv_gsum +
                             goutg[o])
                      : 0.f;
      };
      float dot = 0.f;
#pragma unroll 4
      for (int o = 0; o < ODW; ++o) {
        float tj = rjb[o];
MPNN_UNROLL
        for (int k = 0; k < FP; ++k) {
          tj = fmaf(h[k], rjw[k * ODW + o], tj);
          tj = fmaf(h0n[k], rjw[(FP + k) * ODW + o], tj);
        }
        const float smx = rp[o] / den;
        const float dsm = dout_of(o) * tj;
        rp[o] = smx;                                   // the softmax
        rj[o] = dsm;
        dot = fmaf(dsm, smx, dot);
      }
#pragma unroll 4
      for (int o = 0; o < ODW; ++o) {
        const float smx = rp[o];
        rp[o] = smx * (rj[o] - dot);                   // dpi
        rj[o] = dout_of(o) * smx;                      // djv
      }
      float gh[FP], dh[FP];
MPNN_UNROLL
      for (int k = 0; k < FP; ++k) {
        float t1 = 0.f, t2 = 0.f;
#pragma unroll 4
        for (int o = 0; o < ODW; ++o) {
          const float dpi = row[2 * FP + o], djv = row[2 * FP + ODW + o];
          t1 = fmaf(riw[k * ODW + o], dpi, t1);
          t1 = fmaf(rjw[k * ODW + o], djv, t1);
          t2 = fmaf(riw[(FP + k) * ODW + o], dpi, t2);
          t2 = fmaf(rjw[(FP + k) * ODW + o], djv, t2);
        }
        gh[k] = t1;
        dh[k] = t2 * m;
        row[k] = h[k];
        row[FP + k] = h0n[k];
      }
      store_row(a.gh, n, f, gh);
      store_row(a.dh0, n, f, dh);
    } else {
      if (n < N) {
        float z[FP];
MPNN_UNROLL
        for (int k = 0; k < FP; ++k) z[k] = 0.f;
        store_row(a.gh, n, f, z);
        store_row(a.dh0, n, f, z);
      }
      for (int i = 0; i < kRoStage; ++i) row[i] = 0.f;
    }
    __syncthreads();
    // this chunk's terms of the weight gradients, per owned element
    for (int e = first_owned(0); e < L.total; e += kThreads) {
      int col_x = -1, col_d;
      if (e < L.ib) {
        const int k = e / od;
        col_x = k < f ? k : FP + k - f;
        col_d = 2 * FP + e % od;
      } else if (e < L.jw) {
        col_d = 2 * FP + (e - L.ib);
      } else if (e < L.jb) {
        const int i = e - L.jw, k = i / od;
        col_x = k < f ? k : FP + k - f;
        col_d = 2 * FP + ODW + i % od;
      } else {
        col_d = 2 * FP + ODW + (e - L.jb);
      }
      float s = 0.f;
      if (col_x >= 0) {
        for (int i = 0; i < kChunk; ++i)
          s = fmaf(xs[i * kRoStage + col_x], xs[i * kRoStage + col_d], s);
      } else {
        for (int i = 0; i < kChunk; ++i) s += xs[i * kRoStage + col_d];
      }
      wrow[e] += s;
    }
    __syncthreads();
  }
}

// dw[e] = Σ_b part[b][e], the rows in block order.
__global__ void __launch_bounds__(kThreads) ro_combine_kernel(CombineArgs a) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= a.width) return;
  float s = 0.f;
  for (int b = 0; b < a.rows; ++b) s += a.part[size_t(b) * a.width + e];
  a.dw[e] = s;
}

}  // namespace

extern "C" {

int mpnn_ro_bwd_smem_bytes() { return int(sizeof(float) * ro_smem_floats()); }

long long mpnn_ro_bwd_scratch_floats(int f, int od, int grid) {
  return (long long)grid * RoLayout(f, od).total;
}

// Blocks of the node launch: the co-resident blocks, capped at the node
// chunks. 0 on error.
int mpnn_ro_bwd_grid(int n_nodes) {
  return coop_grid(ro_bwd_kernel, sizeof(float) * ro_smem_floats(),
                   (n_nodes + kChunk - 1) / kChunk);
}

// Launches both kernels on `stream`; returns the first error code (0 =
// success). Does not synchronize and allocates nothing.
int mpnn_ro_bwd(const float* x, const float* stats, const float* norm_w,
                const float* norm_b, const float* h0, const float* mask,
                const int* node_graph, const float* iw, const float* ib,
                const float* jw, const float* jb, const float* labels,
                const float* gmask, const float* out, const float* gout,
                const float* gl, float* gh, float* dh0, float* dw,
                float* part, int n_nodes, int n_graphs, int f, int od,
                int state_mode, int grid, void* stream) {
  if (f < 1 || f > FP || od < 1 || od > ODW || n_nodes < 1 ||
      n_graphs < 1 || grid < 1 ||
      (state_mode != kNone && state_mode != kBatchBn &&
       state_mode != kStateless))
    return int(cudaErrorInvalidValue);
  const size_t bytes = sizeof(float) * ro_smem_floats();
  cudaError_t err = cudaFuncSetAttribute(
      ro_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (err != cudaSuccess) return int(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  RoArgs a{x, stats, norm_w, norm_b, h0, mask, node_graph, iw, ib, jw, jb,
           labels, gmask, out, gout, gl, gh, dh0, dw, part, n_nodes,
           n_graphs, f, od, state_mode};
  ro_bwd_kernel<<<grid, kThreads, bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int width = RoLayout(f, od).total;
  CombineArgs c{part, dw, grid, width};
  ro_combine_kernel<<<(width + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      c);
  return int(cudaGetLastError());
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
