// Fused BN→GRU→BN recurrence backward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels of mpnn_tpu/kernels/recurrence.py that compute
// the chain's VJP: _bwd_kernel (make_recurrence_op), _blocked_bwd_kernel,
// _merged_bwd_kernel and _vmem_bwd_kernel (the VMEM-resident reverse walk
// of make_recurrence_op_merged). Given the cotangent g of h_T and the
// forward's residuals (the pre-norm states h̃_t and the statistics), it
// walks the chain in reverse:
//
//   for t = T..1: masked-BN VJP of step t with the batch sums
//                 S1 = Σ dx̂, S2 = Σ dx̂·x̂ (closed form,
//                 dh̃ = (dx̂ − m·S1/c)/d − m·x̂·S2/(c·s), the S2 term only
//                 where var > 1e-12), then the GRU VJP per node from the
//                 replayed gates → ∂h_{t−1}, ∂W_hh, ∂b_hh, and Σ_t ∂gi
//   ∂mb = W_ih·Σ_t ∂gi; ∂W_ih, ∂b_ih; the message-BN VJP → ∂msgs
//   ∂h0 = m·∂h_0
//
// and returns ∂msgs, ∂h0 and the eight leaves (W_ih, W_hh, b_ih, b_hh and
// both norms' weight and bias). The statistics take no cotangent: they
// feed the running EMAs only, as in the JAX op.
//
// Design: ONE cooperative launch on the node chunks of the forward. The
// sums S1, S2 of each slot are per-chunk partials combined in chunk order
// after a grid barrier (T + 1 barriers in all), alternating between two
// buffers by slot parity. Every weight gradient goes to a block-private
// row of partials, each element owned by one thread of the block: the
// per-node terms are staged in shared memory per chunk and the owners sum
// them in node order. At the end the rows are summed in block order. No
// float atomics; results are deterministic for a given grid size.
//
// Bound on an H100 SXM: per node and step the replayed hidden gates, the
// transposed product for ∂h and the outer products of ∂W_hh (~18f² flop)
// over the bytes of the stash, the residual inputs and the outputs: at
// lipo's b1024 (16,512 slots, f 10, T 6) ~2 us by bytes, ~0.5 us of f32
// arithmetic. The T + 1 grid barriers and the per-chunk owner sums set
// the time.

#include "recurrence_common.cuh"

namespace {

using namespace mpnn_rec;

// Flat layout of the gradient output (and of each block's partial row):
// real (unpadded) shapes, in this order. kernels/recurrence.py::
// grad_layout mirrors it and checks it against
// mpnn_recurrence_bwd_layout.
struct GradLayout {
  int wih, whh, bih, bhh, maw, mab, bnw, bnb, total;
  __host__ __device__ explicit GradLayout(int f) {
    wih = 0;
    whh = wih + 3 * f * f;
    bih = whh + 3 * f * f;
    bhh = bih + 3 * f;
    maw = bhh + 3 * f;
    mab = maw + f;
    bnw = mab + f;
    bnb = bnw + f;
    total = bnb + f;
  }
};

struct BwdArgs {
  RecWeights w;
  const float* msgs;    // (N, f)
  const float* h0;      // (N, f)
  const float* mask;    // (N, 1), 0/1
  const float* stats;   // (T + 1, 2, f) forward batch statistics
  const float* htil;    // (T, N, f) forward pre-norm states
  const float* ght;     // (N, f) cotangent of h_T
  float* dmsgs;         // (N, f)
  float* dh0;           // (N, f)
  float* dw;            // GradLayout(f).total
  float* scratch;
  int n_nodes, f, steps;
};

// per node, staged: [x | d_r | d_z | d_n | da_n] (FP each), odd stride
constexpr int kStage = 5 * FP + 1;
constexpr int kPart = 3 * FP;          // per chunk: S1, S2, the mask count

// First element index >= off owned by this thread (e ≡ tid mod kThreads).
__device__ __forceinline__ int first_owned(int off) {
  return off + ((int(threadIdx.x) - off) % kThreads + kThreads) % kThreads;
}

// wrow[off + i] += v[i] for the elements this thread owns, i < len.
__device__ __forceinline__ void add_owned(float* wrow, int off, int len,
                                          const float* v) {
  for (int e = first_owned(off); e < off + len; e += kThreads)
    wrow[e] += v[e - off];
}

// One chunk's terms of a GRU weight (f, 3f) and bias (3f) gradient from
// the staged rows: ∂W[k][g·f + j] += Σ_i x_i[k]·d_i[g][j], ∂b[g·f + j] +=
// Σ_i d_i[g][j], for the elements this thread owns, summed in node order.
__device__ void gate_grads(float* wrow, int w_off, int b_off,
                           const float* xs, int f) {
  for (int e = first_owned(w_off); e < w_off + 3 * f * f; e += kThreads) {
    const int i = e - w_off, k = i / (3 * f), g = (i % (3 * f)) / f,
              j = i % f;
    const int cd = (1 + g) * FP + j;
    float s = 0.f;
    for (int r = 0; r < kChunk; ++r)
      s = fmaf(xs[r * kStage + k], xs[r * kStage + cd], s);
    wrow[e] += s;
  }
  for (int e = first_owned(b_off); e < b_off + 3 * f; e += kThreads) {
    const int i = e - b_off, cd = (1 + i / f) * FP + i % f;
    float s = 0.f;
    for (int r = 0; r < kChunk; ++r) s += xs[r * kStage + cd];
    wrow[e] += s;
  }
}

// dx of a masked bn1d from dx̂ (real node) under slot `st` with the batch
// sums S1 = cs[j], S2 = cs[FP + j] over c real nodes.
__device__ __forceinline__ float bn_vjp(const float* st, const float* cs,
                                        float c, int j, float dxh,
                                        float xh) {
  return (dxh - cs[j] / c) / st[2 * FP + j] -
         st[3 * FP + j] * xh * cs[FP + j] / (c * st[FP + j]);
}

__global__ void __launch_bounds__(kThreads)
recurrence_bwd_kernel(BwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float sm[];
  const int f = a.f, T = a.steps, N = a.n_nodes;
  stage_rec_weights(sm, a.w, f);
  float* st = sm + RL::kStats;                        // (T+1)·kSlot
  float* red = sm + RL::after_stats(T);               // kWarps·4·FP
  float* sums = red + kWarps * 4 * FP;                // 5·FP
  float* cs = sums + 5 * FP;                          // 3·FP
  float* xs = cs + 3 * FP;                            // kChunk·kStage

  const int tid = threadIdx.x;
  const GradLayout gl(f);
  const int NW = gl.total;
  const int nchunks = (N + kChunk - 1) / kChunk;
  const size_t slot_sz = size_t(N) * f;
  float* gib = a.scratch;                             // (N, 3f) gates
  float* dgib = gib + slot_sz * 3;                    // (N, 3f) Σ_t ∂gi
  float* dhb = dgib + slot_sz * 3;                    // (N, f) ∂h_t
  float* cpart = dhb + slot_sz;                       // 2·nchunks·kPart
  float* wpart = cpart + 2 * size_t(nchunks) * kPart;  // grid·NW
  float* wrow = wpart + size_t(blockIdx.x) * NW;

  // ---- set-up: every slot's norm constants, zeroed partial row -----------
  for (int i = tid; i < (T + 1) * FP; i += kThreads) {
    const int s = i / FP, j = i % FP;
    const float mean = j < f ? a.stats[(size_t(s) * 2) * f + j] : 0.f;
    const float var = j < f ? a.stats[(size_t(s) * 2 + 1) * f + j] : 0.f;
    set_rec_slot(st + s * RL::kSlot, j, mean, var);
  }
  for (int e = tid; e < NW; e += kThreads) wrow[e] = 0.f;
  __syncthreads();
  const float* w = sm + opaque_zero();
  const float* st0 = st;

  // ---- phase 0: the input gates, zeroed Σ ∂gi, slot T's sums -------------
  {
    const float* stT = st + T * RL::kSlot;
    const float* htil_T = a.htil + size_t(T - 1) * slot_sz;
    float* cpart_t = cpart + size_t(T & 1) * nchunks * kPart;
    for (int ch = blockIdx.x; ch < nchunks; ch += gridDim.x) {
      const int n = ch * kChunk + tid;
      float v[4][FP], cnt[1][FP];
MPNN_UNROLL
      for (int j = 0; j < FP; ++j)
        v[0][j] = v[1][j] = v[2][j] = v[3][j] = cnt[0][j] = 0.f;
      if (n < N && a.mask[n] != 0.f) {
        {
          float x[FP], xh[FP], mb[FP];
          load_row(a.msgs, n, f, x);
          bn_row(w, RL::kMaW, RL::kMaB, st0, x, xh, mb);
          input_gates(w, mb, f, gib + size_t(n) * 3 * f);
        }
        for (int c = 0; c < 3 * f; ++c) dgib[size_t(n) * 3 * f + c] = 0.f;
        float g[FP], x[FP], xh[FP];
        load_row(a.ght, n, f, g);
        store_row(dhb, n, f, g);
        load_row(htil_T, n, f, x);
        xhat_of(stT, x, xh);
MPNN_UNROLL
        for (int j = 0; j < FP; ++j) {
          v[0][j] = g[j] * w[RL::kBnW + j];          // dx̂
          v[1][j] = v[0][j] * xh[j];
          v[2][j] = g[j] * xh[j];                     // ∂bn.weight
          v[3][j] = g[j];                             // ∂bn.bias
          cnt[0][j] = 1.f;
        }
      }
      block_feature_sums<4>(v, red, sums);
      block_feature_sums<1>(cnt, red, sums + 4 * FP);
      if (tid < 2 * FP) cpart_t[size_t(ch) * kPart + tid] = sums[tid];
      if (tid < FP) cpart_t[size_t(ch) * kPart + 2 * FP + tid] =
          sums[4 * FP + tid];
      add_owned(wrow, gl.bnw, f, sums + 2 * FP);
      add_owned(wrow, gl.bnb, f, sums + 3 * FP);
    }
    grid.sync();
    chunk_totals<3>(cpart_t, kPart, nchunks, red, cs);
  }
  const float c = cs[2 * FP];

  // ---- the reverse walk, t = T..1 ----------------------------------------
  for (int t = T; t >= 1; --t) {
    const float* stt = st + t * RL::kSlot;
    const float* stp = st + (t - 1) * RL::kSlot;
    const float* htil_t = a.htil + size_t(t - 1) * slot_sz;
    float* cpart_t = cpart + size_t((t - 1) & 1) * nchunks * kPart;
    for (int ch = blockIdx.x; ch < nchunks; ch += gridDim.x) {
      const int n = ch * kChunk + tid;
      float v[4][FP];
MPNN_UNROLL
      for (int j = 0; j < FP; ++j)
        v[0][j] = v[1][j] = v[2][j] = v[3][j] = 0.f;
      float* row = xs + tid * kStage;
      if (n < N && a.mask[n] != 0.f) {
        float dhn[FP], hprev[FP], xhp[FP];
        {
          float dh[FP], x[FP], xh[FP];
          load_row(dhb, n, f, dh);
          load_row(htil_t, n, f, x);
          xhat_of(stt, x, xh);
MPNN_UNROLL
          for (int j = 0; j < FP; ++j)
            dhn[j] = bn_vjp(stt, cs, c, j, dh[j] * w[RL::kBnW + j], xh[j]);
        }
        if (t > 1) {
          float x[FP];
          load_row(a.htil + size_t(t - 2) * slot_sz, n, f, x);
          bn_row(w, RL::kBnW, RL::kBnB, stp, x, xhp, hprev);
        } else {
          load_row(a.h0, n, f, hprev);
        }
        const float* gi = gib + size_t(n) * 3 * f;
        float ghn[FP];
MPNN_UNROLL
        for (int j = 0; j < FP; ++j) {
          float rh, zh, nh;
          hidden_gates(w, hprev, j, rh, zh, nh);
          const bool in = j < f;
          const float sr = sigmoidf_((in ? gi[j] : 0.f) + rh);
          const float sz = sigmoidf_((in ? gi[f + j] : 0.f) + zh);
          const float tn = tanhf((in ? gi[2 * f + j] : 0.f) + sr * nh);
          const float dz = dhn[j] * (hprev[j] - tn);
          const float da_n = dhn[j] * (1.0f - sz) * (1.0f - tn * tn);
          row[j] = hprev[j];
          row[FP + j] = da_n * nh * sr * (1.0f - sr);       // ∂a_r
          row[2 * FP + j] = dz * sz * (1.0f - sz);          // ∂a_z
          row[3 * FP + j] = da_n * sr;                      // ∂(W_hhᵀh)_n
          row[4 * FP + j] = da_n;                           // ∂a_n
          ghn[j] = dhn[j] * sz;
        }
        float dhp[FP];
MPNN_UNROLL
        for (int k = 0; k < FP; ++k) {
          const float* wh = w + RL::kWhh + k * 3 * FP;
          float s = ghn[k];
MPNN_UNROLL
          for (int j = 0; j < FP; ++j) {
            s = fmaf(wh[j], row[FP + j], s);
            s = fmaf(wh[FP + j], row[2 * FP + j], s);
            s = fmaf(wh[2 * FP + j], row[3 * FP + j], s);
          }
          dhp[k] = s;
        }
        float* dg = dgib + size_t(n) * 3 * f;
        for (int j = 0; j < f; ++j) {
          dg[j] += row[FP + j];
          dg[f + j] += row[2 * FP + j];
          dg[2 * f + j] += row[4 * FP + j];
        }
        if (t > 1) {
          store_row(dhb, n, f, dhp);
MPNN_UNROLL
          for (int j = 0; j < FP; ++j) {
            v[0][j] = dhp[j] * w[RL::kBnW + j];
            v[1][j] = v[0][j] * xhp[j];
            v[2][j] = dhp[j] * xhp[j];
            v[3][j] = dhp[j];
          }
        } else {
          store_row(a.dh0, n, f, dhp);
        }
      } else {
        for (int i = 0; i < kStage; ++i) row[i] = 0.f;
        if (t == 1 && n < N) {
          float z[FP];
MPNN_UNROLL
          for (int j = 0; j < FP; ++j) z[j] = 0.f;
          store_row(a.dh0, n, f, z);
        }
      }
      __syncthreads();
      gate_grads(wrow, gl.whh, gl.bhh, xs, f);
      if (t > 1) {
        block_feature_sums<4>(v, red, sums);
        if (tid < 2 * FP) cpart_t[size_t(ch) * kPart + tid] = sums[tid];
        add_owned(wrow, gl.bnw, f, sums + 2 * FP);
        add_owned(wrow, gl.bnb, f, sums + 3 * FP);
      }
      __syncthreads();
    }
    if (t > 1) {
      grid.sync();
      chunk_totals<2>(cpart_t, kPart, nchunks, red, cs);
    }
  }

  // ---- phase M: ∂mb = W_ih·Σ∂gi, ∂W_ih, ∂b_ih, the message norm's sums ---
  {
    float* cpart_0 = cpart;
    for (int ch = blockIdx.x; ch < nchunks; ch += gridDim.x) {
      const int n = ch * kChunk + tid;
      float v[4][FP];
MPNN_UNROLL
      for (int j = 0; j < FP; ++j)
        v[0][j] = v[1][j] = v[2][j] = v[3][j] = 0.f;
      float* row = xs + tid * kStage;
      for (int i = 0; i < kStage; ++i) row[i] = 0.f;
      if (n < N && a.mask[n] != 0.f) {
        float x[FP], xh0[FP], mb[FP];
        load_row(a.msgs, n, f, x);
        bn_row(w, RL::kMaW, RL::kMaB, st0, x, xh0, mb);
        const float* dg = dgib + size_t(n) * 3 * f;
        for (int j = 0; j < f; ++j) {
          row[FP + j] = dg[j];
          row[2 * FP + j] = dg[f + j];
          row[3 * FP + j] = dg[2 * f + j];
        }
        float dmb[FP];
MPNN_UNROLL
        for (int k = 0; k < FP; ++k) {
          const float* wi = w + RL::kWih + k * 3 * FP;
          float s = 0.f;
MPNN_UNROLL
          for (int j = 0; j < FP; ++j) {
            s = fmaf(wi[j], row[FP + j], s);
            s = fmaf(wi[FP + j], row[2 * FP + j], s);
            s = fmaf(wi[2 * FP + j], row[3 * FP + j], s);
          }
          dmb[k] = s;
          row[k] = mb[k];
        }
        store_row(a.dmsgs, n, f, dmb);            // ∂mb, until phase D
MPNN_UNROLL
        for (int j = 0; j < FP; ++j) {
          v[0][j] = dmb[j] * w[RL::kMaW + j];
          v[1][j] = v[0][j] * xh0[j];
          v[2][j] = dmb[j] * xh0[j];                // ∂ma_bn.weight
          v[3][j] = dmb[j];                         // ∂ma_bn.bias
        }
      }
      __syncthreads();
      gate_grads(wrow, gl.wih, gl.bih, xs, f);
      block_feature_sums<4>(v, red, sums);
      if (tid < 2 * FP) cpart_0[size_t(ch) * kPart + tid] = sums[tid];
      add_owned(wrow, gl.maw, f, sums + 2 * FP);
      add_owned(wrow, gl.mab, f, sums + 3 * FP);
      __syncthreads();
    }
    grid.sync();
    chunk_totals<2>(cpart_0, kPart, nchunks, red, cs);
  }

  // ---- phase D: ∂msgs through the message norm ----------------------------
  for (int ch = blockIdx.x; ch < nchunks; ch += gridDim.x) {
    const int n = ch * kChunk + tid;
    if (n >= N) continue;
    float dm[FP];
MPNN_UNROLL
    for (int j = 0; j < FP; ++j) dm[j] = 0.f;
    if (a.mask[n] != 0.f) {
      float dmb[FP], x[FP], xh0[FP];
      load_row(a.dmsgs, n, f, dmb);
      load_row(a.msgs, n, f, x);
      xhat_of(st0, x, xh0);
MPNN_UNROLL
      for (int j = 0; j < FP; ++j)
        dm[j] = bn_vjp(st0, cs, c, j, dmb[j] * w[RL::kMaW + j], xh0[j]);
    }
    store_row(a.dmsgs, n, f, dm);
  }

  // ---- the weight gradients: block rows summed in block order ------------
  for (int e = blockIdx.x * kThreads + tid; e < NW;
       e += gridDim.x * kThreads) {
    float s = 0.f;
    for (int b = 0; b < int(gridDim.x); ++b)
      s += __ldcg(wpart + size_t(b) * NW + e);
    a.dw[e] = s;
  }
}

size_t smem_bytes(int steps) {
  return sizeof(float) * (size_t(RL::after_stats(steps)) +
                          kWarps * 4 * FP + 8 * FP +
                          size_t(kChunk) * kStage);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes.
int mpnn_recurrence_bwd_smem_bytes(int steps) {
  return int(smem_bytes(steps));
}

// Offsets of the flat gradient's leaves (8) and its total, for the
// wrapper's check of its own layout.
void mpnn_recurrence_bwd_layout(int f, int* out) {
  const GradLayout gl(f);
  const int v[] = {gl.wih, gl.whh, gl.bih, gl.bhh, gl.maw,
                   gl.mab, gl.bnw, gl.bnb, gl.total};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
}

// Floats of scratch a launch needs: the input gates, Σ ∂gi, ∂h, the chunk
// partials and the blocks' gradient rows.
long long mpnn_recurrence_bwd_scratch_floats(int n_nodes, int f, int grid) {
  const long long nchunks = (n_nodes + kChunk - 1) / kChunk;
  return 7LL * n_nodes * f + 2 * nchunks * kPart +
         (long long)grid * GradLayout(f).total;
}

// Blocks of the cooperative grid: all co-resident blocks, capped at the
// node chunks. 0 on error.
int mpnn_recurrence_bwd_grid(int steps, int n_nodes) {
  const size_t bytes = smem_bytes(steps);
  if (cudaFuncSetAttribute(recurrence_bwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(bytes)) != cudaSuccess)
    return 0;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, recurrence_bwd_kernel, kThreads, bytes) != cudaSuccess)
    return 0;
  return min(per_sm * sms, max((n_nodes + kChunk - 1) / kChunk, 1));
}

// Launches on `stream` and returns the launch's error code (0 = success).
// Does not synchronize and allocates nothing.
int mpnn_recurrence_bwd(const float* msgs, const float* h0,
                        const float* mask, const float* w_ih,
                        const float* w_hh, const float* b_ih,
                        const float* b_hh, const float* ma_w,
                        const float* ma_b, const float* bn_w,
                        const float* bn_b, const float* stats,
                        const float* htil, const float* ght, float* dmsgs,
                        float* dh0, float* dw, float* scratch, int n_nodes,
                        int f, int steps, int grid, void* stream) {
  if (f < 1 || f > FP || steps < 1 || steps > kMaxSteps || n_nodes < 1 ||
      grid < 1)
    return int(cudaErrorInvalidValue);
  BwdArgs a{{w_ih, w_hh, b_ih, b_hh, ma_w, ma_b, bn_w, bn_b},
            msgs, h0, mask, stats, htil, ght, dmsgs, dh0, dw, scratch,
            n_nodes, f, steps};
  const size_t bytes = smem_bytes(steps);
  cudaError_t err = cudaFuncSetAttribute(
      recurrence_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (err != cudaSuccess) return int(err);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((void*)recurrence_bwd_kernel,
                                    dim3(grid), dim3(kThreads), args, bytes,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
