// Set2vec readout forward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mpnn_tpu/kernels/set2vec.py::_s2v_fwd_kernel (the
// forward of make_set2vec_op). T steps (the reference's 100) of
//
//   h, c   = LSTMhidden([mh ‖ mr], c)     per graph, no input, 2w → w
//   q      = h·Wq
//   e_v    = we·tanh(q_{g(v)} + x_v)       per real node
//   att    = softmax over ALL real nodes of the batch (batch_softmax, the
//            reference's quirk) or over each graph's nodes
//   mr     = Σ_{v∈g} att_v·x_v,  mh = h    → the output m = [mh ‖ mr]
//
// Padded nodes carry −1e8 in the reference, whose exp is exactly 0: they
// are skipped. For training the launch also writes the stash the backward
// walks: a row per (step, graph) — the input carry, the gates and the
// query (set2vec_common.cuh::stash_width) — and each step's attention row.
//
// Bound on an H100: a few MFLOP and a few MB at batch 1,024, microseconds;
// what it costs is the chain of T steps in series. So every step keeps its
// chain on chip (set2vec_common.cuh): the graph's carry and statistics in
// its shared-memory slot, x rows staged once, energies in shared memory.
// Each graph keeps its own softmax statistics — max m_g, Σ exp(e − m_g),
// the unnormalised read Σ exp(e − m_g)·x, updated online over the chunks
// of the chunked route — so a per-graph softmax needs no barrier at all
// and the batch-global one combines per-graph, per-block and per-grid
// partials: one block (G <= 32) after one __syncthreads a step, more
// blocks through their published words (the only wait that crosses
// blocks).
// set2vec_floor_kernel, below, runs the same grid and combine with empty
// steps: the floor the combine alone sets.

#include "set2vec_common.cuh"

namespace {

using namespace mpnn_s2v;

// Shared memory (floats): the weights (WL<WB>), a slot per graph of the
// block — [mh | mr | c | q] (WB each, zero past w), then m_g, s_g of even
// and of odd steps; in global scratch on the spilled route — the
// combine's totals, the graphs' node pointers, the staged x rows (XS
// apart, zero past w to W8) and the energies.
struct FwdSmem {
  int W8, XS, SS, slots, red, gp, xs, eb, total;
  __host__ __device__ FwdSmem(int W, int WB, int gpb, int cap,
                              bool slots_smem) {
    W8 = pad8(W);
    XS = W8 + 1;
    SS = 4 * WB + 4;
    slots = weights_floats(WB);
    red = slots + (slots_smem ? gpb * SS : 0);
    gp = red + 4;
    xs = gp + al4(gpb + 1);
    eb = xs + al4(cap * XS);
    total = eb + al4(cap);
  }
};

constexpr int kFwdPhases = 5;   // clock64 stamps a step (block 0)

struct FwdArgs {
  S2vWeights w;
  const float* x;               // (N, w)
  const int* graph_node_ptr;    // (G + 1)
  float* m;                     // (G, 2w)
  float* carry_stash;           // (T, G, stash_width(w)) or null
  float* att_stash;             // (T, al4(N)) or null
  unsigned long long* part;     // global scratch: the published words,
                                // then (spilled) the slots
  long long* stamps;            // (T, kFwdPhases) or null
  int n_nodes, n_graphs, width, steps, batch_softmax, gpb, cap;
};

// Global scratch: the published words (T, grid, kWordStride), then on the
// spilled route each block's graph slots (grid, gpb, SS).
__host__ __device__ inline size_t fwd_words_floats(int T, int grid) {
  return 2 * word_at(T, grid, 0);
}

// kSlotsSmem: the graphs' slots in shared memory, else in the block's
// region of global scratch (the spilled route); a compile-time choice, so
// that the shared-memory route's accesses stay shared-space ones
template <int WB, bool kSlotsSmem>
__global__ void __launch_bounds__(kMaxThreads, 1)
set2vec_fwd_kernel(FwdArgs a) {
  constexpr int KP = kpl(WB);
  // the read: two half-warps over alternate nodes when w <= 16
  constexpr int NS = WB <= 16 ? 2 : 1;
  extern __shared__ __align__(16) float sm[];
  const int W = a.width, G = a.n_graphs, T = a.steps;
  const FwdSmem L(W, WB, a.gpb, a.cap, kSlotsSmem);
  const int W8 = L.W8, N4 = al4(a.n_nodes);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5, grid = gridDim.x;
  const bool global_sm = a.batch_softmax != 0, multi = grid > 1;
  int lo, hi;
  block_graphs(G, lo, hi);
  const int nb = hi - lo;
  int* gp = reinterpret_cast<int*>(sm + L.gp);
  for (int i = tid; i <= nb; i += blockDim.x)
    gp[i] = a.graph_node_ptr[lo + i];
  stage_weights<WB>(sm, a.w, W);
  float* slots =
      kSlotsSmem
          ? sm + L.slots
          : reinterpret_cast<float*>(a.part) + fwd_words_floats(T, grid) +
                size_t(blockIdx.x) * a.gpb * L.SS;
  for (int i = tid; i < nb * L.SS; i += blockDim.x) slots[i] = 0.f;
  if (multi && global_sm)
    for (int t = tid; t < T; t += blockDim.x)
      a.part[word_at(t, grid, blockIdx.x)] = kEmpty;
  __syncthreads();
  const int bn0 = gp[0], bn1 = gp[nb];
  const bool resident = bn1 - bn0 <= a.cap;
  const int nchunks = resident ? 1 : (bn1 - bn0 + a.cap - 1) / a.cap;
  if (resident) stage_rows(sm + L.xs, a.x, bn0, bn1, W, W8, L.XS);
  cp_async_wait_all();
  if (multi && global_sm)
    cg::this_grid().sync();      // every block's words reset
  else
    __syncthreads();

  const float* we = sm + WL<WB>::we;
  const float* xs = sm + L.xs;
  float* eb = sm + L.eb;
  float* red = sm + L.red;
  bool own[KP];
#pragma unroll
  for (int r = 0; r < KP; ++r) own[r] = lane + 32 * r < W;
  const int sub = NS == 2 ? lane >> 4 : 0;
  const int jl = NS == 2 ? lane & 15 : lane;
  const Lanes<WB> ln(lane);
  const bool stamp = a.stamps && blockIdx.x == 0 && tid == 0;
  auto slot = [&](int i) { return slots + i * L.SS; };

  for (int t = 0; t < T; ++t) {
    const int st2 = 4 * WB + 2 * (t & 1);   // this step's m_g, s_g
    if (stamp) a.stamps[t * kFwdPhases] = clock64();
    // ---- each graph's LSTM step and query --------------------------------
    for (int i = warp; i < nb; i += nw) {
      float* s = slot(i);
      float mh[KP], mr[KP], c[KP], act[KP][4], q[KP];
      Pre<WB> pre;
      lstm_pre<WB>(sm, s, W, lane, pre);
      lstm_post<WB>(sm, s, W, lane, pre, mh, mr, c, act, q);
      float* st = a.carry_stash
                      ? a.carry_stash +
                            (size_t(t) * G + lo + i) * stash_width(W)
                      : nullptr;
#pragma unroll
      for (int r = 0; r < KP; ++r) {
        const int j = ln.j0 + 32 * r;
        if (ln.gh || j >= W) continue;
        if (st) {
          st[j] = mh[r];
          st[W + j] = mr[r];
          st[2 * W + j] = c[r];
#pragma unroll
          for (int g = 0; g < 4; ++g) st[(3 + g) * W + j] = act[r][g];
          st[7 * W + j] = q[r];
        }
        s[WB + j] = 0.f;                   // the read, accumulated below
        s[3 * WB + j] = q[r];
      }
      if (lane == 0) {
        s[st2] = -INFINITY;
        s[st2 + 1] = 0.f;
      }
    }
    __syncwarp();
    if (stamp) a.stamps[t * kFwdPhases + 1] = clock64();

    // ---- energies, the graphs' softmax statistics and reads --------------
    for (int ch = 0; ch < nchunks; ++ch) {
      const int c0 = bn0 + ch * a.cap, c1 = min(bn1, c0 + a.cap);
      if (!resident) {
        __syncthreads();                   // the last chunk is consumed
        stage_rows(sm + L.xs, a.x, c0, c1, W, W8, L.XS);
        cp_async_wait_all();
        __syncthreads();
      }
      for (int i = warp; i < nb; i += nw) {
        const int n0 = max(gp[i], c0), n1 = min(gp[i + 1], c1);
        if (n0 >= n1) continue;
        float* s = slot(i);
        const float* q = s + 3 * WB;
        float cm = -INFINITY;
        for (int v = n0 + lane; v < n1; v += 32) {
          const float e = energy(we, q, xs + (v - c0) * L.XS, W8);
          eb[v - c0] = e;
          if (!resident && a.att_stash)
            a.att_stash[size_t(t) * N4 + v] = e;   // raw, finished below
          cm = fmaxf(cm, e);
        }
        cm = warp_max_(cm);
        const float mo = s[st2], mn = fmaxf(mo, cm);
        const float f = mo == -INFINITY ? 0.f : expf(mo - mn);
        float ps = 0.f;
        for (int v = n0 + lane; v < n1; v += 32) {
          const float p = expf(eb[v - c0] - mn);
          eb[v - c0] = p;
          ps += p;
        }
        ps = warp_sum_(ps);
        __syncwarp();                      // eb of every lane; mo read
        float acc[KP];
#pragma unroll
        for (int r = 0; r < KP; ++r) acc[r] = 0.f;
        for (int v = n0 + sub; v < n1; v += NS) {
          const float p = eb[v - c0];
          const float* xr = xs + (v - c0) * L.XS;
#pragma unroll
          for (int r = 0; r < KP; ++r)
            acc[r] = fmaf(p, xr[min(jl + 32 * r, W8 - 1)], acc[r]);
        }
        if (NS == 2) acc[0] += __shfl_xor_sync(kFull, acc[0], 16);
#pragma unroll
        for (int r = 0; r < KP; ++r) {
          const int j = jl + 32 * r;
          if (sub == 0 && j < W) s[WB + j] = s[WB + j] * f + acc[r];
        }
        if (lane == 0) {
          s[st2] = mn;
          s[st2 + 1] = s[st2 + 1] * f + ps;
        }
        __syncwarp();
      }
    }
    if (stamp) a.stamps[t * kFwdPhases + 2] = clock64();

    // ---- the batch-global softmax's totals: one block's every warp sums
    // the graphs' statistics itself (they alternate by step parity, so one
    // barrier a step); more blocks' warp 0 publishes the block's and
    // gathers every block's
    float M = 0.f, Z = 0.f;
    if (global_sm) {
      __syncthreads();                     // every graph's statistics
      unsigned long long* row = a.part + word_at(t, grid, 0);
      if (!multi || warp == 0) {
        float mb = -INFINITY;
        for (int i = lane; i < nb; i += 32) mb = fmaxf(mb, slot(i)[st2]);
        mb = warp_max_(mb);
        float sb = 0.f;
        for (int i = lane; i < nb; i += 32) {
          const float si = slot(i)[st2 + 1];
          if (si > 0.f) sb += si * expf(slot(i)[st2] - mb);
        }
        M = mb;
        Z = warp_sum_(sb);
        if (multi) publish(row, lane, M, Z);
      }
      if (multi) {
        if (warp == 0) {
          gather_softmax(row, grid, lane, M, Z);
          if (lane == 0) {
            red[0] = M;
            red[1] = Z;
          }
        }
        __syncthreads();
        M = red[0];
        Z = red[1];
      }
    }
    if (stamp) a.stamps[t * kFwdPhases + 3] = clock64();

    // ---- normalise each graph's read; the attention row -------------------
    for (int i = warp; i < nb; i += nw) {
      float* s = slot(i);
      const float mg = s[st2], sg = s[st2 + 1];
      float scale = 0.f;
      if (global_sm) {
        if (sg > 0.f && Z > 0.f) scale = expf(mg - M) / Z;
      } else if (sg > 0.f) {
        scale = 1.0f / sg;
      }
#pragma unroll
      for (int r = 0; r < KP; ++r)
        if (own[r]) s[WB + lane + 32 * r] *= scale;
      if (a.att_stash) {
        float* ar = a.att_stash + size_t(t) * N4;
        for (int v = gp[i] + lane; v < gp[i + 1]; v += 32)
          ar[v] = resident ? eb[v - bn0] * scale
                           : expf(ar[v] - mg) * scale;
      }
    }
    __syncwarp();
    if (stamp) a.stamps[t * kFwdPhases + 4] = clock64();
  }

  for (int i = warp; i < nb; i += nw) {
    const float* s = slot(i);
    float* mo = a.m + size_t(lo + i) * 2 * W;
#pragma unroll
    for (int r = 0; r < KP; ++r)
      if (own[r]) {
        const int j = lane + 32 * r;
        mo[j] = s[j];
        mo[W + j] = s[WB + j];
      }
  }
}

// T empty steps with the forward's grid and batch-global combine: the
// floor the combine's waits alone set (chip_smoke.py's att-times phase).
struct FloorArgs {
  unsigned long long* part;     // (T, grid, kWordStride)
  float* out;                   // (1): keeps the totals live
  int steps;
};

__global__ void __launch_bounds__(kMaxThreads, 1)
set2vec_floor_kernel(FloorArgs a) {
  extern __shared__ __align__(16) float red[];
  const int tid = threadIdx.x, lane = tid & 31, grid = gridDim.x;
  if (grid > 1) {
    for (int t = tid; t < a.steps; t += blockDim.x)
      a.part[word_at(t, grid, blockIdx.x)] = kEmpty;
    cg::this_grid().sync();
  }
  float acc = 0.f;
  for (int t = 0; t < a.steps; ++t) {
    __syncthreads();
    if (tid < 32) {
      float m = 0.f, s = 1.f;
      if (grid > 1) {
        unsigned long long* row = a.part + word_at(t, grid, 0);
        publish(row, lane, m, s);
        gather_softmax(row, grid, lane, m, s);
      }
      if (lane == 0) red[0] = s;
    }
    __syncthreads();
    acc += red[0];
  }
  if (tid == 0 && blockIdx.x == 0) *a.out = acc;
}

const void* kernel_for(int width, bool slots_smem) {
  return slots_smem ? kernel_for_width(width, set2vec_fwd_kernel<16, true>,
                                       set2vec_fwd_kernel<WP, true>)
                    : kernel_for_width(width, set2vec_fwd_kernel<16, false>,
                                       set2vec_fwd_kernel<WP, false>);
}

}  // namespace

extern "C" {

int mpnn_set2vec_fwd_smem_bytes(int width, int gpb, int cap,
                                int slots_smem) {
  return int(sizeof(float) *
             FwdSmem(width, wb_of(width), gpb, cap, slots_smem != 0).total);
}

int mpnn_set2vec_stash_width(int width) { return stash_width(width); }

// floats of the forward's (and the floor's) global scratch
long long mpnn_set2vec_fwd_scratch_floats(int width, int steps, int grid,
                                          int gpb, int slots_smem) {
  const long long slots =
      slots_smem ? 0
                 : (long long)grid * gpb *
                       FwdSmem(width, wb_of(width), gpb, 1, false).SS;
  return (long long)fwd_words_floats(steps, grid) + slots;
}

int mpnn_set2vec_fwd(
    const float* w_hi, const float* w_hf, const float* w_hg,
    const float* w_ho, const float* b_hi, const float* b_hf,
    const float* b_hg, const float* b_ho, const float* wq, const float* we,
    const float* x, const int* graph_node_ptr, float* m, float* carry_stash,
    float* att_stash, unsigned long long* part, long long* stamps,
    int n_nodes, int n_graphs, int width, int steps, int batch_softmax,
    int grid, int warps, int gpb, int cap, int slots_smem, void* stream) {
  if (width < 1 || width > WP || steps < 1 || n_graphs < 1 || grid < 1 ||
      grid > n_graphs || grid > kMaxGrid || warps < 1 || warps > kMaxWarps ||
      cap < 1 || (long long)gpb * grid < n_graphs ||
      (carry_stash == nullptr) != (att_stash == nullptr))
    return int(cudaErrorInvalidValue);
  FwdArgs a{{{w_hi, w_hf, w_hg, w_ho}, {b_hi, b_hf, b_hg, b_ho}, wq, we},
            x, graph_node_ptr, m, carry_stash, att_stash, part, stamps,
            n_nodes, n_graphs, width, steps, batch_softmax, gpb, cap};
  void* args[] = {&a};
  return int(launch_coop(kernel_for(width, slots_smem != 0), grid, warps,
                         sizeof(float) * FwdSmem(width, wb_of(width), gpb,
                                                 cap, slots_smem != 0)
                                             .total,
                         args, stream));
}

int mpnn_set2vec_floor(int grid, int warps, int steps,
                       unsigned long long* part, float* out, void* stream) {
  if (grid < 1 || grid > kMaxGrid || warps < 1 || warps > kMaxWarps ||
      steps < 1)
    return int(cudaErrorInvalidValue);
  FloorArgs a{part, out, steps};
  void* args[] = {&a};
  return int(launch_coop((const void*)set2vec_floor_kernel, grid, warps,
                         4 * sizeof(float), args, stream));
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
