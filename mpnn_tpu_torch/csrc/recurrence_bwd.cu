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
// Design (walk_bwd.cuh). A node is a GROUP of FP lanes, one feature a
// lane; a block of 256 threads owns a contiguous range of node slots
// (balanced by count). Its per-node state (the input gates gi, computed
// once, Σ_t ∂gi, ∂h, x̂) stays in a shared-memory tile for the whole
// launch, and each step's h̃ rows are staged one step ahead with cp.async.
// A lane keeps its column of ∂W_hh (and, after the walk, of ∂W_ih) in
// registers over its nodes; W_hh's and W_ih's transposed products are
// reduce-scatters over the group. The T + 1 slots' batch sums are block
// partials combined in block order: within one thread-block cluster of
// 1-8 blocks through distributed shared memory (small batches), or on a
// grid of co-resident blocks through per-round flags in global memory —
// no grid barrier, the cooperative launch kept for co-residency only. The
// blocks' gradient rows are summed in block order by the last block of
// each counter group: no memset before the launch, no float atomics. A
// block whose nodes outgrow its tile keeps them in its region of global
// scratch (the same code). kernels/recurrence.py::launch_shape picks the
// route from shapes alone.
//
// Numerics: float32 FMA only. Every cross-thread sum runs in a fixed order
// (groups, then warps, then blocks or ranks), so a launch gives the same
// bits on every run of the same route. Σ_t ∂gi is summed before W_ih's two
// products, as the plain version does not.
//
// Bound on an H100 SXM: per node and step the replayed hidden gates, the
// transposed product for ∂h and the outer products of ∂W_hh (~18f² flop)
// over the bytes of the stash, the residual inputs and the outputs
// (chip_smoke.py::_rec_bounds).

#include "recurrence_common.cuh"
#include "walk_bwd.cuh"

namespace {

using namespace mpnn_rec;
using namespace mpnn_walk;

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

// rounds of batch sums: slots 0..T
constexpr int kRounds = kMaxSteps + 1;
constexpr int kFlagWords = flag_words(kRounds);
// a round's block partial, packed to the real features: S1 (f), S2 (f),
// the real-node count (2f + 1 floats of a kCW slot)
constexpr int kCW = 2 * FP + 4;
// per-node state (floats): gi r|z|n, Σ_t ∂gi r|z|n, ∂h, x̂. After the
// walk the gi part holds ∂mb and x̂ of the messages.
constexpr int kGi = 0, kSda = 3 * FP, kGh = 6 * FP, kXh = 7 * FP,
              SS = 8 * FP;
constexpr int kDmb = 0, kX0 = FP;
// W_hh's column a lane: in registers at FP 16, read from shared memory at
// FP 32 (192 registers of weights and gradients would spill)
constexpr bool kWReg = FP <= 16;

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
  float* scratch;       // scratch_floats(...)
  unsigned long long* flags;  // grid route: kFlagWords, zero once
  int* counters;        // grid route: kMaxGroups + 1, zero between launches
  long long* prof;      // null, or kProfSlots clock64 stamps (block 0)
  int n_nodes, f, steps, route, ncap, floor;
};

// Offsets (floats) of one block's shared memory past the staged weights
// and norm constants (RL::after_stats).
struct Smem {
  int tot, cpart, misc, red, sb, state, total;
  __host__ __device__ Smem(int steps, int ncap) {
    int off = al4(RL::after_stats(steps));
    tot = off;    off += kCW;
    cpart = off;  off += (steps + 1) * kCW;
    misc = off;   off += 4;
    red = off;    off += kRed;
    sb = off;     off += 2 * ncap * FP;
    state = off;  off += ncap * SS;
    total = off;
  }
};

size_t smem_bytes(int steps, int ncap) {
  return sizeof(float) * size_t(Smem(steps, ncap).total);
}

// Offsets (floats) of the global scratch.
struct Scratch {
  size_t state, cparts, rows, gparts, total;
  __host__ __device__ Scratch(int n, int f, int steps, int grid) {
    const size_t nw = GradLayout(f).total;
    size_t off = 0;
    state = off;   off += size_t(n) * SS;          // spilled blocks' tiles
    cparts = off;  off += size_t(steps + 1) * grid * kCW;
    rows = off;    off += size_t(grid) * nw;
    gparts = off;  off += size_t(kMaxGroups) * nw;
    total = off;
  }
};

struct Ctx {
  const BwdArgs& a;
  float* sm;
  Smem L2;
  Sync y;
  const GradLayout gl;
  float* row;               // this block's gradient row
  int n0, nb;
  float c;
};

// The block partial of per-lane (s1, s2[, the count]) over its groups (in
// order) into round s's slot, then the totals over the launch's blocks
// into tot.
__device__ void batch_sums(Ctx& x, int s, float s1, float s2,
                           float cnt = 0.f) {
  float v[3] = {s1, s2, cnt};
  float* bp = x.sm + x.L2.cpart + s * kCW;
  const int f = x.a.f;
  groups_to<3>(v, x.sm + x.L2.red, [&](int i, int j, float t) {
    if (i < 2 && j < f)
      bp[i * f + j] = t;
    else if (i == 2 && j == 0)
      bp[2 * f] = t;
  });
  const BwdArgs& a = x.a;
  float* gp = a.scratch +
              Scratch(a.n_nodes, a.f, a.steps, x.y.nblocks).cparts +
              size_t(s) * x.y.nblocks * kCW;
  combine(x.y, bp, x.sm + x.L2.tot, 2 * f + 1, gp,
          a.flags + size_t(s) * kMaxGrid * kFlagStride, x.sm + x.L2.red);
}

// The body of one block, its per-node state in shared memory (kSm) or in
// its region of global scratch.
template <bool kSm>
__device__ void body(Ctx& x) {
  const BwdArgs& a = x.a;
  float* sm = x.sm;
  const int tid = threadIdx.x, q = tid / GS, j = tid % GS;
  const int f = a.f, T = a.steps, N = a.n_nodes;
  const int n0 = x.n0, nb = x.nb;
  const size_t slot_sz = size_t(N) * f;
  const GradLayout& gl = x.gl;
  const float* w = sm;
  const float* st = sm + RL::kStats;
  float* red = sm + x.L2.red;
  const Scratch sc(N, f, T, x.y.nblocks);
  float* state = kSm ? sm + x.L2.state : a.scratch + sc.state + size_t(n0) * SS;
  float* sbuf = sm + x.L2.sb;            // staged h̃ rows (kSm only)
  const int ncap = a.ncap;

  // ---- staging: ∂h_T, h̃_T, the messages (in Σ∂gi's place) -------------
  for (int i = tid; i < nb * FP; i += kBT) {
    const int v = i / FP, jj = i % FP;
    float* s = state + size_t(v) * SS;
    const size_t g = size_t(n0 + v) * f + jj;
    if (jj < f) {
      copy4<kSm>(s + kGh + jj, a.ght + g);
      copy4<kSm>(s + kXh + jj, a.htil + size_t(T - 1) * slot_sz + g);
      copy4<kSm>(s + kSda + jj, a.msgs + g);
    } else {
      s[kGh + jj] = 0.f;
      s[kXh + jj] = 0.f;
      s[kSda + jj] = 0.f;
    }
  }
  // h̃ of index k (slot k + 1) into buffer k & 1: step t reads index t − 2
  auto stage_slot = [&](int k) {
    if constexpr (kSm) {
      float* buf = sbuf + (k & 1) * ncap * FP;
      for (int i = tid; i < nb * FP; i += kBT) {
        const int v = i / FP, jj = i % FP;
        if (jj < f)
          cp_async4(buf + i,
                    a.htil + size_t(k) * slot_sz + size_t(n0 + v) * f + jj);
        else
          buf[i] = 0.f;
      }
    }
  };
  if (T >= 2) stage_slot(T - 2);
  cp_async_wait_all();
  __syncthreads();
  stamp(a.prof, 1);

  // ---- gi once per node, x̂ of slot T and its batch sums ------------------
  const float* stT = st + T * RL::kSlot;
  const float* st0 = st;
  const float bnw = w[RL::kBnW + j], bnb = w[RL::kBnB + j];
  const float maw = w[RL::kMaW + j], mab = w[RL::kMaB + j];
  // compensated per-lane sums: a block's nodes can run to thousands
  Ksum s1, s2, bnw_acc, bnb_acc;
  float cnt = 0.f;
  for (int i0 = 0; i0 < nb; i0 += NG) {
    // warp-uniform rounds: a slot past the block's nodes runs on node 0
    // and writes nothing
    const int i = i0 + q;
    const bool ok = i < nb;
    float* s = state + size_t(ok ? i : 0) * SS;
    const float m = ok ? __ldg(a.mask + n0 + i) : 0.f;
    const float xh = (s[kXh + j] - stT[j]) / stT[2 * FP + j];
    const float gh = m * s[kGh + j];
    const float v0 = gh * bnw;
    s1.add(v0);
    s2.add(v0 * xh);
    bnw_acc.add(gh * xh);
    bnb_acc.add(gh);
    cnt += m;
    const float raw0 = s[kSda + j];
    const float mb = m * (maw * ((raw0 - st0[j]) / st0[2 * FP + j]) + mab);
    float gr = w[RL::kBih + j], gz = w[RL::kBih + FP + j],
          gn = w[RL::kBih + 2 * FP + j];
#pragma unroll
    for (int k = 0; k < FP; ++k) {
      const float mk = gshfl(mb, k);
      const float* wi = w + RL::kWih + k * 3 * FP;
      gr = fmaf(mk, wi[j], gr);
      gz = fmaf(mk, wi[FP + j], gz);
      gn = fmaf(mk, wi[2 * FP + j], gn);
    }
    __syncwarp();
    if (ok) {
      s[kXh + j] = xh;
      s[kGh + j] = gh;
      s[kGi + j] = gr;
      s[kGi + FP + j] = gz;
      s[kGi + 2 * FP + j] = gn;
      s[kSda + j] = 0.f;
      s[kSda + FP + j] = 0.f;
      s[kSda + 2 * FP + j] = 0.f;
    }
  }
  stamp(a.prof, 2);
  batch_sums(x, T, s1.s, s2.s, cnt);
  x.c = sm[x.L2.tot + 2 * f];
  stamp(a.prof, 3);

  // ---- the reverse walk, t = T..1 ----------------------------------------
  float dwh[3][FP], bhh_acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int k = 0; k < FP; ++k) dwh[g][k] = 0.f;
  float wc[3][kWReg ? FP : 1];
  if constexpr (kWReg) {
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int k = 0; k < FP; ++k)
        wc[g][k] = w[RL::kWhh + k * 3 * FP + g * FP + j];
  }
  const float bhr = w[RL::kBhh + j], bhz = w[RL::kBhh + FP + j],
              bhn = w[RL::kBhh + 2 * FP + j];
  const float* tot = sm + x.L2.tot;
  for (int t = T; t >= 1; --t) {
    const float* stt = st + t * RL::kSlot;
    const float* stp = st + (t - 1) * RL::kSlot;
    if (t >= 3) stage_slot(t - 3);
    const float* sb = sbuf + (t & 1) * ncap * FP;    // index t − 2
    // the norm VJP of slot t as dhp = ∂h·bnw·rd − ca − x̂·cb, and x̂ of
    // slot t − 1 as (h̃ − mean)·rdp: reciprocals once a step
    const float rd = 1.0f / stt[2 * FP + j];
    const float ca = (j < f ? tot[j] : 0.f) / x.c * rd;
    const float cb =
        stt[3 * FP + j] * (j < f ? tot[f + j] : 0.f) / (x.c * stt[FP + j]);
    const float rdp = 1.0f / stp[2 * FP + j], meanp = stp[j];
    for (int i0 = 0; i0 < nb; i0 += NG) {
      const int i = i0 + q;
      const bool ok = i < nb;
      const int ic = ok ? i : 0;
      float* s = state + size_t(ic) * SS;
      const int n = n0 + ic;
      const float m = ok ? __ldg(a.mask + n) : 0.f;
      const float gh = s[kGh + j];
      const float dhp =
          m != 0.f ? fmaf(gh * bnw, rd, -ca) - s[kXh + j] * cb : 0.f;
      float hprev, xhp = 0.f;
      if (t > 1) {
        const float raw = kSm ? sb[ic * FP + j]
                              : (j < f ? __ldg(a.htil + size_t(t - 2) * slot_sz +
                                               size_t(n) * f + j)
                                       : 0.f);
        xhp = (raw - meanp) * rdp;
        hprev = m * (bnw * xhp + bnb);
      } else {
        hprev = j < f ? m * __ldg(a.h0 + size_t(n) * f + j) : 0.f;
      }
      float hb[FP];
#pragma unroll
      for (int k = 0; k < FP; ++k) hb[k] = gshfl(hprev, k);
      const float* wv = w + opaque_zero();
      float ghr = bhr, ghz = bhz, ghn = bhn;
#pragma unroll
      for (int k = 0; k < FP; ++k) {
        if constexpr (kWReg) {
          ghr = fmaf(wc[0][k], hb[k], ghr);
          ghz = fmaf(wc[1][k], hb[k], ghz);
          ghn = fmaf(wc[2][k], hb[k], ghn);
        } else {
          const float* wh = wv + RL::kWhh + k * 3 * FP + j;
          ghr = fmaf(wh[0], hb[k], ghr);
          ghz = fmaf(wh[FP], hb[k], ghz);
          ghn = fmaf(wh[2 * FP], hb[k], ghn);
        }
      }
      const float sr = sigmoidf_(s[kGi + j] + ghr);
      const float sz = sigmoidf_(s[kGi + FP + j] + ghz);
      const float tn = tanhf(s[kGi + 2 * FP + j] + sr * ghn);
      const float dz = dhp * (hprev - tn);
      const float da_n = dhp * (1.0f - sz) * (1.0f - tn * tn);
      const float dnh = da_n * sr;
      const float da_r = da_n * ghn * sr * (1.0f - sr);
      const float da_z = dz * sz * (1.0f - sz);
      const float sdr = s[kSda + j], sdz = s[kSda + FP + j],
                  sdn = s[kSda + 2 * FP + j];
      __syncwarp();
      if (ok) {
        s[kSda + j] = sdr + da_r;
        s[kSda + FP + j] = sdz + da_z;
        s[kSda + 2 * FP + j] = sdn + da_n;
      }
      bhh_acc[0] += da_r;
      bhh_acc[1] += da_z;
      bhh_acc[2] += dnh;
      float p[FP];
#pragma unroll
      for (int k = 0; k < FP; ++k) {
        dwh[0][k] = fmaf(hb[k], da_r, dwh[0][k]);
        dwh[1][k] = fmaf(hb[k], da_z, dwh[1][k]);
        dwh[2][k] = fmaf(hb[k], dnh, dwh[2][k]);
        float v;
        if constexpr (kWReg) {
          v = wc[0][k] * da_r;
          v = fmaf(wc[1][k], da_z, v);
          v = fmaf(wc[2][k], dnh, v);
        } else {
          const float* wh = wv + RL::kWhh + k * 3 * FP + j;
          v = wh[0] * da_r;
          v = fmaf(wh[FP], da_z, v);
          v = fmaf(wh[2 * FP], dnh, v);
        }
        p[k] = v;
      }
      reduce_scatter<FP>(p, j);
      const float gprev = m * fmaf(dhp, sz, p[0]);
      if (!ok) {
      } else if (t > 1) {
        s[kGh + j] = gprev;
        s[kXh + j] = xhp;
      } else if (j < f) {
        a.dh0[size_t(n) * f + j] = gprev;
      }
    }
    cp_async_wait_all();
    stamp(a.prof, 4 + 2 * (T - t));
    if (t > 1) {
      // slot t − 1's sums from the tile (each group its own nodes)
      Ksum u1, u2;
      for (int i = q; i < nb; i += NG) {
        const float* s = state + size_t(i) * SS;
        const float gh = s[kGh + j], xh = s[kXh + j];
        const float v0 = gh * bnw;
        u1.add(v0);
        u2.add(v0 * xh);
        bnw_acc.add(gh * xh);
        bnb_acc.add(gh);
      }
      batch_sums(x, t - 1, u1.s, u2.s);
    } else {
      __syncthreads();
    }
    stamp(a.prof, 5 + 2 * (T - t));
  }
  // ∂W_hh, ∂b_hh and the state norm's affine into the row
  float* row = x.row;
#pragma unroll
  for (int g = 0; g < 3; ++g)
    groups_to<FP>(dwh[g], red, [&](int k, int jj, float v) {
      if (k < f && jj < f) row[gl.whh + k * 3 * f + g * f + jj] = v;
    });
  {
    float v[5] = {bhh_acc[0], bhh_acc[1], bhh_acc[2], bnw_acc.s,
                  bnb_acc.s};
    groups_to<5>(v, red, [&](int i, int jj, float s) {
      if (jj >= f) return;
      if (i < 3)
        row[gl.bhh + i * f + jj] = s;
      else
        row[(i == 3 ? gl.bnw : gl.bnb) + jj] = s;
    });
  }
  stamp(a.prof, 70);

  // ---- W_ih's two products once, on Σ_t ∂gi; the message norm's sums ----
  Ksum m1, m2;
  {
    float dwi[3][FP], bih_acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int k = 0; k < FP; ++k) dwi[g][k] = 0.f;
    Ksum maw_acc, mab_acc;
    for (int i0 = 0; i0 < nb; i0 += NG) {
      const int i = i0 + q;
      const bool ok = i < nb;
      const int ic = ok ? i : 0;
      float* s = state + size_t(ic) * SS;
      const int n = n0 + ic;
      const float m = ok ? __ldg(a.mask + n) : 0.f;
      const float raw0 = j < f ? __ldg(a.msgs + size_t(n) * f + j) : 0.f;
      const float x0 = (raw0 - st0[j]) / st0[2 * FP + j];
      const float mb = m * (maw * x0 + mab);
      const float dr = ok ? s[kSda + j] : 0.f,
                  dz = ok ? s[kSda + FP + j] : 0.f,
                  dn = ok ? s[kSda + 2 * FP + j] : 0.f;
      bih_acc[0] += dr;
      bih_acc[1] += dz;
      bih_acc[2] += dn;
      const float* wv = w + opaque_zero();
      float p[FP];
#pragma unroll
      for (int k = 0; k < FP; ++k) {
        const float mk = gshfl(mb, k);
        dwi[0][k] = fmaf(mk, dr, dwi[0][k]);
        dwi[1][k] = fmaf(mk, dz, dwi[1][k]);
        dwi[2][k] = fmaf(mk, dn, dwi[2][k]);
        const float* wi = wv + RL::kWih + k * 3 * FP + j;
        float v = wi[0] * dr;
        v = fmaf(wi[FP], dz, v);
        v = fmaf(wi[2 * FP], dn, v);
        p[k] = v;
      }
      reduce_scatter<FP>(p, j);
      const float dmb = m * p[0];
      __syncwarp();
      if (ok) {
        s[kDmb + j] = dmb;
        s[kX0 + j] = x0;
      }
      const float v0 = dmb * maw;
      m1.add(v0);
      m2.add(v0 * x0);
      maw_acc.add(dmb * x0);
      mab_acc.add(dmb);
    }
#pragma unroll
    for (int g = 0; g < 3; ++g)
      groups_to<FP>(dwi[g], red, [&](int k, int jj, float v) {
        if (k < f && jj < f) row[gl.wih + k * 3 * f + g * f + jj] = v;
      });
    float v[5] = {bih_acc[0], bih_acc[1], bih_acc[2], maw_acc.s,
                  mab_acc.s};
    groups_to<5>(v, red, [&](int i, int jj, float s) {
      if (jj >= f) return;
      if (i < 3)
        row[gl.bih + i * f + jj] = s;
      else
        row[(i == 3 ? gl.maw : gl.mab) + jj] = s;
    });
  }
  stamp(a.prof, 71);
  batch_sums(x, 0, m1.s, m2.s);
  stamp(a.prof, 72);
  // ∂msgs through the message norm
  {
    const float S1 = j < f ? tot[j] : 0.f, S2 = j < f ? tot[f + j] : 0.f;
    const float rd0 = 1.0f / st0[2 * FP + j];
    const float c0 = st0[3 * FP + j] * S2 / (x.c * st0[FP + j]);
    for (int i = q; i < nb; i += NG) {
      const float* s = state + size_t(i) * SS;
      const float m = __ldg(a.mask + n0 + i);
      const float dm =
          m != 0.f ? (s[kDmb + j] * maw - S1 / x.c) * rd0 - s[kX0 + j] * c0
                   : 0.f;
      if (j < f) a.dmsgs[size_t(n0 + i) * f + j] = dm;
    }
  }
  stamp(a.prof, 73);
}

// The empty walk: the route's grid, each round's combine of zero partials
// and the final sum of a zero row.
__device__ void floor_body(Ctx& x) {
  for (int e = threadIdx.x; e < x.gl.total; e += kBT) x.row[e] = 0.f;
  __syncthreads();
  batch_sums(x, x.a.steps, 0.f, 0.f, 0.f);
  for (int t = x.a.steps; t >= 1; --t) {
    if (t > 1)
      batch_sums(x, t - 1, 0.f, 0.f);
    else
      __syncthreads();
  }
  batch_sums(x, 0, 0.f, 0.f);
}

__global__ void __launch_bounds__(kBT, 1)
recurrence_bwd_kernel(BwdArgs a) {
  extern __shared__ float sm[];
  const int tid = threadIdx.x;
  const int nblocks = int(gridDim.x);
  Ctx x{a, sm, Smem(a.steps, a.ncap),
        Sync{a.route, nblocks, int(blockIdx.x), 0ull, a.flags, a.counters,
             a.flags == nullptr ? nullptr : a.flags + kFlagWords - 1},
        GradLayout(a.f), nullptr, 0, 0, 0.f};
  stamp(a.prof, 0);
  const bool flagged = a.route == kRouteGrid && nblocks > 1;
  if (flagged && tid == 0)
    reinterpret_cast<unsigned long long*>(sm + x.L2.misc)[0] =
        ld_flag(x.y.last) + 1;
  stage_rec_weights(sm, a.w, a.f);
  float* st = sm + RL::kStats;
  for (int i = tid; i < (a.steps + 1) * FP; i += kBT) {
    const int s = i / FP, jj = i % FP;
    const float mean = jj < a.f ? a.stats[(size_t(s) * 2) * a.f + jj] : 0.f;
    const float var = jj < a.f ? a.stats[(size_t(s) * 2 + 1) * a.f + jj] : 0.f;
    set_rec_slot(st + s * RL::kSlot, jj, mean, var);
  }
  __syncthreads();
  if (flagged)
    x.y.tag = reinterpret_cast<unsigned long long*>(sm + x.L2.misc)[0];
  x.n0 = split_at(a.n_nodes, nblocks, x.y.b);
  x.nb = split_at(a.n_nodes, nblocks, x.y.b + 1) - x.n0;
  const bool alone = nblocks == 1;
  const Scratch sc(a.n_nodes, a.f, a.steps, nblocks);
  x.row = alone ? a.dw
                : a.scratch + sc.rows + size_t(x.y.b) * x.gl.total;
  if (a.floor)
    floor_body(x);
  else if (x.nb <= a.ncap)
    body<true>(x);
  else
    body<false>(x);
  if (!alone) {
    if (a.route == kRouteCluster)
      final_sum_cluster(x.y, a.dw, a.scratch + sc.rows, x.gl.total,
                        x.gl.total);
    else
      final_sum_grid(x.y, a.dw, a.scratch + sc.rows, x.gl.total,
                     x.gl.total, a.scratch + sc.gparts);
  }
  stamp(a.prof, 75);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block at node capacity ncap, in bytes
// (kernels/recurrence.py::bwd_smem_floats mirrors it).
int mpnn_recurrence_bwd_smem_bytes(int steps, int ncap) {
  return int(smem_bytes(steps, ncap));
}

// Offsets of the flat gradient's leaves (8) and its total, for the
// wrapper's check of its own layout.
void mpnn_recurrence_bwd_layout(int f, int* out) {
  const GradLayout gl(f);
  const int v[] = {gl.wih, gl.whh, gl.bih, gl.bhh, gl.maw,
                   gl.mab, gl.bnw, gl.bnb, gl.total};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
}

// Floats of scratch a launch of `grid` blocks needs: spilled blocks'
// tiles, the rounds' block partials, the blocks' gradient rows and the
// counter groups' sums.
long long mpnn_recurrence_bwd_scratch_floats(int n_nodes, int f, int steps,
                                             int grid) {
  return (long long)Scratch(n_nodes, f, steps, grid).total;
}

// The flag and counter words of the grid route (one buffer each per
// stream, zeroed once): u64 flags, int counters.
int mpnn_recurrence_bwd_sync_words(int* counters) {
  *counters = kMaxGroups + 1;
  return kFlagWords;
}

// The co-resident blocks of the grid route at this shared memory, capped
// at kMaxGrid; 0 on error.
int mpnn_recurrence_bwd_max_grid(int bytes) {
  return max_grid(recurrence_bwd_kernel, bytes);
}

// Launches on `stream` and returns the launch's error code (0 = success).
// route 0: one cluster of `grid` blocks (1, 2, 4 or 8); route 1: `grid`
// co-resident blocks with `flags` and `counters`. ncap: the node capacity
// of a block's shared-memory tile. floor != 0 launches the empty walk (the
// same grid, combines and final sum; dw gets zeros). prof: null or
// kProfSlots int64 clock64 stamps of block 0. Does not synchronize and
// allocates nothing.
int mpnn_recurrence_bwd(const float* msgs, const float* h0,
                        const float* mask, const float* w_ih,
                        const float* w_hh, const float* b_ih,
                        const float* b_hh, const float* ma_w,
                        const float* ma_b, const float* bn_w,
                        const float* bn_b, const float* stats,
                        const float* htil, const float* ght, float* dmsgs,
                        float* dh0, float* dw, float* scratch,
                        unsigned long long* flags, int* counters,
                        long long* prof, int n_nodes, int f, int steps,
                        int route, int grid, int ncap, int floor,
                        void* stream) {
  if (f < 1 || f > FP || steps < 1 || steps > kMaxSteps || n_nodes < 1 ||
      grid < 1 || ncap < 1 ||
      (route == kRouteCluster &&
       (grid != 1 && grid != 2 && grid != 4 && grid != 8)) ||
      (route == kRouteGrid &&
       (grid > kMaxGrid || (grid > 1 && (!flags || !counters)))) ||
      (route != kRouteCluster && route != kRouteGrid))
    return int(cudaErrorInvalidValue);
  BwdArgs a{{w_ih, w_hh, b_ih, b_hh, ma_w, ma_b, bn_w, bn_b},
            msgs, h0, mask, stats, htil, ght, dmsgs, dh0, dw, scratch,
            route == kRouteGrid ? flags : nullptr,
            route == kRouteGrid ? counters : nullptr, prof,
            n_nodes, f, steps, route, ncap, floor};
  return launch_route(recurrence_bwd_kernel, a, route, grid,
                      smem_bytes(steps, ncap), stream);
}

const char* mpnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
