"""Whole-step ops of the PER-STEP edge-network MPNN (the graph_norm and
encoded models): one message network and, where the model has bn1d norms,
one norm pair per step; messages from the initial state.

  * fused_psteps_eval — counterpart of mpnn_tpu/kernels/fused_psteps.py::
    make_fused_psteps_eval_op (Pallas `_ps_eval_kernel`): T per-step
    SpMMs Σ A_t[vid]·h0[src] + A0_t·S_g + bias_t, then per step the folded
    message affine, the GRU and the state norm (folded bn1d, the
    STATELESS norm over the whole batch, or none), and the gated readout
    over [h_T ‖ h0] — one launch (csrc/fused_psteps_eval.cu).
  * fused_psteps — counterpart of make_fused_psteps_op (Pallas
    `_ps_fwd_kernel`, and its two backwards): the same chain with the
    per-step norms in training mode (batch statistics per step) and the
    masked-MSE loss, as a torch.autograd.Function whose forward is one
    launch (csrc/fused_psteps_fwd.cu) and whose backward
    takes one of two routes, as the JAX package's does
    (kernels/split_bwd.py); the forward runs on a thread-block cluster or
    a grid of co-resident blocks that fwd_launch_shape picks, with no grid
    barrier. Up to 28,672 padded node slots the whole
    backward in one launch (`_ps_bwd_kernel` → csrc/fused_psteps_bwd.cu,
    on a thread-block cluster or a grid of co-resident blocks that
    launch_shape picks, with no grid barrier);
    past them the split backward of `_streaming_bwd` — the readout VJP
    (kernels/readout_bwd.py), the reverse walk (kernels/psteps_walk.py)
    and the message VJP of the T networks (kernels/msg_bwd.py). Both
    routes compute the same function at any size that fits device memory;
    `bwd=` forces one.

The index plan and the device-built source order are the shared family's
(graphs/batching.py::plan_fused_eval, kernels/fused_step.py::
source_order). Each op launches its kernel for CUDA tensors and runs its
plain version (fused_psteps_eval_reference, fused_psteps_reference under
autograd) for CPU tensors — nothing else: no fallback.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, NamedTuple

import torch

from mpnn_tpu_torch.graphs.batching import FusedEvalPlan
from mpnn_tpu_torch.kernels import fused_step as K
from mpnn_tpu_torch.kernels.split_bwd import route
from mpnn_tpu_torch.ops.norm import (BN_EPS, bn1d_train, fold_bn1d,
                                     mask_batch_norm_stats)

# width buckets of the CUDA kernels, narrowest first (as fused_step.py's).
# Each is its own build of csrc/fused_psteps_*.cu (kernels/build.py::
# WIDE). The wide backward stages 2·32 + 2·128 floats per node, which
# leaves shared memory for 6 steps' weights (csrc/fused_psteps_bwd.cu::
# kStage).
BUCKETS = (("", dict(f=16, od=32, steps=8)),
           ("f32", dict(f=32, od=128, steps=6)))
MAX_WIDTH = BUCKETS[-1][1]["f"]

# launches of each kernel wrapper; reset with reset_launch_counts()
launch_counts: Dict[str, int] = {"fused_psteps_eval": 0,
                                 "fused_psteps_fwd": 0,
                                 "fused_psteps_bwd": 0}

# norm modes as the kernels read them (the shared family's)
_MSG_MODES, _STATE_MODES = K.MSG_MODES, K.STATE_MODES
NONE, BATCH_BN, AFFINE, STATELESS = K.NONE, K.BATCH_BN, K.AFFINE, K.STATELESS


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _check_modes(who: str, msg_norm: str, state_norm: str) -> None:
    if msg_norm not in _MSG_MODES or state_norm not in _STATE_MODES:
        raise NotImplementedError(
            f"{who}: msg_norm={msg_norm!r}, state_norm={state_norm!r}; the "
            f"per-step kernels take msg norm in {_MSG_MODES} and state norm "
            f"in {_STATE_MODES}")


def _bucket(who: str, f: int, od: int, steps: int) -> str:
    if steps < 1:
        raise NotImplementedError(f"{who}: steps={steps}")
    return K.width_bucket(who, BUCKETS, f=f, od=od, steps=steps)


def _kernel_tensors(weights, tag: str):
    """The weight tensors in kernel argument order, the readout weights as
    the bucket reads them."""
    return [K.ro_table(t, tag) if name in ("ro_iw", "ro_jw") else t
            for name, t in weights]


# ---------------------------------------------------------------------------
# plain versions (CPU path; the card's comparison baseline)
# ---------------------------------------------------------------------------

def _fold_steps(p_bns, s_bns, mode: str, f: int, steps: int, like):
    """Per-step (scale (T, f), shift (T, f)) of eval-mode bn1d norms,
    eps OUTSIDE the sqrt; identity stand-ins for a mode without running
    statistics (the stateless norm normalizes inside the kernel)."""
    if mode != "bn1d":
        return (torch.ones(steps, f, dtype=like.dtype, device=like.device),
                torch.zeros(steps, f, dtype=like.dtype, device=like.device))
    folds = [fold_bn1d(p["weight"], p["bias"], s["running_mean"],
                       s["running_var"], BN_EPS)
             for p, s in zip(p_bns, s_bns)]
    return (torch.stack([a for a, _ in folds]),
            torch.stack([b for _, b in folds]))


def fused_psteps_eval_reference(amat, a0, mbias, h0, mask, node_graph, gru,
                                ma_bns, ma_states, bns, bn_states, ro, vid,
                                src, dst, plan: FusedEvalPlan, *, steps: int,
                                msg_norm: str = "bn1d",
                                state_norm: str = "bn1d"):
    """Plain PyTorch version of the eval kernel, the JAX op's arguments
    minus the TPU window plan plus the index plan (its graph count only is
    read): amat (T, K, f, f), a0 (T, f, f), mbias (T, f), h0 PRE-MASKED
    (N, f), per-step norm dicts as lists of T (ignored for a mode without
    them), weights in the JAX layout. Returns out (G, od)."""
    _check_modes("fused_psteps_eval", msg_norm, state_norm)
    f = h0.shape[1]
    num_graphs = plan.graph_node_ptr.shape[0] - 1
    ng = node_graph.long()
    maw, mab = _fold_steps(ma_bns, ma_states, msg_norm, f, steps, h0)
    sw, sb = _fold_steps(bns, bn_states, state_norm, f, steps, h0)
    h = h0 * mask
    for t in range(steps):
        msgs = K._messages(amat[t], a0[t], mbias[t], h0, ng, vid, src, dst,
                           num_graphs) * mask
        mb = (maw[t] * msgs + mab[t]) * mask
        h = K._gru(gru, mb @ gru["w_ih"] + gru["b_ih"], h, mask)
        if state_norm == "stateless":
            h, _ = mask_batch_norm_stats(h, mask)
        else:
            h = (sw[t] * h + sb[t]) * mask
    return K._readout(h, h0, mask, ng, ro, num_graphs)


def fused_psteps_reference(amat, a0, mbias, h0, mask, node_graph, gru,
                           ma_bns, bns, ro, labels, gmask, vid, src, dst,
                           plan: FusedEvalPlan, *, steps: int,
                           msg_norm: str = "bn1d", state_norm: str = "bn1d",
                           stash=None):
    """Plain PyTorch version of the training forward kernel (and, through
    autograd, of the backward kernel): make_fused_psteps_op's arguments
    minus the TPU window plan, plus the index plan. Returns (loss, out
    (G, od), [(ma_mean_t, ma_var_t)] × T, [(mean_t, var_t)] × T); the
    statistics are detached, zeros for a norm in mode 'none' (the
    stateless norm's are its batch mean and var, which feed no EMA).
    loss = Σ_g Σ_o (out_go − y_g)²·gm_g / Σ gm. A list `stash` receives
    the forward kernel's residuals: each step's masked messages, then
    each step's pre-norm GRU output."""
    _check_modes("fused_psteps", msg_norm, state_norm)
    f = h0.shape[1]
    num_graphs = plan.graph_node_ptr.shape[0] - 1
    ng = node_graph.long()
    zero = h0.new_zeros(f)
    h = h0 * mask
    ma_stats, bn_stats, states = [], [], []
    for t in range(steps):
        msgs = K._messages(amat[t], a0[t], mbias[t], h0, ng, vid, src, dst,
                           num_graphs) * mask
        if stash is not None:
            stash.append(msgs)
        if msg_norm == "bn1d":
            mb, st = bn1d_train(msgs, mask, ma_bns[t]["weight"],
                                ma_bns[t]["bias"])
        else:
            mb, st = msgs, (zero, zero)
        ma_stats.append(tuple(x.detach() for x in st))
        h = K._gru(gru, mb @ gru["w_ih"] + gru["b_ih"], h, mask)
        states.append(h)
        if state_norm == "bn1d":
            h, st = bn1d_train(h, mask, bns[t]["weight"], bns[t]["bias"])
        elif state_norm == "stateless":
            h, st = mask_batch_norm_stats(h, mask)
        else:
            st = (zero, zero)
        bn_stats.append(tuple(x.detach() for x in st))
    if stash is not None:
        stash.extend(states)
    out = K._readout(h, h0, mask, ng, ro, num_graphs)
    loss = (((out - labels[:, None]) ** 2) * gmask[:, None]).sum() \
        / gmask.sum()
    return loss, out, ma_stats, bn_stats


# ---------------------------------------------------------------------------
# the CUDA kernels' libraries
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fused_psteps_eval": {
        "mpnn_fused_psteps_eval": ([_P] * 24 + [_I] * 9 + [_P], _I),
        "mpnn_fused_psteps_eval_smem_bytes": ([_I], _I),
        "mpnn_fused_psteps_eval_scratch_floats": ([_I, _I, _I],
                                                  ctypes.c_longlong),
        "mpnn_fused_psteps_eval_grid": ([_I] * 3, _I),
    },
    "fused_psteps_fwd": {
        "mpnn_fused_psteps_fwd": ([_P] * 30 + [_I] * 15 + [_P], _I),
        "mpnn_fused_psteps_fwd_smem_bytes": ([_I] * 6, _I),
        "mpnn_fused_psteps_fwd_scratch_floats": ([_I] * 5,
                                                 ctypes.c_longlong),
        "mpnn_fused_psteps_fwd_max_grid": ([_I], _I),
        "mpnn_fused_psteps_fwd_counters": ([], _I),
    },
    "fused_psteps_bwd": {
        "mpnn_fused_psteps_bwd": ([_P] * 36 + [_I] * 14 + [_P], _I),
        "mpnn_fused_psteps_bwd_smem_bytes": ([_I] * 4, _I),
        "mpnn_fused_psteps_bwd_layout": ([_I] * 4 + [_P], None),
        "mpnn_fused_psteps_bwd_scratch_floats": ([_I] * 7,
                                                 ctypes.c_longlong),
        "mpnn_fused_psteps_bwd_sync_words": ([_P], _I),
        "mpnn_fused_psteps_bwd_max_grid": ([_I], _I),
    },
}


def _lib(name: str, tag: str = ""):
    return K._lib(name, _SIGNATURES, tag)


# the weight leaves, in the kernels' argument order (and the backward's
# flat gradient layout)
_GRAD_LEAVES = ("amat", "a0", "mbias", "w_ih", "w_hh", "b_ih", "b_hh",
                "ma_w", "ma_b", "bn_w", "bn_b", "ro_iw", "ro_ib", "ro_jw",
                "ro_jb")


def _leaf_shapes(k_vocab: int, f: int, od: int, steps: int):
    T = steps
    return [(T, k_vocab, f, f), (T, f, f), (T, f), (f, 3 * f), (f, 3 * f),
            (3 * f,), (3 * f,), (T, f), (T, f), (T, f), (T, f), (2 * f, od),
            (od,), (2 * f, od), (od,)]


def grad_layout(k_vocab: int, f: int, od: int, steps: int
                ) -> Dict[str, tuple]:
    """{leaf: (offset, shape)} of the backward kernel's flat gradient, in
    csrc/fused_psteps_bwd.cu's PsGradLayout order."""
    out, off = {}, 0
    for name, shape in zip(_GRAD_LEAVES,
                           _leaf_shapes(k_vocab, f, od, steps)):
        out[name] = (off, shape)
        off += math.prod(shape)
    out["total"] = (off, ())
    return out


def split_grads(dw: torch.Tensor, k_vocab: int, f: int, od: int,
                steps: int):
    """The flat gradient as {leaf: view of its shape}."""
    return {name: dw[off:off + math.prod(shape)].view(shape)
            for name, (off, shape)
            in grad_layout(k_vocab, f, od, steps).items() if name != "total"}


def _stack_norms(bns, key: str, f: int, steps: int, like):
    """(T, f) of the per-step norms' `key`, or the identity stand-in for a
    mode without them (ones for a weight, zeros for a bias)."""
    if bns:
        return torch.stack([b[key] for b in bns])
    fill = 1.0 if key == "weight" else 0.0
    return torch.full((steps, f), fill, dtype=like.dtype, device=like.device)


def _check_inputs(who, weights, h0, mask, node_graph, vid, src, dst, plan,
                  steps, extra=()):
    """Device, dtype, shape and contiguity of every kernel input; returns
    (n, f, od, k_vocab, e, num_graphs, the width bucket's tag)."""
    device = h0.device
    if device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {device}")
    n, f = h0.shape
    w = dict(weights)
    k_vocab = w["amat"].shape[1]
    od = w["ro_ib"].shape[0]
    e = src.shape[0]
    num_graphs = plan.graph_node_ptr.shape[0] - 1
    tag = _bucket(who, f, od, steps)
    for name, shape in zip(_GRAD_LEAVES,
                           _leaf_shapes(k_vocab, f, od, steps)):
        K._check(name, w[name], shape, device, torch.float32)
    for name, t, shape in [("h0", h0, (n, f)), ("mask", mask, (n, 1)),
                           *[(nm, t, (num_graphs,)) for nm, t in extra]]:
        K._check(name, t, shape, device, torch.float32)
    for name, t in [("vid", vid), ("src", src), ("dst", dst)]:
        K._check(name, t, (e,), device, torch.int32)
    K._check("node_graph", node_graph, (n,), device, torch.int32)
    K._check_plan(plan, device, n, e, num_graphs)
    K.check_batch_layout(h0, mask, node_graph, vid, src, dst, plan, k_vocab,
                         num_graphs, who=who)
    return n, f, od, k_vocab, e, num_graphs, tag


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# fused_psteps_eval: the serving kernel
# ---------------------------------------------------------------------------

def fused_psteps_eval(amat, a0, mbias, h0, mask, node_graph, gru, ma_bns,
                      ma_states, bns, bn_states, ro, vid, src, dst,
                      plan: FusedEvalPlan, *, steps: int,
                      msg_norm: str = "bn1d", state_norm: str = "bn1d"):
    """Whole-step inference of the per-step family: out (G, od). Arguments
    as fused_psteps_eval_reference. CPU tensors run the plain version;
    CUDA tensors launch the CUDA kernel or raise."""
    _check_modes("fused_psteps_eval", msg_norm, state_norm)
    if h0.device.type == "cpu":
        return fused_psteps_eval_reference(
            amat, a0, mbias, h0, mask, node_graph, gru, ma_bns, ma_states,
            bns, bn_states, ro, vid, src, dst, plan, steps=steps,
            msg_norm=msg_norm, state_norm=state_norm)
    return K.launch_prepared(prepare_fused_psteps_eval(
        amat, a0, mbias, h0, mask, node_graph, gru, ma_bns, ma_states, bns,
        bn_states, ro, vid, src, dst, plan, steps=steps, msg_norm=msg_norm,
        state_norm=state_norm))


def prepare_fused_psteps_eval(amat, a0, mbias, h0, mask, node_graph, gru,
                              ma_bns, ma_states, bns, bn_states, ro, vid,
                              src, dst, plan: FusedEvalPlan, *, steps: int,
                              msg_norm: str = "bn1d",
                              state_norm: str = "bn1d") -> K.PreparedLaunch:
    """Checks every input and the batch layout, folds the eval-mode norms
    to per-step affines, allocates the output and the scratch of one
    CUDA launch."""
    _check_modes("fused_psteps_eval", msg_norm, state_norm)
    f = h0.shape[1]
    maw, mab = _fold_steps(ma_bns, ma_states, msg_norm, f, steps, h0)
    sw, sb = _fold_steps(bns, bn_states, state_norm, f, steps, h0)
    weights = [("amat", amat), ("a0", a0), ("mbias", mbias),
               ("w_ih", gru["w_ih"]), ("w_hh", gru["w_hh"]),
               ("b_ih", gru["b_ih"]), ("b_hh", gru["b_hh"]),
               ("ma_w", maw.contiguous()), ("ma_b", mab.contiguous()),
               ("bn_w", sw.contiguous()), ("bn_b", sb.contiguous()),
               ("ro_iw", ro["i"]["w"]), ("ro_ib", ro["i"]["b"]),
               ("ro_jw", ro["j"]["w"]), ("ro_jb", ro["j"]["b"])]
    n, f, od, k_vocab, e, g, tag = _check_inputs(
        "fused_psteps_eval", weights, h0, mask, node_graph, vid, src, dst,
        plan, steps)
    lib = _lib("fused_psteps_eval", tag)
    device = h0.device
    grid = K._grid(lib, "mpnn_fused_psteps_eval_grid", steps, n, g)
    kw = dict(dtype=torch.float32, device=device)
    out = torch.empty(g, od, **kw)
    # the T steps' messages and one state slot, updated in place
    htil = torch.empty(steps + 1, n, f, **kw)
    scratch = torch.empty(
        lib.mpnn_fused_psteps_eval_scratch_floats(n, g, steps), **kw)
    msg_mode = AFFINE if msg_norm == "bn1d" else NONE
    state_mode = {"bn1d": AFFINE, "stateless": STATELESS,
                  "none": NONE}[state_norm]
    tensors = _kernel_tensors(weights, tag) + [
        h0, vid, src, plan.edge_order, plan.dst_ptr, plan.graph_node_ptr,
        out, htil, scratch]
    args = (*(t.data_ptr() for t in tensors), n, g, f, od, k_vocab, steps,
            msg_mode, state_mode, grid, _stream(device))
    return K.PreparedLaunch("fused_psteps_eval", lib.mpnn_fused_psteps_eval,
                            lib.mpnn_cuda_error_string, args, out,
                            tuple(tensors), launch_counts)


# ---------------------------------------------------------------------------
# fused_psteps: the training forward and backward kernels
# ---------------------------------------------------------------------------

class PsMeta(NamedTuple):
    steps: int
    msg_mode: int
    state_mode: int
    split: int = 0          # the split backward (kernels/split_bwd.py)


# ---------------------------------------------------------------------------
# the training forward's routes (csrc/fused_psteps_fwd.cu)
# ---------------------------------------------------------------------------

FWD_THREADS = 256          # kFT
FWD_PROF_SLOTS = 80        # kProfSlots: block 0's clock64 stamps
# The T·K message tables sit in shared memory up to this many floats
# (64 KB: encoded's T 3, K 8 at FP 16 take 24 KB; at K 64 they would take
# 196 KB), else the kernel reads them through the read-only cache
# (csrc/fused_psteps_fwd.cu::kAmatSmemFloats).
AMAT_SMEM_FLOATS = 16384


def amat_in_smem(tag: str, k_vocab: int, steps: int) -> bool:
    """Whether the forward stages the T·K message tables in shared memory."""
    fp = dict(BUCKETS)[tag]["f"]
    return steps * k_vocab * fp * fp <= AMAT_SMEM_FLOATS


def fwd_smem_floats(tag: str, k_vocab: int, steps: int, ncap: int,
                    ecap: int, blocks: int) -> int:
    """Floats of one forward block's shared memory in a launch of `blocks`
    blocks (csrc/fused_psteps_fwd.cu::Smem after fused_psteps_common.cuh::
    PL): the staged weights and the 2T slots' norm constants, the message
    tables when they fit (amat_in_smem), each slot's partial row, the
    reduction scratch, every block's partial row of the slot being
    combined, the block's edge tables (ncap nodes, ecap edges) and the node
    tile (h0, the state, the T messages: max((2 + T)·FP, od) a node)."""
    b = dict(BUCKETS)[tag]
    fp, odw, T = b["f"], b["od"], steps
    al4 = lambda v: (v + 3) & ~3
    ro = 2 * fp * odw if odw <= 32 else 0          # kRoInSmem
    weights = (2 * fp * 3 * fp + 6 * fp + 2 * ro + 2 * odw
               + T * (fp * fp + 5 * fp) + 2 * T * 3 * fp)
    n = al4(weights)
    n += T * k_vocab * fp * fp if amat_in_smem(tag, k_vocab, T) else 0
    n += al4(2 * T * (3 * fp + 4)) + 2 * FWD_THREADS
    n += max(blocks, 1) * (2 * fp + 4)
    return n + al4(ncap + 1 + 2 * ecap) + ncap * max((2 + T) * fp, odw)


def fwd_capacity(tag: str, k_vocab: int, steps: int, smem_bytes: int,
                 blocks: int) -> int:
    """The most node slots (at most fused_step.FWD_MAX_NCAP, EDGE_RATIO
    edges each) whose tile fits `smem_bytes` of a forward block in a launch
    of up to `blocks` blocks; 0 when none does."""
    return K.tile_capacity(
        lambda c: fwd_smem_floats(tag, k_vocab, steps, c, EDGE_RATIO * c,
                                  blocks), smem_bytes, K.FWD_MAX_NCAP)


def fwd_launch_shape(n: int, tag: str, k_vocab: int, steps: int, *,
                     sums: bool, smem_bytes: int, max_grid: int
                     ) -> K.FwdShape:
    """The training forward's route for a batch of `n` node slots: the
    shared family's forward policy (fused_step.fwd_policy and its
    constants) on this kernel's tiles, with `sums` for a norm on batch
    statistics (the T message norms' one combine or a state norm's combine
    a step): up to 512 slots one cluster, past them a grid of a block per
    24 slots; without either a grid of a block per 16 slots."""
    return K.fwd_policy(
        f"fused_psteps_fwd: one node at vocab {k_vocab}, T {steps}", n,
        lambda c, g: fwd_smem_floats(tag, k_vocab, steps, c, EDGE_RATIO * c,
                                     g),
        sums=sums, smem_bytes=smem_bytes, max_grid=max_grid)


def device_fwd_shape(n: int, tag: str, k_vocab: int, steps: int,
                     sums: bool, device) -> K.FwdShape:
    """fwd_launch_shape on `device`'s shared memory and the kernel's
    co-resident blocks."""
    def most(smem, sms):
        cap = max(fwd_capacity(tag, k_vocab, steps, smem, sms), 1)
        return _lib("fused_psteps_fwd", tag).mpnn_fused_psteps_fwd_max_grid(
            4 * fwd_smem_floats(tag, k_vocab, steps, cap, EDGE_RATIO * cap,
                                sms))
    return K.device_shape(
        ("fused_psteps_fwd", n, tag, k_vocab, steps, sums), device, most,
        lambda smem, m: fwd_launch_shape(n, tag, k_vocab, steps, sums=sums,
                                         smem_bytes=smem, max_grid=m))


# The forward's grid-route counters (each round's arrivals, the launch's),
# one buffer per device and stream, zeroed once: every launch leaves them
# zero.
_FWD_COUNTERS: Dict[tuple, torch.Tensor] = {}


def _fwd_counters(shape: K.FwdShape, tag: str, device, stream: int):
    if shape.route != "grid" or shape.grid < 2:
        return None
    key = (str(device), stream)
    if key not in _FWD_COUNTERS:
        _FWD_COUNTERS[key] = torch.zeros(
            _lib("fused_psteps_fwd", tag).mpnn_fused_psteps_fwd_counters(),
            dtype=torch.int32, device=device)
    return _FWD_COUNTERS[key]


def prepare_fused_psteps_fwd(weights, h0, mask, node_graph, labels, gmask,
                             vid, src, dst, plan: FusedEvalPlan,
                             meta: PsMeta, prof=None, floor: bool = False
                             ) -> K.PreparedLaunch:
    """One checked forward launch on its route (device_fwd_shape): outputs
    loss (1,), out (G, od), stats (2T, 2, f) and the residual stash htil
    (2T, N, f) — slots 0..T-1 the masked messages of each step, T..2T-1
    the pre-norm GRU outputs. `weights` is the (name, tensor) list in
    _GRAD_LEAVES order. A measurement may take block 0's clock64 stamps
    (`prof`, int64 with FWD_PROF_SLOTS slots) or launch the empty forward
    (`floor`: the route's grid and combines, no arithmetic; counted as its
    own key)."""
    T = meta.steps
    n, f, od, k_vocab, e, g, tag = _check_inputs(
        "fused_psteps", weights, h0, mask, node_graph, vid, src, dst, plan,
        T, extra=(("labels", labels), ("gmask", gmask)))
    K._check_prof(prof, FWD_PROF_SLOTS)
    lib = _lib("fused_psteps_fwd", tag)
    device = h0.device
    sums = meta.msg_mode != NONE or meta.state_mode != NONE
    shape = device_fwd_shape(n, tag, k_vocab, T, sums, device)
    stream = _stream(device)
    kw = dict(dtype=torch.float32, device=device)
    loss = torch.empty(1, **kw)
    out = torch.empty(g, od, **kw)
    stats = torch.empty(2 * T, 2, f, **kw)
    htil = torch.empty(2 * T, n, f, **kw)
    scratch = torch.empty(lib.mpnn_fused_psteps_fwd_scratch_floats(
        n, e, g, T, shape.grid), **kw)
    counters = _fwd_counters(shape, tag, device, stream)
    tensors = _kernel_tensors(weights, tag) + [
        h0, labels, gmask, vid, src, plan.edge_order, plan.dst_ptr,
        plan.graph_node_ptr, loss, out, stats, htil, scratch]
    args = (*(t.data_ptr() for t in tensors), K._ptr(counters), K._ptr(prof),
            n, g, e, f, od, k_vocab, T, meta.msg_mode, meta.state_mode,
            int(shape.route == "grid"), shape.grid, shape.ncap, shape.ecap,
            int(amat_in_smem(tag, k_vocab, T)), int(floor), stream)
    return K.PreparedLaunch("fused_psteps_fwd_floor" if floor
                            else "fused_psteps_fwd",
                            lib.mpnn_fused_psteps_fwd,
                            lib.mpnn_cuda_error_string, args,
                            (loss, out, stats, htil),
                            tuple(tensors) + (counters, prof),
                            floor_counts if floor else launch_counts)


# ---------------------------------------------------------------------------
# the backward's routes (csrc/fused_psteps_bwd.cu)
# ---------------------------------------------------------------------------

BWD_THREADS = 256          # walk_bwd.cuh::kBT
EDGE_RATIO = 3             # edge slots a node slot of a block's tile
MAX_NCAP = 1024            # the most node slots a block's tile is given
PROF_SLOTS = 80            # walk_bwd.cuh::kProfSlots: block 0's stamps
# The route policy is the three reverse walks' one (fused_step.walk_shape):
# with a state norm on batch statistics (bn1d or the stateless norm: its
# sums cross blocks every step) a cluster up to CLUSTER_SLOTS slots;
# otherwise, and without one (the T message norms' sums cross blocks once,
# after the walk), a grid of a block per GRID_NODES slots.
MAX_CLUSTER, MAX_GRID = K.MAX_CLUSTER, K.MAX_GRID
CLUSTER_NODES, CLUSTER_SLOTS, GRID_NODES = (K.CLUSTER_NODES, K.CLUSTER_SLOTS,
                                            K.GRID_NODES)

# the empty forward's and walk's launches (a measurement's yardstick, not
# the path's)
floor_counts: Dict[str, int] = {"fused_psteps_fwd_floor": 0,
                                "fused_psteps_bwd_floor": 0}


def bwd_smem_floats(tag: str, k_vocab: int, steps: int, ncap: int,
                    ecap: int) -> int:
    """Floats of one backward block's shared memory (csrc/
    fused_psteps_bwd.cu::Smem after fused_psteps_common.cuh::PL): the
    staged weights and the 2T slots' norm constants, the round totals and
    block partials, the reduction scratch, the readout's staged rows (and
    in the wide bucket a round's gates), the block's node and edge tables
    (ncap nodes, ecap edges), two steps' staged stash rows and the node
    tile ((4 + T)·FP floats a node)."""
    b = dict(BUCKETS)[tag]
    fp, odw, T = b["f"], b["od"], steps
    al4 = lambda v: (v + 3) & ~3
    ro = 2 * fp * odw if odw <= 32 else 0          # kRoInSmem
    weights = (2 * fp * 3 * fp + 6 * fp + 2 * ro + 2 * odw
               + T * (fp * fp + 5 * fp) + 2 * T * 3 * fp)
    warps = BWD_THREADS // 32
    ng = BWD_THREADS // fp
    red = max(warps * fp * fp, BWD_THREADS * 16)
    rows = ng * 2 * (2 * fp + 4 + 2 * odw)
    wst = 0 if fp <= 16 else ng * 6 * fp
    n = al4(weights) + al4(3 * fp * T) + fp + 6 * fp * T + 4 + red + rows
    n += wst + al4(2 * ncap + 1 + 5 * ecap + (warps + 1) * k_vocab + 1)
    return n + 4 * ncap * fp + ncap * (4 + T) * fp


# a backward launch (route, blocks, the tile's node and edge slots, bytes)
PsBwdShape = K.BwdShape


def _tile_floats(tag: str, k_vocab: int, steps: int):
    return lambda c: bwd_smem_floats(tag, k_vocab, steps, c, EDGE_RATIO * c)


def bwd_capacity(tag: str, k_vocab: int, steps: int, smem_bytes: int) -> int:
    """The most node slots (at most MAX_NCAP, EDGE_RATIO edges each) whose
    tile fits `smem_bytes` of a block; 0 when none does."""
    return K.tile_capacity(_tile_floats(tag, k_vocab, steps), smem_bytes,
                           MAX_NCAP)


def launch_shape(n: int, tag: str, k_vocab: int, steps: int, *,
                 state_sums: bool, smem_bytes: int, max_grid: int
                 ) -> PsBwdShape:
    """The backward's route for a batch of `n` node slots (the walks'
    fused_step.walk_shape, with `state_sums` for a state norm on batch
    statistics): a block's share stays within 3/4 of its tile
    (bwd_capacity: fewer nodes in the wide bucket and at a large vocab or
    T), since whole graphs go to a block. A block whose graphs still
    outgrow its tile keeps them in global scratch, on the same route."""
    s = K.walk_shape(
        f"fused_psteps_bwd: one node at vocab {k_vocab}, T {steps}", n,
        _tile_floats(tag, k_vocab, steps), most_ncap=MAX_NCAP, share=0.75,
        step_sums=state_sums, smem_bytes=smem_bytes, max_grid=max_grid)
    return PsBwdShape(s.route, s.grid, s.ncap, EDGE_RATIO * s.ncap,
                      s.smem_bytes)


def device_bwd_shape(n: int, tag: str, k_vocab: int, steps: int,
                     state_sums: bool, device) -> PsBwdShape:
    """launch_shape on `device`'s shared memory and co-resident blocks."""
    def most(smem, _):
        cap = max(bwd_capacity(tag, k_vocab, steps, smem), 1)
        return _lib("fused_psteps_bwd", tag).mpnn_fused_psteps_bwd_max_grid(
            4 * bwd_smem_floats(tag, k_vocab, steps, cap, EDGE_RATIO * cap))
    return K.device_shape(
        ("fused_psteps_bwd", n, tag, k_vocab, steps, state_sums), device,
        most, lambda smem, m: launch_shape(n, tag, k_vocab, steps,
                                           state_sums=state_sums,
                                           smem_bytes=smem, max_grid=m))


def prepare_fused_psteps_bwd(weights, h0, labels, gmask, out, gout, gl,
                             htil, stats, node_graph, vid, src, dst,
                             plan: FusedEvalPlan, meta: PsMeta, prof=None,
                             floor: bool = False) -> K.PreparedLaunch:
    """One checked backward launch on the forward's residuals (the batch
    tensors as the forward checked them), on its route (device_bwd_shape):
    outputs dh0 (N, f) and the flat gradient of grad_layout. A measurement
    may take block 0's clock64 stamps (`prof`, int64 with PROF_SLOTS
    slots) or launch the empty walk (`floor`: the route's grid and
    combines, no arithmetic; counted as its own key)."""
    device = h0.device
    n, f = h0.shape
    w = dict(weights)
    k_vocab, od = w["amat"].shape[1], w["ro_ib"].shape[0]
    e, g, T = src.shape[0], plan.graph_node_ptr.shape[0] - 1, meta.steps
    for name, t, shape in [("out", out, (g, od)), ("gout", gout, (g, od)),
                           ("gl", gl, (1,)), ("htil", htil, (2 * T, n, f)),
                           ("stats", stats, (2 * T, 2, f))]:
        K._check(name, t, shape, device, torch.float32)
    K._check_prof(prof, PROF_SLOTS)
    tag = _bucket("fused_psteps", f, od, T)
    lib = _lib("fused_psteps_bwd", tag)
    layout = grad_layout(k_vocab, f, od, T)
    c_layout = (ctypes.c_int * 16)()
    lib.mpnn_fused_psteps_bwd_layout(k_vocab, f, od, T, c_layout)
    if [v[0] for v in layout.values()] != list(c_layout):
        raise RuntimeError("fused_psteps_bwd: the gradient layout of the "
                           "built library disagrees with grad_layout")
    shape = device_bwd_shape(n, tag, k_vocab, T, meta.state_mode != NONE,
                             device)
    kw = dict(dtype=torch.float32, device=device)
    dh0 = torch.empty(n, f, **kw)
    dw = torch.empty(layout["total"][0], **kw)
    scratch = torch.empty(lib.mpnn_fused_psteps_bwd_scratch_floats(
        n, e, k_vocab, f, od, T, shape.grid), **kw)
    stream = _stream(device)
    flags, counters = (K.sync_buffers(lib.mpnn_fused_psteps_bwd_sync_words,
                                      device, stream)
                       if shape.route == "grid" and shape.grid > 1
                       else (None, None))
    src_order, src_ptr = K.source_order(src, n)
    tensors = _kernel_tensors(weights, tag) + [
        h0, labels, gmask, out, gout, gl, htil, stats, vid, src, dst,
        src_order, src_ptr, plan.graph_node_ptr, node_graph, dh0, dw,
        scratch]
    args = (*(t.data_ptr() for t in tensors), K._ptr(flags),
            K._ptr(counters), K._ptr(prof), n, g, e, f, od, k_vocab, T,
            meta.msg_mode, meta.state_mode, int(shape.route == "grid"),
            shape.grid, shape.ncap, shape.ecap, int(floor), stream)
    return K.PreparedLaunch("fused_psteps_bwd_floor" if floor
                            else "fused_psteps_bwd",
                            lib.mpnn_fused_psteps_bwd,
                            lib.mpnn_cuda_error_string, args, (dh0, dw),
                            tuple(tensors) + (flags, counters, prof),
                            floor_counts if floor else launch_counts)


def flat_weights(amat, a0, mbias, gru, ma_bns, bns, ro, h0, *, steps: int,
                 msg_norm: str, state_norm: str):
    """The training kernels' (name, tensor) weight list in _GRAD_LEAVES
    order — the per-step norms stacked (T, f), identity stand-ins for a
    mode without them — and their PsMeta."""
    f = h0.shape[1]
    meta = PsMeta(steps, BATCH_BN if msg_norm == "bn1d" else NONE,
                  {"bn1d": BATCH_BN, "stateless": STATELESS,
                   "none": NONE}[state_norm])
    ma = ma_bns if msg_norm == "bn1d" else []
    sn = bns if state_norm == "bn1d" else []
    tensors = [amat, a0, mbias, gru["w_ih"], gru["w_hh"], gru["b_ih"],
               gru["b_hh"], _stack_norms(ma, "weight", f, steps, h0),
               _stack_norms(ma, "bias", f, steps, h0),
               _stack_norms(sn, "weight", f, steps, h0),
               _stack_norms(sn, "bias", f, steps, h0), ro["i"]["w"],
               ro["i"]["b"], ro["j"]["w"], ro["j"]["b"]]
    return list(zip(_GRAD_LEAVES, tensors)), meta


class _FusedPsteps(torch.autograd.Function):
    """The training forward kernel, with the backward kernel as its VJP —
    or, on the split route, the readout VJP, the reverse walk and the
    message VJP (split_backward). Inputs: meta, the 15 weight leaves
    (_GRAD_LEAVES order, per-step norms stacked (T, f)), h0, then the
    non-differentiable batch tensors and the plan. Outputs (loss (1,),
    out, stats); stats carry no gradient. On CPU tensors (the split route
    only) the forward is the plain version with its stash."""

    @staticmethod
    def forward(ctx, meta, *args):
        weights = list(zip(_GRAD_LEAVES, args[:15]))
        h0, mask, node_graph, labels, gmask, vid, src, dst = args[15:23]
        plan = FusedEvalPlan(*args[23:])
        loss, out, stats, htil = forward_residuals(
            weights, h0, mask, node_graph, labels, gmask, vid, src, dst,
            plan, meta)
        ctx.meta = meta
        ctx.save_for_backward(*args, out, stats, htil)
        ctx.mark_non_differentiable(stats)
        return loss, out, stats

    @staticmethod
    def backward(ctx, g_loss, g_out, _g_stats):
        saved = ctx.saved_tensors
        args, (out, stats, htil) = saved[:-3], saved[-3:]
        weights = list(zip(_GRAD_LEAVES, args[:15]))
        h0, mask, node_graph, labels, gmask, vid, src, dst = args[15:23]
        plan = FusedEvalPlan(*args[23:])
        gl = (torch.zeros(1, dtype=out.dtype, device=out.device)
              if g_loss is None else g_loss.reshape(1).contiguous())
        gout = (torch.zeros_like(out) if g_out is None
                else g_out.contiguous())
        if ctx.meta.split:
            dh0, grads = split_backward(
                weights, h0, mask, node_graph, labels, gmask, vid, src, dst,
                plan, out, gout, gl, htil, stats, ctx.meta)
        else:
            dh0, dw = K.launch_prepared(prepare_fused_psteps_bwd(
                weights, h0, labels, gmask, out, gout, gl, htil, stats,
                node_graph, vid, src, dst, plan, ctx.meta))
            f, od = h0.shape[1], out.shape[1]
            grads = split_grads(dw, args[0].shape[1], f, od, ctx.meta.steps)
        return (None, *(grads[name] for name in _GRAD_LEAVES), dh0,
                *([None] * (len(args) - 16)))


_MODE_NAMES = {"msg": {BATCH_BN: "bn1d", NONE: "none"},
               "state": {BATCH_BN: "bn1d", STATELESS: "stateless",
                         NONE: "none"}}


def forward_residuals(weights, h0, mask, node_graph, labels, gmask, vid,
                      src, dst, plan, meta: PsMeta):
    """The forward kernel's outputs (loss (1,), out, stats (2T, 2, f), htil
    (2T, N, f)): its launch for CUDA tensors, the plain version for CPU
    tensors."""
    if h0.device.type != "cuda":
        return _reference_residuals(weights, h0, mask, node_graph, labels,
                                    gmask, vid, src, dst, plan, meta)
    return K.launch_prepared(prepare_fused_psteps_fwd(
        weights, h0, mask, node_graph, labels, gmask, vid, src, dst, plan,
        meta))


def _reference_residuals(weights, h0, mask, node_graph, labels, gmask, vid,
                         src, dst, plan, meta: PsMeta):
    """The forward kernel's outputs from the plain version."""
    w = dict(weights)
    T = meta.steps
    norms = lambda a, b: [{"weight": w[a][t], "bias": w[b][t]}
                          for t in range(T)]
    stash = []
    loss, out, ma, st = fused_psteps_reference(
        w["amat"], w["a0"], w["mbias"], h0, mask, node_graph,
        {k: w[k] for k in ("w_ih", "w_hh", "b_ih", "b_hh")},
        norms("ma_w", "ma_b"), norms("bn_w", "bn_b"),
        {"i": {"w": w["ro_iw"], "b": w["ro_ib"]},
         "j": {"w": w["ro_jw"], "b": w["ro_jb"]}},
        labels, gmask, vid, src, dst, plan, steps=T,
        msg_norm=_MODE_NAMES["msg"][meta.msg_mode],
        state_norm=_MODE_NAMES["state"][meta.state_mode], stash=stash)
    stats = torch.stack([torch.stack(s) for s in (*ma, *st)])
    return loss.reshape(1), out, stats, torch.stack(stash)


def split_backward(weights, h0, mask, node_graph, labels, gmask, vid, src,
                   dst, plan: FusedEvalPlan, out, gout, gl, htil, stats,
                   meta: PsMeta):
    """The split route of the per-step family's backward: the readout +
    loss VJP (kernels/readout_bwd.py) on h_T rebuilt from the stash's last
    state slot, the reverse walk (kernels/psteps_walk.py) on the stash,
    and the message VJP of the T networks (kernels/msg_bwd.py). Each
    launches its kernel for CUDA tensors and runs its plain version for
    CPU tensors. Returns (dh0, {leaf: gradient})."""
    from mpnn_tpu_torch.kernels import msg_bwd as MB
    from mpnn_tpu_torch.kernels import psteps_walk as PW
    from mpnn_tpu_torch.kernels import readout_bwd as RB
    w = dict(weights)
    T = meta.steps
    msg_norm = _MODE_NAMES["msg"][meta.msg_mode]
    state_norm = _MODE_NAMES["state"][meta.state_mode]
    ro = {"i": {"w": w["ro_iw"], "b": w["ro_ib"]},
          "j": {"w": w["ro_jw"], "b": w["ro_jb"]}}
    gh, dh0_ro, dro = RB.ro_bwd(
        htil[2 * T - 1], stats[2 * T - 1], w["bn_w"][T - 1],
        w["bn_b"][T - 1], h0, mask, node_graph, ro, labels, gmask, out,
        gout, gl, state_norm=state_norm)
    dh0_walk, dmsgs, dwalk = PW.ps_walk_bwd(
        gh, h0, mask, htil, stats, plan.graph_node_ptr, weights, steps=T,
        msg_norm=msg_norm, state_norm=state_norm)
    dh0_msg, dmsg = MB.msg_bwd(w["amat"], w["a0"], h0, mask, node_graph,
                               vid, src, dst, dmsgs, plan)
    grads = {**dmsg, **dwalk, "ro_iw": dro["i"]["w"], "ro_ib": dro["i"]["b"],
             "ro_jw": dro["j"]["w"], "ro_jb": dro["j"]["b"]}
    return dh0_ro + dh0_walk + dh0_msg, grads


def fused_psteps(amat, a0, mbias, h0, mask, node_graph, gru, ma_bns, bns,
                 ro, labels, gmask, vid, src, dst, plan: FusedEvalPlan, *,
                 steps: int, msg_norm: str = "bn1d",
                 state_norm: str = "bn1d", bwd: str = "auto"):
    """Whole-step training forward of the per-step family: (loss, out
    (G, od), [(ma_mean_t, ma_var_t)] × T, [(mean_t, var_t)] × T),
    differentiable in the weights and h0 for the cotangents of both loss
    and out. Arguments as fused_psteps_reference (ma_bns / bns: T dicts,
    or empty for a mode without them). `bwd` picks the backward route:
    'whole' (one kernel), 'split' (the readout VJP, the reverse walk and
    the message VJP) or 'auto', the JAX package's rule (kernels/
    split_bwd.py). CPU tensors run the plain version under autograd on the
    whole route, and the plain versions of the three VJPs on the split
    route; CUDA tensors launch the forward kernel (and, in the backward
    pass, the route's kernels) or raise."""
    _check_modes("fused_psteps", msg_norm, state_norm)
    split = route("psteps", steps=steps, f=h0.shape[1], n=h0.shape[0],
                  msg_norm=msg_norm, state_norm=state_norm,
                  bwd=bwd) == "split"
    if h0.device.type == "cpu" and not split:
        return fused_psteps_reference(
            amat, a0, mbias, h0, mask, node_graph, gru, ma_bns, bns, ro,
            labels, gmask, vid, src, dst, plan, steps=steps,
            msg_norm=msg_norm, state_norm=state_norm)
    _bucket("fused_psteps", h0.shape[1], ro["i"]["b"].shape[0], steps)
    weights, meta = flat_weights(amat, a0, mbias, gru, ma_bns, bns, ro, h0,
                                 steps=steps, msg_norm=msg_norm,
                                 state_norm=state_norm)
    loss, out, stats = _FusedPsteps.apply(
        meta._replace(split=int(split)), *(t for _, t in weights), h0, mask,
        node_graph, labels, gmask, vid, src, dst, *plan)
    ma_stats: List[tuple] = [(stats[t, 0], stats[t, 1])
                             for t in range(steps)]
    bn_stats = [(stats[steps + t, 0], stats[steps + t, 1])
                for t in range(steps)]
    return loss[0], out, ma_stats, bn_stats
