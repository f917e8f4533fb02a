"""The T-step attention family's message + GRU + norm op (the `att` model,
models/att_model.py's composition): counterpart of
mpnn_tpu/kernels/fused_att.py::make_fused_att_steps_op (Pallas
`_att_steps_fwd_kernel` with its edge body `_att_steps_edge_fwd`, and
`_att_steps_bwd_kernel`).

With Tm message networks (Tm = T per-step, or 1 when the steps share one),
each giving message tables over the INITIAL state h0 (fused_att.py::
att_messages: the gate softmax_feat(h0[dst]·Wh_t + qv_t[k]), A'_t[k]·(gate
⊙ h0[src]) summed per destination, and with the 'att' aggregation the
rank-1 non-edge correction A0_t·(g0 ⊙ (S_g − Σ_e h0[src]))):

    h = h0
    for t < T:  h = GRU(m_{min(t, Tm−1)}, h)            (the EVOLVING state)
                h = mask_batch_norm(h)    (the stateless norm, or none)

`fused_att_steps` is a torch.autograd.Function whose forward and backward
are one CUDA launch each (csrc/fused_att_steps_fwd.cu, a cooperative
launch; csrc/fused_att_steps_bwd.cu, on the route of launch_shape: one
thread-block cluster or a grid of co-resident blocks, no grid barrier).
The stateless norm has no parameters and no running state, so serving
and training share the forward; the training forward also writes the
residuals the backward reads (the Tm message slots, the T pre-norm
states, each step's mean and var), which serving skips. CPU tensors run the plain version fused_att_steps_reference (under
autograd); CUDA tensors launch the kernels or raise — no fallback. The
index plan is graphs/batching.py::plan_fused_eval's; the backward's source
order (each edge's position in the destination order, sorted by source) is
built on the device (kernels/fused_step.py::source_order).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple

import torch

from mpnn_tpu_torch.graphs.batching import FusedEvalPlan
from mpnn_tpu_torch.kernels import fused_step as K
from mpnn_tpu_torch.kernels.fused_att import att_messages
from mpnn_tpu_torch.ops.norm import mask_batch_norm

# width buckets of the CUDA kernels, narrowest first (as fused_step.py's):
# f, the vocab K and the steps. Each is its own build of
# csrc/fused_att_steps_{fwd,bwd}.cu (kernels/build.py::WIDE).
BUCKETS = (("", dict(f=16, K=64, steps=8)),
           ("f32", dict(f=32, K=64, steps=8)))
MAX_WIDTH = BUCKETS[-1][1]["f"]
MAX_STEPS = BUCKETS[-1][1]["steps"]
STATE_NORMS = ("stateless", "none")

launch_counts: Dict[str, int] = {"fused_att_steps_fwd": 0,
                                 "fused_att_steps_bwd": 0}
# the empty backward's launches (a measurement's yardstick, not the path's)
floor_counts: Dict[str, int] = {"fused_att_steps_bwd_floor": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
    for k in floor_counts:
        floor_counts[k] = 0


def _check_shape(who: str, tm: int, steps: int, state_norm: str) -> None:
    if state_norm not in STATE_NORMS:
        raise NotImplementedError(
            f"{who}: state_norm={state_norm!r}; the op takes {STATE_NORMS}")
    if tm not in (steps, 1):
        raise ValueError(f"{who}: {tm} message tables for {steps} steps; "
                         "expected one per step, or one shared")


# ---------------------------------------------------------------------------
# plain version (CPU path; the card's comparison baseline)
# ---------------------------------------------------------------------------

def fused_att_steps_reference(aprime, a0, qv, q0, wh, h0, mask, node_graph,
                              gru, vid, src, dst, plan: FusedEvalPlan, *,
                              steps: int, with_corr: bool = False,
                              state_norm: str = "stateless"):
    """Plain PyTorch version of the op, make_fused_att_steps_op's
    arguments minus the TPU window plan plus the index plan (its graph
    count only is read): aprime (Tm, K, f, f), a0 (Tm, f, f), qv (Tm, K, f),
    q0 (Tm, f), wh (Tm, f, f), h0 PRE-MASKED (N, f), mask (N, 1), GRU
    weights in the JAX layout. Returns h (N, f)."""
    tm = aprime.shape[0]
    _check_shape("fused_att_steps", tm, steps, state_norm)
    num_graphs = plan.graph_node_ptr.shape[0] - 1
    msgs = [att_messages(aprime[t], a0[t], qv[t], q0[t], wh[t], h0, mask,
                         node_graph, vid, src, dst, num_graphs,
                         with_corr=with_corr) for t in range(tm)]
    h = h0 * mask
    for t in range(steps):
        m = msgs[min(t, tm - 1)]
        h = K._gru(gru, m @ gru["w_ih"] + gru["b_ih"], h, mask)
        if state_norm == "stateless":
            h = mask_batch_norm(h, mask)
    return h


# ---------------------------------------------------------------------------
# the CUDA kernels' libraries
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fused_att_steps_fwd": {
        "mpnn_fused_att_steps_fwd": ([_P] * 20 + [_I] * 10 + [_P], _I),
        "mpnn_fused_att_steps_fwd_smem_bytes": ([_I] * 3, _I),
        "mpnn_fused_att_steps_fwd_scratch_floats": ([_I], ctypes.c_longlong),
        "mpnn_fused_att_steps_fwd_grid": ([_I] * 6, _I),
    },
    "fused_att_steps_bwd": {
        "mpnn_fused_att_steps_bwd": ([_P] * 28 + [_I] * 14 + [_P], _I),
        "mpnn_fused_att_steps_bwd_smem_bytes": ([_I] * 5, _I),
        "mpnn_fused_att_steps_bwd_layout": ([_I, _I, _I, _P], None),
        "mpnn_fused_att_steps_bwd_scratch_floats": ([_I] * 7,
                                                    ctypes.c_longlong),
        "mpnn_fused_att_steps_bwd_sync_words": ([_P], _I),
        "mpnn_fused_att_steps_bwd_max_grid": ([_I], _I),
    },
}


def _lib(name: str, tag: str = ""):
    return K._lib(name, _SIGNATURES, tag)


# the differentiable leaves, in the kernels' argument order and the
# backward's flat gradient layout (csrc/fused_att_steps_bwd.cu::
# AttsGradLayout)
_GRAD_LEAVES = ("aprime", "a0", "qv", "q0", "wh", "w_ih", "w_hh", "b_ih",
                "b_hh")


def _leaf_shapes(tm: int, k_vocab: int, f: int):
    return [(tm, k_vocab, f, f), (tm, f, f), (tm, k_vocab, f), (tm, f),
            (tm, f, f), (f, 3 * f), (f, 3 * f), (3 * f,), (3 * f,)]


def grad_layout(tm: int, k_vocab: int, f: int) -> Dict[str, tuple]:
    """{leaf: (offset, shape)} of the backward kernel's flat gradient."""
    out, off = {}, 0
    for name, shape in zip(_GRAD_LEAVES, _leaf_shapes(tm, k_vocab, f)):
        out[name] = (off, shape)
        off += math.prod(shape)
    out["total"] = (off, ())
    return out


def split_grads(dw: torch.Tensor, tm: int, k_vocab: int, f: int):
    """The flat gradient as {leaf: view of its shape}."""
    return {name: dw[off:off + math.prod(shape)].view(shape)
            for name, (off, shape) in grad_layout(tm, k_vocab, f).items()
            if name != "total"}


def _check_smem(need: int, device, **widths) -> None:
    """NotImplementedError naming the widths when a block of the kernel
    needs more shared memory than the card gives one: its staged gate
    tables grow with K·Tm, past the limit in the wide bucket at K 64 and
    the most steps."""
    most = torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin
    if need > most:
        raise NotImplementedError(
            "fused_att_steps: " + ", ".join(f"{k}={v}" for k, v in
                                            widths.items())
            + f"; a block would need {need} B of shared memory, the card "
            f"gives {most}")


class AttsMeta(NamedTuple):
    steps: int
    with_corr: bool
    stateless: bool


def _check_inputs(who, weights, h0, mask, node_graph, vid, src, dst, plan,
                  meta: AttsMeta):
    """Device, dtype, shape and contiguity of every kernel input and the
    batch layout (one sync); returns (n, f, tm, k_vocab, e, num_graphs)."""
    device = h0.device
    if device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {device}")
    n, f = h0.shape
    w = dict(weights)
    tm, k_vocab = w["aprime"].shape[:2]
    e = src.shape[0]
    num_graphs = plan.graph_node_ptr.shape[0] - 1
    K.width_bucket(who, BUCKETS, f=f, K=k_vocab, steps=meta.steps)
    for name, shape in zip(_GRAD_LEAVES, _leaf_shapes(tm, k_vocab, f)):
        K._check(name, w[name], shape, device, torch.float32)
    K._check("h0", h0, (n, f), device, torch.float32)
    K._check("mask", mask, (n, 1), device, torch.float32)
    for name, t in [("vid", vid), ("src", src), ("dst", dst)]:
        K._check(name, t, (e,), device, torch.int32)
    K._check("node_graph", node_graph, (n,), device, torch.int32)
    K._check_plan(plan, device, n, e, num_graphs)
    K.check_batch_layout(h0, mask, node_graph, vid, src, dst, plan, k_vocab,
                         num_graphs, who=who)
    return n, f, tm, k_vocab, e, num_graphs


def prepare_fused_att_steps_fwd(weights, h0, mask, node_graph, vid, src, dst,
                                plan: FusedEvalPlan, meta: AttsMeta, *,
                                train: bool) -> K.PreparedLaunch:
    """One checked forward launch: outputs h (N, f), the masked message
    slots (Tm, N, f), the pre-norm states — (T, N, f) with `train`, else
    one slot the kernel updates in place — and, with `train`, each step's
    (mean, var) (T, 2, f) (else an empty tensor). `weights` is the (name,
    tensor) list in _GRAD_LEAVES order."""
    n, f, tm, k_vocab, e, g = _check_inputs(
        "fused_att_steps", weights, h0, mask, node_graph, vid, src, dst,
        plan, meta)
    lib = _lib("fused_att_steps_fwd", K.width_bucket(
        "", BUCKETS, f=f, K=k_vocab, steps=meta.steps))
    T = meta.steps
    _check_smem(lib.mpnn_fused_att_steps_fwd_smem_bytes(tm, k_vocab, T),
                h0.device, f=f, K=k_vocab, Tm=tm, steps=T)
    grid = K._grid(lib, "mpnn_fused_att_steps_fwd_grid", f, tm, k_vocab, T,
                   n, g)
    kw = dict(dtype=torch.float32, device=h0.device)
    h = torch.empty(n, f, **kw)
    msgs = torch.empty(tm, n, f, **kw)
    htil = torch.empty(T if train else 1, n, f, **kw)
    stats = torch.empty((T, 2, f) if train else (0,), **kw)
    scratch = torch.empty(lib.mpnn_fused_att_steps_fwd_scratch_floats(n),
                          **kw)
    tensors = [t for _, t in weights] + [
        h0, vid, src, plan.edge_order, plan.dst_ptr, plan.graph_node_ptr,
        h, msgs, htil, stats, scratch]
    ptrs = [t.data_ptr() for t in tensors]
    if not train:
        ptrs[-2] = None
    args = (*ptrs, n, g, f, k_vocab, T, tm, int(meta.with_corr),
            int(meta.stateless), int(train), grid,
            torch.cuda.current_stream(h0.device).cuda_stream)
    return K.PreparedLaunch("fused_att_steps_fwd",
                            lib.mpnn_fused_att_steps_fwd,
                            lib.mpnn_cuda_error_string, args,
                            (h, msgs, htil, stats), tuple(tensors),
                            launch_counts)


# ---------------------------------------------------------------------------
# the backward's routes (csrc/fused_att_steps_bwd.cu)
# ---------------------------------------------------------------------------

BWD_THREADS = 256          # kBT
PROF_SLOTS = 80            # kProfSlots: block 0's clock64 stamps
APRIME_SMEM_FLOATS = 16384  # A'_t staged in shared memory up to this
# The reverse walks' policy (kernels/fused_step.py::walk_shape: with the
# stateless norm one cluster of the fewest of 1, 2, 4 or 8 blocks of at
# most CLUSTER_NODES slots each, up to CLUSTER_SLOTS node slots; else a
# grid of a block per GRID_NODES slots up to the co-resident blocks) on
# this kernel's tile, with its own cluster constants. From
# scripts/time_att_steps.py --sweep on an H100 (PERF.md, row 16; events, the
# att model's widths): one block was first at b1 (13 slots; 47.0 us
# against 48.5-60.3 on the other routes), clusters of 4-8 at b4 (64 slots;
# 53.5 / 51.3 against 59.5 for 2 and 60.4 for the best grid), and the grid
# from b16 (256 slots: a block per 8-16 slots 71.7-73.0 against 80.1 for a
# cluster of 8) to b1024 (132 blocks first).
CLUSTER_SLOTS = 128
CLUSTER_NODES = 16
EDGE_RATIO = K.EDGE_RATIO
MAX_NCAP = K.MAX_NCAP
GRID_NODES = K.GRID_NODES


def bwd_smem_floats(tag: str, tm: int, k_vocab: int, steps: int, ncap: int,
                    ecap: int) -> int:
    """Floats of one backward block's shared memory (csrc/
    fused_att_steps_bwd.cu::Smem after fused_att_steps_common.cuh::SL):
    the GRU and the Tm step blocks [A0_t | Wh_t | q0_t | qv_t], the T
    slots' norm constants, the round totals and partials, the reduction
    scratch, (at FP 32) a round's staged gates, Wh_tᵀ and a zero bias,
    A'_t when it fits, the block's node and edge tables, the node tile
    ((5 + Tm)·FP a node) and the edge rows (3·FP an edge)."""
    fp = dict(BUCKETS)[tag]["f"]
    al4 = lambda v: (v + 3) & ~3
    warps = BWD_THREADS // 32
    weights = (6 * fp * fp + 6 * fp + tm * (2 * fp * fp + fp + k_vocab * fp)
               + steps * 3 * fp)
    red = max(warps * fp * fp, BWD_THREADS * 16)
    wst = 0 if fp <= 16 else (BWD_THREADS // fp) * 6 * fp
    ap = k_vocab * fp * fp if k_vocab * fp * fp <= APRIME_SMEM_FLOATS else 0
    n = (al4(weights) + al4(3 * fp) + 3 * fp * steps + 4 + red + wst
         + fp * fp + fp + ap)
    n += al4(2 * (ncap + 1) + 7 * ecap + (warps + 1) * k_vocab + 1)
    return n + ncap * (5 + tm) * fp + ecap * 3 * fp


def _tile_floats(tag, tm, k_vocab, steps):
    return lambda c: bwd_smem_floats(tag, tm, k_vocab, steps, c,
                                     EDGE_RATIO * c)


def launch_shape(n: int, tag: str, tm: int, k_vocab: int, steps: int, *,
                 state_sums: bool, smem_bytes: int,
                 max_grid: int) -> K.BwdShape:
    """The backward's route for a batch of `n` node slots: the reverse
    walks' policy (fused_step.walk_shape, with `state_sums` for the
    stateless norm, whose batch sums cross blocks every step) on this
    kernel's tile with this module's CLUSTER_SLOTS and CLUSTER_NODES; a
    block's share stays within 3/4 of the tile; the grid route within
    `max_grid`, the card's co-resident blocks. The grid route's blocks
    wait on each other's flags: its launch refuses a grid past the blocks
    that fit the card together at its shared memory, and it needs the card
    to itself (a kernel on another stream holding SMs could keep one of
    its blocks from starting). NotImplementedError when not one node
    fits."""
    floats = _tile_floats(tag, tm, k_vocab, steps)
    s = K.walk_shape(
        f"fused_att_steps_bwd: one node at vocab {k_vocab}, Tm {tm}, T "
        f"{steps}", n, floats, most_ncap=MAX_NCAP, share=0.75,
        step_sums=state_sums, smem_bytes=smem_bytes, max_grid=max_grid,
        cluster_slots=CLUSTER_SLOTS, cluster_nodes=CLUSTER_NODES)
    return K.BwdShape(s.route, s.grid, s.ncap, EDGE_RATIO * s.ncap,
                      s.smem_bytes)


def device_bwd_shape(n: int, tag: str, tm: int, k_vocab: int, steps: int,
                     state_sums: bool, device) -> K.BwdShape:
    """launch_shape on `device`'s shared memory and co-resident blocks."""
    def most(smem, _):
        cap = max(K.tile_capacity(_tile_floats(tag, tm, k_vocab, steps),
                                  smem, MAX_NCAP), 1)
        return _lib("fused_att_steps_bwd", tag) \
            .mpnn_fused_att_steps_bwd_max_grid(
                4 * bwd_smem_floats(tag, tm, k_vocab, steps, cap,
                                    EDGE_RATIO * cap))
    return K.device_shape(
        ("fused_att_steps_bwd", n, tag, tm, k_vocab, steps, state_sums),
        device, most, lambda smem, m: launch_shape(
            n, tag, tm, k_vocab, steps, state_sums=state_sums,
            smem_bytes=smem, max_grid=m))


def prepare_fused_att_steps_bwd(weights, h0, msgs, htil, stats, gh, vid, src,
                                dst, plan: FusedEvalPlan, meta: AttsMeta, *,
                                prof=None, floor: bool = False
                                ) -> K.PreparedLaunch:
    """One checked backward launch on the training forward's residuals
    (the batch tensors as the forward checked them), on its route
    (device_bwd_shape): outputs dh0 (N, f) and
    the flat gradient of grad_layout. A measurement may take block 0's
    clock64 stamps (`prof`, int64 with PROF_SLOTS slots) or launch the
    empty walk (`floor`: the route's grid and combines, no arithmetic;
    counted as its own key)."""
    device = h0.device
    n, f = h0.shape
    w = dict(weights)
    tm, k_vocab = w["aprime"].shape[:2]
    e, g, T = src.shape[0], plan.graph_node_ptr.shape[0] - 1, meta.steps
    for name, t, shape in [("msgs", msgs, (tm, n, f)),
                           ("htil", htil, (T, n, f)),
                           ("stats", stats, (T, 2, f)), ("gh", gh, (n, f))]:
        K._check(name, t, shape, device, torch.float32)
    K._check_prof(prof, PROF_SLOTS)
    tag = K.width_bucket("", BUCKETS, f=f, K=k_vocab, steps=T)
    lib = _lib("fused_att_steps_bwd", tag)
    layout = grad_layout(tm, k_vocab, f)
    c_layout = (ctypes.c_int * 10)()
    lib.mpnn_fused_att_steps_bwd_layout(tm, k_vocab, f, c_layout)
    if [v[0] for v in layout.values()] != list(c_layout):
        raise RuntimeError("fused_att_steps_bwd: the gradient layout of the "
                           "built library disagrees with grad_layout")
    shape = device_bwd_shape(n, tag, tm, k_vocab, T, meta.stateless, device)
    kw = dict(dtype=torch.float32, device=device)
    dh0 = torch.empty(n, f, **kw)
    dw = torch.empty(layout["total"][0], **kw)
    scratch = torch.empty(lib.mpnn_fused_att_steps_bwd_scratch_floats(
        n, e, k_vocab, f, T, tm, shape.grid), **kw)
    stream = torch.cuda.current_stream(device).cuda_stream
    flags, counters = (K.sync_buffers(
        lib.mpnn_fused_att_steps_bwd_sync_words, device, stream)
        if shape.route == "grid" and shape.grid > 1 else (None, None))
    # each edge's position in the destination order, sorted by source
    src_pos, src_ptr = K.source_order(src[plan.edge_order.long()], n)
    tensors = [w[k] for k in _GRAD_LEAVES] + [
        h0, msgs, htil, stats, gh, vid, src, dst, plan.edge_order,
        plan.dst_ptr, src_pos, src_ptr, plan.graph_node_ptr, dh0, dw,
        scratch]
    args = (*(t.data_ptr() for t in tensors), K._ptr(flags),
            K._ptr(counters), K._ptr(prof), n, g, e, f, k_vocab, T, tm,
            int(meta.with_corr), int(meta.stateless),
            int(shape.route == "grid"), shape.grid, shape.ncap, shape.ecap,
            int(floor), stream)
    return K.PreparedLaunch("fused_att_steps_bwd_floor" if floor
                            else "fused_att_steps_bwd",
                            lib.mpnn_fused_att_steps_bwd,
                            lib.mpnn_cuda_error_string, args, (dh0, dw),
                            tuple(tensors) + (flags, counters, prof),
                            floor_counts if floor else launch_counts)


class _FusedAttSteps(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its VJP. Inputs:
    meta, train (K.records_grad of the leaves: write the residuals), the 9
    weight leaves (_GRAD_LEAVES order), h0, then the non-differentiable
    batch tensors and the plan. Output h (N, f)."""

    @staticmethod
    def forward(ctx, meta, train, *args):
        weights = list(zip(_GRAD_LEAVES, args[:9]))
        h0, mask, node_graph, vid, src, dst = args[9:15]
        plan = FusedEvalPlan(*args[15:])
        h, msgs, htil, stats = K.launch_prepared(prepare_fused_att_steps_fwd(
            weights, h0, mask, node_graph, vid, src, dst, plan, meta,
            train=train))
        ctx.meta = meta
        if train:
            ctx.save_for_backward(*args, msgs, htil, stats)
        return h

    @staticmethod
    def backward(ctx, gh):
        saved = ctx.saved_tensors
        args, (msgs, htil, stats) = saved[:-3], saved[-3:]
        weights = list(zip(_GRAD_LEAVES, args[:9]))
        h0, _mask, _ng, vid, src, dst = args[9:15]
        plan = FusedEvalPlan(*args[15:])
        dh0, dw = K.launch_prepared(prepare_fused_att_steps_bwd(
            weights, h0, msgs, htil, stats, gh.contiguous(), vid, src, dst,
            plan, ctx.meta))
        tm, k_vocab = args[0].shape[:2]
        grads = split_grads(dw, tm, k_vocab, h0.shape[1])
        return (None, None, *(grads[name] for name in _GRAD_LEAVES), dh0,
                *([None] * (len(args) - 10)))


def fused_att_steps(aprime, a0, qv, q0, wh, h0, mask, node_graph, gru, vid,
                    src, dst, plan: FusedEvalPlan, *, steps: int,
                    with_corr: bool = False, state_norm: str = "stateless"):
    """The T-step message + GRU + norm op: h (N, f), differentiable in
    aprime, a0, qv, q0, wh, the GRU weights and h0. Arguments as
    fused_att_steps_reference. CPU tensors run the plain version under
    autograd; CUDA tensors launch the forward kernel (and, in the backward
    pass, the backward kernel on launch_shape's route) or raise."""
    if h0.device.type == "cpu":
        return fused_att_steps_reference(
            aprime, a0, qv, q0, wh, h0, mask, node_graph, gru, vid, src, dst,
            plan, steps=steps, with_corr=with_corr, state_norm=state_norm)
    _check_shape("fused_att_steps", aprime.shape[0], steps, state_norm)
    meta = AttsMeta(steps, bool(with_corr), state_norm == "stateless")
    leaves = (aprime, a0, qv, q0, wh, gru["w_ih"], gru["w_hh"],
              gru["b_ih"], gru["b_hh"], h0)
    return _FusedAttSteps.apply(meta, K.records_grad(*leaves), *leaves, mask,
                                node_graph, vid, src, dst, *plan)
