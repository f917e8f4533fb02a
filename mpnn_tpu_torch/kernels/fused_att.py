"""The collapsed attention family's message + GRU op (the `adv` model):
counterpart of mpnn_tpu/kernels/fused_att.py::make_fused_att_op (Pallas
`_att_fwd_kernel` and `_att_bwd_kernel`).

    per edge e (dst v, src u, vid k):
        gate_e = softmax_feat(h0[v]·Wh + qv[k])
        msg_v += A'[k]·(gate_e ⊙ h0[u])
    'att' aggregation (with_corr), per node v of graph g:
        msg_v += A0·(g0_v ⊙ (S_g − Σ_{e→v} h0[src_e])),
        g0_v = softmax_feat(h0[v]·Wh + q0),  S_g = Σ_{w∈g} h0[w]
    h = GRU(msg ⊙ mask, h0)                      (ONE application)

A'[k] = fold(pen_k) + Bf carries the final bias (models/fused_train.py::
_build_att_form); the 'att' term is the reference's sum over every
non-edge pair of the graph, whose edge features are zero, so each takes
the zero-edge matrix A0 and gate g0 — all pairs minus the real edges.
Every message step of this family is the same GRU(msgs, h0), so one
application is exact (the plain model, models/sparse.py, runs the steps).

`fused_att` is a torch.autograd.Function whose forward and backward are
one CUDA launch each (csrc/fused_att_fwd.cu, csrc/fused_att_bwd.cu: the
att model's T-step backward body at T 1 on independent blocks that own
whole graphs, launch_shape's grid). The forward writes the masked
messages for the backward only when a gradient is wanted; serving skips
that write. CPU tensors run the plain version
fused_att_reference (under autograd); CUDA tensors launch the kernels or
raise — no fallback. The index plan is graphs/batching.py::
plan_fused_eval's; the backward's source order is built on the device
(kernels/fused_step.py::source_order).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional

import torch

from mpnn_tpu_torch.graphs.batching import FusedEvalPlan
from mpnn_tpu_torch.kernels import fused_step as K

# width buckets of the CUDA kernels, narrowest first (as fused_step.py's):
# f and the vocab K. Each is its own build of csrc/fused_att_{fwd,bwd}.cu
# (kernels/build.py::WIDE).
BUCKETS = (("", dict(f=16, K=64)), ("f32", dict(f=32, K=64)))
MAX_WIDTH = BUCKETS[-1][1]["f"]

launch_counts: Dict[str, int] = {"fused_att_fwd": 0, "fused_att_bwd": 0}
# the empty backward's launches (a measurement's yardstick, not the path's)
floor_counts: Dict[str, int] = {"fused_att_bwd_floor": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
    for k in floor_counts:
        floor_counts[k] = 0


# ---------------------------------------------------------------------------
# plain version (CPU path; the card's comparison baseline)
# ---------------------------------------------------------------------------

def att_messages(aprime, a0, qv, q0, wh, h0, mask, node_graph, vid, src,
                 dst, num_graphs: int, *, with_corr: bool):
    """The masked gated messages (N, f) of one message network, in plain
    PyTorch: aprime (K, f, f), a0 (f, f), qv (K, f), q0 (f), wh (f, f), h0
    PRE-MASKED (N, f), mask (N, 1)."""
    vid, src, dst = vid.long(), src.long(), dst.long()
    zh = h0 @ wh                                      # (N, f) per node
    hs = h0[src]
    gate = torch.softmax(zh[dst] + qv[vid], dim=-1)
    msg = torch.bmm(aprime[vid], (gate * hs).unsqueeze(-1)).squeeze(-1)
    agg = torch.zeros_like(h0).index_add(0, dst, msg)
    if with_corr:
        ng = node_graph.long()
        g0 = torch.softmax(zh + q0, dim=-1)
        s = h0.new_zeros((num_graphs + 1, h0.shape[1])).index_add(0, ng, h0)
        x = s[ng] - torch.zeros_like(h0).index_add(0, dst, hs)
        agg = agg + (g0 * x) @ a0.T
    return agg * mask


def fused_att_reference(aprime, a0, qv, q0, wh, h0, mask, node_graph, gru,
                        vid, src, dst, plan: FusedEvalPlan, *,
                        with_corr: bool = True):
    """Plain PyTorch version of the op, make_fused_att_op's arguments minus
    the TPU window plan plus the index plan (its graph count only is
    read): aprime (K, f, f), a0 (f, f), qv (K, f), q0 (f), wh (f, f), h0
    PRE-MASKED (N, f), mask (N, 1), GRU weights in the JAX layout.
    Returns h (N, f)."""
    msgs = att_messages(aprime, a0, qv, q0, wh, h0, mask, node_graph, vid,
                        src, dst, plan.graph_node_ptr.shape[0] - 1,
                        with_corr=with_corr)
    return K._gru(gru, msgs @ gru["w_ih"] + gru["b_ih"], h0 * mask, mask)


# ---------------------------------------------------------------------------
# the CUDA kernels' libraries
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fused_att_fwd": {
        "mpnn_fused_att_fwd": ([_P] * 17 + [_I] * 5 + [_P], _I),
        "mpnn_fused_att_fwd_smem_bytes": ([_I], _I),
    },
    "fused_att_bwd": {
        "mpnn_fused_att_bwd": ([_P] * 25 + [_I] * 10 + [_P], _I),
        "mpnn_fused_att_bwd_smem_bytes": ([_I] * 3, _I),
        "mpnn_fused_att_bwd_layout": ([_I, _I, _P], None),
        "mpnn_fused_att_bwd_scratch_floats": ([_I] * 5, ctypes.c_longlong),
        "mpnn_fused_att_bwd_counters": ([], _I),
        "mpnn_fused_att_bwd_max_grid": ([_I], _I),
    },
}


def _lib(name: str, tag: str = ""):
    return K._lib(name, _SIGNATURES, tag)


def _kernel_tensors(weights, tag: str):
    """The weight tensors in kernel argument order, A' as the bucket reads
    it (zero-padded to (K, 32, 32) in the wide bucket,
    csrc/fused_att_common.cuh::kAprimeInSmem)."""
    return [K.vocab_table(t, tag) if name == "aprime" else t
            for name, t in weights]


# the differentiable leaves, in the kernels' argument order and the
# backward's flat gradient layout (csrc/fused_att_bwd.cu::AttGradLayout)
_GRAD_LEAVES = ("aprime", "a0", "qv", "q0", "wh", "w_ih", "w_hh", "b_ih",
                "b_hh")


def _leaf_shapes(k_vocab: int, f: int):
    return [(k_vocab, f, f), (f, f), (k_vocab, f), (f,), (f, f),
            (f, 3 * f), (f, 3 * f), (3 * f,), (3 * f,)]


def grad_layout(k_vocab: int, f: int) -> Dict[str, tuple]:
    """{leaf: (offset, shape)} of the backward kernel's flat gradient."""
    out, off = {}, 0
    for name, shape in zip(_GRAD_LEAVES, _leaf_shapes(k_vocab, f)):
        out[name] = (off, shape)
        off += math.prod(shape)
    out["total"] = (off, ())
    return out


def split_grads(dw: torch.Tensor, k_vocab: int, f: int):
    """The flat gradient as {leaf: view of its shape}."""
    return {name: dw[off:off + math.prod(shape)].view(shape)
            for name, (off, shape) in grad_layout(k_vocab, f).items()
            if name != "total"}


def _check_inputs(who, weights, h0, mask, node_graph, vid, src, dst, plan):
    """Device, dtype, shape and contiguity of every kernel input and the
    batch layout (one sync); returns (n, f, k_vocab, e, num_graphs)."""
    device = h0.device
    if device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {device}")
    n, f = h0.shape
    w = dict(weights)
    k_vocab = w["aprime"].shape[0]
    e = src.shape[0]
    num_graphs = plan.graph_node_ptr.shape[0] - 1
    K.width_bucket(who, BUCKETS, f=f, K=k_vocab)
    for name, shape in zip(_GRAD_LEAVES, _leaf_shapes(k_vocab, f)):
        K._check(name, w[name], shape, device, torch.float32)
    K._check("h0", h0, (n, f), device, torch.float32)
    K._check("mask", mask, (n, 1), device, torch.float32)
    for name, t in [("vid", vid), ("src", src), ("dst", dst)]:
        K._check(name, t, (e,), device, torch.int32)
    K._check("node_graph", node_graph, (n,), device, torch.int32)
    K._check_plan(plan, device, n, e, num_graphs)
    K.check_batch_layout(h0, mask, node_graph, vid, src, dst, plan, k_vocab,
                         num_graphs, who=who)
    return n, f, k_vocab, e, num_graphs


def prepare_fused_att_fwd(weights, h0, mask, node_graph, vid, src, dst,
                          plan: FusedEvalPlan, *, with_corr: bool,
                          write_msgs: bool) -> K.PreparedLaunch:
    """One checked forward launch: outputs h (N, f) and, with
    `write_msgs`, the masked messages (N, f) the backward reads (else an
    empty tensor). `weights` is the (name, tensor) list in _GRAD_LEAVES
    order."""
    n, f, k_vocab, e, g = _check_inputs("fused_att", weights, h0, mask,
                                        node_graph, vid, src, dst, plan)
    tag = K.width_bucket("fused_att", BUCKETS, f=f, K=k_vocab)
    lib = _lib("fused_att_fwd", tag)
    kw = dict(dtype=torch.float32, device=h0.device)
    h = torch.empty(n, f, **kw)
    msgs = torch.empty(n, f, **kw) if write_msgs else torch.empty(0, **kw)
    tensors = _kernel_tensors(weights, tag) + [
        h0, vid, src, plan.edge_order, plan.dst_ptr, plan.graph_node_ptr,
        h, msgs]
    ptrs = [t.data_ptr() for t in tensors]
    if not write_msgs:
        ptrs[-1] = None
    args = (*ptrs, n, g, f, k_vocab, int(with_corr),
            torch.cuda.current_stream(h0.device).cuda_stream)
    return K.PreparedLaunch("fused_att_fwd", lib.mpnn_fused_att_fwd,
                            lib.mpnn_cuda_error_string, args, (h, msgs),
                            tuple(tensors), launch_counts)


# ---------------------------------------------------------------------------
# the backward's launch (csrc/fused_att_bwd.cu: independent blocks)
# ---------------------------------------------------------------------------

BWD_THREADS = 256          # walk_bwd.cuh::kBT
MAX_GRID = 512             # walk_bwd.cuh::kMaxGrid
PROF_SLOTS = 80            # walk_bwd.cuh::kProfSlots: block 0's stamps
EDGE_RATIO = K.EDGE_RATIO  # edge slots a node slot of a block's tile
MAX_NCAP = K.MAX_NCAP      # the most node slots a block's tile is given
# Node slots a block takes (launch_shape): a block per BWD_NODES slots or a
# block a graph, whichever is more, at most the card's co-resident blocks
# at the rule's tile (blocks own whole graphs and wait on no other block,
# as the folded serving kernel's do: kernels/fused_step.py::
# eval_launch_shape); a tile of BWD_SLACK times the share. From
# scripts/time_att.py --sweep on an H100 (PERF.md, row 15; trace): a
# block per 16 slots was first or within 1% of the best at adv b16 (23.3
# us against 25.5-38.9 at a block per 4-128), b128 (24.1 against
# 26.9-64.9) and b1024 (132 blocks, 41.6 against 45.6-87.4) and at the
# f32 bucket's b16 (80.5 against 86.6-288.6); b1 runs one block.
BWD_NODES = 16
BWD_SLACK = 2


def bwd_smem_floats(tag: str, k_vocab: int, ncap: int) -> int:
    """Floats of one backward block's shared memory at node capacity ncap
    and EDGE_RATIO edges a node (the T-step kernel's tile at T 1, one
    message network: kernels/fused_att_steps.py::bwd_smem_floats)."""
    from mpnn_tpu_torch.kernels import fused_att_steps as AS
    return AS.bwd_smem_floats(tag, 1, k_vocab, 1, ncap, EDGE_RATIO * ncap)


class AttBwdShape(NamedTuple):
    """A backward launch: `grid` independent blocks (the free route), the
    node and edge slots of a block's shared-memory tile and its dynamic
    shared memory (bytes)."""
    grid: int
    ncap: int
    ecap: int
    smem_bytes: int
    route: str = "free"

    def tag(self) -> str:
        return f"free x{self.grid} cap {self.ncap}"


def launch_shape(n: int, tag: str, k_vocab: int, *, smem_bytes: int,
                 max_grid: int, graphs: int = 0,
                 nodes: Optional[int] = None,
                 ncap: Optional[int] = None) -> AttBwdShape:
    """The backward's launch for a batch of `n` node slots in `graphs`
    graphs: a block per BWD_NODES slots or a block a graph, whichever is
    more (`nodes` forces a block per `nodes` slots), at most `max_grid`
    blocks (the co-resident ones at the rule's tile) and MAX_GRID; a
    block's tile BWD_SLACK times its share, within the most node slots
    (MAX_NCAP) whose tile fits `smem_bytes` (`ncap` forces a tile: 1
    spills every block of more than one node). A block whose graphs
    outgrow its tile keeps them in global scratch, on the same launch.
    NotImplementedError when not one node fits."""
    cap = K.tile_capacity(lambda c: bwd_smem_floats(tag, k_vocab, c),
                          smem_bytes, MAX_NCAP)
    if cap < 1:
        raise NotImplementedError(
            f"fused_att_bwd: one node at vocab {k_vocab} needs "
            f"{4 * bwd_smem_floats(tag, k_vocab, 1)} bytes of shared "
            f"memory; the card has {smem_bytes}")
    if nodes is None:
        grid = max(1, min(max_grid, MAX_GRID,
                          max(-(-n // BWD_NODES), graphs)))
    else:
        grid = max(1, min(MAX_GRID, -(-n // nodes)))
    c = min(cap, ncap or BWD_SLACK * -(-n // grid))
    return AttBwdShape(grid, c, EDGE_RATIO * c,
                       4 * bwd_smem_floats(tag, k_vocab, c))


def device_bwd_shape(n: int, tag: str, k_vocab: int, graphs: int,
                     device) -> AttBwdShape:
    """launch_shape on `device`'s shared memory and the kernel's
    co-resident blocks at the rule's tile."""
    def rule(smem, most):
        return launch_shape(n, tag, k_vocab, smem_bytes=smem, max_grid=most,
                            graphs=graphs)
    return K.device_shape(
        ("fused_att_bwd", n, tag, k_vocab, graphs), device,
        lambda smem, _: _lib("fused_att_bwd", tag)
        .mpnn_fused_att_bwd_max_grid(rule(smem, MAX_GRID).smem_bytes), rule)


# The backward's counters (its final sum's arrivals), one buffer per
# device and stream, zeroed once: every launch leaves them zero.
_COUNTERS: Dict[tuple, torch.Tensor] = {}


def _counters(lib, device, stream: int) -> torch.Tensor:
    key = (str(device), stream)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(lib.mpnn_fused_att_bwd_counters(),
                                     dtype=torch.int32, device=device)
    return _COUNTERS[key]


def prepare_fused_att_bwd(weights, h0, msgs, gh, vid, src, dst,
                          plan: FusedEvalPlan, *, with_corr: bool,
                          prof=None, floor: bool = False
                          ) -> K.PreparedLaunch:
    """One checked backward launch on the forward's residuals (the batch
    tensors as the forward checked them), on its launch (device_bwd_shape):
    outputs dh0 (N, f) and the flat gradient of grad_layout. A
    measurement may take block 0's clock64 stamps (`prof`, int64 with
    PROF_SLOTS slots) or launch the empty walk (`floor`: the same grid and
    final sum, no arithmetic; counted as its own key)."""
    device = h0.device
    n, f = h0.shape
    w = dict(weights)
    k_vocab = w["aprime"].shape[0]
    e, g = src.shape[0], plan.graph_node_ptr.shape[0] - 1
    for name, t in [("msgs", msgs), ("gh", gh)]:
        K._check(name, t, (n, f), device, torch.float32)
    K._check_prof(prof, PROF_SLOTS)
    tag = K.width_bucket("fused_att", BUCKETS, f=f, K=k_vocab)
    lib = _lib("fused_att_bwd", tag)
    layout = grad_layout(k_vocab, f)
    c_layout = (ctypes.c_int * 10)()
    lib.mpnn_fused_att_bwd_layout(k_vocab, f, c_layout)
    if [v[0] for v in layout.values()] != list(c_layout):
        raise RuntimeError("fused_att_bwd: the gradient layout of the "
                           "built library disagrees with grad_layout")
    shape = device_bwd_shape(n, tag, k_vocab, g, device)
    kw = dict(dtype=torch.float32, device=device)
    dh0 = torch.empty(n, f, **kw)
    dw = torch.empty(layout["total"][0], **kw)
    scratch = torch.empty(lib.mpnn_fused_att_bwd_scratch_floats(
        n, e, k_vocab, f, shape.grid), **kw)
    stream = torch.cuda.current_stream(device).cuda_stream
    counters = _counters(lib, device, stream) if shape.grid > 1 else None
    # each edge's position in the destination order, sorted by source
    src_pos, src_ptr = K.source_order(src[plan.edge_order.long()], n)
    tensors = [w[k] for k in _GRAD_LEAVES] + [
        h0, msgs, gh, vid, src, dst, plan.edge_order, plan.dst_ptr, src_pos,
        src_ptr, plan.graph_node_ptr, dh0, dw, scratch]
    args = (*(t.data_ptr() for t in tensors), K._ptr(counters),
            K._ptr(prof), n, g, e, f, k_vocab, int(with_corr), shape.grid,
            shape.ncap, shape.ecap, int(floor), stream)
    return K.PreparedLaunch("fused_att_bwd_floor" if floor
                            else "fused_att_bwd", lib.mpnn_fused_att_bwd,
                            lib.mpnn_cuda_error_string, args, (dh0, dw),
                            tuple(tensors) + (counters, prof),
                            floor_counts if floor else launch_counts)


class _FusedAtt(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its VJP. Inputs:
    with_corr, write_msgs (K.records_grad of the leaves), the 9 weight
    leaves (_GRAD_LEAVES order), h0, then the non-differentiable batch
    tensors and the plan. Output h (N, f)."""

    @staticmethod
    def forward(ctx, with_corr, write_msgs, *args):
        weights = list(zip(_GRAD_LEAVES, args[:9]))
        h0, mask, node_graph, vid, src, dst = args[9:15]
        plan = FusedEvalPlan(*args[15:])
        h, msgs = K.launch_prepared(prepare_fused_att_fwd(
            weights, h0, mask, node_graph, vid, src, dst, plan,
            with_corr=with_corr, write_msgs=write_msgs))
        ctx.with_corr = with_corr
        ctx.save_for_backward(*args, msgs)
        return h

    @staticmethod
    def backward(ctx, gh):
        saved = ctx.saved_tensors
        args, msgs = saved[:-1], saved[-1]
        weights = list(zip(_GRAD_LEAVES, args[:9]))
        h0, _mask, _ng, vid, src, dst = args[9:15]
        plan = FusedEvalPlan(*args[15:])
        dh0, dw = K.launch_prepared(prepare_fused_att_bwd(
            weights, h0, msgs, gh.contiguous(), vid, src, dst, plan,
            with_corr=ctx.with_corr))
        grads = split_grads(dw, args[0].shape[0], h0.shape[1])
        return (None, None, *(grads[name] for name in _GRAD_LEAVES), dh0,
                *([None] * (len(args) - 10)))


def fused_att(aprime, a0, qv, q0, wh, h0, mask, node_graph, gru, vid, src,
              dst, plan: FusedEvalPlan, *, with_corr: bool = True):
    """The message + GRU op: h (N, f), differentiable in aprime, a0, qv,
    q0, wh, the GRU weights and h0. Arguments as fused_att_reference.
    CPU tensors run the plain version under autograd; CUDA tensors launch
    the forward kernel (and, in the backward pass, the backward kernel)
    or raise."""
    if h0.device.type == "cpu":
        return fused_att_reference(aprime, a0, qv, q0, wh, h0, mask,
                                   node_graph, gru, vid, src, dst, plan,
                                   with_corr=with_corr)
    leaves = (aprime, a0, qv, q0, wh, gru["w_ih"], gru["w_hh"],
              gru["b_ih"], gru["b_hh"], h0)
    return _FusedAtt.apply(bool(with_corr), K.records_grad(*leaves),
                           *leaves, mask, node_graph, vid, src, dst, *plan)
