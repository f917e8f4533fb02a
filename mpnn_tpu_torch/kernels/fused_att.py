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
one CUDA launch each (csrc/fused_att_fwd.cu, csrc/fused_att_bwd.cu). The
forward writes the masked messages for the backward only when a gradient
is wanted; serving skips that write. CPU tensors run the plain version
fused_att_reference (under autograd); CUDA tensors launch the kernels or
raise — no fallback. The index plan is graphs/batching.py::
plan_fused_eval's; the backward's source order is built on the device
(kernels/fused_step.py::source_order).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from mpnn_tpu_torch.graphs.batching import FusedEvalPlan
from mpnn_tpu_torch.kernels import fused_step as K

# the widest f and the largest vocab the CUDA kernels take
MAX_WIDTH = 16
MAX_VOCAB = 64

launch_counts: Dict[str, int] = {"fused_att_fwd": 0, "fused_att_bwd": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# plain version (CPU path; the card's comparison baseline)
# ---------------------------------------------------------------------------

def fused_att_reference(aprime, a0, qv, q0, wh, h0, mask, node_graph, gru,
                        vid, src, dst, plan: FusedEvalPlan, *,
                        with_corr: bool = True):
    """Plain PyTorch version of the op, make_fused_att_op's arguments minus
    the TPU window plan plus the index plan (its graph count only is
    read): aprime (K, f, f), a0 (f, f), qv (K, f), q0 (f), wh (f, f), h0
    PRE-MASKED (N, f), mask (N, 1), GRU weights in the JAX layout.
    Returns h (N, f)."""
    num_graphs = plan.graph_node_ptr.shape[0] - 1
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
    msgs = agg * mask
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
        "mpnn_fused_att_bwd": ([_P] * 23 + [_I] * 7 + [_P], _I),
        "mpnn_fused_att_bwd_smem_bytes": ([_I], _I),
        "mpnn_fused_att_bwd_layout": ([_I, _I, _P], None),
        "mpnn_fused_att_bwd_scratch_floats": ([_I] * 5, ctypes.c_longlong),
        "mpnn_fused_att_bwd_grid": ([_I] * 4, _I),
    },
}


def _lib(name: str):
    return K._lib(name, _SIGNATURES)


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
    if f > MAX_WIDTH or k_vocab > MAX_VOCAB:
        raise NotImplementedError(
            f"{who}: f={f}, K={k_vocab}; the kernels take f up to "
            f"{MAX_WIDTH} and a vocab of up to {MAX_VOCAB}")
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
    lib = _lib("fused_att_fwd")
    kw = dict(dtype=torch.float32, device=h0.device)
    h = torch.empty(n, f, **kw)
    msgs = torch.empty(n, f, **kw) if write_msgs else torch.empty(0, **kw)
    tensors = [t for _, t in weights] + [
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


def prepare_fused_att_bwd(weights, h0, msgs, gh, vid, src, dst,
                          plan: FusedEvalPlan, *, with_corr: bool
                          ) -> K.PreparedLaunch:
    """One checked backward launch on the forward's residuals (the batch
    tensors as the forward checked them): outputs dh0 (N, f) and the flat
    gradient of grad_layout."""
    device = h0.device
    n, f = h0.shape
    w = dict(weights)
    k_vocab = w["aprime"].shape[0]
    e, g = src.shape[0], plan.graph_node_ptr.shape[0] - 1
    for name, t in [("msgs", msgs), ("gh", gh)]:
        K._check(name, t, (n, f), device, torch.float32)
    lib = _lib("fused_att_bwd")
    layout = grad_layout(k_vocab, f)
    c_layout = (ctypes.c_int * 10)()
    lib.mpnn_fused_att_bwd_layout(k_vocab, f, c_layout)
    if [v[0] for v in layout.values()] != list(c_layout):
        raise RuntimeError("fused_att_bwd: the gradient layout of the "
                           "built library disagrees with grad_layout")
    grid = K._grid(lib, "mpnn_fused_att_bwd_grid", k_vocab, n, g, e)
    kw = dict(dtype=torch.float32, device=device)
    dh0 = torch.empty(n, f, **kw)
    dw = torch.empty(layout["total"][0], **kw)
    scratch = torch.empty(lib.mpnn_fused_att_bwd_scratch_floats(
        n, e, k_vocab, f, grid), **kw)
    src_order, src_ptr = K.source_order(src, n)
    tensors = [w[k] for k in _GRAD_LEAVES] + [
        h0, msgs, gh, vid, src, dst, plan.edge_order, plan.dst_ptr,
        src_order, src_ptr, plan.graph_node_ptr, dh0, dw, scratch]
    args = (*(t.data_ptr() for t in tensors), n, g, e, f, k_vocab,
            int(with_corr), grid, torch.cuda.current_stream(device)
            .cuda_stream)
    return K.PreparedLaunch("fused_att_bwd", lib.mpnn_fused_att_bwd,
                            lib.mpnn_cuda_error_string, args, (dh0, dw),
                            tuple(tensors), launch_counts)


class _FusedAtt(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its VJP. Inputs:
    with_corr, the 9 weight leaves (_GRAD_LEAVES order), h0, then the
    non-differentiable batch tensors and the plan. Output h (N, f)."""

    @staticmethod
    def forward(ctx, with_corr, *args):
        weights = list(zip(_GRAD_LEAVES, args[:9]))
        h0, mask, node_graph, vid, src, dst = args[9:15]
        plan = FusedEvalPlan(*args[15:])
        grad = any(ctx.needs_input_grad[1:11])
        h, msgs = K.launch_prepared(prepare_fused_att_fwd(
            weights, h0, mask, node_graph, vid, src, dst, plan,
            with_corr=with_corr, write_msgs=grad))
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
        return (None, *(grads[name] for name in _GRAD_LEAVES), dh0,
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
    return _FusedAtt.apply(
        bool(with_corr), aprime, a0, qv, q0, wh, gru["w_ih"],
        gru["w_hh"], gru["b_ih"], gru["b_hh"], h0, mask, node_graph, vid,
        src, dst, *plan)
