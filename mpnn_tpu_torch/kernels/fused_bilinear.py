"""The bilinear family's message + GRU chain (the `ecfp_bilinear` model):
counterpart of mpnn_tpu/kernels/fused_bilinear.py::make_fused_bilinear_op
(Pallas `_bil_fwd_kernel` and `_bil_bwd_kernel`).

    per step t = 1..T, per edge e (dst v, src u, vid k):
        φ_e = vec(h_{t−1}[u] ⊗ h_{t−1}[v])            (f², index n·f + j)
        msg_t[v] += A_k·φ_e,    A_k[m, n·f + j] = W_k[n, m, j]
    h_t = GRU(msg_t ⊙ mask, h0)                        (hidden = h0 always)

with h_0 = h0 masked and W_k the vocab row k of the edge features viewed
as (f, f, f) (models/fused_train.py builds the table). The op returns the
state history hist (N, T·f), h_t in columns (t−1)·f..t·f, for the
readout over cat[h0, hist]. It is differentiable in h0 and the GRU
weights; amat takes a zero gradient, as the JAX op's (the reference's
bilinear message has no parameters and reads raw edge features).

`fused_bilinear` is a torch.autograd.Function whose forward and backward
are one CUDA launch each (csrc/fused_bilinear_fwd.cu,
csrc/fused_bilinear_bwd.cu). The forward writes the messages the
backward reads only when a gradient is wanted (kernels/fused_step.py::
records_grad): serving skips that write, as the JAX op's keep_msgs=False
does. CPU tensors run the plain version fused_bilinear_reference (under
autograd); CUDA tensors launch the kernels or raise — no fallback. The
index plan is graphs/batching.py::plan_fused_eval's; the backward's
source order is built on the device (kernels/fused_step.py::
source_order).

The kernels keep a graph's states in shared memory, one warp per graph:
they take f <= 4 (nf 2-4, so ef = nf³ from 8 to 64), a vocab of at most
64 rows and graphs of at most MAX_GRAPH_NODES atoms; past any of these the
wrapper raises NotImplementedError naming the widths.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from mpnn_tpu_torch.graphs.batching import FusedEvalPlan
from mpnn_tpu_torch.kernels import fused_step as K

# the one width bucket (csrc/fused_bilinear_common.cuh: FP, kMaxVocab)
BUCKETS = (("", dict(f=4, K=64)),)
MAX_WIDTH = BUCKETS[-1][1]["f"]
# the largest graph a warp holds in shared memory (kMaxGraphNodes)
MAX_GRAPH_NODES = 256

launch_counts: Dict[str, int] = {"fused_bilinear_fwd": 0,
                                 "fused_bilinear_bwd": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# plain version (CPU path; the card's comparison baseline)
# ---------------------------------------------------------------------------

def bilinear_messages(amat, h, vid, src, dst):
    """Σ_{e: dst_e = v} A[vid_e]·vec(h[src_e] ⊗ h[dst_e]) (N, f), in plain
    PyTorch: amat (K, f, f²), h (N, f)."""
    vid, src, dst = vid.long(), src.long(), dst.long()
    n, f = h.shape
    phi = (h[src][:, :, None] * h[dst][:, None, :]).reshape(-1, f * f)
    msg = torch.bmm(amat[vid], phi.unsqueeze(-1)).squeeze(-1)
    return h.new_zeros((n, f)).index_add(0, dst, msg)


def fused_bilinear_reference(amat, h0, mask, node_graph, gru, vid, src,
                             dst, plan: FusedEvalPlan, *, steps: int):
    """Plain PyTorch version of the op, make_fused_bilinear_op's arguments
    minus the TPU window plan plus node_graph and the index plan (neither
    read here): amat (K, f, f²), h0 (N, f), mask (N, 1), GRU weights in
    the JAX layout, vid/src/dst (E,). Returns hist (N, steps·f)."""
    h0 = h0 * mask
    h, hist = h0, []
    for _ in range(steps):
        msgs = bilinear_messages(amat, h, vid, src, dst) * mask
        h = K._gru(gru, msgs @ gru["w_ih"] + gru["b_ih"], h0, mask)
        hist.append(h)
    return torch.cat(hist, dim=-1)


# ---------------------------------------------------------------------------
# the CUDA kernels' libraries
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fused_bilinear_fwd": {
        "mpnn_fused_bilinear_fwd": ([_P] * 13 + [_I] * 6 + [_P], _I),
        "mpnn_fused_bilinear_fwd_smem_bytes": ([_I, _I], _I),
    },
    "fused_bilinear_bwd": {
        "mpnn_fused_bilinear_bwd": ([_P] * 20 + [_I] * 7 + [_P], _I),
        "mpnn_fused_bilinear_bwd_smem_bytes": ([_I, _I], _I),
        "mpnn_fused_bilinear_bwd_layout": ([_I, _P], None),
        "mpnn_fused_bilinear_bwd_scratch_floats": ([_I], ctypes.c_longlong),
        "mpnn_fused_bilinear_bwd_grid": ([_I, _I, _I], _I),
    },
}


def _lib(name: str, tag: str = ""):
    return K._lib(name, _SIGNATURES, tag)


_GRU_LEAVES = ("w_ih", "w_hh", "b_ih", "b_hh")


def grad_layout(f: int) -> Dict[str, tuple]:
    """{leaf: (offset, shape)} of the backward kernel's flat GRU gradient
    (csrc/fused_bilinear_bwd.cu::BilGradLayout)."""
    shapes = [(f, 3 * f), (f, 3 * f), (3 * f,), (3 * f,)]
    out, off = {}, 0
    for name, shape in zip(_GRU_LEAVES, shapes):
        out[name] = (off, shape)
        off += math.prod(shape)
    out["total"] = (off, ())
    return out


def split_grads(dw: torch.Tensor, f: int):
    """The flat gradient as {leaf: view of its shape}."""
    return {name: dw[off:off + math.prod(shape)].view(shape)
            for name, (off, shape) in grad_layout(f).items()
            if name != "total"}


def _graph_nodes(plan: FusedEvalPlan, who: str) -> int:
    """The batch's largest graph (atoms), which sizes the kernels' shared
    memory; past MAX_GRAPH_NODES NotImplementedError naming it."""
    gnp = plan.graph_node_ptr
    most = int((gnp[1:] - gnp[:-1]).max()) if gnp.shape[0] > 1 else 0
    if most > MAX_GRAPH_NODES:
        raise NotImplementedError(
            f"{who}: a graph of {most} atoms; the kernels hold a graph's "
            f"states in shared memory, up to {MAX_GRAPH_NODES} atoms")
    return max(most, 1)


def _check_inputs(who, amat, gru, h0, mask, node_graph, vid, src, dst,
                  plan):
    """Device, dtype, shape and contiguity of every kernel input and the
    batch layout; returns (n, f, k_vocab, e, num_graphs, max_nodes)."""
    device = h0.device
    if device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {device}")
    n, f = h0.shape
    k_vocab = amat.shape[0]
    e = src.shape[0]
    num_graphs = plan.graph_node_ptr.shape[0] - 1
    K.width_bucket(who, BUCKETS, f=f, K=k_vocab)
    K._check("amat", amat, (k_vocab, f, f * f), device, torch.float32)
    for name, shape in zip(_GRU_LEAVES, [(f, 3 * f), (f, 3 * f), (3 * f,),
                                         (3 * f,)]):
        K._check(name, gru[name], shape, device, torch.float32)
    K._check("h0", h0, (n, f), device, torch.float32)
    K._check("mask", mask, (n, 1), device, torch.float32)
    for name, t in [("vid", vid), ("src", src), ("dst", dst)]:
        K._check(name, t, (e,), device, torch.int32)
    K._check("node_graph", node_graph, (n,), device, torch.int32)
    K._check_plan(plan, device, n, e, num_graphs)
    K.check_batch_layout(h0, mask, node_graph, vid, src, dst, plan, k_vocab,
                         num_graphs, who=who)
    return n, f, k_vocab, e, num_graphs, _graph_nodes(plan, who)


def prepare_fused_bilinear_fwd(amat, h0, mask, node_graph, gru, vid, src,
                               dst, plan: FusedEvalPlan, *, steps: int,
                               write_msgs: bool) -> K.PreparedLaunch:
    """One checked forward launch: outputs hist (N, steps·f) and, with
    `write_msgs`, the masked messages (N, steps·f) the backward reads
    (else an empty tensor). h0 PRE-MASKED."""
    n, f, k_vocab, e, g, most = _check_inputs(
        "fused_bilinear", amat, gru, h0, mask, node_graph, vid, src, dst,
        plan)
    if steps < 1:
        raise ValueError(f"fused_bilinear: steps={steps}")
    lib = _lib("fused_bilinear_fwd")
    kw = dict(dtype=torch.float32, device=h0.device)
    hist = torch.empty(n, steps * f, **kw)
    msgs = torch.empty(n, steps * f, **kw) if write_msgs \
        else torch.empty(0, **kw)
    tensors = [amat, *(gru[k] for k in _GRU_LEAVES), h0, vid, src,
               plan.edge_order, plan.dst_ptr, plan.graph_node_ptr, hist,
               msgs]
    ptrs = [t.data_ptr() for t in tensors]
    if not write_msgs:
        ptrs[-1] = None
    args = (*ptrs, n, g, f, k_vocab, steps, most,
            torch.cuda.current_stream(h0.device).cuda_stream)
    return K.PreparedLaunch("fused_bilinear_fwd",
                            lib.mpnn_fused_bilinear_fwd,
                            lib.mpnn_cuda_error_string, args, (hist, msgs),
                            tuple(tensors), launch_counts)


def prepare_fused_bilinear_bwd(amat, h0, gru, hist, msgs, ghist, vid, src,
                               dst, plan: FusedEvalPlan, *, steps: int,
                               max_nodes: int) -> K.PreparedLaunch:
    """One checked backward launch on the forward's residuals (the batch
    tensors and `max_nodes`, its largest graph, as the forward's launch
    checked and found them): outputs dh0 (N, f) and the flat GRU gradient
    of grad_layout."""
    device = h0.device
    n, f = h0.shape
    k_vocab = amat.shape[0]
    g = plan.graph_node_ptr.shape[0] - 1
    for name, t in [("hist", hist), ("msgs", msgs), ("ghist", ghist)]:
        K._check(name, t, (n, steps * f), device, torch.float32)
    lib = _lib("fused_bilinear_bwd")
    layout = grad_layout(f)
    c_layout = (ctypes.c_int * 5)()
    lib.mpnn_fused_bilinear_bwd_layout(f, c_layout)
    if [v[0] for v in layout.values()] != list(c_layout):
        raise RuntimeError("fused_bilinear_bwd: the gradient layout of the "
                           "built library disagrees with grad_layout")
    grid = K._grid(lib, "mpnn_fused_bilinear_bwd_grid", k_vocab, max_nodes,
                   g)
    kw = dict(dtype=torch.float32, device=device)
    dh0 = torch.empty(n, f, **kw)
    dw = torch.empty(layout["total"][0], **kw)
    scratch = torch.empty(lib.mpnn_fused_bilinear_bwd_scratch_floats(grid),
                          **kw)
    src_order, src_ptr = K.source_order(src, n)
    tensors = [amat, *(gru[k] for k in _GRU_LEAVES), h0, hist, msgs, ghist,
               vid, src, dst, plan.edge_order, plan.dst_ptr, src_order,
               src_ptr, plan.graph_node_ptr, dh0, dw, scratch]
    args = (*(t.data_ptr() for t in tensors), n, g, f, k_vocab, steps,
            max_nodes, grid, torch.cuda.current_stream(device).cuda_stream)
    return K.PreparedLaunch("fused_bilinear_bwd",
                            lib.mpnn_fused_bilinear_bwd,
                            lib.mpnn_cuda_error_string, args, (dh0, dw),
                            tuple(tensors), launch_counts)


class _FusedBilinear(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its VJP. Inputs:
    steps, write_msgs (K.records_grad of the leaves), amat, the 4 GRU
    leaves, h0, then the non-differentiable batch tensors and the plan.
    Output hist (N, steps·f)."""

    @staticmethod
    def forward(ctx, steps, write_msgs, amat, w_ih, w_hh, b_ih, b_hh, h0,
                mask, node_graph, vid, src, dst, *plan):
        gru = dict(zip(_GRU_LEAVES, (w_ih, w_hh, b_ih, b_hh)))
        plan = FusedEvalPlan(*plan)
        p = prepare_fused_bilinear_fwd(amat, h0, mask, node_graph, gru, vid,
                                       src, dst, plan, steps=steps,
                                       write_msgs=write_msgs)
        hist, msgs = K.launch_prepared(p)
        ctx.steps, ctx.max_nodes = steps, p.args[-2]
        ctx.save_for_backward(amat, w_ih, w_hh, b_ih, b_hh, h0, vid, src,
                              dst, *plan, hist, msgs)
        return hist

    @staticmethod
    def backward(ctx, ghist):
        (amat, w_ih, w_hh, b_ih, b_hh, h0, vid, src, dst, *rest) = \
            ctx.saved_tensors
        plan, hist, msgs = FusedEvalPlan(*rest[:4]), rest[4], rest[5]
        gru = dict(zip(_GRU_LEAVES, (w_ih, w_hh, b_ih, b_hh)))
        dh0, dw = K.launch_prepared(prepare_fused_bilinear_bwd(
            amat, h0, gru, hist, msgs, ghist.contiguous(), vid, src, dst,
            plan, steps=ctx.steps, max_nodes=ctx.max_nodes))
        grads = split_grads(dw, h0.shape[1])
        damat = torch.zeros_like(amat) if ctx.needs_input_grad[2] else None
        return (None, None, damat, *(grads[k] for k in _GRU_LEAVES), dh0,
                *([None] * (5 + len(plan))))


def fused_bilinear(amat, h0, mask, node_graph, gru, vid, src, dst,
                   plan: FusedEvalPlan, *, steps: int):
    """The message + GRU chain: hist (N, steps·f), differentiable in h0
    and the GRU weights (amat takes a zero gradient). h0 PRE-MASKED;
    arguments as fused_bilinear_reference (node_graph is read by the
    kernels' layout check). CPU tensors run the plain version under
    autograd; CUDA tensors launch the forward kernel (and, in the backward
    pass, the backward kernel) or raise."""
    if h0.device.type == "cpu":
        # as the kernels and the JAX op: no gradient into amat
        return fused_bilinear_reference(amat.detach(), h0, mask, node_graph,
                                        gru, vid, src, dst, plan,
                                        steps=steps)
    leaves = (amat, gru["w_ih"], gru["w_hh"], gru["b_ih"], gru["b_hh"], h0)
    return _FusedBilinear.apply(int(steps), K.records_grad(*leaves[1:]),
                                *leaves, mask, node_graph, vid, src, dst,
                                *plan)
