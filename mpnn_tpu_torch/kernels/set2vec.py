"""The set2vec readout op: counterpart of mpnn_tpu/kernels/set2vec.py::
make_set2vec_op (Pallas `_s2v_fwd_kernel` and `_s2v_bwd_kernel`).

    m_0 = 0 (G, 2w), c_0 = 0 (G, w); for t = 1..T:
        h_t, c_t = LSTMhidden(m_{t−1}, c_{t−1})       (no input; 2w → w)
        q_g      = h_t,g · Wq                          (w → w, no bias)
        e_v      = we · tanh(q_{g(v)} + x_v) − 1e8·(1 − mask_v)
        att      = softmax over ALL nodes of the batch (batch_softmax, the
                   reference's quirk, set2vec.py:139) or per graph
        read_g   = Σ_{v∈g} att_v · x_v
        m_t      = [h_t ‖ read]
    returns m_T (G, 2w)

With the batch-global softmax a molecule's output depends on the other
molecules of its batch, as in the reference. `set2vec` is a
torch.autograd.Function whose forward and backward are one cooperative
CUDA launch each (csrc/set2vec_fwd.cu, csrc/set2vec_bwd.cu). For training
the forward writes the residual stash — each step's input carry (mh, mr,
c) and attention row — which the backward walks in reverse; serving skips
it. CPU tensors run the plain version set2vec_reference (under autograd);
CUDA tensors launch the kernels or raise — no fallback.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple

import torch

from mpnn_tpu_torch.kernels import fused_step as K
from mpnn_tpu_torch.ops.readout import LSTM_GATES, _lstm_hidden_apply

# width buckets of the CUDA kernels, narrowest first (as fused_step.py's):
# the set's width w = 2·nf. Each is its own build of
# csrc/set2vec_{fwd,bwd}.cu (kernels/build.py::WIDE).
BUCKETS = (("", dict(w=32)), ("w64", dict(w=64)))
MAX_WIDTH = BUCKETS[-1][1]["w"]
_BIG_NEG = -1e8          # the reference's masking constant

launch_counts: Dict[str, int] = {"set2vec_fwd": 0, "set2vec_bwd": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# plain version (CPU path; the card's comparison baseline)
# ---------------------------------------------------------------------------

def set2vec_reference(rparams, x, mask, node_graph, graph_node_ptr, *,
                      time_steps: int, batch_softmax: bool = True):
    """Plain PyTorch version of the op, make_set2vec_op's arguments minus
    the TPU window plan plus the per-graph node pointers (their length
    only is read, for G): rparams {"lstm": {w_h*, b_h*}, "q_attn": {"w"},
    "e_attn": {"w"}} in the JAX layout, x (N, w), mask (N, 1), node_graph
    (N,) with padded nodes at G. Returns m (G, 2w). The packed loop of
    mpnn_tpu/models/sparse.py::sparse_set2vec."""
    num_graphs = graph_node_ptr.shape[0] - 1
    width = x.shape[1]
    ng = node_graph.long()
    q_rows = ng.clamp(0, max(num_graphs - 1, 0))
    add_mask = (1.0 - mask[:, 0]) * _BIG_NEG
    mprev = x.new_zeros((num_graphs, 2 * width))
    cprev = x.new_zeros((num_graphs, width))
    for _ in range(time_steps):
        m, c = _lstm_hidden_apply(rparams["lstm"], mprev, cprev)
        query = m @ rparams["q_attn"]["w"]
        energies = (torch.tanh(query[q_rows] + x)
                    @ rparams["e_attn"]["w"])[:, 0] + add_mask
        if batch_softmax:
            att = torch.softmax(energies, dim=0)
        else:
            # the segment max only shifts the exponent: no gradient
            emax = energies.new_full((num_graphs + 1,), -math.inf) \
                .scatter_reduce(0, ng, energies.detach(), "amax")
            z = torch.exp(energies - emax[ng])
            denom = z.new_zeros((num_graphs + 1,)).index_add(0, ng, z)
            att = z / denom[ng]
        read = x.new_zeros((num_graphs + 1, width)).index_add(
            0, ng, att[:, None] * x)[:num_graphs]
        mprev, cprev = torch.cat([m, read], dim=1), c
    return mprev


# ---------------------------------------------------------------------------
# the CUDA kernels' libraries
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "set2vec_fwd": {
        "mpnn_set2vec_fwd": ([_P] * 16 + [_I] * 6 + [_P], _I),
        "mpnn_set2vec_fwd_smem_bytes": ([_I], _I),
        "mpnn_set2vec_fwd_scratch_floats": ([_I] * 3, ctypes.c_longlong),
        "mpnn_set2vec_fwd_grid": ([_I, _I], _I),
    },
    "set2vec_bwd": {
        "mpnn_set2vec_bwd": ([_P] * 18 + [_I] * 6 + [_P], _I),
        "mpnn_set2vec_bwd_smem_bytes": ([_I], _I),
        "mpnn_set2vec_bwd_layout": ([_I, _P], None),
        "mpnn_set2vec_bwd_scratch_floats": ([_I] * 5, ctypes.c_longlong),
        "mpnn_set2vec_bwd_grid": ([_I, _I], _I),
    },
}


def _lib(name: str, tag: str = ""):
    return K._lib(name, _SIGNATURES, tag)


# the differentiable leaves, in the kernels' argument order and the
# backward's flat gradient layout (csrc/set2vec_bwd.cu::S2vGradLayout)
_GRAD_LEAVES = tuple(f"w_h{k}" for k in LSTM_GATES) + tuple(
    f"b_h{k}" for k in LSTM_GATES) + ("q_w", "e_w")


def _leaf_shapes(w: int):
    return [(2 * w, w)] * 4 + [(1, w)] * 4 + [(w, w), (w, 1)]


def grad_layout(w: int) -> Dict[str, tuple]:
    """{leaf: (offset, shape)} of the backward kernel's flat gradient."""
    out, off = {}, 0
    for name, shape in zip(_GRAD_LEAVES, _leaf_shapes(w)):
        out[name] = (off, shape)
        off += math.prod(shape)
    out["total"] = (off, ())
    return out


def split_grads(dw: torch.Tensor, w: int):
    return {name: dw[off:off + math.prod(shape)].view(shape)
            for name, (off, shape) in grad_layout(w).items()
            if name != "total"}


def flat_leaves(rparams):
    """The readout's leaves in _GRAD_LEAVES order, contiguous (the JAX
    layout of an nn.Linear weight is its transposed view)."""
    lstm = rparams["lstm"]
    return [t.contiguous() for t in
            [lstm[n] for n in _GRAD_LEAVES[:8]]
            + [rparams["q_attn"]["w"], rparams["e_attn"]["w"]]]


def check_node_layout(mask, node_graph, graph_node_ptr,
                      who: str = "set2vec") -> None:
    """The invariants the kernels rely on, with one device sync: graphs
    node-contiguous in order (node_graph non-decreasing, padded nodes and
    only they at G with mask 0, real masks 1) and graph_node_ptr the
    graphs' node ranges."""
    g = graph_node_ptr.shape[0] - 1
    ng = node_graph.long()
    bad = torch.stack([
        (ng[1:] < ng[:-1]).any(),
        ((ng > g) | (ng < 0)).any(),
        (mask[:, 0] != (ng < g).to(mask.dtype)).any(),
        ((graph_node_ptr[0] != 0)
         | (graph_node_ptr.long().diff()
            != torch.bincount(ng.clamp(0, g), minlength=g + 1)[:g])).any()])
    names = ["node_graph not non-decreasing", "node_graph out of [0, G]",
             "mask must be 1 on real nodes and 0 on padded nodes",
             "graph_node_ptr disagrees with node_graph"]
    for flag, what in zip(bad.cpu().tolist(), names):
        if flag:
            raise ValueError(f"{who}: {what}")


def _check_inputs(leaves, x, mask, node_graph, graph_node_ptr, steps):
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"set2vec: unsupported device {device}")
    n, w = x.shape
    K.width_bucket("set2vec", BUCKETS, w=w)
    if steps < 1:
        raise NotImplementedError(f"set2vec: time_steps={steps}")
    for name, t, shape in zip(_GRAD_LEAVES, leaves, _leaf_shapes(w)):
        K._check(name, t, shape, device, torch.float32)
    K._check("x", x, (n, w), device, torch.float32)
    K._check("mask", mask, (n, 1), device, torch.float32)
    K._check("node_graph", node_graph, (n,), device, torch.int32)
    g = graph_node_ptr.shape[0] - 1
    K._check("graph_node_ptr", graph_node_ptr, (g + 1,), device,
             torch.int32)
    check_node_layout(mask, node_graph, graph_node_ptr)
    return n, w, g


class S2vMeta(NamedTuple):
    steps: int
    batch_softmax: bool


def prepare_set2vec_fwd(leaves, x, mask, node_graph, graph_node_ptr,
                        meta: S2vMeta, *, stash: bool) -> K.PreparedLaunch:
    """One checked forward launch: outputs m (G, 2w) and, with `stash`,
    the residuals the backward reads — the input carry of every step
    (T, G, 3w) as [mh ‖ mr ‖ c] and the attention rows (T, N) — else
    empty tensors."""
    n, w, g = _check_inputs(leaves, x, mask, node_graph, graph_node_ptr,
                            meta.steps)
    lib = _lib("set2vec_fwd", K.width_bucket("set2vec", BUCKETS, w=w))
    T = meta.steps
    grid = K._grid(lib, "mpnn_set2vec_fwd_grid", g, w)
    kw = dict(dtype=torch.float32, device=x.device)
    m = torch.empty(g, 2 * w, **kw)
    carry = torch.empty(T, g, 3 * w, **kw) if stash else torch.empty(0, **kw)
    att = torch.empty(T, n, **kw) if stash else torch.empty(0, **kw)
    scratch = torch.empty(lib.mpnn_set2vec_fwd_scratch_floats(n, g, grid),
                          **kw)
    tensors = list(leaves) + [x, graph_node_ptr, m, carry, att, scratch]
    ptrs = [t.data_ptr() for t in tensors]
    if not stash:
        ptrs[-3] = ptrs[-2] = None
    args = (*ptrs, n, g, w, T, int(meta.batch_softmax), grid,
            torch.cuda.current_stream(x.device).cuda_stream)
    return K.PreparedLaunch("set2vec_fwd", lib.mpnn_set2vec_fwd,
                            lib.mpnn_cuda_error_string, args,
                            (m, carry, att), tuple(tensors), launch_counts)


def prepare_set2vec_bwd(leaves, x, graph_node_ptr, carry, att, gm,
                        meta: S2vMeta) -> K.PreparedLaunch:
    """One checked backward launch on the forward's stash: outputs dx
    (N, w) and the flat gradient of grad_layout."""
    device = x.device
    n, w = x.shape
    g, T = graph_node_ptr.shape[0] - 1, meta.steps
    for name, t, shape in [("carry", carry, (T, g, 3 * w)),
                           ("att", att, (T, n)), ("gm", gm, (g, 2 * w))]:
        K._check(name, t, shape, device, torch.float32)
    lib = _lib("set2vec_bwd", K.width_bucket("set2vec", BUCKETS, w=w))
    layout = grad_layout(w)
    c_layout = (ctypes.c_int * 11)()
    lib.mpnn_set2vec_bwd_layout(w, c_layout)
    if [v[0] for v in layout.values()] != list(c_layout):
        raise RuntimeError("set2vec_bwd: the gradient layout of the built "
                           "library disagrees with grad_layout")
    grid = K._grid(lib, "mpnn_set2vec_bwd_grid", g, w)
    kw = dict(dtype=torch.float32, device=device)
    dx = torch.empty(n, w, **kw)
    dw = torch.empty(layout["total"][0], **kw)
    scratch = torch.empty(
        lib.mpnn_set2vec_bwd_scratch_floats(n, g, w, T, grid), **kw)
    tensors = list(leaves) + [x, graph_node_ptr, carry, att, gm, dx, dw,
                              scratch]
    args = (*(t.data_ptr() for t in tensors), n, g, w, T,
            int(meta.batch_softmax), grid,
            torch.cuda.current_stream(device).cuda_stream)
    return K.PreparedLaunch("set2vec_bwd", lib.mpnn_set2vec_bwd,
                            lib.mpnn_cuda_error_string, args, (dx, dw),
                            tuple(tensors), launch_counts)


class _Set2Vec(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its VJP. Inputs:
    meta, stash (K.records_grad of the leaves), the 10 leaves
    (_GRAD_LEAVES order), x, then mask, node_graph and graph_node_ptr.
    Output m (G, 2w)."""

    @staticmethod
    def forward(ctx, meta, stash, *args):
        leaves, (x, mask, node_graph, gnp) = args[:10], args[10:]
        m, carry, att = K.launch_prepared(prepare_set2vec_fwd(
            leaves, x, mask, node_graph, gnp, meta, stash=stash))
        ctx.meta = meta
        ctx.save_for_backward(*leaves, x, gnp, carry, att)
        return m

    @staticmethod
    def backward(ctx, gm):
        saved = ctx.saved_tensors
        leaves, (x, gnp, carry, att) = saved[:10], saved[10:]
        dx, dw = K.launch_prepared(prepare_set2vec_bwd(
            leaves, x, gnp, carry, att, gm.contiguous(), ctx.meta))
        grads = split_grads(dw, x.shape[1])
        return (None, None, *(grads[name] for name in _GRAD_LEAVES), dx,
                None, None, None)


def set2vec(rparams, x, mask, node_graph, graph_node_ptr, *,
            time_steps: int, batch_softmax: bool = True):
    """The set2vec readout: m (G, 2w), differentiable in the readout's
    leaves and x. Arguments as set2vec_reference. CPU tensors run the
    plain version under autograd; CUDA tensors launch the forward kernel
    (and, in the backward pass, the backward kernel) or raise."""
    if x.device.type == "cpu":
        return set2vec_reference(rparams, x, mask, node_graph,
                                 graph_node_ptr, time_steps=time_steps,
                                 batch_softmax=batch_softmax)
    leaves = (*flat_leaves(rparams), x)
    return _Set2Vec.apply(S2vMeta(int(time_steps), bool(batch_softmax)),
                          K.records_grad(*leaves), *leaves, mask,
                          node_graph, graph_node_ptr)
