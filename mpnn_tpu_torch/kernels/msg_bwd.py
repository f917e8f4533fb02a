"""The message VJP of the split training backward, for T >= 1 stacked
message networks (counterpart of mpnn_tpu/kernels/fused_step.py::
_msg_bwd_kernel, the shared family's T = 1, and of mpnn_tpu/kernels/
fused_psteps.py::_ps_a0_bwd_kernel and _ps_edge_bwd_kernel, the per-step
family's T networks).

The forward's messages of network t, masked:

    m_t,d = (Σ_{e: dst_e = d} A_t[vid_e]·h0_src_e + A0_t·S_g(d) + b_t)·m_d,
    S_g = Σ_{v ∈ g} h0_v

Given their cotangents dm_t (T, N, f), with dm'_t = dm_t·m (the mask):

    dh0_v  = Σ_t Σ_{e: src_e = v} A_t[vid_e]ᵀ·dm'_t,dst_e + Σ_t A0_tᵀ·D_t,g(v)
    dA_t[k] = Σ_{e: vid_e = k} dm'_t,dst_e ⊗ h0_src_e
    dA0_t  = Σ_g D_t,g ⊗ S_g,   db_t = Σ_g D_t,g,   D_t,g = Σ_{v ∈ g} dm'_t,v

CPU tensors run the plain version (msg_bwd_reference, autograd of the
plain message sum); CUDA tensors launch csrc/msg_bwd.cu or raise.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from mpnn_tpu_torch.graphs.batching import FusedEvalPlan
from mpnn_tpu_torch.kernels import fused_step as K

# width buckets, narrowest first (kernels/build.py::WIDE, the split_bwd
# family)
BUCKETS = (("", dict(f=16)), ("f32", dict(f=32)))
# the largest edge vocabulary (csrc/spmm_common.cuh::kMaxVocab)
MAX_VOCAB = 64

launch_counts: Dict[str, int] = {"msg_bwd": 0}

_LEAVES = ("amat", "a0", "mbias")


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def msg_bwd_reference(amat, a0, h0, mask, node_graph, vid, src, dst, dmsgs,
                      num_graphs: int):
    """The plain version: autograd of kernels/fused_step.py::_messages
    (times the mask) for each of the T networks. amat (T, K, f, f), a0
    (T, f, f), dmsgs (T, N, f). Returns (dh0 (N, f), {'amat', 'a0',
    'mbias'}: (T, K, f, f), (T, f, f), (T, f))."""
    T, f = amat.shape[0], h0.shape[1]
    ng = node_graph.long()
    with torch.enable_grad():
        a = amat.detach().requires_grad_()
        b0 = a0.detach().requires_grad_()
        mb = h0.new_zeros(T, f).requires_grad_()
        h = h0.detach().requires_grad_()
        m = torch.stack([K._messages(a[t], b0[t], mb[t], h, ng, vid, src,
                                     dst, num_graphs) * mask
                         for t in range(T)])
        g = torch.autograd.grad(m, [h, a, b0, mb], dmsgs.detach())
    return g[0], dict(zip(_LEAVES, g[1:]))


def grad_layout(steps: int, k_vocab: int, f: int) -> Dict[str, tuple]:
    """{leaf: (offset, shape)} of the kernel's flat gradient: dA (T, K, f,
    f), dA0 (T, f, f), db (T, f)."""
    out, off = {}, 0
    for name, shape in zip(_LEAVES, [(steps, k_vocab, f, f),
                                     (steps, f, f), (steps, f)]):
        out[name] = (off, shape)
        off += math.prod(shape)
    out["total"] = (off, ())
    return out


def split_grads(dw: torch.Tensor, steps: int, k_vocab: int, f: int):
    return {name: dw[off:off + math.prod(shape)].view(shape)
            for name, (off, shape) in grad_layout(steps, k_vocab, f).items()
            if name != "total"}


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "msg_bwd": {
        "mpnn_msg_bwd": ([_P] * 17 + [_I] * 6 + [_P], _I),
        "mpnn_msg_bwd_scratch_floats": ([_I] * 5, ctypes.c_longlong),
        "mpnn_msg_bwd_layout": ([_I] * 3 + [_P], None),
    },
}


def _lib(name: str = "msg_bwd", tag: str = ""):
    return K._lib(name, _SIGNATURES, tag)


def prepare_msg_bwd(amat, a0, h0, mask, node_graph, vid, src, dst, dmsgs,
                    plan: FusedEvalPlan) -> K.PreparedLaunch:
    """One checked launch (the batch layout as the forward checked it);
    the source and vocab orders are built on the device. Outputs (dh0
    (N, f), the flat gradient of grad_layout)."""
    device = h0.device
    if device.type != "cuda":
        raise ValueError(f"msg_bwd: unsupported device {device}")
    T, k_vocab, f = amat.shape[0], amat.shape[1], amat.shape[-1]
    n, e = h0.shape[0], src.shape[0]
    g = plan.graph_node_ptr.shape[0] - 1
    if not 1 <= k_vocab <= MAX_VOCAB:
        raise NotImplementedError(
            f"msg_bwd: K={k_vocab}; the kernel takes 1 to {MAX_VOCAB} ids")
    if e < 1:
        raise ValueError("msg_bwd: no edges")
    tag = K.width_bucket("msg_bwd", BUCKETS, f=f)
    for name, t, shape in [("amat", amat, (T, k_vocab, f, f)),
                           ("a0", a0, (T, f, f)), ("h0", h0, (n, f)),
                           ("mask", mask, (n, 1)),
                           ("dmsgs", dmsgs, (T, n, f))]:
        K._check(name, t, shape, device, torch.float32)
    for name, t in [("vid", vid), ("src", src), ("dst", dst)]:
        K._check(name, t, (e,), device, torch.int32)
    K._check("node_graph", node_graph, (n,), device, torch.int32)
    K._check("plan.graph_node_ptr", plan.graph_node_ptr, (g + 1,), device,
             torch.int32)
    lib = _lib("msg_bwd", tag)
    layout = grad_layout(T, k_vocab, f)
    c_layout = (ctypes.c_int * 4)()
    lib.mpnn_msg_bwd_layout(T, k_vocab, f, c_layout)
    if [v[0] for v in layout.values()] != list(c_layout):
        raise RuntimeError("msg_bwd: the gradient layout of the built "
                           "library disagrees with grad_layout")
    src_order, src_ptr = K.source_order(src, n)
    vorder, vptr = K.source_order(vid, k_vocab)
    kw = dict(dtype=torch.float32, device=device)
    dh0 = torch.empty(n, f, **kw)
    dw = torch.empty(layout["total"][0], **kw)
    scratch = torch.empty(lib.mpnn_msg_bwd_scratch_floats(
        T, k_vocab, n, e, g), **kw)
    keep = (amat, a0, h0, mask, dmsgs, vid, src, dst, src_order, src_ptr,
            vorder, vptr, plan.graph_node_ptr, node_graph, dh0, dw, scratch)
    args = (*(t.data_ptr() for t in keep), n, e, g, f, k_vocab, T,
            torch.cuda.current_stream(device).cuda_stream)
    return K.PreparedLaunch("msg_bwd", lib.mpnn_msg_bwd,
                            lib.mpnn_cuda_error_string, args, (dh0, dw),
                            keep, launch_counts)


def msg_bwd(amat, a0, h0, mask, node_graph, vid, src, dst, dmsgs,
            plan: FusedEvalPlan):
    """(dh0 (N, f), {'amat': (T, K, f, f), 'a0': (T, f, f), 'mbias':
    (T, f)}) of the T masked message sums for their cotangents dmsgs
    (T, N, f). CPU tensors run the plain version; CUDA tensors launch the
    kernel or raise."""
    if h0.device.type == "cpu":
        return msg_bwd_reference(amat, a0, h0, mask, node_graph, vid, src,
                                 dst, dmsgs, plan.graph_node_ptr.shape[0] - 1)
    dh0, dw = K.launch_prepared(prepare_msg_bwd(
        amat, a0, h0, mask, node_graph, vid, src, dst, dmsgs, plan))
    return dh0, split_grads(dw, amat.shape[0], amat.shape[1], h0.shape[1])
