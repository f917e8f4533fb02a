"""The edge-MLP chain op (counterpart of mpnn_tpu/kernels/edge_mlp.py):
the edge network's head layers and its weight-shared ×T relu tail on the
edge-vocab rows, with a backward.

    pen = edge_mlp(e, head_ws, head_bs, shared_w, tail=T)

e (R, ef); head_ws[i] (d_i, d_{i+1}) and head_bs[i] (d_{i+1},) in the JAX
layout (in, out); shared_w (pf, pf). It is the `edge_mlp_fn` hook of the
A-form builders (models/sparse.py::_edge_penultimates); make_edge_mlp_op
binds the tail count as the JAX package's does. CPU tensors run the plain
version (edge_mlp_reference) under autograd; CUDA tensors launch the
hand-written kernels csrc/edge_mlp_fwd.cu and, in the backward pass,
csrc/edge_mlp_bwd.cu, or raise. The forward writes no residuals — the
backward recomputes the chain — so serving and training launch the same
forward.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Sequence

import torch

from mpnn_tpu_torch.kernels import fused_step as K

# the most head layers the kernels take (csrc/edge_mlp_common.cuh)
MAX_HEAD = 4

launch_counts: Dict[str, int] = {"edge_mlp_fwd": 0, "edge_mlp_bwd": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def edge_mlp_reference(x, head_ws: Sequence, head_bs: Sequence, shared_w,
                       tail: int):
    """The plain version: ops/message.py::_edge_mlp_penultimate on plain
    tensors, weights in the JAX layout (in, out) — the same nn.Linear
    arithmetic on their transposes, so a model's rows come out bit for bit
    as its plain chain gives them."""
    linear = torch.nn.functional.linear
    for w, b in zip(head_ws, head_bs):
        x = torch.relu(linear(x, w.t(), b))
    for _ in range(tail):
        x = torch.relu(linear(x, shared_w.t()))
    return x


_I, _P = ctypes.c_int, ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "edge_mlp_fwd": {
        "mpnn_edge_mlp_fwd": ([_P, _PP, _PP, _P, _IP, _I, _I, _I, _P, _P],
                              _I),
    },
    "edge_mlp_bwd": {
        "mpnn_edge_mlp_bwd": ([_P, _PP, _PP, _P, _IP, _I, _I, _I, _P, _P, _P,
                               _P, _I, _P], _I),
        "mpnn_edge_mlp_bwd_layout": ([_IP, _I, _IP], None),
        "mpnn_edge_mlp_bwd_grid": ([_IP, _I, _I], _I),
        "mpnn_edge_mlp_bwd_scratch_floats": ([_IP, _I, _I, _I, _I],
                                             ctypes.c_longlong),
    },
}


def _lib(name: str):
    return K._lib(name, _SIGNATURES)


def grad_layout(dims: Sequence[int]) -> Dict[str, tuple]:
    """{leaf: (offset, shape)} of the backward kernel's flat gradient, in
    csrc/edge_mlp_bwd.cu's GradLayout order: head weights w0.., head
    biases b0.., then W_s ("ws")."""
    h = len(dims) - 1
    shapes = ([(f"w{i}", (dims[i], dims[i + 1])) for i in range(h)]
              + [(f"b{i}", (dims[i + 1],)) for i in range(h)]
              + [("ws", (dims[-1], dims[-1]))])
    out, off = {}, 0
    for name, shape in shapes:
        out[name] = (off, shape)
        off += math.prod(shape)
    out["total"] = (off, ())
    return out


def _check_inputs(who, x, head_ws, head_bs, shared_w, tail):
    """Device, dtype, shape and contiguity of every input; returns the
    layer widths (ef, d_1, …, pf)."""
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {device}")
    if len(head_ws) != len(head_bs) or len(head_ws) > MAX_HEAD:
        raise NotImplementedError(
            f"{who}: {len(head_ws)} head layers; the kernels take up to "
            f"{MAX_HEAD}")
    if tail < 0:
        raise ValueError(f"{who}: tail={tail}")
    rows, ef = x.shape
    dims = [ef] + [w.shape[1] for w in head_ws]
    pf = dims[-1]
    K._check("x", x, (rows, ef), device, torch.float32)
    for i, (w, b) in enumerate(zip(head_ws, head_bs)):
        K._check(f"head_ws[{i}]", w, (dims[i], dims[i + 1]), device,
                 torch.float32)
        K._check(f"head_bs[{i}]", b, (dims[i + 1],), device, torch.float32)
    K._check("shared_w", shared_w, (pf, pf), device, torch.float32)
    if rows < 1:
        raise ValueError(f"{who}: no rows")
    return dims


def _pointers(ts):
    return (ctypes.c_void_p * max(len(ts), 1))(*(t.data_ptr() for t in ts))


def _int_array(v):
    return (ctypes.c_int * len(v))(*v)


def prepare_edge_mlp_fwd(x, head_ws, head_bs, shared_w, *,
                         tail: int) -> K.PreparedLaunch:
    """One checked forward launch: output pen (R, pf)."""
    dims = _check_inputs("edge_mlp", x, head_ws, head_bs, shared_w, tail)
    lib = _lib("edge_mlp_fwd")
    out = torch.empty(x.shape[0], dims[-1], dtype=torch.float32,
                      device=x.device)
    keep = (x, *head_ws, *head_bs, shared_w, out)
    args = (x.data_ptr(), _pointers(head_ws), _pointers(head_bs),
            shared_w.data_ptr(), _int_array(dims), len(head_ws),
            x.shape[0], tail, out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    return K.PreparedLaunch("edge_mlp_fwd", lib.mpnn_edge_mlp_fwd,
                            lib.mpnn_cuda_error_string, args, out, keep,
                            launch_counts)


_GRIDS: Dict[tuple, int] = {}


def prepare_edge_mlp_bwd(x, head_ws, head_bs, shared_w, gpen, *,
                         tail: int) -> K.PreparedLaunch:
    """One checked backward launch: outputs dx (R, ef) and the flat
    gradient of grad_layout."""
    dims = _check_inputs("edge_mlp", x, head_ws, head_bs, shared_w, tail)
    rows, h = x.shape[0], len(head_ws)
    K._check("gpen", gpen, (rows, dims[-1]), x.device, torch.float32)
    lib = _lib("edge_mlp_bwd")
    layout = grad_layout(dims)
    c_dims = _int_array(dims)
    c_layout = (ctypes.c_int * (2 * h + 2))()
    lib.mpnn_edge_mlp_bwd_layout(c_dims, h, c_layout)
    if [v[0] for v in layout.values()] != list(c_layout):
        raise RuntimeError("edge_mlp_bwd: the gradient layout of the built "
                           "library disagrees with grad_layout")
    key = (tuple(dims), rows, torch.cuda.current_device())
    if key not in _GRIDS:
        grid = lib.mpnn_edge_mlp_bwd_grid(c_dims, h, rows)
        if grid < 1:
            raise RuntimeError("edge_mlp_bwd: no cooperative grid fits "
                               "this card")
        _GRIDS[key] = grid
    grid = _GRIDS[key]
    kw = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty(rows, dims[0], **kw)
    dw = torch.empty(layout["total"][0], **kw)
    scratch = torch.empty(lib.mpnn_edge_mlp_bwd_scratch_floats(
        c_dims, h, rows, tail, grid), **kw)
    keep = (x, *head_ws, *head_bs, shared_w, gpen, dx, dw, scratch)
    args = (x.data_ptr(), _pointers(head_ws), _pointers(head_bs),
            shared_w.data_ptr(), c_dims, h, rows, tail, gpen.data_ptr(),
            dx.data_ptr(), dw.data_ptr(), scratch.data_ptr(), grid,
            torch.cuda.current_stream(x.device).cuda_stream)
    return K.PreparedLaunch("edge_mlp_bwd", lib.mpnn_edge_mlp_bwd,
                            lib.mpnn_cuda_error_string, args, (dx, dw), keep,
                            launch_counts)


def split_grads(dw: torch.Tensor, dims: Sequence[int]):
    """The flat gradient as {leaf: view of its shape}."""
    return {name: dw[off:off + math.prod(shape)].view(shape)
            for name, (off, shape) in grad_layout(dims).items()
            if name != "total"}


class _EdgeMlp(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its VJP. Inputs:
    tail, the number of head layers H, x, the H head weights, the H head
    biases, W_s. Output pen (R, pf)."""

    @staticmethod
    def forward(ctx, tail, h, x, *ws):
        pen = K.launch_prepared(prepare_edge_mlp_fwd(
            x, ws[:h], ws[h:2 * h], ws[2 * h], tail=tail))
        ctx.tail, ctx.h = tail, h
        ctx.save_for_backward(x, *ws)
        return pen

    @staticmethod
    def backward(ctx, gpen):
        x, *ws = ctx.saved_tensors
        h = ctx.h
        dx, dw = K.launch_prepared(prepare_edge_mlp_bwd(
            x, ws[:h], ws[h:2 * h], ws[2 * h], gpen.contiguous(),
            tail=ctx.tail))
        dims = [x.shape[1]] + [w.shape[1] for w in ws[:h]]
        g = split_grads(dw, dims)
        return (None, None, dx, *(g[f"w{i}"] for i in range(h)),
                *(g[f"b{i}"] for i in range(h)), g["ws"])


def edge_mlp(e, head_ws: Sequence, head_bs: Sequence, shared_w, *,
             tail: int):
    """pen (R, pf) of the chain on the rows e (R, ef), differentiable in e
    and every weight. CPU tensors run the plain version; CUDA tensors
    launch the kernels or raise."""
    if e.device.type == "cpu":
        return edge_mlp_reference(e, head_ws, head_bs, shared_w, tail)
    c = lambda t: t.contiguous()
    return _EdgeMlp.apply(tail, len(head_ws), c(e), *map(c, head_ws),
                          *map(c, head_bs), c(shared_w))


def make_edge_mlp_op(tail: int):
    """fn(e, head_ws, head_bs, shared_w) → pen with the tail count bound:
    the `edge_mlp_fn` hook, as mpnn_tpu/kernels/edge_mlp.py::
    make_edge_mlp_op returns it."""
    def fn(e, head_ws, head_bs, shared_w):
        return edge_mlp(e, head_ws, head_bs, shared_w, tail=tail)
    return fn
