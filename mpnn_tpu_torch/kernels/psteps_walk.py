"""The per-step family's reverse walk through its recurrence, the middle of
its split training backward (counterpart of mpnn_tpu/kernels/
fused_psteps.py::_ps_stream_walk_kernel).

The forward of the per-step family (kernels/fused_psteps.py), from the
masked messages m_t of its T message networks (the stash's slots
0..T−1):

    h = h0·mask;  for t < T: mb_t = msgnorm_t(m_t);
                             h̃_t = GRU(mb_t·W_ih + b_ih, h);  h = statenorm_t(h̃_t)

msgnorm_t is the masked bn1d of step t (batch statistics) or none;
statenorm_t the masked bn1d of step t, the stateless norm (batch
statistics, no affine) or none. Given the cotangent gh of h_T it
returns dh0 of the chain, dm_t (T, N, f) — the cotangents of the masked
messages, which the message VJP (kernels/msg_bwd.py) takes — and the
gradients of W_ih, W_hh, b_ih, b_hh and the per-step norms (T, f).

CPU tensors run the plain version (ps_walk_bwd_reference, autograd of
the plain chain from the stashed messages); CUDA tensors launch
csrc/ps_walk_bwd.cu or raise.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from mpnn_tpu_torch.kernels import fused_step as K
from mpnn_tpu_torch.ops.norm import bn1d_train, mask_batch_norm_stats

# width buckets, narrowest first (kernels/build.py::WIDE, the split_bwd
# family): the per-step kernels' (kernels/fused_psteps.py::BUCKETS)
BUCKETS = (("", dict(f=16, steps=8)), ("f32", dict(f=32, steps=8)))
# norm modes as the kernel reads them (csrc/fused_psteps_common.cuh::Mode)
MSG_MODES = {"none": 0, "bn1d": 1}
STATE_MODES = {"none": 0, "bn1d": 1, "stateless": 3}

launch_counts: Dict[str, int] = {"ps_walk_bwd": 0}

# the flat gradient's leaves, in csrc/ps_walk_bwd.cu's WalkLayout order
LEAVES = ("w_ih", "w_hh", "b_ih", "b_hh", "ma_w", "ma_b", "bn_w", "bn_b")


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def grad_layout(f: int, steps: int) -> Dict[str, tuple]:
    T = steps
    out, off = {}, 0
    for name, shape in zip(LEAVES, [(f, 3 * f), (f, 3 * f), (3 * f,),
                                    (3 * f,), (T, f), (T, f), (T, f),
                                    (T, f)]):
        out[name] = (off, shape)
        off += math.prod(shape)
    out["total"] = (off, ())
    return out


def split_grads(dw: torch.Tensor, f: int, steps: int):
    return {name: dw[off:off + math.prod(shape)].view(shape)
            for name, (off, shape) in grad_layout(f, steps).items()
            if name != "total"}


def ps_walk_bwd_reference(gh, h0, mask, htil, weights, *, steps: int,
                          msg_norm: str, state_norm: str):
    """The plain version: autograd of the plain per-step chain (as
    kernels/fused_psteps.py::fused_psteps_reference runs it) from the
    stashed messages htil[:T]. `weights` maps LEAVES (at least) to
    tensors, the norms stacked (T, f). Returns (dh0 (N, f), dmsgs (T, N,
    f), {leaf: gradient}), zeros for a leaf the modes leave out."""
    T = steps
    with torch.enable_grad():
        m = htil[:T].detach().requires_grad_()
        h0d = h0.detach().requires_grad_()
        w = {k: weights[k].detach().requires_grad_() for k in LEAVES}
        gru = {k: w[k] for k in ("w_ih", "w_hh", "b_ih", "b_hh")}
        h = h0d * mask
        for t in range(T):
            mb = (bn1d_train(m[t], mask, w["ma_w"][t], w["ma_b"][t])[0]
                  if msg_norm == "bn1d" else m[t])
            h = K._gru(gru, mb @ gru["w_ih"] + gru["b_ih"], h, mask)
            if state_norm == "bn1d":
                h = bn1d_train(h, mask, w["bn_w"][t], w["bn_b"][t])[0]
            elif state_norm == "stateless":
                h = mask_batch_norm_stats(h, mask)[0]
        leaves = [m, h0d, *(w[k] for k in LEAVES)]
        g = torch.autograd.grad(h, leaves, gh.detach(), allow_unused=True)
    g = [torch.zeros_like(x) if d is None else d for x, d in zip(leaves, g)]
    return g[1], g[0], dict(zip(LEAVES, g[2:]))


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ps_walk_bwd": {
        "mpnn_ps_walk_bwd": ([_P] * 24 + [_I] * 8 + [_P], _I),
        "mpnn_ps_walk_bwd_smem_bytes": ([_I], _I),
        "mpnn_ps_walk_bwd_layout": ([_I, _I, _P], None),
        "mpnn_ps_walk_bwd_scratch_floats": ([_I] * 4, ctypes.c_longlong),
        "mpnn_ps_walk_bwd_grid": ([_I, _I], _I),
    },
}


def _lib(name: str = "ps_walk_bwd", tag: str = ""):
    return K._lib(name, _SIGNATURES, tag)


def prepare_ps_walk_bwd(weights, gh, h0, htil, stats, graph_node_ptr, *,
                        steps: int, msg_norm: str, state_norm: str
                        ) -> K.PreparedLaunch:
    """One checked launch on the forward's residuals (the batch layout as
    the forward checked it). `weights` is the per-step kernels' (name,
    tensor) list (kernels/fused_psteps.py::flat_weights), of which the
    kernel reads the GRU's and the norms'. Outputs (dh0 (N, f), dmsgs
    (T, N, f), the flat gradient of grad_layout)."""
    device = h0.device
    if device.type != "cuda":
        raise ValueError(f"ps_walk_bwd: unsupported device {device}")
    if msg_norm not in MSG_MODES or state_norm not in STATE_MODES:
        raise NotImplementedError(
            f"ps_walk_bwd: msg_norm={msg_norm!r}, state_norm={state_norm!r}")
    n, f = h0.shape
    T = steps
    g = graph_node_ptr.shape[0] - 1
    tag = K.width_bucket("ps_walk_bwd", BUCKETS, f=f, steps=T)
    w = dict(weights)
    for name, shape in [("w_ih", (f, 3 * f)), ("w_hh", (f, 3 * f)),
                        ("b_ih", (3 * f,)), ("b_hh", (3 * f,)),
                        ("ma_w", (T, f)), ("ma_b", (T, f)),
                        ("bn_w", (T, f)), ("bn_b", (T, f)),
                        ("a0", (T, f, f)), ("mbias", (T, f))]:
        K._check(name, w[name], shape, device, torch.float32)
    for name, t, shape in [("gh", gh, (n, f)), ("h0", h0, (n, f)),
                           ("htil", htil, (2 * T, n, f)),
                           ("stats", stats, (2 * T, 2, f))]:
        K._check(name, t, shape, device, torch.float32)
    K._check("graph_node_ptr", graph_node_ptr, (g + 1,), device,
             torch.int32)
    lib = _lib("ps_walk_bwd", tag)
    layout = grad_layout(f, T)
    c_layout = (ctypes.c_int * 9)()
    lib.mpnn_ps_walk_bwd_layout(f, T, c_layout)
    if [v[0] for v in layout.values()] != list(c_layout):
        raise RuntimeError("ps_walk_bwd: the gradient layout of the built "
                           "library disagrees with grad_layout")
    grid = K._grid(lib, "mpnn_ps_walk_bwd_grid", T, n)
    kw = dict(dtype=torch.float32, device=device)
    dh0 = torch.empty(n, f, **kw)
    dmsgs = torch.empty(T, n, f, **kw)
    dw = torch.empty(layout["total"][0], **kw)
    scratch = torch.empty(lib.mpnn_ps_walk_bwd_scratch_floats(
        n, f, T, grid), **kw)
    keep = (*(t for _, t in weights), gh, h0, htil, stats, graph_node_ptr,
            dh0, dmsgs, dw, scratch)
    args = (*(t.data_ptr() for t in keep), n, g, f, w["ro_ib"].shape[0], T,
            MSG_MODES[msg_norm], STATE_MODES[state_norm], grid,
            torch.cuda.current_stream(device).cuda_stream)
    return K.PreparedLaunch("ps_walk_bwd", lib.mpnn_ps_walk_bwd,
                            lib.mpnn_cuda_error_string, args,
                            (dh0, dmsgs, dw), keep, launch_counts)


def ps_walk_bwd(gh, h0, mask, htil, stats, graph_node_ptr, weights, *,
                steps: int, msg_norm: str, state_norm: str):
    """(dh0 (N, f), dmsgs (T, N, f), {leaf: gradient}) of the per-step
    chain for the cotangent gh of h_T, on the forward's stash htil (2T, N,
    f) and statistics (2T, 2, f). `weights` is the per-step kernels'
    (name, tensor) list (kernels/fused_psteps.py::flat_weights: the norms
    stacked (T, f)). CPU tensors run the plain version; CUDA tensors
    launch the kernel or raise."""
    if h0.device.type == "cpu":
        return ps_walk_bwd_reference(gh, h0, mask, htil, dict(weights),
                                     steps=steps, msg_norm=msg_norm,
                                     state_norm=state_norm)
    dh0, dmsgs, dw = K.launch_prepared(prepare_ps_walk_bwd(
        weights, gh, h0, htil, stats, graph_node_ptr, steps=steps,
        msg_norm=msg_norm, state_norm=state_norm))
    return dh0, dmsgs, split_grads(dw, h0.shape[1], steps)
