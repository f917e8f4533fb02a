"""The readout + loss VJP of the split training backward (counterpart of
mpnn_tpu/kernels/fused_step.py::_ro_bwd_kernel, which both JAX families'
split backwards call).

Given the forward's out (G, od), the cotangents gl of the loss and gout
of out, and the last state h_T, per real node v of graph g:

    dout_g = gl·2(out_g − y_g)·gm_g/Σgm + gout_g
    x      = [h_T,v ‖ h0_v·m_v],  sm = softmax_od(x·W_i + b_i)
    djv    = dout_g ⊙ sm · m_v,    dsm = dout_g ⊙ (x·W_j + b_j) · m_v
    dpi    = sm ⊙ (dsm − Σ_o dsm·sm)
    gh_v   = W_i[:f]·dpi + W_j[:f]·djv,  dh0_v = (W_i[f:]·dpi + W_j[f:]·djv)·m_v
    dW_i   = Σ_v x_vᵀ·dpi_v, db_i = Σ_v dpi_v (dW_j, db_j likewise with djv)

h_T is rebuilt from the forward's stash: its pre-norm slot x̃ and that
slot's batch (mean, var), through the state norm (bn1d with its weight
and bias, the stateless norm, or none). The forward kernels do not write
h_T itself; rebuilding it costs one normalization per node, where
stashing it would cost the forward an (N, f) write on every step whether
or not the step splits.

CPU tensors run the plain version (ro_bwd_reference, autograd of the
plain readout); CUDA tensors launch csrc/ro_bwd.cu or raise.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from mpnn_tpu_torch.kernels import fused_step as K
from mpnn_tpu_torch.ops.norm import BN_EPS, STATELESS_EPS, VAR_CLAMP

# width buckets, narrowest first (kernels/build.py::WIDE, the split_bwd
# family): the per-step family's readout widths, which hold the shared
# family's (od <= 16 narrow, 64 wide)
BUCKETS = (("", dict(f=16, od=32)), ("f32", dict(f=32, od=128)))
# the state norm's mode as the kernel reads it (csrc/fused_psteps_common.
# cuh::Mode)
STATE_MODES = {"none": 0, "bn1d": 1, "stateless": 3}

launch_counts: Dict[str, int] = {"ro_bwd": 0}

_LEAVES = ("iw", "ib", "jw", "jb")


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def rebuild_state(x, stats, norm_w, norm_b, mask, state_norm: str):
    """h_T from its pre-norm slot x (N, f) and the slot's stats (2, f):
    mean, biased var — the forward's own normalization of that slot."""
    mean, var = stats[0], stats[1]
    if state_norm == "bn1d":
        xh = (x - mean) / (torch.sqrt(torch.clamp(var, min=VAR_CLAMP))
                           + BN_EPS)
        return (norm_w * xh + norm_b) * mask
    if state_norm == "stateless":
        return (x - mean) * mask / torch.sqrt(var + STATELESS_EPS)
    if state_norm == "none":
        return x * mask
    raise NotImplementedError(f"ro_bwd: state_norm={state_norm!r}")


def grad_layout(f: int, od: int) -> Dict[str, tuple]:
    """{leaf: (offset, shape)} of the kernel's flat weight gradient:
    dW_i (2f, od), db_i (od), dW_j (2f, od), db_j (od)."""
    out, off = {}, 0
    for name, shape in zip(_LEAVES, [(2 * f, od), (od,), (2 * f, od),
                                     (od,)]):
        out[name] = (off, shape)
        off += math.prod(shape)
    out["total"] = (off, ())
    return out


def _as_ro(flat: Dict[str, torch.Tensor]):
    return {"i": {"w": flat["iw"], "b": flat["ib"]},
            "j": {"w": flat["jw"], "b": flat["jb"]}}


def ro_bwd_reference(x, stats, norm_w, norm_b, h0, mask, node_graph, ro,
                     labels, gmask, out, gout, gl, *, state_norm: str):
    """The plain version: autograd of the plain readout (kernels/
    fused_step.py::_readout) on the rebuilt h_T for the cotangent dout.
    Returns (gh (N, f), dh0 (N, f), {'i': {w, b}, 'j': {w, b}})."""
    num_graphs = labels.shape[0]
    dout = (gl.reshape(()) * 2.0 * (out - labels[:, None])
            * gmask[:, None] / gmask.sum() + gout)
    with torch.enable_grad():
        h = rebuild_state(x, stats, norm_w, norm_b, mask,
                          state_norm).detach().requires_grad_()
        h0d = h0.detach().requires_grad_()
        w = {s: {k: v.detach().requires_grad_() for k, v in ro[s].items()}
             for s in ("i", "j")}
        o = K._readout(h, h0d, mask, node_graph.long(), w, num_graphs)
        leaves = [h, h0d, w["i"]["w"], w["i"]["b"], w["j"]["w"],
                  w["j"]["b"]]
        g = torch.autograd.grad(o, leaves, dout.detach())
    return g[0], g[1], _as_ro(dict(zip(_LEAVES, g[2:])))


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ro_bwd": {
        "mpnn_ro_bwd": ([_P] * 20 + [_I] * 6 + [_P], _I),
        "mpnn_ro_bwd_smem_bytes": ([], _I),
        "mpnn_ro_bwd_scratch_floats": ([_I, _I, _I], ctypes.c_longlong),
        "mpnn_ro_bwd_grid": ([_I], _I),
    },
}


def _lib(name: str = "ro_bwd", tag: str = ""):
    return K._lib(name, _SIGNATURES, tag)


def prepare_ro_bwd(x, stats, norm_w, norm_b, h0, mask, node_graph, ro,
                   labels, gmask, out, gout, gl, *, state_norm: str
                   ) -> K.PreparedLaunch:
    """One checked launch (the batch layout as the forward checked it).
    Outputs (gh (N, f), dh0 (N, f), the flat gradient of grad_layout)."""
    device = h0.device
    if device.type != "cuda":
        raise ValueError(f"ro_bwd: unsupported device {device}")
    if state_norm not in STATE_MODES:
        raise NotImplementedError(f"ro_bwd: state_norm={state_norm!r}")
    n, f = h0.shape
    g, od = out.shape
    tag = K.width_bucket("ro_bwd", BUCKETS, f=f, od=od)
    floats = [("x", x, (n, f)), ("stats", stats, (2, f)),
              ("norm_w", norm_w, (f,)), ("norm_b", norm_b, (f,)),
              ("h0", h0, (n, f)), ("mask", mask, (n, 1)),
              ("ro.i.w", ro["i"]["w"], (2 * f, od)),
              ("ro.i.b", ro["i"]["b"], (od,)),
              ("ro.j.w", ro["j"]["w"], (2 * f, od)),
              ("ro.j.b", ro["j"]["b"], (od,)),
              ("labels", labels, (g,)), ("gmask", gmask, (g,)),
              ("out", out, (g, od)), ("gout", gout, (g, od)),
              ("gl", gl, (1,))]
    for name, t, shape in floats:
        K._check(name, t, shape, device, torch.float32)
    K._check("node_graph", node_graph, (n,), device, torch.int32)
    lib = _lib("ro_bwd", tag)
    grid = K._grid(lib, "mpnn_ro_bwd_grid", n)
    kw = dict(dtype=torch.float32, device=device)
    gh = torch.empty(n, f, **kw)
    dh0 = torch.empty(n, f, **kw)
    dw = torch.empty(grad_layout(f, od)["total"][0], **kw)
    scratch = torch.empty(lib.mpnn_ro_bwd_scratch_floats(f, od, grid), **kw)
    keep = (x, stats, norm_w, norm_b, h0, mask, node_graph,
            K.ro_table(ro["i"]["w"], tag), ro["i"]["b"],
            K.ro_table(ro["j"]["w"], tag), ro["j"]["b"], labels, gmask,
            out, gout, gl, gh, dh0, dw, scratch)
    args = (*(t.data_ptr() for t in keep), n, g, f, od,
            STATE_MODES[state_norm], grid,
            torch.cuda.current_stream(device).cuda_stream)
    return K.PreparedLaunch("ro_bwd", lib.mpnn_ro_bwd,
                            lib.mpnn_cuda_error_string, args,
                            (gh, dh0, dw), keep, launch_counts)


def split_grads(dw: torch.Tensor, f: int, od: int):
    """The flat gradient as {'i': {w, b}, 'j': {w, b}} views."""
    return _as_ro({name: dw[off:off + math.prod(shape)].view(shape)
                   for name, (off, shape) in grad_layout(f, od).items()
                   if name != "total"})


def ro_bwd(x, stats, norm_w, norm_b, h0, mask, node_graph, ro, labels,
           gmask, out, gout, gl, *, state_norm: str):
    """(gh, dh0, {'i': {w, b}, 'j': {w, b}}) of the readout + loss for the
    cotangents gl (1,) and gout (G, od). x (N, f) is h_T's pre-norm slot,
    stats (2, f) its batch mean and var, norm_w / norm_b (f,) the state
    norm's affine (read in mode bn1d only). CPU tensors run the plain
    version; CUDA tensors launch the kernel or raise."""
    if h0.device.type == "cpu":
        return ro_bwd_reference(x, stats, norm_w, norm_b, h0, mask,
                                node_graph, ro, labels, gmask, out, gout, gl,
                                state_norm=state_norm)
    gh, dh0, dw = K.launch_prepared(prepare_ro_bwd(
        x, stats, norm_w, norm_b, h0, mask, node_graph, ro, labels, gmask,
        out, gout, gl, state_norm=state_norm))
    return gh, dh0, split_grads(dw, h0.shape[1], out.shape[1])
