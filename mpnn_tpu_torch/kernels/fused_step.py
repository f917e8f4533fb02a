"""Whole-step INFERENCE op of the shared-weight edge-network MPNN — the
serving path's one kernel launch.

Counterpart of mpnn_tpu/kernels/fused_step.py::make_fused_eval_op (Pallas
`_eval_kernel`). The CUDA kernel (csrc/fused_eval.cu) computes, per graph,
the A-form messages + A0 bias leakage + message bias, the folded message
norm, T × [GRU → folded state norm], and the gated readout, in one launch.

The TPU kernel's window plan (`fs_win`/`fs_ns`, 128-lane one-hot windows,
128-graph blocks) is a VMEM workaround and is not ported. In its place the
host attaches an index plan (graphs/batching.py::plan_fused_eval): a
stable destination-sorted edge order with row pointers, and each graph's
node and edge range.

`fused_eval` launches the kernel for CUDA tensors and runs the plain
version `fused_eval_reference` for CPU tensors — nothing else: there is
no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import torch

from mpnn_tpu_torch.graphs.batching import FusedEvalPlan
from mpnn_tpu_torch.ops.norm import fold_bn1d

BN_EPS = 1e-5
# the widest f and od the CUDA kernel is compiled for (csrc/fused_eval.cu)
MAX_WIDTH = 16

# launches of each kernel wrapper; reset with reset_launch_counts()
launch_counts: Dict[str, int] = {"fused_eval": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# folded norms
# ---------------------------------------------------------------------------

def fold_norm(p_bn, s_bn, mode: str, f: int, like: torch.Tensor):
    """(scale, shift) of a masked bn1d in eval mode — bn1d_apply's eval
    branch with eps OUTSIDE the sqrt: scale = w/(rv**0.5+eps), shift =
    b − rm·scale. 'none' folds to the identity affine."""
    if mode == "none":
        return (torch.ones(f, dtype=like.dtype, device=like.device),
                torch.zeros(f, dtype=like.dtype, device=like.device))
    if mode != "bn1d":
        raise NotImplementedError(
            f"norm mode {mode!r}: the stateless state norm needs per-step "
            "batch statistics over all nodes (ROADMAP queue 2, row 1)")
    return fold_bn1d(p_bn["weight"], p_bn["bias"], s_bn["running_mean"],
                     s_bn["running_var"], BN_EPS)


# ---------------------------------------------------------------------------
# plain version (CPU path; the card's comparison baseline)
# ---------------------------------------------------------------------------

def fused_eval_reference(amat, a0, mbias, h0, mask, node_graph, gru, ma_bn,
                         ma_state, bn, bn_state, ro, vid, src, dst,
                         plan: FusedEvalPlan, *, steps: int,
                         msg_norm: str = "bn1d", state_norm: str = "bn1d"):
    """Plain PyTorch version of the kernel, same arguments. h0 PRE-MASKED
    (N, f); mask (N, 1); weights in the JAX layout (in, out); gates r|z|n.
    Returns out (G, od). Only the plan's graph count is read: the plain
    version sums with index_add_ over all edges and nodes."""
    f = h0.shape[1]
    num_graphs = plan.graph_node_ptr.shape[0] - 1
    maw, mab = fold_norm(ma_bn, ma_state, msg_norm, f, h0)
    sw, sb = fold_norm(bn, bn_state, state_norm, f, h0)
    vid, src, dst = vid.long(), src.long(), dst.long()
    ng = node_graph.long()
    edge_msg = torch.bmm(amat[vid], h0[src].unsqueeze(-1)).squeeze(-1)
    agg = torch.zeros_like(h0).index_add_(0, dst, edge_msg)
    s = torch.zeros(num_graphs + 1, f, dtype=h0.dtype,
                    device=h0.device).index_add_(0, ng, h0)
    base = s[ng] @ a0.T
    msgs = (agg + base + mbias) * mask
    mb = (maw * msgs + mab) * mask
    gi = mb @ gru["w_ih"] + gru["b_ih"]
    gir, giz, gin = gi.split(f, dim=-1)
    h = h0 * mask
    for _ in range(steps):
        gh = h @ gru["w_hh"] + gru["b_hh"]
        ghr, ghz, ghn = gh.split(f, dim=-1)
        r = torch.sigmoid(gir + ghr) * mask
        z = torch.sigmoid(giz + ghz) * mask
        nn_ = torch.tanh(gin + r * ghn) * mask
        h = ((1.0 - z) * nn_ + z * h) * mask
        h = (sw * h + sb) * mask
    x = torch.cat([h, h0 * mask], dim=-1)
    gated = torch.softmax(x @ ro["i"]["w"] + ro["i"]["b"], dim=-1) \
        * (x @ ro["j"]["w"] + ro["j"]["b"]) * mask
    od = gated.shape[-1]
    out = torch.zeros(num_graphs + 1, od, dtype=h0.dtype,
                      device=h0.device).index_add_(0, ng, gated)
    return out[:num_graphs]


# ---------------------------------------------------------------------------
# the CUDA kernel's wrapper
# ---------------------------------------------------------------------------

_ARGTYPES_SET = False


def _lib():
    global _ARGTYPES_SET
    from mpnn_tpu_torch.kernels import build
    lib = build.load("fused_eval")
    if not _ARGTYPES_SET:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.mpnn_fused_eval.argtypes = [p] * 22 + [i] * 5 + [p]
        lib.mpnn_fused_eval.restype = i
        lib.mpnn_fused_eval_smem_bytes.argtypes = [i]
        lib.mpnn_fused_eval_smem_bytes.restype = i
        lib.mpnn_cuda_error_string.argtypes = [i]
        lib.mpnn_cuda_error_string.restype = ctypes.c_char_p
        _ARGTYPES_SET = True
    return lib


def _check(name, t, shape, device, dtype):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_batch_layout(h0, mask, node_graph, vid, src, dst, plan, k_vocab,
                       num_graphs: int) -> None:
    """The invariants the kernel relies on, checked with one device sync:
    node_graph non-decreasing over real nodes; padded nodes (and only they)
    carry node_graph == G and mask 0; real masks are 1; every edge stays
    inside one graph; vocab ids in range; the plan agrees with edge_dst
    and node_graph."""
    n, e, g = h0.shape[0], src.shape[0], num_graphs
    ng, s, d = node_graph.long(), src.long(), dst.long()
    order = plan.edge_order.long()
    # clamp every index before it indexes: an out-of-range gather would be
    # a device-side fault, not a flag
    s_c, d_c = s.clamp(0, n - 1), d.clamp(0, n - 1)
    o_c = order.clamp(0, max(e - 1, 0))
    d_sorted = d_c[o_c]
    bad = torch.stack([
        (ng[1:] < ng[:-1]).any(),
        ((ng > g) | (ng < 0)).any(),
        (mask[:, 0] != (ng < g).to(mask.dtype)).any(),
        (ng[s_c] != ng[d_c]).any(),
        ((vid < 0) | (vid >= k_vocab)).any(),
        ((s != s_c) | (d != d_c)).any(),
        ((order != o_c) | (torch.bincount(o_c, minlength=e) != 1)).any(),
        (d_sorted[1:] < d_sorted[:-1]).any(),
        ((plan.dst_ptr[0] != 0) | (plan.dst_ptr.long().diff()
                                   != torch.bincount(d_c, minlength=n))
         ).any(),
        ((plan.graph_node_ptr[0] != 0)
         | (plan.graph_node_ptr.long().diff()
            != torch.bincount(ng.clamp(0, g), minlength=g + 1)[:g])).any(),
    ])
    names = ["node_graph not non-decreasing",
             "node_graph out of [0, G]",
             "mask must be 1 on real nodes and 0 on padded nodes",
             "an edge crosses two graphs",
             "vid out of range",
             "src/dst out of range",
             "plan edge_order is not a permutation of the edges",
             "plan edge_order not destination-sorted",
             "plan dst_ptr disagrees with edge_dst",
             "plan graph_node_ptr disagrees with node_graph"]
    for flag, what in zip(bad.cpu().tolist(), names):
        if flag:
            raise ValueError(f"fused_eval: {what}")


def fused_eval(amat, a0, mbias, h0, mask, node_graph, gru, ma_bn, ma_state,
               bn, bn_state, ro, vid, src, dst, plan: FusedEvalPlan, *,
               steps: int, msg_norm: str = "bn1d", state_norm: str = "bn1d"):
    """Whole-step inference: out (G, od). Arguments in the JAX op's order
    (make_fused_eval_op), minus the TPU window plan, plus the index plan
    (tensors on the same device as h0). CPU tensors run the plain version;
    CUDA tensors launch the CUDA kernel or raise."""
    if state_norm == "stateless" or msg_norm not in ("bn1d", "none") \
            or state_norm not in ("bn1d", "none"):
        raise NotImplementedError(
            f"fused_eval: msg_norm={msg_norm!r}, state_norm={state_norm!r}; "
            "the kernel takes bn1d/none folded affines — the stateless "
            "state norm is still to port (ROADMAP queue 2, row 1)")
    device = h0.device
    if device.type == "cpu":
        return fused_eval_reference(
            amat, a0, mbias, h0, mask, node_graph, gru, ma_bn, ma_state, bn,
            bn_state, ro, vid, src, dst, plan, steps=steps,
            msg_norm=msg_norm, state_norm=state_norm)
    return launch_prepared(prepare_fused_eval(
        amat, a0, mbias, h0, mask, node_graph, gru, ma_bn, ma_state, bn,
        bn_state, ro, vid, src, dst, plan, steps=steps, msg_norm=msg_norm,
        state_norm=state_norm))


class PreparedLaunch(NamedTuple):
    """A checked kernel call: the C arguments (pointers into `keep`), the
    output it writes, and the tensors that must outlive the launch."""
    lib: ctypes.CDLL
    args: tuple
    out: torch.Tensor
    keep: tuple


def prepare_fused_eval(amat, a0, mbias, h0, mask, node_graph, gru, ma_bn,
                       ma_state, bn, bn_state, ro, vid, src, dst,
                       plan: FusedEvalPlan, *, steps: int,
                       msg_norm: str = "bn1d", state_norm: str = "bn1d",
                       check: bool = True) -> PreparedLaunch:
    """Checks (device, dtype, shape, contiguity and, with `check`, the
    batch layout), folds the norms and allocates the output of one CUDA
    launch. check=False only to time the bare launch on inputs already
    checked."""
    device = h0.device
    if device.type != "cuda":
        raise ValueError(f"fused_eval: unsupported device {device}")
    n, f = h0.shape
    k_vocab = amat.shape[0]
    od = ro["i"]["b"].shape[0]
    e = src.shape[0]
    num_graphs = plan.graph_node_ptr.shape[0] - 1
    if f > MAX_WIDTH or od > MAX_WIDTH:
        raise NotImplementedError(
            f"fused_eval: f={f}, od={od}; the kernel is compiled for widths "
            f"up to {MAX_WIDTH} (the lipo family's)")
    lib = _lib()
    maw, mab = fold_norm(ma_bn, ma_state, msg_norm, f, h0)
    sw, sb = fold_norm(bn, bn_state, state_norm, f, h0)
    floats = [("amat", amat, (k_vocab, f, f)), ("a0", a0, (f, f)),
              ("mbias", mbias, (f,)), ("h0", h0, (n, f)),
              ("w_ih", gru["w_ih"], (f, 3 * f)),
              ("w_hh", gru["w_hh"], (f, 3 * f)),
              ("b_ih", gru["b_ih"], (3 * f,)),
              ("b_hh", gru["b_hh"], (3 * f,)),
              ("ma_scale", maw, (f,)), ("ma_shift", mab, (f,)),
              ("s_scale", sw, (f,)), ("s_shift", sb, (f,)),
              ("ro.i.w", ro["i"]["w"], (2 * f, od)),
              ("ro.i.b", ro["i"]["b"], (od,)),
              ("ro.j.w", ro["j"]["w"], (2 * f, od)),
              ("ro.j.b", ro["j"]["b"], (od,)),
              ("mask", mask, (n, 1))]
    for name, t, shape in floats:
        _check(name, t, shape, device, torch.float32)
    ints = [("vid", vid, (e,)), ("src", src, (e,)), ("dst", dst, (e,)),
            ("node_graph", node_graph, (n,)),
            ("plan.edge_order", plan.edge_order, (e,)),
            ("plan.dst_ptr", plan.dst_ptr, (n + 1,)),
            ("plan.graph_node_ptr", plan.graph_node_ptr, (num_graphs + 1,))]
    for name, t, shape in ints:
        _check(name, t, shape, device, torch.int32)
    if check:
        check_batch_layout(h0, mask, node_graph, vid, src, dst, plan,
                           k_vocab, num_graphs)

    out = torch.empty(num_graphs, od, dtype=torch.float32, device=device)
    tensors = [t for _, t, _ in floats[:16]] + [
        vid, src, plan.edge_order, plan.dst_ptr, plan.graph_node_ptr, out]
    args = (*(t.data_ptr() for t in tensors), num_graphs, f, od, k_vocab,
            steps, torch.cuda.current_stream(device).cuda_stream)
    return PreparedLaunch(lib, args, out, tuple(tensors))


def launch_prepared(p: PreparedLaunch) -> torch.Tensor:
    """Launch the kernel on the stream captured by prepare_fused_eval;
    raise if the launch is refused. Counts the launch."""
    with torch.cuda.device(p.out.device):
        err = p.lib.mpnn_fused_eval(*p.args)
    if err != 0:
        raise RuntimeError("fused_eval kernel launch failed: "
                           + p.lib.mpnn_cuda_error_string(err).decode())
    launch_counts["fused_eval"] += 1
    return p.out
