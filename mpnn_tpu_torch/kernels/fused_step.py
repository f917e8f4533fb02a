"""Whole-step ops of the shared-weight edge-network MPNN: the serving
path's inference kernel and the training path's forward and backward
kernels.

  * fused_eval — counterpart of mpnn_tpu/kernels/fused_step.py::
    make_fused_eval_op (Pallas `_eval_kernel`). The CUDA kernel
    (csrc/fused_eval.cu) computes, per graph, the A-form messages + A0 bias
    leakage + message bias, the folded message norm, T × [GRU → folded
    state norm], and the gated readout, in one launch. The stateless state
    norm normalizes by the batch's own statistics after every step, so
    that mode launches a kernel of its own (`fused_eval_stateless`, the
    training forward's body without the loss, on its routes).
  * fused_step — counterpart of make_fused_step_op (Pallas `_fwd_kernel`
    and its two backwards): the same chain with the masked bn1d norms in
    training mode (batch statistics over all real nodes, per step) and the
    masked-MSE loss, as a torch.autograd.Function whose forward is one
    CUDA launch (csrc/fused_step_fwd.cu, on the route of fwd_launch_shape)
    and whose backward
    takes the JAX package's route for the batch (kernels/split_bwd.py):
    the whole backward in one launch (`_full_bwd_kernel` →
    csrc/fused_step_bwd.cu), or past its node count, with bn1d norms, the
    split one — the readout VJP (`_ro_bwd_kernel` → kernels/
    readout_bwd.py), the recurrence VJP (kernels/recurrence.py) and the
    message VJP (`_msg_bwd_kernel` → kernels/msg_bwd.py).

The TPU kernel's window plan (`fs_win`/`fs_ns`, 128-lane one-hot windows,
128-graph blocks) is a VMEM workaround and is not ported. In its place the
host attaches an index plan (graphs/batching.py::plan_fused_eval): a
stable destination-sorted edge order with row pointers, and each graph's
node and edge range. The training backward also walks each node's
outgoing edges: that source-sorted order is derived from edge_src on the
device at launch (source_order), so serving batches do not carry it.

Each op launches its kernels for CUDA tensors and runs its plain version
(fused_eval_reference, fused_step_reference under autograd) for CPU
tensors — nothing else: there is no fallback from a kernel to its plain
version.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional

import torch

from mpnn_tpu_torch.graphs.batching import FusedEvalPlan
from mpnn_tpu_torch.kernels.split_bwd import route
from mpnn_tpu_torch.ops.norm import (BN_EPS, bn1d_train, fold_bn1d,
                                     mask_batch_norm_stats)

# width buckets of the CUDA kernels, narrowest first: (tag, the most of
# each width the bucket's build takes). Each is its own build of
# csrc/fused_eval.cu and fused_step_{fwd,bwd}.cu (kernels/build.py::WIDE);
# a batch takes the narrowest that holds it (width_bucket). lipo's od =
# 2·afm stays within 64 at f <= 32; the basic shell's od = 4·afm takes
# od 64 past afm 4 and od 128 past afm 16.
BUCKETS = (("", dict(f=16, od=16)), ("o64", dict(f=16, od=64)),
           ("f32", dict(f=32, od=64)), ("o128", dict(f=32, od=128)))
MAX_WIDTH = BUCKETS[-1][1]["f"]
# the most recurrent steps the training kernels take (kMaxSteps)
MAX_STEPS = 32

# norm modes as the kernels read them (csrc/fused_train_common.cuh::Mode)
NONE, BATCH_BN, AFFINE, STATELESS = 0, 1, 2, 3
MSG_MODES = ("bn1d", "none")
STATE_MODES = ("bn1d", "stateless", "none")
_STATE_MODE = {"bn1d": BATCH_BN, "stateless": STATELESS, "none": NONE}

# launches of each kernel wrapper; reset with reset_launch_counts()
launch_counts: Dict[str, int] = {"fused_eval": 0,
                                 "fused_eval_stateless": 0,
                                 "fused_step_fwd": 0, "fused_step_bwd": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# folded norms
# ---------------------------------------------------------------------------

def fold_norm(p_bn, s_bn, mode: str, f: int, like: torch.Tensor):
    """(scale, shift) of a masked bn1d in eval mode — bn1d_apply's eval
    branch with eps OUTSIDE the sqrt: scale = w/(rv**0.5+eps), shift =
    b − rm·scale. 'none' and 'stateless' fold to the identity affine (the
    stateless norm has no running state: it normalizes by the batch's own
    statistics, in the kernel)."""
    if mode != "bn1d":
        return (torch.ones(f, dtype=like.dtype, device=like.device),
                torch.zeros(f, dtype=like.dtype, device=like.device))
    return fold_bn1d(p_bn["weight"], p_bn["bias"], s_bn["running_mean"],
                     s_bn["running_var"], BN_EPS)


# ---------------------------------------------------------------------------
# plain version (CPU path; the card's comparison baseline)
# ---------------------------------------------------------------------------

def _messages(amat, a0, mbias, h0, ng, vid, src, dst, num_graphs: int):
    """m_d = Σ_{e: dst_e = d} A[vid_e]·h0[src_e] + A0·S_graph(d) + mbias."""
    vid, src, dst = vid.long(), src.long(), dst.long()
    edge_msg = torch.bmm(amat[vid], h0[src].unsqueeze(-1)).squeeze(-1)
    agg = torch.zeros_like(h0).index_add(0, dst, edge_msg)
    s = h0.new_zeros((num_graphs + 1, h0.shape[1])).index_add(0, ng, h0)
    return agg + s[ng] @ a0.T + mbias


def _gru(gru, gi, h, mask):
    """One masked GRU step from the precomputed input gates gi."""
    f = h.shape[1]
    gir, giz, gin = gi.split(f, dim=-1)
    ghr, ghz, ghn = (h @ gru["w_hh"] + gru["b_hh"]).split(f, dim=-1)
    r = torch.sigmoid(gir + ghr) * mask
    z = torch.sigmoid(giz + ghz) * mask
    nn_ = torch.tanh(gin + r * ghn) * mask
    return ((1.0 - z) * nn_ + z * h) * mask


def _readout(h, h0, mask, ng, ro, num_graphs: int):
    """Per-graph sums of softmax_od(W_i·[h ‖ h0] + b_i) ⊙ (W_j·[h ‖ h0] + b_j)."""
    x = torch.cat([h, h0 * mask], dim=-1)
    gated = torch.softmax(x @ ro["i"]["w"] + ro["i"]["b"], dim=-1) \
        * (x @ ro["j"]["w"] + ro["j"]["b"]) * mask
    out = gated.new_zeros((num_graphs + 1, gated.shape[-1]))
    return out.index_add(0, ng, gated)[:num_graphs]


def _check_modes(who: str, msg_norm: str, state_norm: str) -> None:
    if msg_norm not in MSG_MODES or state_norm not in STATE_MODES:
        raise ValueError(
            f"{who}: msg_norm={msg_norm!r}, state_norm={state_norm!r}; the "
            f"kernels take msg norm in {MSG_MODES} and state norm in "
            f"{STATE_MODES}")


def fused_eval_reference(amat, a0, mbias, h0, mask, node_graph, gru, ma_bn,
                         ma_state, bn, bn_state, ro, vid, src, dst,
                         plan: FusedEvalPlan, *, steps: int,
                         msg_norm: str = "bn1d", state_norm: str = "bn1d"):
    """Plain PyTorch version of the eval kernel, same arguments. h0
    PRE-MASKED (N, f); mask (N, 1); weights in the JAX layout (in, out);
    gates r|z|n. Returns out (G, od). Only the plan's graph count is read:
    the plain version sums with index_add over all edges and nodes. The
    stateless state norm takes this batch's statistics after every step."""
    _check_modes("fused_eval", msg_norm, state_norm)
    f = h0.shape[1]
    num_graphs = plan.graph_node_ptr.shape[0] - 1
    maw, mab = fold_norm(ma_bn, ma_state, msg_norm, f, h0)
    sw, sb = fold_norm(bn, bn_state, state_norm, f, h0)
    ng = node_graph.long()
    msgs = _messages(amat, a0, mbias, h0, ng, vid, src, dst,
                     num_graphs) * mask
    mb = (maw * msgs + mab) * mask
    gi = mb @ gru["w_ih"] + gru["b_ih"]
    h = h0 * mask
    for _ in range(steps):
        h = _gru(gru, gi, h, mask)
        if state_norm == "stateless":
            h = mask_batch_norm_stats(h, mask)[0]
        else:
            h = (sw * h + sb) * mask
    return _readout(h, h0, mask, ng, ro, num_graphs)


def fused_step_reference(amat, a0, mbias, h0, mask, node_graph, gru, ma_bn,
                         bn, ro, labels, gmask, vid, src, dst,
                         plan: FusedEvalPlan, *, steps: int,
                         msg_norm: str = "bn1d", state_norm: str = "bn1d",
                         stash=None):
    """Plain PyTorch version of the training forward kernel (and, through
    autograd, of the backward kernel): make_fused_step_op's arguments
    minus the TPU window plan, plus the index plan (only its graph count is
    read). h0 PRE-MASKED. Returns (loss, out (G, od), (ma_mean, ma_var),
    [(mean_t, var_t)] × steps); the statistics are detached (they feed the
    running EMAs only), zeros for a norm in mode 'none' (the stateless
    norm's are its batch mean and biased var, which feed no EMA).
    loss = Σ_g Σ_o (out_go − y_g)²·gm_g / Σ gm. A list `stash` receives
    the forward kernel's residuals: the masked messages, then each step's
    pre-norm state."""
    _check_modes("fused_step", msg_norm, state_norm)
    f = h0.shape[1]
    num_graphs = plan.graph_node_ptr.shape[0] - 1
    ng = node_graph.long()
    zero = h0.new_zeros(f)
    msgs = _messages(amat, a0, mbias, h0, ng, vid, src, dst,
                     num_graphs) * mask
    if stash is not None:
        stash.append(msgs)
    if msg_norm == "bn1d":
        mb, ma_stats = bn1d_train(msgs, mask, ma_bn["weight"], ma_bn["bias"])
    else:
        mb, ma_stats = msgs, (zero, zero)
    gi = mb @ gru["w_ih"] + gru["b_ih"]
    h = h0 * mask
    step_stats = []
    for _ in range(steps):
        h = _gru(gru, gi, h, mask)
        if stash is not None:
            stash.append(h)
        if state_norm == "bn1d":
            h, st = bn1d_train(h, mask, bn["weight"], bn["bias"])
        elif state_norm == "stateless":
            h, st = mask_batch_norm_stats(h, mask)
        else:
            st = (zero, zero)
        step_stats.append(tuple(x.detach() for x in st))
    out = _readout(h, h0, mask, ng, ro, num_graphs)
    loss = (((out - labels[:, None]) ** 2) * gmask[:, None]).sum() \
        / gmask.sum()
    return (loss, out, tuple(x.detach() for x in ma_stats), step_stats)


# ---------------------------------------------------------------------------
# the CUDA kernels' libraries and checks
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: (argtypes, restype) of each library's entry points
_SIGNATURES = {
    "fused_eval": {
        "mpnn_fused_eval": ([_P] * 24 + [_I] * 11 + [_P], _I),
        "mpnn_fused_eval_smem_bytes": ([_I] * 4, _I),
        "mpnn_fused_eval_scratch_floats": ([_I] * 5, ctypes.c_longlong),
        "mpnn_fused_eval_max_grid": ([_I], _I),
        "mpnn_fused_eval_stateless": ([_P] * 23 + [_I] * 13 + [_P], _I),
        "mpnn_fused_eval_stateless_smem_bytes": ([_I] * 5, _I),
        "mpnn_fused_eval_stateless_scratch_floats": ([_I] * 5,
                                                     ctypes.c_longlong),
        "mpnn_fused_eval_stateless_max_grid": ([_I], _I),
    },
    "fused_step_fwd": {
        "mpnn_fused_step_fwd": ([_P] * 30 + [_I] * 14 + [_P], _I),
        "mpnn_fused_step_fwd_smem_bytes": ([_I] * 5, _I),
        "mpnn_fused_step_fwd_scratch_floats": ([_I] * 5, ctypes.c_longlong),
        "mpnn_fused_step_fwd_counters": ([], _I),
        "mpnn_fused_step_fwd_max_grid": ([_I], _I),
    },
    "fused_step_bwd": {
        "mpnn_fused_step_bwd": ([_P] * 36 + [_I] * 14 + [_P], _I),
        "mpnn_fused_step_bwd_smem_bytes": ([_I] * 4, _I),
        "mpnn_fused_step_bwd_layout": ([_I, _I, _I, _P], None),
        "mpnn_fused_step_bwd_scratch_floats": ([_I] * 7, ctypes.c_longlong),
        "mpnn_fused_step_bwd_sync_words": ([_P], _I),
        "mpnn_fused_step_bwd_max_grid": ([_I], _I),
    },
}
_READY = set()


def _lib(name: str = "fused_eval", signatures=None, tag: str = ""):
    """The loaded library of source `name` in width bucket `tag` (built at
    first use), its C functions typed from `signatures` (default: this
    module's _SIGNATURES)."""
    from mpnn_tpu_torch.kernels import build
    lib = build.load(name, tag)
    if (name, tag) not in _READY:
        for fn, (args, res) in (signatures or _SIGNATURES)[name].items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = res
        lib.mpnn_cuda_error_string.argtypes = [_I]
        lib.mpnn_cuda_error_string.restype = ctypes.c_char_p
        _READY.add((name, tag))
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
                       num_graphs: int, who: str = "fused_eval") -> None:
    """The invariants the kernels rely on, checked with one device sync:
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
            raise ValueError(f"{who}: {what}")


def width_bucket(who: str, buckets, **widths) -> str:
    """The tag of the narrowest of `buckets` ((tag, {width: most}),
    narrowest first; each kernel module's BUCKETS) that holds every one of
    `widths`; past all of them, NotImplementedError naming the widths."""
    for tag, most in buckets:
        if all(widths[k] <= v for k, v in most.items()):
            return tag
    raise NotImplementedError(
        f"{who}: " + ", ".join(f"{k}={v}" for k, v in widths.items())
        + "; the kernels are compiled for widths up to " + " or ".join(
            ", ".join(f"{k}={v}" for k, v in most.items())
            for _, most in buckets))


def bucket_of(who: str, tag: Optional[str], **widths) -> str:
    """`tag` when its bucket of BUCKETS holds `widths` (a measurement's
    choice), else ValueError; with tag None the narrowest bucket that
    holds them (width_bucket)."""
    if tag is None:
        return width_bucket(who, BUCKETS, **widths)
    most = dict(BUCKETS)[tag]
    if not all(widths[k] <= v for k, v in most.items()):
        raise ValueError(f"{who}: bucket {tag!r} ({most}) does not hold "
                         f"{widths}")
    return tag


def step_tables(amat, ro_iw, ro_jw, tag: str):
    """(amat, ro_iw, ro_jw) as the shared family's bucket `tag` reads
    them: the vocab tables zero-padded to (K, 32, 32) past f 16
    (fused_train_common.cuh::kVocabInSmem), the readout weights to
    (2·32, od 128) past od 64 (kRoInSmem)."""
    most = dict(BUCKETS)[tag]
    if most["f"] > 16:
        amat = vocab_table(amat, tag, most["f"])
    if most["od"] > 64:
        ro_iw, ro_jw = (ro_table(t, tag, most["f"], most["od"])
                        for t in (ro_iw, ro_jw))
    return amat, ro_iw, ro_jw


def vocab_table(t: torch.Tensor, tag: str, fp: int = 32) -> torch.Tensor:
    """A (..., f, f) vocab table as a wide bucket's kernels read it: zero-
    padded to (..., fp, fp) in device memory, which the block's shared
    memory could not hold at fp 32 (csrc/fused_train_common.cuh::
    kVocabInSmem). The narrow build stages the table itself."""
    if not tag:
        return t
    f = t.shape[-1]
    return torch.nn.functional.pad(t, (0, fp - f, 0, fp - f)).contiguous()


def ro_table(t: torch.Tensor, tag: str, fp: int = 32, odw: int = 128):
    """A (2f, od) readout weight as the per-step family's and the split
    backward's wide buckets read it: each half [h | h0] zero-padded to fp
    rows, od to odw columns, in device memory (csrc/
    fused_psteps_common.cuh::kRoInSmem, csrc/ro_bwd.cu::kWInSmem). The
    narrow builds stage the weight themselves."""
    if not tag:
        return t
    f, od = t.shape[0] // 2, t.shape[1]
    pad = lambda x: torch.nn.functional.pad(x, (0, odw - od, 0, fp - f))
    return torch.cat([pad(t[:f]), pad(t[f:])]).contiguous()


def _check_plan(plan, device, n, e, num_graphs):
    ints = [("plan.edge_order", plan.edge_order, (e,)),
            ("plan.dst_ptr", plan.dst_ptr, (n + 1,)),
            ("plan.graph_node_ptr", plan.graph_node_ptr, (num_graphs + 1,))]
    for name, t, shape in ints:
        _check(name, t, shape, device, torch.int32)


def source_order(src: torch.Tensor, n: int):
    """(edge ids stably sorted by source, row pointers (n+1,)), int32, on
    src's device without a host sync: the backward kernel's transposed
    message sum walks each node's outgoing edges in batch order. Derived
    from the checked edge_src, so it needs no layout check of its own."""
    s_sorted, order = torch.sort(src, stable=True)
    nodes = torch.arange(n + 1, dtype=src.dtype, device=src.device)
    ptr = torch.searchsorted(s_sorted, nodes, out_int32=True)
    return order.to(torch.int32), ptr


def records_grad(*tensors) -> bool:
    """True when autograd records an op on `tensors`: grad mode is on and
    one of them requires grad. A Function's needs_input_grad ignores
    torch.no_grad, so the ops decide this before `apply`: serving writes
    no residuals for a backward that never runs."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class PreparedLaunch(NamedTuple):
    """A checked kernel call: the launch-count key, the C function, its
    arguments (pointers into `keep`), what it writes, the tensors that
    must outlive the launch, and the launch-count table it adds to."""
    name: str
    fn: object
    error_string: object
    args: tuple
    out: object
    keep: tuple
    counts: Dict[str, int] = launch_counts


def launch_prepared(p: PreparedLaunch):
    """Launch a prepared kernel call on the stream captured when it was
    prepared; raise if the launch is refused. Counts the launch."""
    device = (p.out[0] if isinstance(p.out, tuple) else p.out).device
    with torch.cuda.device(device):
        err = p.fn(*p.args)
    if err != 0:
        raise RuntimeError(f"{p.name} kernel launch failed: "
                           + p.error_string(err).decode())
    p.counts[p.name] += 1
    return p.out


# ---------------------------------------------------------------------------
# fused_eval: the serving kernel
# ---------------------------------------------------------------------------

def fused_eval(amat, a0, mbias, h0, mask, node_graph, gru, ma_bn, ma_state,
               bn, bn_state, ro, vid, src, dst, plan: FusedEvalPlan, *,
               steps: int, msg_norm: str = "bn1d", state_norm: str = "bn1d"):
    """Whole-step inference: out (G, od). Arguments in the JAX op's order
    (make_fused_eval_op), minus the TPU window plan, plus the index plan
    (tensors on the same device as h0). CPU tensors run the plain version;
    CUDA tensors launch the CUDA kernel (the folded norms' on the free
    route of eval_launch_shape, the stateless state norm's on the training
    forward's routes) or raise."""
    _check_modes("fused_eval", msg_norm, state_norm)
    if h0.device.type == "cpu":
        return fused_eval_reference(
            amat, a0, mbias, h0, mask, node_graph, gru, ma_bn, ma_state, bn,
            bn_state, ro, vid, src, dst, plan, steps=steps,
            msg_norm=msg_norm, state_norm=state_norm)
    return launch_prepared(prepare_fused_eval(
        amat, a0, mbias, h0, mask, node_graph, gru, ma_bn, ma_state, bn,
        bn_state, ro, vid, src, dst, plan, steps=steps, msg_norm=msg_norm,
        state_norm=state_norm))


def prepare_fused_eval(amat, a0, mbias, h0, mask, node_graph, gru, ma_bn,
                       ma_state, bn, bn_state, ro, vid, src, dst,
                       plan: FusedEvalPlan, *, steps: int,
                       msg_norm: str = "bn1d", state_norm: str = "bn1d",
                       check: bool = True, tag: Optional[str] = None,
                       prof=None, floor: bool = False) -> PreparedLaunch:
    """Checks (device, dtype, shape, contiguity and, with `check`, the
    batch layout), folds the norms and allocates the output of one CUDA
    launch of the training forward's body: with folded norms on the free
    route (eval_launch_shape on the card, device_eval_shape),
    for the stateless state norm on the training forward's routes
    (fwd_launch_shape). check=False only to time the bare launch on inputs
    already checked; `tag` forces a width bucket that holds the batch (to
    time one bucket against another); `prof` and `floor` as
    prepare_fused_step_fwd's."""
    _check_modes("fused_eval", msg_norm, state_norm)
    device = h0.device
    if device.type != "cuda":
        raise ValueError(f"fused_eval: unsupported device {device}")
    n, f = h0.shape
    k_vocab = amat.shape[0]
    od = ro["i"]["b"].shape[0]
    e = src.shape[0]
    num_graphs = plan.graph_node_ptr.shape[0] - 1
    tag = bucket_of("fused_eval", tag, f=f, od=od)
    lib = _lib("fused_eval", tag=tag)
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
    for name, t in [("vid", vid), ("src", src), ("dst", dst)]:
        _check(name, t, (e,), device, torch.int32)
    _check("node_graph", node_graph, (n,), device, torch.int32)
    _check_plan(plan, device, n, e, num_graphs)
    if check:
        check_batch_layout(h0, mask, node_graph, vid, src, dst, plan,
                           k_vocab, num_graphs)
    _check_prof(prof, FWD_PROF_SLOTS)

    out = torch.empty(num_graphs, od, dtype=torch.float32, device=device)
    amat_k, riw, rjw = step_tables(amat, ro["i"]["w"], ro["j"]["w"], tag)
    plan_t = [vid, src, plan.edge_order, plan.dst_ptr, plan.graph_node_ptr,
              out]
    stream = torch.cuda.current_stream(device).cuda_stream
    if state_norm == "stateless":
        shape = device_fwd_shape(n, tag, k_vocab, steps, True, device,
                                 "fused_eval")
        scratch = torch.empty(
            lib.mpnn_fused_eval_stateless_scratch_floats(
                n, e, num_graphs, steps, shape.grid),
            dtype=torch.float32, device=device)
        counters = _fwd_counters(shape, device, stream)
        tensors = [amat_k] + [t for _, t, _ in floats[1:10]] + [
            riw, ro["i"]["b"], rjw, ro["j"]["b"]] + plan_t + [scratch]
        args = (*(t.data_ptr() for t in tensors), _ptr(counters),
                _ptr(prof), n, num_graphs, e, f, od, k_vocab, steps,
                AFFINE if msg_norm == "bn1d" else NONE,
                int(shape.route == "grid"), shape.grid, shape.ncap,
                shape.ecap, int(floor), stream)
        return PreparedLaunch("fused_eval_stateless_floor" if floor
                              else "fused_eval_stateless",
                              lib.mpnn_fused_eval_stateless,
                              lib.mpnn_cuda_error_string, args, out,
                              tuple(tensors) + (counters, prof),
                              floor_counts if floor else launch_counts)
    shape = device_eval_shape(n, tag, k_vocab, steps, device, num_graphs)
    scratch = torch.empty(lib.mpnn_fused_eval_scratch_floats(
        n, e, num_graphs, steps, shape.grid), dtype=torch.float32,
        device=device)
    tensors = [amat_k] + [t for _, t, _ in floats[1:12]] + [
        riw, ro["i"]["b"], rjw, ro["j"]["b"]] + plan_t + [scratch]
    args = (*(t.data_ptr() for t in tensors), _ptr(prof), n, num_graphs, e,
            f, od, k_vocab, steps, shape.grid, shape.ncap, shape.ecap,
            int(floor), stream)
    return PreparedLaunch("fused_eval_floor" if floor else "fused_eval",
                          lib.mpnn_fused_eval, lib.mpnn_cuda_error_string,
                          args, out, tuple(tensors) + (prof,),
                          floor_counts if floor else launch_counts)


# ---------------------------------------------------------------------------
# fused_step: the training forward and backward kernels
# ---------------------------------------------------------------------------

_GRAD_LEAVES = ("amat", "a0", "mbias", "w_ih", "w_hh", "b_ih", "b_hh",
                "ma_w", "ma_b", "bn_w", "bn_b", "ro_iw", "ro_ib", "ro_jw",
                "ro_jb")


def grad_layout(k_vocab: int, f: int, od: int) -> Dict[str, tuple]:
    """{leaf: (offset, shape)} of the backward kernel's flat gradient
    output, in csrc/fused_step_bwd.cu's GradLayout order."""
    shapes = [(k_vocab, f, f), (f, f), (f,), (f, 3 * f), (f, 3 * f),
              (3 * f,), (3 * f,), (f,), (f,), (f,), (f,), (2 * f, od),
              (od,), (2 * f, od), (od,)]
    out, off = {}, 0
    for name, shape in zip(_GRAD_LEAVES, shapes):
        out[name] = (off, shape)
        off += math.prod(shape)
    out["total"] = (off, ())
    return out


_GRIDS: Dict[tuple, int] = {}


def _grid(lib, fn: str, *key) -> int:
    """Blocks of a cooperative launch (all co-resident blocks, capped at
    the work's need), cached per library and shape."""
    k = (fn, id(lib), torch.cuda.current_device(), *key)
    if k not in _GRIDS:
        grid = getattr(lib, fn)(*key)
        if grid < 1:
            raise RuntimeError(f"{fn}: no cooperative grid fits this card")
        _GRIDS[k] = grid
    return _GRIDS[k]


def _flat_weights(amat, a0, mbias, gru, ma_bn, bn, ro):
    return [("amat", amat), ("a0", a0), ("mbias", mbias),
            ("w_ih", gru["w_ih"]), ("w_hh", gru["w_hh"]),
            ("b_ih", gru["b_ih"]), ("b_hh", gru["b_hh"]),
            ("ma_w", ma_bn["weight"]), ("ma_b", ma_bn["bias"]),
            ("bn_w", bn["weight"]), ("bn_b", bn["bias"]),
            ("ro_iw", ro["i"]["w"]), ("ro_ib", ro["i"]["b"]),
            ("ro_jw", ro["j"]["w"]), ("ro_jb", ro["j"]["b"])]


def _kernel_weights(weights, h0, tag: str):
    """The training kernels' leading arguments: the 15 weight leaves with
    h0 after mbias, the vocab and readout tables as the bucket reads them
    (step_tables)."""
    w = dict(weights)
    amat, riw, rjw = step_tables(w["amat"], w["ro_iw"], w["ro_jw"], tag)
    w.update(amat=amat, ro_iw=riw, ro_jw=rjw)
    return [w["amat"], w["a0"], w["mbias"], h0] + [w[k]
                                                   for k in _GRAD_LEAVES[3:]]


class StepMeta(NamedTuple):
    steps: int
    msg_mode: int           # NONE or BATCH_BN
    state_mode: int         # NONE, BATCH_BN or STATELESS
    split: int = 0          # the split backward (kernels/split_bwd.py)


def _check_step_inputs(weights, h0, mask, node_graph, labels, gmask, vid,
                       src, dst, plan):
    """Device, dtype, shape and contiguity of every training-kernel input;
    returns (n, f, od, k_vocab, e, num_graphs)."""
    device = h0.device
    if device.type != "cuda":
        raise ValueError(f"fused_step: unsupported device {device}")
    n, f = h0.shape
    w = dict(weights)
    k_vocab = w["amat"].shape[0]
    od = w["ro_ib"].shape[0]
    e = src.shape[0]
    num_graphs = plan.graph_node_ptr.shape[0] - 1
    layout = grad_layout(k_vocab, f, od)
    for name, t in weights:
        _check(name, t, layout[name][1], device, torch.float32)
    for name, t, shape in [("h0", h0, (n, f)), ("mask", mask, (n, 1)),
                           ("labels", labels, (num_graphs,)),
                           ("gmask", gmask, (num_graphs,))]:
        _check(name, t, shape, device, torch.float32)
    for name, t in [("vid", vid), ("src", src), ("dst", dst)]:
        _check(name, t, (e,), device, torch.int32)
    _check("node_graph", node_graph, (n,), device, torch.int32)
    _check_plan(plan, device, n, e, num_graphs)
    return n, f, od, k_vocab, e, num_graphs


def prepare_fused_step_fwd(weights, h0, mask, node_graph, labels, gmask,
                           vid, src, dst, plan: FusedEvalPlan,
                           meta: StepMeta, tag: Optional[str] = None,
                           prof=None, floor: bool = False) -> PreparedLaunch:
    """One checked forward launch on its route (fwd_launch_shape): its
    arguments and outputs (loss (1,), out (G, od), stats (T+1, 2, f), htil
    (T+1, N, f)). `weights` is the (name, tensor) list of _flat_weights;
    `tag` as prepare_fused_eval's. A measurement may take block 0's
    clock64 stamps (`prof`, int64 with FWD_PROF_SLOTS slots) or launch the
    empty forward (`floor`: the route's grid and combines, no arithmetic;
    counted as its own key)."""
    n, f, od, k_vocab, e, g = _check_step_inputs(
        weights, h0, mask, node_graph, labels, gmask, vid, src, dst, plan)
    tag = bucket_of("fused_step", tag, f=f, od=od)
    check_batch_layout(h0, mask, node_graph, vid, src, dst, plan, k_vocab, g,
                       who="fused_step")
    _check_prof(prof, FWD_PROF_SLOTS)
    lib = _lib("fused_step_fwd", tag=tag)
    device, T = h0.device, meta.steps
    sums = meta.msg_mode != NONE or meta.state_mode != NONE
    shape = device_fwd_shape(n, tag, k_vocab, T, sums, device)
    stream = torch.cuda.current_stream(device).cuda_stream
    kw = dict(dtype=torch.float32, device=device)
    loss = torch.empty(1, **kw)
    out = torch.empty(g, od, **kw)
    stats = torch.empty(T + 1, 2, f, **kw)
    htil = torch.empty(T + 1, n, f, **kw)
    scratch = torch.empty(lib.mpnn_fused_step_fwd_scratch_floats(
        n, e, g, T, shape.grid), **kw)
    counters = _fwd_counters(shape, device, stream)
    tensors = _kernel_weights(weights, h0, tag) + [
        labels, gmask, vid, src, plan.edge_order, plan.dst_ptr,
        plan.graph_node_ptr, loss, out, stats, htil, scratch]
    args = (*(t.data_ptr() for t in tensors), _ptr(counters),
            _ptr(prof), n, g, e, f, od, k_vocab, T, meta.msg_mode,
            meta.state_mode, int(shape.route == "grid"), shape.grid,
            shape.ncap, shape.ecap, int(floor), stream)
    return PreparedLaunch("fused_step_fwd_floor" if floor
                          else "fused_step_fwd", lib.mpnn_fused_step_fwd,
                          lib.mpnn_cuda_error_string, args,
                          (loss, out, stats, htil),
                          tuple(tensors) + (counters, prof),
                          floor_counts if floor else launch_counts)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_prof(prof, slots: int) -> None:
    if prof is not None and (prof.dtype != torch.int64
                             or prof.numel() < slots):
        raise ValueError(f"prof: int64 with {slots} slots expected")


# ---------------------------------------------------------------------------
# the forward's routes (csrc/fused_step_forward.cuh: the training forward
# and the stateless serving kernel)
# ---------------------------------------------------------------------------

FWD_THREADS = 256          # kFT
FWD_MAX_GRID = 512         # kMaxGrid: the flag rows of the grid route
FWD_PROF_SLOTS = 80        # kProfSlots: block 0's clock64 stamps
FWD_MAX_NCAP = 2048        # the most node slots a block's tile is given
# Node slots a block takes. With a norm on batch statistics (its sums
# cross blocks in every slot) up to FWD_CLUSTER_SLOTS slots one cluster of
# the fewest blocks (1, 2, 4, 8) whose share is at most FWD_CLUSTER_NODES
# (8 past them); past them a grid of a block per FWD_STAT_NODES slots,
# but no more than max(FWD_STAT_BLOCKS, ceil(sqrt(n))) blocks (each
# slot's combine reads every block's row, so its cost grows with the
# blocks while a block's nodes shrink); without one, at any size, a block
# per FWD_GRID_NODES slots; all up to the co-resident blocks. From
# scripts/time_fused_step.py --fwd --sweep on an H100 (PERF.md, row 2;
# events): lipo bn1d/bn1d's cluster of 8 beat or tied every grid
# up to 512 slots (b16 44.5 us against 46.1 at 11 blocks; b32 46.8
# against 45.6-45.8 at 22-32) and lost past it (b40 54.9 against 46.6 at
# 26); the best grids took 27 (640 slots), 38 (896), 70 (1,664 and
# 3,328), 82-132 (6,656) and 103 blocks (13,184; 115 and 132 within 4%);
# without a norm on statistics (basic none/none) 16 blocks at 256 slots
# and 132 at 13,184.
FWD_CLUSTER_NODES = 32
FWD_CLUSTER_SLOTS = 512
FWD_STAT_NODES = 24
FWD_STAT_BLOCKS = 70
FWD_GRID_NODES = 16


def fwd_smem_floats(tag: str, k_vocab: int, steps: int, ncap: int,
                    ecap: int, blocks: int) -> int:
    """Floats of one forward block's shared memory in a launch of `blocks`
    blocks (csrc/fused_step_forward.cuh::Smem after fused_train_common.cuh::
    L): the staged weights and norm constants, each slot's partial row,
    the reduction scratch, every block's partial row of the slot being
    combined, the block's edge tables (ncap nodes, ecap edges) and the
    node tile."""
    fp, odp = _bucket_widths(tag)
    al4 = lambda v: (v + 3) & ~3
    ro = 2 * fp * odp if odp <= 64 else 0           # kRoInSmem
    vocab = k_vocab * fp * fp if fp <= 16 else 0    # kVocabInSmem
    weights = 7 * fp * fp + 11 * fp + 2 * ro + 2 * odp + vocab
    n = al4(weights + 3 * fp * (steps + 1))
    # a block's partial row of each slot (kRow), every block's row staged
    # for the combine (kStaged)
    n += al4((steps + 1) * (3 * fp + 4)) + 2 * FWD_THREADS
    n += max(blocks, 1) * (2 * fp + 4)
    n += al4(ncap + 1 + 2 * ecap) + ncap * 5 * fp
    return n


class FwdShape(NamedTuple):
    """A forward launch: the route ('cluster': one thread-block cluster of
    `grid` blocks; 'grid': `grid` co-resident blocks), the node and edge
    slots of a block's shared-memory tile, its dynamic shared memory
    (bytes)."""
    route: str
    grid: int
    ncap: int
    ecap: int
    smem_bytes: int

    def tag(self) -> str:
        return f"{self.route} x{self.grid} cap {self.ncap}"


def fwd_capacity(tag: str, k_vocab: int, steps: int, smem_bytes: int,
                 blocks: int) -> int:
    """The most node slots (at most FWD_MAX_NCAP, EDGE_RATIO edges each)
    whose tile fits `smem_bytes` of a forward block in a launch of up to
    `blocks` blocks; 0 when none does."""
    fits = lambda c: 4 * fwd_smem_floats(tag, k_vocab, steps, c,
                                         EDGE_RATIO * c, blocks) <= smem_bytes
    lo, hi = 0, FWD_MAX_NCAP
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
    return lo


def fwd_policy(who: str, n: int, floats, *, sums: bool, smem_bytes: int,
               max_grid: int) -> FwdShape:
    """The forward kernels' route policy for a batch of `n` node slots,
    from shapes and norms alone (this family's training forward and
    stateless serving kernel, the per-step family's training forward):
    with `sums` (a norm on batch statistics, whose sums cross blocks) up
    to FWD_CLUSTER_SLOTS slots one cluster of the fewest blocks (1, 2, 4)
    that take at most FWD_CLUSTER_NODES slots each, else 8; past them the
    grid route with a block per FWD_STAT_NODES slots, at most
    max(FWD_STAT_BLOCKS, ceil(sqrt(n))) blocks, and without sums at any
    size a block per FWD_GRID_NODES slots; each at most `max_grid` (the
    card's co-resident blocks); neither share past 3/4 of a block's tile
    (the most node slots, at most FWD_MAX_NCAP with EDGE_RATIO edges
    each, whose floats(ncap, blocks) fit `smem_bytes`) with room for the
    partial rows of the most blocks the card holds; the launch's tile
    then fills what its own block count leaves. A block whose graphs
    still outgrow its tile keeps them in global scratch, on the same
    route. NotImplementedError (naming `who`) when not one node fits."""
    most = max(MAX_CLUSTER, min(max_grid, FWD_MAX_GRID))

    def cap_of(g):
        return tile_capacity(lambda c: floats(c, g), smem_bytes,
                             FWD_MAX_NCAP)
    cap = cap_of(most)
    if cap < 1:
        raise NotImplementedError(
            f"{who} needs {4 * floats(1, most)} bytes of shared memory; the "
            f"card has {smem_bytes}")

    def shape(route, g):
        c = cap_of(g)
        return FwdShape(route, g, c, EDGE_RATIO * c, 4 * floats(c, g))
    fill = max(1, 3 * cap // 4)
    if sums and n <= FWD_CLUSTER_SLOTS and -(-n // MAX_CLUSTER) <= fill:
        return shape("cluster", next(
            (c for c in (1, 2, 4)
             if -(-n // c) <= min(FWD_CLUSTER_NODES, fill)), MAX_CLUSTER))
    want = (min(-(-n // FWD_STAT_NODES),
                max(FWD_STAT_BLOCKS, math.isqrt(n - 1) + 1)) if sums
            else -(-n // FWD_GRID_NODES))
    return shape("grid", max(1, min(max_grid, FWD_MAX_GRID,
                                    max(want, -(-n // fill)))))


def fwd_launch_shape(n: int, tag: str, k_vocab: int, steps: int, *,
                     sums: bool, smem_bytes: int, max_grid: int) -> FwdShape:
    """This family's forward route for a batch of `n` node slots
    (fwd_policy on fwd_smem_floats' tiles)."""
    return fwd_policy(
        f"fused_step_fwd: one node at vocab {k_vocab}, T {steps}", n,
        lambda c, g: fwd_smem_floats(tag, k_vocab, steps, c, EDGE_RATIO * c,
                                     g),
        sums=sums, smem_bytes=smem_bytes, max_grid=max_grid)


_DEVICE_SHAPES: Dict[tuple, tuple] = {}


def device_shape(key: tuple, device, most_fn, rule_fn):
    """A launch rule's shape on `device`, computed once for each `key`
    (the kernel's name first, then the rule's arguments):
    `most_fn(smem, sms)` gives the kernel's co-resident blocks (its
    library's max_grid at the rule's largest tile) on a card with `smem`
    bytes of shared memory a block and `sms` multiprocessors, and
    `rule_fn(smem, most)` the shape. RuntimeError when no block fits."""
    key = key + (str(device),)
    if key not in _DEVICE_SHAPES:
        props = torch.cuda.get_device_properties(device)
        smem = props.shared_memory_per_block_optin
        most = most_fn(smem, props.multi_processor_count)
        if most < 1:
            raise RuntimeError(f"{key[0]}: no block fits this card")
        _DEVICE_SHAPES[key] = rule_fn(smem, most)
    return _DEVICE_SHAPES[key]


# the C function of each forward kernel's co-resident blocks
_FWD_MAX_GRID = {"fused_step_fwd": "mpnn_fused_step_fwd_max_grid",
                 "fused_eval": "mpnn_fused_eval_stateless_max_grid"}


def device_fwd_shape(n: int, tag: str, k_vocab: int, steps: int, sums: bool,
                     device, kernel: str = "fused_step_fwd") -> FwdShape:
    """fwd_launch_shape on `device`'s shared memory and the co-resident
    blocks of `kernel`'s library ('fused_step_fwd', or 'fused_eval' for
    the stateless serving kernel)."""
    def most(smem, sms):
        # the co-resident blocks of a block that fills the card's shared
        # memory, as the rule's tile does
        cap = max(fwd_capacity(tag, k_vocab, steps, smem, sms), 1)
        return getattr(_lib(kernel, tag=tag), _FWD_MAX_GRID[kernel])(
            4 * fwd_smem_floats(tag, k_vocab, steps, cap, EDGE_RATIO * cap,
                                sms))
    return device_shape(
        (kernel, n, tag, k_vocab, steps, sums), device, most,
        lambda smem, m: fwd_launch_shape(n, tag, k_vocab, steps, sums=sums,
                                         smem_bytes=smem, max_grid=m))


# The forward kernels' counters on the grid route (each slot's arrivals,
# the launch's; the training forward and the stateless serving kernel
# share them, apart from the backward's), one buffer per device and
# stream, zeroed once: every launch leaves them zero.
_FWD_COUNTERS: Dict[tuple, torch.Tensor] = {}


def _fwd_counters(shape: FwdShape, device, stream: int):
    """The counters of a forward launch: the grid route past one block
    takes them; None otherwise."""
    if shape.route != "grid" or shape.grid < 2:
        return None
    key = (str(device), stream)
    if key not in _FWD_COUNTERS:
        _FWD_COUNTERS[key] = torch.zeros(
            _lib("fused_step_fwd").mpnn_fused_step_fwd_counters(),
            dtype=torch.int32, device=device)
    return _FWD_COUNTERS[key]


# ---------------------------------------------------------------------------
# the folded serving kernel's route (csrc/fused_eval.cu::fused_eval_kernel:
# the forward's body on the free route, no statistics, no loss)
# ---------------------------------------------------------------------------

# Node slots a block takes: a block per EVAL_NODES slots, or a block a
# graph where that gives more (a b16 request spreads over as many blocks as
# it has graphs: blocks own whole graphs), at most the card's co-resident
# blocks (b1024 fills the card in about one wave). A block's tile holds
# EVAL_SLACK times its share (its graphs pass the share by up to a graph);
# a block whose graphs outgrow it keeps them in global scratch, on the
# same route. From scripts/time_fused_step.py --eval --sweep on an H100
# (PERF.md, row 1; a trace's device time): a block per 16 slots was first
# at lipo b16, b128 and b1024 and basic o64 b16 and b1024 (8, 32, 64 and
# 128 up to 3× slower), and at the wide buckets' b16 (8 slots a graph) a
# block a graph beat it by 29-35%.
EVAL_NODES = 16
EVAL_SLACK = 2


class EvalShape(NamedTuple):
    """A folded serving launch: `grid` independent blocks (the free
    route), the node and edge slots of a block's shared-memory tile and
    its dynamic shared memory (bytes)."""
    grid: int
    ncap: int
    ecap: int
    smem_bytes: int
    route: str = "free"

    def tag(self) -> str:
        return f"free x{self.grid} cap {self.ncap}"


def eval_smem_floats(tag: str, k_vocab: int, steps: int, ncap: int) -> int:
    """Floats of one folded serving block's shared memory (fwd_smem_floats
    with one staged row: no slot crosses blocks)."""
    return fwd_smem_floats(tag, k_vocab, steps, ncap, EDGE_RATIO * ncap, 1)


def eval_launch_shape(n: int, tag: str, k_vocab: int, steps: int, *,
                      smem_bytes: int, max_grid: int, graphs: int = 0,
                      nodes: Optional[int] = None,
                      ncap: Optional[int] = None) -> EvalShape:
    """The folded serving kernel's launch for a batch of `n` node slots in
    `graphs` graphs: a block per EVAL_NODES slots or a block a graph,
    whichever is more (`nodes` forces a block per `nodes` slots), at most
    `max_grid` blocks (the co-resident ones at the rule's tile) unless
    `nodes` is forced; a block's tile EVAL_SLACK times its share, within
    the most node slots (FWD_MAX_NCAP) whose tile fits `smem_bytes`
    (`ncap` forces a tile: 1 spills every block of more than one node).
    NotImplementedError when not one node fits."""
    cap = tile_capacity(lambda c: eval_smem_floats(tag, k_vocab, steps, c),
                        smem_bytes, FWD_MAX_NCAP)
    if cap < 1:
        raise NotImplementedError(
            f"fused_eval: one node at vocab {k_vocab}, T {steps} needs "
            f"{4 * eval_smem_floats(tag, k_vocab, steps, 1)} bytes of "
            f"shared memory; the card has {smem_bytes}")
    if nodes is None:
        grid = max(1, min(max_grid, max(-(-n // EVAL_NODES), graphs)))
    else:
        grid = max(1, -(-n // nodes))
    c = min(cap, ncap or EVAL_SLACK * -(-n // grid))
    return EvalShape(grid, c, EDGE_RATIO * c,
                     4 * eval_smem_floats(tag, k_vocab, steps, c))


def device_eval_shape(n: int, tag: str, k_vocab: int, steps: int, device,
                      graphs: int = 0) -> EvalShape:
    """eval_launch_shape on `device`'s shared memory and the folded
    kernel's co-resident blocks at the rule's tile."""
    def rule(smem, most):
        return eval_launch_shape(n, tag, k_vocab, steps, smem_bytes=smem,
                                 max_grid=most, graphs=graphs)
    return device_shape(
        ("fused_eval", n, tag, k_vocab, steps, graphs), device,
        lambda smem, _: _lib("fused_eval", tag=tag).mpnn_fused_eval_max_grid(
            rule(smem, 1 << 30).smem_bytes), rule)


# ---------------------------------------------------------------------------
# the backward's routes (csrc/fused_step_bwd.cu)
# ---------------------------------------------------------------------------

BWD_THREADS = 256          # kBT
MAX_CLUSTER = 8            # the portable cluster size
MAX_GRID = 512             # kMaxGrid: the flag rows of the grid route
EDGE_RATIO = 3             # edge slots a node slot of a block's tile
MAX_NCAP = 1024            # the most node slots a block's tile is given
PROF_SLOTS = 80            # kProfSlots: block 0's clock64 stamps
# Node slots a block takes, in all three reverse walks (fused_step_bwd,
# fused_psteps_bwd, recurrence_bwd; walk_shape). With a state norm (its
# batch sums cross blocks in every step) up to CLUSTER_SLOTS slots the
# cluster route takes the fewest blocks (1, 2, 4, 8) whose share is at
# most CLUSTER_NODES (8 past them); otherwise, and without a state norm at
# any size, the grid route takes one block per GRID_NODES slots, up to the
# co-resident blocks. From scripts/time_fused_step.py --sweep (PERF.md,
# row 3; events): lipo bn1d/bn1d's cluster of 8 beat every grid at 256
# and 384 slots (63.7, 65.2 us; a block per 8 slots 68.1, 70.4) and lost
# at 512 (72.0 against 69.9 at a block per 16) and 640 (82.3 against 71.7);
# from 512 to 2,176 slots a block per 16 beat 8, 32, 64 and 100 or lay
# within 2%; without a state norm the grid at 16 beat a cluster of 8 at
# 256 slots (basic none/none 48.7 against 53.9 us) and 8 a block was at
# most 5% faster. scripts/time_fused_psteps.py and scripts/time_recurrence.py
# --sweep found the same constants for the other two walks (PERF.md, PR 17).
CLUSTER_NODES = 32
CLUSTER_SLOTS = 384
GRID_NODES = 16


class WalkShape(NamedTuple):
    """A reverse walk's launch: the route ('cluster': one thread-block
    cluster of `grid` blocks; 'grid': `grid` co-resident blocks), the node
    slots of a block's shared-memory tile and its dynamic shared memory
    (bytes)."""
    route: str
    grid: int
    ncap: int
    smem_bytes: int

    def tag(self) -> str:
        return f"{self.route} x{self.grid} cap {self.ncap}"


def tile_capacity(smem_floats, smem_bytes: int, most: int) -> int:
    """The most node slots c <= `most` whose tile of smem_floats(c) floats
    fits `smem_bytes`; 0 when none does."""
    lo, hi = 0, most
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = ((mid, hi) if 4 * smem_floats(mid) <= smem_bytes
                  else (lo, mid - 1))
    return lo


def walk_shape(who: str, n: int, smem_floats, *, most_ncap: int,
               share: float, step_sums: bool, smem_bytes: int,
               max_grid: int, cluster_slots: int = CLUSTER_SLOTS,
               cluster_nodes: int = CLUSTER_NODES) -> WalkShape:
    """The route of a reverse walk over `n` node slots, from shapes alone:
    with `step_sums` (batch sums that every step combines across blocks)
    up to `cluster_slots` slots one cluster of the fewest blocks (1, 2, 4)
    that take at most `cluster_nodes` slots each, else 8 (the walk's
    CLUSTER_SLOTS and CLUSTER_NODES unless a kernel measured its own);
    past them, and
    without step_sums at any size, the grid route with a block per
    GRID_NODES slots, at most `max_grid` (the card's co-resident blocks)
    and MAX_GRID. Neither route gives a block more than `share` of its
    tile, the most node slots (at most `most_ncap`) whose smem_floats fit
    `smem_bytes`, while the card holds the blocks. NotImplementedError
    (naming `who`) when not one node fits."""
    cap = tile_capacity(smem_floats, smem_bytes, most_ncap)
    if cap < 1:
        raise NotImplementedError(
            f"{who} needs {4 * smem_floats(1)} bytes of shared memory; the "
            f"card has {smem_bytes}")
    bytes_ = 4 * smem_floats(cap)
    fill = max(1, int(share * cap))
    if step_sums and n <= cluster_slots and -(-n // MAX_CLUSTER) <= fill:
        c = next((c for c in (1, 2, 4)
                  if -(-n // c) <= min(cluster_nodes, fill)), MAX_CLUSTER)
        return WalkShape("cluster", c, cap, bytes_)
    grid = max(1, min(max_grid, MAX_GRID, -(-n // min(GRID_NODES, fill))))
    return WalkShape("grid", grid, cap, bytes_)


def _bucket_widths(tag: str):
    most = dict(BUCKETS)[tag]
    return most["f"], most["od"]


def bwd_smem_floats(tag: str, k_vocab: int, steps: int, ncap: int,
                    ecap: int) -> int:
    """Floats of one backward block's shared memory (csrc/
    fused_step_bwd.cu::Smem after fused_train_common.cuh::L): the staged
    weights and norm constants, the batch sums, the reduction scratch, the
    readout's staged rows, the block's node and edge tables (ncap nodes,
    ecap edges), two staged htil slots and the node tile."""
    fp, odp = _bucket_widths(tag)
    al4 = lambda v: (v + 3) & ~3
    ro = 2 * fp * odp if odp <= 64 else 0           # kRoInSmem
    vocab = k_vocab * fp * fp if fp <= 16 else 0    # kVocabInSmem
    weights = 7 * fp * fp + 11 * fp + 2 * ro + 2 * odp + vocab
    n = al4(weights + 3 * fp * (steps + 1))
    warps = BWD_THREADS // 32
    red = max(warps * fp * fp, BWD_THREADS * 16)
    rows = (BWD_THREADS // fp) * 2 * (2 * fp + 4 + 2 * odp)
    n += 4 * fp + al4((steps + 1) * 2 * fp) + 4 + red + rows
    n += al4(2 * ncap + 1 + 5 * ecap + (warps + 1) * k_vocab + 1)
    n += 2 * ncap * fp + ncap * 10 * fp
    return n


class BwdShape(NamedTuple):
    """A backward launch: the route ('cluster': one thread-block cluster
    of `grid` blocks; 'grid': `grid` co-resident blocks), the node and
    edge slots of a block's shared-memory tile, its dynamic shared memory
    (bytes)."""
    route: str
    grid: int
    ncap: int
    ecap: int
    smem_bytes: int

    def tag(self) -> str:
        return f"{self.route} x{self.grid} cap {self.ncap}"


def _tile_floats(tag: str, k_vocab: int, steps: int):
    return lambda c: bwd_smem_floats(tag, k_vocab, steps, c, EDGE_RATIO * c)


def bwd_capacity(tag: str, k_vocab: int, steps: int, smem_bytes: int) -> int:
    """The most node slots (at most MAX_NCAP, EDGE_RATIO edges each) whose
    tile fits `smem_bytes` of a block; 0 when none does."""
    return tile_capacity(_tile_floats(tag, k_vocab, steps), smem_bytes,
                         MAX_NCAP)


def launch_shape(n: int, tag: str, k_vocab: int, steps: int, *,
                 step_sums: bool, smem_bytes: int, max_grid: int
                 ) -> BwdShape:
    """The backward's route for a batch of `n` node slots (walk_shape, with
    `step_sums` for a state norm): a block's share stays within 3/4 of its
    tile (bwd_capacity: fewer nodes in the wide buckets and with a large
    vocab or T), since whole graphs go to a block and its real nodes pass
    its share by up to a graph. A block whose graphs still outgrow its
    tile keeps them in global scratch, on the same route."""
    s = walk_shape(f"fused_step_bwd: one node at vocab {k_vocab}, T {steps}",
                   n, _tile_floats(tag, k_vocab, steps), most_ncap=MAX_NCAP,
                   share=0.75, step_sums=step_sums, smem_bytes=smem_bytes,
                   max_grid=max_grid)
    return BwdShape(s.route, s.grid, s.ncap, EDGE_RATIO * s.ncap,
                    s.smem_bytes)


def device_bwd_shape(n: int, tag: str, k_vocab: int, steps: int,
                     step_sums: bool, device) -> BwdShape:
    """launch_shape on `device`'s shared memory and co-resident blocks."""
    def most(smem, _):
        cap = max(bwd_capacity(tag, k_vocab, steps, smem), 1)
        return _lib("fused_step_bwd", tag=tag).mpnn_fused_step_bwd_max_grid(
            4 * bwd_smem_floats(tag, k_vocab, steps, cap, EDGE_RATIO * cap))
    return device_shape(
        ("fused_step_bwd", n, tag, k_vocab, steps, step_sums), device, most,
        lambda smem, m: launch_shape(n, tag, k_vocab, steps,
                                     step_sums=step_sums, smem_bytes=smem,
                                     max_grid=m))


# The grid routes' flags and counters of the reverse walks (fused_step_bwd,
# fused_psteps_bwd, recurrence_bwd), one pair per kernel, device and
# stream, zeroed once: every launch leaves its counters zero and tags its
# flags with a value the last launch left in the flag buffer's last word.
_SYNC: Dict[tuple, tuple] = {}


def sync_buffers(words_fn, device, stream: int):
    """The (u64 flags, int32 counters) pair of a kernel's grid route;
    `words_fn` is its library's `*_sync_words` entry point."""
    key = (words_fn.__name__, str(device), stream)
    if key not in _SYNC:
        n_counters = ctypes.c_int()
        words = words_fn(ctypes.byref(n_counters))
        _SYNC[key] = (torch.zeros(words, dtype=torch.int64, device=device),
                      torch.zeros(n_counters.value, dtype=torch.int32,
                                  device=device))
    return _SYNC[key]


def prepare_fused_step_bwd(weights, h0, labels, gmask, out, gout, gl, htil,
                           stats, node_graph, vid, src, dst,
                           plan: FusedEvalPlan, meta: StepMeta,
                           tag: Optional[str] = None, prof=None,
                           floor: bool = False) -> PreparedLaunch:
    """One checked backward launch on the forward's residuals (the batch
    tensors as the forward checked them): its arguments and outputs
    (dh0 (N, f), the flat gradient of grad_layout); `tag` as
    prepare_fused_eval's. A measurement may take block 0's clock64 stamps
    (`prof`, int64 with PROF_SLOTS slots) or launch the empty walk
    (`floor`: the route's grid and combines, no arithmetic; counted as its
    own key)."""
    device = h0.device
    n, f = h0.shape
    w = dict(weights)
    k_vocab, od = w["amat"].shape[0], w["ro_ib"].shape[0]
    e, g, T = src.shape[0], plan.graph_node_ptr.shape[0] - 1, meta.steps
    for name, t, shape_ in [("out", out, (g, od)), ("gout", gout, (g, od)),
                            ("gl", gl, (1,)), ("htil", htil, (T + 1, n, f)),
                            ("stats", stats, (T + 1, 2, f))]:
        _check(name, t, shape_, device, torch.float32)
    _check_prof(prof, PROF_SLOTS)
    tag = bucket_of("fused_step", tag, f=f, od=od)
    lib = _lib("fused_step_bwd", tag=tag)
    layout = grad_layout(k_vocab, f, od)
    c_layout = (ctypes.c_int * 16)()
    lib.mpnn_fused_step_bwd_layout(k_vocab, f, od, c_layout)
    if [v[0] for v in layout.values()] != list(c_layout):
        raise RuntimeError("fused_step_bwd: the gradient layout of the "
                           "built library disagrees with grad_layout")
    shape = device_bwd_shape(n, tag, k_vocab, T, meta.state_mode != NONE,
                             device)
    kw = dict(dtype=torch.float32, device=device)
    dh0 = torch.empty(n, f, **kw)
    dw = torch.empty(layout["total"][0], **kw)
    scratch = torch.empty(lib.mpnn_fused_step_bwd_scratch_floats(
        n, e, k_vocab, f, od, T, shape.grid), **kw)
    stream = torch.cuda.current_stream(device).cuda_stream
    flags, counters = (sync_buffers(lib.mpnn_fused_step_bwd_sync_words,
                                    device, stream)
                       if shape.route == "grid" and shape.grid > 1
                       else (None, None))
    src_order, src_ptr = source_order(src, n)
    tensors = _kernel_weights(weights, h0, tag) + [
        labels, gmask, out, gout, gl, htil, stats, vid, src, dst,
        src_order, src_ptr, plan.graph_node_ptr, node_graph, dh0, dw,
        scratch]
    ptr = lambda t: None if t is None else t.data_ptr()
    args = (*(t.data_ptr() for t in tensors), ptr(flags), ptr(counters),
            ptr(prof), n, g, e, f, od, k_vocab, T, meta.msg_mode,
            meta.state_mode, int(shape.route == "grid"), shape.grid,
            shape.ncap, shape.ecap, int(floor), stream)
    return PreparedLaunch("fused_step_bwd_floor" if floor
                          else "fused_step_bwd", lib.mpnn_fused_step_bwd,
                          lib.mpnn_cuda_error_string, args, (dh0, dw),
                          tuple(tensors) + (flags, counters, prof),
                          floor_counts if floor else launch_counts)


# the empty kernels' launches (a measurement's yardstick, not the path's)
floor_counts: Dict[str, int] = {"fused_step_fwd_floor": 0,
                                "fused_eval_floor": 0,
                                "fused_eval_stateless_floor": 0,
                                "fused_step_bwd_floor": 0}


def split_grads(dw: torch.Tensor, k_vocab: int, f: int, od: int):
    """The flat gradient as {leaf: view of its shape}."""
    return {name: dw[off:off + math.prod(shape)].view(shape)
            for name, (off, shape) in grad_layout(k_vocab, f, od).items()
            if name != "total"}


class _FusedStep(torch.autograd.Function):
    """The training forward kernel, with the backward kernel as its VJP —
    or, on the split route, the readout, recurrence and message VJPs
    (split_backward). Inputs: meta, the 15 weight leaves (_GRAD_LEAVES
    order), h0, then the non-differentiable batch tensors and the plan.
    Outputs (loss (1,), out, stats); stats carry no gradient (they feed
    the running EMAs). On CPU tensors (the split route only) the forward
    is the plain version with its stash."""

    @staticmethod
    def forward(ctx, meta, *args):
        weights = list(zip(_GRAD_LEAVES, args[:15]))
        h0, mask, node_graph, labels, gmask, vid, src, dst = args[15:23]
        plan = FusedEvalPlan(*args[23:])
        loss, out, stats, htil = forward_residuals(
            weights, h0, mask, node_graph, labels, gmask, vid, src, dst,
            plan, meta)
        ctx.meta = meta
        ctx.save_for_backward(*args, out, stats, htil)
        ctx.mark_non_differentiable(stats)
        return loss, out, stats

    @staticmethod
    def backward(ctx, g_loss, g_out, _g_stats):
        saved = ctx.saved_tensors
        args, (out, stats, htil) = saved[:-3], saved[-3:]
        weights = list(zip(_GRAD_LEAVES, args[:15]))
        h0, mask, node_graph, labels, gmask, vid, src, dst = args[15:23]
        plan = FusedEvalPlan(*args[23:])
        gl = (torch.zeros(1, dtype=out.dtype, device=out.device)
              if g_loss is None else g_loss.reshape(1).contiguous())
        gout = (torch.zeros_like(out) if g_out is None
                else g_out.contiguous())
        if ctx.meta.split:
            dh0, grads = split_backward(
                dict(weights), h0, mask, node_graph, labels, gmask, vid,
                src, dst, plan, out, gout, gl, htil, stats,
                steps=ctx.meta.steps)
        else:
            dh0, dw = launch_prepared(prepare_fused_step_bwd(
                weights, h0, labels, gmask, out, gout, gl, htil, stats,
                node_graph, vid, src, dst, plan, ctx.meta))
            f, od, k = h0.shape[1], out.shape[1], args[0].shape[0]
            grads = split_grads(dw, k, f, od)
        return (None, *(grads[name] for name in _GRAD_LEAVES), dh0,
                *([None] * (len(args) - 16)))


def forward_residuals(weights, h0, mask, node_graph, labels, gmask, vid,
                      src, dst, plan, meta: StepMeta):
    """The forward kernel's outputs (loss (1,), out, stats (T+1, 2, f),
    htil (T+1, N, f)): its launch for CUDA tensors, the plain version for
    CPU tensors."""
    if h0.device.type != "cuda":
        return _reference_residuals(weights, h0, mask, node_graph, labels,
                                    gmask, vid, src, dst, plan, meta)
    return launch_prepared(prepare_fused_step_fwd(
        weights, h0, mask, node_graph, labels, gmask, vid, src, dst, plan,
        meta))


def _reference_residuals(weights, h0, mask, node_graph, labels, gmask, vid,
                         src, dst, plan, meta: StepMeta):
    """The forward kernel's outputs from the plain version."""
    w = dict(weights)
    stash = []
    loss, out, ma, st = fused_step_reference(
        w["amat"], w["a0"], w["mbias"], h0, mask, node_graph,
        {k: w[k] for k in ("w_ih", "w_hh", "b_ih", "b_hh")},
        {"weight": w["ma_w"], "bias": w["ma_b"]},
        {"weight": w["bn_w"], "bias": w["bn_b"]},
        {"i": {"w": w["ro_iw"], "b": w["ro_ib"]},
         "j": {"w": w["ro_jw"], "b": w["ro_jb"]}},
        labels, gmask, vid, src, dst, plan, steps=meta.steps,
        msg_norm="bn1d" if meta.msg_mode == BATCH_BN else "none",
        state_norm={v: k for k, v in _STATE_MODE.items()}[meta.state_mode],
        stash=stash)
    stats = torch.stack([torch.stack(ma), *(torch.stack(s) for s in st)])
    return loss.reshape(1), out, stats, torch.stack(stash)


def split_backward(w, h0, mask, node_graph, labels, gmask, vid, src, dst,
                   plan: FusedEvalPlan, out, gout, gl, htil, stats, *,
                   steps: int):
    """The split route of the shared family's backward (bn1d/bn1d): the
    readout + loss VJP (kernels/readout_bwd.py) on h_T rebuilt from the
    stash's last slot, the recurrence VJP (kernels/recurrence.py) on the
    stash as it stands — slot 0 the masked messages, slots 1..T the
    pre-norm states — and the message VJP (kernels/msg_bwd.py, one
    network). Each launches its kernel for CUDA tensors and runs its plain
    version for CPU tensors. Returns (dh0, {leaf: gradient})."""
    from mpnn_tpu_torch.kernels import msg_bwd as MB
    from mpnn_tpu_torch.kernels import readout_bwd as RB
    from mpnn_tpu_torch.kernels import recurrence as R
    ro = {"i": {"w": w["ro_iw"], "b": w["ro_ib"]},
          "j": {"w": w["ro_jw"], "b": w["ro_jb"]}}
    gh, dh0_ro, dro = RB.ro_bwd(
        htil[steps], stats[steps], w["bn_w"], w["bn_b"], h0, mask,
        node_graph, ro, labels, gmask, out, gout, gl, state_norm="bn1d")
    dmsgs, dh0_rec, drec = R.recurrence_vjp(
        htil[0], h0, mask, {k: w[k] for k in ("w_ih", "w_hh", "b_ih",
                                              "b_hh")},
        {"weight": w["ma_w"], "bias": w["ma_b"]},
        {"weight": w["bn_w"], "bias": w["bn_b"]}, stats, htil[1:], gh,
        steps=steps)
    dh0_msg, dmsg = MB.msg_bwd(w["amat"][None], w["a0"][None], h0, mask,
                               node_graph, vid, src, dst, dmsgs[None], plan)
    grads = {"amat": dmsg["amat"][0], "a0": dmsg["a0"][0],
             "mbias": dmsg["mbias"][0], **drec,
             "ro_iw": dro["i"]["w"], "ro_ib": dro["i"]["b"],
             "ro_jw": dro["j"]["w"], "ro_jb": dro["j"]["b"]}
    return dh0_ro + dh0_rec + dh0_msg, grads


def fused_step(amat, a0, mbias, h0, mask, node_graph, gru, ma_bn, bn, ro,
               labels, gmask, vid, src, dst, plan: FusedEvalPlan, *,
               steps: int, msg_norm: str = "bn1d",
               state_norm: str = "bn1d", bwd: str = "auto"):
    """Whole-step training forward: (loss, out (G, od), (ma_mean, ma_var),
    [(mean_t, var_t)] × steps), differentiable in the weights and h0 for
    the cotangents of both loss and out. Arguments as fused_step_reference.
    `bwd` picks the backward route: 'whole' (one kernel), 'split' (the
    readout, recurrence and message VJPs; bn1d/bn1d only) or 'auto', the
    JAX package's rule (kernels/split_bwd.py), which keeps every other
    norm pair, the stateless state norm's too, on the whole backward. CPU tensors run the plain
    version under autograd on the whole route, and the plain versions of
    the three VJPs on the split route; CUDA tensors launch the forward
    kernel (and, in the backward pass, the route's kernels) or raise."""
    _check_modes("fused_step", msg_norm, state_norm)
    split = route("shared", steps=steps, f=h0.shape[1], n=h0.shape[0],
                  msg_norm=msg_norm, state_norm=state_norm,
                  bwd=bwd) == "split"
    if h0.device.type == "cpu" and not split:
        return fused_step_reference(
            amat, a0, mbias, h0, mask, node_graph, gru, ma_bn, bn, ro,
            labels, gmask, vid, src, dst, plan, steps=steps,
            msg_norm=msg_norm, state_norm=state_norm)
    if not 1 <= steps <= MAX_STEPS:
        raise NotImplementedError(
            f"fused_step: steps={steps}; the kernels take 1 to {MAX_STEPS}")
    meta = StepMeta(steps, BATCH_BN if msg_norm == "bn1d" else NONE,
                    _STATE_MODE[state_norm], int(split))
    weights = [t for _, t in _flat_weights(amat, a0, mbias, gru, ma_bn, bn,
                                           ro)]
    loss, out, stats = _FusedStep.apply(
        meta, *weights, h0, mask, node_graph, labels, gmask, vid, src, dst,
        *plan)
    return (loss[0], out, (stats[0, 0], stats[0, 1]),
            [(stats[t, 0], stats[t, 1]) for t in range(1, steps + 1)])
