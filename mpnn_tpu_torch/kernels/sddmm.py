"""The attention SDDMM op (counterpart of mpnn_tpu/kernels/sddmm.py): the
unfused attention message of the attention models' decomposed training
path, with its VJP.

    gate_e = softmax_feat([h[dst_e] ‖ evocab[vid_e]] · wa + ba)    (nf)
    g_e    = gate_e ⊙ h[src_e]
    out[d] = Σ_{e: dst_e = d} aprime[vid_e] · g_e                   (N, mf)

aprime (K, mf, nf), evocab (K, ef), wa (nf + ef, nf) in the JAX (in, out)
layout, ba (nf,), h (N, nf), vid/src/dst (E,) int32. The VJP gives the
gradients of aprime, evocab, wa, ba and h (mpnn_tpu/kernels/sddmm.py::
_sddmm_bwd). make_sddmm_op() returns the `sddmm_fn` hook of
models/sparse.py with the JAX hook's signature (aprime, evocab, wa, ba, h,
vid, src, dst, plan) → (N, mf), where `plan` is the index plan the loader
attaches (graphs/batching.py::plan_from_batch: the stable destination
order and its row pointers). The TPU window plan (spmm_win, 128-aligned
windows) is not ported: the backward's source and vocab orders are built
on the device (fused_step.py::source_order).

CPU tensors run the plain version (sddmm_reference under autograd); CUDA
tensors launch the hand-written kernels csrc/sddmm_fwd.cu and
csrc/sddmm_bwd.cu (the TPU's row and transposed layouts are one function
here: one forward, one backward), or raise.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from mpnn_tpu_torch.graphs.batching import FusedEvalPlan
from mpnn_tpu_torch.kernels import fused_step as K
from mpnn_tpu_torch.kernels.spmm import check_layout

# width buckets, narrowest first (kernels/build.py::WIDE): mf, nf <= 16
# with aprime in shared memory, <= 32 with aprime in device memory
BUCKETS = (("", dict(f=16)), ("f32", dict(f=32)))
# the largest edge vocabulary and bond-row width the kernels take
# (csrc/sddmm_common.cuh)
MAX_VOCAB = 64
MAX_EDGE_FEATURES = 32

launch_counts: Dict[str, int] = {"sddmm_fwd": 0, "sddmm_bwd": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def sddmm_reference(aprime, evocab, wa, ba, h, vid, src, dst):
    """The plain version, line for line mpnn_tpu/kernels/sddmm.py::
    sddmm_att_reference: the gate from the concatenated destination and
    vocab rows, the gated source rows through aprime[vid], a sum per
    destination."""
    vid, src, dst = vid.long(), src.long(), dst.long()
    hd = h[dst]
    ev = evocab[vid]
    gate = torch.softmax(torch.cat([hd, ev], dim=-1) @ wa + ba, dim=-1)
    g = gate * h[src]
    msgs = torch.einsum("emn,en->em", aprime[vid], g)
    return h.new_zeros((h.shape[0], aprime.shape[1])).index_add_(0, dst,
                                                                 msgs)


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "sddmm_fwd": {
        "mpnn_sddmm_fwd": ([_P] * 10 + [_I] * 5 + [_P], _I),
        "mpnn_sddmm_fwd_smem_bytes": ([_I], _I),
    },
    "sddmm_bwd": {
        "mpnn_sddmm_bwd": ([_P] * 21 + [_I] * 7 + [_P], _I),
        "mpnn_sddmm_bwd_smem_bytes": ([_I], _I),
        "mpnn_sddmm_bwd_scratch_floats": ([_I] * 4, ctypes.c_longlong),
        "mpnn_sddmm_bwd_grid": ([_I] * 3, _I),
    },
}


def _lib(name: str, tag: str = ""):
    return K._lib(name, _SIGNATURES, tag)


def _bucket(mf: int, nf: int) -> str:
    return K.width_bucket("sddmm", BUCKETS, f=max(mf, nf))


def check_widths(k_vocab: int, mf: int, nf: int, ef: int) -> str:
    """The kernels' width and vocabulary limits: the width bucket's tag,
    or NotImplementedError naming the widths past them."""
    if not 1 <= k_vocab <= MAX_VOCAB:
        raise NotImplementedError(
            f"sddmm: K={k_vocab}; the kernels take 1 to {MAX_VOCAB} vocab "
            f"ids")
    if ef > MAX_EDGE_FEATURES:
        raise NotImplementedError(
            f"sddmm: ef={ef}; the kernels take bond rows up to "
            f"{MAX_EDGE_FEATURES} wide")
    return _bucket(mf, nf)


def check_inputs(aprime, evocab, wa, ba, h, vid, src, dst,
                 plan: FusedEvalPlan) -> int:
    """Device, dtype, shape and contiguity of the forward's inputs and the
    kernels' limits (check_widths); returns the vocab size K."""
    device = h.device
    if device.type != "cuda":
        raise ValueError(f"sddmm: unsupported device {device}")
    k_vocab, mf, nf = aprime.shape
    ef = evocab.shape[1]
    n, e = h.shape[0], src.shape[0]
    check_widths(k_vocab, mf, nf, ef)
    K._check("aprime", aprime, (k_vocab, mf, nf), device, torch.float32)
    K._check("evocab", evocab, (k_vocab, ef), device, torch.float32)
    K._check("wa", wa, (nf + ef, nf), device, torch.float32)
    K._check("ba", ba, (nf,), device, torch.float32)
    K._check("h", h, (n, nf), device, torch.float32)
    for name, t in [("vid", vid), ("src", src), ("dst", dst),
                    ("plan.edge_order", plan.edge_order)]:
        K._check(name, t, (e,), device, torch.int32)
    K._check("plan.dst_ptr", plan.dst_ptr, (n + 1,), device, torch.int32)
    if e < 1:
        raise ValueError("sddmm: no edges")
    return k_vocab


def prepare_sddmm_fwd(aprime, evocab, wa, ba, h, vid, src, order, ptr
                      ) -> K.PreparedLaunch:
    """One launch of the forward kernel on inputs the caller checked:
    out (N, mf), each row the sum over its edges in the order's stable
    sequence (order, ptr: the destination order and its row pointers)."""
    k_vocab, mf, nf = aprime.shape
    n, ef = h.shape[0], evocab.shape[1]
    lib = _lib("sddmm_fwd", _bucket(mf, nf))
    out = torch.empty(n, mf, dtype=torch.float32, device=h.device)
    keep = (aprime, evocab, wa, ba, h, vid, src, order, ptr, out)
    args = (*(t.data_ptr() for t in keep), n, mf, nf, ef, k_vocab,
            torch.cuda.current_stream(h.device).cuda_stream)
    return K.PreparedLaunch("sddmm_fwd", lib.mpnn_sddmm_fwd,
                            lib.mpnn_cuda_error_string, args, out, keep,
                            launch_counts)


def prepare_sddmm_bwd(aprime, evocab, wa, ba, h, gout, vid, src, dst,
                      order, ptr) -> K.PreparedLaunch:
    """One launch of the backward kernel on inputs the caller checked, for
    the cotangent gout (N, mf); the stable source and vocab orders are
    built on the device. Outputs (da, devocab, dwa, dba, dh)."""
    k_vocab, mf, nf = aprime.shape
    n, e, ef = h.shape[0], src.shape[0], evocab.shape[1]
    K._check("gout", gout, (n, mf), h.device, torch.float32)
    lib = _lib("sddmm_bwd", _bucket(mf, nf))
    grid = K._grid(lib, "mpnn_sddmm_bwd_grid", n, e, k_vocab)
    s_order, s_ptr = K.source_order(src, n)
    v_order, v_ptr = K.source_order(vid, k_vocab)
    kw = dict(dtype=torch.float32, device=h.device)
    da = torch.empty(k_vocab, mf, nf, **kw)
    dev = torch.empty(k_vocab, ef, **kw)
    dwa = torch.empty(nf + ef, nf, **kw)
    dba = torch.empty(nf, **kw)
    dh = torch.empty(n, nf, **kw)
    scratch = torch.empty(
        lib.mpnn_sddmm_bwd_scratch_floats(e, nf, k_vocab, grid), **kw)
    keep = (aprime, evocab, wa, ba, h, gout, vid, src, dst, order, ptr,
            s_order, s_ptr, v_order, v_ptr, da, dev, dwa, dba, dh, scratch)
    args = (*(t.data_ptr() for t in keep), n, e, mf, nf, ef, k_vocab, grid,
            torch.cuda.current_stream(h.device).cuda_stream)
    return K.PreparedLaunch("sddmm_bwd", lib.mpnn_sddmm_bwd,
                            lib.mpnn_cuda_error_string, args,
                            (da, dev, dwa, dba, dh), keep, launch_counts)


class _Sddmm(torch.autograd.Function):
    """The forward kernel, with the backward kernel as the VJP. Inputs:
    aprime, evocab, wa, ba, h, vid, src, dst, the plan's edge_order and
    dst_ptr (checked by the caller)."""

    @staticmethod
    def forward(ctx, aprime, evocab, wa, ba, h, vid, src, dst, edge_order,
                dst_ptr):
        ctx.save_for_backward(aprime, evocab, wa, ba, h, vid, src, dst,
                              edge_order, dst_ptr)
        return K.launch_prepared(prepare_sddmm_fwd(
            aprime, evocab, wa, ba, h, vid, src, edge_order, dst_ptr))

    @staticmethod
    def backward(ctx, gout):
        grads = K.launch_prepared(prepare_sddmm_bwd(
            *ctx.saved_tensors[:5], gout.contiguous(),
            *ctx.saved_tensors[5:]))
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)),
                None, None, None, None, None)


def sddmm(aprime, evocab, wa, ba, h, vid, src, dst, plan: FusedEvalPlan, *,
          check: bool = True):
    """out (N, mf), differentiable in aprime, evocab, wa, ba and h. CPU
    tensors run the plain version under autograd; CUDA tensors launch the
    kernels or raise (with `check`, after the index check of
    kernels/spmm.py::check_layout)."""
    if h.device.type == "cpu":
        return sddmm_reference(aprime, evocab, wa, ba, h, vid, src, dst)
    aprime, evocab, wa, ba, h = (t.contiguous()
                                 for t in (aprime, evocab, wa, ba, h))
    k_vocab = check_inputs(aprime, evocab, wa, ba, h, vid, src, dst, plan)
    if check:
        check_layout(h, vid, src, dst, plan, k_vocab, who="sddmm")
    return _Sddmm.apply(aprime, evocab, wa, ba, h, vid, src, dst,
                        plan.edge_order, plan.dst_ptr)


def make_sddmm_op():
    """The `sddmm_fn` hook: fn(aprime, evocab, wa, ba, h, vid, src, dst,
    plan) → (N, mf) as mpnn_tpu/kernels/sddmm.py::make_sddmm_op returns
    it, with the TPU window plan's place taken by the index plan. The
    index check runs once per batch: the att model calls the hook once per
    message network on one batch's index tensors."""
    checked = []

    def fn(aprime, evocab, wa, ba, h, vid, src, dst, plan):
        ids = (vid, src, dst, plan.edge_order, plan.dst_ptr)
        fresh = len(checked) != len(ids) or any(
            x is not y for x, y in zip(checked, ids))
        out = sddmm(aprime, evocab, wa, ba, h, vid, src, dst, plan,
                    check=fresh)
        checked[:] = ids
        return out
    return fn
