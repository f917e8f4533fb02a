"""The vocab-indexed SpMM op (counterpart of mpnn_tpu/kernels/spmm.py): the
A-form message sum of the edge-network family on the decomposed training
path, with its VJP.

    out[d] = Σ_{e: dst_e = d} A[vid_e] · h[src_e]                 (N, mf)
    dh     = the same sum on Aᵀ with src and dst swapped          (N, nf)
    dA[k]  = Σ_{e: vid_e = k} g[dst_e] ⊗ h[src_e]                 (K, mf, nf)

A (K, mf, nf), h (N, nf), vid/src/dst (E,) int32. make_spmm_op() returns
the `spmm_vocab_fn` hook of models/sparse.py with the JAX hook's signature
(amat, h, vid, src, dst, plan) → (N, mf), where `plan` is the index plan
the loader attaches (graphs/batching.py::plan_fused_eval: the stable
destination order and its row pointers). The TPU window plan (spmm_win,
plan_edge_windows) is not ported: the backward's source order and its
stable vocab order are built on the device (fused_step.py::source_order).

CPU tensors run the plain version (spmm_reference under autograd); CUDA
tensors launch the hand-written kernels csrc/spmm_fwd.cu (the forward and,
on Aᵀ through the source order, dh) and csrc/spmm_da.cu (dA), or raise.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from mpnn_tpu_torch.graphs.batching import FusedEvalPlan
from mpnn_tpu_torch.kernels import fused_step as K

# width buckets, narrowest first (kernels/build.py::WIDE): mf, nf <= 16
# with A in shared memory, <= 32 with A in device memory
BUCKETS = (("", dict(f=16)), ("f32", dict(f=32)))
# the largest edge vocabulary the kernels take (csrc/spmm_common.cuh)
MAX_VOCAB = 64

launch_counts: Dict[str, int] = {"spmm_fwd": 0, "spmm_da": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def spmm_reference(a, h, vid, src, dst):
    """The plain version: einsum over the gathered tables and rows, then a
    sum per destination (mpnn_tpu/kernels/spmm.py::spmm_reference)."""
    msgs = torch.einsum("emn,en->em", a[vid.long()], h[src.long()])
    return h.new_zeros((h.shape[0], a.shape[1])).index_add_(
        0, dst.long(), msgs)


def spmm_da_reference(h, g, vid, src, dst, k_vocab: int):
    """The plain dA: Σ_{e: vid_e = k} g[dst_e] ⊗ h[src_e], (K, mf, nf)."""
    outer = g[dst.long()][:, :, None] * h[src.long()][:, None, :]
    return g.new_zeros((k_vocab, g.shape[1], h.shape[1])).index_add_(
        0, vid.long(), outer)


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "spmm_fwd": {
        "mpnn_spmm_fwd": ([_P] * 7 + [_I] * 4 + [_P], _I),
        "mpnn_spmm_fwd_smem_bytes": ([_I], _I),
    },
    "spmm_da": {
        "mpnn_spmm_da": ([_P] * 8 + [_I] * 5 + [_P], _I),
        "mpnn_spmm_da_smem_bytes": ([], _I),
        "mpnn_spmm_da_scratch_floats": ([_I, _I], ctypes.c_longlong),
        "mpnn_spmm_da_grid": ([_I, _I], _I),
    },
}


def _lib(name: str, tag: str = ""):
    return K._lib(name, _SIGNATURES, tag)


def _bucket(mf: int, nf: int) -> str:
    return K.width_bucket("spmm", BUCKETS, f=max(mf, nf))


def check_layout(h, vid, src, dst, plan: FusedEvalPlan, k_vocab: int,
                 who: str = "spmm") -> None:
    """The index invariants the kernels rely on, with one device sync:
    vocab ids in range, src/dst in range, the plan's order a destination-
    sorted permutation of the edges and its row pointers those of dst
    (also the SDDMM kernels', kernels/sddmm.py; `who` names the op)."""
    n, e = h.shape[0], src.shape[0]
    s, d = src.long(), dst.long()
    order = plan.edge_order.long()
    d_c = d.clamp(0, n - 1)
    o_c = order.clamp(0, max(e - 1, 0))
    d_sorted = d_c[o_c]
    bad = torch.stack([
        ((vid < 0) | (vid >= k_vocab)).any(),
        ((s < 0) | (s >= n) | (d != d_c)).any(),
        ((order != o_c) | (torch.bincount(o_c, minlength=e) != 1)).any(),
        (d_sorted[1:] < d_sorted[:-1]).any(),
        ((plan.dst_ptr[0] != 0) | (plan.dst_ptr.long().diff()
                                   != torch.bincount(d_c, minlength=n))
         ).any()])
    names = ["vid out of range", "src/dst out of range",
             "plan edge_order is not a permutation of the edges",
             "plan edge_order not destination-sorted",
             "plan dst_ptr disagrees with edge_dst"]
    for flag, what in zip(bad.cpu().tolist(), names):
        if flag:
            raise ValueError(f"{who}: {what}")


def _check_inputs(a, h, vid, src, dst, plan: FusedEvalPlan) -> int:
    """Device, dtype, shape and contiguity of the forward's inputs;
    returns the vocab size K."""
    device = h.device
    if device.type != "cuda":
        raise ValueError(f"spmm: unsupported device {device}")
    k_vocab, mf, nf = a.shape
    n, e = h.shape[0], src.shape[0]
    if not 1 <= k_vocab <= MAX_VOCAB:
        raise NotImplementedError(
            f"spmm: K={k_vocab}; the kernels take 1 to {MAX_VOCAB} vocab ids")
    _bucket(mf, nf)
    K._check("a", a, (k_vocab, mf, nf), device, torch.float32)
    K._check("h", h, (n, nf), device, torch.float32)
    for name, t in [("vid", vid), ("src", src), ("dst", dst),
                    ("plan.edge_order", plan.edge_order)]:
        K._check(name, t, (e,), device, torch.int32)
    K._check("plan.dst_ptr", plan.dst_ptr, (n + 1,), device, torch.int32)
    if e < 1:
        raise ValueError("spmm: no edges")
    return k_vocab


def prepare_spmm_fwd(a, x, vid, gather, order, ptr, *, n_out: int
                     ) -> K.PreparedLaunch:
    """One launch of the forward kernel on inputs the caller checked:
    out[r] = Σ_{p ∈ [ptr[r], ptr[r+1])} a[vid_e]·x[gather_e], e = order[p];
    a (K, mo, ni), x (·, ni). Output out (n_out, mo)."""
    k_vocab, mo, ni = a.shape
    lib = _lib("spmm_fwd", _bucket(mo, ni))
    out = torch.empty(n_out, mo, dtype=torch.float32, device=x.device)
    keep = (a, x, vid, gather, order, ptr, out)
    args = (*(t.data_ptr() for t in keep), n_out, mo, ni, k_vocab,
            torch.cuda.current_stream(x.device).cuda_stream)
    return K.PreparedLaunch("spmm_fwd", lib.mpnn_spmm_fwd,
                            lib.mpnn_cuda_error_string, args, out, keep,
                            launch_counts)


def prepare_spmm_da(h, g, vid, src, dst, k_vocab: int) -> K.PreparedLaunch:
    """One launch of the dA kernel on inputs the caller checked; the stable
    vocab order is built on the device. Output dA (K, mf, nf)."""
    mf, nf, e = g.shape[1], h.shape[1], src.shape[0]
    tag = _bucket(mf, nf)
    lib = _lib("spmm_da", tag)
    grid = K._grid(lib, "mpnn_spmm_da_grid", e, k_vocab)
    vorder, vptr = K.source_order(vid, k_vocab)
    kw = dict(dtype=torch.float32, device=h.device)
    da = torch.empty(k_vocab, mf, nf, **kw)
    part = torch.empty(lib.mpnn_spmm_da_scratch_floats(e, k_vocab), **kw)
    keep = (g, h, src, dst, vorder, vptr, da, part)
    args = (*(t.data_ptr() for t in keep), e, mf, nf, k_vocab, grid,
            torch.cuda.current_stream(h.device).cuda_stream)
    return K.PreparedLaunch("spmm_da", lib.mpnn_spmm_da,
                            lib.mpnn_cuda_error_string, args, da, keep,
                            launch_counts)


class _SpMM(torch.autograd.Function):
    """The forward kernel, with its transposed launch (dh) and the dA
    kernel as the VJP, each only where autograd asks for it. Inputs: a, h,
    vid, src, dst, the plan's edge_order and dst_ptr (checked by the
    caller)."""

    @staticmethod
    def forward(ctx, a, h, vid, src, dst, edge_order, dst_ptr):
        ctx.save_for_backward(a, h, vid, src, dst)
        return K.launch_prepared(prepare_spmm_fwd(
            a, h, vid, src, edge_order, dst_ptr, n_out=h.shape[0]))

    @staticmethod
    def backward(ctx, g):
        a, h, vid, src, dst = ctx.saved_tensors
        g = g.contiguous()
        da = dh = None
        if ctx.needs_input_grad[1]:
            s_order, s_ptr = K.source_order(src, h.shape[0])
            dh = K.launch_prepared(prepare_spmm_fwd(
                a.transpose(1, 2).contiguous(), g, vid, dst, s_order, s_ptr,
                n_out=h.shape[0]))
        if ctx.needs_input_grad[0]:
            da = K.launch_prepared(prepare_spmm_da(h, g, vid, src, dst,
                                                   a.shape[0]))
        return da, dh, None, None, None, None, None


def spmm(a, h, vid, src, dst, plan: FusedEvalPlan, *, check: bool = True):
    """out (N, mf), differentiable in a and h. CPU tensors run the plain
    version under autograd; CUDA tensors launch the kernels or raise (with
    `check`, after the layout check of check_layout)."""
    if h.device.type == "cpu":
        return spmm_reference(a, h, vid, src, dst)
    a, h = a.contiguous(), h.contiguous()
    k_vocab = _check_inputs(a, h, vid, src, dst, plan)
    if check:
        check_layout(h, vid, src, dst, plan, k_vocab)
    return _SpMM.apply(a, h, vid, src, dst, plan.edge_order, plan.dst_ptr)


def make_spmm_op():
    """The `spmm_vocab_fn` hook: fn(amat, h, vid, src, dst, plan) → (N, mf)
    as mpnn_tpu/kernels/spmm.py::make_spmm_op returns it, with the TPU
    window plan's place taken by the index plan. The layout check runs once
    per batch: the per-step family calls the hook T times on one batch's
    index tensors."""
    checked = []

    def fn(amat, h, vid, src, dst, plan):
        ids = (vid, src, dst, plan.edge_order, plan.dst_ptr)
        fresh = len(checked) != len(ids) or any(
            x is not y for x, y in zip(checked, ids))
        out = spmm(amat, h, vid, src, dst, plan, check=fresh)
        checked[:] = ids
        return out
    return fn
