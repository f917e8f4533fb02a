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
launch_shape sizes the forward's tiles of edges on the host from the
shapes alone, a block a tile (csrc/spmm_fwd.cu, on csrc/sddmm_common.cuh's
tiles).
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

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


# ---------------------------------------------------------------------------
# the forward's tiles, from shapes alone
# ---------------------------------------------------------------------------

# csrc/sddmm_common.cuh's constants
THREADS = 256
MAX_PER = 8               # positions a lane group takes in a tile
PROF_SLOTS = 24
# The tile rule (scripts/time_spmm.py --sweep; PERF.md, row 9): the
# positions cut into tiles of about GRID_WAVE blocks an SM, a tile at most
# TILE_POSITIONS positions (row 11's forward rule, kernels/sddmm.py).
GRID_WAVE = 3
TILE_POSITIONS = 128


def group_of(mo: int, ni: int) -> int:
    """Lanes a position: the narrowest of 8, 16 (the narrow bucket) and 32
    (the wide bucket) that holds mo and ni."""
    f = max(mo, ni)
    return 8 if f <= 8 else 16 if f <= 16 else 32


# the vocab ids whose A tables a block stages (csrc/spmm_fwd.cu::
# kStageIds): every id in the narrow bucket, 16 in the wide one
STAGE_IDS = {16: MAX_VOCAB, 32: 16}


def smem_floats(k_vocab: int, fp: int, te: int) -> int:
    """Dynamic shared memory of a block, in floats (csrc/spmm_fwd.cu::
    fwd_smem_floats): the used ids' A tables (room for min(K, STAGE_IDS)
    of them), a tile's staged positions (te of them: five index arrays,
    the x rows and the products), the used-id mask, the boundary rows'
    pointers and the combine's flags."""
    al4 = lambda n: (n + 3) & ~3
    table = min(k_vocab, STAGE_IDS[fp]) * fp * fp
    return table + al4(5 * te) + 2 * te * fp + 8


class SpmmShape(NamedTuple):
    """A forward launch, a block a tile: lanes a position, positions a
    group takes in a tile, the tiles, dynamic shared memory (bytes)."""
    group: int
    per: int
    tiles: int
    smem_bytes: int

    def tag(self) -> str:
        return f"g{self.group} p{self.per} x{self.tiles}"


def launch_shape(n_pos: int, mo: int, ni: int, k_vocab: int, *,
                 smem_bytes: int, sms: int, per: Optional[int] = None
                 ) -> SpmmShape:
    """The tile rule, from the shapes alone: the n_pos positions of the
    order (the edges) cut into tiles, a block a tile, a group taking the
    fewest positions that keep the tiles within GRID_WAVE blocks an SM, at
    most TILE_POSITIONS a tile and MAX_PER a group. `per` forces the
    positions a group (a measurement's and a check's). A tile gives way
    (fewer positions a group) until the block fits `smem_bytes`."""
    group = group_of(mo, ni)
    fp = 16 if group <= 16 else 32
    ng = THREADS // group
    cdiv = lambda a, b: -(-a // b)
    if per is None:
        most = min(MAX_PER, max(1, TILE_POSITIONS // ng))
        per = min(most, max(1, cdiv(n_pos, ng * max(1, GRID_WAVE * sms))))
    per = min(MAX_PER, max(1, per))
    while 4 * smem_floats(k_vocab, fp, ng * per) > smem_bytes and per > 1:
        per -= 1
    need = 4 * smem_floats(k_vocab, fp, ng * per)
    if need > smem_bytes:
        raise NotImplementedError(
            f"spmm_fwd: a tile at K={k_vocab} needs {need} bytes of shared "
            f"memory; the card has {smem_bytes}")
    return SpmmShape(group, per, cdiv(n_pos, ng * per), need)


_SHAPES: Dict[tuple, SpmmShape] = {}


def device_shape(n_pos: int, mo: int, ni: int, k_vocab: int,
                 device) -> SpmmShape:
    """launch_shape on `device`'s SM count and shared-memory limit."""
    key = (n_pos, mo, ni, k_vocab, str(device))
    if key not in _SHAPES:
        props = torch.cuda.get_device_properties(device)
        _SHAPES[key] = launch_shape(
            n_pos, mo, ni, k_vocab,
            smem_bytes=props.shared_memory_per_block_optin,
            sms=props.multi_processor_count)
    return _SHAPES[key]


# The forward's integer counters, one buffer per device and stream, zeroed
# once (a larger batch takes a new zeroed one): every launch leaves them
# zero.
_COUNTERS: Dict[tuple, torch.Tensor] = {}


def _counters(device, stream: int, n: int) -> torch.Tensor:
    key = (str(device), stream)
    if key not in _COUNTERS or _COUNTERS[key].numel() < n:
        _COUNTERS[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                     device=device)
    return _COUNTERS[key]


# a floor launch's count: a measurement's yardstick, never the main path's
floor_counts: Dict[str, int] = {"spmm_fwd": 0}


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "spmm_fwd": {
        "mpnn_spmm_fwd": ([_P] * 11 + [_I] * 8 + [_P], _I),
        "mpnn_spmm_fwd_smem_bytes": ([_I] * 3, _I),
        "mpnn_spmm_fwd_scratch_floats": ([_I] * 3, ctypes.c_longlong),
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


def prepare_spmm_fwd(a, x, vid, gather, key, order, ptr, *, n_out: int,
                     prof=None, floor: bool = False) -> K.PreparedLaunch:
    """One launch of the forward kernel on inputs the caller checked:
    out[r] = Σ_{p ∈ [ptr[r], ptr[r+1])} a[vid_e]·x[gather_e], e = order[p];
    a (K, mo, ni), x (·, ni), key[e] the output row of edge e (the order
    groups the edges by it). Output out (n_out, mo). `prof`: block 0's
    clock64 stamps (int64, PROF_SLOTS); `floor`: the empty-kernel floor
    (the same tiles and combines, no arithmetic; counted apart)."""
    k_vocab, mo, ni = a.shape
    e = order.shape[0]
    shape = device_shape(e, mo, ni, k_vocab, x.device)
    lib = _lib("spmm_fwd", _bucket(mo, ni))
    kw = dict(dtype=torch.float32, device=x.device)
    out = torch.empty(n_out, mo, **kw)
    scratch = torch.empty(lib.mpnn_spmm_fwd_scratch_floats(
        e, shape.group, shape.per), **kw)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    counters = _counters(x.device, stream, shape.tiles)
    K._check_prof(prof, PROF_SLOTS)
    keep = (a, x, vid, gather, key, order, ptr, out, scratch, counters, prof)
    args = (*(t.data_ptr() for t in keep[:10]), K._ptr(prof), n_out, e, mo,
            ni, k_vocab, shape.group, shape.per, int(floor), stream)
    return K.PreparedLaunch("spmm_fwd", lib.mpnn_spmm_fwd,
                            lib.mpnn_cuda_error_string, args, out, keep,
                            floor_counts if floor else launch_counts)


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
            a, h, vid, src, dst, edge_order, dst_ptr, n_out=h.shape[0]))

    @staticmethod
    def backward(ctx, g):
        a, h, vid, src, dst = ctx.saved_tensors
        g = g.contiguous()
        da = dh = None
        if ctx.needs_input_grad[1]:
            s_order, s_ptr = K.source_order(src, h.shape[0])
            dh = K.launch_prepared(prepare_spmm_fwd(
                a.transpose(1, 2).contiguous(), g, vid, dst, src, s_order,
                s_ptr, n_out=h.shape[0]))
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
