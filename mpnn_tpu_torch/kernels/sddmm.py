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
windows) is not ported: the backward's node order (the 2E edge ends
sorted by node) and vocab order are built on the device
(fused_step.py::source_order).

CPU tensors run the plain version (sddmm_reference under autograd); CUDA
tensors launch the hand-written kernels csrc/sddmm_fwd.cu and
csrc/sddmm_bwd.cu (the TPU's row and transposed layouts are one function
here: one forward, one backward), or raise. launch_shape sizes each
launch's tiles on the host from the shapes alone, a block a tile
(csrc/sddmm_common.cuh).
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

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


# ---------------------------------------------------------------------------
# the launch shape: the tiles, from shapes alone
# ---------------------------------------------------------------------------

# csrc/sddmm_common.cuh's constants
THREADS = 256
MAX_PER = 8               # positions a lane group takes in a tile
PROF_SLOTS = 24
# The tile rule (scripts/time_sddmm.py --sweep, device time in a trace;
# PERF.md, row 11): each direction's positions cut into tiles of about
# GRID_WAVE[direction] blocks an SM (the backward: one block for two
# SMs), a tile at most TILE_POSITIONS positions.
GRID_WAVE = {"fwd": 3, "bwd": 0.5}
TILE_POSITIONS = 128


def group_of(mf: int, nf: int) -> int:
    """Lanes an edge: the narrowest of 8, 16 (the narrow bucket) and 32
    (the wide bucket) that holds mf and nf."""
    f = max(mf, nf)
    return 8 if f <= 8 else 16 if f <= 16 else 32


def _al4(n: int) -> int:
    return (n + 3) & ~3


def smem_floats(direction: str, k_vocab: int, fp: int, te: int,
                vte: int = 0) -> int:
    """Dynamic shared memory of a block, in floats (csrc/sddmm_common.cuh::
    table_floats, stage_floats; sddmm_fwd.cu::fwd_smem_floats, sddmm_bwd.cu::
    bwd_smem_floats): the tables (A' too in the narrow bucket), a tile's
    staged positions (te of them; the backward's vocab tiles vte), the
    combines' flags and the backward's last sums."""
    tables = _al4(2 * fp * fp + k_vocab * fp + fp) + (
        k_vocab * fp * fp if fp <= 16 else 0)
    stage = lambda t, rows: _al4(5 * t) + rows * t * fp
    if direction == "fwd":
        return tables + stage(te, 3) + 4
    return (tables + max(stage(te, 4), stage(vte, 5)) + 8 + k_vocab * fp
            + _al4(k_vocab) + 8)


class SddmmShape(NamedTuple):
    """A launch, a block a tile: lanes an edge, positions a group takes in
    a tile (the forward's edges, the backward's edge ends by node) and, in
    the backward, in a vocab tile, the tiles, dynamic shared memory
    (bytes)."""
    group: int
    per: int
    vper: int
    tiles: int
    vtiles: int
    smem_bytes: int

    @property
    def grid(self) -> int:
        return self.tiles + self.vtiles

    def tag(self) -> str:
        per = f"p{self.per}" + (f"/{self.vper}" if self.vper else "")
        return f"g{self.group} {per} x{self.grid}"


def launch_shape(direction: str, n_edges: int, mf: int, nf: int,
                 k_vocab: int, *, smem_bytes: int, sms: int,
                 per: Optional[Tuple[int, int]] = None) -> SddmmShape:
    """The tile rule, from the shapes alone. The forward walks the E edges
    by destination; the backward the 2E edge ends by node and the E edges
    by vocab id. A block a tile, a group taking the fewest positions that
    keep the tiles within GRID_WAVE[direction] blocks an SM, at most
    TILE_POSITIONS a tile and MAX_PER a group. `per` forces (positions a group, positions a group in a vocab tile): a
    measurement's and a check's. A tile gives way (fewer positions a
    group) until the block fits `smem_bytes`."""
    group = group_of(mf, nf)
    fp = 16 if group <= 16 else 32
    ng = THREADS // group
    pos = n_edges if direction == "fwd" else 2 * n_edges
    cdiv = lambda a, b: -(-a // b)
    cap = max(1, int(GRID_WAVE[direction] * sms))
    most = min(MAX_PER, max(1, TILE_POSITIONS // ng))
    if per is None:
        per = (min(most, max(1, cdiv(pos, ng * cap))),
               min(most, max(1, cdiv(n_edges, ng * cap))))
    per, vper = (min(MAX_PER, max(1, p)) for p in per)
    if direction == "fwd":
        vper = 0

    def floats(p, v):
        return smem_floats(direction, k_vocab, fp, ng * p, ng * v)
    while floats(per, vper) * 4 > smem_bytes and max(per, vper) > 1:
        per, vper = max(1, per - 1), max(min(vper, 1), vper - 1)
    if floats(per, vper) * 4 > smem_bytes:
        raise NotImplementedError(
            f"sddmm_{direction}: a tile at K={k_vocab} needs "
            f"{4 * floats(per, vper)} bytes of shared memory; the card has "
            f"{smem_bytes}")
    return SddmmShape(group, per, vper, cdiv(pos, ng * per),
                      cdiv(n_edges, ng * vper) if vper else 0,
                      4 * floats(per, vper))


_SHAPES: Dict[tuple, SddmmShape] = {}


def device_shape(direction: str, n_edges: int, mf: int, nf: int,
                 k_vocab: int, device) -> SddmmShape:
    """launch_shape on `device`'s SM count and shared-memory limit."""
    key = (direction, n_edges, mf, nf, k_vocab, str(device))
    if key not in _SHAPES:
        props = torch.cuda.get_device_properties(device)
        _SHAPES[key] = launch_shape(
            direction, n_edges, mf, nf, k_vocab,
            smem_bytes=props.shared_memory_per_block_optin,
            sms=props.multi_processor_count)
    return _SHAPES[key]


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "sddmm_fwd": {
        "mpnn_sddmm_fwd": ([_P] * 14 + [_I] * 9 + [_P], _I),
        "mpnn_sddmm_fwd_smem_bytes": ([_I] * 3, _I),
        "mpnn_sddmm_fwd_scratch_floats": ([_I] * 3, ctypes.c_longlong),
    },
    "sddmm_bwd": {
        "mpnn_sddmm_bwd": ([_P] * 21 + [_I] * 10 + [_P], _I),
        "mpnn_sddmm_bwd_smem_bytes": ([_I] * 4, _I),
        "mpnn_sddmm_bwd_scratch_floats": ([_I] * 7, ctypes.c_longlong),
        "mpnn_sddmm_bwd_counters": ([_I] * 5, _I),
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


# The kernels' integer counters, one buffer per device and stream,
# zeroed once (a larger batch takes a new zeroed one): every launch leaves
# them zero.
_COUNTERS: Dict[tuple, torch.Tensor] = {}


def _counters(device, stream: int, n: int) -> torch.Tensor:
    key = (str(device), stream)
    if key not in _COUNTERS or _COUNTERS[key].numel() < n:
        _COUNTERS[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                     device=device)
    return _COUNTERS[key]


def _prof_ptr(prof):
    """A clock64 stamp buffer (int64, PROF_SLOTS, on the device) or null."""
    if prof is None:
        return None
    if prof.dtype != torch.int64 or prof.numel() < PROF_SLOTS:
        raise ValueError(f"prof: int64 with {PROF_SLOTS} slots expected")
    return prof.data_ptr()


# a floor launch's count: a measurement's yardstick, never the main path's
_FLOOR_COUNTS: Dict[str, int] = {"sddmm_fwd": 0, "sddmm_bwd": 0}


def prepare_sddmm_fwd(aprime, evocab, wa, ba, h, vid, src, dst, order, ptr,
                      *, prof=None, floor: bool = False
                      ) -> K.PreparedLaunch:
    """One launch of the forward kernel on inputs the caller checked:
    out (N, mf), each row the sum over its edges in the order's stable
    sequence (order, ptr: the destination order and its row pointers).
    `prof`: block 0's clock64 stamps; `floor`: the empty-kernel floor (the
    same grid and combines, no arithmetic; counted apart)."""
    k_vocab, mf, nf = aprime.shape
    n, e, ef = h.shape[0], src.shape[0], evocab.shape[1]
    shape = device_shape("fwd", e, mf, nf, k_vocab, h.device)
    lib = _lib("sddmm_fwd", _bucket(mf, nf))
    kw = dict(dtype=torch.float32, device=h.device)
    out = torch.empty(n, mf, **kw)
    scratch = torch.empty(lib.mpnn_sddmm_fwd_scratch_floats(
        e, shape.group, shape.per), **kw)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    counters = _counters(h.device, stream, shape.tiles)
    keep = (aprime, evocab, wa, ba, h, vid, src, dst, order, ptr, out,
            scratch, counters, prof)
    args = (*(t.data_ptr() for t in keep[:13]), _prof_ptr(prof), n, e, mf,
            nf, ef, k_vocab, shape.group, shape.per, int(floor), stream)
    return K.PreparedLaunch("sddmm_fwd", lib.mpnn_sddmm_fwd,
                            lib.mpnn_cuda_error_string, args, out, keep,
                            _FLOOR_COUNTS if floor else launch_counts)


def node_order(src, dst, n: int):
    """The backward's node order: the 2E edge ends (x < E: edge x's
    destination end; else edge x − E's source end) stably sorted by node,
    and its row pointers, on the device without a host sync."""
    return K.source_order(torch.cat([dst, src]), n)


def prepare_sddmm_bwd(aprime, evocab, wa, ba, h, gout, vid, src, dst, *,
                      prof=None, floor: bool = False) -> K.PreparedLaunch:
    """One launch of the backward kernel on inputs the caller checked, for
    the cotangent gout (N, mf); the node and vocab orders are built on the
    device. Outputs (da, devocab, dwa, dba, dh). `prof`, `floor` as
    prepare_sddmm_fwd's."""
    k_vocab, mf, nf = aprime.shape
    n, e, ef = h.shape[0], src.shape[0], evocab.shape[1]
    K._check("gout", gout, (n, mf), h.device, torch.float32)
    shape = device_shape("bwd", e, mf, nf, k_vocab, h.device)
    lib = _lib("sddmm_bwd", _bucket(mf, nf))
    n_order, n_ptr = node_order(src, dst, n)
    v_order, v_ptr = K.source_order(vid, k_vocab)
    kw = dict(dtype=torch.float32, device=h.device)
    da = torch.empty(k_vocab, mf, nf, **kw)
    dev = torch.empty(k_vocab, ef, **kw)
    dwa = torch.empty(nf + ef, nf, **kw)
    dba = torch.empty(nf, **kw)
    dh = torch.empty(n, nf, **kw)
    scratch = torch.empty(lib.mpnn_sddmm_bwd_scratch_floats(
        e, mf, nf, k_vocab, shape.group, shape.per, shape.vper), **kw)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    counters = _counters(h.device, stream, lib.mpnn_sddmm_bwd_counters(
        e, k_vocab, shape.group, shape.per, shape.vper))
    keep = (aprime, evocab, wa, ba, h, gout, vid, src, dst, n_order, n_ptr,
            v_order, v_ptr, da, dev, dwa, dba, dh, scratch, counters, prof)
    args = (*(t.data_ptr() for t in keep[:20]), _prof_ptr(prof), n, e, mf,
            nf, ef, k_vocab, shape.group, shape.per, shape.vper, int(floor),
            stream)
    return K.PreparedLaunch("sddmm_bwd", lib.mpnn_sddmm_bwd,
                            lib.mpnn_cuda_error_string, args,
                            (da, dev, dwa, dba, dh), keep,
                            _FLOOR_COUNTS if floor else launch_counts)


def library_smem_bytes(direction: str, shape: SddmmShape, k_vocab: int,
                       mf: int, nf: int) -> int:
    """The built library's shared memory for `shape`, to hold against
    launch_shape's."""
    lib = _lib(f"sddmm_{direction}", _bucket(mf, nf))
    if direction == "fwd":
        return lib.mpnn_sddmm_fwd_smem_bytes(k_vocab, shape.group, shape.per)
    return lib.mpnn_sddmm_bwd_smem_bytes(k_vocab, shape.group, shape.per,
                                         shape.vper)


class _Sddmm(torch.autograd.Function):
    """The forward kernel, with the backward kernel as the VJP. Inputs:
    aprime, evocab, wa, ba, h, vid, src, dst, the plan's edge_order and
    dst_ptr (checked by the caller)."""

    @staticmethod
    def forward(ctx, aprime, evocab, wa, ba, h, vid, src, dst, edge_order,
                dst_ptr):
        ctx.save_for_backward(aprime, evocab, wa, ba, h, vid, src, dst)
        return K.launch_prepared(prepare_sddmm_fwd(
            aprime, evocab, wa, ba, h, vid, src, dst, edge_order, dst_ptr))

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
