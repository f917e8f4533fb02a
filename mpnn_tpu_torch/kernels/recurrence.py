"""The fused BN→GRU→BN recurrence op (counterpart of mpnn_tpu/kernels/
recurrence.py): the lipo family's whole step chain on messages that are
constant across steps, with its VJP.

    mb = bn1d(msgs);  h = h0·mask;  T × { h = bn1d(GRU(mb, h)) }

msgs, h0 (N, f); mask (N, 1), 0/1; gru {w_ih, w_hh (f, 3f), b_ih, b_hh
(3f)} in the JAX layout, gates r|z|n; ma_bn, bn {weight, bias} (f,). Both
norms take the batch statistics of the masked rows, the biased variance,
eps outside the root. Returns (h_T, (ma_mean, ma_var), [(mean_t, var_t)]
× T) as reference_recurrence does; the statistics carry no gradient (they
feed the running EMAs: models/sparse.py::mpnn_new_state).

make_recurrence_op(steps, f) returns the `recurrence_fn` hook of
models/sparse.py. The JAX package picks one of four TPU variants by VMEM
size (make_recurrence_op_auto); they compute the same function, and here
one pair of kernels does at any node count: csrc/recurrence_fwd.cu (one
launch on the route fwd_launch_shape picks) and csrc/recurrence_bwd.cu
(one launch on the route launch_shape picks): each a thread-block
cluster or a grid of co-resident blocks, no grid barrier. CPU tensors run the plain version
(reference_recurrence under autograd); CUDA tensors launch the kernels or
raise.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from mpnn_tpu_torch.kernels import fused_step as K
from mpnn_tpu_torch.kernels.fused_step import _gru
from mpnn_tpu_torch.ops.norm import bn1d_train

# width buckets, narrowest first (kernels/build.py::WIDE)
BUCKETS = (("", dict(f=16)), ("f32", dict(f=32)))
# the most steps the kernels take (fused_train_common.cuh::kMaxSteps)
MAX_STEPS = 32

launch_counts: Dict[str, int] = {"recurrence_fwd": 0, "recurrence_bwd": 0}
# the empty kernels' launches (a measurement's yardstick, not the path's)
floor_counts: Dict[str, int] = {"recurrence_fwd_floor": 0,
                                "recurrence_bwd_floor": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
    for k in floor_counts:
        floor_counts[k] = 0


def reference_recurrence(msgs, h0, mask, gru, ma_bn, bn, *, steps: int):
    """The plain version: the masked bn1d of the messages, then T × [GRU
    from the precomputed input gates → masked bn1d], as mpnn_tpu/kernels/
    recurrence.py::reference_recurrence chains them (and as the plain
    model's step loop does). Returns (h_T, (ma_mean, ma_var),
    [(mean_t, var_t)] × steps), the statistics detached."""
    mb, ma_stats = bn1d_train(msgs, mask, ma_bn["weight"], ma_bn["bias"])
    gi = mb @ gru["w_ih"] + gru["b_ih"]
    h = h0 * mask
    step_stats = []
    for _ in range(steps):
        h, st = bn1d_train(_gru(gru, gi, h, mask), mask, bn["weight"],
                           bn["bias"])
        step_stats.append(tuple(x.detach() for x in st))
    return h, tuple(x.detach() for x in ma_stats), step_stats


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "recurrence_fwd": {
        "mpnn_recurrence_fwd": ([_P] * 17 + [_I] * 7 + [_P], _I),
        "mpnn_recurrence_fwd_smem_bytes": ([_I] * 3, _I),
        "mpnn_recurrence_fwd_scratch_floats": ([_I] * 3, ctypes.c_longlong),
        "mpnn_recurrence_fwd_counters": ([], _I),
        "mpnn_recurrence_fwd_max_grid": ([_I], _I),
    },
    "recurrence_bwd": {
        "mpnn_recurrence_bwd": ([_P] * 21 + [_I] * 7 + [_P], _I),
        "mpnn_recurrence_bwd_smem_bytes": ([_I, _I], _I),
        "mpnn_recurrence_bwd_layout": ([_I, _P], None),
        "mpnn_recurrence_bwd_scratch_floats": ([_I] * 4,
                                               ctypes.c_longlong),
        "mpnn_recurrence_bwd_sync_words": ([_P], _I),
        "mpnn_recurrence_bwd_max_grid": ([_I], _I),
    },
}

# the weight leaves, in the kernels' order (and the backward's GradLayout)
_LEAVES = ("w_ih", "w_hh", "b_ih", "b_hh", "ma_w", "ma_b", "bn_w", "bn_b")


def _lib(name: str, tag: str = ""):
    return K._lib(name, _SIGNATURES, tag)


def grad_layout(f: int) -> Dict[str, tuple]:
    """{leaf: (offset, shape)} of the backward kernel's flat gradient, in
    csrc/recurrence_bwd.cu's GradLayout order."""
    shapes = [(f, 3 * f), (f, 3 * f), (3 * f,), (3 * f,), (f,), (f,), (f,),
              (f,)]
    out, off = {}, 0
    for name, shape in zip(_LEAVES, shapes):
        out[name] = (off, shape)
        off += math.prod(shape)
    out["total"] = (off, ())
    return out


def _flat(gru, ma_bn, bn):
    return [gru["w_ih"], gru["w_hh"], gru["b_ih"], gru["b_hh"],
            ma_bn["weight"], ma_bn["bias"], bn["weight"], bn["bias"]]


def _check_inputs(msgs, h0, mask, weights, steps):
    """Device, dtype, shape and contiguity of the inputs; returns (n, f,
    the width bucket's tag)."""
    device = h0.device
    if device.type != "cuda":
        raise ValueError(f"recurrence: unsupported device {device}")
    n, f = h0.shape
    tag = K.width_bucket("recurrence", BUCKETS, f=f)
    if not 1 <= steps <= MAX_STEPS:
        raise NotImplementedError(
            f"recurrence: steps={steps}; the kernels take 1 to {MAX_STEPS}")
    for name, t, shape in [("msgs", msgs, (n, f)), ("h0", h0, (n, f)),
                           ("mask", mask, (n, 1))]:
        K._check(name, t, shape, device, torch.float32)
    for (name, (_, shape)), t in zip(grad_layout(f).items(), weights):
        K._check(name, t, shape, device, torch.float32)
    return n, f, tag


# ---------------------------------------------------------------------------
# the forward's routes (csrc/recurrence_fwd.cu)
# ---------------------------------------------------------------------------

FWD_THREADS = 256          # fused_step_forward.cuh::kFT
FWD_PROF_SLOTS = 80        # fused_step_forward.cuh::kProfSlots
# Every slot's statistics cross blocks, so the route policy is the shared
# family's forward one (kernels/fused_step.py::fwd_policy with sums: a
# cluster up to FWD_CLUSTER_SLOTS slots, past them a grid of a block per
# FWD_STAT_NODES slots, at most max(FWD_STAT_BLOCKS, ceil(sqrt(n)))
# blocks), its constants kept there. scripts/time_recurrence.py --fwd
# --sweep on an H100 (PERF.md, row 5; events) found the rule's route first
# or within 1% at lipo b16 (a cluster of 8, 29.3 us against 36.2-80.9),
# b128 (70 blocks, 43.9 against 43.7-124.7), b1024 (129 blocks) and the
# split's 57,856 slots (132 blocks).


def fwd_smem_floats(tag: str, steps: int, ncap: int, blocks: int) -> int:
    """Floats of one forward block's shared memory in a launch of `blocks`
    blocks (csrc/recurrence_fwd.cu::Smem after recurrence_common.cuh::RL):
    the staged weights and each slot's norm constants, each slot's partial
    row, the reduction scratch, every block's partial row of the slot
    being combined (the cluster route stages them), the tile's mask and
    its rows (4·FP floats a node)."""
    fp = _fp(tag)
    al4 = lambda v: (v + 3) & ~3
    row, staged = 3 * fp + 4, 2 * fp + 4            # kRow, kStaged
    n = al4(6 * fp * fp + 10 * fp + 4 * fp * (steps + 1))
    n += al4((steps + 1) * row) + 2 * FWD_THREADS
    n += max(blocks, 1) * staged
    return n + al4(ncap) + ncap * 4 * fp


def fwd_capacity(tag: str, steps: int, smem_bytes: int, blocks: int) -> int:
    """The most node slots (at most K.FWD_MAX_NCAP) whose tile fits
    `smem_bytes` of a forward block in a launch of up to `blocks` blocks;
    0 when none does."""
    return K.tile_capacity(lambda c: fwd_smem_floats(tag, steps, c, blocks),
                           smem_bytes, K.FWD_MAX_NCAP)


def fwd_launch_shape(n: int, tag: str, steps: int, *, smem_bytes: int,
                     max_grid: int) -> K.FwdShape:
    """The forward's route for `n` node slots: the shared family's forward
    policy (fused_step.fwd_policy, every slot's sums crossing blocks) on
    this kernel's tile. A block whose slots outgrow its tile (past what
    the co-resident blocks hold: ~57,856 slots of lipo's split at f 10 fit)
    keeps them in global scratch, on the same route."""
    return K.fwd_policy(
        f"recurrence_fwd: one node at T {steps}", n,
        lambda c, g: fwd_smem_floats(tag, steps, c, g), sums=True,
        smem_bytes=smem_bytes, max_grid=max_grid)


def device_fwd_shape(n: int, tag: str, steps: int, device) -> K.FwdShape:
    """fwd_launch_shape on `device`'s shared memory and the kernel's
    co-resident blocks at the tile that fills a block's shared memory."""
    def most(smem, sms):
        cap = max(fwd_capacity(tag, steps, smem, sms), 1)
        return _lib("recurrence_fwd", tag).mpnn_recurrence_fwd_max_grid(
            4 * fwd_smem_floats(tag, steps, cap, sms))
    return K.device_shape(
        ("recurrence_fwd", n, tag, steps), device, most,
        lambda smem, m: fwd_launch_shape(n, tag, steps, smem_bytes=smem,
                                         max_grid=m))


# The forward's counters on the grid route (each slot's arrivals, the
# launch's), one buffer per device and stream, zeroed once: every launch
# leaves them zero.
_FWD_COUNTERS: Dict[tuple, torch.Tensor] = {}


def _fwd_counters(lib, device, stream: int) -> torch.Tensor:
    key = (str(device), stream)
    if key not in _FWD_COUNTERS:
        _FWD_COUNTERS[key] = torch.zeros(lib.mpnn_recurrence_fwd_counters(),
                                         dtype=torch.int32, device=device)
    return _FWD_COUNTERS[key]


def prepare_recurrence_fwd(msgs, h0, mask, weights, *, steps: int,
                           stash: bool, prof=None, floor: bool = False
                           ) -> K.PreparedLaunch:
    """One checked forward launch on its route (device_fwd_shape). Outputs
    (h_T (N, f), stats (T+1, 2, f), htil): with `stash` htil (T, N, f)
    holds every step's pre-norm state for the backward; without, an empty
    tensor (serving writes no residuals). A measurement may take block 0's
    clock64 stamps (`prof`, int64 with FWD_PROF_SLOTS slots) or launch the
    empty forward (`floor`: the route's grid and combines, no arithmetic;
    counted as its own key)."""
    n, f, tag = _check_inputs(msgs, h0, mask, weights, steps)
    K._check_prof(prof, FWD_PROF_SLOTS)
    lib = _lib("recurrence_fwd", tag)
    device = h0.device
    shape = device_fwd_shape(n, tag, steps, device)
    kw = dict(dtype=torch.float32, device=device)
    ht = torch.empty(n, f, **kw)
    stats = torch.empty(steps + 1, 2, f, **kw)
    htil = torch.empty((steps, n, f) if stash else (0,), **kw)
    scratch = torch.empty(lib.mpnn_recurrence_fwd_scratch_floats(
        n, steps, shape.grid), **kw)
    stream = torch.cuda.current_stream(device).cuda_stream
    counters = (_fwd_counters(lib, device, stream)
                if shape.route == "grid" and shape.grid > 1 else None)
    keep = (msgs, h0, mask, *weights, ht, stats, htil, scratch)
    ptrs = [t.data_ptr() for t in keep]
    if not stash:
        ptrs[-2] = None
    args = (*ptrs, K._ptr(counters), K._ptr(prof), n, f, steps,
            int(shape.route == "grid"), shape.grid, shape.ncap, int(floor),
            stream)
    return K.PreparedLaunch("recurrence_fwd_floor" if floor
                            else "recurrence_fwd", lib.mpnn_recurrence_fwd,
                            lib.mpnn_cuda_error_string, args,
                            (ht, stats, htil), keep + (counters, prof),
                            floor_counts if floor else launch_counts)


# ---------------------------------------------------------------------------
# the backward's routes (csrc/recurrence_bwd.cu)
# ---------------------------------------------------------------------------

BWD_THREADS = 256          # walk_bwd.cuh::kBT
MAX_NCAP = 2048            # the most node slots a block's tile is given
PROF_SLOTS = 80            # walk_bwd.cuh::kProfSlots: block 0's stamps
# The route policy is the three reverse walks' one (fused_step.walk_shape):
# every step's batch sums cross blocks, so a cluster up to CLUSTER_SLOTS
# slots, past them a grid of a block per GRID_NODES slots.
MAX_CLUSTER, MAX_GRID = K.MAX_CLUSTER, K.MAX_GRID
CLUSTER_NODES, CLUSTER_SLOTS, GRID_NODES = (K.CLUSTER_NODES, K.CLUSTER_SLOTS,
                                            K.GRID_NODES)


def _fp(tag: str) -> int:
    return dict(BUCKETS)[tag]["f"]


def bwd_smem_floats(tag: str, steps: int, ncap: int) -> int:
    """Floats of one backward block's shared memory (csrc/
    recurrence_bwd.cu::Smem after recurrence_common.cuh::RL): the staged
    weights and each slot's norm constants, the round totals and block
    partials, the reduction scratch, two staged h̃ slots and the node tile
    (8·FP floats a node)."""
    fp = _fp(tag)
    al4 = lambda v: (v + 3) & ~3
    cw = 2 * fp + 4
    red = max((BWD_THREADS // 32) * fp * fp, BWD_THREADS * 16)
    n = al4(6 * fp * fp + 10 * fp + 4 * fp * (steps + 1))
    return n + cw + (steps + 1) * cw + 4 + red + 2 * ncap * fp + ncap * 8 * fp


# a backward launch (route, blocks, the tile's node slots, bytes)
RecShape = K.WalkShape


def bwd_capacity(tag: str, steps: int, smem_bytes: int) -> int:
    """The most node slots (at most MAX_NCAP) whose tile fits `smem_bytes`
    of a block; 0 when none does."""
    return K.tile_capacity(lambda c: bwd_smem_floats(tag, steps, c),
                           smem_bytes, MAX_NCAP)


def launch_shape(n: int, tag: str, steps: int, *, smem_bytes: int,
                 max_grid: int) -> RecShape:
    """The backward's route for `n` node slots (the walks'
    fused_step.walk_shape; every step's sums cross blocks): no share past
    a block's tile (bwd_capacity: fewer slots in the wide bucket and at a
    large T) while the card holds the blocks. Past that (57,856 slots of
    lipo's split at f 10) a block keeps its nodes in global scratch, on
    the same route."""
    return K.walk_shape(f"recurrence_bwd: one node at T {steps}", n,
                        lambda c: bwd_smem_floats(tag, steps, c),
                        most_ncap=MAX_NCAP, share=1.0, step_sums=True,
                        smem_bytes=smem_bytes, max_grid=max_grid)


def device_bwd_shape(n: int, tag: str, steps: int, device) -> RecShape:
    """launch_shape on `device`'s shared memory and co-resident blocks."""
    def most(smem, _):
        cap = max(bwd_capacity(tag, steps, smem), 1)
        return _lib("recurrence_bwd", tag).mpnn_recurrence_bwd_max_grid(
            4 * bwd_smem_floats(tag, steps, cap))
    return K.device_shape(
        ("recurrence_bwd", n, tag, steps), device, most,
        lambda smem, m: launch_shape(n, tag, steps, smem_bytes=smem,
                                     max_grid=m))


def prepare_recurrence_bwd(msgs, h0, mask, weights, stats, htil, ght, *,
                           steps: int, prof=None, floor: bool = False
                           ) -> K.PreparedLaunch:
    """One checked backward launch on the forward's residuals, on its route
    (device_bwd_shape). Outputs (dmsgs (N, f), dh0 (N, f), the flat
    gradient of grad_layout). A measurement may take block 0's clock64
    stamps (`prof`, int64 with PROF_SLOTS slots) or launch the empty walk
    (`floor`: the route's grid and combines, no arithmetic; counted as its
    own key)."""
    n, f, tag = _check_inputs(msgs, h0, mask, weights, steps)
    for name, t, shape in [("stats", stats, (steps + 1, 2, f)),
                           ("htil", htil, (steps, n, f)),
                           ("ght", ght, (n, f))]:
        K._check(name, t, shape, h0.device, torch.float32)
    K._check_prof(prof, PROF_SLOTS)
    lib = _lib("recurrence_bwd", tag)
    layout = grad_layout(f)
    c_layout = (ctypes.c_int * 9)()
    lib.mpnn_recurrence_bwd_layout(f, c_layout)
    if [v[0] for v in layout.values()] != list(c_layout):
        raise RuntimeError("recurrence_bwd: the gradient layout of the "
                           "built library disagrees with grad_layout")
    device = h0.device
    shape = device_bwd_shape(n, tag, steps, device)
    kw = dict(dtype=torch.float32, device=device)
    dmsgs = torch.empty(n, f, **kw)
    dh0 = torch.empty(n, f, **kw)
    dw = torch.empty(layout["total"][0], **kw)
    scratch = torch.empty(lib.mpnn_recurrence_bwd_scratch_floats(
        n, f, steps, shape.grid), **kw)
    stream = torch.cuda.current_stream(device).cuda_stream
    flags, counters = (K.sync_buffers(lib.mpnn_recurrence_bwd_sync_words,
                                      device, stream)
                       if shape.route == "grid" and shape.grid > 1
                       else (None, None))
    keep = (msgs, h0, mask, *weights, stats, htil, ght, dmsgs, dh0, dw,
            scratch)
    args = (*(t.data_ptr() for t in keep), K._ptr(flags), K._ptr(counters),
            K._ptr(prof), n, f, steps, int(shape.route == "grid"),
            shape.grid, shape.ncap, int(floor), stream)
    return K.PreparedLaunch("recurrence_bwd_floor" if floor
                            else "recurrence_bwd", lib.mpnn_recurrence_bwd,
                            lib.mpnn_cuda_error_string, args,
                            (dmsgs, dh0, dw), keep + (flags, counters, prof),
                            floor_counts if floor else launch_counts)


def split_grads(dw: torch.Tensor, f: int):
    """The flat gradient as {leaf: view of its shape}."""
    return {name: dw[off:off + math.prod(shape)].view(shape)
            for name, (off, shape) in grad_layout(f).items()
            if name != "total"}


class _Recurrence(torch.autograd.Function):
    """The forward kernel with the residual stash, the backward kernel as
    its VJP; applied only while autograd records the op. Inputs: steps,
    msgs, h0, mask, the eight weight leaves (_LEAVES order). Outputs (h_T,
    stats (T+1, 2, f)); stats carry no gradient."""

    @staticmethod
    def forward(ctx, steps, msgs, h0, mask, *weights):
        ht, stats, htil = K.launch_prepared(prepare_recurrence_fwd(
            msgs, h0, mask, weights, steps=steps, stash=True))
        ctx.steps = steps
        ctx.save_for_backward(msgs, h0, mask, stats, htil, *weights)
        ctx.mark_non_differentiable(stats)
        return ht, stats

    @staticmethod
    def backward(ctx, ght, _g_stats):
        msgs, h0, mask, stats, htil, *weights = ctx.saved_tensors
        dmsgs, dh0, dw = K.launch_prepared(prepare_recurrence_bwd(
            msgs, h0, mask, weights, stats, htil, ght.contiguous(),
            steps=ctx.steps))
        g = split_grads(dw, h0.shape[1])
        return (None, dmsgs, dh0, None, *(g[k] for k in _LEAVES))


def recurrence(msgs, h0, mask, gru, ma_bn, bn, *, steps: int):
    """(h_T, (ma_mean, ma_var), [(mean_t, var_t)] × steps), differentiable
    in msgs, h0 and the weights. CPU tensors run the plain version under
    autograd; CUDA tensors launch the kernels or raise. Only while autograd
    records the op does the forward keep the backward's residuals."""
    if h0.device.type == "cpu":
        return reference_recurrence(msgs, h0, mask, gru, ma_bn, bn,
                                    steps=steps)
    c = lambda t: t.contiguous()
    weights = [c(t) for t in _flat(gru, ma_bn, bn)]
    if K.records_grad(msgs, h0, *weights):
        ht, stats = _Recurrence.apply(steps, c(msgs), c(h0), c(mask),
                                      *weights)
    else:
        ht, stats, _ = K.launch_prepared(prepare_recurrence_fwd(
            c(msgs), c(h0), c(mask), weights, steps=steps, stash=False))
    return (ht, (stats[0, 0], stats[0, 1]),
            [(stats[t, 0], stats[t, 1]) for t in range(1, steps + 1)])


def recurrence_vjp_reference(msgs, h0, mask, gru, ma_bn, bn, ght, *,
                             steps: int):
    """The plain VJP: autograd of reference_recurrence for the cotangent
    ght of h_T. Returns (dmsgs, dh0, {leaf: gradient})."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_()
                  for t in (msgs, h0, *_flat(gru, ma_bn, bn))]
        m, h, w = leaves[0], leaves[1], leaves[2:]
        ht, _, _ = reference_recurrence(
            m, h, mask, dict(zip(("w_ih", "w_hh", "b_ih", "b_hh"), w)),
            {"weight": w[4], "bias": w[5]},
            {"weight": w[6], "bias": w[7]}, steps=steps)
        g = torch.autograd.grad(ht, leaves, ght.detach())
    return g[0], g[1], dict(zip(_LEAVES, g[2:]))


def recurrence_vjp(msgs, h0, mask, gru, ma_bn, bn, stats, htil, ght, *,
                   steps: int):
    """(dmsgs, dh0, {leaf: gradient}) of the chain for the cotangent ght of
    h_T, on a forward's residuals: stats (T+1, 2, f) and htil (T, N, f),
    the pre-norm states (the split backward of kernels/fused_step.py feeds
    the whole-step forward's stash). CPU tensors run the plain version
    (recurrence_vjp_reference); CUDA tensors launch the backward kernel or
    raise."""
    if h0.device.type == "cpu":
        return recurrence_vjp_reference(msgs, h0, mask, gru, ma_bn, bn, ght,
                                        steps=steps)
    weights = [t.contiguous() for t in _flat(gru, ma_bn, bn)]
    dmsgs, dh0, dw = K.launch_prepared(prepare_recurrence_bwd(
        msgs, h0, mask, weights, stats, htil, ght.contiguous(),
        steps=steps))
    return dmsgs, dh0, split_grads(dw, h0.shape[1])


def make_recurrence_op(steps: int, f: int):
    """The `recurrence_fn` hook: fn(msgs, h0, mask, gru, ma_bn, bn) → (h_T,
    ma_stats, step_stats) with the step count bound, as mpnn_tpu/kernels/
    recurrence.py::make_recurrence_op returns it — without its node cap:
    one pair of kernels takes any node count. f is checked against the
    kernels' widths at once."""
    K.width_bucket("recurrence", BUCKETS, f=f)

    def fn(msgs, h0, mask, gru, ma_bn, bn):
        return recurrence(msgs, h0, mask, gru, ma_bn, bn, steps=steps)
    return fn
