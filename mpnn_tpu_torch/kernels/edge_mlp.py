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
forward. launch_shape picks each launch's route from the shapes alone,
on the host, before the launch: W_s's columns in registers at pf <= 64,
W_s's column panels over a thread-block cluster above, and past what a
cluster of 8 holds the same clusters reading W_s from device memory
(csrc/edge_mlp_common.cuh).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Sequence

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


# ---------------------------------------------------------------------------
# the launch shape: the route and the rows a block holds, from shapes alone
# ---------------------------------------------------------------------------

# csrc/edge_mlp_common.cuh's constants
REG_MAX_PF = 64           # widest W_s kept in registers (the register route)
MAX_CLUSTER = 8           # the portable cluster size (the panel route)
PANEL_THREADS = 256
RT = 4                    # rows a thread computes on the panel route
PROF_SLOTS = 20
# Rows a register-route block holds when the rows allow (one or two warps
# compute a row). The forward's rows are independent: 2 a block spread a
# layer's shared-memory loads and instructions over more SMs. The
# backward's blocks each form a partial ∂W_s after the walk (rows·T·pf²)
# that the last block sums: 4 rows, a warp or two on each of an SM's four
# schedulers. scripts/time_edge_mlp.py --sweep measures both.
REG_ROWS = {"fwd": 2, "bwd": 4}


def _r4(n: int) -> int:
    return (n + 3) // 4 * 4


def reg_kp(pf: int) -> int:
    """The register route's W_s vector (pf rounded up to 8 floats)."""
    return (pf + 7) // 8 * 8


def reg_lanes(kp: int) -> int:
    """Threads of a register-route row: a column each, one warp at pf <= 32,
    two above."""
    return 64 if kp > 32 else 32


def reg_max_threads(kp: int) -> int:
    """The most threads a register-route block has (a thread's W_s column
    costs kp registers)."""
    return 1024 if kp <= 32 else 640 if kp <= 48 else 512


def smem_floats(direction: str, dims: Sequence[int], tail: int, kp: int,
                cluster: int, rb: int, l2: bool = False) -> int:
    """Dynamic shared memory of a block, in floats: csrc/edge_mlp_common.cuh::
    Plan's total (kp > 0 the register route, 0 the panel route; l2: W_s
    and the backward's tail stash in device memory)."""
    pf = dims[-1]
    ld = kp if kp else _r4(pf)
    pp = kp if kp else _r4(-(-pf // cluster))
    wld = kp + 4 if kp else pp
    rbp = rb if kp else _r4(rb)
    n = sum(_r4(_r4(i) * (o | 1)) + _r4(o) for i, o in zip(dims, dims[1:]))
    n += (0 if l2 else _r4(_r4(pf) * wld)) + _r4(2 * rbp * ld)
    if direction == "bwd":
        n += sum(_r4(rbp * _r4(d)) for d in dims)          # head inputs, y_H
        n += sum(_r4(rbp * _r4(d)) for d in dims[1:])      # head gz
        if not l2:
            n += _r4((tail + 1) * rbp * pp) + _r4(tail * rbp * pp)
    return n


class MlpShape(NamedTuple):
    """A launch: the route ('reg', 'panel' or 'l2'), the register vector kp
    (0 off the register route), blocks a cluster, rows a block (a cluster)
    holds, the clusters, threads a block, dynamic shared memory (bytes)."""
    route: str
    kp: int
    cluster: int
    rb: int
    clusters: int
    threads: int
    smem_bytes: int

    @property
    def grid(self) -> int:
        return self.clusters * self.cluster

    def c_args(self):
        """(rb, cluster, kp, l2) as the C entry points take them."""
        return self.rb, self.cluster, self.kp, int(self.route == "l2")

    def tag(self) -> str:
        return (f"{self.route} C{self.cluster} rb{self.rb} "
                f"x{self.clusters}")


def launch_shape(direction: str, rows: int, dims: Sequence[int], tail: int,
                 *, smem_bytes: int, sms: int) -> MlpShape:
    """The route rule. pf <= 64: the register route, a thread an output
    column (a row is a warp, two past pf 32), REG_ROWS rows a block, or
    rows / sms if more, at most what the block's threads (reg_max_threads,
    15 rows: a named barrier each) and shared memory hold (the backward
    keeps every layer's rows). pf > 64: the panel route, a cluster of the
    fewest blocks (1, 2, 4, 8) whose W_s panels and rows fit — at least RT
    rows, a rank owning columns — holding RT rows or rows / (sms /
    cluster). Past what a cluster of 8 holds (pf ~468 in the backward at T
    50, ~640 in the forward), the l2 route: the panel route's clusters of 8
    with W_s and the backward's stash in device memory. The rows are then
    balanced over the blocks. NotImplementedError only when RT rows and
    the head weights do not fit a block (no head and pf past ~4,700)."""
    pf, budget = dims[-1], smem_bytes // 4
    floats = lambda kp, c, rb, l2=False: smem_floats(direction, dims, tail,
                                                     kp, c, rb, l2)

    def balance(rb, route, kp, cluster, threads):
        n = -(-rows // rb)
        rb = -(-rows // n)
        return MlpShape(route, kp, cluster, rb, n, threads(rb),
                        4 * floats(kp, cluster, rb, route == "l2"))
    if pf <= REG_MAX_PF:
        kp, lanes = reg_kp(pf), reg_lanes(reg_kp(pf))
        cap = min(15, reg_max_threads(kp) // lanes)   # a named barrier a row
        while cap > 0 and floats(kp, 1, cap) > budget:
            cap -= 1
        if cap < 1:
            raise NotImplementedError(
                f"edge_mlp_{direction}: one row at pf {pf} needs "
                f"{4 * floats(kp, 1, 1)} bytes of shared memory; the card "
                f"has {smem_bytes}")
        rb = min(cap, max(REG_ROWS[direction], -(-rows // sms)))
        return balance(rb, "reg", kp, 1, lambda r: lanes * r)
    for cluster in (1, 2, 4, 8):
        panel = _r4(-(-pf // cluster))
        if (cluster - 1) * panel >= pf:
            continue
        cap = 0
        while floats(0, cluster, cap + RT) <= budget:
            cap += RT
        if cap < RT:
            continue
        rb = min(cap, max(RT, -(-rows // max(1, sms // cluster))))
        return balance(rb, "panel", 0, cluster, lambda r: PANEL_THREADS)
    cluster, cap = MAX_CLUSTER, 0
    while floats(0, cluster, cap + RT, True) <= budget:
        cap += RT
    if cap < RT:
        raise NotImplementedError(
            f"edge_mlp_{direction}: {RT} rows and the head weights at dims "
            f"{list(dims)} need {4 * floats(0, cluster, RT, True)} bytes of "
            f"shared memory a block; the card has {smem_bytes}")
    rb = min(cap, max(RT, -(-rows // max(1, sms // cluster))))
    return balance(rb, "l2", 0, cluster, lambda r: PANEL_THREADS)


_SHAPES: Dict[tuple, MlpShape] = {}


def device_shape(direction: str, rows: int, dims: Sequence[int], tail: int,
                 device) -> MlpShape:
    """launch_shape on `device`'s SM count and shared-memory limit."""
    key = (direction, rows, tuple(dims), tail, str(device))
    if key not in _SHAPES:
        props = torch.cuda.get_device_properties(device)
        _SHAPES[key] = launch_shape(
            direction, rows, dims, tail,
            smem_bytes=props.shared_memory_per_block_optin,
            sms=props.multi_processor_count)
    return _SHAPES[key]


_I, _P = ctypes.c_int, ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "edge_mlp_fwd": {
        "mpnn_edge_mlp_fwd": ([_P, _PP, _PP, _P, _IP] + [_I] * 7
                              + [_P, _P, _P], _I),
        "mpnn_edge_mlp_fwd_smem_bytes": ([_IP] + [_I] * 7, _I),
        "mpnn_edge_mlp_fwd_floor": ([_IP] + [_I] * 8 + [_P], _I),
    },
    "edge_mlp_bwd": {
        "mpnn_edge_mlp_bwd": ([_P, _PP, _PP, _P, _IP] + [_I] * 7
                              + [_P] * 7, _I),
        "mpnn_edge_mlp_bwd_layout": ([_IP, _I, _IP], None),
        "mpnn_edge_mlp_bwd_smem_bytes": ([_IP] + [_I] * 7, _I),
        "mpnn_edge_mlp_bwd_scratch_floats": ([_IP] + [_I] * 7,
                                             ctypes.c_longlong),
        "mpnn_edge_mlp_bwd_floor": ([_IP] + [_I] * 8 + [_P], _I),
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


def _prof_ptr(prof):
    """A clock64 stamp buffer (int64, PROF_SLOTS, on the device) or null."""
    if prof is None:
        return None
    if prof.dtype != torch.int64 or prof.numel() < PROF_SLOTS:
        raise ValueError(f"prof: int64 with {PROF_SLOTS} slots expected")
    return prof.data_ptr()


def prepare_edge_mlp_fwd(x, head_ws, head_bs, shared_w, *, tail: int,
                         prof=None) -> K.PreparedLaunch:
    """One checked forward launch: output pen (R, pf). `prof` (optional):
    block 0's clock64 stamps (csrc/edge_mlp_fwd.cu)."""
    dims = _check_inputs("edge_mlp", x, head_ws, head_bs, shared_w, tail)
    shape = device_shape("fwd", x.shape[0], dims, tail, x.device)
    lib = _lib("edge_mlp_fwd")
    out = torch.empty(x.shape[0], dims[-1], dtype=torch.float32,
                      device=x.device)
    keep = (x, *head_ws, *head_bs, shared_w, out, prof)
    args = (x.data_ptr(), _pointers(head_ws), _pointers(head_bs),
            shared_w.data_ptr(), _int_array(dims), len(head_ws),
            x.shape[0], tail, *shape.c_args(), out.data_ptr(),
            _prof_ptr(prof),
            torch.cuda.current_stream(x.device).cuda_stream)
    return K.PreparedLaunch("edge_mlp_fwd", lib.mpnn_edge_mlp_fwd,
                            lib.mpnn_cuda_error_string, args, out, keep,
                            launch_counts)


# The backward's cross-block counters, one buffer of MAX_CLUSTER ints per
# device and stream, zeroed once here: each launch leaves them zero.
_COUNTERS: Dict[tuple, torch.Tensor] = {}


def _counters(device, stream: int) -> torch.Tensor:
    key = (str(device), stream)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(MAX_CLUSTER, dtype=torch.int32,
                                     device=device)
    return _COUNTERS[key]


def prepare_edge_mlp_bwd(x, head_ws, head_bs, shared_w, gpen, *,
                         tail: int, prof=None) -> K.PreparedLaunch:
    """One checked backward launch: outputs dx (R, ef) and the flat
    gradient of grad_layout. `prof` as prepare_edge_mlp_fwd's."""
    dims = _check_inputs("edge_mlp", x, head_ws, head_bs, shared_w, tail)
    rows, h = x.shape[0], len(head_ws)
    K._check("gpen", gpen, (rows, dims[-1]), x.device, torch.float32)
    shape = device_shape("bwd", rows, dims, tail, x.device)
    lib = _lib("edge_mlp_bwd")
    layout = grad_layout(dims)
    c_dims = _int_array(dims)
    c_layout = (ctypes.c_int * (2 * h + 2))()
    lib.mpnn_edge_mlp_bwd_layout(c_dims, h, c_layout)
    if [v[0] for v in layout.values()] != list(c_layout):
        raise RuntimeError("edge_mlp_bwd: the gradient layout of the built "
                           "library disagrees with grad_layout")
    kw = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty(rows, dims[0], **kw)
    dw = torch.empty(layout["total"][0], **kw)
    n = lib.mpnn_edge_mlp_bwd_scratch_floats(c_dims, h, rows, tail,
                                             *shape.c_args())
    scratch = torch.empty(max(n, 1), **kw)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    counters = _counters(x.device, stream) if shape.clusters > 1 else None
    keep = (x, *head_ws, *head_bs, shared_w, gpen, dx, dw, scratch, counters,
            prof)
    args = (x.data_ptr(), _pointers(head_ws), _pointers(head_bs),
            shared_w.data_ptr(), c_dims, h, rows, tail, *shape.c_args(),
            gpen.data_ptr(), dx.data_ptr(), dw.data_ptr(),
            scratch.data_ptr() if n else None,
            None if counters is None else counters.data_ptr(),
            _prof_ptr(prof), stream)
    return K.PreparedLaunch("edge_mlp_bwd", lib.mpnn_edge_mlp_bwd,
                            lib.mpnn_cuda_error_string, args, (dx, dw), keep,
                            launch_counts)


def launch_floor(direction: str, rows: int, dims: Sequence[int], tail: int,
                 layers: int, device) -> None:
    """The empty-chain floor of a launch: a kernel with the same grid,
    block, cluster and shared memory as edge_mlp_<direction> on these
    shapes and `layers` barrier-separated empty layers (csrc/
    edge_mlp_{fwd,bwd}.cu). Counts nothing: a measurement's yardstick."""
    shape = device_shape(direction, rows, dims, tail, device)
    lib = _lib(f"edge_mlp_{direction}")
    fn = getattr(lib, f"mpnn_edge_mlp_{direction}_floor")
    err = fn(_int_array(dims), len(dims) - 1, rows, tail, *shape.c_args(),
             layers,
             torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"edge_mlp_{direction} floor launch failed: "
                           + lib.mpnn_cuda_error_string(err).decode())


def library_smem_bytes(direction: str, rows: int, dims: Sequence[int],
                       tail: int, shape: MlpShape) -> int:
    """The built library's shared memory for `shape` (0: a shape it does
    not take), to hold against smem_floats."""
    lib = _lib(f"edge_mlp_{direction}")
    fn = getattr(lib, f"mpnn_edge_mlp_{direction}_smem_bytes")
    return fn(_int_array(dims), len(dims) - 1, rows, tail, *shape.c_args())


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
