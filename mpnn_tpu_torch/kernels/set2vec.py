"""The set2vec readout op: counterpart of mpnn_tpu/kernels/set2vec.py::
make_set2vec_op (Pallas `_s2v_fwd_kernel` and `_s2v_bwd_kernel`).

    m_0 = 0 (G, 2w), c_0 = 0 (G, w); for t = 1..T:
        h_t, c_t = LSTMhidden(m_{t−1}, c_{t−1})       (no input; 2w → w)
        q_g      = h_t,g · Wq                          (w → w, no bias)
        e_v      = we · tanh(q_{g(v)} + x_v) − 1e8·(1 − mask_v)
        att      = softmax over ALL nodes of the batch (batch_softmax, the
                   reference's quirk, set2vec.py:139) or per graph
        read_g   = Σ_{v∈g} att_v · x_v
        m_t      = [h_t ‖ read]
    returns m_T (G, 2w)

With the batch-global softmax a molecule's output depends on the other
molecules of its batch, as in the reference. `set2vec` is a
torch.autograd.Function whose forward and backward are one cooperative
CUDA launch each (csrc/set2vec_fwd.cu, csrc/set2vec_bwd.cu), shaped by
`launch_shape` on the host: one block for a batch of at most 32 graphs
that fits it, else a block per SM; a block whose node rows exceed its
staging capacity streams them (the chunked route), and a block with more
graphs than its shared memory holds slots for keeps them in global
scratch (the spilled route). For training the
forward writes the residual stash — a row per step and graph (input
carry, gates, query) and each step's attention row — which the backward
walks in reverse; serving skips it. CPU tensors run the plain version
set2vec_reference (under autograd); CUDA tensors launch the kernels or
raise — no fallback.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple

import torch

from mpnn_tpu_torch.kernels import fused_step as K
from mpnn_tpu_torch.ops.readout import LSTM_GATES, _lstm_hidden_apply

# width buckets of the CUDA kernels, narrowest first (as fused_step.py's):
# the set's width w = 2·nf. Each is its own build of
# csrc/set2vec_{fwd,bwd}.cu (kernels/build.py::WIDE).
BUCKETS = (("", dict(w=32)), ("w64", dict(w=64)))
MAX_WIDTH = BUCKETS[-1][1]["w"]
_BIG_NEG = -1e8          # the reference's masking constant

launch_counts: Dict[str, int] = {"set2vec_fwd": 0, "set2vec_bwd": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# plain version (CPU path; the card's comparison baseline)
# ---------------------------------------------------------------------------

def set2vec_reference(rparams, x, mask, node_graph, graph_node_ptr, *,
                      time_steps: int, batch_softmax: bool = True):
    """Plain PyTorch version of the op, make_set2vec_op's arguments minus
    the TPU window plan plus the per-graph node pointers (their length
    only is read, for G): rparams {"lstm": {w_h*, b_h*}, "q_attn": {"w"},
    "e_attn": {"w"}} in the JAX layout, x (N, w), mask (N, 1), node_graph
    (N,) with padded nodes at G. Returns m (G, 2w). The packed loop of
    mpnn_tpu/models/sparse.py::sparse_set2vec."""
    num_graphs = graph_node_ptr.shape[0] - 1
    width = x.shape[1]
    ng = node_graph.long()
    q_rows = ng.clamp(0, max(num_graphs - 1, 0))
    add_mask = (1.0 - mask[:, 0]) * _BIG_NEG
    mprev = x.new_zeros((num_graphs, 2 * width))
    cprev = x.new_zeros((num_graphs, width))
    for _ in range(time_steps):
        m, c = _lstm_hidden_apply(rparams["lstm"], mprev, cprev)
        query = m @ rparams["q_attn"]["w"]
        energies = (torch.tanh(query[q_rows] + x)
                    @ rparams["e_attn"]["w"])[:, 0] + add_mask
        if batch_softmax:
            att = torch.softmax(energies, dim=0)
        else:
            # the segment max only shifts the exponent: no gradient
            emax = energies.new_full((num_graphs + 1,), -math.inf) \
                .scatter_reduce(0, ng, energies.detach(), "amax")
            z = torch.exp(energies - emax[ng])
            denom = z.new_zeros((num_graphs + 1,)).index_add(0, ng, z)
            att = z / denom[ng]
        read = x.new_zeros((num_graphs + 1, width)).index_add(
            0, ng, att[:, None] * x)[:num_graphs]
        mprev, cprev = torch.cat([m, read], dim=1), c
    return mprev


# ---------------------------------------------------------------------------
# the launch shape: the host's route rule
# ---------------------------------------------------------------------------

MAX_WARPS = 16           # csrc/set2vec_common.cuh::kMaxWarps
MAX_GRID = 256           # csrc/set2vec_common.cuh::kMaxGrid
BWD_MIN_WARPS = 8        # the backward's block-wide leaf sums: 256 threads
ONE_BLOCK_GRAPHS = 32    # a batch of at most this many graphs: one block
MIN_ROWS = 32            # the least staging capacity a launch accepts
_FWD_PHASES, _BWD_PHASES = 5, 6   # clock64 stamps a step (csrc)


def _al4(n: int) -> int:
    return (n + 3) & ~3


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def stash_width(w: int) -> int:
    """Floats a row of the forward's training stash takes:
    [mh | mr | c | i f g o | q] (csrc/set2vec_common.cuh::stash_width)."""
    return _al4(8 * w)


def att_stride(n: int) -> int:
    """Floats a step's row of the attention stash takes (16-byte rows, so
    the backward's bulk copies start aligned)."""
    return _al4(n)


def width_bound(w: int) -> int:
    """The width bound WB the kernels are instantiated for at w
    (csrc/set2vec_common.cuh::wb_of): 16 or 32 in the narrow bucket, 64 in
    the wide one."""
    return 16 if w <= 16 else 32 if w <= BUCKETS[0][1]["w"] else 64


def _weights_floats(wb: int) -> int:
    pair = 4 * wb * (wb + 1) + (16 if wb == 16 else 0)
    rsq = 18 if wb == 16 else wb + 1
    return _al4(2 * pair) + 4 * wb + _al4(wb * rsq) + wb


def smem_floats(direction: str, w: int, gpb: int, warps: int, cap: int,
                acc_smem: bool = True, slots_smem: bool = True) -> int:
    """Shared memory (floats) of a block of `direction` ('fwd' or 'bwd')
    at width w with `gpb` graphs, `warps` warps and `cap` staged rows: the
    layouts csrc/set2vec_fwd.cu::FwdSmem and csrc/set2vec_bwd.cu::BwdSmem
    (the wrappers check the built library agrees); the backward's leaf
    accumulator in it with `acc_smem`, the graphs' slots with
    `slots_smem`."""
    wb, w8 = width_bound(w), _pad8(w)
    xs = w8 + 1
    slots = gpb if slots_smem else 0
    if direction == "fwd":
        return (_weights_floats(wb) + slots * (4 * wb + 4) + 4
                + _al4(gpb + 1) + _al4(cap * xs) + _al4(cap))
    acc = _al4(grad_layout(w)["total"][0]) if acc_smem else 0
    per_graph = 4 * wb + 4 + 8 * wb + 2 * stash_width(w)
    return (_weights_floats(wb) + acc + slots * per_graph + 4 + warps * w8
            + 4 + _al4(gpb + 1) + 2 * _al4(cap * xs) + _al4(cap)
            + 2 * _al4(cap + 8))


class S2vShape(NamedTuple):
    """A launch: `grid` blocks of `warps` warps, at most `gpb` graphs a
    block, `cap` node rows staged a block (a block with more streams them:
    the chunked route), `smem` bytes of shared memory a block, the
    backward's leaf accumulator in shared memory (`acc_smem`) or in the
    block's row of global scratch, the graphs' slots in shared memory
    (`slots_smem`) or in the block's region of global scratch (the
    spilled route)."""
    grid: int
    warps: int
    gpb: int
    cap: int
    smem: int
    acc_smem: bool = True
    slots_smem: bool = True

    @property
    def route(self) -> str:
        return "one-block" if self.grid == 1 else "grid"

    def tag(self, graph_node_ptr) -> str:
        """The route of a batch with these node pointers (a sequence of G
        + 1 ints), and what gives way on it: 'one-block' or 'grid', then
        'chunked' when a block's rows pass `cap`, 'global-acc',
        'spilled'."""
        ptr, g = [int(p) for p in graph_node_ptr], len(graph_node_ptr) - 1
        most = max(ptr[(b + 1) * g // self.grid] - ptr[b * g // self.grid]
                   for b in range(self.grid))
        return " ".join([self.route] + ["chunked"] * (most > self.cap)
                        + ["global-acc"] * (not self.acc_smem)
                        + ["spilled"] * (not self.slots_smem))


def launch_shape(direction: str, n_nodes: int, n_graphs: int, w: int, *,
                 smem_bytes: int, sms: int) -> S2vShape:
    """The route rule, from the shapes alone: a batch of at most
    ONE_BLOCK_GRAPHS graphs whose node slots all fit one block's staging
    capacity runs as ONE block (a warp per graph, no grid barrier); any
    other as min(sms, G, MAX_GRID) blocks, one per SM, a warp per graph up
    to MAX_WARPS (the backward at least BWD_MIN_WARPS, for its block-wide
    leaf sums). A block stages up to `cap` node rows — all the slots if they
    fit, else as many as `smem_bytes` leaves — and a block whose graphs
    hold more streams them in chunks of `cap` rows. A block must stage at
    least MIN_ROWS rows (or all the slots); what gives way for them, in
    turn: the backward's leaf accumulator (in shared memory in the narrow
    bucket, else the block's row of global scratch — past ~40 graphs a
    block at w 32, and always in the wide bucket, whose 145 KB do not fit
    beside the weights' 151 KB), then the graphs' slots (the spilled
    route: the backward past ~9 graphs a block at w 54-64, the forward
    past ~70). NotImplementedError only when the weights alone leave no
    room (a card with less shared memory than an H100)."""
    budget = smem_bytes // 4

    def fit(grid, acc_smem, slots_smem):
        gpb = -(-n_graphs // grid)
        warps = min(MAX_WARPS, max(gpb, BWD_MIN_WARPS if direction == "bwd"
                                   else 1))
        floats = lambda cap: smem_floats(direction, w, gpb, warps, cap,
                                         acc_smem, slots_smem)
        cap = max(1, n_nodes)
        if floats(cap) > budget:
            per = 2 * (_pad8(w) + 1) + 3 if direction == "bwd" \
                else _pad8(w) + 2
            cap = max(0, (budget - floats(0)) // per)
            while cap > 0 and floats(cap) > budget:
                cap -= 1
        return S2vShape(grid, warps, gpb, cap, 4 * floats(cap), acc_smem,
                        slots_smem)

    # (acc_smem, slots_smem), in the order they give way
    if direction == "fwd":
        tiers = [(True, True), (True, False)]
    else:
        tiers = [(True, True)] * (w <= BUCKETS[0][1]["w"]) + [
            (False, True), (False, False)]
    if n_graphs <= ONE_BLOCK_GRAPHS:
        one = fit(1, *tiers[0])
        if one.cap >= n_nodes:
            return one
    grid = min(sms, n_graphs, MAX_GRID)
    for acc_smem, slots_smem in tiers:
        shape = fit(grid, acc_smem, slots_smem)
        if shape.cap >= min(MIN_ROWS, n_nodes):
            return shape
    raise NotImplementedError(
        f"set2vec_{direction}: {n_graphs} graphs of width {w} leave room "
        f"for {shape.cap} staged rows a block ({smem_bytes} bytes of shared "
        f"memory, {sms} SMs); at least {MIN_ROWS} are needed")


def device_shape(direction: str, n_nodes: int, n_graphs: int, w: int,
                 device) -> S2vShape:
    """launch_shape on `device`'s SM count and shared-memory limit."""
    props = torch.cuda.get_device_properties(device)
    return launch_shape(direction, n_nodes, n_graphs, w,
                        smem_bytes=props.shared_memory_per_block_optin,
                        sms=props.multi_processor_count)


# ---------------------------------------------------------------------------
# the CUDA kernels' libraries
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "set2vec_fwd": {
        "mpnn_set2vec_fwd": ([_P] * 17 + [_I] * 10 + [_P], _I),
        "mpnn_set2vec_fwd_smem_bytes": ([_I] * 4, _I),
        "mpnn_set2vec_stash_width": ([_I], _I),
        "mpnn_set2vec_fwd_scratch_floats": ([_I] * 5, ctypes.c_longlong),
        "mpnn_set2vec_floor": ([_I] * 3 + [_P] * 3, _I),
    },
    "set2vec_bwd": {
        "mpnn_set2vec_bwd": ([_P] * 19 + [_I] * 11 + [_P], _I),
        "mpnn_set2vec_bwd_smem_bytes": ([_I] * 6, _I),
        "mpnn_set2vec_bwd_layout": ([_I, _P], None),
        "mpnn_set2vec_bwd_scratch_floats": ([_I] * 5, ctypes.c_longlong),
    },
}


def _lib(name: str, tag: str = ""):
    return K._lib(name, _SIGNATURES, tag)


# the differentiable leaves, in the kernels' argument order and the
# backward's flat gradient layout (csrc/set2vec_bwd.cu::S2vGradLayout)
_GRAD_LEAVES = tuple(f"w_h{k}" for k in LSTM_GATES) + tuple(
    f"b_h{k}" for k in LSTM_GATES) + ("q_w", "e_w")


def _leaf_shapes(w: int):
    return [(2 * w, w)] * 4 + [(1, w)] * 4 + [(w, w), (w, 1)]


def grad_layout(w: int) -> Dict[str, tuple]:
    """{leaf: (offset, shape)} of the backward kernel's flat gradient."""
    out, off = {}, 0
    for name, shape in zip(_GRAD_LEAVES, _leaf_shapes(w)):
        out[name] = (off, shape)
        off += math.prod(shape)
    out["total"] = (off, ())
    return out


def split_grads(dw: torch.Tensor, w: int):
    return {name: dw[off:off + math.prod(shape)].view(shape)
            for name, (off, shape) in grad_layout(w).items()
            if name != "total"}


def flat_leaves(rparams):
    """The readout's leaves in _GRAD_LEAVES order, contiguous (the JAX
    layout of an nn.Linear weight is its transposed view)."""
    lstm = rparams["lstm"]
    return [t.contiguous() for t in
            [lstm[n] for n in _GRAD_LEAVES[:8]]
            + [rparams["q_attn"]["w"], rparams["e_attn"]["w"]]]


def check_node_layout(mask, node_graph, graph_node_ptr,
                      who: str = "set2vec") -> None:
    """The invariants the kernels rely on, with one device sync: graphs
    node-contiguous in order (node_graph non-decreasing, padded nodes and
    only they at G with mask 0, real masks 1) and graph_node_ptr the
    graphs' node ranges."""
    g = graph_node_ptr.shape[0] - 1
    ng = node_graph.long()
    bad = torch.stack([
        (ng[1:] < ng[:-1]).any(),
        ((ng > g) | (ng < 0)).any(),
        (mask[:, 0] != (ng < g).to(mask.dtype)).any(),
        ((graph_node_ptr[0] != 0)
         | (graph_node_ptr.long().diff()
            != torch.bincount(ng.clamp(0, g), minlength=g + 1)[:g])).any()])
    names = ["node_graph not non-decreasing", "node_graph out of [0, G]",
             "mask must be 1 on real nodes and 0 on padded nodes",
             "graph_node_ptr disagrees with node_graph"]
    for flag, what in zip(bad.cpu().tolist(), names):
        if flag:
            raise ValueError(f"{who}: {what}")


def _check_inputs(leaves, x, mask, node_graph, graph_node_ptr, steps):
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"set2vec: unsupported device {device}")
    n, w = x.shape
    K.width_bucket("set2vec", BUCKETS, w=w)
    if steps < 1:
        raise NotImplementedError(f"set2vec: time_steps={steps}")
    for name, t, shape in zip(_GRAD_LEAVES, leaves, _leaf_shapes(w)):
        K._check(name, t, shape, device, torch.float32)
    K._check("x", x, (n, w), device, torch.float32)
    K._check("mask", mask, (n, 1), device, torch.float32)
    K._check("node_graph", node_graph, (n,), device, torch.int32)
    g = graph_node_ptr.shape[0] - 1
    K._check("graph_node_ptr", graph_node_ptr, (g + 1,), device,
             torch.int32)
    check_node_layout(mask, node_graph, graph_node_ptr)
    return n, w, g


def _checked_shape(lib, direction, n, g, w, device) -> S2vShape:
    """device_shape, held against the built library's own shared-memory
    size for it."""
    shape = device_shape(direction, n, g, w, device)
    fn = getattr(lib, f"mpnn_set2vec_{direction}_smem_bytes")
    size = fn(w, shape.gpb, shape.cap, int(shape.slots_smem)) \
        if direction == "fwd" else fn(w, shape.gpb, shape.warps, shape.cap,
                                      int(shape.acc_smem),
                                      int(shape.slots_smem))
    if size != shape.smem:
        raise RuntimeError(f"set2vec_{direction}: the built library's "
                           f"shared memory ({size} B) disagrees with "
                           f"launch_shape's ({shape.smem} B)")
    return shape


class S2vMeta(NamedTuple):
    steps: int
    batch_softmax: bool


def prepare_set2vec_fwd(leaves, x, mask, node_graph, graph_node_ptr,
                        meta: S2vMeta, *, stash: bool,
                        stamps=None) -> K.PreparedLaunch:
    """One checked forward launch: outputs m (G, 2w) and, with `stash`,
    the residuals the backward reads — a row per step and graph (T, G,
    stash_width(w)) and the attention rows (T, att_stride(N)) — else empty
    tensors. `stamps`, an int64 (T, 5) tensor, takes block 0's clock64
    stamps of each step's phases."""
    n, w, g = _check_inputs(leaves, x, mask, node_graph, graph_node_ptr,
                            meta.steps)
    lib = _lib("set2vec_fwd", K.width_bucket("set2vec", BUCKETS, w=w))
    if lib.mpnn_set2vec_stash_width(w) != stash_width(w):
        raise RuntimeError("set2vec_fwd: the built library's stash row "
                           "disagrees with stash_width")
    T = meta.steps
    shape = _checked_shape(lib, "fwd", n, g, w, x.device)
    kw = dict(dtype=torch.float32, device=x.device)
    m = torch.empty(g, 2 * w, **kw)
    carry = torch.empty(T, g, stash_width(w), **kw) if stash \
        else torch.empty(0, **kw)
    att = torch.empty(T, att_stride(n), **kw) if stash \
        else torch.empty(0, **kw)
    part = torch.empty(lib.mpnn_set2vec_fwd_scratch_floats(
        w, T, shape.grid, shape.gpb, int(shape.slots_smem)), **kw)
    tensors = list(leaves) + [x, graph_node_ptr, m, carry, att, part]
    ptrs = [t.data_ptr() for t in tensors]
    if not stash:
        ptrs[-3] = ptrs[-2] = None
    if stamps is not None:
        K._check("stamps", stamps, (T, _FWD_PHASES), x.device, torch.int64)
        tensors.append(stamps)
    args = (*ptrs, None if stamps is None else stamps.data_ptr(), n, g, w,
            T, int(meta.batch_softmax), shape.grid, shape.warps, shape.gpb,
            shape.cap, int(shape.slots_smem),
            torch.cuda.current_stream(x.device).cuda_stream)
    return K.PreparedLaunch("set2vec_fwd", lib.mpnn_set2vec_fwd,
                            lib.mpnn_cuda_error_string, args,
                            (m, carry, att), tuple(tensors), launch_counts)


def prepare_set2vec_bwd(leaves, x, graph_node_ptr, carry, att, gm,
                        meta: S2vMeta, *, stamps=None) -> K.PreparedLaunch:
    """One checked backward launch on the forward's stash: outputs dx
    (N, w) and the flat gradient of grad_layout. `stamps`, an int64
    (T, 6) tensor, takes block 0's clock64 stamps of each step's phases."""
    device = x.device
    n, w = x.shape
    g, T = graph_node_ptr.shape[0] - 1, meta.steps
    for name, t, shape in [("carry", carry, (T, g, stash_width(w))),
                           ("att", att, (T, att_stride(n))),
                           ("gm", gm, (g, 2 * w))]:
        K._check(name, t, shape, device, torch.float32)
    lib = _lib("set2vec_bwd", K.width_bucket("set2vec", BUCKETS, w=w))
    layout = grad_layout(w)
    c_layout = (ctypes.c_int * 11)()
    lib.mpnn_set2vec_bwd_layout(w, c_layout)
    if [v[0] for v in layout.values()] != list(c_layout):
        raise RuntimeError("set2vec_bwd: the gradient layout of the built "
                           "library disagrees with grad_layout")
    shape = _checked_shape(lib, "bwd", n, g, w, device)
    kw = dict(dtype=torch.float32, device=device)
    dx = torch.empty(n, w, **kw)
    dw = torch.empty(layout["total"][0], **kw)
    scratch = torch.empty(lib.mpnn_set2vec_bwd_scratch_floats(
        w, T, shape.grid, shape.gpb, int(shape.slots_smem)), **kw)
    tensors = list(leaves) + [x, graph_node_ptr, carry, att, gm, dx, dw,
                              scratch]
    if stamps is not None:
        K._check("stamps", stamps, (T, _BWD_PHASES), device, torch.int64)
    args = (*(t.data_ptr() for t in tensors),
            None if stamps is None else stamps.data_ptr(), n, g, w, T,
            int(meta.batch_softmax), shape.grid, shape.warps, shape.gpb,
            shape.cap, int(shape.acc_smem), int(shape.slots_smem),
            torch.cuda.current_stream(device).cuda_stream)
    if stamps is not None:
        tensors.append(stamps)
    return K.PreparedLaunch("set2vec_bwd", lib.mpnn_set2vec_bwd,
                            lib.mpnn_cuda_error_string, args, (dx, dw),
                            tuple(tensors), launch_counts)


def prepare_barrier_floor(n_nodes: int, n_graphs: int, w: int, steps: int,
                          device) -> K.PreparedLaunch:
    """The forward's grid and batch-global combine over `steps` empty steps
    (csrc/set2vec_fwd.cu::set2vec_floor_kernel): the floor its waits set.
    A measurement kernel; it counts in no launch table of the ops."""
    lib = _lib("set2vec_fwd", K.width_bucket("set2vec", BUCKETS, w=w))
    shape = device_shape("fwd", n_nodes, n_graphs, w, device)
    kw = dict(dtype=torch.float32, device=device)
    part = torch.empty(lib.mpnn_set2vec_fwd_scratch_floats(
        w, steps, shape.grid, shape.gpb, 1), **kw)
    out = torch.empty(1, **kw)
    args = (shape.grid, shape.warps, steps, part.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    return K.PreparedLaunch("set2vec_floor", lib.mpnn_set2vec_floor,
                            lib.mpnn_cuda_error_string, args, (out,),
                            (part, out), {"set2vec_floor": 0})


class _Set2Vec(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its VJP. Inputs:
    meta, stash (K.records_grad of the leaves), the 10 leaves
    (_GRAD_LEAVES order), x, then mask, node_graph and graph_node_ptr.
    Output m (G, 2w)."""

    @staticmethod
    def forward(ctx, meta, stash, *args):
        leaves, (x, mask, node_graph, gnp) = args[:10], args[10:]
        m, carry, att = K.launch_prepared(prepare_set2vec_fwd(
            leaves, x, mask, node_graph, gnp, meta, stash=stash))
        ctx.meta = meta
        ctx.save_for_backward(*leaves, x, gnp, carry, att)
        return m

    @staticmethod
    def backward(ctx, gm):
        saved = ctx.saved_tensors
        leaves, (x, gnp, carry, att) = saved[:10], saved[10:]
        dx, dw = K.launch_prepared(prepare_set2vec_bwd(
            leaves, x, gnp, carry, att, gm.contiguous(), ctx.meta))
        grads = split_grads(dw, x.shape[1])
        return (None, None, *(grads[name] for name in _GRAD_LEAVES), dx,
                None, None, None)


def set2vec(rparams, x, mask, node_graph, graph_node_ptr, *,
            time_steps: int, batch_softmax: bool = True):
    """The set2vec readout: m (G, 2w), differentiable in the readout's
    leaves and x. Arguments as set2vec_reference. CPU tensors run the
    plain version under autograd; CUDA tensors launch the forward kernel
    (and, in the backward pass, the backward kernel) or raise."""
    if x.device.type == "cpu":
        return set2vec_reference(rparams, x, mask, node_graph,
                                 graph_node_ptr, time_steps=time_steps,
                                 batch_softmax=batch_softmax)
    leaves = (*flat_leaves(rparams), x)
    return _Set2Vec.apply(S2vMeta(int(time_steps), bool(batch_softmax)),
                          K.records_grad(*leaves), *leaves, mask,
                          node_graph, graph_node_ptr)
