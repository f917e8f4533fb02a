"""The attention SDDMM op of the decomposed training path on the CPU against
the JAX package: the port's op (kernels/sddmm.py; its plain version on CPU
tensors) — the forward, and the gradients of aprime, evocab, wa, ba and h
through autograd — against mpnn_tpu/kernels/sddmm.py's Pallas op in
interpret mode (its transposed layout `t` at mf == nf with a 128-aligned
window plan, its row layout at mf != nf) and its sddmm_att_reference under
jax.vjp, on the same numpy inputs.

Inputs as tests/test_torch_spmm.py::_batch makes them (contiguous graphs
of 3 to 23 nodes with local edges, vocab ids 1..K−1, a padded tail of
edges on the dummy node with id 0), with the attention weights of
tests/test_kernels.py::TestSddmm. One case gives aprime[0] — the model's
A'_0 = pen(0)·W̃ + Bf, never zero — random values and h and the cotangent
random rows at the dummy node, so the padded edges carry messages and
gradients. Tolerances as tests/test_kernels.py::TestSddmm: the forward
atol 2e-4, each gradient rtol 1e-4 / atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpnn_tpu.kernels import sddmm as J
from mpnn_tpu.kernels.spmm import plan_edge_windows
from mpnn_tpu_torch.graphs.batching import FusedEvalPlan, plan_fused_eval
from mpnn_tpu_torch.kernels import sddmm as D
from test_torch_spmm import _batch

FWD_ATOL = 2e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4
NAMES = ("out", "d aprime", "d evocab", "d wa", "d ba", "dh")

# (k, nf, mf, ef, graphs, seed, layout, padded edges carry messages)
CASES = {
    "adv_widths": (9, 7, 7, 6, 20, 0, "t", False),
    "mf_ne_nf": (9, 10, 13, 6, 12, 1, "rows", False),
    "real_widths": (64, 27, 27, 6, 12, 2, "t", False),
    "sink_messages": (9, 7, 7, 6, 20, 3, "t", True),
}


def _problem(k, nf, mf, ef, n_graphs, seed, sink):
    """(aprime, evocab, wa, ba, h, vid, src, dst, edge_mask, node_cap,
    gout) in numpy."""
    _, h, vid, src, dst, mask, node_cap, _ = _batch(k, nf, n_graphs, seed)
    rs = np.random.RandomState(seed + 100)
    aprime = (rs.randn(k, mf, nf) * 0.3).astype(np.float32)
    evocab = rs.randn(k, ef).astype(np.float32)
    wa = (rs.randn(nf + ef, nf) * 0.3).astype(np.float32)
    ba = (rs.randn(nf) * 0.1).astype(np.float32)
    gout = rs.randn(node_cap, mf).astype(np.float32)
    if sink:
        h[node_cap - 1] = rs.randn(nf)
    else:
        aprime[0] = 0.0
    return (aprime, evocab, wa, ba, h, vid, src, dst, mask, node_cap, gout)


def _port(aprime, evocab, wa, ba, h, vid, src, dst, node_cap, gout):
    """The port's hook on CPU tensors: out and the five gradients for the
    cotangent gout."""
    plan = FusedEvalPlan(*(torch.from_numpy(p) for p in plan_fused_eval(
        dst, np.zeros(node_cap, np.int32), 1)))
    leaves = [torch.tensor(x, requires_grad=True)
              for x in (aprime, evocab, wa, ba, h)]
    out = D.make_sddmm_op()(*leaves, *(torch.from_numpy(x)
                                       for x in (vid, src, dst)), plan)
    (out * torch.from_numpy(gout)).sum().backward()
    return [out.detach().numpy()] + [x.grad.numpy() for x in leaves]


def _jax(fn, aprime, evocab, wa, ba, h, vid, src, dst, gout):
    """fn's out and its five gradients through jax.vjp."""
    idx = [jnp.asarray(x) for x in (vid, src, dst)]
    out, vjp = jax.vjp(lambda *p: fn(*p, *idx),
                       *(jnp.asarray(x) for x in (aprime, evocab, wa, ba,
                                                  h)))
    return [np.asarray(out)] + [np.asarray(g) for g in
                                vjp(jnp.asarray(gout))]


def _close(got, want):
    np.testing.assert_allclose(got[0], want[0], atol=FWD_ATOL,
                               err_msg="out")
    for x, w, name in zip(got[1:], want[1:], NAMES[1:]):
        assert x.shape == w.shape, name
        np.testing.assert_allclose(x, w, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_port_matches_pallas_interpret(case):
    """Forward and the five gradients of the port's op against the Pallas
    op (make_sddmm_op(interpret=True)) in the case's layout, its window
    plan from plan_edge_windows (align 128 for `t`). The Pallas kernels
    take an edge only inside its block's node window, which is planned on
    the real edges: where the padded edges carry messages, every block
    holding one must see the dummy node, or the comparison would miss
    them."""
    k, nf, mf, ef, n_graphs, seed, layout, sink = CASES[case]
    (aprime, evocab, wa, ba, h, vid, src, dst, mask, node_cap,
     gout) = _problem(k, nf, mf, ef, n_graphs, seed, sink)
    plan = plan_edge_windows(src, dst, mask, node_cap, block_edges=128,
                             align=128 if layout == "t" else 16)
    assert plan is not None
    if sink:
        blocks = np.unique(np.nonzero(mask == 0)[0] // plan.block_edges)
        assert (plan.win_start[blocks] + plan.window > node_cap - 1).all()
    op = J.make_sddmm_op(block_edges=plan.block_edges, window=plan.window,
                         interpret=True, layout=layout)
    win = jnp.asarray(plan.win_start)
    want = _jax(lambda *x: op(*x, win), aprime, evocab, wa, ba, h, vid, src,
                dst, gout)
    _close(_port(aprime, evocab, wa, ba, h, vid, src, dst, node_cap, gout),
           want)


@pytest.mark.parametrize("case", list(CASES))
def test_port_matches_xla_reference(case):
    """The same against the JAX package's sddmm_att_reference (gather,
    softmax, einsum, segment_sum) under jax.vjp: the function the port's
    plain version copies line for line, padded edges included."""
    k, nf, mf, ef, n_graphs, seed, _, sink = CASES[case]
    (aprime, evocab, wa, ba, h, vid, src, dst, _, node_cap,
     gout) = _problem(k, nf, mf, ef, n_graphs, seed, sink)
    got = _port(aprime, evocab, wa, ba, h, vid, src, dst, node_cap, gout)
    _close(got, _jax(J.sddmm_att_reference, aprime, evocab, wa, ba, h, vid,
                     src, dst, gout))
    if sink:
        # the padded edges are real work here: the dummy row's message
        # and its gradient are not zero, and the tables' gradients move
        assert np.abs(got[0][node_cap - 1]).max() > 1e-3
        assert np.abs(got[5][node_cap - 1]).max() > 1e-3
        pad = _port(aprime, evocab, wa, ba, h, vid[-1:], src[-1:],
                    dst[-1:], node_cap, gout)
        assert np.abs(pad[1][0]).max() > 1e-3


def test_widths_past_the_buckets_raise():
    """The wrapper's limits, checked before any launch: nf or mf past 32,
    ef past 32, K past 64 raise naming the widths; on a CPU/CUDA mix or a
    CPU tensor the kernel path raises too (the plain version runs only
    when h lies on the CPU)."""
    assert D.BUCKETS[-1][1]["f"] == 32
    D.check_widths(64, 32, 32, 32)
    for args, what in [((9, 33, 7, 6), "f=33"), ((9, 7, 33, 6), "f=33"),
                       ((9, 7, 7, 33), "ef=33"), ((65, 7, 7, 6), "K=65"),
                       ((0, 7, 7, 6), "K=0")]:
        with pytest.raises(NotImplementedError, match=what):
            D.check_widths(*args)
    (aprime, evocab, wa, ba, h, vid, src, dst, _, node_cap,
     _) = _problem(9, 7, 7, 6, 3, 4, False)
    plan = FusedEvalPlan(*(torch.from_numpy(p) for p in plan_fused_eval(
        dst, np.zeros(node_cap, np.int32), 1)))
    t = [torch.from_numpy(x) for x in (aprime, evocab, wa, ba, h, vid, src,
                                       dst)]
    with pytest.raises(ValueError, match="unsupported device cpu"):
        D.check_inputs(*t, plan)


# kernels/sddmm.py::launch_shape on an H100: (direction, edges, mf, nf, K,
# the rule's tag); adv's b1 (62 edges), b16 (512), b128 (3,350), b256
# (6,700) and b1024 (26,752), the tiles growing past one position a group
# (the forward past 396 tiles, the backward past 66), the wide bucket at
# K 64, mf 13 / nf 10, 66,560 edges (32,896 node slots)
H100 = dict(smem_bytes=232448, sms=132)
RULE_CASES = [
    ("fwd", 62, 7, 7, 8, "g8 p1 x2"),
    ("bwd", 62, 7, 7, 8, "g8 p1/1 x6"),
    ("fwd", 512, 7, 7, 8, "g8 p1 x16"),
    ("bwd", 512, 7, 7, 8, "g8 p1/1 x48"),
    ("fwd", 32 * 396, 7, 7, 8, "g8 p1 x396"),
    ("fwd", 32 * 396 + 1, 7, 7, 8, "g8 p2 x199"),
    ("bwd", 16 * 66, 7, 7, 8, "g8 p1/1 x99"),
    ("bwd", 16 * 66 + 1, 7, 7, 8, "g8 p2/1 x68"),
    ("bwd", 3350, 7, 7, 8, "g8 p4/2 x106"),
    ("bwd", 6700, 7, 7, 8, "g8 p4/4 x158"),
    ("fwd", 26752, 7, 7, 8, "g8 p3 x279"),
    ("bwd", 26752, 7, 7, 8, "g8 p4/4 x627"),
    ("fwd", 66560, 7, 7, 8, "g8 p4 x520"),
    ("bwd", 66560, 7, 7, 8, "g8 p4/4 x1560"),
    ("fwd", 26752, 27, 27, 64, "g32 p8 x418"),
    ("bwd", 26752, 32, 32, 64, "g32 p8/8 x1254"),
    ("fwd", 26752, 13, 10, 9, "g16 p5 x335"),
    ("bwd", 26752, 13, 10, 9, "g16 p8/8 x627"),
    ("bwd", 40, 16, 9, 64, "g16 p1/1 x8"),
]


@pytest.mark.parametrize("direction,edges,mf,nf,k,tag", RULE_CASES)
def test_launch_rule_at_its_boundaries(direction, edges, mf, nf, k, tag):
    """A block a tile at every size, the lane group (8, 16 or 32: the
    narrowest holding mf and nf), the fewest positions a group takes that
    keep the tiles within GRID_WAVE[direction] blocks an SM, at most
    TILE_POSITIONS a tile and MAX_PER a group, every position in one tile
    (the forward's E edges; the backward's 2E edge ends and E edges), and
    a block's shared memory within the card's."""
    s = D.launch_shape(direction, edges, mf, nf, k, **H100)
    assert s.tag() == tag
    ng = D.THREADS // s.group
    assert s.group == D.group_of(mf, nf) >= max(mf, nf)
    pos = edges if direction == "fwd" else 2 * edges
    cap = int(D.GRID_WAVE[direction] * H100["sms"])
    for per, tiles, n in ((s.per, s.tiles, pos), (s.vper, s.vtiles, edges)):
        if direction == "fwd" and n == edges and per == 0:
            assert tiles == 0
            continue
        most = min(D.MAX_PER, D.TILE_POSITIONS // ng)
        assert 1 <= per <= most
        assert tiles == -(-n // (ng * per))
        # the fewest positions a group that keep the tiles within the cap
        assert per == most or -(-n // (ng * per)) <= cap
        assert per == 1 or -(-n // (ng * (per - 1))) > cap
    assert s.grid == s.tiles + s.vtiles
    fp = 16 if s.group <= 16 else 32
    assert s.smem_bytes == 4 * D.smem_floats(direction, k, fp, ng * s.per,
                                             ng * s.vper)
    assert s.smem_bytes <= H100["smem_bytes"]


def test_launch_rule_on_a_smaller_card_and_forced_routes():
    """With less shared memory a tile gives way (fewer positions a group)
    until a block fits, and a card where not even one position a group
    fits raises rather than launching something else; forced tiles (a
    measurement's and a check's) take the given positions a group, within
    1 to MAX_PER."""
    big = D.launch_shape("bwd", 26752, 7, 7, 64, **H100)
    small = D.launch_shape("bwd", 26752, 7, 7, 64, smem_bytes=100 * 1024,
                           sms=132)
    assert small.per < big.per and small.smem_bytes <= 100 * 1024
    with pytest.raises(NotImplementedError, match="shared memory"):
        D.launch_shape("bwd", 26752, 16, 16, 64, smem_bytes=60 * 1024,
                       sms=132)
    # the smallest tiles: a group one position, a tile 32 edges
    tiny = D.launch_shape("fwd", 26752, 7, 7, 8, **H100, per=(1, 1))
    assert tiny.tag() == "g8 p1 x836"
    assert D.launch_shape("bwd", 26752, 7, 7, 8, **H100,
                          per=(4, 2)).tag() == "g8 p4/2 x836"
    assert D.launch_shape("bwd", 512, 7, 7, 8, **H100,
                          per=(0, 9)).tag() == f"g8 p1/{D.MAX_PER} x34"
    # forced tiles give way to shared memory as the rule's do
    assert D.launch_shape("bwd", 26752, 7, 7, 64, smem_bytes=100 * 1024,
                          sms=132, per=(8, 8)).smem_bytes <= 100 * 1024


def test_node_order_is_each_nodes_destination_then_source_ends():
    """The backward's node order: for each node its destination ends
    (edge ids x < E) in edge order, then its source ends (E + edge id) in
    edge order, with row pointers — the order a node's dh sums its
    terms in."""
    rs = np.random.RandomState(5)
    n, e = 13, 40
    src = rs.randint(0, n, e).astype(np.int32)
    dst = rs.randint(0, n, e).astype(np.int32)
    order, ptr = D.node_order(torch.from_numpy(src), torch.from_numpy(dst),
                              n)
    want = [x for v in range(n)
            for x in [i for i in range(e) if dst[i] == v]
            + [e + i for i in range(e) if src[i] == v]]
    assert order.tolist() == want
    counts = np.bincount(np.concatenate([dst, src]), minlength=n)
    assert ptr.tolist() == [0, *np.cumsum(counts).tolist()]
