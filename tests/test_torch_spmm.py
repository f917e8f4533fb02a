"""The SpMM op of the decomposed training path on the CPU against the JAX
package: the port's op (kernels/spmm.py; its plain version on CPU
tensors) — the forward, and dA and dh through autograd — against
mpnn_tpu/kernels/spmm.py's Pallas op in interpret mode and its
spmm_reference under jax.vjp, on the same numpy inputs.

Inputs as tests/test_kernels.py::TestSpmm._batch makes them: contiguous
graphs of 3 to 23 nodes with local edges, vocab ids 1..K−1, A_0 = 0, and a
padded tail of edges on the dummy node. Tolerance rtol 1e-5 / atol 1e-5:
float32 on both sides, the per-destination sums taken in other orders;
dA and dh — sums of hundreds of products, up to ~50 in size — are divided
by their max abs first, as every gradient comparison of the port is.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpnn_tpu.kernels import spmm as J
from mpnn_tpu_torch.graphs.batching import FusedEvalPlan, plan_fused_eval
from mpnn_tpu_torch.kernels import spmm as S

RTOL, ATOL = 1e-5, 1e-5


def _batch(k, f, n_graphs, seed):
    """TestSpmm._batch's layout at K vocab ids and width f."""
    rs = np.random.RandomState(seed)
    srcs, dsts, vids = [], [], []
    off = 0
    for _ in range(n_graphs):
        a = rs.randint(3, 24)
        ne = 2 * rs.randint(a - 1, 2 * a)
        srcs.append(rs.randint(0, a, ne) + off)
        dsts.append(rs.randint(0, a, ne) + off)
        vids.append(rs.randint(1, k, ne))
        off += a
    src = np.concatenate(srcs).astype(np.int32)
    dst = np.concatenate(dsts).astype(np.int32)
    vid = np.concatenate(vids).astype(np.int32)
    e = src.shape[0]
    node_cap = int(-(-(off + 1) // 128) * 128)
    edge_cap = int(-(-e // 128) * 128)
    mask = np.zeros(edge_cap, np.float32)
    mask[:e] = 1
    pad = np.full(edge_cap - e, node_cap - 1, np.int32)
    src = np.concatenate([src, pad])
    dst = np.concatenate([dst, pad])
    vid = np.concatenate([vid, np.zeros(edge_cap - e, np.int32)])
    h = rs.randn(node_cap, f).astype(np.float32)
    h[off:] = 0
    a_mats = rs.randn(k, f, f).astype(np.float32)
    a_mats[0] = 0
    g = rs.randn(node_cap, f).astype(np.float32)
    return a_mats, h, vid, src, dst, mask, node_cap, g


def _close(got, want, names=("out", "dA", "dh")):
    """out as it is, dA and dh each divided by its max abs."""
    for i, (x, y, name) in enumerate(zip(got, want, names)):
        y = np.asarray(y)
        scale = 1.0 if i == 0 else max(float(np.abs(y).max()), 1e-30)
        np.testing.assert_allclose(x / scale, y / scale, rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def _port(a, h, vid, src, dst, g, node_cap):
    """The port's hook on CPU tensors: out, and (dA, dh) for the
    cotangent g."""
    node_graph = np.zeros(node_cap, np.int32)
    plan = FusedEvalPlan(*(torch.from_numpy(p) for p in plan_fused_eval(
        dst, node_graph, 1)))
    ta = torch.tensor(a, requires_grad=True)
    th = torch.tensor(h, requires_grad=True)
    out = S.make_spmm_op()(ta, th, *(torch.from_numpy(x)
                                     for x in (vid, src, dst)), plan)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), ta.grad.numpy(), th.grad.numpy()


CASES = [(7, 10, 40, 0), (7, 10, 12, 3), (17, 24, 20, 5)]


@pytest.mark.parametrize("k,f,n_graphs,seed", CASES)
def test_port_matches_pallas_interpret(k, f, n_graphs, seed):
    """Forward, dA and dh of the port's op against the Pallas op
    (make_spmm_op(interpret=True), its window plan from
    plan_edge_windows) through jax.vjp."""
    a, h, vid, src, dst, mask, node_cap, g = _batch(k, f, n_graphs, seed)
    plan = J.plan_edge_windows(src, dst, mask, node_cap, block_edges=128)
    assert plan is not None
    op = J.make_spmm_op(block_edges=plan.block_edges, window=plan.window,
                        interpret=True)
    idx = [jnp.asarray(x) for x in (vid, src, dst)]
    out, vjp = jax.vjp(lambda a_, h_: op(a_, h_, *idx,
                                         jnp.asarray(plan.win_start)),
                       jnp.asarray(a), jnp.asarray(h))
    da, dh = vjp(jnp.asarray(g))
    _close(_port(a, h, vid, src, dst, g, node_cap), (out, da, dh))


@pytest.mark.parametrize("k,f,n_graphs,seed", CASES)
def test_port_matches_xla_reference(k, f, n_graphs, seed):
    """The same against the JAX package's spmm_reference (einsum +
    segment_sum) under jax.vjp; the plain dA (spmm_da_reference) against
    its dA directly."""
    a, h, vid, src, dst, _, node_cap, g = _batch(k, f, n_graphs, seed)
    idx = [jnp.asarray(x) for x in (vid, src, dst)]
    out, vjp = jax.vjp(lambda a_, h_: J.spmm_reference(a_, h_, *idx),
                       jnp.asarray(a), jnp.asarray(h))
    da, dh = vjp(jnp.asarray(g))
    _close(_port(a, h, vid, src, dst, g, node_cap), (out, da, dh))
    plain = S.spmm_da_reference(*(torch.from_numpy(x) for x in (h, g, vid,
                                                                src, dst)),
                                k)
    _close([plain.numpy()], [da], ["dA"])


def test_padded_edges_add_nothing():
    """The padded edges (vid 0, A_0 = 0, on the zero dummy row) contribute
    exactly 0 to out, dA and dh, and the real edges alone give the full
    batch's results."""
    a, h, vid, src, dst, mask, node_cap, g = _batch(7, 10, 12, 3)
    pad = mask == 0
    assert pad.sum() > 0
    for x in _port(a, h, vid[pad], src[pad], dst[pad], g, node_cap):
        assert not x.any()
    real = ~pad
    _close(_port(a, h, vid[real], src[real], dst[real], g, node_cap),
           _port(a, h, vid, src, dst, g, node_cap))


def test_layout_check_names_the_fault():
    """check_layout (run before the kernels' first launch on a batch)
    raises on what would fault on the card, naming it."""
    _, h, vid, src, dst, _, node_cap, _ = _batch(7, 10, 5, 1)
    plan = FusedEvalPlan(*(torch.from_numpy(p) for p in plan_fused_eval(
        dst, np.zeros(node_cap, np.int32), 1)))
    t = torch.from_numpy
    S.check_layout(t(h), t(vid), t(src), t(dst), plan, 7)
    with pytest.raises(ValueError, match="vid out of range"):
        S.check_layout(t(h), t(vid), t(src), t(dst), plan, 6)
    bad = src.copy()
    bad[0] = node_cap
    with pytest.raises(ValueError, match="src/dst out of range"):
        S.check_layout(t(h), t(vid), t(bad), t(dst), plan, 7)
    shuffled = plan._replace(edge_order=plan.edge_order.flip(0))
    with pytest.raises(ValueError, match="not destination-sorted"):
        S.check_layout(t(h), t(vid), t(src), t(dst), shuffled, 7)


# ---------------------------------------------------------------------------
# the forward kernel's tile rule (kernels/spmm.py::launch_shape)
# ---------------------------------------------------------------------------

H100 = dict(smem_bytes=232448, sms=132)

# (positions, mo, ni, K, the launch's tag): a row crossing one tile (b16),
# the cap of GRID_WAVE blocks an SM and one past it, lipo's b1024 and
# 32,896 slots, the 8-lane groups (f <= 8), the wide bucket and K 1 to 64
RULE_CASES = [
    (62, 10, 10, 8, "g16 p1 x4"),
    (16 * 396, 10, 10, 8, "g16 p1 x396"),
    (16 * 396 + 1, 10, 10, 8, "g16 p2 x199"),
    (33024, 10, 10, 8, "g16 p6 x344"),
    (66560, 10, 10, 8, "g16 p8 x520"),
    (26752, 8, 8, 1, "g8 p3 x279"),
    (26752, 16, 16, 64, "g16 p5 x335"),
    (26752, 30, 30, 64, "g32 p8 x418"),
    (40, 24, 17, 17, "g32 p1 x5"),
    (1, 1, 1, 1, "g8 p1 x1"),
]


@pytest.mark.parametrize("pos,mo,ni,k,tag", RULE_CASES)
def test_launch_rule_at_its_boundaries(pos, mo, ni, k, tag):
    """A block a tile at every size, the lane group (8, 16 or 32: the
    narrowest holding mo and ni), the fewest positions a group takes that
    keep the tiles within GRID_WAVE blocks an SM, at most TILE_POSITIONS a
    tile and MAX_PER a group, every position in one tile, and a block's
    shared memory (the narrow bucket's tables too) within the card's."""
    s = S.launch_shape(pos, mo, ni, k, **H100)
    assert s.tag() == tag
    ng = S.THREADS // s.group
    assert s.group == S.group_of(mo, ni) >= max(mo, ni)
    cap = S.GRID_WAVE * H100["sms"]
    most = min(S.MAX_PER, S.TILE_POSITIONS // ng)
    assert 1 <= s.per <= most
    assert s.tiles == -(-pos // (ng * s.per))
    assert s.per == most or s.tiles <= cap
    assert s.per == 1 or -(-pos // (ng * (s.per - 1))) > cap
    fp = 16 if s.group <= 16 else 32
    assert s.smem_bytes == 4 * S.smem_floats(k, fp, ng * s.per)
    assert s.smem_bytes <= H100["smem_bytes"]


def test_launch_rule_on_a_smaller_card_and_forced_tiles():
    """With less shared memory (K 64's tables take 64 KB in the narrow
    bucket) a tile gives way, fewer positions a group, until a block fits;
    a card where not one position a group fits raises rather than
    launching something else; forced tiles (a measurement's and a
    check's) take the given positions a group, within 1 to MAX_PER; a
    smaller card's fewer SMs give larger tiles."""
    big = S.launch_shape(66560, 16, 16, 64, **H100)
    small = S.launch_shape(66560, 16, 16, 64, smem_bytes=70 * 1024, sms=132)
    assert small.per < big.per and small.smem_bytes <= 70 * 1024
    assert small.tag() == "g16 p2 x2080"
    with pytest.raises(NotImplementedError, match="shared memory"):
        S.launch_shape(66560, 16, 16, 64, smem_bytes=60 * 1024, sms=132)
    # the wide bucket stages at most STAGE_IDS tables (64 KB): its tiles
    # give way at K 64 as at K 16, and not at K 4
    wide = [S.launch_shape(66560, 32, 32, k, smem_bytes=70 * 1024,
                           sms=132).per for k in (4, 16, 64)]
    assert wide[0] == 8 and wide[1] == wide[2] < 8
    for per, want in ((1, "g16 p1 x4160"), (5, "g16 p5 x832"),
                      (99, "g16 p8 x520"), (0, "g16 p1 x4160")):
        assert S.launch_shape(66560, 10, 10, 8, **H100,
                              per=per).tag() == want
    assert S.launch_shape(3745, 10, 10, 8, **H100).tag() == "g16 p1 x235"
    assert (S.launch_shape(3745, 10, 10, 8, smem_bytes=232448,
                           sms=78).tag() == "g16 p2 x118")
