"""The fused recurrence op of the decomposed training path on the CPU
against the JAX package: the port's op (kernels/recurrence.py; its plain
version on CPU tensors) — h_T, the message norm's and every step's
statistics, and the gradient of every leaf through autograd — against
mpnn_tpu/kernels/recurrence.py::reference_recurrence under jax.vjp, and
once against its Pallas op (make_recurrence_op, interpret mode), on the
same numpy inputs.

Inputs as tests/test_kernels.py::TestRecurrence._inputs makes them: N 256
node rows, a quarter of them masked, non-trivial norm affines (so their
gradients are exercised). Tolerance: values rtol 2e-4 / atol 1e-5, each
gradient leaf divided by its max abs first (float32 on both sides, batch
sums in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpnn_tpu.kernels import recurrence as J
from mpnn_tpu_torch.kernels import recurrence as R

RTOL, ATOL = 2e-4, 1e-5
N = 256
LEAVES = ("msgs", "h0", "w_ih", "w_hh", "b_ih", "b_hh", "ma_w", "ma_b",
          "bn_w", "bn_b")


def _inputs(f, seed):
    rs = np.random.RandomState(seed)
    x = {"msgs": 0.5 + rs.randn(N, f), "h0": rs.randn(N, f),
         "w_ih": 0.4 * rs.randn(f, 3 * f), "w_hh": 0.4 * rs.randn(f, 3 * f),
         "b_ih": 0.1 * rs.randn(3 * f), "b_hh": 0.1 * rs.randn(3 * f),
         "ma_w": rs.rand(f) + 0.5, "ma_b": rs.randn(f),
         "bn_w": rs.rand(f) + 0.5, "bn_b": rs.randn(f)}
    x = {k: v.astype(np.float32) for k, v in x.items()}
    mask = (rs.rand(N, 1) > 0.25).astype(np.float32)
    g = rs.randn(N, f).astype(np.float32)
    return x, mask, g


def _split(x):
    gru = {k: x[k] for k in ("w_ih", "w_hh", "b_ih", "b_hh")}
    return (gru, {"weight": x["ma_w"], "bias": x["ma_b"]},
            {"weight": x["bn_w"], "bias": x["bn_b"]})


def _port(x, mask, g, steps):
    """(h_T, ma stats, step stats) and {leaf: gradient} of the port's op
    for the cotangent g of h_T."""
    t = {k: torch.tensor(v, requires_grad=True) for k, v in x.items()}
    ht, ma, st = R.make_recurrence_op(steps, x["h0"].shape[1])(
        t["msgs"], t["h0"], torch.from_numpy(mask), *_split(t))
    (ht * torch.from_numpy(g)).sum().backward()
    assert not ma[0].requires_grad and not st[0][1].requires_grad
    vals = (ht.detach().numpy(), np.stack([s.numpy() for s in ma]),
            np.stack([[s.numpy() for s in p] for p in st]))
    return vals, {k: t[k].grad.numpy() for k in LEAVES}


def _jax(fn, x, mask, g, steps):
    """The same through jax.vjp of fn(msgs, h0, mask, gru, ma, bn); the
    statistics' cotangents zero, as the loss never reaches them."""
    def run(msgs, h0, gru, ma, bn):
        return fn(msgs, h0, jnp.asarray(mask), gru, ma, bn)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    (ht, ma, st), vjp = jax.vjp(run, j["msgs"], j["h0"], *_split(j))
    zeros = jax.tree.map(jnp.zeros_like, (ma, st))
    dm, dh, dg, dma, dbn = vjp((jnp.asarray(g), *zeros))
    vals = (np.asarray(ht), np.stack([np.asarray(s) for s in ma]),
            np.stack([[np.asarray(s) for s in p] for p in st]))
    grads = {"msgs": dm, "h0": dh, **dg, "ma_w": dma["weight"],
             "ma_b": dma["bias"], "bn_w": dbn["weight"], "bn_b": dbn["bias"]}
    return vals, {k: np.asarray(v) for k, v in grads.items()}


def _assert_close(got, want):
    for x, y, name in zip(got[0], want[0], ("h_T", "ma stats",
                                            "step stats")):
        np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL, err_msg=name)
    for k in LEAVES:
        scale = max(float(np.abs(want[1][k]).max()), 1e-30)
        np.testing.assert_allclose(got[1][k] / scale, want[1][k] / scale,
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("f,steps,seed", [(10, 4, 0), (10, 6, 1),
                                          (24, 5, 2), (24, 4, 3)])
def test_plain_chain_matches_reference_recurrence(f, steps, seed):
    """The port's op on CPU tensors against reference_recurrence and its
    jax.vjp: h_T, both statistics and every gradient leaf."""
    x, mask, g = _inputs(f, seed)

    def ref(*a):
        return J.reference_recurrence(*a, steps=steps)
    _assert_close(_port(x, mask, g, steps), _jax(ref, x, mask, g, steps))


def test_plain_chain_matches_pallas_interpret():
    """The same against the JAX package's fused Pallas op
    (make_recurrence_op, interpret mode, its fused backward)."""
    f, steps = 10, 4
    x, mask, g = _inputs(f, 7)
    op = J.make_recurrence_op(steps, f, N, interpret=True, bwd_mode="fused")
    _assert_close(_port(x, mask, g, steps), _jax(op, x, mask, g, steps))


def test_hook_checks_the_width_at_once():
    """make_recurrence_op names the widths past the kernels' widest bucket
    when it is made, before any batch."""
    with pytest.raises(NotImplementedError, match="f=33"):
        R.make_recurrence_op(6, 33)
    R.make_recurrence_op(6, 32)


# ---------------------------------------------------------------------------
# the backward kernel's route rule (kernels/recurrence.py::launch_shape),
# decided on the host from shapes alone
# ---------------------------------------------------------------------------

H100_SMEM, H100_GRID = 232448, 132          # opt-in bytes a block; 1 a SM


def _rule(n, tag="", steps=6, smem=H100_SMEM, max_grid=H100_GRID):
    return R.launch_shape(n, tag, steps, smem_bytes=smem, max_grid=max_grid)


def test_bwd_rule_at_its_node_count_boundaries():
    """Up to CLUSTER_SLOTS node slots one cluster of the fewest blocks (1,
    2, 4) whose share is at most CLUSTER_NODES, else 8; then the grid at
    GRID_NODES slots a block, capped at the co-resident blocks and at
    MAX_GRID (lipo's f 10, T 6)."""
    cn, cs, gn = R.CLUSTER_NODES, R.CLUSTER_SLOTS, R.GRID_NODES
    assert 8 * cn <= cs
    for c in (1, 2, 4):
        assert _rule(c * cn)[:2] == ("cluster", c)
        assert _rule(c * cn + 1)[:2] == ("cluster", 2 * c)
    assert _rule(8 * cn)[:2] == ("cluster", 8)
    assert _rule(cs)[:2] == ("cluster", 8)
    assert _rule(cs + 1)[:2] == ("grid", -(-(cs + 1) // gn))
    assert _rule(1)[:2] == ("cluster", 1)
    assert _rule(16512)[:2] == ("grid", H100_GRID)          # b1024
    assert _rule(10 ** 6)[:2] == ("grid", H100_GRID)
    assert _rule(10 ** 6, max_grid=1000)[:2] == ("grid", R.MAX_GRID)


@pytest.mark.parametrize("tag,least", [("", 300), ("f32", 128)])
def test_bwd_rule_keeps_a_block_within_its_tile(tag, least):
    """A block's tile holds 8·FP floats a node and two staged slots: at
    least `least` node slots on an H100 at T 6; its share of the slots
    stays within the tile while the card holds the blocks (past 132 ×
    cap slots — lipo's split at 57,856 — blocks keep their nodes in
    global scratch); the bytes are the tile's, and one more node does not
    fit."""
    cap = R.bwd_capacity(tag, 6, H100_SMEM)
    assert cap >= least
    for n in (16, 256, 384, 600, 4096, 16512, 32896, 57856):
        s = _rule(n, tag)
        assert s.ncap == cap
        assert s.smem_bytes == 4 * R.bwd_smem_floats(tag, 6, cap) \
            <= H100_SMEM
        if n <= H100_GRID * cap:
            assert -(-n // s.grid) <= cap, (n, s.tag())
        else:
            assert s.grid == H100_GRID, (n, s.tag())
    assert 4 * R.bwd_smem_floats(tag, 6, cap + 1) > H100_SMEM


@pytest.mark.parametrize("max_grid", [132, 114, 78])
def test_bwd_rule_on_steps_and_a_smaller_card(max_grid):
    """The tile shrinks with T (each slot's norm constants and partials)
    and with a card's shared memory; a card with fewer SMs (114 on an
    H100 PCIe, or 78) caps the grid; a card that cannot hold one node
    raises."""
    caps = [R.bwd_capacity("", t, H100_SMEM) for t in (1, 6, 32)]
    assert caps[0] >= caps[1] > caps[2] > 0
    assert R.bwd_capacity("", 6, 100 * 1024) < caps[1]
    for n in (600, 16512, 57856):
        s = _rule(n, max_grid=max_grid)
        assert s.route == "grid"
        assert s.grid == min(max_grid, -(-n // R.GRID_NODES))
    small = _rule(512, smem=100 * 1024, max_grid=max_grid)
    assert -(-512 // small.grid) <= small.ncap
    with pytest.raises(NotImplementedError, match="shared memory"):
        _rule(16, smem=8 * 1024)


# ---------------------------------------------------------------------------
# the forward kernel's route rule (kernels/recurrence.py::fwd_launch_shape:
# the shared family's forward policy on this kernel's tile)
# ---------------------------------------------------------------------------

def _fwd_rule(n, tag="", steps=6, smem=H100_SMEM, max_grid=H100_GRID):
    return R.fwd_launch_shape(n, tag, steps, smem_bytes=smem,
                              max_grid=max_grid)


K = R.K
CN, CS = K.FWD_CLUSTER_NODES, K.FWD_CLUSTER_SLOTS
# (node slots, bucket, co-resident blocks, route, blocks)
FWD_RULE_CASES = [
    (1, "", 132, "cluster", 1),
    (CN, "", 132, "cluster", 1),                  # one block's capacity
    (CN + 1, "", 132, "cluster", 2),              # one past it
    (2 * CN + 1, "", 132, "cluster", 4),
    (4 * CN + 1, "", 132, "cluster", 8),
    (CS, "", 132, "cluster", 8),                  # the cluster's capacity
    (CS + 1, "", 132, "grid", -(-(CS + 1) // K.FWD_STAT_NODES)),  # past it
    (CS, "f32", 132, "cluster", 8),
    (CS + 1, "f32", 132, "grid", 22),
    (16512, "", 132, "grid", 129),                # b1024: ceil(sqrt(n))
    (16512, "f32", 132, "grid", 129),
    (57856, "", 132, "grid", 132),                # the split's slots
    (57856, "", 114, "grid", 114),                # a card with fewer SMs
    (10 ** 6, "", 1000, "grid", K.FWD_MAX_GRID),  # the flag rows' limit
]


@pytest.mark.parametrize("n,tag,most,route,grid", FWD_RULE_CASES)
def test_fwd_rule_at_its_capacities(n, tag, most, route, grid):
    """Up to FWD_CLUSTER_SLOTS slots one cluster of the fewest blocks (1,
    2, 4) whose share is at most FWD_CLUSTER_NODES, else 8; past them the
    grid at FWD_STAT_NODES slots a block, at most max(FWD_STAT_BLOCKS,
    ceil(sqrt(n))) blocks, the co-resident ones and FWD_MAX_GRID; the
    tile fills a block's shared memory beside the launch's partial rows
    (one more node does not fit)."""
    s = _fwd_rule(n, tag, max_grid=most)
    assert (s.route, s.grid) == (route, grid)
    cap = R.fwd_capacity(tag, 6, H100_SMEM, s.grid)
    assert s.ncap == cap >= 1
    assert s.smem_bytes == 4 * R.fwd_smem_floats(tag, 6, cap, s.grid) \
        <= H100_SMEM
    assert 4 * R.fwd_smem_floats(tag, 6, cap + 1, s.grid) > H100_SMEM


def test_fwd_rule_tiles_and_a_smaller_card():
    """lipo's b1024 (16,512 slots) fits the tiles at f 10 and f 30; the
    split's 57,856 slots fit 132 tiles at f 10 and spill at f 30 (its
    blocks keep their slots in global scratch, on the same route); the
    tile shrinks with T and with a card's shared memory; a card that
    cannot hold one node raises."""
    for tag in ("", "f32"):
        s = _fwd_rule(16512, tag)
        assert -(-16512 // s.grid) <= s.ncap
    assert -(-57856 // 132) <= _fwd_rule(57856).ncap
    assert -(-57856 // 132) > _fwd_rule(57856, "f32").ncap
    caps = [R.fwd_capacity("", t, H100_SMEM, 132) for t in (1, 6, 32)]
    assert caps[0] > caps[1] > caps[2] > 0
    small = _fwd_rule(16512, smem=100 * 1024)
    assert small.grid == 129 and small.ncap < _fwd_rule(16512).ncap
    assert small.smem_bytes <= 100 * 1024
    with pytest.raises(NotImplementedError, match="shared memory"):
        _fwd_rule(16, smem=4 * 1024)


@pytest.mark.parametrize("route,want", [
    (None, "grid x129 cap 776"), ("cluster 2", "cluster x2 cap 776"),
    ("cluster 8", "cluster x8 cap 776"), ("grid", "grid x128 cap 776"),
    ("spilled", "grid x128 cap 16")])
def test_fwd_forced_routes(monkeypatch, route, want):
    """chip_smoke.py::_rec_fwd_route forces each route on the rule's card
    (an H100's shared memory, 132 co-resident blocks) at lipo b1024's
    16,512 slots, within the rule's tile (a forced cluster's blocks keep
    their slots past it in global scratch), and restores the rule
    after."""
    import types
    from chip_smoke import _rec_fwd_route
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda d: types.SimpleNamespace(
            shared_memory_per_block_optin=H100_SMEM,
            multi_processor_count=132))
    rule = lambda n, tag, steps, device: _fwd_rule(n, tag, steps)
    monkeypatch.setattr(R, "device_fwd_shape", rule)
    with _rec_fwd_route(route):
        assert R.device_fwd_shape(16512, "", 6, "cuda").tag() == want
    assert R.device_fwd_shape is rule
