"""The set2vec op's host side on the CPU: the route rule that shapes the
kernels' launches (kernels/set2vec.py::launch_shape — one block, a block
per SM, the staging capacity past which a block's rows stream, where the
backward's leaf accumulator and the graphs' slots live) at its boundaries, against an H100's
232,448 bytes of shared memory a block and 132 SMs; and set2vec_reference
against the JAX package's Pallas op make_set2vec_op in interpret mode on a
ragged batch — single-node graphs, empty graphs, padded node slots — at
the wide widths w 54 and 64, in both softmax modes.

Tolerances: forward rtol 2e-4 / atol 1e-5 (float32, sums in other
orders), every gradient leaf divided by its max abs likewise, as
tests/test_torch_att_kernels.py holds the narrow widths. The kernels
themselves run on the card (tests/test_torch_gpu.py, chip_smoke.py) and
through the CPU stand-in (scripts/cuda_emu/check_set2vec.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpnn_tpu.kernels.fused_step import plan_fused_step
from mpnn_tpu.kernels.set2vec import make_set2vec_op
from mpnn_tpu.ops.readout import set2vec_init
from mpnn_tpu_torch.kernels import set2vec as S
from test_torch_att_kernels import assert_leaves_close, jax_s2v, torch_s2v

RTOL, ATOL = 2e-4, 1e-5
H100 = dict(smem_bytes=232448, sms=132)


def shape(direction, n, g, w, **kw):
    return S.launch_shape(direction, n, g, w, **{**H100, **kw})


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_batch16_is_one_block_at_bench_widths(direction):
    """adv's b16 (w 14, 16 graphs in 258 node slots): one block, a warp
    per graph, every slot staged — no grid barrier."""
    s = shape(direction, 258, 16, 14)
    assert (s.route, s.grid, s.warps, s.gpb, s.cap) == ("one-block", 1, 16,
                                                        16, 258)
    assert s.smem == 4 * S.smem_floats(direction, 14, 16, 16, 258)
    assert s.smem <= H100["smem_bytes"] and s.acc_smem


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_batch1024_takes_a_block_per_sm(direction):
    """b1024 (16,512 slots): 132 blocks of 8 graphs, a warp each; the
    capacity fills the budget (one more row would not fit) and holds a
    block's share of the real nodes many times over."""
    s = shape(direction, 16512, 1024, 14)
    assert (s.route, s.grid, s.warps, s.gpb) == ("grid", 132, 8, 8)
    assert s.smem <= H100["smem_bytes"] < 4 * S.smem_floats(
        direction, 14, 8, 8, s.cap + 1)
    assert 13109 / 132 * 4 < s.cap < 16512


@pytest.mark.parametrize("g,route,warps", [(1, "one-block", 1),
                                           (32, "one-block", 16),
                                           (33, "grid", 1),
                                           (132, "grid", 1),
                                           (133, "grid", 2),
                                           (4224, "grid", 16),
                                           (4225, "grid", 16)])
def test_one_block_boundary_and_warps(g, route, warps):
    """At most 32 graphs run as one block (16 warps, two graphs a warp
    past 16); beyond, min(132, G) blocks of up to 16 warps."""
    s = shape("fwd", 24 * g, g, 14)
    assert (s.route, s.warps) == (route, warps)
    assert s.grid == (1 if route == "one-block" else min(132, g))
    assert s.gpb == -(-g // s.grid)


def test_one_block_needs_every_slot_staged():
    """16 graphs whose slots pass one block's capacity: a block per graph,
    and a block whose graph is larger than its capacity streams it (the
    chunked route) — decided from the shapes, before the launch."""
    one = shape("fwd", 3000, 16, 14)
    assert one.route == "one-block" and one.cap == 3000
    many = shape("fwd", 60000, 16, 14)
    assert (many.route, many.grid, many.gpb) == ("grid", 16, 1)
    assert many.cap < 60000
    assert shape("bwd", 60000, 16, 14).cap < many.cap


def test_backward_leaf_accumulator():
    """The narrow backward's per-block leaf accumulator stays in shared
    memory while the graphs' slots leave room for MIN_ROWS rows, else
    moves to the block's row of global scratch (w 32 past ~41 graphs a
    block); the wide one (37,184 floats at w 64 beside 151 KB of weights)
    is always there. The wide b16 backward takes a block per graph."""
    assert shape("bwd", 13109, 1024, 14).acc_smem
    assert shape("bwd", 13109, 1024, 32).acc_smem
    s = shape("bwd", 80000, 6000, 32)
    assert not s.acc_smem and s.cap >= S.MIN_ROWS
    assert s.smem == 4 * S.smem_floats("bwd", 32, s.gpb, s.warps, s.cap,
                                       acc_smem=False)
    wide = shape("bwd", 258, 16, 64)
    assert wide.route == "grid" and not wide.acc_smem
    assert shape("fwd", 258, 16, 54).route == "one-block"


@pytest.mark.parametrize("direction,w,g", [
    ("fwd", 54, 9240), ("fwd", 64, 9108), ("bwd", 14, 16896),
    ("bwd", 32, 6600), ("bwd", 54, 1188), ("bwd", 64, 1056)])
def test_slots_spill_past_the_block_capacity(direction, w, g):
    """With 13 node slots a graph (bench.py's batches), the graphs' slots
    stay in shared memory up to the last batch whose block share leaves
    MIN_ROWS rows beside them, and move to the block's region of global
    scratch one graph later (the spilled route), which stages rows again."""
    keep = shape(direction, 13 * g, g, w)
    spill = shape(direction, 13 * (g + 1), g + 1, w)
    assert keep.slots_smem and not spill.slots_smem
    assert spill.tag([0] * (g + 2)).endswith("spilled")
    assert spill.cap > keep.cap >= S.MIN_ROWS
    assert spill.smem == 4 * S.smem_floats(direction, w, spill.gpb,
                                           spill.warps, spill.cap,
                                           spill.acc_smem, slots_smem=False)


@pytest.mark.parametrize("w", [14, 32, 54, 64])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_every_batch_size_has_a_route(direction, w):
    """No batch is refused on an H100: from one graph to a million, a
    block stages at least MIN_ROWS rows (or every slot) in its budget."""
    for g in (1, 17, 33, 2048, 10000, 100000, 1000000):
        s = shape(direction, 13 * g, g, w)
        assert s.cap >= min(S.MIN_ROWS, 13 * g)
        assert s.smem <= H100["smem_bytes"]


def test_refuses_when_no_rows_fit():
    """A card whose shared memory a block cannot hold the wide weights
    (151 KB) has no route at w 64."""
    with pytest.raises(NotImplementedError, match="set2vec_bwd"):
        S.launch_shape("bwd", 100000, 1000, 64, smem_bytes=48 * 1024,
                       sms=132)
    with pytest.raises(NotImplementedError, match="set2vec_fwd"):
        S.launch_shape("fwd", 100000, 1000, 64, smem_bytes=48 * 1024,
                       sms=132)


def test_stash_rows_are_16_byte_rows():
    """The backward's bulk copies need 16-byte aligned rows."""
    for w in (2, 14, 54, 64):
        assert S.stash_width(w) % 4 == 0 and S.stash_width(w) >= 8 * w
    for n in (1, 257, 16512):
        assert S.att_stride(n) % 4 == 0 and n <= S.att_stride(n) < n + 4


def ragged_problem(seed, w):
    """Ragged graphs (single-node and empty ones among them), five padded
    node slots, a chain of edges in each graph for the JAX window plan,
    random masked x and set2vec_init's leaves."""
    rng = np.random.RandomState(seed)
    sizes = np.array([1, 1, 1, 5, 0, 0, 12, 3, 0, 7, 1, 9])
    g, n_real = len(sizes), int(sizes.sum())
    n = n_real + 5
    ng = np.full(n, g, np.int32)
    ng[:n_real] = np.repeat(np.arange(g), sizes)
    gnp = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    src = np.array([v for gi in range(g) for v in range(gnp[gi],
                                                        gnp[gi + 1] - 1)]
                   + [n - 1], np.int32)
    dst = np.array(list(src[:-1] + 1) + [n - 1], np.int32)
    emask = np.concatenate([np.ones(len(src) - 1), [0]]).astype(np.float32)
    plan = plan_fused_step(src, dst, emask, ng, n, g, block_edges=128)
    mask = (np.arange(n) < n_real).astype(np.float32)[:, None]
    x = (rng.randn(n, w) * mask).astype(np.float32)
    rp = jax.tree.map(np.asarray, set2vec_init(jax.random.PRNGKey(seed),
                                               w // 2))
    cw = rng.randn(g, 2 * w).astype(np.float32)
    return rp, x, mask, ng, gnp, plan, cw


@pytest.mark.parametrize("batch_softmax", [True, False])
@pytest.mark.parametrize("w", [54, 64])
def test_reference_matches_pallas_interpret_on_ragged_wide(w, batch_softmax):
    """m (G, 2w) and the gradient in every readout leaf and x, T 3."""
    rp, x, mask, ng, gnp, plan, cw = ragged_problem(w, w)
    n, g = x.shape[0], gnp.shape[0] - 1
    op = make_set2vec_op(w, n, g, time_steps=3,
                         node_window=plan.node_window, interpret=True,
                         batch_softmax=batch_softmax)
    ns = jnp.asarray(plan.node_start)
    want = jax_s2v(lambda r, xx: op(r, xx, jnp.asarray(mask),
                                    jnp.asarray(ng), ns), rp, x, cw)
    got = torch_s2v(rp, x, mask, ng, gnp, cw, time_steps=3,
                    batch_softmax=batch_softmax)
    assert np.abs(want[0]).max() > 1e-2
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    assert_leaves_close(got[1], want[1])
    empty = np.flatnonzero(np.diff(gnp) == 0)
    assert not got[0][empty, w:].any()          # an empty graph reads 0
    assert not got[1]["x"][mask[:, 0] == 0].any()
