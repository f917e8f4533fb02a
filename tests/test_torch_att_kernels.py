"""The port's attention-family ops (mpnn_tpu_torch.kernels.fused_att and
.set2vec) against the JAX package on the CPU: fused_att_reference against
the Pallas op make_fused_att_op in interpret mode (its kernels are
`_att_fwd_kernel` and `_att_bwd_kernel`), for the 'att' aggregation (the
rank-1 non-edge correction) and 'adj', forward and every gradient leaf;
set2vec_reference against make_set2vec_op in interpret mode at T 4 and
against the JAX package's plain sparse_set2vec at the reference's T 100,
for the batch-global and the per-graph softmax. On the CPU the port's ops
are their plain versions (under autograd).

Tolerances: forward values rtol 2e-4 / atol 1e-5 (the JAX package's own
for its kernels against its references: float32, sums in other orders);
every gradient leaf divided by its max abs, rtol 2e-4 / atol 1e-5 (at
T 100 the 100-step reverse chain, rtol 1e-3 / atol 1e-5). The batches
carry padded nodes, padded edges on the dummy node (vid 0, whose A' is
not zero) and single-node graphs.

The CUDA kernels are compared with these plain versions on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpnn_tpu.kernels.fused_att import make_fused_att_op
from mpnn_tpu.kernels.fused_step import plan_fused_step
from mpnn_tpu.kernels.set2vec import make_set2vec_op
from mpnn_tpu.models.sparse import sparse_set2vec
from mpnn_tpu.ops.readout import set2vec_init
from mpnn_tpu_torch.graphs.batching import FusedEvalPlan, plan_fused_eval
from mpnn_tpu_torch.kernels import fused_att as A
from mpnn_tpu_torch.kernels import set2vec as S
from test_fused_step import build_problem

RTOL, ATOL = 2e-4, 1e-5
ATT_LEAVES = ("aprime", "a0", "qv", "q0", "wh", "h0", "w_ih", "w_hh",
              "b_ih", "b_hh")


def att_problem(seed, n=160, g=14, f=7, k=6, pad_edges=9):
    """build_problem's packed batch (contiguous graphs, padded nodes, some
    single-node graphs) with padded edges appended on the dummy last node,
    the attention op's weights, and JAX's window plan for it."""
    rng = np.random.RandomState(seed)
    args, _, _ = build_problem(rng, n=n, g=g, f=f, od=4, k=k, steps=1)
    src = np.concatenate([args["src"], np.full(pad_edges, n - 1)]) \
        .astype(np.int32)
    dst = np.concatenate([args["dst"], np.full(pad_edges, n - 1)]) \
        .astype(np.int32)
    vid = np.concatenate([args["vid"], np.zeros(pad_edges)]).astype(np.int32)
    emask = np.concatenate([np.ones(args["src"].shape[0]),
                            np.zeros(pad_edges)]).astype(np.float32)
    plan = plan_fused_step(src, dst, emask, args["node_graph"], n, g,
                           block_edges=128)
    assert plan is not None
    r = lambda *s, sc=1.0: (rng.randn(*s) * sc).astype(np.float32)
    p = dict(aprime=r(k, f, f, sc=0.3), a0=r(f, f, sc=0.3), qv=r(k, f),
             q0=r(f), wh=r(f, f, sc=0.5), h0=args["h0"], mask=args["mask"],
             node_graph=args["node_graph"], gru=args["gru"], vid=vid,
             src=src, dst=dst)
    return p, plan, dict(n=n, g=g, f=f, k=k), r(n, f)


def jax_att(p, plan, dims, cw, with_corr):
    """(h, {leaf: grad of Σ h·cw}) of the Pallas op in interpret mode."""
    op = make_fused_att_op(dims["f"], dims["n"], dims["g"], dims["k"],
                           with_corr=with_corr,
                           block_edges=plan.block_edges, window=plan.window,
                           node_window=plan.node_window, interpret=True)
    a = jax.tree.map(jnp.asarray, p)
    win, ns = jnp.asarray(plan.win_start), jnp.asarray(plan.node_start)

    def obj(aprime, a0, qv, q0, wh, h0, gru):
        h = op(aprime, a0, qv, q0, wh, h0, a["mask"], a["node_graph"], gru,
               a["vid"], a["src"], a["dst"], win, ns)
        return jnp.sum(h * cw), h

    diff = (a["aprime"], a["a0"], a["qv"], a["q0"], a["wh"], a["h0"],
            a["gru"])
    (_, h), g = jax.value_and_grad(obj, argnums=tuple(range(7)),
                                   has_aux=True)(*diff)
    grads = dict(zip(ATT_LEAVES[:6], map(np.asarray, g[:6])))
    grads.update({k: np.asarray(v) for k, v in g[6].items()})
    return np.asarray(h), grads


def torch_att_args(p, dims, grad=True):
    """The port op's arguments (differentiable leaves requiring grad) and
    {leaf: tensor}."""
    t = lambda x: torch.tensor(np.ascontiguousarray(x))
    leaf = lambda x: t(x).requires_grad_(grad)
    w = {k: leaf(p[k]) for k in ATT_LEAVES[:6]}
    gru = {k: leaf(v) for k, v in p["gru"].items()}
    plan = FusedEvalPlan(*map(t, plan_fused_eval(p["dst"], p["node_graph"],
                                                 dims["g"])))
    args = (w["aprime"], w["a0"], w["qv"], w["q0"], w["wh"], w["h0"],
            t(p["mask"]), t(p["node_graph"]), gru, t(p["vid"]), t(p["src"]),
            t(p["dst"]), plan)
    return args, {**w, **gru}


def assert_leaves_close(got, want, rtol=RTOL, atol=ATOL):
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g / scale, w / scale, rtol=rtol,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("with_corr", [True, False])
def test_fused_att_matches_pallas_interpret(with_corr):
    """h and the gradient in every leaf (aprime, a0, qv, q0, wh, h0 and
    the four GRU leaves) of Σ h·c, for 'att' (with_corr) and 'adj'."""
    p, plan, dims, cw = att_problem(0)
    want_h, want_g = jax_att(p, plan, dims, cw, with_corr)
    args, leaves = torch_att_args(p, dims)
    A.reset_launch_counts()
    h = A.fused_att(*args, with_corr=with_corr)
    grads = torch.autograd.grad((h * torch.tensor(cw)).sum(),
                                list(leaves.values()), allow_unused=True)
    assert sum(A.launch_counts.values()) == 0       # plain version on CPU
    assert np.abs(want_h).max() > 1e-2
    np.testing.assert_allclose(h.detach().numpy(), want_h, rtol=RTOL,
                               atol=ATOL)
    got = {k: (np.zeros(v.shape, np.float32) if gr is None else gr.numpy())
           for (k, v), gr in zip(leaves.items(), grads)}
    assert_leaves_close(got, want_g)
    if not with_corr:
        assert not got["a0"].any() and not got["q0"].any()


def test_fused_att_padded_rows_and_edges():
    """Padded nodes come out exactly zero and take no gradient; padded
    edges (vid 0, whose A' is not zero) add nothing, because the dummy
    node's h0 row is zero."""
    p, _, dims, cw = att_problem(1)
    args, leaves = torch_att_args(p, dims)
    h = A.fused_att(*args)
    pad = p["mask"][:, 0] == 0
    assert pad.any() and not h.detach().numpy()[pad].any()
    dh0, = torch.autograd.grad((h * torch.tensor(cw)).sum(), [leaves["h0"]])
    real_e = p["src"] != dims["n"] - 1
    q = dict(p, src=p["src"][real_e], dst=p["dst"][real_e],
             vid=p["vid"][real_e])
    args2, _ = torch_att_args(q, dims)
    h2 = A.fused_att(*args2)
    np.testing.assert_allclose(h.detach().numpy(), h2.detach().numpy(),
                               rtol=1e-6, atol=1e-7)
    assert not dh0.numpy()[pad].any()


def s2v_problem(seed, n=160, g=14, nf=5):
    """A packed batch (build_problem's graphs and padded nodes), a random
    masked x of width w = 2·nf, and set2vec_init's leaves."""
    rng = np.random.RandomState(seed)
    args, _, _ = build_problem(rng, n=n, g=g, f=4, od=4, k=3, steps=1)
    w = 2 * nf
    x = (rng.randn(n, w) * args["mask"]).astype(np.float32)
    plan = plan_fused_step(args["src"], args["dst"],
                           np.ones(args["src"].shape[0], np.float32),
                           args["node_graph"], n, g, block_edges=128)
    rp = jax.tree.map(np.asarray, set2vec_init(jax.random.PRNGKey(seed), nf))
    gnp = plan_fused_eval(args["dst"], args["node_graph"], g).graph_node_ptr
    cw = rng.randn(g, 2 * w).astype(np.float32)
    return rp, x, args["mask"], args["node_graph"], gnp, plan, cw


def jax_s2v(fn, rp, x, cw):
    (_, m), (g_rp, g_x) = jax.value_and_grad(
        lambda r, xx: (lambda m: (jnp.sum(m * cw), m))(fn(r, xx)),
        argnums=(0, 1), has_aux=True)(jax.tree.map(jnp.asarray, rp),
                                      jnp.asarray(x))
    leaves = {f"lstm/{k}": np.asarray(v) for k, v in g_rp["lstm"].items()}
    leaves["q_attn/w"] = np.asarray(g_rp["q_attn"]["w"])
    leaves["e_attn/w"] = np.asarray(g_rp["e_attn"]["w"])
    leaves["x"] = np.asarray(g_x)
    return np.asarray(m), leaves


def torch_s2v(rp, x, mask, ng, gnp, cw, **kw):
    t = lambda a: torch.tensor(np.ascontiguousarray(a))
    trp = {"lstm": {k: t(v).requires_grad_() for k, v in rp["lstm"].items()},
           "q_attn": {"w": t(rp["q_attn"]["w"]).requires_grad_()},
           "e_attn": {"w": t(rp["e_attn"]["w"]).requires_grad_()}}
    tx = t(x).requires_grad_()
    S.reset_launch_counts()
    m = S.set2vec(trp, tx, t(mask), t(ng), t(gnp), **kw)
    leaves = {f"lstm/{k}": v for k, v in trp["lstm"].items()}
    leaves.update({"q_attn/w": trp["q_attn"]["w"],
                   "e_attn/w": trp["e_attn"]["w"], "x": tx})
    grads = torch.autograd.grad((m * t(cw)).sum(), list(leaves.values()))
    assert sum(S.launch_counts.values()) == 0       # plain version on CPU
    return m.detach().numpy(), {k: g.numpy()
                                for k, g in zip(leaves, grads)}


@pytest.mark.parametrize("batch_softmax", [True, False])
def test_set2vec_matches_pallas_interpret(batch_softmax):
    """m (G, 2w) and the gradient in every readout leaf and x, T 4."""
    rp, x, mask, ng, gnp, plan, cw = s2v_problem(2)
    n, w = x.shape
    g = gnp.shape[0] - 1
    op = make_set2vec_op(w, n, g, time_steps=4,
                         node_window=plan.node_window, interpret=True,
                         batch_softmax=batch_softmax)
    ns = jnp.asarray(plan.node_start)
    want = jax_s2v(lambda r, xx: op(r, xx, jnp.asarray(mask),
                                    jnp.asarray(ng), ns), rp, x, cw)
    got = torch_s2v(rp, x, mask, ng, gnp, cw, time_steps=4,
                    batch_softmax=batch_softmax)
    assert np.abs(want[0]).max() > 1e-2
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    assert_leaves_close(got[1], want[1])
    assert not got[1]["x"][mask[:, 0] == 0].any()


@pytest.mark.parametrize("batch_softmax", [True, False])
def test_set2vec_matches_jax_plain_at_100_steps(batch_softmax):
    """The reference's depth (set2vec.py:79): 100 steps against the JAX
    package's sparse_set2vec, forward and every gradient leaf."""
    rp, x, mask, ng, gnp, _, cw = s2v_problem(3)
    g = gnp.shape[0] - 1
    want = jax_s2v(lambda r, xx: sparse_set2vec(
        r, xx, jnp.asarray(mask), jnp.asarray(ng), g, time_steps=100,
        batch_softmax=batch_softmax), rp, x, cw)
    got = torch_s2v(rp, x, mask, ng, gnp, cw, time_steps=100,
                    batch_softmax=batch_softmax)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    assert_leaves_close(got[1], want[1], rtol=1e-3)


def test_grad_layouts_cover_every_leaf_once():
    k, f, w = 9, 7, 14
    for mod, layout, args, sizes in (
            (A, A.grad_layout(k, f), (k, f),
             [k * f * f, f * f, k * f, f, f * f, 3 * f * f, 3 * f * f,
              3 * f, 3 * f]),
            (S, S.grad_layout(w), (w,),
             [2 * w * w] * 4 + [w] * 4 + [w * w, w])):
        off = 0
        for name, size in zip(mod._GRAD_LEAVES, sizes):
            assert layout[name][0] == off, name
            assert int(np.prod(layout[name][1])) == size, name
            off += size
        assert layout["total"][0] == off
        flat = torch.arange(off, dtype=torch.float32)
        parts = mod.split_grads(flat, *args)
        assert torch.equal(torch.cat([parts[nm].reshape(-1)
                                      for nm in mod._GRAD_LEAVES]), flat)


@pytest.mark.parametrize("with_corr", [True, False])
def test_fused_att_is_the_one_step_att_steps_function(with_corr):
    """The adv model's op is the att model's T-step op at one step, one
    message network and no state norm, bit for bit: the forward and the
    autograd gradient of every leaf on the same seeded inputs (the
    identity on which the adv backward kernel builds the T-step one's
    body at T 1)."""
    from mpnn_tpu_torch.kernels import fused_att_steps as AS
    p, _, dims, cw = att_problem(3)
    args, leaves = torch_att_args(p, dims)
    c = torch.tensor(cw)
    h = A.fused_att_reference(*args, with_corr=with_corr)
    want = torch.autograd.grad((h * c).sum(), list(leaves.values()),
                               allow_unused=True)
    one = [t.unsqueeze(0) for t in args[:5]]
    h1 = AS.fused_att_steps_reference(*one, *args[5:], steps=1,
                                      with_corr=with_corr,
                                      state_norm="none")
    got = torch.autograd.grad((h1 * c).sum(), list(leaves.values()),
                              allow_unused=True)
    assert torch.equal(h, h1)
    for name, w, g in zip(leaves, want, got):
        assert (w is None) == (g is None), name
        if w is not None:
            assert torch.equal(w, g), name


# ---------------------------------------------------------------------------
# the backward kernel's launch rule (kernels/fused_att.py::launch_shape),
# decided on the host from shapes alone
# ---------------------------------------------------------------------------

H100_SMEM = 232448                   # opt-in bytes a block

# (node slots, graphs, bucket, vocab, co-resident blocks, the launch's tag)
BWD_RULE_CASES = [
    (14, 1, "", 8, 132, "free x1 cap 28"),          # b1: one block
    (270, 16, "", 8, 132, "free x17 cap 32"),       # b16: a block per 16
    (100, 20, "", 8, 132, "free x20 cap 10"),       # a block a graph
    (132 * 16, 132, "", 8, 132, "free x132 cap 32"),  # the card's blocks
    (132 * 16 + 1, 132, "", 8, 132, "free x132 cap 34"),  # one past them
    (16512, 1024, "", 8, 132, "free x132 cap 187"),   # b1024, tile's cap
    (16512, 1024, "", 64, 264, "free x264 cap 126"),  # two blocks an SM
    (16512, 1024, "f32", 64, 132, "free x132 cap 71"),  # the wide bucket
    (10 ** 6, 4000, "", 8, 1000, "free x512 cap 187"),  # MAX_GRID
]


@pytest.mark.parametrize("n,g,tag,k,most,want", BWD_RULE_CASES)
def test_att_bwd_rule_at_its_boundaries(n, g, tag, k, most, want):
    """A block per BWD_NODES slots or a block a graph, whichever is more,
    at most the co-resident blocks and MAX_GRID; a tile of BWD_SLACK
    times the share within the most node slots a block's shared memory
    holds (the bytes are the tile's, one more node does not fit)."""
    s = A.launch_shape(n, tag, k, smem_bytes=H100_SMEM, max_grid=most,
                       graphs=g)
    assert s.tag() == want
    assert s.grid == min(most, A.MAX_GRID, max(-(-n // A.BWD_NODES), g))
    cap = A.K.tile_capacity(lambda c: A.bwd_smem_floats(tag, k, c),
                            H100_SMEM, A.MAX_NCAP)
    assert s.ncap == min(cap, A.BWD_SLACK * -(-n // s.grid))
    assert s.ecap == A.EDGE_RATIO * s.ncap
    assert s.smem_bytes == 4 * A.bwd_smem_floats(tag, k, s.ncap) \
        <= H100_SMEM
    assert 4 * A.bwd_smem_floats(tag, k, cap + 1) > H100_SMEM


def test_att_bwd_rule_on_a_smaller_card_and_forced_launches():
    """Less shared memory shrinks the tile (blocks past it keep their
    graphs in global scratch, on the same launch); a card that cannot
    hold one node raises; forced launches (a check's and a
    measurement's) take a block per `nodes` slots past the co-resident
    blocks (up to MAX_GRID) or the given tile."""
    big = A.launch_shape(16512, "", 8, smem_bytes=H100_SMEM, max_grid=132,
                         graphs=1024)
    small = A.launch_shape(16512, "", 8, smem_bytes=100 * 1024,
                           max_grid=132, graphs=1024)
    assert small.grid == big.grid and small.ncap < big.ncap
    assert small.smem_bytes <= 100 * 1024
    with pytest.raises(NotImplementedError, match="shared memory"):
        A.launch_shape(16, "", 8, smem_bytes=8 * 1024, max_grid=132)
    one = A.launch_shape(16512, "", 8, smem_bytes=H100_SMEM, max_grid=132,
                         graphs=1024, nodes=1 << 30)
    assert (one.grid, one.ncap) == (1, big.ncap)
    per = A.launch_shape(16512, "", 8, smem_bytes=H100_SMEM, max_grid=132,
                         graphs=1024, nodes=64)
    assert per.grid == 258
    assert A.launch_shape(16512, "", 8, smem_bytes=H100_SMEM, max_grid=132,
                          nodes=1).grid == A.MAX_GRID
    spilled = A.launch_shape(270, "", 8, smem_bytes=H100_SMEM, max_grid=132,
                             graphs=16, ncap=1)
    assert (spilled.grid, spilled.ncap, spilled.ecap) == (17, 1,
                                                          A.EDGE_RATIO)


@pytest.mark.parametrize("route,want", [
    (None, "free x17 cap 32"), ("nodes 1", "free x270 cap 2"),
    ("nodes 64", "free x5 cap 108"), ("one", "free x1 cap 187"),
    ("spilled", "free x17 cap 1")])
def test_att_bwd_forced_launches(monkeypatch, route, want):
    """chip_smoke.py::_adv_bwd_route forces each launch on the rule's
    card (an H100's shared memory and 132 co-resident blocks) at b16's
    270 node slots in 16 graphs, and restores the rule after."""
    import types
    from chip_smoke import _adv_bwd_route
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda d: types.SimpleNamespace(
            shared_memory_per_block_optin=H100_SMEM,
            multi_processor_count=132))
    rule = lambda n, tag, k, g, device: A.launch_shape(
        n, tag, k, smem_bytes=H100_SMEM, max_grid=132, graphs=g)
    monkeypatch.setattr(A, "device_bwd_shape", rule)
    with _adv_bwd_route(route):
        assert A.device_bwd_shape(270, "", 8, 16, "cuda").tag() == want
    assert A.device_bwd_shape is rule
    with pytest.raises(ValueError, match="unknown route"):
        with _adv_bwd_route("grid"):
            pass
