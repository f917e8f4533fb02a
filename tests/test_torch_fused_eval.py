"""The port's whole-step eval op (mpnn_tpu_torch.kernels.fused_step)
against the JAX package's Pallas eval kernel, run in interpret mode on the
CPU (make_fused_eval_op(..., interpret=True)).

Tolerance rtol 2e-4 / atol 1e-5: the JAX package's own for this comparison
(tests/test_fused_step.py, TestFusedEval) — both sides are float32 and sum
messages and per-graph rows in different orders.

The CUDA kernel itself is compared with its plain version at the
flagship widths by tests/test_torch_gpu.py on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpnn_tpu.kernels.fused_step import make_fused_eval_op
from mpnn_tpu_torch.graphs.batching import plan_fused_eval
from mpnn_tpu_torch.kernels import fused_step as K
from test_fused_step import build_problem

RTOL, ATOL = 2e-4, 1e-5


def _states(rng, f):
    """Non-trivial running statistics for both norms."""
    def st():
        return {"running_mean": (0.3 * rng.randn(f)).astype(np.float32),
                "running_var": (0.5 + rng.rand(f)).astype(np.float32)}
    return st(), st()


def _jax_out(args, plan, dims, ma_state, bn_state, msg_norm, state_norm):
    op = make_fused_eval_op(
        dims["steps"], dims["f"], dims["n"], dims["od"], dims["g"],
        dims["k"], block_edges=plan.block_edges, window=plan.window,
        node_window=plan.node_window, interpret=True,
        msg_norm=msg_norm, state_norm=state_norm)
    a = {k: jax.tree.map(jnp.asarray, v) for k, v in args.items()}
    out = op(a["amat"], a["a0"], a["mbias"], a["h0"], a["mask"],
             a["node_graph"], a["gru"], a["ma_bn"],
             jax.tree.map(jnp.asarray, ma_state), a["bn"],
             jax.tree.map(jnp.asarray, bn_state), a["ro"], a["vid"],
             a["src"], a["dst"], jnp.asarray(plan.win_start),
             jnp.asarray(plan.node_start))
    return np.asarray(out)


def _torch_args(args, dims, ma_state, bn_state, device="cpu"):
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=device)
    tree = lambda d: {k: (tree(v) if isinstance(v, dict) else t(v))
                      for k, v in d.items()}
    plan = plan_fused_eval(args["dst"], args["node_graph"], dims["g"])
    return (t(args["amat"]), t(args["a0"]), t(args["mbias"]), t(args["h0"]),
            t(args["mask"]), t(args["node_graph"]), tree(args["gru"]),
            tree(args["ma_bn"]), tree(ma_state), tree(args["bn"]),
            tree(bn_state), tree(args["ro"]), t(args["vid"]), t(args["src"]),
            t(args["dst"]), K.FusedEvalPlan(*(t(p) for p in plan)))


@pytest.mark.parametrize("msg_norm,state_norm,od",
                         [("bn1d", "bn1d", 6), ("none", "none", 6),
                          ("none", "stateless", 6), ("bn1d", "stateless", 6),
                          ("none", "none", 72), ("none", "stateless", 72)])
def test_fused_eval_matches_pallas_interpret(msg_norm, state_norm, od):
    """The served output of every norm pair; the stateless state norm by
    this batch's own statistics; od 72 past the od-64 buckets."""
    rng = np.random.RandomState(0)
    args, plan, dims = build_problem(rng, od=od)
    ma_state, bn_state = _states(rng, dims["f"])
    want = _jax_out(args, plan, dims, ma_state, bn_state, msg_norm,
                    state_norm)
    got = K.fused_eval(*_torch_args(args, dims, ma_state, bn_state),
                       steps=dims["steps"], msg_norm=msg_norm,
                       state_norm=state_norm).numpy()
    assert got.shape == want.shape == (dims["g"], dims["od"])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.abs(want).max() > 1e-2          # not a trivial comparison


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch():
    rng = np.random.RandomState(1)
    args, _, dims = build_problem(rng, n=128, g=12)
    ma_state, bn_state = _states(rng, dims["f"])
    targs = _torch_args(args, dims, ma_state, bn_state)
    K.reset_launch_counts()
    a = K.fused_eval(*targs, steps=dims["steps"])
    b = K.fused_eval_reference(*targs, steps=dims["steps"])
    assert torch.equal(a, b)
    assert K.launch_counts["fused_eval"] == 0


def _layout_case():
    rng = np.random.RandomState(3)
    args, _, dims = build_problem(rng, n=128, g=12)
    ma_state, bn_state = _states(rng, dims["f"])
    targs = list(_torch_args(args, dims, ma_state, bn_state))
    return targs, dims


@pytest.mark.parametrize("fault", ["unsorted_graph", "real_mask_zero",
                                   "cross_graph_edge", "vid_range",
                                   "plan_order", "plan_graph_ptr"])
def test_layout_checks_raise(fault):
    targs, dims = _layout_case()
    h0, mask, ng, vid, src, dst, plan = (targs[3], targs[4], targs[5],
                                         targs[12], targs[13], targs[14],
                                         targs[15])
    K.check_batch_layout(h0, mask, ng, vid, src, dst, plan, dims["k"],
                         dims["g"])                       # the clean case
    if fault == "unsorted_graph":
        ng = ng.clone()
        ng[0], ng[-20] = ng[-20].item(), ng[0].item()
    elif fault == "real_mask_zero":
        mask = mask.clone()
        mask[0] = 0.0
    elif fault == "cross_graph_edge":
        src = src.clone()
        src[0] = int(plan.graph_node_ptr[-2])             # a node of the
    elif fault == "vid_range":                            # last graph
        vid = vid.clone()
        vid[0] = dims["k"]
    elif fault == "plan_order":
        order = plan.edge_order.clone()
        order[0] = order[1]
        plan = plan._replace(edge_order=order)
    else:
        gnp = plan.graph_node_ptr.clone()
        gnp[1] += 1
        plan = plan._replace(graph_node_ptr=gnp)
    with pytest.raises(ValueError, match="fused_eval"):
        K.check_batch_layout(h0, mask, ng, vid, src, dst, plan, dims["k"],
                             dims["g"])


# the folded serving kernel's launch rule (kernels/fused_step.py::
# eval_launch_shape) on an H100's shared memory, for its narrow bucket at
# lipo's vocab and steps; max_grid stands for the card's co-resident
# blocks (two an SM)
H100 = dict(smem_bytes=232448, max_grid=264)

EVAL_RULE_CASES = [
    (1, {}, "free x1 cap 2"),
    (256, {}, "free x16 cap 32"),                  # b16: a block a graph
    (16 * 264, {}, "free x264 cap 32"),            # the co-resident blocks
    (16 * 264 + 1, {}, "free x264 cap 34"),        # one past: no more
    (16512, {}, "free x264 cap 126"),              # b1024: one wave
    (16512, dict(max_grid=114), "free x114 cap 290"),   # a smaller card
    (16512, dict(nodes=1), "free x16512 cap 2"),   # forced shares
    (16512, dict(nodes=1 << 30), "free x1 cap 601"),    # the tile fills
    (16512, dict(ncap=1), "free x264 cap 1"),
    (256, dict(nodes=40), "free x7 cap 74"),
    # a block a graph where the batch has more graphs than EVAL_NODES
    # shares (the wide buckets' b16: 8 slots a graph)
    (256, dict(graphs=16), "free x16 cap 32"),
    (128, dict(graphs=16), "free x16 cap 16"),
    (16512, dict(graphs=1024), "free x264 cap 126"),
    (2000, dict(graphs=300), "free x264 cap 16"),
]


@pytest.mark.parametrize("n,kw,tag", EVAL_RULE_CASES)
def test_eval_launch_rule_at_its_boundaries(n, kw, tag):
    """A block per EVAL_NODES slots or a block a graph, whichever is more,
    at most the co-resident blocks (one wave) unless a share is forced; a
    tile EVAL_SLACK times the share,
    within the most node slots that fit the card (FWD_MAX_NCAP) or the
    forced tile; the block's shared memory that tile's."""
    args = {**H100, **kw}
    s = K.eval_launch_shape(n, "", 6, 6, **args)
    assert s.tag() == tag
    assert s.route == "free" and s.ecap == K.EDGE_RATIO * s.ncap
    assert s.smem_bytes == 4 * K.eval_smem_floats("", 6, 6, s.ncap)
    assert s.smem_bytes <= H100["smem_bytes"]
    if "nodes" not in kw:
        assert s.grid == max(1, min(args["max_grid"], max(
            -(-n // K.EVAL_NODES), kw.get("graphs", 0))))


def test_eval_launch_rule_names_and_refusals(monkeypatch):
    """The forced routes' names (chip_smoke.py::_eval_route, which forces
    the launches inside it) map to the rule's keywords; an unknown one
    raises; a card where not one node's tile fits raises rather than
    launching something else; the wide buckets' tiles give way first."""
    import types

    import chip_smoke as CS
    monkeypatch.setattr(
        K, "device_eval_shape", lambda n, tag, k, steps, device, graphs=0:
        K.eval_launch_shape(n, tag, k, steps, graphs=graphs, **H100))
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d:
                        types.SimpleNamespace(
                            shared_memory_per_block_optin=232448))
    rule = K.device_eval_shape(16512, "", 6, 6, "cuda", 1024)
    for route, kw in ((None, {}), ("nodes 8", dict(nodes=8)),
                      ("one", dict(nodes=1 << 30)), ("spilled", dict(ncap=1))):
        with CS._eval_route(route):
            got = K.device_eval_shape(16512, "", 6, 6, "cuda", 1024)
        assert got == K.eval_launch_shape(16512, "", 6, 6, graphs=1024,
                                          **{**H100, **kw}), route
    assert K.device_eval_shape(16512, "", 6, 6, "cuda", 1024) == rule
    for bad in ("nodes", "nodes 0", "grid", "cluster 8"):
        with pytest.raises(ValueError, match="route"):
            with CS._eval_route(bad):
                pass
    with pytest.raises(NotImplementedError, match="shared memory"):
        K.eval_launch_shape(256, "o128", 64, 6, smem_bytes=4096,
                            max_grid=264)
    narrow = K.eval_launch_shape(16512, "", 6, 6, smem_bytes=40 * 1024,
                                 max_grid=264)
    wide = K.eval_launch_shape(16512, "o128", 6, 6, smem_bytes=40 * 1024,
                               max_grid=264)
    assert wide.ncap < narrow.ncap <= 126
