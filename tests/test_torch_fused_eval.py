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
