"""The port's whole-step training op (mpnn_tpu_torch.kernels.fused_step::
fused_step) against the JAX package's Pallas training kernels, run in
interpret mode on the CPU (make_fused_step_op(..., interpret=True), whose
forward is `_fwd_kernel` and whose backward at this size is
`_full_bwd_kernel`). On the CPU the port's op is its plain version,
fused_step_reference, under autograd.

Tolerances: forward outputs rtol 2e-4 / atol 1e-5 (the JAX package's own
for its kernel against its reference, tests/test_fused_step.py); every
gradient leaf is compared after dividing both sides by the leaf's max abs,
at rtol 2e-4 / atol 1e-5 — float32 on both sides, batch-wide sums in other
orders. message_bias has zero gradient in theory under the message bn1d,
so under it only an absolute bound on the scale of the A0 gradient holds.

The CUDA kernels themselves are compared with this plain version at the
flagship widths by tests/test_torch_gpu.py on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpnn_tpu.kernels.fused_step import make_fused_step_op
from mpnn_tpu_torch.graphs.batching import plan_fused_eval
from mpnn_tpu_torch.kernels import fused_step as K
from test_fused_step import as_jnp, build_problem

RTOL, ATOL = 2e-4, 1e-5
NORMS = [("bn1d", "bn1d"), ("bn1d", "none"), ("none", "bn1d"),
         ("none", "none"), ("none", "stateless"), ("bn1d", "stateless")]
# the leaves in the order of the JAX op's differentiable arguments
LEAVES = ["amat", "a0", "mbias", "h0", "gru/b_hh", "gru/b_ih", "gru/w_hh",
          "gru/w_ih", "ma_bn/bias", "ma_bn/weight", "bn/bias", "bn/weight",
          "ro/i/b", "ro/i/w", "ro/j/b", "ro/j/w"]


def _small_problem(seed, steps=3, od=6):
    rng = np.random.RandomState(seed)
    args, plan, dims = build_problem(rng, n=128, g=12, steps=steps, od=od)
    cw = rng.randn(dims["g"], dims["od"]).astype(np.float32)
    return args, plan, dims, cw


def _jax_step(args, plan, dims, cw, msg_norm, state_norm):
    """(loss, out, ma_stats, step_stats, {leaf: grad}) of the Pallas op in
    interpret mode, the gradient of 1.3·loss + Σ out·cw."""
    op = make_fused_step_op(
        dims["steps"], dims["f"], dims["n"], dims["od"], dims["g"],
        dims["k"], block_edges=plan.block_edges, window=plan.window,
        node_window=plan.node_window, interpret=True, msg_norm=msg_norm,
        state_norm=state_norm)
    a = as_jnp(args)
    win, ns = jnp.asarray(plan.win_start), jnp.asarray(plan.node_start)

    def obj(amat, a0, mbias, h0, gru, ma_bn, bn, ro):
        loss, out, ma, st = op(amat, a0, mbias, h0, a["mask"],
                               a["node_graph"], gru, ma_bn, bn, ro,
                               a["labels"], a["gmask"], a["vid"], a["src"],
                               a["dst"], win, ns)
        return 1.3 * loss + jnp.sum(out * cw), (loss, out, ma, st)

    diff = (a["amat"], a["a0"], a["mbias"], a["h0"], a["gru"], a["ma_bn"],
            a["bn"], a["ro"])
    (_, (loss, out, ma, st)), grads = jax.jit(jax.value_and_grad(
        obj, argnums=tuple(range(8)), has_aux=True))(*diff)
    flat = [np.asarray(x) for x in jax.tree.leaves(grads)]
    return (np.asarray(loss), np.asarray(out),
            [np.asarray(x) for x in ma],
            [[np.asarray(x) for x in s] for s in st],
            dict(zip(LEAVES, flat)))


def _torch_inputs(args, dims):
    """fused_step's arguments as CPU tensors, the differentiable leaves
    requiring grad, and {leaf: tensor} in LEAVES order."""
    t = lambda x: torch.tensor(np.ascontiguousarray(x))
    gru = {k: t(v).requires_grad_() for k, v in args["gru"].items()}
    ma = {k: t(v).requires_grad_() for k, v in args["ma_bn"].items()}
    bn = {k: t(v).requires_grad_() for k, v in args["bn"].items()}
    ro = {s: {k: t(v).requires_grad_() for k, v in args["ro"][s].items()}
          for s in ("i", "j")}
    amat, a0, mbias, h0 = (t(args[k]).requires_grad_()
                           for k in ("amat", "a0", "mbias", "h0"))
    plan = plan_fused_eval(args["dst"], args["node_graph"], dims["g"])
    targs = (amat, a0, mbias, h0, t(args["mask"]), t(args["node_graph"]),
             gru, ma, bn, ro, t(args["labels"]), t(args["gmask"]),
             t(args["vid"]), t(args["src"]), t(args["dst"]),
             K.FusedEvalPlan(*(t(p) for p in plan)))
    leaves = {"amat": amat, "a0": a0, "mbias": mbias, "h0": h0,
              "gru/b_hh": gru["b_hh"], "gru/b_ih": gru["b_ih"],
              "gru/w_hh": gru["w_hh"], "gru/w_ih": gru["w_ih"],
              "ma_bn/bias": ma["bias"], "ma_bn/weight": ma["weight"],
              "bn/bias": bn["bias"], "bn/weight": bn["weight"],
              "ro/i/b": ro["i"]["b"], "ro/i/w": ro["i"]["w"],
              "ro/j/b": ro["j"]["b"], "ro/j/w": ro["j"]["w"]}
    return targs, leaves


def _torch_step(args, dims, cw, msg_norm, state_norm, **kw):
    targs, leaves = _torch_inputs(args, dims)
    loss, out, ma, st = K.fused_step(*targs, steps=dims["steps"],
                                     msg_norm=msg_norm,
                                     state_norm=state_norm, **kw)
    obj = 1.3 * loss + (out * torch.tensor(cw)).sum()
    grads = torch.autograd.grad(obj, list(leaves.values()),
                                allow_unused=True)
    return (loss.detach().numpy(), out.detach().numpy(),
            [x.numpy() for x in ma], [[x.numpy() for x in s] for s in st],
            {k: (np.zeros_like(v.detach().numpy()) if g is None
                 else g.numpy())
             for (k, v), g in zip(leaves.items(), grads)})


@pytest.mark.parametrize("msg_norm,state_norm,od",
                         [(m, s, 6) for m, s in NORMS]
                         + [("none", "none", 72), ("bn1d", "stateless", 72)])
def test_fused_step_matches_pallas_interpret(msg_norm, state_norm, od):
    """loss, out, the batch statistics of every slot (the stateless norm's
    batch mean and var too), and every gradient leaf, with the cotangents
    of both the loss and out nonzero; od 72 is past the od-64 buckets (the
    basic shell's od = 4·afm at afm 18)."""
    args, plan, dims, cw = _small_problem(0, od=od)
    want = _jax_step(args, plan, dims, cw, msg_norm, state_norm)
    got = _torch_step(args, dims, cw, msg_norm, state_norm)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)
    assert np.abs(want[1]).max() > 1e-2         # not a trivial comparison
    for a, b in zip([got[2], *got[3]], [want[2], *want[3]]):
        np.testing.assert_allclose(a[0], b[0], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(a[1], b[1], rtol=RTOL, atol=ATOL)
    assert len(got[3]) == dims["steps"]
    for name in LEAVES:
        g, w = got[4][name], want[4][name]
        assert g.shape == w.shape, name
        if name == "mbias" and msg_norm == "bn1d":
            bound = ATOL * np.abs(want[4]["a0"]).max()
            assert np.abs(g - w).max() <= bound, name
            continue
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g / scale, w / scale, rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    # the norms a mode leaves out get exactly zero gradient on both sides
    if msg_norm == "none":
        assert not got[4]["ma_bn/weight"].any()
    if state_norm != "bn1d":
        assert not got[4]["bn/weight"].any()


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch():
    args, _, dims, _ = _small_problem(1, steps=2)
    targs, _ = _torch_inputs(args, dims)
    K.reset_launch_counts()
    a = K.fused_step(*targs, steps=2)
    b = K.fused_step_reference(*targs, steps=2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[1].requires_grad and not a[2][0].requires_grad
    assert K.launch_counts["fused_step_fwd"] == 0
    assert K.launch_counts["fused_step_bwd"] == 0


def test_grad_layout_covers_every_leaf_once():
    k, f, od = 7, 10, 14
    layout = K.grad_layout(k, f, od)
    sizes = {"amat": k * f * f, "a0": f * f, "mbias": f,
             "w_ih": 3 * f * f, "w_hh": 3 * f * f, "b_ih": 3 * f,
             "b_hh": 3 * f, "ma_w": f, "ma_b": f, "bn_w": f, "bn_b": f,
             "ro_iw": 2 * f * od, "ro_ib": od, "ro_jw": 2 * f * od,
             "ro_jb": od}
    off = 0
    for name in K._GRAD_LEAVES:
        assert layout[name][0] == off, name
        assert int(np.prod(layout[name][1])) == sizes[name], name
        off += sizes[name]
    assert layout["total"][0] == off
    flat = torch.arange(off, dtype=torch.float32)
    parts = K.split_grads(flat, k, f, od)
    assert torch.equal(torch.cat([parts[n].reshape(-1)
                                  for n in K._GRAD_LEAVES]), flat)


@pytest.mark.parametrize("fault", ["plan_src_order", "plan_src_ptr"])
def test_layout_checks_cover_the_source_plan(fault):
    """The backward kernel's source-sorted plan is derived on the device
    from the checked edge_src (source_order), so it is right by
    construction: a stable argsort and the row pointers of its counts.
    A bad edge_src is caught by the layout check that guards both
    kernels."""
    args, _, dims, _ = _small_problem(3, steps=2)
    targs, _ = _torch_inputs(args, dims)
    h0, mask, ng, vid, src, dst, plan = (targs[3], targs[4], targs[5],
                                         targs[12], targs[13], targs[14],
                                         targs[15])
    n, s = h0.shape[0], np.asarray(args["src"]).astype(np.int64)
    order, ptr = K.source_order(src, n)
    assert order.dtype == ptr.dtype == torch.int32
    if fault == "plan_src_order":
        assert order.tolist() == np.argsort(s, kind="stable").tolist()
    else:
        want = np.concatenate([[0], np.cumsum(np.bincount(s, minlength=n))])
        assert ptr.tolist() == want.tolist()
    K.check_batch_layout(h0, mask, ng, vid, src, dst, plan, dims["k"],
                         dims["g"], who="fused_step")
    bad = src.clone()
    # an edge into graph 0 whose source goes below node 0 (clamped, it
    # stays inside graph 0, so only the range check fires)
    bad[int(torch.nonzero(ng[dst.long()] == 0)[0])] = -1
    with pytest.raises(ValueError, match="fused_step: src/dst out of range"):
        K.check_batch_layout(h0, mask, ng, vid, bad, dst, plan, dims["k"],
                             dims["g"], who="fused_step")
