"""The port's T-step attention op (mpnn_tpu_torch.kernels.fused_att_steps)
against the JAX package on the CPU: fused_att_steps_reference against the
Pallas op make_fused_att_steps_op in interpret mode (its kernels are
`_att_steps_fwd_kernel` with `_att_steps_edge_fwd`, and
`_att_steps_bwd_kernel`), forward and every gradient leaf, for the four
modes of tests/test_fused_norm_modes.py::ATT_STEPS_MODES — per-step or
shared message tables, the stateless norm or none, 'adj' or 'att' — and a
ragged batch. On the CPU the port's op is its plain version (under
autograd). Also: the attention ops decide before launching whether autograd
records them, so serving (torch.no_grad) writes no training residuals.

Tolerances, the JAX package's own for this op against its reference
(tests/test_fused_norm_modes.py:307-320): forward rtol 2e-4 / atol 1e-5;
every gradient leaf divided by its max abs, rtol 5e-4 / atol 3e-5 (float32
through the T-step chain and the batch-wide norm, sums in other orders).

The CUDA kernels are compared with this plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpnn_tpu.kernels.fused_att import make_fused_att_steps_op
from mpnn_tpu_torch.graphs.batching import FusedEvalPlan, plan_fused_eval
from mpnn_tpu_torch.kernels import fused_att as A
from mpnn_tpu_torch.kernels import fused_att_steps as AS
from mpnn_tpu_torch.kernels import fused_step as K
from mpnn_tpu_torch.kernels import set2vec as S
from test_torch_att_kernels import assert_leaves_close, att_problem

FWD_RTOL, FWD_ATOL = 2e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 3e-5
STEPS = 3
LEAVES = ("aprime", "a0", "qv", "q0", "wh", "h0", "w_ih", "w_hh", "b_ih",
          "b_hh")
# (per-step tables, state norm, with_corr): ATT_STEPS_MODES at the op level
MODES = [(True, "stateless", False), (True, "none", False),
         (False, "stateless", False), (True, "stateless", True)]


def steps_problem(seed, tm, **kw):
    """att_problem's packed batch (padded nodes, single-node graphs,
    padded edges on the dummy node, whose vid 0 has a nonzero A') with Tm
    random message tables."""
    p, plan, dims, cw = att_problem(seed, **kw)
    rng = np.random.RandomState(seed + 100)
    f, k = dims["f"], dims["k"]
    r = lambda *s, sc=1.0: (rng.randn(*s) * sc).astype(np.float32)
    p = dict(p, aprime=r(tm, k, f, f, sc=0.3), a0=r(tm, f, f, sc=0.3),
             qv=r(tm, k, f), q0=r(tm, f), wh=r(tm, f, f, sc=0.5))
    return p, plan, dims, cw


def jax_steps(p, plan, dims, cw, *, per_step, state_norm, with_corr):
    """(h, {leaf: grad of Σ h·cw}) of the Pallas op in interpret mode."""
    op = make_fused_att_steps_op(
        STEPS, dims["f"], dims["n"], dims["g"], dims["k"],
        with_corr=with_corr, state_norm=state_norm, per_step_msgs=per_step,
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
    grads = dict(zip(LEAVES[:6], map(np.asarray, g[:6])))
    grads.update({k: np.asarray(v) for k, v in g[6].items()})
    return np.asarray(h), grads


def torch_steps(p, dims, cw, **kw):
    """(h, {leaf: grad of Σ h·cw}) of the port's op on the CPU."""
    t = lambda x: torch.tensor(np.ascontiguousarray(x))
    w = {k: t(p[k]).requires_grad_() for k in LEAVES[:6]}
    gru = {k: t(v).requires_grad_() for k, v in p["gru"].items()}
    plan = FusedEvalPlan(*map(t, plan_fused_eval(p["dst"], p["node_graph"],
                                                 dims["g"])))
    AS.reset_launch_counts()
    h = AS.fused_att_steps(w["aprime"], w["a0"], w["qv"], w["q0"], w["wh"],
                           w["h0"], t(p["mask"]), t(p["node_graph"]), gru,
                           t(p["vid"]), t(p["src"]), t(p["dst"]), plan,
                           steps=STEPS, **kw)
    leaves = {**w, **gru}
    grads = torch.autograd.grad((h * t(cw)).sum(), list(leaves.values()),
                                allow_unused=True)
    assert sum(AS.launch_counts.values()) == 0      # plain version on CPU
    return h.detach().numpy(), {
        k: np.zeros(v.shape, np.float32) if g is None else g.numpy()
        for (k, v), g in zip(leaves.items(), grads)}


@pytest.mark.parametrize("per_step,state_norm,with_corr", MODES)
def test_fused_att_steps_matches_pallas_interpret(per_step, state_norm,
                                                  with_corr):
    """h and the gradient in every leaf (the Tm-stacked aprime, a0, qv,
    q0, wh, then h0 and the four GRU leaves) of Σ h·c."""
    tm = STEPS if per_step else 1
    p, plan, dims, cw = steps_problem(0, tm)
    kw = dict(state_norm=state_norm, with_corr=with_corr)
    want_h, want_g = jax_steps(p, plan, dims, cw, per_step=per_step, **kw)
    got_h, got_g = torch_steps(p, dims, cw, **kw)
    assert np.abs(want_h).max() > 1e-2
    np.testing.assert_allclose(got_h, want_h, rtol=FWD_RTOL, atol=FWD_ATOL)
    assert_leaves_close(got_g, want_g, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert got_g["aprime"].shape == (tm, dims["k"], dims["f"], dims["f"])
    if not with_corr:
        assert not got_g["a0"].any() and not got_g["q0"].any()


def test_fused_att_steps_ragged_batch():
    """A smaller batch of mostly tiny graphs (single-node graphs, padded
    nodes and padded edges), the att model's mode: per-step tables, the
    stateless norm, 'adj'. Padded rows come out zero and take no
    gradient."""
    p, plan, dims, cw = steps_problem(3, STEPS, n=64, g=23, pad_edges=5)
    kw = dict(state_norm="stateless", with_corr=False)
    want_h, want_g = jax_steps(p, plan, dims, cw, per_step=True, **kw)
    got_h, got_g = torch_steps(p, dims, cw, **kw)
    np.testing.assert_allclose(got_h, want_h, rtol=FWD_RTOL, atol=FWD_ATOL)
    assert_leaves_close(got_g, want_g, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    pad = p["mask"][:, 0] == 0
    assert pad.any() and not got_h[pad].any() and not got_g["h0"][pad].any()


def test_plain_version_refuses_what_the_kernels_do_not_compute():
    p, plan, dims, _ = steps_problem(4, 2)
    t = lambda x: torch.tensor(np.ascontiguousarray(x))
    fplan = FusedEvalPlan(*map(t, plan_fused_eval(p["dst"], p["node_graph"],
                                                  dims["g"])))
    args = [t(p[k]) for k in LEAVES[:6]] + [
        t(p["mask"]), t(p["node_graph"]),
        {k: t(v) for k, v in p["gru"].items()}, t(p["vid"]), t(p["src"]),
        t(p["dst"]), fplan]
    with pytest.raises(ValueError, match="2 message tables for 3 steps"):
        AS.fused_att_steps(*args, steps=3)
    with pytest.raises(NotImplementedError, match="state_norm='bn1d'"):
        AS.fused_att_steps(*args, steps=2, state_norm="bn1d")


def test_grad_layout_covers_every_leaf_once():
    tm, k, f = 3, 9, 7
    layout = AS.grad_layout(tm, k, f)
    sizes = [tm * k * f * f, tm * f * f, tm * k * f, tm * f, tm * f * f,
             3 * f * f, 3 * f * f, 3 * f, 3 * f]
    off = 0
    for name, size in zip(AS._GRAD_LEAVES, sizes):
        assert layout[name][0] == off, name
        assert int(np.prod(layout[name][1])) == size, name
        off += size
    assert layout["total"][0] == off
    flat = torch.arange(off, dtype=torch.float32)
    parts = AS.split_grads(flat, tm, k, f)
    assert torch.equal(torch.cat([parts[nm].reshape(-1)
                                  for nm in AS._GRAD_LEAVES]), flat)


def _meta_op_call(op, grad):
    """Call an attention op's kernel path on meta tensors (no card: the
    prepare and launch steps are replaced) and return the residual flag
    its forward was prepared with."""
    seen = {}
    m = lambda *s, dt=torch.float32: torch.empty(*s, dtype=dt,
                                                 device="meta")
    i = lambda *s: m(*s, dt=torch.int32)
    n, f, e, g, k = 10, 4, 12, 3, 5
    plan = FusedEvalPlan(i(e), i(n + 1), i(g + 1), i(g + 1))
    gru = {"w_ih": m(f, 3 * f), "w_hh": m(f, 3 * f), "b_ih": m(3 * f),
           "b_hh": m(3 * f)}
    if op == "set2vec":
        w = 2 * f
        rp = {"lstm": {**{f"w_h{c}": m(2 * w, w) for c in "ifgo"},
                       **{f"b_h{c}": m(1, w) for c in "ifgo"}},
              "q_attn": {"w": m(w, w)}, "e_attn": {"w": m(w, 1)}}
        leaves = [*rp["lstm"].values(), rp["q_attn"]["w"],
                  rp["e_attn"]["w"]]

        def prep(*a, stash, **kw):
            seen["flag"] = stash
            return (m(g, 2 * w), m(1), m(1))
        call = lambda: S.set2vec(rp, m(n, w), m(n, 1), i(n), i(g + 1),
                                 time_steps=3)
        mod, name = S, "prepare_set2vec_fwd"
    else:
        tm = 2 if op == "fused_att_steps" else None
        shp = (lambda *s: (tm, *s)) if tm else (lambda *s: s)
        leaves = [m(*shp(k, f, f)), m(*shp(f, f)), m(*shp(k, f)),
                  m(*shp(f)), m(*shp(f, f)), *gru.values()]
        args = (*leaves[:5], m(n, f), m(n, 1), i(n), gru, i(e), i(e), i(e),
                plan)
        if op == "fused_att":
            def prep(*a, write_msgs, **kw):
                seen["flag"] = write_msgs
                return (m(n, f), m(n, f))
            call = lambda: A.fused_att(*args)
            mod, name = A, "prepare_fused_att_fwd"
        else:
            def prep(*a, train, **kw):
                seen["flag"] = train
                return (m(n, f), m(tm, n, f), m(2, n, f), m(2, 2, f))
            call = lambda: AS.fused_att_steps(*args, steps=2)
            mod, name = AS, "prepare_fused_att_steps_fwd"
    for x in leaves:
        x.requires_grad_(grad)
    return mod, name, prep, call, seen


@pytest.mark.parametrize("op", ["fused_att", "set2vec", "fused_att_steps"])
def test_serving_writes_no_training_residuals(op, monkeypatch):
    """A Function's needs_input_grad ignores torch.no_grad, so a forward
    that read it wrote the backward's residuals (the message stash,
    set2vec's 100-step stash) on every serving request, where the
    parameters require grad. The ops decide before launching: residuals
    only when autograd records the op."""
    for grad_mode, requires, want in ((False, True, False),
                                      (True, True, True),
                                      (True, False, False)):
        mod, name, prep, call, seen = _meta_op_call(op, requires)
        monkeypatch.setattr(mod, name, prep)
        monkeypatch.setattr(K, "launch_prepared", lambda p: p)
        with torch.set_grad_enabled(grad_mode):
            call()
        assert seen["flag"] is want, (grad_mode, requires)


# the backward's launch rule (kernels/fused_att_steps.py::launch_shape) on
# an H100's shared memory and co-resident blocks (one a multiprocessor),
# at the att model's widths (narrow bucket, Tm 3, K 8, T 3): with the
# stateless norm one cluster up to the module's CLUSTER_SLOTS node slots
# (the fewest blocks of at most its CLUSTER_NODES slots each), then a grid
# of a block per GRID_NODES slots up to the co-resident blocks; without a
# state norm always the grid
H100 = dict(smem_bytes=232448, max_grid=132)

BWD_RULE_CASES = [
    (13, True, {}, "cluster x1 cap 161"),           # b1
    (16, True, {}, "cluster x1 cap 161"),
    (17, True, {}, "cluster x2 cap 161"),
    (64, True, {}, "cluster x4 cap 161"),           # b4
    (65, True, {}, "cluster x8 cap 161"),
    (128, True, {}, "cluster x8 cap 161"),          # the cluster's capacity
    (129, True, {}, "grid x9 cap 161"),             # one past it
    (256, True, {}, "grid x16 cap 161"),            # b16
    (16512, True, {}, "grid x132 cap 161"),         # b1024: co-resident
    (30, False, {}, "grid x2 cap 161"),
    (16512, False, {}, "grid x132 cap 161"),
    (16512, True, dict(smem_bytes=60 * 1024), "grid x132 cap 16"),
    (16512, True, dict(max_grid=66), "grid x66 cap 161"),   # a smaller card
    (16512, True, dict(route="cluster 8"), "cluster x8 cap 161"),
    (30, True, dict(route="grid"), "grid x2 cap 161"),
    (4000, True, dict(route="grid 5"), "grid x5 cap 161"),
    (4000, True, dict(route="grid 500"), "grid x500 cap 161"),  # refused
    # at launch: past the co-resident blocks
    (16512, True, dict(route="spilled"), "grid x128 cap 16"),
]


@pytest.mark.parametrize("n,sums,kw,tag", BWD_RULE_CASES)
def test_bwd_launch_rule_at_its_boundaries(n, sums, kw, tag, monkeypatch):
    """The route and blocks, the tile (the most node slots, EDGE_RATIO
    edges each, whose shared memory fits the card) and the block's bytes
    that tile's; forced routes (chip_smoke.py::_att_bwd_route, around the
    rule's shape) keep the rule's tile (16 node slots when spilled), and
    a forced grid is taken as asked (the launch refuses one past the
    co-resident blocks)."""
    kw = dict(kw)
    route = kw.pop("route", None)
    args = {**H100, **kw}
    if route is None:
        s = AS.launch_shape(n, "", 3, 8, 3, state_sums=sums, **args)
    else:
        import chip_smoke as CS
        monkeypatch.setattr(
            AS, "device_bwd_shape", lambda n, tag, tm, k, steps, sums_,
            device: AS.launch_shape(n, tag, tm, k, steps, state_sums=sums_,
                                    **args))
        with CS._att_bwd_route(route):
            s = AS.device_bwd_shape(n, "", 3, 8, 3, sums, "cuda")
    assert s.tag() == tag
    assert s.ecap == AS.EDGE_RATIO * s.ncap
    assert s.smem_bytes == 4 * AS.bwd_smem_floats("", 3, 8, 3, s.ncap,
                                                  s.ecap)
    assert s.smem_bytes <= args["smem_bytes"]
    assert s.route == "cluster" or route or s.grid <= args["max_grid"]


def test_bwd_launch_rule_refusals_and_the_wide_bucket():
    """A card where not one node's tile fits raises rather than launching
    something else; the wide bucket at K 64, Tm 8, T 8 now fits a tile
    (its A' tables are read from device memory); an unknown route
    raises (chip_smoke.py::_att_bwd_route)."""
    with pytest.raises(NotImplementedError, match="shared memory"):
        AS.launch_shape(256, "f32", 8, 64, 8, state_sums=True,
                        smem_bytes=150000, max_grid=132)
    wide = AS.launch_shape(256, "f32", 8, 64, 8, state_sums=True, **H100)
    assert wide.tag() == "grid x52 cap 7"
    assert AS.bwd_smem_floats("f32", 8, 64, 8, 1, 3) > AS.bwd_smem_floats(
        "", 8, 64, 8, 1, 3)
    import chip_smoke as CS
    for bad in ("cluster 3", "grid x", "stream", "one"):
        with pytest.raises(ValueError, match="route"):
            with CS._att_bwd_route(bad):
                pass
