"""The port's per-step whole-step ops (mpnn_tpu_torch.kernels.fused_psteps)
against the JAX package's Pallas per-step kernels run in interpret mode on
the CPU (make_fused_psteps_eval_op, whose kernel is `_ps_eval_kernel`;
make_fused_psteps_op, whose forward is `_ps_fwd_kernel` and whose backward
at this size is the monolithic `_ps_bwd_kernel`). On the CPU the port's
ops are their plain versions, fused_psteps_eval_reference and
fused_psteps_reference under autograd.

Tolerances: forward outputs rtol 2e-4 / atol 1e-5 (the JAX package's own
for its kernel against its reference); every gradient leaf is compared
after dividing both sides by the leaf's max abs, at rtol 2e-4 / atol 1e-5
— float32 on both sides, batch-wide sums in other orders. Under the
message bn1d, each step's message_bias has zero gradient in theory, so it
is held to an absolute bound on the scale of the A0 gradient.

The CUDA kernels are compared with these plain versions on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpnn_tpu.kernels.fused_psteps import (make_fused_psteps_eval_op,
                                           make_fused_psteps_op)
from mpnn_tpu_torch.graphs.batching import plan_fused_eval
from mpnn_tpu_torch.kernels import fused_psteps as P
from mpnn_tpu_torch.kernels import fused_step as K
from test_fused_step import build_problem

RTOL, ATOL = 2e-4, 1e-5
# all six norm pairs of the family: msg {bn1d, none} × state {bn1d,
# stateless, none}
NORMS = [(m, s) for m in ("bn1d", "none")
         for s in ("bn1d", "stateless", "none")]


def psteps_problem(seed, steps=3, n=128, g=12, f=8, od=6, k=5):
    """build_problem's packed batch with per-step weights: T A tables,
    A0 matrices, message biases and norm pairs, eval running stats."""
    rng = np.random.RandomState(seed)
    args, plan, dims = build_problem(rng, n=n, g=g, f=f, od=od, k=k,
                                     steps=steps)
    r = lambda *s, sc=1.0: (rng.randn(*s) * sc).astype(np.float32)
    args["amat"] = r(steps, k, f, f, sc=0.2)
    args["amat"][:, 0] = 0.0                     # vocab id 0: the zero row
    args["a0"] = r(steps, f, f, sc=0.1)
    args["mbias"] = r(steps, f, sc=0.1)

    def bn():
        return {"weight": 1 + r(f, sc=0.2), "bias": r(f, sc=0.2)}

    def bn_state():
        return {"running_mean": r(f, sc=0.3),
                "running_var": (0.3 + rng.rand(f)).astype(np.float32)}
    args["ma_bn"] = [bn() for _ in range(steps)]
    args["bn"] = [bn() for _ in range(steps)]
    args["ma_state"] = [bn_state() for _ in range(steps)]
    args["bn_state"] = [bn_state() for _ in range(steps)]
    args["gmask"][-1] = 0.0                      # one padded graph slot
    cw = r(g, od)
    return args, plan, dims, cw


def _jnp(x):
    return jax.tree.map(jnp.asarray, x)


def jax_eval(args, plan, dims, msg_norm, state_norm):
    op = make_fused_psteps_eval_op(
        dims["steps"], dims["f"], dims["n"], dims["od"], dims["g"],
        dims["k"], block_edges=plan.block_edges, window=plan.window,
        node_window=plan.node_window, interpret=True, msg_norm=msg_norm,
        state_norm=state_norm)
    a = _jnp(args)
    return np.asarray(op(
        a["amat"], a["a0"], a["mbias"], a["h0"], a["mask"], a["node_graph"],
        a["gru"], a["ma_bn"], a["ma_state"], a["bn"], a["bn_state"],
        a["ro"], a["vid"], a["src"], a["dst"], jnp.asarray(plan.win_start),
        jnp.asarray(plan.node_start)))


def jax_step(args, plan, dims, cw, msg_norm, state_norm):
    """(loss, out, ma_stats, bn_stats, {leaf: grad}) of the Pallas op in
    interpret mode, the gradient of 1.3·loss + Σ out·cw."""
    op = make_fused_psteps_op(
        dims["steps"], dims["f"], dims["n"], dims["od"], dims["g"],
        dims["k"], block_edges=plan.block_edges, window=plan.window,
        node_window=plan.node_window, interpret=True, msg_norm=msg_norm,
        state_norm=state_norm)
    a = _jnp(args)
    win, ns = jnp.asarray(plan.win_start), jnp.asarray(plan.node_start)

    def obj(amat, a0, mbias, h0, gru, ma_bn, bn, ro):
        loss, out, ma, st = op(amat, a0, mbias, h0, a["mask"],
                               a["node_graph"], gru, ma_bn, bn, ro,
                               a["labels"], a["gmask"], a["vid"], a["src"],
                               a["dst"], win, ns)
        return 1.3 * loss + jnp.sum(out * cw), (loss, out, ma, st)

    diff = (a["amat"], a["a0"], a["mbias"], a["h0"], a["gru"], a["ma_bn"],
            a["bn"], a["ro"])
    (_, (loss, out, ma, st)), grads = jax.value_and_grad(
        obj, argnums=tuple(range(8)), has_aux=True)(*diff)
    g = jax.tree.map(np.asarray, grads)
    leaves = {"amat": g[0], "a0": g[1], "mbias": g[2], "h0": g[3],
              **{f"gru/{k}": v for k, v in g[4].items()},
              "ma_w": np.stack([b["weight"] for b in g[5]]),
              "ma_b": np.stack([b["bias"] for b in g[5]]),
              "bn_w": np.stack([b["weight"] for b in g[6]]),
              "bn_b": np.stack([b["bias"] for b in g[6]]),
              **{f"ro/{s}/{k}": v for s in ("i", "j")
                 for k, v in g[7][s].items()}}
    return (np.asarray(loss), np.asarray(out),
            [[np.asarray(x) for x in p] for p in ma],
            [[np.asarray(x) for x in p] for p in st], leaves)


def torch_inputs(args, dims, device="cpu", grad=False):
    """The ops' arguments as tensors on `device` (differentiable leaves
    requiring grad with `grad`), and {leaf: tensor} keyed as jax_step."""
    def t(x):
        x = torch.tensor(np.ascontiguousarray(x), device=device)
        return x.requires_grad_() if grad and x.is_floating_point() else x

    def d(x):
        return {k: t(v) for k, v in x.items()}
    gru = d(args["gru"])
    ro = {s: d(args["ro"][s]) for s in ("i", "j")}
    ma = [d(b) for b in args["ma_bn"]]
    bn = [d(b) for b in args["bn"]]
    amat, a0, mbias, h0 = (t(args[k]) for k in ("amat", "a0", "mbias",
                                                "h0"))
    plan = plan_fused_eval(args["dst"], args["node_graph"], dims["g"])
    nograd = lambda x: torch.tensor(np.ascontiguousarray(x), device=device)
    common = dict(
        amat=amat, a0=a0, mbias=mbias, h0=h0, mask=nograd(args["mask"]),
        node_graph=nograd(args["node_graph"]), gru=gru, ma_bns=ma, bns=bn,
        ro=ro, labels=nograd(args["labels"]), gmask=nograd(args["gmask"]),
        vid=nograd(args["vid"]), src=nograd(args["src"]),
        dst=nograd(args["dst"]),
        plan=P.FusedEvalPlan(*(nograd(p) for p in plan)),
        ma_states=[{k: nograd(v) for k, v in s.items()}
                   for s in args["ma_state"]],
        bn_states=[{k: nograd(v) for k, v in s.items()}
                   for s in args["bn_state"]])
    leaves = {"amat": amat, "a0": a0, "mbias": mbias, "h0": h0,
              **{f"gru/{k}": v for k, v in gru.items()},
              "ma_w": ma, "ma_b": ma, "bn_w": bn, "bn_b": bn,
              **{f"ro/{s}/{k}": v for s in ("i", "j")
                 for k, v in ro[s].items()}}
    return common, leaves


def eval_call(fn, c, **kw):
    return fn(c["amat"], c["a0"], c["mbias"], c["h0"], c["mask"],
              c["node_graph"], c["gru"], c["ma_bns"], c["ma_states"],
              c["bns"], c["bn_states"], c["ro"], c["vid"], c["src"],
              c["dst"], c["plan"], **kw)


def step_call(fn, c, **kw):
    return fn(c["amat"], c["a0"], c["mbias"], c["h0"], c["mask"],
              c["node_graph"], c["gru"], c["ma_bns"], c["bns"], c["ro"],
              c["labels"], c["gmask"], c["vid"], c["src"], c["dst"],
              c["plan"], **kw)


def step_grads(fn, c, leaves, cw, **kw):
    """fn's (loss, out, ma_stats, bn_stats) and the gradient of 1.3·loss +
    Σ out·cw in every leaf, the per-step norm leaves stacked (T, f)."""
    loss, out, ma, st = step_call(fn, c, **kw)
    flat, keys = [], []
    for k, v in leaves.items():
        if isinstance(v, list):
            field = "weight" if k.endswith("_w") else "bias"
            flat += [b[field] for b in v]
        else:
            flat.append(v)
        keys.append(k)
    cwt = torch.as_tensor(cw, device=out.device)
    grads = torch.autograd.grad(1.3 * loss + (out * cwt).sum(), flat,
                                allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(flat, grads)]
    out_g, i = {}, 0
    for k, v in leaves.items():
        if isinstance(v, list):
            out_g[k] = torch.stack(grads[i:i + len(v)])
            i += len(v)
        else:
            out_g[k] = grads[i]
            i += 1
    return loss, out, ma, st, out_g


def assert_grads_close(got, want, msg_norm, scale_key="a0"):
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if name == "mbias" and msg_norm == "bn1d":
            bound = ATOL * np.abs(want[scale_key]).max()
            assert np.abs(g - w).max() <= bound, name
            continue
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g / scale, w / scale, rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("msg_norm,state_norm", NORMS)
def test_psteps_eval_matches_pallas_interpret(msg_norm, state_norm):
    """Serving: per-step folded norms from their own running statistics,
    or the stateless norm on the batch's statistics."""
    args, plan, dims, _ = psteps_problem(0)
    want = jax_eval(args, plan, dims, msg_norm, state_norm)
    c, _ = torch_inputs(args, dims)
    got = eval_call(P.fused_psteps_eval, c, steps=dims["steps"],
                    msg_norm=msg_norm, state_norm=state_norm).numpy()
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("msg_norm,state_norm", NORMS)
def test_psteps_step_matches_pallas_interpret(msg_norm, state_norm):
    """Training: loss, out, every slot's batch statistics, and every
    gradient leaf, with the cotangents of both loss and out nonzero."""
    args, plan, dims, cw = psteps_problem(1)
    want = jax_step(args, plan, dims, cw, msg_norm, state_norm)
    c, leaves = torch_inputs(args, dims, grad=True)
    loss, out, ma, st, grads = step_grads(
        P.fused_psteps, c, leaves, cw, steps=dims["steps"],
        msg_norm=msg_norm, state_norm=state_norm)
    np.testing.assert_allclose(loss.detach().numpy(), want[0], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(out.detach().numpy(), want[1], rtol=RTOL,
                               atol=ATOL)
    assert len(ma) == len(st) == dims["steps"]
    for a, b in zip([*ma, *st], [*want[2], *want[3]]):
        np.testing.assert_allclose(a[0].numpy(), b[0], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(a[1].numpy(), b[1], rtol=RTOL, atol=ATOL)
    assert_grads_close({k: v.numpy() for k, v in grads.items()}, want[4],
                       msg_norm)
    if msg_norm == "none":
        assert not grads["ma_w"].any()
    if state_norm != "bn1d":
        assert not grads["bn_w"].any()


def test_cpu_wrappers_take_plain_versions_and_count_no_launch():
    args, _, dims, _ = psteps_problem(2, steps=2)
    c, _ = torch_inputs(args, dims)
    P.reset_launch_counts()
    a = step_call(P.fused_psteps, c, steps=2)
    b = step_call(P.fused_psteps_reference, c, steps=2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    e1 = eval_call(P.fused_psteps_eval, c, steps=2,
                   state_norm="stateless")
    e2 = eval_call(P.fused_psteps_eval_reference, c, steps=2,
                   state_norm="stateless")
    assert torch.equal(e1, e2)
    assert set(P.launch_counts.values()) == {0}


@pytest.mark.parametrize("bad", ["msg_stateless", "unknown"])
def test_unsupported_norm_modes_raise(bad):
    args, _, dims, _ = psteps_problem(3, steps=2)
    c, _ = torch_inputs(args, dims)
    kw = ({"msg_norm": "stateless"} if bad == "msg_stateless"
          else {"state_norm": "batch"})
    with pytest.raises(NotImplementedError, match="per-step kernels"):
        step_call(P.fused_psteps, c, steps=2, **kw)
    with pytest.raises(NotImplementedError, match="per-step kernels"):
        eval_call(P.fused_psteps_eval, c, steps=2, **kw)


def test_grad_layout_covers_every_leaf_once():
    k, f, od, T = 7, 8, 28, 3
    layout = P.grad_layout(k, f, od, T)
    sizes = {"amat": T * k * f * f, "a0": T * f * f, "mbias": T * f,
             "w_ih": 3 * f * f, "w_hh": 3 * f * f, "b_ih": 3 * f,
             "b_hh": 3 * f, "ma_w": T * f, "ma_b": T * f, "bn_w": T * f,
             "bn_b": T * f, "ro_iw": 2 * f * od, "ro_ib": od,
             "ro_jw": 2 * f * od, "ro_jb": od}
    off = 0
    for name in P._GRAD_LEAVES:
        assert layout[name][0] == off, name
        assert int(np.prod(layout[name][1])) == sizes[name], name
        off += sizes[name]
    assert layout["total"][0] == off
    flat = torch.arange(off, dtype=torch.float32)
    parts = P.split_grads(flat, k, f, od, T)
    assert torch.equal(torch.cat([parts[n].reshape(-1)
                                  for n in P._GRAD_LEAVES]), flat)


# ---------------------------------------------------------------------------
# the backward kernel's route rule (kernels/fused_psteps.py::launch_shape),
# decided on the host from shapes alone
# ---------------------------------------------------------------------------

H100_SMEM, H100_GRID = 232448, 132          # opt-in bytes a block; 1 a SM


def _rule(n, tag="", k=8, steps=3, smem=H100_SMEM, max_grid=H100_GRID,
          state_sums=True):
    return P.launch_shape(n, tag, k, steps, state_sums=state_sums,
                          smem_bytes=smem, max_grid=max_grid)


def test_bwd_rule_at_its_node_count_boundaries():
    """With a state norm on batch statistics (its sums cross blocks every
    step), up to CLUSTER_SLOTS node slots one cluster of the fewest
    blocks (1, 2, 4) whose share is at most CLUSTER_NODES, else 8; then
    the grid at GRID_NODES slots a block, capped at the co-resident
    blocks (encoded's widths: K 8, T 3)."""
    cn, cs, gn = P.CLUSTER_NODES, P.CLUSTER_SLOTS, P.GRID_NODES
    assert 8 * cn <= cs
    for c in (1, 2, 4):
        assert _rule(c * cn)[:2] == ("cluster", c)
        assert _rule(c * cn + 1)[:2] == ("cluster", 2 * c)
    assert _rule(8 * cn)[:2] == ("cluster", 8)
    assert _rule(cs)[:2] == ("cluster", 8)
    assert _rule(cs + 1)[:2] == ("grid", -(-(cs + 1) // gn))
    assert _rule(1)[:2] == ("cluster", 1)
    assert _rule(1664)[:2] == ("grid", -(-1664 // gn))      # b128
    assert _rule(28672)[:2] == ("grid", H100_GRID)          # the split's
    assert _rule(10 ** 6, max_grid=1000)[:2] == ("grid", P.MAX_GRID)


@pytest.mark.parametrize("tag", ["", "f32"])
def test_bwd_rule_without_a_state_norm_takes_the_grid(tag):
    """A state norm of 'none' combines nothing per step (the message
    norms' sums cross blocks once, after the walk): the grid route at
    every size, a block per GRID_NODES slots (one block alone up to
    GRID_NODES), capped at the co-resident blocks; the tile is the one
    the state-norm rule gives."""
    gn = P.GRID_NODES
    for n in (1, gn, gn + 1, 256, P.CLUSTER_SLOTS, 13184, 10 ** 6):
        s = _rule(n, tag, state_sums=False)
        assert s.route == "grid", (n, s.tag())
        assert s.grid == min(H100_GRID, -(-n // gn)), (n, s.tag())
        assert s[2:] == _rule(n, tag)[2:]


@pytest.mark.parametrize("tag,steps,least", [("", 3, 200), ("", 8, 120),
                                             ("f32", 3, 64),
                                             ("f32", 6, 48)])
def test_bwd_rule_keeps_a_block_within_its_tile(tag, steps, least):
    """A block's tile holds (4 + T)·FP floats a node, two steps' staged
    rows and EDGE_RATIO edges a node: at least `least` node slots on an
    H100 (a whole b16 of encoded fits the narrow build's); a block's share
    stays within 3/4 of its tile on both routes, so a block past it holds
    a graph larger than the share (which the kernel keeps in global
    scratch); the bytes are the tile's, and one more node does not fit."""
    cap = P.bwd_capacity(tag, 8, steps, H100_SMEM)
    assert cap >= least
    for n in (16, 256, 512, 600, 1664, 4096, 13184, 28672):
        for sums in (True, False):
            s = _rule(n, tag, steps=steps, state_sums=sums)
            assert s.ncap == cap and s.ecap == P.EDGE_RATIO * cap
            assert s.smem_bytes == 4 * P.bwd_smem_floats(
                tag, 8, steps, cap, s.ecap) <= H100_SMEM
            if s.grid < H100_GRID:
                assert -(-n // s.grid) <= 3 * cap // 4, (n, s.tag())
    assert 4 * P.bwd_smem_floats(tag, 8, steps, cap + 1,
                                 P.EDGE_RATIO * (cap + 1)) > H100_SMEM


@pytest.mark.parametrize("max_grid", [132, 114, 78])
def test_bwd_rule_on_vocab_steps_and_a_smaller_card(max_grid):
    """The tile shrinks with the vocab (its counters), with T and with a
    card's shared memory; the route follows the tile; a card with fewer
    SMs caps the grid; a card that cannot hold one node raises."""
    caps = [P.bwd_capacity("", k, t, H100_SMEM)
            for k, t in ((8, 3), (64, 3), (8, 8), (64, 8))]
    assert caps[0] > caps[1] > caps[3] and caps[0] > caps[2] > caps[3]
    for n in (600, 13184, 28672):
        s = _rule(n, max_grid=max_grid)
        assert s.grid == min(max_grid, -(-n // P.GRID_NODES)), s.tag()
    small = _rule(512, smem=100 * 1024, max_grid=max_grid)
    assert small.ncap < _rule(512).ncap
    assert small.route == "grid" or -(-512 // small.grid) <= \
        3 * small.ncap // 4
    with pytest.raises(NotImplementedError, match="shared memory"):
        _rule(16, smem=16 * 1024)


# ---------------------------------------------------------------------------
# the training forward's route rule (kernels/fused_psteps.py::
# fwd_launch_shape: the shared family's forward policy on this kernel's
# tiles), decided on the host from shapes alone
# ---------------------------------------------------------------------------

def _fwd_rule(n, tag="", k=8, steps=3, smem=H100_SMEM, max_grid=H100_GRID,
              sums=True):
    return P.fwd_launch_shape(n, tag, k, steps, sums=sums, smem_bytes=smem,
                              max_grid=max_grid)


def test_fwd_rule_at_its_node_count_boundaries():
    """With a norm on batch statistics (the T message norms' one combine,
    or a state norm's every step) up to FWD_CLUSTER_SLOTS node slots one
    cluster of the fewest blocks (1, 2, 4) whose share is at most
    FWD_CLUSTER_NODES, else 8; past them the grid at a block per
    FWD_STAT_NODES slots up to max(FWD_STAT_BLOCKS, ⌈√n⌉) blocks; without
    one a block per FWD_GRID_NODES slots; all capped at the co-resident
    blocks (encoded's widths: K 8, T 3)."""
    cn, cs = K.FWD_CLUSTER_NODES, K.FWD_CLUSTER_SLOTS
    sn, sb, gn = K.FWD_STAT_NODES, K.FWD_STAT_BLOCKS, K.FWD_GRID_NODES
    for c in (1, 2, 4):
        assert _fwd_rule(c * cn)[:2] == ("cluster", c)
        assert _fwd_rule(c * cn + 1)[:2] == ("cluster", 2 * c)
    assert _fwd_rule(1)[:2] == ("cluster", 1)
    assert _fwd_rule(cs)[:2] == ("cluster", 8)
    assert _fwd_rule(cs + 1)[:2] == ("grid", -(-(cs + 1) // sn))
    assert _fwd_rule(1664)[:2] == ("grid", sb)               # b128
    assert _fwd_rule(16512)[:2] == ("grid", 129)             # b1024
    assert _fwd_rule(28672)[:2] == ("grid", H100_GRID)       # the split's
    for n in (1, gn, gn + 1, 256, 1664, 16512):
        assert _fwd_rule(n, sums=False)[:2] == (
            "grid", min(H100_GRID, -(-n // gn)))
    # every route's tile is the launch's own: its rows for its blocks
    for n in (16, 300, 600, 16512, 10 ** 5):
        s = _fwd_rule(n)
        assert s.ncap == P.fwd_capacity("", 8, 3, H100_SMEM, s.grid)
        assert s.ecap == P.EDGE_RATIO * s.ncap
        assert s.smem_bytes == 4 * P.fwd_smem_floats(
            "", 8, 3, s.ncap, s.ecap, s.grid) <= H100_SMEM


@pytest.mark.parametrize("tag,steps,k,least", [
    ("", 1, 8, 800), ("", 3, 8, 450), ("", 6, 8, 240), ("", 8, 8, 160),
    ("", 3, 64, 500), ("f32", 1, 8, 220), ("f32", 3, 8, 200),
    ("f32", 6, 8, 110)])
def test_fwd_rule_tile_for_steps_one_to_eight(tag, steps, k, least):
    """A node's tile row holds h0, the state and the T messages
    (max((2 + T)·FP, od) floats) and EDGE_RATIO edges: at least `least`
    node slots on an H100; the message tables sit in shared memory while
    T·K·FP² fit AMAT_SMEM_FLOATS (encoded's K 8, T 3: 24 KB) and are read
    from device memory past it (K 64); a block's share stays within 3/4
    of its tile, so a block past it holds a graph larger than the share
    (which the kernel keeps in global scratch); one more node does not
    fit."""
    fp = dict(P.BUCKETS)[tag]["f"]
    assert P.amat_in_smem(tag, k, steps) == (
        steps * k * fp * fp <= P.AMAT_SMEM_FLOATS)
    for n in (16, 256, 600, 1664, 16512, 28672):
        for sums in (True, False):
            s = _fwd_rule(n, tag, k=k, steps=steps, sums=sums)
            cap = P.fwd_capacity(tag, k, steps, H100_SMEM, s.grid)
            assert s.ncap == cap >= least, (n, s.tag())
            if s.grid < H100_GRID:
                assert -(-n // s.grid) <= 3 * cap // 4, (n, s.tag())
            assert 4 * P.fwd_smem_floats(tag, k, steps, cap + 1,
                                         P.EDGE_RATIO * (cap + 1),
                                         s.grid) > H100_SMEM


def test_fwd_rule_without_any_norm_on_statistics():
    """none/none (and a pair whose only norm is 'none') combines nothing:
    a grid of a block per FWD_GRID_NODES slots at every size, one block
    alone up to FWD_GRID_NODES; the rule never takes a cluster then."""
    gn = K.FWD_GRID_NODES
    for n in (1, gn, gn + 1, 100, 512, 13184):
        s = _fwd_rule(n, sums=False)
        assert s.route == "grid" and s.grid == min(H100_GRID, -(-n // gn))


@pytest.mark.parametrize("max_grid", [132, 114, 78])
def test_fwd_rule_on_vocab_steps_and_a_smaller_card(max_grid):
    """The tile shrinks with the staged tables (K, T) and a card's shared
    memory; a card with fewer SMs caps the grid; a card that cannot hold
    one node raises."""
    caps = [P.fwd_capacity("", k, t, H100_SMEM, 132)
            for k, t in ((8, 3), (16, 3), (8, 6))]
    assert caps[0] > caps[1] and caps[0] > caps[2]
    for n in (2000, 16512, 28672):
        s = _fwd_rule(n, max_grid=max_grid, sums=False)
        assert s.grid == min(max_grid, -(-n // K.FWD_GRID_NODES)), s.tag()
    small = _fwd_rule(512, smem=100 * 1024, max_grid=max_grid)
    assert small.ncap < _fwd_rule(512).ncap
    with pytest.raises(NotImplementedError, match="shared memory"):
        _fwd_rule(16, smem=8 * 1024)
