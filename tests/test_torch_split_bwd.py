"""The split training backward of the port's whole-step ops (kernels/
split_bwd.py, readout_bwd.py, msg_bwd.py, psteps_walk.py; fused_step and
fused_psteps with bwd="split") against the JAX package on the CPU.

  * The routes: fused_step(..., bwd="split") against make_fused_step_op
    (interpret mode) under MPNN_FS_REC_BWD=stream (its readout VJP
    `_ro_bwd_kernel`, the merged streaming reverse walk and the message
    VJP `_msg_bwd_kernel`; bn1d/bn1d), and fused_psteps(..., bwd="split")
    against make_fused_psteps_op under MPNN_PS_BWD=stream (its
    `_streaming_bwd`) for every norm pair, and once past 128 graphs with
    MPNN_PS_STREAM_BLK=128 (several node and graph blocks).
  * Each plain kernel version alone against jax.vjp of the JAX reference
    function it computes (the readout of models/sparse.py, the message sum
    of kernels/fused_step.py::reference_fused_step, the per-step chain
    from ops/update.py and ops/norm.py), with random values at the padded
    node slots, where the function gives nothing.
  * The route rule against mpnn_tpu's own (_vmem_bwd_fits,
    pick_stream_blk, PS_MONO_BWD_NPAD_CAP) over a grid of shapes; the
    split and whole routes against each other on the CPU.

Tolerances, as tests/test_torch_fused_step.py: forward outputs rtol 2e-4
/ atol 1e-5; every gradient leaf divided by its max abs on both sides at
rtol 2e-4 / atol 1e-5 (float32 on both sides, sums in other orders);
message_bias under the message bn1d, zero in theory, within atol of the
scale of the A0 gradient. On the card the kernels are held against these
plain versions by chip_smoke.py and tests/test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpnn_tpu.kernels import fused_psteps as JP
from mpnn_tpu.kernels import recurrence as JR
from mpnn_tpu.kernels.spmm import spmm_reference
from mpnn_tpu.models.sparse import sparse_graph_level_output
from mpnn_tpu.ops.norm import mask_batch_norm
from mpnn_tpu.ops.update import gru_apply
from mpnn_tpu_torch.kernels import fused_psteps as P
from mpnn_tpu_torch.kernels import fused_step as K
from mpnn_tpu_torch.kernels import msg_bwd as MB
from mpnn_tpu_torch.kernels import psteps_walk as PW
from mpnn_tpu_torch.kernels import readout_bwd as RB
from mpnn_tpu_torch.kernels import recurrence as R
from mpnn_tpu_torch.kernels import split_bwd as S
from test_torch_fused_step import (LEAVES, RTOL, ATOL, _jax_step,
                                   _small_problem, _torch_inputs,
                                   _torch_step)
from test_torch_psteps_kernels import (NORMS, assert_grads_close,
                                       jax_step, psteps_problem, step_grads,
                                       torch_inputs)


def _close(got, want, err=""):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=err)


def _scaled_close(got, want, err=""):
    scale = max(float(np.abs(want).max()), 1e-30)
    _close(np.asarray(got) / scale, np.asarray(want) / scale, err)


# ---------------------------------------------------------------------------
# the route rule
# ---------------------------------------------------------------------------

SHAPES = [(t, f, n) for t in (1, 3, 6, 8) for f in (7, 8, 10, 16, 17, 27, 32)
          for n in (100, 13184, 16512, 28672, 28673, 40000, 47662, 47663,
                    47744, 50000, 57856, 59136, 65536)]


def test_route_rule_is_the_jax_packages():
    """Split exactly where the JAX package splits: the shared family past
    _vmem_bwd_fits at npad = round_up(n, pick_stream_blk(n)) with bn1d
    norms (never with another pair), the per-step family past
    PS_MONO_BWD_NPAD_CAP padded node slots for every pair."""
    split_shared = split_ps = 0
    for t, f, n in SHAPES:
        assert S.pick_stream_blk(n) == JR.pick_stream_blk(n)
        npad = -(-n // JR.pick_stream_blk(n)) * JR.pick_stream_blk(n)
        want = not JR._vmem_bwd_fits(t, f, npad)
        got = S.route("shared", steps=t, f=f, n=n, msg_norm="bn1d",
                      state_norm="bn1d")
        assert got == ("split" if want else "whole"), (t, f, n)
        split_shared += want
        for mn, sn in [("bn1d", "none"), ("none", "bn1d"), ("none", "none")]:
            assert S.route("shared", steps=t, f=f, n=n, msg_norm=mn,
                           state_norm=sn) == "whole"
        want = -(-n // 128) * 128 > JP.PS_MONO_BWD_NPAD_CAP
        for mn, sn in NORMS:
            got = S.route("psteps", steps=t, f=f, n=n, msg_norm=mn,
                          state_norm=sn)
            assert got == ("split" if want else "whole"), (t, f, n, mn, sn)
        split_ps += want
    assert 0 < split_shared < len(SHAPES) and 0 < split_ps < len(SHAPES)
    # lipo (T 6, f 10) at its b3584 slots splits, at b1024's does not
    assert S.shared_splits(6, 10, 57856) and not S.shared_splits(6, 10,
                                                                 16512)
    assert S.psteps_splits(57856) and not S.psteps_splits(16512)


@pytest.mark.parametrize("bwd", ["whole", "split"])
def test_forced_routes_override_the_rule(bwd):
    for n in (128, 65536):
        assert S.route("psteps", steps=3, f=8, n=n, msg_norm="none",
                       state_norm="stateless", bwd=bwd) == bwd
        assert S.route("shared", steps=6, f=10, n=n, msg_norm="bn1d",
                       state_norm="bn1d", bwd=bwd) == bwd


@pytest.mark.parametrize("msg_norm,state_norm",
                         [("bn1d", "none"), ("none", "bn1d"),
                          ("none", "none")])
def test_forced_split_of_a_non_bn1d_shared_config_raises(msg_norm,
                                                         state_norm):
    args, _, dims, _ = _small_problem(4, steps=2)
    targs, _ = _torch_inputs(args, dims)
    with pytest.raises(NotImplementedError, match="bn1d-only"):
        K.fused_step(*targs, steps=2, msg_norm=msg_norm,
                     state_norm=state_norm, bwd="split")
    with pytest.raises(ValueError, match="bwd="):
        K.fused_step(*targs, steps=2, bwd="stream")


# ---------------------------------------------------------------------------
# the split routes against the JAX package's
# ---------------------------------------------------------------------------

def test_shared_split_matches_the_jax_split_route(monkeypatch):
    """lipo's norms: loss, out, every slot's statistics and every gradient
    leaf of fused_step(bwd='split') against the Pallas op's split route
    (readout VJP, merged streaming reverse walk, message VJP)."""
    args, plan, dims, cw = _small_problem(0)
    monkeypatch.setenv("MPNN_FS_REC_BWD", "stream")
    want = _jax_step(args, plan, dims, cw, "bn1d", "bn1d")
    R.reset_launch_counts()
    got = _torch_step(args, dims, cw, "bn1d", "bn1d", bwd="split")
    _close(got[0], want[0])
    _close(got[1], want[1])
    for a, b in zip([got[2], *got[3]], [want[2], *want[3]]):
        _close(a[0], b[0])
        _close(a[1], b[1])
    for name in LEAVES:
        if name == "mbias":
            bound = ATOL * np.abs(want[4]["a0"]).max()
            assert np.abs(got[4][name] - want[4][name]).max() <= bound
            continue
        _scaled_close(got[4][name], want[4][name], name)
    assert R.launch_counts["recurrence_bwd"] == 0      # the plain versions


@pytest.mark.parametrize("msg_norm,state_norm", NORMS)
def test_psteps_split_matches_the_jax_split_route(msg_norm, state_norm,
                                                  monkeypatch):
    """Every norm pair: loss, out, the statistics and every gradient leaf
    of fused_psteps(bwd='split') against the Pallas op's streaming
    backward."""
    args, plan, dims, cw = psteps_problem(1)
    monkeypatch.setenv("MPNN_PS_BWD", "stream")
    want = jax_step(args, plan, dims, cw, msg_norm, state_norm)
    _check_psteps_split(args, dims, cw, msg_norm, state_norm, want)


def test_psteps_split_matches_the_jax_split_route_multiblock(monkeypatch):
    """Past 128 graphs with the JAX package's node block at 128: its
    streaming backward's cross-block sums, against the port's split."""
    args, plan, dims, cw = psteps_problem(2, steps=2, n=640, g=150, f=7,
                                          od=5, k=6)
    assert dims["g"] > 128
    monkeypatch.setenv("MPNN_PS_BWD", "stream")
    monkeypatch.setenv("MPNN_PS_STREAM_BLK", "128")
    want = jax_step(args, plan, dims, cw, "bn1d", "bn1d")
    _check_psteps_split(args, dims, cw, "bn1d", "bn1d", want)


def _check_psteps_split(args, dims, cw, msg_norm, state_norm, want):
    c, leaves = torch_inputs(args, dims, grad=True)
    loss, out, ma, st, grads = step_grads(
        P.fused_psteps, c, leaves, cw, steps=dims["steps"],
        msg_norm=msg_norm, state_norm=state_norm, bwd="split")
    _close(loss.detach().numpy(), want[0])
    _close(out.detach().numpy(), want[1])
    for a, b in zip([*ma, *st], [*want[2], *want[3]]):
        _close(a[0].numpy(), b[0])
        _close(a[1].numpy(), b[1])
    assert_grads_close({k: v.numpy() for k, v in grads.items()}, want[4],
                       msg_norm)


@pytest.mark.parametrize("family", ["shared", "psteps"])
def test_split_and_whole_routes_agree_on_the_cpu(family):
    """The two routes of one op on the same inputs: the same forward, and
    the same gradients (each leaf scaled)."""
    if family == "shared":
        args, _, dims, cw = _small_problem(5)
        whole = _torch_step(args, dims, cw, "bn1d", "bn1d")
        split = _torch_step(args, dims, cw, "bn1d", "bn1d", bwd="split")
        np.testing.assert_array_equal(split[1], whole[1])
        for name in LEAVES:
            if name != "mbias":
                _scaled_close(split[4][name], whole[4][name], name)
        return
    args, _, dims, cw = psteps_problem(6)
    res = {}
    for bwd in ("whole", "split"):
        c, leaves = torch_inputs(args, dims, grad=True)
        res[bwd] = step_grads(P.fused_psteps, c, leaves, cw,
                              steps=dims["steps"], msg_norm="none",
                              state_norm="stateless", bwd=bwd)
    assert torch.equal(res["split"][1], res["whole"][1])
    for name, w in res["whole"][4].items():
        _scaled_close(res["split"][4][name].numpy(), w.numpy(), name)


def test_cpu_split_routes_launch_nothing():
    for mod in (RB, MB, PW, R, K, P):
        mod.reset_launch_counts()
    args, _, dims, cw = psteps_problem(7, steps=2)
    c, leaves = torch_inputs(args, dims, grad=True)
    step_grads(P.fused_psteps, c, leaves, cw, steps=2, bwd="split")
    for mod in (RB, MB, PW, R, K, P):
        assert not any(mod.launch_counts.values()), mod.__name__


# ---------------------------------------------------------------------------
# each plain kernel version against jax.vjp of its JAX reference function
# ---------------------------------------------------------------------------

def _padded_noise(rng, x, mask):
    """x with random values at the padded node slots (the last axis but
    one is the node axis)."""
    x = np.array(x, np.float32)
    pad = mask[:, 0] == 0
    x[..., pad, :] = rng.randn(*x[..., pad, :].shape)
    return x


def _jnorm(x, mask, mode, w=None, b=None):
    """The JAX package's masked norms as its reference_recurrence applies
    them."""
    if mode == "none":
        return x * mask
    if mode == "stateless":
        return mask_batch_norm(x, mask)
    c = mask.sum()
    mean = (x * mask).sum(0) / c
    var = (((x - mean) * mask) ** 2).sum(0) / c
    out = (x - mean) / (jnp.sqrt(jnp.maximum(var, JR.VAR_CLAMP))
                        + JR.BN_EPS)
    return (w * out + b) * mask


@pytest.mark.parametrize("state_norm", ["bn1d", "stateless", "none"])
def test_ro_bwd_reference_matches_jax_vjp(state_norm):
    """gh, dh0 and the readout weights' gradients for the cotangent
    gl·MSE' + gout, against jax.vjp of models/sparse.py::
    sparse_graph_level_output on h_T normalized from its slot."""
    rng = np.random.RandomState(8)
    args, _, dims, _ = psteps_problem(8, f=8, od=6)
    n, f, g, od = dims["n"], dims["f"], dims["g"], dims["od"]
    mask, ng = args["mask"], args["node_graph"]
    x = _padded_noise(rng, rng.randn(n, f) * mask + 0.3, mask)
    h0 = _padded_noise(rng, args["h0"], mask)
    mean, var = (x * mask).sum(0) / mask.sum(), rng.rand(f) + 0.2
    stats = np.stack([mean, var]).astype(np.float32)
    nw, nb = 1 + 0.2 * rng.randn(f), 0.2 * rng.randn(f)
    out = rng.randn(g, od).astype(np.float32)
    gout = rng.randn(g, od).astype(np.float32)
    gl = np.float32(1.3)
    labels, gmask = args["labels"], args["gmask"]
    dout = (gl * 2 * (out - labels[:, None]) * gmask[:, None]
            / gmask.sum() + gout).astype(np.float32)

    def fn(h, h0m, ro):
        return sparse_graph_level_output(
            ro, jnp.concatenate([h, h0m * mask], -1), mask, ng, g)

    xs = jnp.asarray(x)
    if state_norm == "bn1d":
        d = jnp.sqrt(jnp.maximum(stats[1], JR.VAR_CLAMP)) + JR.BN_EPS
        h = (nw * (xs - stats[0]) / d + nb) * mask
    elif state_norm == "stateless":
        h = (xs - stats[0]) * mask / jnp.sqrt(stats[1] + 1e-6)
    else:
        h = xs * mask
    _, vjp = jax.vjp(fn, h.astype(jnp.float32), jnp.asarray(h0),
                     jax.tree.map(jnp.asarray, args["ro"]))
    wh, wh0, wro = vjp(jnp.asarray(dout))
    t = lambda v: torch.tensor(np.asarray(v, np.float32))
    gh, dh0, dro = RB.ro_bwd_reference(
        t(x), t(stats), t(nw), t(nb), t(h0), t(mask), t(ng),
        {s: {k: t(v) for k, v in args["ro"][s].items()} for s in "ij"},
        t(labels), t(gmask), t(out), t(gout), t([gl]),
        state_norm=state_norm)
    _scaled_close(gh.numpy(), np.asarray(wh), "gh")
    _scaled_close(dh0.numpy(), np.asarray(wh0), "dh0")
    for s in "ij":
        for k in "wb":
            _scaled_close(dro[s][k].numpy(), np.asarray(wro[s][k]),
                          f"ro.{s}.{k}")
    assert not gh.numpy()[mask[:, 0] == 0].any()


@pytest.mark.parametrize("steps", [1, 3])
def test_msg_bwd_reference_matches_jax_vjp(steps):
    """dh0, dA, dA0 and the message bias's gradient of T masked message
    sums (the messages of reference_fused_step), for cotangents random at
    the padded node slots too."""
    rng = np.random.RandomState(9)
    args, _, dims, _ = psteps_problem(9, steps=steps)
    n, f, g = dims["n"], dims["f"], dims["g"]
    mask, ng = args["mask"], args["node_graph"]
    vid, src, dst = args["vid"], args["src"], args["dst"]
    h0 = _padded_noise(rng, args["h0"], mask)
    dm = rng.randn(steps, n, f).astype(np.float32)

    def fn(amat, a0, mbias, h):
        s = jax.ops.segment_sum(h, ng, num_segments=g + 1)
        return jnp.stack([
            (spmm_reference(amat[t], h, vid, src, dst) + s[ng] @ a0[t].T
             + mbias[t]) * mask for t in range(steps)])

    _, vjp = jax.vjp(fn, *(jnp.asarray(args[k]) for k in ("amat", "a0",
                                                          "mbias")),
                     jnp.asarray(h0))
    wa, wa0, wb, wh = vjp(jnp.asarray(dm))
    t = lambda v: torch.tensor(np.asarray(v))
    dh0, d = MB.msg_bwd_reference(t(args["amat"]), t(args["a0"]), t(h0),
                                  t(mask), t(ng), t(vid), t(src), t(dst),
                                  t(dm), g)
    _scaled_close(dh0.numpy(), np.asarray(wh), "dh0")
    _scaled_close(d["amat"].numpy(), np.asarray(wa), "amat")
    _scaled_close(d["a0"].numpy(), np.asarray(wa0), "a0")
    _scaled_close(d["mbias"].numpy(), np.asarray(wb), "mbias")


@pytest.mark.parametrize("msg_norm,state_norm", NORMS)
def test_ps_walk_bwd_reference_matches_jax_vjp(msg_norm, state_norm):
    """dh0, the messages' cotangents and the GRU and per-step norm
    gradients of the per-step chain from its stashed messages, against
    jax.vjp of the chain written with the JAX package's GRU and norms."""
    rng = np.random.RandomState(10)
    args, _, dims, _ = psteps_problem(10)
    n, f, T = dims["n"], dims["f"], dims["steps"]
    mask = args["mask"]
    msgs = (rng.randn(T, n, f) * mask).astype(np.float32)
    gh = _padded_noise(rng, rng.randn(n, f), mask)
    ma = [b for b in args["ma_bn"]]
    bn = [b for b in args["bn"]]

    def fn(m, h0, gru, ma_w, ma_b, bn_w, bn_b):
        h = h0 * mask
        for t in range(T):
            mb = (_jnorm(m[t], mask, "bn1d", ma_w[t], ma_b[t])
                  if msg_norm == "bn1d" else m[t])
            h = gru_apply(gru, mb[None], h[None], mask[None])[0]
            h = _jnorm(h, mask, state_norm, bn_w[t], bn_b[t])
        return h

    stack = lambda bs, k: jnp.asarray(np.stack([b[k] for b in bs]))
    jin = (jnp.asarray(msgs), jnp.asarray(args["h0"]),
           jax.tree.map(jnp.asarray, args["gru"]), stack(ma, "weight"),
           stack(ma, "bias"), stack(bn, "weight"), stack(bn, "bias"))
    _, vjp = jax.vjp(fn, *jin)
    wm, wh0, wgru, *wnorms = vjp(jnp.asarray(gh))
    t = lambda v: torch.tensor(np.asarray(v))
    htil = torch.cat([t(msgs), torch.zeros(T, n, f)])
    weights = {**{k: t(v) for k, v in args["gru"].items()},
               "ma_w": t(jin[3]), "ma_b": t(jin[4]), "bn_w": t(jin[5]),
               "bn_b": t(jin[6])}
    dh0, dm, d = PW.ps_walk_bwd_reference(
        t(gh), t(args["h0"]), t(mask), htil, weights, steps=T,
        msg_norm=msg_norm, state_norm=state_norm)
    _scaled_close(dh0.numpy(), np.asarray(wh0), "dh0")
    _scaled_close(dm.numpy(), np.asarray(wm), "dmsgs")
    for k in ("w_ih", "w_hh", "b_ih", "b_hh"):
        _scaled_close(d[k].numpy(), np.asarray(wgru[k]), k)
    for k, w in zip(("ma_w", "ma_b", "bn_w", "bn_b"), wnorms):
        _scaled_close(d[k].numpy(), np.asarray(w), k)


def test_recurrence_vjp_matches_jax_vjp():
    """The shared family's reverse walk, plain (recurrence_vjp_reference,
    what the split route runs on the CPU in csrc/recurrence_bwd.cu's
    place), against jax.vjp of the JAX package's reference_recurrence."""
    rng = np.random.RandomState(11)
    args, _, dims, _ = _small_problem(11, steps=4)
    n, f = dims["n"], dims["f"]
    mask = args["mask"]
    msgs = (rng.randn(n, f) * mask + 0.5).astype(np.float32)
    g = rng.randn(n, f).astype(np.float32)
    fn = lambda m, h0, gru, ma, bn: JR.reference_recurrence(
        m, h0, mask, gru, ma, bn, steps=4)[0]
    jin = (jnp.asarray(msgs), jnp.asarray(args["h0"]),
           *(jax.tree.map(jnp.asarray, args[k]) for k in ("gru", "ma_bn",
                                                          "bn")))
    _, vjp = jax.vjp(fn, *jin)
    wm, wh0, wgru, wma, wbn = vjp(jnp.asarray(g))
    t = lambda v: torch.tensor(np.asarray(v))
    tr = lambda d: {k: t(v) for k, v in d.items()}
    dm, dh0, d = R.recurrence_vjp_reference(
        t(msgs), t(args["h0"]), t(mask), tr(args["gru"]), tr(args["ma_bn"]),
        tr(args["bn"]), t(g), steps=4)
    _scaled_close(dm.numpy(), np.asarray(wm), "dmsgs")
    _scaled_close(dh0.numpy(), np.asarray(wh0), "dh0")
    for k in ("w_ih", "w_hh", "b_ih", "b_hh"):
        _scaled_close(d[k].numpy(), np.asarray(wgru[k]), k)
    for k, w in (("ma_w", wma["weight"]), ("ma_b", wma["bias"]),
                 ("bn_w", wbn["weight"]), ("bn_b", wbn["bias"])):
        _scaled_close(d[k].numpy(), np.asarray(w), k)


def test_grad_layouts_cover_every_leaf_once():
    f, od, T, k = 7, 9, 3, 5
    for layout, split, sizes in [
            (RB.grad_layout(f, od), lambda x: RB.split_grads(x, f, od),
             [2 * f * od, od, 2 * f * od, od]),
            (MB.grad_layout(T, k, f), lambda x: MB.split_grads(x, T, k, f),
             [T * k * f * f, T * f * f, T * f]),
            (PW.grad_layout(f, T), lambda x: PW.split_grads(x, f, T),
             [3 * f * f, 3 * f * f, 3 * f, 3 * f] + [T * f] * 4)]:
        offs = [v[0] for name, v in layout.items() if name != "total"]
        assert offs == list(np.cumsum([0] + sizes[:-1]))
        assert layout["total"][0] == sum(sizes)
        flat = torch.arange(sum(sizes), dtype=torch.float32)
        parts = split(flat)
        leaves = [v for s in parts.values()
                  for v in (s.values() if isinstance(s, dict) else [s])]
        assert torch.equal(torch.cat([p.reshape(-1) for p in leaves]), flat)
