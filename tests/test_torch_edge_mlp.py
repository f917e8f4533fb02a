"""The port's edge-MLP chain op (mpnn_tpu_torch.kernels.edge_mlp) against
the JAX package on the CPU: the op against the Pallas kernels
edge_mlp_forward / edge_mlp_backward in interpret mode (their kernels are
`_fwd_kernel` and `_bwd_kernel`), at pf 16, 36, 49, 64 and 256, the ×50
tail and none, 1 and 2 head layers and ragged row counts; the flagship's
training step through the `edge_mlp_fn` hook for three Adam steps in
lockstep with the JAX package's fused_flagship_loss(..., edge_mlp_fn=...);
and the att model's per-step A'-form build through the hook against the
JAX package's _build_att_form_steps, forward and gradients. On the CPU the
port's op is its plain version (under autograd); the CUDA kernels are
compared with it on the card by tests/test_torch_gpu.py and chip_smoke.py.

Tolerances, as tests/test_torch_att_steps_kernels.py states them: forward
rtol 2e-4 / atol 1e-5; every gradient leaf divided by its max abs, rtol
5e-4 / atol 3e-5 (float32 through a 51-layer chain, products summed in
other orders). The chain's forward is divided by its max abs too: its
scale after 50 relu layers depends on the weights. The lockstep: losses rtol 1e-4, parameters after the steps
rtol 1e-4 / atol 1e-4 (1% of an Adam step at lr 1e-2), message_bias left
out (its gradient is zero in theory under the message bn1d).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from mpnn_tpu import graphs as JG
from mpnn_tpu.kernels.edge_mlp import (edge_mlp_backward, edge_mlp_forward,
                                       make_edge_mlp_op as jax_make_op)
from mpnn_tpu.train.checkpoint import tree_to_arrays
from mpnn_tpu_torch import graphs as TG
from mpnn_tpu_torch.kernels import edge_mlp as M
from mpnn_tpu_torch.train import trainer as ttrainer
from mpnn_tpu_torch.train.checkpoint import (module_to_jax_arrays,
                                             params_from_jax_arrays)
from test_torch_gpu import mlp_chain
from test_torch_train import SMILES, _arrays

FWD_RTOL, FWD_ATOL = 2e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 3e-5
TAIL = 50

# (rows, head dims, tail): pf 16 (encoded: ef 2, two head layers), 36
# (bench's bfm 6), 49 (bfm 7, a full vocab of 64 + the zero row), 64 (the
# reference's bfm 8), 256 (bfm 4 at f 19, two head layers), no tail, the
# zero row alone, and 130 rows (five of the JAX kernels' blocks of 32; on
# the card, several blocks or clusters)
CASES = [(9, [(2, 4), (4, 16)], TAIL), (14, [(6, 36)], TAIL),
         (65, [(7, 49)], TAIL), (23, [(8, 64)], TAIL),
         (11, [(4, 16), (16, 256)], 3), (9, [(6, 36)], 0),
         (1, [(6, 36)], TAIL), (130, [(7, 49)], 3)]


def _scaled_close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL, err_msg=what)


@pytest.mark.parametrize("rows,head,tail", CASES)
def test_op_matches_pallas_kernels(rows, head, tail):
    """Forward against edge_mlp_forward and every gradient (the rows, each
    head weight and bias, W_s) against edge_mlp_backward, both Pallas
    kernels in interpret mode, blocks of 32 rows (so the row counts are
    ragged)."""
    rng = np.random.RandomState(rows + tail + len(head))
    x, ws, bs, sw = mlp_chain(rng, rows, head, tail)
    g = rng.randn(rows, sw.shape[0]).astype(np.float32)
    jpen = edge_mlp_forward(jnp.asarray(x), tuple(map(jnp.asarray, ws)),
                            tuple(map(jnp.asarray, bs)), jnp.asarray(sw),
                            tail=tail, block=32, interpret=True)
    jdx, jdws, jdbs, jdsw = edge_mlp_backward(
        jnp.asarray(x), jnp.asarray(g), tuple(map(jnp.asarray, ws)),
        tuple(map(jnp.asarray, bs)), jnp.asarray(sw), tail=tail, block=32,
        interpret=True)
    leaves = [torch.tensor(a, requires_grad=True) for a in [x, *ws, *bs, sw]]
    h = len(head)
    M.reset_launch_counts()
    pen = M.make_edge_mlp_op(tail)(leaves[0], leaves[1:1 + h],
                                   leaves[1 + h:1 + 2 * h], leaves[-1])
    assert sum(M.launch_counts.values()) == 0       # plain version on CPU
    scale = float(np.abs(np.asarray(jpen)).max())
    assert scale > 0 and (np.asarray(jpen) > 0).mean() > 0.2
    np.testing.assert_allclose(pen.detach().numpy() / scale,
                               np.asarray(jpen) / scale, rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    grads = torch.autograd.grad((pen * torch.tensor(g)).sum(), leaves,
                                allow_unused=True)
    grads = [np.zeros_like(a) if gr is None else gr.numpy()
             for a, gr in zip([x, *ws, *bs, sw], grads)]
    want = [jdx, *jdws, *jdbs, jdsw]
    names = (["x"] + [f"w{i}" for i in range(h)] + [f"b{i}" for i in range(h)]
             + ["ws"])
    for name, gr, w in zip(names, grads, want):
        _scaled_close(gr, np.asarray(w).reshape(gr.shape), name)


# an H100: 227 KB of shared memory a block, 132 SMs
H100 = dict(smem_bytes=232448, sms=132)

# (direction, rows, dims, the rule's launch on an H100): the register
# route — a thread a column, REG_ROWS rows a block (the forward 2, the
# backward 4): one block up to that, then balanced blocks (9 rows: 5 of 2
# forward, 3 of 3 backward); rows / sms past 528 rows;
# the cap of 15 rows (a named barrier each; pf 16), the threads' cap (pf
# 64: 8 rows of 64 threads) and the backward's shared-memory cap (pf 64:
# 7 rows of 52 layers' outputs and gz) — and the
# panel route's cluster: the fewest blocks whose W_s panels fit (pf 81,
# 144, 256)
RULE_CASES = [
    ("fwd", 1, [6, 36], "reg C1 rb1 x1"),
    ("bwd", 1, [6, 36], "reg C1 rb1 x1"),
    ("fwd", 4, [6, 36], "reg C1 rb2 x2"),
    ("bwd", 5, [6, 36], "reg C1 rb3 x2"),
    ("fwd", 9, [6, 36], "reg C1 rb2 x5"),
    ("bwd", 9, [6, 36], "reg C1 rb3 x3"),
    ("fwd", 9, [2, 4, 16], "reg C1 rb2 x5"),
    ("bwd", 65, [7, 49], "reg C1 rb4 x17"),
    ("fwd", 65, [8, 64], "reg C1 rb2 x33"),
    ("bwd", 65, [8, 64], "reg C1 rb4 x17"),
    ("fwd", 528, [6, 36], "reg C1 rb4 x132"),
    ("fwd", 529, [6, 36], "reg C1 rb5 x106"),
    ("bwd", 2000, [2, 4, 16], "reg C1 rb15 x134"),
    ("fwd", 10000, [8, 64], "reg C1 rb8 x1250"),
    ("bwd", 10000, [8, 64], "reg C1 rb7 x1429"),
    ("fwd", 65, [3, 9, 81], "panel C1 rb4 x17"),
    ("bwd", 65, [12, 144], "panel C2 rb4 x17"),
    ("fwd", 65, [4, 16, 256], "panel C2 rb4 x17"),
    ("bwd", 65, [4, 16, 256], "panel C4 rb4 x17"),
    ("bwd", 1, [4, 16, 256], "panel C4 rb1 x1"),
    ("bwd", 200, [4, 16, 256], "panel C4 rb4 x50"),
    # past what a cluster of 8 holds: the l2 route (bond widths 22-31 at
    # f > ef give pf 484-961; 5 → 25 → 625 at f 26-32)
    ("fwd", 9, [22, 484], "panel C8 rb3 x3"),
    ("bwd", 9, [22, 484], "l2 C8 rb3 x3"),
    ("fwd", 1, [25, 625], "l2 C8 rb1 x1"),
    ("bwd", 9, [5, 25, 625], "l2 C8 rb3 x3"),
    ("fwd", 200, [5, 25, 625], "l2 C8 rb13 x16"),
    ("bwd", 65, [31, 961], "l2 C8 rb4 x17"),
]


@pytest.mark.parametrize("direction,rows,dims,tag", RULE_CASES)
def test_launch_rule_at_its_boundaries(direction, rows, dims, tag):
    """kernels/edge_mlp.py::launch_shape on an H100 at the zoo's widths:
    the route, the cluster and the rows a block hold, every row covered
    once, each block's shared memory within the card's, the register
    route's threads within its register budget, every cluster rank owning
    W_s columns, the l2 route only where no cluster of 8 holds W_s's
    panels (and the backward's stash)."""
    s = M.launch_shape(direction, rows, dims, TAIL, **H100)
    assert s.tag() == tag
    pf = dims[-1]
    assert s.rb * s.clusters >= rows > s.rb * (s.clusters - 1)
    assert s.smem_bytes == 4 * M.smem_floats(direction, dims, TAIL, s.kp,
                                             s.cluster, s.rb,
                                             s.route == "l2")
    assert s.smem_bytes <= H100["smem_bytes"]
    if s.route == "reg":
        assert pf <= M.REG_MAX_PF and s.kp == M.reg_kp(pf) and s.kp >= pf
        assert s.threads == M.reg_lanes(s.kp) * s.rb
        assert s.threads <= M.reg_max_threads(s.kp) and s.rb <= 15
    else:
        assert pf > M.REG_MAX_PF and s.kp == 0
        assert s.threads == M.PANEL_THREADS
        panel = -(-pf // s.cluster + 3) // 4 * 4
        assert (s.cluster - 1) * panel < pf
        # the next smaller cluster (on the l2 route, a cluster of 8) does
        # not hold W_s's panel and RT rows
        if s.cluster > 1:
            smaller = s.cluster if s.route == "l2" else s.cluster // 2
            assert M.smem_floats(direction, dims, TAIL, 0, smaller,
                                 M.RT) * 4 > H100["smem_bytes"]


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_launch_rule_grows_blocks_with_rows(direction):
    """More rows never lower the rows a block holds, never pass a block's
    budget, and leave no block empty, at every zoo width; the backward
    holds no more rows a block than the forward."""
    for dims in ([2, 4, 16], [6, 36], [7, 49], [8, 64], [3, 9, 81],
                 [12, 144], [4, 16, 256], [5, 25, 625], [31, 961]):
        last = 0
        for rows in (1, 2, 5, 9, 33, 65, 130, 200, 1000, 5000):
            s = M.launch_shape(direction, rows, dims, TAIL, **H100)
            assert s.rb >= min(last, rows) and s.rb <= rows
            assert -(-rows // s.rb) == s.clusters
            assert s.smem_bytes <= H100["smem_bytes"]
            if direction == "bwd":
                f = M.launch_shape("fwd", rows, dims, TAIL, **H100)
                assert s.rb <= max(f.rb, M.RT)
            last = s.rb


def test_launch_rule_on_a_smaller_card():
    """With less shared memory the backward's rows a block fall, W_s at pf
    256 needs a larger cluster, a card where no cluster of 8 holds W_s
    takes the l2 route, and one where not even that route's rows and head
    fit raises rather than launching something else."""
    assert M.launch_shape("bwd", 9, [6, 36], TAIL, smem_bytes=100 * 1024,
                          sms=132).rb < 9
    small = dict(smem_bytes=150 * 1024, sms=132)
    assert M.launch_shape("fwd", 65, [4, 16, 256], TAIL,
                          **small).cluster == 4
    assert M.launch_shape("bwd", 65, [4, 16, 256], TAIL,
                          **small).cluster == 8
    assert M.launch_shape("bwd", 65, [4, 16, 256], TAIL,
                          smem_bytes=48 * 1024, sms=132).tag() == \
        "l2 C8 rb4 x17"
    with pytest.raises(NotImplementedError, match="head weights"):
        M.launch_shape("bwd", 65, [4, 16, 256], TAIL, smem_bytes=16 * 1024,
                       sms=132)
    # one row of the register route that no block holds
    with pytest.raises(NotImplementedError, match="one row at pf 64"):
        M.launch_shape("bwd", 9, [8, 64], TAIL, smem_bytes=16 * 1024,
                       sms=132)


def test_grad_layout_is_the_jax_tuple_order():
    """The backward kernel's flat gradient: head weights, head biases,
    W_s — make_edge_mlp_op's (dws, dbs, dshared) in order."""
    layout = M.grad_layout([4, 16, 256])
    assert list(layout) == ["w0", "w1", "b0", "b1", "ws", "total"]
    assert layout["w1"] == (64, (16, 256))
    assert layout["b0"] == (64 + 4096, (16,))
    assert layout["total"][0] == 64 + 4096 + 16 + 256 + 256 * 256


def _bare_mpnn(tail):
    """A bare MPNN at bench.py's flagship widths, 2 message steps, the ×50
    tail: (JAX cfg, params, state, port MPNN, JAX batch, port batch)."""
    from mpnn_tpu.models.mpnn import mpnn_init
    from mpnn_tpu_torch.models.config import MPNNConfig
    smiles = SMILES[:12]
    labels = [0.3 * np.cos(i) for i in range(len(smiles))]
    jg, ge = JG.encode_molgraphs(JG.generate_molgraphs(smiles, labels))
    tg, _ = TG.encode_molgraphs(TG.generate_molgraphs(smiles, labels))
    jcfg = dataclasses.replace(bench.flagship_mpnn_cfg(ge), message_steps=2,
                               edge_mlp_tail_repeats=tail)
    tcfg = MPNNConfig(**{f.name: getattr(jcfg, f.name)
                         for f in jcfg.__dataclass_fields__.values()})
    params, state = mpnn_init(jax.random.PRNGKey(5), jcfg)
    net = params_from_jax_arrays(_arrays(params, state), tcfg, "cpu")
    b = next(iter(JG.GraphLoader(jg, 12, collate="packed", use_native=False,
                                 fused_step_plan=True)))
    b["node_feats"] = np.concatenate([b["node_feats"], b["node_nafm"]], -1)
    jb = {k: (jnp.asarray(v) if not np.isscalar(v) else v)
          for k, v in b.items() if k != "num_graphs"}
    tb = ttrainer.batch_to_device(next(iter(TG.GraphLoader(tg, 12))), "cpu")
    tb["node_feats"] = torch.cat([tb["node_feats"], tb["node_nafm"]], -1)
    return jcfg, params, state, net, jb, tb


def test_hook_lockstep_three_adam_steps():
    """Three Adam steps (lr 1e-2) of the flagship's training step with the
    masked MSE inside the training op: the JAX package's
    fused_flagship_loss with edge_mlp_fn = its Pallas chain op (interpret
    mode) against the port's fused_flagship_loss, whose A-form build takes
    the chain through kernels/edge_mlp.py's op (its plain version here):
    each step's loss, and every parameter after the third."""
    import optax
    from mpnn_tpu.models.fused_train import (fused_flagship_loss as jax_loss,
                                             make_fused_step_for_batch)
    from mpnn_tpu.train import optim as jopt
    from mpnn_tpu_torch.models.fused_train import fused_flagship_loss
    from mpnn_tpu_torch.train import optim as topt
    jcfg, params, state, net, jb, tb = _bare_mpnn(TAIL)
    op = make_fused_step_for_batch(jcfg, jb, interpret=True)
    hook = jax_make_op(TAIL, block=32, bwd_block=32, interpret=True)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p: jax_loss(p, state, jcfg, jb, jb["labels"], op,
                           edge_mlp_fn=hook)[0]))
    jo = jopt.adam(1e-2)
    jp = jax.tree.map(jnp.asarray, params)
    js = jo.init(jp)
    to = topt.adam(list(net.parameters()), 1e-2)
    M.reset_launch_counts()
    for step in range(3):
        jl, jg = grad_fn(jp)
        upd, js = jo.update(jg, js, jp)
        jp = optax.apply_updates(jp, upd)
        to.zero_grad()
        loss, _, _ = fused_flagship_loss(net, tb, tb["labels"])
        loss.backward()
        to.step()
        np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-4,
                                   err_msg=f"step {step}")
    assert sum(M.launch_counts.values()) == 0       # plain version on CPU
    got = module_to_jax_arrays(net)
    want = {f"params/{k}": np.asarray(v)
            for k, v in tree_to_arrays(jp).items()}
    mb = "params/message/0/message_bias"
    assert mb in want
    for k, w in want.items():
        if k != mb:
            np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-4,
                                       err_msg=k)


def test_att_steps_form_through_hook_matches_jax():
    """The att model's per-step A'-form (three message networks, each
    chain through the hook) against the JAX package's
    _build_att_form_steps with its Pallas chain op (interpret mode): the
    five stacked operands, and the gradient of a random linear function of
    them in every message-network leaf."""
    from mpnn_tpu.models.fused_train import _build_att_form_steps as jax_form
    from mpnn_tpu_torch.models.fused_train import _build_att_form_steps
    from test_torch_att_steps_model import setup
    from test_torch_psteps_model import jax_batch
    jg, tg, jcfg, tcfg, params, state, net = setup()
    jcfg = dataclasses.replace(jcfg, mpnn=dataclasses.replace(
        jcfg.mpnn, edge_mlp_tail_repeats=TAIL))
    net.mpnn.cfg = dataclasses.replace(net.mpnn.cfg,
                                       edge_mlp_tail_repeats=TAIL)
    jb = jax_batch(jg, 16)
    tb = ttrainer.batch_to_device(next(iter(TG.GraphLoader(tg, 16))), "cpu")
    hook = jax_make_op(TAIL, block=32, bwd_block=32, interpret=True)
    jforms = jax_form(jax.tree.map(jnp.asarray, params["mpnn"]), jcfg.mpnn,
                      jb, edge_mlp_fn=hook)
    rng = np.random.RandomState(7)
    cs = [rng.randn(*np.shape(x)).astype(np.float32) for x in jforms]
    jgrads = jax.grad(lambda p: sum(
        (x * c).sum() for x, c in zip(jax_form(p, jcfg.mpnn, jb,
                                                edge_mlp_fn=hook), cs)))(
        jax.tree.map(jnp.asarray, params["mpnn"]))
    forms = _build_att_form_steps(net.mpnn, tb,
                                  M.make_edge_mlp_op(TAIL))
    for name, x, jx in zip(("aprime", "a0", "qv", "q0", "wh"), forms,
                           jforms):
        np.testing.assert_allclose(x.detach().numpy(), np.asarray(jx),
                                   rtol=FWD_RTOL, atol=FWD_ATOL,
                                   err_msg=name)
    sum((x * torch.tensor(c)).sum() for x, c in zip(forms, cs)).backward()
    got = {k: (t.grad.t() if tr else t.grad).numpy()
           for k, (t, tr) in _key_map(net).items()
           if k.startswith("params/mpnn/message/") and t.grad is not None}
    want = {f"params/mpnn/{k}": np.asarray(v)
            for k, v in tree_to_arrays(jgrads).items()
            if k.startswith("message/")}
    assert set(got) <= set(want) and len(got) > 0
    for k, w in want.items():
        if k in got:
            _scaled_close(got[k], w, k)
        else:                         # a leaf the forms do not read
            assert not w.any(), k


def _key_map(net):
    from mpnn_tpu_torch.train.checkpoint import jax_key_map
    return jax_key_map(net)
