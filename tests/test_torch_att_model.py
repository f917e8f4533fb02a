"""The attention model `adv` (zoo adv, test_adv.py) on the CPU against the
JAX package, the weights transplanted from the JAX init with the leaves
the forward never reads (message_bias, agg/att) perturbed: eval outputs
of both port paths — the MPNN core through the port's attention ops
(fused_att and set2vec, their plain versions here) and through its plain
sparse model — against the JAX network on the same batches, for both
aggregations and both set2vec softmax modes; the weight transplant round
trip; and adv checkpoints written by one package and served by the
other's `predict`. The JAX side runs its plain XLA network at the
reference's 100 set2vec steps, and its Pallas ops in interpret mode at a
cut depth. The edge-MLP tail is cut to ×2.

Tolerances: forward values rtol 1e-4 / atol 1e-5 (float32, sums in other
orders). The batch-global softmax couples every molecule of a batch, so
every comparison runs on the same batches in both packages.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import bench
from mpnn_tpu import graphs as JG
from mpnn_tpu.models import zoo as jzoo
from mpnn_tpu.models.fused_train import (fused_eval_eligible,
                                         make_fused_eval_for_batch)
from mpnn_tpu.models.network import network_apply_packed as jax_apply
from mpnn_tpu.models.network import network_init as jax_init
from mpnn_tpu.train import cli as jcli
from mpnn_tpu.train.checkpoint import save_checkpoint as jax_save
from mpnn_tpu_torch import graphs as TG
from mpnn_tpu_torch.kernels import fused_att as A
from mpnn_tpu_torch.kernels import set2vec as S
from mpnn_tpu_torch.models import zoo as tzoo
from mpnn_tpu_torch.models.network import network_apply_packed, network_init
from mpnn_tpu_torch.train import cli as tcli
from mpnn_tpu_torch.train import trainer as ttrainer
from mpnn_tpu_torch.train.checkpoint import (module_to_jax_arrays,
                                             params_from_jax_arrays,
                                             save_checkpoint)
from test_torch_psteps_model import _csv, _predict, arrays_of, jax_batch

RTOL, ATOL = 1e-4, 1e-5
SMILES = bench.SMILES + ["C", "O", "CCO", "CCN", "c1ccccc1", "CC(=O)O"]
# (aggregation, batch-global softmax): adv's own, and the variants the
# kernels take
VARIANTS = [("att", True), ("adj", True), ("att", False)]


def cut(cfg, aggregation="att", batch_softmax=True, **kw):
    """adv at its widths and depth, the ×50 tail cut to ×2."""
    return dataclasses.replace(cfg, mpnn=dataclasses.replace(
        cfg.mpnn, edge_mlp_tail_repeats=2, aggregation=aggregation,
        set2vec_batch_softmax=batch_softmax, **kw))


def perturb(params, rng):
    """Random message_bias and agg/att leaves (the JAX init leaves the
    bias at zero): the forward must not read them."""
    params = jax.tree.map(np.array, params)
    m = params["mpnn"]
    for mp in m["message"]:
        mp["message_bias"] = (0.3 * rng.randn(
            *mp["message_bias"].shape)).astype(np.float32)
    if "agg" in m:
        m["agg"]["att"] = {k: (rng.randn(*v.shape)).astype(np.float32)
                           for k, v in m["agg"]["att"].items()}
    return params


def setup(smiles=SMILES[:16], seed=0, n_out=4, **kw):
    """(JAX graphs, port graphs, JAX cfg, port cfg, params, state, port
    net transplanted from them); labels are n_out integer classes."""
    labels = [(3 * i) % n_out for i in range(len(smiles))]
    jg, ge = JG.encode_molgraphs(JG.generate_molgraphs(smiles, labels))
    tg, _ = TG.encode_molgraphs(TG.generate_molgraphs(smiles, labels))
    widths = dict(afm=ge.atom_width(), bfm=ge.bond_width(), nafm=3,
                  n_out=n_out)
    jcfg = cut(jzoo.build("adv", **widths), **kw)
    tcfg = cut(tzoo.build("adv", **widths), **kw)
    params, state = jax_init(jax.random.PRNGKey(seed), jcfg)
    params = perturb(params, np.random.RandomState(seed))
    net = params_from_jax_arrays(arrays_of(params, state), tcfg, "cpu")
    return jg, tg, jcfg, tcfg, params, state, net


@functools.lru_cache(maxsize=None)
def jax_eval(aggregation, batch_softmax):
    """The JAX network's eval output on setup()'s batch of 16 through its
    plain XLA path (100 set2vec steps)."""
    jg, _, jcfg, _, params, state, _ = setup(aggregation=aggregation,
                                             batch_softmax=batch_softmax)
    out, _ = jax_apply(jax.tree.map(jnp.asarray, params),
                       jax.tree.map(jnp.asarray, state), jcfg,
                       jax_batch(jg, 16), training=False)
    return np.asarray(out)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("aggregation,batch_softmax", VARIANTS)
def test_network_eval_matches_jax(aggregation, batch_softmax, fused):
    """Serving: the JAX network against the port's, its MPNN core through
    fused_att + set2vec (fused=True) or the plain sparse model (False)."""
    _, tg, _, tcfg, _, _, net = setup(aggregation=aggregation,
                                      batch_softmax=batch_softmax)
    want = jax_eval(aggregation, batch_softmax)
    tb = ttrainer.batch_to_device(next(iter(TG.GraphLoader(tg, 16))), "cpu")
    A.reset_launch_counts()
    S.reset_launch_counts()
    with torch.no_grad():
        out = network_apply_packed(net, tb, fused=fused)
    assert sum(A.launch_counts.values()) + sum(S.launch_counts.values()) \
        == 0
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(out.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("aggregation", ["att", "adj"])
def test_network_eval_matches_jax_pallas_path(aggregation):
    """The JAX package's own kernel path (fused_att_out: the Pallas att
    and set2vec ops in interpret mode), set2vec cut to 4 steps, against
    the port's kernel path: the two A'-form builds agree."""
    jg, tg, jcfg, _, params, state, net = setup(aggregation=aggregation,
                                                set2vec_steps=4)
    jb = jax_batch(jg, 16)
    assert fused_eval_eligible(jcfg.mpnn, jb)
    op = make_fused_eval_for_batch(jcfg.mpnn, jb, interpret=True)
    want, _ = jax_apply(jax.tree.map(jnp.asarray, params),
                        jax.tree.map(jnp.asarray, state), jcfg, jb,
                        training=False, eval_op=op)
    tb = ttrainer.batch_to_device(next(iter(TG.GraphLoader(tg, 16))), "cpu")
    with torch.no_grad():
        out = network_apply_packed(net, tb, fused=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_transplant_round_trip_of_every_att_leaf():
    """Every JAX leaf of adv has its counterpart and the round trip is
    exact: the gate (message/0/attn), the aggregator's Linear(1→1), the
    set2vec leaves in the JAX layout (lstm untransposed (2w, w) and
    (1, w), q_attn (w, w), e_attn (w, 1)) and the unread message_bias."""
    _, _, jcfg, _, params, state, net = setup(seed=2)
    arrays = arrays_of(params, state)
    back = module_to_jax_arrays(net)
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    w = 2 * jcfg.mpnn.node_features
    shapes = {"params/mpnn/readout/lstm/w_hi": (2 * w, w),
              "params/mpnn/readout/lstm/b_ho": (1, w),
              "params/mpnn/readout/q_attn/w": (w, w),
              "params/mpnn/readout/e_attn/w": (w, 1),
              "params/mpnn/agg/att/w": (1, 1), "params/mpnn/agg/att/b": (1,),
              "params/mpnn/message/0/attn/w": (
                  jcfg.mpnn.node_features + jcfg.mpnn.edge_features,
                  jcfg.mpnn.node_features),
              "params/mpnn/message/0/message_bias": (
                  jcfg.mpnn.node_features,)}
    for k, shape in shapes.items():
        assert arrays[k].shape == shape, k
    # the transplant puts the LSTM weight where the JAX apply reads it
    lstm = net.mpnn.readout.lstm
    np.testing.assert_array_equal(
        lstm.w_hf.detach().numpy(),
        arrays["params/mpnn/readout/lstm/w_hf"])
    np.testing.assert_array_equal(
        net.mpnn.readout.q_attn.weight.detach().numpy().T,
        arrays["params/mpnn/readout/q_attn/w"])


def test_checkpoints_cross_served(tmp_path, capsys):
    """An adv checkpoint written by the JAX package (the ×50 tail, 100
    set2vec steps) served by the port's `predict`, and a port-written one
    served by the JAX package's: the same records {"index", "pred":
    argmax, "logits"} from both, batch by batch."""
    csv = _csv(tmp_path)
    gs, ge = TG.encode_molgraphs(TG.generate_molgraphs(
        pd.read_csv(csv)["smiles"].tolist()))
    kw = dict(afm=ge.atom_width(), bfm=ge.bond_width(), nafm=3, n_out=4)
    params, state = jax_init(jax.random.PRNGKey(5), jzoo.build("adv", **kw))
    params = perturb(params, np.random.RandomState(5))
    ck_jax = os.path.join(str(tmp_path), "jax.npz")
    jax_save(ck_jax, params=params, state=state)
    ck_port = os.path.join(str(tmp_path), "port.npz")
    save_checkpoint(ck_port, network_init(
        tzoo.build("adv", **kw), torch.Generator().manual_seed(5), "cpu"))
    for ck in (ck_jax, ck_port):
        args = ["predict", "--experiment", "adv_classification", "--data",
                csv, "--ckpt", ck]
        jl = _predict(jcli.main, args + ["--packed"], capsys)
        tl = _predict(tcli.main, args + ["--device", "cpu"], capsys)
        assert [r["index"] for r in tl] == [r["index"] for r in jl] \
            == list(range(30))
        np.testing.assert_allclose([r["logits"] for r in tl],
                                   [r["logits"] for r in jl], rtol=RTOL,
                                   atol=ATOL)
        margin = np.sort(np.asarray([r["logits"] for r in jl]), -1)
        sure = margin[:, -1] - margin[:, -2] > 1e-4
        assert [r["pred"] for r, s in zip(tl, sure) if s] \
            == [r["pred"] for r, s in zip(jl, sure) if s]
        assert len(tl[0]["logits"]) == 4
