"""The T-step attention model `att` (zoo att, models/att_model.py's
composition) on the CPU against the JAX package, the weights transplanted
from the JAX init with the leaves the forward never reads (each step's
message_bias) perturbed: eval outputs of both port paths — the MPNN core
through the port's ops (fused_att_steps and set2vec, their plain versions
here) and through its plain sparse model, whose loop runs every step
literally — against the JAX network's plain XLA path, for the zoo config
and the other modes the kernels take (tests/test_fused_norm_modes.py::
ATT_STEPS_MODES: shared message weights, no norm, the 'att' aggregation);
the zoo config against the JAX package's own kernel path (fused_mpnn_eval:
the Pallas ops in interpret mode); the weight transplant round trip; and
att checkpoints written by one package and served by the other's
`predict`. The edge-MLP tail is cut to ×2; set2vec runs the reference's
100 steps except on the interpret path (4).

Tolerances: forward values rtol 1e-4 / atol 1e-5 (float32, sums in other
orders). The stateless norm and the batch-global set2vec softmax couple
every molecule of a batch, so every comparison runs on the same batches.
"""

import dataclasses
import functools
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
from mpnn_tpu_torch.kernels import fused_att_steps as AS
from mpnn_tpu_torch.kernels import set2vec as S
from mpnn_tpu_torch.models import zoo as tzoo
from mpnn_tpu_torch.models.mpnn import att_steps_shape
from mpnn_tpu_torch.models.network import network_apply_packed, network_init
from mpnn_tpu_torch.train import cli as tcli
from mpnn_tpu_torch.train import trainer as ttrainer
from mpnn_tpu_torch.train.checkpoint import (module_to_jax_arrays,
                                             params_from_jax_arrays,
                                             save_checkpoint)
from test_torch_att_model import perturb
from test_torch_psteps_model import _csv, _predict, arrays_of, jax_batch

RTOL, ATOL = 1e-4, 1e-5
SMILES = bench.SMILES + ["C", "O", "CCO", "CCN", "c1ccccc1", "CC(=O)O"]
# (shared message weights, state norm, aggregation, readout): the zoo's
# own first, then the other modes the kernels take
MODES = [(False, "stateless", "adj", "set2vec"),
         (False, "none", "adj", "graph_level"),
         (True, "stateless", "adj", "graph_level"),
         (False, "stateless", "att", "graph_level")]


def cut(cfg, share=False, state_norm="stateless", aggregation="adj",
        readout="set2vec", **kw):
    """att at its widths and depth (3 steps) in one of MODES, the ×50
    tail cut to ×2."""
    return dataclasses.replace(cfg, mpnn=dataclasses.replace(
        cfg.mpnn, edge_mlp_tail_repeats=2, share_message_weights=share,
        state_norm=state_norm, aggregation=aggregation, readout=readout,
        **kw))


def setup(smiles=SMILES[:16], seed=0, n_out=4, **kw):
    """(JAX graphs, port graphs, JAX cfg, port cfg, params, state, port
    net transplanted from them); labels are n_out integer classes."""
    labels = [(3 * i) % n_out for i in range(len(smiles))]
    jg, ge = JG.encode_molgraphs(JG.generate_molgraphs(smiles, labels))
    tg, _ = TG.encode_molgraphs(TG.generate_molgraphs(smiles, labels))
    widths = dict(afm=ge.atom_width(), bfm=ge.bond_width(), nafm=3,
                  n_out=n_out)
    jcfg = cut(jzoo.build("att", **widths), **kw)
    tcfg = cut(tzoo.build("att", **widths), **kw)
    params, state = jax_init(jax.random.PRNGKey(seed), jcfg)
    params = perturb(params, np.random.RandomState(seed))
    net = params_from_jax_arrays(arrays_of(params, state), tcfg, "cpu")
    return jg, tg, jcfg, tcfg, params, state, net


@functools.lru_cache(maxsize=None)
def jax_eval(mode):
    """The JAX network's eval output on setup()'s batch of 16 through its
    plain XLA path."""
    jg, _, jcfg, _, params, state, _ = setup(**dict(zip(
        ("share", "state_norm", "aggregation", "readout"), mode)))
    out, _ = jax_apply(jax.tree.map(jnp.asarray, params),
                       jax.tree.map(jnp.asarray, state), jcfg,
                       jax_batch(jg, 16), training=False)
    return np.asarray(out)


def test_zoo_att_is_the_reference_composition():
    """Per-step message networks, 'adj', GRU on the evolving state from
    messages of the initial one, the stateless norm, set2vec: the T-step
    kernel family, with one message network per step in the module."""
    cfg = tzoo.att(7, 6).mpnn
    assert att_steps_shape(cfg)
    assert (cfg.share_message_weights, cfg.aggregation, cfg.update_hidden,
            cfg.message_input, cfg.state_norm, cfg.readout,
            cfg.message_steps) == (False, "adj", "state", "initial",
                                   "stateless", "set2vec", 3)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jzoo.att(7, 6).mpnn)
    net = network_init(tzoo.att(7, 6), torch.Generator().manual_seed(0),
                       "cpu")
    assert len(net.mpnn.message) == 3 and not hasattr(net.mpnn, "agg")


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_network_eval_matches_jax(mode, fused):
    """Serving: the JAX network against the port's, its MPNN core through
    fused_att_steps + set2vec (fused=True) or the plain sparse model."""
    _, tg, _, tcfg, _, _, net = setup(**dict(zip(
        ("share", "state_norm", "aggregation", "readout"), mode)))
    want = jax_eval(mode)
    tb = ttrainer.batch_to_device(next(iter(TG.GraphLoader(tg, 16))), "cpu")
    AS.reset_launch_counts()
    S.reset_launch_counts()
    with torch.no_grad():
        out = network_apply_packed(net, tb, fused=fused)
    assert sum(AS.launch_counts.values()) + sum(S.launch_counts.values()) \
        == 0
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(out.numpy(), want, rtol=RTOL, atol=ATOL)


def test_network_eval_matches_jax_pallas_path():
    """The JAX package's own kernel path for the zoo config (fused_mpnn_eval
    through the Pallas att-steps and set2vec ops in interpret mode), set2vec
    cut to 4 steps, against the port's kernel path: the two per-step
    A'-form builds agree."""
    jg, tg, jcfg, _, params, state, net = setup(set2vec_steps=4)
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
    """Every JAX leaf of att has its counterpart and the round trip is
    exact: each step's gate (message/{t}/attn), its edge MLP (head, the
    shared tail layer, final) and unread message_bias, the GRU and the
    set2vec leaves; the stateless norm has none."""
    _, _, jcfg, _, params, state, net = setup(seed=2)
    arrays = arrays_of(params, state)
    back = module_to_jax_arrays(net)
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    nf, ef = jcfg.mpnn.node_features, jcfg.mpnn.edge_features
    for t in range(3):
        assert arrays[f"params/mpnn/message/{t}/attn/w"].shape == (nf + ef,
                                                                  nf)
        assert f"params/mpnn/message/{t}/final/w" in arrays
        assert f"params/mpnn/message/{t}/head/0/w" in arrays
        np.testing.assert_array_equal(
            net.mpnn.message[t].attn.weight.detach().numpy().T,
            arrays[f"params/mpnn/message/{t}/attn/w"])
    assert not any("bn" in k or "agg" in k for k in arrays)


def test_checkpoints_cross_served(tmp_path, capsys):
    """An att checkpoint written by the JAX package (the ×50 tail, 100
    set2vec steps) served by the port's `predict`, and a port-written one
    served by the JAX package's: the same records {"index", "pred":
    argmax, "logits"} from both, batch by batch."""
    csv = _csv(tmp_path)
    gs, ge = TG.encode_molgraphs(TG.generate_molgraphs(
        pd.read_csv(csv)["smiles"].tolist()))
    kw = dict(afm=ge.atom_width(), bfm=ge.bond_width(), nafm=3, n_out=4)
    params, state = jax_init(jax.random.PRNGKey(6), jzoo.build("att", **kw))
    params = perturb(params, np.random.RandomState(6))
    ck_jax = os.path.join(str(tmp_path), "jax.npz")
    jax_save(ck_jax, params=params, state=state)
    ck_port = os.path.join(str(tmp_path), "port.npz")
    save_checkpoint(ck_port, network_init(
        tzoo.build("att", **kw), torch.Generator().manual_seed(6), "cpu"))
    for ck in (ck_jax, ck_port):
        args = ["predict", "--experiment", "att_classification", "--data",
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
