"""The basic shell on the CPU against the JAX package: basic_classification
and single_target trained three Adam steps in lockstep through both
packages' trainer.train(); the autoencoder's and the stateless shared
pairs' served output; the port's copy of graphs/filters.py and the
experiments' transforms.

The JAX side runs the packed path with its whole-step Pallas kernels in
interpret mode (fuse_step, spmm='kernel_interpret', as
tests/test_fused_norm_modes.py runs the basic config); the port its plain
versions. The edge-MLP tail is cut to ×3; widths are the featurized
SMILES' (afm 7, so od = 4·afm = 28, past the narrow bucket's 16).

Tolerances: losses and served outputs rtol 1e-4 / atol 1e-5, parameters
after three steps rtol 1e-4 / atol 1e-4 (tests/test_torch_train.py's
LOCK_ATOL). The basic shell has no norm, so no leaf is left out.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpnn_tpu import graphs as JG
from mpnn_tpu.graphs import filters as JF
from mpnn_tpu.models import zoo as jzoo
from mpnn_tpu.models.fused_train import make_fused_eval_for_batch
from mpnn_tpu.models.network import network_apply_packed as jax_apply
from mpnn_tpu.models.network import network_init as jax_init
from mpnn_tpu.train import cli as jcli
from mpnn_tpu.train import experiments as jexp
from mpnn_tpu.train import trainer as jtrainer
from mpnn_tpu_torch import graphs as TG
from mpnn_tpu_torch.graphs import filters as TF
from mpnn_tpu_torch.kernels import fused_step as K
from mpnn_tpu_torch.models import zoo as tzoo
from mpnn_tpu_torch.models.network import network_apply_packed
from mpnn_tpu_torch.train import cli as tcli
from mpnn_tpu_torch.train import experiments as texp
from mpnn_tpu_torch.train import trainer as ttrainer
from mpnn_tpu_torch.train.checkpoint import (module_to_jax_arrays,
                                             params_from_jax_arrays)
from test_torch_train import LOCK_ATOL, RTOL, SMILES, _arrays

ATOL = 1e-5


def _cut(cfg, **mpnn):
    return dataclasses.replace(cfg, mpnn=dataclasses.replace(
        cfg.mpnn, edge_mlp_tail_repeats=3, **mpnn))


def _graphs(labels):
    smiles = SMILES[:len(labels)]
    jg, ge = JG.encode_molgraphs(JG.generate_molgraphs(smiles, labels))
    tg, _ = TG.encode_molgraphs(TG.generate_molgraphs(smiles, labels))
    return jg, tg, ge.atom_width(), ge.bond_width()


def _pair(model, afm, bfm, n_out, seed, **mpnn):
    """(JAX cfg, port cfg, JAX params and state as host arrays — the
    JAX train step donates its inputs —, the port's net holding them)."""
    jcfg = _cut(jzoo.build(model, afm=afm, bfm=bfm, n_out=n_out), **mpnn)
    tcfg = _cut(tzoo.build(model, afm=afm, bfm=bfm, n_out=n_out), **mpnn)
    params, state = jax.tree.map(np.asarray,
                                 jax_init(jax.random.PRNGKey(seed), jcfg))
    net = params_from_jax_arrays(_arrays(params, state), tcfg, "cpu")
    return jcfg, tcfg, params, state, net


@pytest.mark.parametrize("experiment", ["basic_classification",
                                        "single_target"])
def test_lockstep_three_adam_steps(experiment, monkeypatch):
    """Three Adam steps of the experiment's optimizer (lr 1e-3, cross
    entropy, seed 317) through both packages' train() from the same
    weights, then validation: per-step losses, every parameter after step
    3, and the validation loss and metrics. Each step is one epoch of one
    shuffled batch of all 24 training molecules: the JAX trainer's fused
    path draws the loader's first shuffle for its eligibility probe, so
    with smaller batches its epochs would see other batches than the
    port's (a batch's order moves its sums by rounding only).
    single_target's labels are one-vs-rest (class 1 of four) and its head
    the 4-layer MLP."""
    labels = [i % 4 for i in range(30)]
    jg, tg, afm, bfm = _graphs(labels)
    exp = texp.get(experiment)
    n_out = 4
    if exp.binarize_target_class is not None:
        jg, tg = JF.binarize_target(jg, 1), TF.binarize_target(tg, 1)
        n_out = 2
    jcfg, tcfg, params, state, net = _pair(exp.model, afm, bfm, n_out,
                                           seed=5)
    assert tcfg.mpnn.output_dim == 4 * afm > 16
    jlosses = []
    real_make = jtrainer.make_train_step

    def recording_make(*a, **kw):
        step = real_make(*a, **kw)

        def rec(*sa):
            out = step(*sa)
            jlosses.append(float(out[0]))
            return out
        return rec
    monkeypatch.setattr(jtrainer, "make_train_step", recording_make)
    tlosses = []
    real_step = ttrainer.train_step

    def recording_step(*a, **kw):
        loss = real_step(*a, **kw)
        tlosses.append(float(loss))
        return loss
    monkeypatch.setattr(ttrainer, "train_step", recording_step)
    kw = dict(epochs=3, batch_size=24, learning_rate=exp.train.learning_rate,
              weight_decay=exp.train.weight_decay, loss="ce",
              metric_average=exp.train.metric_average, seed=317)
    jp, js, _, jhist = jtrainer.train(
        jcfg, jtrainer.TrainConfig(packed=True, fuse_step=True,
                                   spmm="kernel_interpret", **kw),
        jg[:24], jg[24:], params=jax.tree.map(jnp.asarray, params),
        state=jax.tree.map(jnp.asarray, state))
    K.reset_launch_counts()
    tnet, thist = ttrainer.train(tcfg, ttrainer.TrainConfig(**kw), tg[:24],
                                 tg[24:], net=net, device="cpu")
    assert len(jlosses) == len(tlosses) == 3
    np.testing.assert_allclose(tlosses, jlosses, rtol=RTOL)
    got, want = module_to_jax_arrays(tnet), _arrays(jp, js)
    assert set(got) == set(want)
    before = _arrays(params, state)
    for k, w in want.items():
        assert not np.array_equal(w, before[k]), k
        np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=LOCK_ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(thist[-1]["val_loss"],
                               jhist[-1]["val_loss"], rtol=RTOL)
    for key in ("accuracy", "precision", "recall", "f1"):
        assert thist[-1][f"val_{key}"] == pytest.approx(
            jhist[-1][f"val_{key}"]), key


@pytest.mark.parametrize("model,msg_norm,state_norm", [
    ("autoencoder", "none", "none"), ("basic", "none", "stateless"),
    ("basic", "bn1d", "stateless")])
def test_served_output_matches_jax(model, msg_norm, state_norm):
    """The served output (eval mode) of the autoencoder's encoder (head
    'none': the graph embeddings, od 2·afm) and of the basic shell with
    the stateless state norm (by the batch's own statistics), the JAX
    package through its eval kernel in interpret mode, the port through
    its eval op (the plain version here), on the same batch."""
    labels = [0.1 * i for i in range(16)]
    jg, tg, afm, bfm = _graphs(labels)
    jcfg, tcfg, params, state, net = _pair(
        model, afm, bfm, 0 if model == "autoencoder" else 4, seed=7,
        msg_norm=msg_norm, state_norm=state_norm)
    if msg_norm == "bn1d":
        rng = np.random.RandomState(7)
        with torch.no_grad():
            net.mpnn.ma_bn[0].running_mean.copy_(torch.tensor(
                0.3 * rng.randn(afm), dtype=torch.float32))
            net.mpnn.ma_bn[0].running_var.copy_(torch.tensor(
                0.5 + rng.rand(afm), dtype=torch.float32))
        arrays = module_to_jax_arrays(net)
        state = jax.tree.map(np.asarray, state)
        state["mpnn"]["ma_bn"][0] = {
            "running_mean": arrays["state/mpnn/ma_bn/0/running_mean"],
            "running_var": arrays["state/mpnn/ma_bn/0/running_var"]}
    b = next(iter(JG.GraphLoader(jg, 16, collate="packed", use_native=False,
                                 fused_step_plan=True)))
    jb = {k: (jnp.asarray(v) if not np.isscalar(v) else v)
          for k, v in b.items() if k != "num_graphs"}
    ev = make_fused_eval_for_batch(jcfg.mpnn, jb, interpret=True)
    want, _ = jax_apply(params, jax.tree.map(jnp.asarray, state), jcfg, jb,
                        training=False, eval_op=ev)
    tb = ttrainer.batch_to_device(next(iter(TG.GraphLoader(tg, 16))), "cpu")
    K.reset_launch_counts()
    with torch.no_grad():
        got = network_apply_packed(net, tb).numpy()
    assert K.launch_counts["fused_eval"] == 0          # the plain version
    want = np.asarray(want)
    assert got.shape == want.shape == (16, 2 * afm if model == "autoencoder"
                                       else 4)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("lower,upper,keep", [(None, None, None), (2, None,
                                                                   None),
                                              (1, 9, None), (1, None, 2)])
def test_filters_match_jax(lower, upper, keep):
    """filter_by_label_count, binarize_target and affinity_labels on the
    same graphs: the same kept graphs, labels and class counts."""
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 6, 30).tolist()
    jg, tg, _, _ = _graphs(labels)
    for js, ts in zip(jg, tg):
        js.affinity = ts.affinity = float(rng.rand())
    jout, jl, jn = JF.filter_by_label_count(jg, lower, upper, keep)
    tout, tl, tn = TF.filter_by_label_count(tg, lower, upper, keep)
    assert (tl, tn) == (jl, jn) and len(tout) == len(jout)
    assert [g.label for g in TF.binarize_target(tout, 1)] == [
        g.label for g in JF.binarize_target(jout, 1)]
    jg2, tg2, _, _ = _graphs(labels)
    for js, ts in zip(jg2, tg2):
        js.affinity = ts.affinity = float(rng.rand())
    assert [g.label for g in TF.affinity_labels(tg2, 3)] == [
        g.label for g in JF.affinity_labels(jg2, 3)]


def test_experiment_transforms_match_jax():
    """The registered experiments' preprocessing: single_target's
    one-vs-rest against class 243 as the JAX package's CLI applies it,
    basic_classification's none."""
    labels = [i % 250 for i in range(260)]
    graphs = [dataclasses.replace(g) for g in _graphs(labels[:30])[1]
              for _ in range(9)]
    for g, y in zip(graphs, labels):
        g.label = y
    for name in ("basic_classification", "single_target"):
        want = [g.label for g in jcli._apply_experiment_transforms(
            jexp.get(name), [dataclasses.replace(g) for g in graphs])]
        got = [g.label for g in tcli.apply_experiment_transforms(
            texp.get(name), [dataclasses.replace(g) for g in graphs])]
        assert got == want
    assert sum(got) == 1                  # the one molecule of class 243
