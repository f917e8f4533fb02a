"""The per-step family's training slice on the CPU against the JAX
package: one training step of both networks (the JAX MPNN core through
the Pallas per-step training op in interpret mode), three Adam steps of
the encoded model in lockstep through both packages' train() (cross
entropy, coupled weight decay), the masked cross entropy and the
classification report, and the `train` verb's F1 checkpoint gate.

The port runs its plain versions here; the JAX side, apart from the
training-step test, its plain XLA path. Weights are transplanted from the
JAX init with every norm, running statistic and message bias perturbed
(tests/test_torch_psteps_model.py, whose gradient tolerances the
training-step test shares).

Tolerances: losses rtol 1e-4; parameters after the lockstep's Adam steps
rtol 1e-4 / atol 2e-5 (2% of one step at lr 1e-3: Adam divides by the
gradient's own scale); running statistics rtol 2e-4 / atol 1e-6.
Leaves whose gradient is zero in theory take noise-driven ±lr steps in
both packages and are not compared by value: each step's message_bias
under the message bn1d (its message norm's running mean takes that drift
in, and is compared with the drift computed from both runs' biases taken
out) and the encoders' last bias under the input bn1d (its input norm's
running mean likewise).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpnn_tpu.models.fused_train import (fused_step_eligible,
                                         make_fused_step_for_batch)
from mpnn_tpu.models.network import network_apply_packed as jax_apply
from mpnn_tpu.train import metrics as jmetrics
from mpnn_tpu.train import trainer as jtrainer
from mpnn_tpu.train.checkpoint import tree_to_arrays
from mpnn_tpu_torch import graphs as TG
from mpnn_tpu_torch.kernels import fused_psteps as P
from mpnn_tpu_torch.models.network import assign_state, network_apply_packed
from mpnn_tpu_torch.train import cli as tcli
from mpnn_tpu_torch.train import metrics as tmetrics
from mpnn_tpu_torch.train import trainer as ttrainer
from mpnn_tpu_torch.train.checkpoint import module_to_jax_arrays
from test_torch_psteps_model import (ATOL, MODELS, SMILES, _csv,
                                     arrays_of, assert_grads, jax_batch,
                                     jax_ce, port_grads, setup)

RTOL = 1e-4
LOCK_ATOL = 2e-5


@functools.lru_cache(maxsize=None)
def jax_training_step(model):
    """The JAX network's training step on setup(model, seed=1)'s first
    batch of 16, its MPNN core through the per-step training op in
    interpret mode: (loss, out, {grad leaf}, {state leaf}), computed once
    for both port paths."""
    jg, _, jcfg, _, params, state, _ = setup(model, seed=1)
    jb = jax_batch(jg, 16)
    assert fused_step_eligible(jcfg.mpnn, jb, training=True)
    op = make_fused_step_for_batch(jcfg.mpnn, jb, interpret=True)

    def loss_fn(p):
        out, ns = jax_apply(p, state, jcfg, jb, training=True, fused_op=op)
        return jax_ce(out, jb["labels"], jb["graph_mask"]), (out, ns)

    (jloss, (jout, jstate)), jgrads = jax.value_and_grad(
        loss_fn, has_aux=True)(jax.tree.map(jnp.asarray, params))
    return (float(jloss), np.asarray(jout),
            {f"params/{k}": np.asarray(v)
             for k, v in tree_to_arrays(jgrads).items()},
            {f"state/{k}": np.asarray(v)
             for k, v in tree_to_arrays(jstate).items()})


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("model", MODELS)
def test_network_training_step_matches_jax(model, fused):
    """One training step: masked cross entropy, out, every parameter
    gradient (the autoencoders' decoders zero on both sides), and every
    running statistic after the step — each per-step norm's single EMA
    update and the input norms' — against jax_training_step."""
    _, tg, _, tcfg, params, state, net = setup(model, seed=1)
    jloss, jout, jgrads, want = jax_training_step(model)
    tb = ttrainer.batch_to_device(next(iter(TG.GraphLoader(tg, 16))), "cpu")
    P.reset_launch_counts()
    out, new_state = network_apply_packed(net, tb, fused=fused,
                                          training=True)
    loss = ttrainer.ce_loss(out, tb["labels"], tb["graph_mask"])
    loss.backward()
    assert sum(P.launch_counts.values()) == 0       # plain version on CPU
    np.testing.assert_allclose(loss.item(), jloss, rtol=RTOL)
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=RTOL,
                               atol=ATOL)
    assert_grads(port_grads(net), jgrads, tcfg.mpnn)
    assign_state(net, new_state)
    got = {k: v for k, v in module_to_jax_arrays(net).items()
           if k.startswith("state/")}
    assert set(got) == set(want)
    before = arrays_of(params, state)
    moved = [k for k in want if "encoder" not in k]
    # encoded: ma_bn/t and bn/t for T = 3, aebn, bebn; graph_norm: none
    assert len(moved) == (16 if model == "encoded" else 0)
    for k, w in want.items():
        if k in moved:
            assert not np.allclose(w, before[k]), k
        np.testing.assert_allclose(got[k], w, rtol=2e-4, atol=1e-6,
                                   err_msg=k)


def test_lockstep_three_adam_steps_encoded(monkeypatch, tmp_path):
    """Three Adam steps (lr 1e-3, coupled weight decay 1e-5, cross
    entropy, shuffled batches of 8, seed 317) of the encoded model
    through the port's train() and the JAX package's trainer.train() from
    the same weights, then validation with micro averaging: per-step
    losses, every parameter (the autoencoders' decoders moved by the
    weight decay alone) and every running statistic after step 3, and the
    validation metrics."""
    smiles = (SMILES * 2)[:30]
    jg, tg, jcfg, tcfg, params, state, net = setup("encoded", smiles,
                                                   seed=3)
    T = jcfg.mpnn.message_steps
    jlosses, jbias, tbias = [], [], []
    real_make = jtrainer.make_train_step

    def recording_make(*a, **kw):
        step = real_make(*a, **kw)

        def rec(*sa):
            m = sa[0]["mpnn"]
            jbias.append(([np.asarray(mp["message_bias"])
                           for mp in m["message"]],
                          [np.asarray(e["enc"][1]["b"]) for e in
                           (m["atom_encoder"], m["bond_encoder"])]))
            out = step(*sa)
            jlosses.append(float(out[0]))
            return out
        return rec
    monkeypatch.setattr(jtrainer, "make_train_step", recording_make)
    real_step = ttrainer.train_step

    def recording_step(net, *a, **kw):
        m = net.mpnn
        tbias.append(([mp.message_bias.detach().numpy().copy()
                       for mp in m.message],
                      [e.enc[1].bias.detach().numpy().copy() for e in
                       (m.atom_encoder, m.bond_encoder)]))
        return real_step(net, *a, **kw)
    monkeypatch.setattr(ttrainer, "train_step", recording_step)
    kw = dict(epochs=1, batch_size=8, learning_rate=1e-3,
              weight_decay=1e-5, loss="ce", metric_average="micro",
              seed=317)
    jp, js, _, jhist = jtrainer.train(
        jcfg, jtrainer.TrainConfig(packed=True, **kw), jg[:24], jg[24:],
        params=jax.tree.map(jnp.asarray, params),
        state=jax.tree.map(jnp.asarray, state), with_nafm=False)
    log = str(tmp_path / "train.jsonl")
    tnet, thist = ttrainer.train(tcfg, ttrainer.TrainConfig(
        log_path=log, **kw), tg[:24], tg[24:], net=net, device="cpu")
    with open(log) as fh:
        tlosses = [json.loads(x)["loss"] for x in fh if '"step"' in x]
    assert len(jlosses) == len(tlosses) == len(tbias) == len(jbias) == 3
    np.testing.assert_allclose(tlosses, jlosses, rtol=RTOL)
    got, want = module_to_jax_arrays(tnet), arrays_of(jp, js)
    before = arrays_of(params, state)
    assert set(got) == set(want)
    # the biases a batch-statistics norm takes out of its input follow
    # noise-level gradients; their norm's running mean takes the drift in
    # exactly: one EMA update per step, so after S steps the difference is
    # 0.1·Σ_s 0.9**(S−1−s)·Δbias_s
    skip, drift = set(), {}
    S = len(tbias)
    for t in range(T):
        skip.add(f"params/mpnn/message/{t}/message_bias")
        drift[f"state/mpnn/ma_bn/{t}/running_mean"] = 0.1 * sum(
            0.9 ** (S - 1 - s) * (tb[0][t] - jb[0][t])
            for s, (tb, jb) in enumerate(zip(tbias, jbias)))
    for i, (enc, bn) in enumerate((("atom_encoder", "aebn"),
                                   ("bond_encoder", "bebn"))):
        skip.add(f"params/mpnn/{enc}/enc/1/b")
        drift[f"state/mpnn/{bn}/running_mean"] = 0.1 * sum(
            0.9 ** (S - 1 - s) * (tb[1][i] - jb[1][i])
            for s, (tb, jb) in enumerate(zip(tbias, jbias)))
    for k, w in want.items():
        if k in skip:
            continue
        g = got[k] - drift.get(k, 0.0)
        if k.startswith("params/"):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=LOCK_ATOL,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=1e-6,
                                       err_msg=k)
        if "/dec/" in k:                  # weight decay alone moved it
            assert not np.array_equal(w, before[k]), k
    # with the JAX run's noise-driven biases and running means the port's
    # validation reproduces the JAX run's
    with torch.no_grad():
        for t, mp in enumerate(tnet.mpnn.message):
            mp.message_bias.copy_(torch.tensor(
                want[f"params/mpnn/message/{t}/message_bias"]))
            tnet.mpnn.ma_bn[t].running_mean.copy_(torch.tensor(
                want[f"state/mpnn/ma_bn/{t}/running_mean"]))
        for enc, bn in (("atom_encoder", "aebn"), ("bond_encoder", "bebn")):
            getattr(tnet.mpnn, enc).enc[1].bias.copy_(torch.tensor(
                want[f"params/mpnn/{enc}/enc/1/b"]))
            getattr(tnet.mpnn, bn).running_mean.copy_(torch.tensor(
                want[f"state/mpnn/{bn}/running_mean"]))
    val = ttrainer.evaluate(tnet, TG.GraphLoader(tg[24:], 8), "ce",
                            "micro", device="cpu")
    np.testing.assert_allclose(val["loss"], jhist[0]["val_loss"], rtol=RTOL)
    for key in ("accuracy", "precision", "recall", "f1"):
        assert val[key] == pytest.approx(jhist[0][f"val_{key}"]), key


def test_masked_ce_matches_jax():
    """The masked cross entropy Σ per·gm / Σ gm against the JAX
    package's (optax's softmax cross entropy with integer labels), with a
    padded graph slot."""
    import optax
    rng = np.random.RandomState(0)
    out = (3 * rng.randn(9, 5)).astype(np.float32)
    labels = rng.randint(0, 5, 9)
    gm = np.ones(9, np.float32)
    gm[-2:] = 0.0
    per = optax.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(out), jnp.asarray(labels, jnp.int32))
    want = float((per * gm).sum() / gm.sum())
    got = ttrainer.ce_loss(torch.tensor(out), torch.tensor(labels),
                           torch.tensor(gm))
    assert float(got) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("average", ["weighted", "micro", "macro",
                                     "binary"])
def test_classification_report_matches_jax(average):
    rng = np.random.RandomState(1)
    y, p = rng.randint(0, 4, 50), rng.randint(0, 4, 50)
    if average == "binary":
        y, p = y % 2, p % 2
    assert tmetrics.classification_report(y, p, average) \
        == jmetrics.classification_report(y, p, average)


def test_cli_train_classification_and_f1_gate(tmp_path, capsys):
    """`train --device cpu` of encoded_classification: the classification
    report in the result line, and no checkpoint from an epoch whose
    validation f1 misses the gate (0.8)."""
    csv = _csv(tmp_path, 40)
    ckdir = os.path.join(str(tmp_path), "ck")
    tcli.main(["train", "--experiment", "encoded_classification", "--data",
               csv, "--epochs", "1", "--batch-size", "8", "--ckpt-dir",
               ckdir, "--device", "cpu"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    last = res["last"]
    assert {"val_accuracy", "val_precision", "val_recall", "val_f1"} \
        <= set(last)
    assert {"accuracy", "f1"} <= set(res["test"])
    written = os.path.exists(os.path.join(ckdir, "ckpt_0.npz"))
    assert written == (last["val_f1"] > 0.8)
