"""The attention model's training slice on the CPU against the JAX
package: one training step of adv (cross entropy; loss, out and every
parameter gradient) through both port paths against the JAX network's
XLA path; three Adam steps of adv_classification in lockstep through both
packages' train() on the JAX package's packed XLA path (no 100-step
interpret grid runs); and the early stop after the first epoch whose
summed step loss is below the threshold.

The port runs its plain versions here: the ops fused_att and set2vec
(whose collapse to one GRU application this holds against the JAX
package's literal step loop) and the plain sparse model. Weights are
transplanted from the JAX init with message_bias and agg/att perturbed
(tests/test_torch_att_model.py). Depth as adv has it (3 message steps,
100 set2vec steps), the edge-MLP tail cut to ×2.

Tolerances: losses rtol 1e-4; gradient leaves, each divided by its max
abs, rtol 1e-3 / atol 1e-5 (float32 through the 100-step set2vec chain,
sums in other orders); parameters after the lockstep's Adam steps rtol
1e-4 / atol 2e-5 (2% of one step at lr 1e-3: Adam divides by the
gradient's own scale). The two leaves the forward never reads,
agg/att/{w, b} and message/0/message_bias, take an exactly zero gradient
in both packages, and with no weight decay Adam leaves them bit-identical:
they are compared exactly.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpnn_tpu.models.network import network_apply_packed as jax_apply
from mpnn_tpu.train import trainer as jtrainer
from mpnn_tpu.train.checkpoint import tree_to_arrays
from mpnn_tpu_torch import graphs as TG
from mpnn_tpu_torch.train import trainer as ttrainer
from mpnn_tpu_torch.train.checkpoint import module_to_jax_arrays
from mpnn_tpu_torch.models.network import network_apply_packed
from test_torch_att_model import SMILES, setup
from test_torch_psteps_model import arrays_of, jax_batch, jax_ce, port_grads

RTOL = 1e-4
GRAD_RTOL, ATOL = 1e-3, 1e-5
LOCK_ATOL = 2e-5
ZERO_GRAD = ("params/mpnn/agg/att/w", "params/mpnn/agg/att/b",
             "params/mpnn/message/0/message_bias")


@functools.lru_cache(maxsize=None)
def jax_training_step():
    """The JAX network's training step on setup(seed=1)'s batch of 16
    (its plain XLA path): (loss, out, {grad leaf})."""
    jg, _, jcfg, _, params, state, _ = setup(seed=1)
    jb = jax_batch(jg, 16)

    def loss_fn(p):
        out, _ = jax_apply(p, state, jcfg, jb, training=True)
        return jax_ce(out, jb["labels"], jb["graph_mask"]), out

    (jloss, jout), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    return (float(jloss), np.asarray(jout),
            {f"params/{k}": np.asarray(v)
             for k, v in tree_to_arrays(jgrads).items()})


@pytest.mark.parametrize("fused", [True, False])
def test_training_step_matches_jax(fused):
    """Cross entropy, out and every parameter gradient of one training
    step; the leaves the forward never reads are exactly zero on both
    sides."""
    _, tg, _, _, _, _, net = setup(seed=1)
    jloss, jout, jgrads = jax_training_step()
    tb = ttrainer.batch_to_device(next(iter(TG.GraphLoader(tg, 16))), "cpu")
    out, new_state = network_apply_packed(net, tb, fused=fused,
                                          training=True)
    loss = ttrainer.ce_loss(out, tb["labels"], tb["graph_mask"])
    loss.backward()
    assert new_state == {"mpnn": {}}
    np.testing.assert_allclose(loss.item(), jloss, rtol=RTOL)
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=RTOL,
                               atol=ATOL)
    got = port_grads(net)
    assert set(got) == set(jgrads)
    for k, w in jgrads.items():
        g = got[k]
        assert g.shape == w.shape, k
        if k in ZERO_GRAD:
            assert not w.any() and not g.any(), k
            continue
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g / scale, w / scale, rtol=GRAD_RTOL,
                                   atol=ATOL, err_msg=k)


def _jax_train(jg, jcfg, params, state, kw, monkeypatch, *, val=None):
    """The JAX package's train() on its packed XLA path; returns
    (params, state, history, per-step losses)."""
    jlosses = []
    real_make = jtrainer.make_train_step

    def recording_make(*a, **k):
        step = real_make(*a, **k)

        def rec(*sa):
            out = step(*sa)
            jlosses.append(float(out[0]))
            return out
        return rec
    monkeypatch.setattr(jtrainer, "make_train_step", recording_make)
    jp, js, _, jhist = jtrainer.train(
        jcfg, jtrainer.TrainConfig(packed=True, **kw), jg, val,
        params=jax.tree.map(jnp.asarray, params),
        state=jax.tree.map(jnp.asarray, state), with_nafm=False)
    monkeypatch.undo()
    return jp, js, jhist, jlosses


def test_lockstep_three_adam_steps_adv(monkeypatch, tmp_path):
    """Three Adam steps (lr 1e-3, no weight decay, cross entropy,
    shuffled batches of 8, seed 317) of adv_classification through the
    port's train() and the JAX package's trainer.train() from the same
    weights, then validation: per-step losses, every parameter after step
    3 — the never-read leaves bit-identical to their start in both — and
    the validation loss."""
    smiles = (SMILES * 2)[:30]
    jg, tg, jcfg, tcfg, params, state, net = setup(smiles, seed=3)
    kw = dict(epochs=1, batch_size=8, learning_rate=1e-3, loss="ce",
              seed=317)
    jp, js, jhist, jlosses = _jax_train(jg[:24], jcfg, params, state, kw,
                                        monkeypatch, val=jg[24:])
    log = str(tmp_path / "train.jsonl")
    tnet, thist = ttrainer.train(tcfg, ttrainer.TrainConfig(
        log_path=log, **kw), tg[:24], tg[24:], net=net, device="cpu")
    with open(log) as fh:
        tlosses = [json.loads(x)["loss"] for x in fh if '"step"' in x]
    assert len(jlosses) == len(tlosses) == 3
    np.testing.assert_allclose(tlosses, jlosses, rtol=RTOL)
    got, want = module_to_jax_arrays(tnet), arrays_of(jp, js)
    before = arrays_of(params, state)
    assert set(got) == set(want)
    for k, w in want.items():
        if k in ZERO_GRAD:
            np.testing.assert_array_equal(w, before[k], err_msg=k)
            np.testing.assert_array_equal(got[k], w, err_msg=k)
            continue
        np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=LOCK_ATOL,
                                   err_msg=k)
        if "readout/lstm" in k or "attn" in k:
            assert not np.array_equal(w, before[k]), k
    np.testing.assert_allclose(thist[0]["val_loss"], jhist[0]["val_loss"],
                               rtol=RTOL)


def test_early_stop_matches_jax(monkeypatch, tmp_path):
    """early_stop_loss: both packages stop after the same epoch, the
    first whose SUMMED step loss is below the threshold, after writing
    that epoch's checkpoint. The threshold sits between the first and the
    second epoch's sums of an unstopped JAX run, so both stop after epoch
    1 of 3."""
    smiles = (SMILES * 2)[:16]
    jg, tg, jcfg, tcfg, params, state, net = setup(smiles, seed=4)
    kw = dict(epochs=3, batch_size=8, learning_rate=1e-2, loss="ce",
              seed=317)
    _, _, free, _ = _jax_train(jg, jcfg, params, state, kw, monkeypatch)
    sums = [r["train_loss"] for r in free]
    assert sums[1] < sums[0]
    thr = 0.5 * (sums[0] + sums[1])
    kw["early_stop_loss"] = thr
    jck, tck = str(tmp_path / "jax"), str(tmp_path / "port")
    _, _, jhist, _ = _jax_train(jg, jcfg, params, state,
                                dict(kw, ckpt_dir=jck), monkeypatch)
    _, thist = ttrainer.train(tcfg, ttrainer.TrainConfig(
        ckpt_dir=tck, **kw), tg, net=net, device="cpu")
    assert len(jhist) == len(thist) == 2
    np.testing.assert_allclose([r["train_loss"] for r in thist],
                               [r["train_loss"] for r in jhist], rtol=RTOL)
    assert sorted(f for f in os.listdir(tck) if f.endswith(".npz")) \
        == sorted(f for f in os.listdir(jck) if f.endswith(".npz")) \
        == ["ckpt_0.npz", "ckpt_1.npz"]
