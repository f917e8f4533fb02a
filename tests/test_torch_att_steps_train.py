"""The T-step attention model's training slice on the CPU against the JAX
package: one training step of att (cross entropy; loss, out and every
parameter gradient) through both port paths against jax.value_and_grad of
the JAX network's XLA path; three Adam steps of att_classification in
lockstep through both packages' train(); and the `train` verb on the CPU
writing a checkpoint every epoch (the experiment has no F1 gate) that the
`predict` verb then serves.

The port runs its plain versions here: the ops fused_att_steps and
set2vec, and the plain sparse model. Weights are transplanted from the
JAX init with each step's message_bias perturbed (tests/
test_torch_att_steps_model.py). Depth as att has it (3 message steps, 100
set2vec steps), the edge-MLP tail cut to ×2.

Tolerances: losses rtol 1e-4; gradient leaves, each divided by its max
abs, rtol 1e-3 / atol 1e-5 (float32 through the 100-step set2vec chain and
the three batch-wide norms, sums in other orders); parameters after the
lockstep's Adam steps rtol 1e-4 / atol 2e-5 (2% of one step at lr 1e-3).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpnn_tpu.models.network import network_apply_packed as jax_apply
from mpnn_tpu.train.checkpoint import tree_to_arrays
from mpnn_tpu_torch import graphs as TG
from mpnn_tpu_torch.models.network import network_apply_packed
from mpnn_tpu_torch.train import cli as tcli
from mpnn_tpu_torch.train import trainer as ttrainer
from mpnn_tpu_torch.train.checkpoint import module_to_jax_arrays
from test_torch_att_steps_model import SMILES, setup
from test_torch_att_train import _jax_train
from test_torch_psteps_model import (_csv, arrays_of, jax_batch, jax_ce,
                                     port_grads)

RTOL = 1e-4
GRAD_RTOL, ATOL = 1e-3, 1e-5
LOCK_ATOL = 2e-5
# The forward never reads a step's message_bias (kept for checkpoint
# parity): its gradient is exactly zero in both packages, and with no
# weight decay Adam leaves it bit-identical. It is compared exactly, not
# within the tolerance that the other leaves' Adam steps need.
ZERO_GRAD = tuple(f"params/mpnn/message/{t}/message_bias" for t in range(3))


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
    step (the three message networks' edge MLPs and gates, the GRU, the
    set2vec readout, the head); each message_bias is exactly zero on both
    sides, and the state is empty (the stateless norm keeps none)."""
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
    assert any("message/2/attn" in k for k in jgrads)
    for k, w in jgrads.items():
        g = got[k]
        assert g.shape == w.shape, k
        if k in ZERO_GRAD:
            assert not w.any() and not g.any(), k
            continue
        scale = max(float(np.abs(w).max()), 1e-30)
        assert scale > 0, k
        np.testing.assert_allclose(g / scale, w / scale, rtol=GRAD_RTOL,
                                   atol=ATOL, err_msg=k)


def test_lockstep_three_adam_steps_att(monkeypatch, tmp_path):
    """Three Adam steps (lr 1e-3, no weight decay, cross entropy,
    shuffled batches of 8, seed 317) of att_classification through the
    port's train() and the JAX package's trainer.train() from the same
    weights, then validation: per-step losses, every parameter after step
    3 (the message biases bit-identical to their start in both) and the
    validation loss."""
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


def test_train_verb_writes_checkpoints_it_serves(tmp_path, capsys):
    """`train --device cpu` of att_classification: the classification
    report in the result line, a checkpoint after every epoch (no F1 gate,
    no early stop), and `predict` from the last one."""
    csv = _csv(tmp_path, 24)
    ckdir = os.path.join(str(tmp_path), "ck")
    tcli.main(["train", "--experiment", "att_classification", "--data",
               csv, "--epochs", "2", "--batch-size", "8", "--ckpt-dir",
               ckdir, "--device", "cpu"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"accuracy", "f1"} <= set(res["test"])
    assert np.isfinite(res["test"]["loss"])
    assert sorted(f for f in os.listdir(ckdir) if f.endswith(".npz")) \
        == ["ckpt_0.npz", "ckpt_1.npz"]
    tcli.main(["predict", "--experiment", "att_classification", "--data",
               csv, "--ckpt", os.path.join(ckdir, "ckpt_1.npz"),
               "--device", "cpu"])
    recs = [json.loads(x) for x in capsys.readouterr().out.split("\n") if x]
    assert [r["index"] for r in recs] == list(range(24))
    assert all(len(r["logits"]) == 4 and np.isfinite(r["logits"]).all()
               for r in recs)
