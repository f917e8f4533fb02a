"""The decomposed training path on the CPU against the JAX package: the
port's train() with fuse_step=False — the plain model with the SpMM hook
(kernels/spmm.py), the edge-MLP chain op and, with fuse_recurrence, the
fused recurrence op (kernels/recurrence.py), each its plain version on CPU
tensors — against the JAX package's train() with packed=True,
spmm='kernel_interpret' (the Pallas SpMM op in interpret mode) and
fuse_recurrence (make_recurrence_op_auto, interpret mode), from the same
weights; one training step's gradients (nafm_bn's among them: they reach
the wrapper through the SpMM's dh, the recurrence's dh0 and the readout's
h0) and the per-step family's step with the SpMM hook alone; the `train
--spmm kernel` verb; the attention models' `train --spmm kernel` against
their whole-step path; and what the decomposed path refuses.

The lipo shell at its widths with depth cut to T = 3 and a ×3 edge-MLP
tail (tests/test_torch_train.py's _setup), the per-step models as
tests/test_torch_psteps_model.py sets them up. Tolerances as in those
files: losses and values rtol 1e-4 / atol 1e-5, gradient leaves divided
by their max abs rtol 2e-4 / atol 1e-5, parameters after the Adam steps
atol 1e-4, running statistics rtol 1e-4. message_bias under the message
bn1d has zero gradient in theory: held to an absolute bound, its value
after Adam steps not compared, its norm's running mean compared with the
drift of both runs' biases taken out.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpnn_tpu import graphs as JG
from mpnn_tpu.kernels.recurrence import make_recurrence_op_auto
from mpnn_tpu.kernels.spmm import make_spmm_op as jax_spmm_op
from mpnn_tpu.models.network import network_apply_packed as jax_apply
from mpnn_tpu.train import trainer as jtrainer
from mpnn_tpu.train.checkpoint import tree_to_arrays
from mpnn_tpu_torch import graphs as TG
from mpnn_tpu_torch.kernels import recurrence as R
from mpnn_tpu_torch.kernels import spmm as S
from mpnn_tpu_torch.models.network import assign_state, network_apply_packed
from mpnn_tpu_torch.train import cli as tcli
from mpnn_tpu_torch.train import trainer as ttrainer
from mpnn_tpu_torch.train.checkpoint import module_to_jax_arrays
from test_torch_psteps_model import (arrays_of, assert_grads, jax_ce,
                                     port_grads)
from test_torch_psteps_model import setup as ps_setup
from test_torch_train import (ATOL, LOCK_ATOL, RTOL, SMILES, _arrays,
                              _assert_grads, _csv, _port_grads, _setup)


def _jax_spmm_batch(jg, n, with_nafm):
    """The first packed batch of n with the SpMM window plan, and the
    Pallas SpMM op (interpret mode) sized to it. Blocks of 128 edges: the
    plan's window may not exceed the batch's node capacity (256 here),
    and without a plan the JAX model takes its XLA gather instead."""
    loader = JG.GraphLoader(jg, n, collate="packed", use_native=False,
                            spmm_plan=True, spmm_block_edges=128,
                            with_nafm=with_nafm)
    b = next(iter(loader))
    assert "spmm_win" in b
    op = jax_spmm_op(block_edges=loader.spmm_block_edges,
                     window=loader.spmm_window, interpret=True)
    jb = {k: (jnp.asarray(v) if not np.isscalar(v) else v)
          for k, v in b.items() if k != "num_graphs"}
    return jb, op, loader


@pytest.mark.parametrize("fuse_recurrence", [True, False])
def test_lockstep_three_adam_steps_decomposed(monkeypatch, tmp_path,
                                              fuse_recurrence):
    """Three Adam steps (lr 1e-2, coupled weight decay 1e-4, shuffled
    batches of 40, seed 317) through the port's decomposed train() and the
    JAX package's train() with the SpMM kernel (and the fused recurrence)
    in interpret mode, from the same weights, then validation through the
    eval path: per-step losses, every parameter and running statistic
    after step 3. Batches of 40 molecules: the JAX trainer plans windows of
    512 edges, which a batch takes only when its node capacity is at least
    as large (every JAX batch is checked to carry the plan)."""
    jg, tg, jcfg, tcfg, params, state, net = _setup((SMILES * 5)[:136],
                                                    seed=2)
    jlosses, jbias, tbias = [], [], []
    real_make = jtrainer.make_train_step

    def recording_make(*a, **kw):
        assert kw["spmm_vocab_fn"] is not None
        assert (kw["recurrence_fn"] is not None) == fuse_recurrence
        step = real_make(*a, **kw)

        def rec(*sa):
            assert "spmm_win" in sa[3]
            jbias.append(np.asarray(sa[0]["mpnn"]["message"][0]
                                    ["message_bias"]))
            out = step(*sa)
            jlosses.append(float(out[0]))
            return out
        return rec
    monkeypatch.setattr(jtrainer, "make_train_step", recording_make)
    real_step = ttrainer.train_step

    def recording_step(net, *a, **kw):
        assert kw["hooks"]["spmm_vocab_fn"] is not None
        assert (kw["hooks"]["recurrence_fn"] is not None) == fuse_recurrence
        tbias.append(net.mpnn.message[0].message_bias.detach().numpy().copy())
        return real_step(net, *a, **kw)
    monkeypatch.setattr(ttrainer, "train_step", recording_step)
    jp, js, _, jhist = jtrainer.train(
        jcfg, jtrainer.TrainConfig(
            epochs=1, batch_size=40, learning_rate=1e-2, weight_decay=1e-4,
            loss="mse", packed=True, plateau=True, seed=317,
            spmm="kernel_interpret", fuse_recurrence=fuse_recurrence),
        jg[:120], jg[120:], params=jax.tree.map(jnp.asarray, params),
        state=jax.tree.map(jnp.asarray, state))
    log = str(tmp_path / "train.jsonl")
    S.reset_launch_counts()
    R.reset_launch_counts()
    tnet, thist = ttrainer.train(
        tcfg, ttrainer.TrainConfig(
            epochs=1, batch_size=40, learning_rate=1e-2, weight_decay=1e-4,
            plateau=True, seed=317, log_path=log, fuse_step=False,
            fuse_recurrence=fuse_recurrence),
        tg[:120], tg[120:], net=net, device="cpu")
    # CPU tensors: the plain versions, no kernel launch
    assert set(S.launch_counts.values()) | set(R.launch_counts.values()) \
        == {0}
    with open(log) as fh:
        tlosses = [json.loads(x)["loss"] for x in fh if '"step"' in x]
    assert len(jlosses) == len(tlosses) == 3
    np.testing.assert_allclose(tlosses, jlosses, rtol=RTOL)
    got = module_to_jax_arrays(tnet)
    want = _arrays(jp, js)
    assert set(got) == set(want)
    mb = "params/mpnn/message/0/message_bias"
    ma_mean = "state/mpnn/ma_bn/0/running_mean"
    np.testing.assert_array_equal(tbias[0], jbias[0])
    a = 0.9 ** tcfg.mpnn.message_steps
    drift = (1 - a) * sum(a ** (len(tbias) - 1 - s) * (tb - jb)
                          for s, (tb, jb) in enumerate(zip(tbias, jbias)))
    got[ma_mean] = got[ma_mean] - drift
    for k, w in want.items():
        if k != mb:
            np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=LOCK_ATOL,
                                       err_msg=k)
    # eval mode normalizes by the running statistics, where message_bias
    # no longer cancels: with the JAX run's bias and message running mean
    # the port's validation reproduces the JAX run's
    assert np.isfinite(thist[0]["val_loss"])
    with torch.no_grad():
        tnet.mpnn.message[0].message_bias.copy_(torch.tensor(want[mb]))
        tnet.mpnn.ma_bn[0].running_mean.copy_(torch.tensor(want[ma_mean]))
    val = ttrainer.evaluate(tnet, TG.GraphLoader(tg[120:], 40), "mse",
                            device="cpu")
    np.testing.assert_allclose(val["loss"], jhist[0]["val_loss"], rtol=RTOL)


def test_decomposed_step_gradients_match_jax():
    """One training step of the lipo network through the decomposed path
    with both hooks (the SpMM and the recurrence op) against the JAX loss
    with the Pallas SpMM and recurrence ops in interpret mode: the loss,
    out, every parameter gradient — nafm_bn's weight and bias among them,
    which reach the graph_norm wrapper through the SpMM's dh, the
    recurrence's dh0 and the readout's h0 — and every running statistic."""
    jg, tg, jcfg, tcfg, params, state, net = _setup(SMILES[:16], seed=4)
    jb, spmm_op, loader = _jax_spmm_batch(jg, 16, True)
    rec_op = make_recurrence_op_auto(jcfg.mpnn.message_steps,
                                     jcfg.mpnn.node_features,
                                     loader._packed_caps[0], interpret=True)
    loss_fn = jtrainer.make_loss_fn(jcfg, "mse", spmm_vocab_fn=spmm_op,
                                    recurrence_fn=rec_op)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jax.tree.map(jnp.asarray, state)
    (jloss, (jout, jns)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, jstate, jb, True), has_aux=True))(jparams)
    tb = ttrainer.batch_to_device(next(iter(TG.GraphLoader(tg, 16))), "cpu")
    hooks = ttrainer.decomposed_hooks(tcfg, ttrainer.TrainConfig(
        fuse_step=False, fuse_recurrence=True))
    assert hooks["recurrence_fn"] is not None
    out, new_state = network_apply_packed(net, tb, fused=False,
                                          training=True, hooks=hooks)
    loss = ttrainer.mse_loss(out, tb["labels"], tb["graph_mask"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    want = {f"params/{k}": np.asarray(v)
            for k, v in tree_to_arrays(jgrads).items()}
    got = _port_grads(net)
    for k in ("params/nafm_bn/weight", "params/nafm_bn/bias"):
        assert np.abs(want[k]).max() > 1e-4, k
    _assert_grads(got, want)
    assign_state(net, new_state)
    got = {k: v for k, v in module_to_jax_arrays(net).items()
           if k.startswith("state/")}
    for k, w in _arrays(params, jns).items():
        if k.startswith("state/"):
            np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("model", ["graph_norm", "encoded"])
def test_per_step_family_spmm_hook_matches_jax(model):
    """The per-step family's training step with the SpMM hook alone (the
    JAX loop calls it once per step, and so does the port's): the loss,
    out, every parameter gradient and running statistic against the JAX
    network with the Pallas SpMM op in interpret mode."""
    jg, tg, jcfg, tcfg, params, state, net = ps_setup(model, seed=3)
    jb, spmm_op, _ = _jax_spmm_batch(jg, 16, False)

    def loss_fn(p):
        out, ns = jax_apply(p, jax.tree.map(jnp.asarray, state), jcfg, jb,
                            training=True, spmm_vocab_fn=spmm_op)
        return jax_ce(out, jb["labels"], jb["graph_mask"]), (out, ns)

    (jloss, (jout, jns)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax.tree.map(jnp.asarray, params))
    tb = ttrainer.batch_to_device(next(iter(TG.GraphLoader(tg, 16))), "cpu")
    hooks = ttrainer.decomposed_hooks(tcfg, ttrainer.TrainConfig(
        fuse_step=False, fuse_recurrence=True))
    assert hooks["recurrence_fn"] is None          # not recurrence_eligible
    out, new_state = network_apply_packed(net, tb, fused=False,
                                          training=True, hooks=hooks)
    loss = ttrainer.ce_loss(out, tb["labels"], tb["graph_mask"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    assert_grads(port_grads(net), {
        f"params/{k}": np.asarray(v)
        for k, v in tree_to_arrays(jgrads).items()}, tcfg.mpnn)
    assign_state(net, new_state)
    got = module_to_jax_arrays(net)
    for k, w in arrays_of(params, jns).items():
        if k.startswith("state/"):
            np.testing.assert_allclose(got[k], w, rtol=2e-4, atol=1e-6,
                                       err_msg=k)


def test_cli_train_spmm_kernel_cpu(tmp_path, capsys):
    """`train --spmm kernel --device cpu --epochs 2` on zoo.lipo as it is:
    the decomposed path trains (finite losses), validates and checkpoints
    every epoch, and the port's `predict` serves the checkpoint."""
    csv = _csv(tmp_path, SMILES[:30])
    ckdir = os.path.join(str(tmp_path), "ck")
    log = os.path.join(str(tmp_path), "log.jsonl")
    tcli.main(["train", "--experiment", "lipo", "--data", csv, "--epochs",
               "2", "--ckpt-dir", ckdir, "--log", log, "--spmm", "kernel",
               "--device", "cpu"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["epochs"] == 2 and np.isfinite(res["test"]["loss"])
    with open(log) as fh:
        steps = [json.loads(x) for x in fh if '"step"' in x]
    assert len(steps) == 2 * 2 and all(np.isfinite(s["loss"])
                                       for s in steps)
    assert "ckpt_1.npz" in os.listdir(ckdir)
    tcli.main(["predict", "--experiment", "lipo", "--data", csv, "--ckpt",
               os.path.join(ckdir, "ckpt_1.npz"), "--device", "cpu"])
    preds = [json.loads(x) for x in capsys.readouterr().out.split("\n") if x]
    assert len(preds) == 30 and all(np.isfinite(p["pred"]) for p in preds)


@pytest.mark.parametrize("experiment", ["adv_classification",
                                        "att_classification"])
def test_spmm_kernel_on_attention_models_names_row_11(tmp_path,
                                                       experiment):
    """The attention models' decomposed path runs the SDDMM kernels (row
    11 of PERF.md's table, ported): `train --spmm kernel` trains them, and
    its per-step losses match the whole-step path's from the same weights
    (the trainer's seed) on the same shuffled batches."""
    csv = os.path.join(str(tmp_path), "cls.csv")
    with open(csv, "w") as fh:
        fh.write("smiles,target\n" + "".join(
            f"{s},{i % 3}\n" for i, s in enumerate(SMILES[:20])))
    losses = []
    for extra in (["--spmm", "kernel"], []):
        log = os.path.join(str(tmp_path), f"log{len(losses)}.jsonl")
        tcli.main(["train", "--experiment", experiment, "--data", csv,
                   "--epochs", "1", "--log", log, "--device", "cpu",
                   *extra])
        with open(log) as fh:
            losses.append([json.loads(x)["loss"] for x in fh
                           if '"step"' in x])
    assert len(losses[0]) == len(losses[1]) >= 1
    np.testing.assert_allclose(losses[0], losses[1], rtol=RTOL)


def test_decomposed_path_refuses_what_it_cannot_run():
    """ecfp_bilinear's decomposed path runs no kernel (in the JAX package
    its message is plain XLA): it raises, naming why."""
    from chip_smoke import bil_cut
    from mpnn_tpu_torch.models import zoo
    csv_rows = [(s, 0) for s in SMILES[:10]]
    gs, _ = TG.encode_molgraphs(TG.generate_molgraphs(
        [s for s, _ in csv_rows], [np.zeros((1, 32), np.float32)] * 10))
    cfg = zoo.build("ecfp_bilinear", afm=2, bfm=8, n_out=32)
    with pytest.raises(NotImplementedError, match="runs no kernel"):
        ttrainer.train(cfg, ttrainer.TrainConfig(
            epochs=1, fuse_step=False, loss="ecfp_mse"), bil_cut(gs),
            device="cpu")
