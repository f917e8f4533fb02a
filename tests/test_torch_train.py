"""The training slice on the CPU against the JAX package: three Adam steps
in lockstep through both packages' train(), the host pieces of the loop
(split, shuffled loader), and the `train` verb's checkpoint served by the
JAX package's `predict`; the helpers that tests/test_torch_train_network.py
shares (the network's training step, the in-kernel-loss flavor).

The port runs its plain versions here (the training op's is
fused_step_reference under autograd); the JAX side runs its whole-step
training op in interpret mode, or its plain XLA path. The network is the
lipo shell at its widths with depth cut to T = 3 and a ×3 edge-MLP tail,
except in the CLI test, which trains zoo.lipo as it is.

Tolerances: forward values rtol 1e-4 / atol 1e-5 and gradient leaves,
each divided by its max abs, rtol 2e-4 / atol 1e-5 (float32 on both sides,
batch-wide sums in other orders); running statistics rtol 2e-4 /
atol 1e-6. message_bias has zero gradient in theory under the message
bn1d: its gradient is held to an absolute bound, and its value after Adam
steps (where noise-level gradients take ±lr steps) is not compared; the
message norm's running mean, which takes that drift in, is compared with
the drift computed from both runs' per-step biases taken out.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.model_selection import train_test_split as sk_split

import bench
from mpnn_tpu import graphs as JG
from mpnn_tpu.models import zoo as jzoo
from mpnn_tpu.models.network import network_init as jax_init
from mpnn_tpu.train import cli as jcli
from mpnn_tpu.train import trainer as jtrainer
from mpnn_tpu.train.checkpoint import tree_to_arrays
from mpnn_tpu_torch import graphs as TG
from mpnn_tpu_torch.models import zoo as tzoo
from mpnn_tpu_torch.train import cli as tcli
from mpnn_tpu_torch.train import trainer as ttrainer
from mpnn_tpu_torch.train.checkpoint import (jax_key_map,
                                             module_to_jax_arrays,
                                             params_from_jax_arrays)
from mpnn_tpu_torch.train.split import train_test_split

RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL = 2e-4
# parameters after the lockstep's Adam steps: 1% of one step at lr 1e-2.
# Adam divides by the gradient's own scale, so an element whose gradient is
# at float-noise level takes a noise-driven step, a fraction of lr
LOCK_ATOL = 1e-4
SMILES = bench.SMILES + ["C", "O", "CCO"] + bench.SMILES[:8] + [
    "CCN", "c1ccccc1", "CC(=O)O"] + bench.SMILES[3:10]


def _cut(cfg):
    """The lipo shell at its widths, depth cut to T = 3 and a ×3 tail."""
    return dataclasses.replace(cfg, mpnn=dataclasses.replace(
        cfg.mpnn, message_steps=3, edge_mlp_tail_repeats=3))


def _perturb(params, state, rng):
    """Random affine norms and running statistics on top of the JAX init
    (which leaves them at 1/0 and would hide a swapped statistic)."""
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)

    def bn(p, s, f):
        p["weight"] = (1 + 0.2 * rng.randn(f)).astype(np.float32)
        p["bias"] = (0.2 * rng.randn(f)).astype(np.float32)
        s["running_mean"] = (0.3 * rng.randn(f)).astype(np.float32)
        s["running_var"] = (0.3 + rng.rand(f)).astype(np.float32)
    m, ms = params["mpnn"], state["mpnn"]
    for key in ("ma_bn", "bn"):
        bn(m[key][0], ms[key][0], m[key][0]["weight"].shape[0])
    for key in ("nafm_bn", "head_bn"):
        bn(params[key], state[key], params[key]["weight"].shape[0])
    return params, state


def _setup(smiles, seed=0):
    """(JAX graphs, port graphs, JAX cfg, port cfg, params, state, port
    net transplanted from them)."""
    labels = [0.3 * np.sin(i) for i in range(len(smiles))]
    jg, ge = JG.encode_molgraphs(JG.generate_molgraphs(smiles, labels))
    tg, _ = TG.encode_molgraphs(TG.generate_molgraphs(smiles, labels))
    afm, bfm = ge.atom_width(), ge.bond_width()
    jcfg, tcfg = _cut(jzoo.lipo(afm, bfm, 3)), _cut(tzoo.lipo(afm, bfm, 3))
    params, state = jax_init(jax.random.PRNGKey(seed), jcfg)
    params, state = _perturb(params, state, np.random.RandomState(seed))
    net = params_from_jax_arrays(_arrays(params, state), tcfg, "cpu")
    return jg, tg, jcfg, tcfg, params, state, net


def _arrays(params, state):
    out = {f"params/{k}": np.asarray(v)
           for k, v in tree_to_arrays(params).items()}
    out.update({f"state/{k}": np.asarray(v)
                for k, v in tree_to_arrays(state).items()})
    return out


def _port_grads(net):
    """The port's parameter gradients, keyed and laid out as JAX leaves."""
    return {k: (t.grad.t() if tr else t.grad).numpy()
            for k, (t, tr) in jax_key_map(net).items()
            if k.startswith("params/")}


def _assert_grads(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if k.endswith("message_bias"):
            assert np.abs(g - w).max() <= ATOL, k
            continue
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g / scale, w / scale, rtol=GRAD_RTOL,
                                   atol=ATOL, err_msg=k)


def test_lockstep_three_adam_steps(monkeypatch, tmp_path):
    """Three Adam steps (lr 1e-2, coupled weight decay 1e-4, shuffled
    batches of 8, seed 317) through the port's train() and the JAX
    package's trainer.train() from the same weights, then validation and
    the plateau schedule: per-step losses, the validation loss and every
    parameter and running statistic after step 3 agree."""
    smiles = SMILES[:30]
    jg, tg, jcfg, tcfg, params, state, net = _setup(smiles, seed=1)
    jlosses, jbias, tbias = [], [], []
    real_make = jtrainer.make_train_step

    def recording_make(*a, **kw):
        step = real_make(*a, **kw)

        def rec(*sa):
            jbias.append(np.asarray(sa[0]["mpnn"]["message"][0]
                                    ["message_bias"]))
            out = step(*sa)
            jlosses.append(float(out[0]))
            return out
        return rec
    monkeypatch.setattr(jtrainer, "make_train_step", recording_make)
    real_step = ttrainer.train_step

    def recording_step(net, *a, **kw):
        tbias.append(net.mpnn.message[0].message_bias.detach().numpy().copy())
        return real_step(net, *a, **kw)
    monkeypatch.setattr(ttrainer, "train_step", recording_step)
    jp, js, _, jhist = jtrainer.train(
        jcfg, jtrainer.TrainConfig(
            epochs=1, batch_size=8, learning_rate=1e-2, weight_decay=1e-4,
            loss="mse", packed=True, plateau=True, seed=317),
        jg[:24], jg[24:], params=jax.tree.map(jnp.asarray, params),
        state=jax.tree.map(jnp.asarray, state))
    log = str(tmp_path / "train.jsonl")
    tnet, thist = ttrainer.train(
        tcfg, ttrainer.TrainConfig(
            epochs=1, batch_size=8, learning_rate=1e-2, weight_decay=1e-4,
            plateau=True, seed=317, log_path=log),
        tg[:24], tg[24:], net=net, device="cpu")
    with open(log) as fh:
        recs = [json.loads(x) for x in fh]
    tlosses = [r["loss"] for r in recs if "step" in r]
    assert recs[-1] == thist[0]
    assert len(jlosses) == len(tlosses) == 3
    np.testing.assert_allclose(tlosses, jlosses, rtol=RTOL)
    assert thist[0]["lr"] == pytest.approx(jhist[0]["lr"]) == 1e-2
    got = module_to_jax_arrays(tnet)
    want = _arrays(jp, js)
    assert set(got) == set(want)
    # message_bias follows its noise-level gradient (±lr Adam steps), so
    # its value is not compared. The message norm's running mean takes
    # that drift in exactly: the batch mean of the messages is shifted by
    # the bias of each step's forward, and nothing else in the training
    # forward sees the bias. With a = 0.9**T (the T-fold EMA per step),
    # the drift after the last step is (1 − a)·Σ_s a**(S−s)·Δbias_s; it is
    # taken out before the comparison
    mb = "params/mpnn/message/0/message_bias"
    ma_mean = "state/mpnn/ma_bn/0/running_mean"
    assert len(jbias) == len(tbias) == 3
    np.testing.assert_array_equal(tbias[0], jbias[0])
    a = 0.9 ** tcfg.mpnn.message_steps
    drift = (1 - a) * sum(a ** (len(tbias) - 1 - s) * (tb - jb)
                          for s, (tb, jb) in enumerate(zip(tbias, jbias)))
    got[ma_mean] = got[ma_mean] - drift
    for k, w in want.items():
        if k != mb:
            np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=LOCK_ATOL,
                                       err_msg=k)
    # eval mode normalizes by the running statistics, so message_bias no
    # longer cancels there: with the JAX run's message_bias and message
    # running mean the port's validation reproduces the JAX run's
    assert np.isfinite(thist[0]["val_loss"])
    with torch.no_grad():
        tnet.mpnn.message[0].message_bias.copy_(torch.tensor(want[mb]))
        tnet.mpnn.ma_bn[0].running_mean.copy_(torch.tensor(want[ma_mean]))
    val = ttrainer.evaluate(tnet, TG.GraphLoader(tg[24:], 8), "mse",
                            device="cpu")
    np.testing.assert_allclose(val["loss"], jhist[0]["val_loss"], rtol=RTOL)


@pytest.mark.parametrize("wd", [0.0, 1e-4])
def test_adam_matches_jax(wd):
    """adam(): torch's Adam with coupled weight decay against the JAX
    package's optax chain on the same parameters and gradients (five steps,
    gradients over four decades, the learning rate cut after step 3 as the
    plateau schedule cuts it)."""
    import optax
    from mpnn_tpu.train import optim as jopt
    from mpnn_tpu_torch.train import optim as topt
    rng = np.random.RandomState(3)
    p0 = rng.randn(7, 5).astype(np.float32)
    grads = [(s * rng.randn(7, 5)).astype(np.float32)
             for s in (1.0, 0.1, 10.0, 1.0, 1e-3)]
    jo = jopt.adam(1e-2, weight_decay=wd)
    jp = jnp.asarray(p0)
    js = jo.init(jp)
    tp = torch.nn.Parameter(torch.tensor(p0))
    to = topt.adam([tp], 1e-2, weight_decay=wd)
    for i, g in enumerate(grads):
        if i == 3:
            js = jopt.set_learning_rate(js, 1e-3)
            topt.set_learning_rate(to, 1e-3)
        upd, js = jo.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.tensor(g)
        to.step()
    assert topt.get_learning_rate(to) == pytest.approx(
        jopt.get_learning_rate(js)) == 1e-3
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kw", [
    {}, {"mode": "max", "threshold_mode": "abs", "threshold": 1e-3,
         "cooldown": 2, "min_lr": 2e-4, "patience": 3}])
def test_plateau_schedule_matches_jax(kw):
    """The port's ReduceLROnPlateau against the JAX package's on one metric
    sequence: gains, stalls inside the threshold, and noise; the same
    learning rate after every epoch, cut at least twice."""
    from mpnn_tpu.train.optim import ReduceLROnPlateau as JPlateau
    from mpnn_tpu_torch.train.optim import ReduceLROnPlateau as TPlateau
    rng = np.random.RandomState(0)
    metrics = list(1.0 - 0.01 * np.arange(5)) + [0.96 * (1 - 5e-5)] * 14 \
        + list(0.5 + 0.1 * rng.rand(60))
    if kw.get("mode") == "max":
        metrics = [-m for m in metrics]
    j, t = JPlateau(1e-2, **kw), TPlateau(1e-2, **kw)
    got = [t.step(m) for m in metrics]
    assert got == [j.step(m) for m in metrics]
    assert len(set(got)) >= 3
    assert t.state_dict() == {k: getattr(j, k) for k in t.state_dict()}


@pytest.mark.parametrize("n,seed", [(10, 317), (37, 317), (1000, 0),
                                    (4200, 317), (4199, 5)])
def test_split_matches_sklearn(n, seed):
    xs = list(range(n))
    assert list(train_test_split(xs, 0.1, seed)) == sk_split(
        xs, test_size=0.1, random_state=seed)


def test_shuffled_loader_matches_jax():
    """GraphLoader(shuffle=True, seed=317): the same batches, array for
    array, as the JAX package's over two epochs."""
    smiles = (SMILES * 2)[:45]
    jg, _ = JG.encode_molgraphs(JG.generate_molgraphs(smiles, [0.0] * 45))
    tg, _ = TG.encode_molgraphs(TG.generate_molgraphs(smiles, [0.0] * 45))
    jl = JG.GraphLoader(jg, 8, shuffle=True, seed=317, collate="packed",
                        use_native=False)
    tl = TG.GraphLoader(tg, 8, shuffle=True, seed=317)
    for _ in range(2):
        jbs, tbs = list(jl), list(tl)
        assert len(jbs) == len(tbs) == 6
        for jb, tb in zip(jbs, tbs):
            for k, v in jb.items():
                if k == "num_graphs":
                    assert int(v) == int(tb[k])
                    continue
                np.testing.assert_array_equal(np.asarray(tb[k]),
                                              np.asarray(v), err_msg=k)


def _csv(tmp_path, smiles):
    path = os.path.join(str(tmp_path), "lipo.csv")
    pd.DataFrame({"smiles": smiles,
                  "exp": [0.5 * np.cos(i) for i in range(len(smiles))]}
                 ).to_csv(path, index=False)
    return path


def test_cli_train_checkpoint_served_by_jax_predict(tmp_path, capsys):
    """`train --device cpu --epochs 2` on zoo.lipo as it is: one
    checkpoint per epoch, which the JAX package's `predict` and the port's
    `predict` serve with the same predictions."""
    csv = _csv(tmp_path, SMILES[:30])
    ckdir = os.path.join(str(tmp_path), "ck")
    tcli.main(["train", "--experiment", "lipo", "--data", csv, "--epochs",
               "2", "--ckpt-dir", ckdir, "--device", "cpu"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["epochs"] == 2 and np.isfinite(res["test"]["loss"])
    assert np.isfinite(res["last"]["val_loss"])
    assert sorted(os.listdir(ckdir)) == [
        "ckpt_0.npz", "ckpt_0.npz.meta.json", "ckpt_1.npz",
        "ckpt_1.npz.meta.json"]
    ckpt = os.path.join(ckdir, "ckpt_1.npz")
    jcli.main(["predict", "--experiment", "lipo", "--data", csv, "--ckpt",
               ckpt, "--packed"])
    jl = [json.loads(x) for x in capsys.readouterr().out.split("\n") if x]
    tcli.main(["predict", "--experiment", "lipo", "--data", csv, "--ckpt",
               ckpt, "--device", "cpu"])
    tl = [json.loads(x) for x in capsys.readouterr().out.split("\n") if x]
    assert [r["index"] for r in tl] == [r["index"] for r in jl] \
        == list(range(30))
    np.testing.assert_allclose([r["pred"] for r in tl],
                               [r["pred"] for r in jl], rtol=RTOL,
                               atol=ATOL)


def test_train_verb_defaults_to_cuda(tmp_path):
    """Without --device the verb asks for the card; on a host without one
    it raises before it reads the data."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["train", "--experiment", "lipo", "--data",
                   os.path.join(str(tmp_path), "absent.csv")])
