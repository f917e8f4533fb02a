"""Checkpoints both packages resume: the port's `train` writes the JAX
package's optimizer state (inject_hyperparams' count and learning rate,
scale_by_adam's count and moments at its chain index), and either
package's `train(resume=True)` restarts the other's run from its latest
`ckpt_<epoch>.npz` at the next epoch.

The lipo shell at afm 7, bfm 6, nafm 3 (bench.py's SMILES), depth cut to
T = 3 with a ×3 edge-MLP tail as in tests/test_torch_train.py; Adam at lr
1e-2 with coupled weight decay 1e-4 (so scale_by_adam sits at chain index
1) and the plateau schedule. The port runs its plain versions here.

Tolerances: the optimizer state read back, exactly; the resumed runs'
losses rtol 1e-4, their parameters and running statistics rtol 1e-4 /
atol 1e-4 (tests/test_torch_train.py's LOCK_ATOL) after 3 Adam steps.
message_bias is left out (zero gradient in theory under the message bn1d:
Adam's steps follow float noise; ROADMAP, differences that are not
faults), and the message norm's running mean, which takes its drift in,
is compared with the drift computed from both runs' per-step biases
taken out, as there.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpnn_tpu.train import trainer as jtrainer
from mpnn_tpu.train.checkpoint import load_checkpoint as jax_load
from mpnn_tpu.train.checkpoint import tree_to_arrays
from mpnn_tpu.train.optim import adam as jax_adam
from mpnn_tpu_torch.train import trainer as ttrainer
from mpnn_tpu_torch.train.checkpoint import (load_checkpoint,
                                             load_opt_state,
                                             module_to_jax_arrays,
                                             opt_state_arrays, read_arrays)
from mpnn_tpu_torch.train.optim import adam
from test_torch_train import RTOL, LOCK_ATOL, SMILES, _arrays, _setup

LR, WD = 1e-2, 1e-4
MB = "params/mpnn/message/0/message_bias"
MA_MEAN = "state/mpnn/ma_bn/0/running_mean"


def _jcfg(epochs, ckdir):
    return jtrainer.TrainConfig(
        epochs=epochs, batch_size=8, learning_rate=LR, weight_decay=WD,
        loss="mse", packed=True, plateau=True, seed=317, ckpt_dir=ckdir)


def _tcfg(epochs, ckdir):
    return ttrainer.TrainConfig(
        epochs=epochs, batch_size=8, learning_rate=LR, weight_decay=WD,
        plateau=True, seed=317, ckpt_dir=ckdir)


@pytest.fixture(scope="module")
def setup():
    """(JAX graphs, port graphs, JAX cfg, port cfg, params, state, net)
    on 30 molecules: 16 train the checkpointed epoch (2 steps at batch 8),
    24 the resumed one (3 steps), the last 6 validate."""
    return _setup(SMILES[:30], seed=2)


def _jax_opt_arrays(jcfg, params, ck):
    """The JAX package's optimizer state read from checkpoint `ck` into
    its own template, as `opt_state/` arrays."""
    template = jax_adam(LR, weight_decay=WD).init(params)
    _, _, opt, meta = jax_load(ck, params=params, state=None,
                               opt_state=template)
    return {f"opt_state/{k}": np.asarray(v)
            for k, v in tree_to_arrays(opt).items()}, meta


def _assert_opt_equal(got, want):
    assert set(got) == set(want)
    assert any("/mu/" in k for k in want) and any("/nu/" in k for k in want)
    for k, w in want.items():
        g = np.asarray(got[k])
        # a checkpoint holds the learning rate as float32
        np.testing.assert_array_equal(g, np.asarray(w).astype(g.dtype),
                                      err_msg=k)


def test_port_checkpoint_loads_into_jax(setup, tmp_path):
    """Two port steps, then the JAX package's load_checkpoint with its own
    optimizer template: every mu, nu, count and the learning rate equal
    the port's optimizer state."""
    jg, tg, jcfg, tcfg, params, state, net = setup
    ckdir = str(tmp_path / "ck")
    tnet, _ = ttrainer.train(tcfg, _tcfg(1, ckdir), tg[:16], tg[24:],
                             net=copy.deepcopy(net), device="cpu")
    ck = os.path.join(ckdir, "ckpt_0.npz")
    arrays = read_arrays(ck)
    got, meta = _jax_opt_arrays(jcfg, jax.tree.map(jnp.asarray, params), ck)
    assert meta["epoch"] == 0 and meta["sched"]["lr"] == LR
    assert int(got["opt_state/count"]) == 2
    assert int(got["opt_state/inner_state/1/count"]) == 2
    # the JAX tree holds exactly what the port wrote
    _assert_opt_equal(got, {k: v for k, v in arrays.items()
                            if k.startswith("opt_state/")})
    # and that is the port's live optimizer state, Linear moments
    # transposed
    opt = adam(tnet.parameters(), LR, weight_decay=WD)
    load_opt_state(arrays, tnet, opt)
    _assert_opt_equal(opt_state_arrays(tnet, opt), got)


def test_jax_checkpoint_loads_into_port(setup, tmp_path):
    """Two JAX steps, then the port's load_opt_state: the port's Adam
    holds the JAX run's step, moments and learning rate."""
    jg, tg, jcfg, tcfg, params, state, net = setup
    ckdir = str(tmp_path / "ck")
    _, _, jopt, _ = jtrainer.train(
        jcfg, _jcfg(1, ckdir), jg[:16], jg[24:],
        params=jax.tree.map(jnp.asarray, params),
        state=jax.tree.map(jnp.asarray, state))
    ck = os.path.join(ckdir, "ckpt_0.npz")
    tnet, meta = load_checkpoint(ck, tcfg, device="cpu")
    assert meta["epoch"] == 0
    opt = adam(tnet.parameters(), 1.0, weight_decay=WD)
    load_opt_state(read_arrays(ck), tnet, opt)
    want = {f"opt_state/{k}": np.asarray(v)
            for k, v in tree_to_arrays(jopt).items()}
    assert int(want["opt_state/inner_state/1/count"]) == 2
    _assert_opt_equal(opt_state_arrays(tnet, opt), want)
    assert opt.param_groups[0]["lr"] == pytest.approx(LR)


def _record_bias(monkeypatch):
    """Per-step message_bias of both packages' train steps, and the JAX
    step losses."""
    jlosses, jbias, tbias, tlosses = [], [], [], []
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
        tbias.append(net.mpnn.message[0].message_bias.detach().numpy()
                     .copy())
        loss = real_step(net, *a, **kw)
        tlosses.append(float(loss))
        return loss
    monkeypatch.setattr(ttrainer, "train_step", recording_step)
    return jlosses, jbias, tlosses, tbias


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_resumed_runs_track_each_other(setup, tmp_path, monkeypatch,
                                       writer):
    """One package writes the epoch-0 checkpoint (2 steps); both resume
    it with train(resume=True) for epoch 1 (3 steps on 24 molecules) in
    lockstep: the same losses, parameters and running statistics."""
    jg, tg, jcfg, tcfg, params, state, net = setup
    ckdir = str(tmp_path / "ck")
    if writer == "port":
        ttrainer.train(tcfg, _tcfg(1, ckdir), tg[:16], tg[24:],
                       net=copy.deepcopy(net), device="cpu")
    else:
        jtrainer.train(jcfg, _jcfg(1, ckdir), jg[:16], jg[24:],
                       params=jax.tree.map(jnp.asarray, params),
                       state=jax.tree.map(jnp.asarray, state))
    # each package resumes from its own copy of the directory
    tdir = str(tmp_path / "ck_port")
    os.makedirs(tdir)
    for name in os.listdir(ckdir):
        with open(os.path.join(ckdir, name), "rb") as src, \
                open(os.path.join(tdir, name), "wb") as dst:
            dst.write(src.read())
    jlosses, jbias, tlosses, tbias = _record_bias(monkeypatch)
    jp, js, _, jhist = jtrainer.train(
        jcfg, _jcfg(2, ckdir), jg[:24], jg[24:],
        params=jax.tree.map(jnp.asarray, params),
        state=jax.tree.map(jnp.asarray, state), resume=True)
    tnet, thist = ttrainer.train(tcfg, _tcfg(2, tdir), tg[:24], tg[24:],
                                 resume=True, device="cpu")
    assert [h["epoch"] for h in thist] == [1] and len(jhist) == 1
    assert len(jlosses) == len(tlosses) == 3
    np.testing.assert_allclose(tlosses, jlosses, rtol=RTOL)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(ckdir))
    got = module_to_jax_arrays(tnet)
    want = _arrays(jp, js)
    assert set(got) == set(want)
    np.testing.assert_array_equal(tbias[0], jbias[0])
    a = 0.9 ** tcfg.mpnn.message_steps
    drift = (1 - a) * sum(a ** (len(tbias) - 1 - s) * (tb - jb)
                          for s, (tb, jb) in enumerate(zip(tbias, jbias)))
    got[MA_MEAN] = got[MA_MEAN] - drift
    for k, w in want.items():
        if k != MB:
            np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=LOCK_ATOL,
                                       err_msg=k)
