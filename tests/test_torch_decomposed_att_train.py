"""The attention models' decomposed training path on the CPU against the
JAX package: the port's plain model with the SDDMM hook (kernels/sddmm.py),
the edge-MLP chain op and the set2vec op — each its plain version on CPU
tensors — against the JAX network with the Pallas SDDMM op in interpret
mode (make_sddmm_op(interpret=True, layout="t"), its 128-aligned window
plan) from the same weights: one training step's loss, out and every
parameter gradient; three Adam steps of the port's train(fuse_step=False)
against the JAX package's train(packed=True, spmm="kernel_interpret"); the
`train --spmm kernel` verb; and the hooks a family cannot use raising.

adv and att as tests/test_torch_att_model.py and
tests/test_torch_att_steps_model.py set them up (their widths and 3
message steps, the ×50 edge-MLP tail cut to ×2, weights transplanted from
the JAX init with the leaves the forward never reads perturbed), set2vec
cut to 3 steps: the SDDMM hook is what is under test, and the 100-step
chain only adds float32 rounding (tests/test_torch_att_train.py holds it
at full depth). set2vec's batch-global softmax and att's stateless norm
make each output depend on its batch: every comparison runs on the same
batches. Tolerances as tests/test_torch_decomposed_train.py: losses and
values rtol 1e-4 / atol 1e-5, gradient leaves divided by their max abs
rtol 2e-4 / atol 1e-5, parameters after the Adam steps atol 1e-4; a leaf
the forward never reads (message_bias, adv's agg/att) takes an exactly
zero gradient in both packages.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpnn_tpu import graphs as JG
from mpnn_tpu.kernels.sddmm import make_sddmm_op as jax_sddmm_op
from mpnn_tpu.train import trainer as jtrainer
from mpnn_tpu.train.checkpoint import tree_to_arrays
from mpnn_tpu_torch import graphs as TG
from mpnn_tpu_torch.kernels import sddmm as D
from mpnn_tpu_torch.kernels import set2vec as S2V
from mpnn_tpu_torch.models import zoo as tzoo
from mpnn_tpu_torch.models.network import network_apply_packed, network_init
from mpnn_tpu_torch.models.sparse import sparse_mpnn_apply
from mpnn_tpu_torch.train import cli as tcli
from mpnn_tpu_torch.train import trainer as ttrainer
from mpnn_tpu_torch.train.checkpoint import module_to_jax_arrays
from test_torch_att_model import SMILES
from test_torch_att_model import setup as adv_setup
from test_torch_att_steps_model import setup as att_setup
from test_torch_psteps_model import arrays_of, jax_ce, port_grads

RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL = 2e-4
LOCK_ATOL = 1e-4
SETUPS = {"adv": adv_setup, "att": att_setup}
S2V_STEPS = 3


def _setup(model, smiles, seed):
    return SETUPS[model](smiles, seed=seed, set2vec_steps=S2V_STEPS)


def _jax_sddmm_batch(jg, n):
    """The first packed batch of n with the SDDMM's 128-aligned window
    plan (the transposed layout's), and the Pallas op (interpret mode)
    sized to it: without a plan the JAX model takes its XLA gather."""
    loader = JG.GraphLoader(jg, n, collate="packed", use_native=False,
                            spmm_plan=True, spmm_block_edges=256,
                            spmm_align=128)
    b = next(iter(loader))
    assert "spmm_win" in b
    op = jax_sddmm_op(block_edges=loader.spmm_block_edges,
                      window=loader.spmm_window, interpret=True,
                      layout="t")
    jb = {k: (jnp.asarray(v) if not np.isscalar(v) else v)
          for k, v in b.items() if k != "num_graphs"}
    return jb, op


def _assert_grads(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        scale = float(np.abs(w).max())
        if scale == 0.0:                 # a leaf the forward never reads
            assert not g.any(), k
            continue
        np.testing.assert_allclose(g / scale, w / scale, rtol=GRAD_RTOL,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("model", ["adv", "att"])
def test_sddmm_hook_step_matches_jax(model):
    """One training step (cross entropy) of the port's plain model with
    the decomposed hooks — the SDDMM once per message network (adv's
    shared network once), the chain op, the set2vec op — against the JAX
    network's loss with the Pallas SDDMM op: the loss, out and every
    parameter gradient."""
    jg, tg, jcfg, tcfg, params, state, net = _setup(model, SMILES[:16], 5)
    jb, op = _jax_sddmm_batch(jg, 16)
    loss_fn = jtrainer.make_loss_fn(jcfg, "ce", sddmm_fn=op)
    (jloss, (jout, _)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, jax.tree.map(jnp.asarray, state), jb, True),
        has_aux=True))(jax.tree.map(jnp.asarray, params))
    tb = ttrainer.batch_to_device(next(iter(TG.GraphLoader(tg, 16))), "cpu")
    hooks = ttrainer.decomposed_hooks(tcfg, ttrainer.TrainConfig(
        fuse_step=False))
    assert set(hooks) == {"sddmm_fn", "edge_mlp_fn", "set2vec_fn"}
    calls = []
    sddmm_fn = hooks["sddmm_fn"]

    def counting(*a):
        calls.append(a[0].shape)
        return sddmm_fn(*a)
    hooks["sddmm_fn"] = counting
    out, new_state = network_apply_packed(net, tb, fused=False,
                                          training=True, hooks=hooks)
    assert new_state == {"mpnn": {}}
    assert len(calls) == (1 if tcfg.mpnn.share_message_weights
                          else tcfg.mpnn.message_steps)
    loss = ttrainer.ce_loss(out, tb["labels"], tb["graph_mask"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    _assert_grads(port_grads(net), {f"params/{k}": np.asarray(v) for k, v
                                    in tree_to_arrays(jgrads).items()})


@pytest.mark.parametrize("model", ["adv", "att"])
def test_lockstep_three_adam_steps_decomposed_att(monkeypatch, tmp_path,
                                                  model):
    """Three Adam steps (lr 1e-2, coupled weight decay 1e-4, cross
    entropy, shuffled batches of 40, seed 317) through the port's
    decomposed train() and the JAX package's train() with the Pallas SDDMM
    op in interpret mode, from the same weights, then validation through
    the eval path: per-step losses, every parameter after step 3, the
    validation loss. Every JAX step gets the SDDMM op and every JAX batch
    carries the window plan (a batch without it takes the XLA gather, and
    the test would compare plain with plain)."""
    smiles = (SMILES * 9)[:136]
    jg, tg, jcfg, tcfg, params, state, net = _setup(model, smiles, 6)
    jlosses = []
    real_make = jtrainer.make_train_step

    def recording_make(*a, **kw):
        assert kw["sddmm_fn"] is not None
        step = real_make(*a, **kw)

        def rec(*sa):
            assert "spmm_win" in sa[3]
            out = step(*sa)
            jlosses.append(float(out[0]))
            return out
        return rec
    monkeypatch.setattr(jtrainer, "make_train_step", recording_make)
    real_step = ttrainer.train_step

    def recording_step(*a, **kw):
        assert kw["hooks"]["sddmm_fn"] is not None
        return real_step(*a, **kw)
    monkeypatch.setattr(ttrainer, "train_step", recording_step)
    kw = dict(epochs=1, batch_size=40, learning_rate=1e-2,
              weight_decay=1e-4, loss="ce", seed=317)
    jp, js, _, jhist = jtrainer.train(
        jcfg, jtrainer.TrainConfig(packed=True, spmm="kernel_interpret",
                                   **kw),
        jg[:120], jg[120:], params=jax.tree.map(jnp.asarray, params),
        state=jax.tree.map(jnp.asarray, state), with_nafm=False)
    log = str(tmp_path / "train.jsonl")
    D.reset_launch_counts()
    S2V.reset_launch_counts()
    tnet, thist = ttrainer.train(
        tcfg, ttrainer.TrainConfig(log_path=log, fuse_step=False, **kw),
        tg[:120], tg[120:], net=net, device="cpu")
    # CPU tensors: the plain versions, no kernel launch
    assert set(D.launch_counts.values()) | set(S2V.launch_counts.values()) \
        == {0}
    with open(log) as fh:
        tlosses = [json.loads(x)["loss"] for x in fh if '"step"' in x]
    assert len(jlosses) == len(tlosses) == 3
    np.testing.assert_allclose(tlosses, jlosses, rtol=RTOL)
    got, want = module_to_jax_arrays(tnet), arrays_of(jp, js)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=LOCK_ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(thist[0]["val_loss"], jhist[0]["val_loss"],
                               rtol=RTOL)


def _cls_csv(tmp_path, n):
    csv = os.path.join(str(tmp_path), "cls.csv")
    with open(csv, "w") as fh:
        fh.write("smiles,target\n" + "".join(
            f"{s},{i % 3}\n" for i, s in enumerate((SMILES * 3)[:n])))
    return csv


@pytest.mark.parametrize("experiment", ["adv_classification",
                                        "att_classification"])
def test_cli_train_spmm_kernel_attention_cpu(tmp_path, capsys, experiment):
    """`train --spmm kernel --device cpu` on the zoo model as it is (×50
    tail, 100 set2vec steps): the decomposed path trains (finite losses),
    validates and checkpoints, and the port's `predict` serves the
    checkpoint."""
    csv = _cls_csv(tmp_path, 30)
    ckdir = os.path.join(str(tmp_path), "ck")
    log = os.path.join(str(tmp_path), "log.jsonl")
    tcli.main(["train", "--experiment", experiment, "--data", csv,
               "--epochs", "1", "--ckpt-dir", ckdir, "--log", log,
               "--spmm", "kernel", "--device", "cpu"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["epochs"] == 1 and np.isfinite(res["test"]["loss"])
    with open(log) as fh:
        steps = [json.loads(x) for x in fh if '"step"' in x]
    assert len(steps) == 2 and all(np.isfinite(s["loss"]) for s in steps)
    ck = sorted(f for f in os.listdir(ckdir) if f.endswith(".npz"))
    tcli.main(["predict", "--experiment", experiment, "--data", csv,
               "--ckpt", os.path.join(ckdir, ck[-1]), "--device", "cpu"])
    preds = [json.loads(x) for x in capsys.readouterr().out.split("\n") if x]
    assert len(preds) == 30 and all(np.isfinite(p["logits"]).all()
                                    for p in preds)


def _hook(*a, **kw):
    raise AssertionError("a refused hook was called")


# (zoo model, widths, hook, the family the error names); each hook is one
# the family's loop has no place for, which sparse_mpnn_apply used to drop
REFUSED = [
    ("adv", dict(afm=7, bfm=6), "spmm_vocab_fn", "attention"),
    ("att", dict(afm=7, bfm=6), "recurrence_fn", "attention"),
    ("att", dict(afm=7, bfm=6, readout="graph_level"), "set2vec_fn",
     "attention"),
    ("ecfp_bilinear", dict(afm=2, bfm=8), "sddmm_fn", "bilinear"),
    ("ecfp_bilinear", dict(afm=2, bfm=8), "edge_mlp_fn", "bilinear"),
    ("lipo", dict(afm=7, bfm=6, nafm=3), "sddmm_fn", "shared edge-network"),
    ("lipo", dict(afm=7, bfm=6, nafm=3), "set2vec_fn",
     "shared edge-network"),
    ("graph_norm", dict(afm=7, bfm=6, nafm=3), "recurrence_fn",
     "per-step edge-network"),
]


@pytest.mark.parametrize("model,widths,hook,family", REFUSED)
def test_unusable_hook_raises(model, widths, hook, family):
    """A hook the config's family cannot use raises, naming the hook and
    the family, before the forward runs: none is silently dropped."""
    import dataclasses
    readout = widths.pop("readout", None)
    cfg = tzoo.build(model, n_out=4 if model != "ecfp_bilinear" else 32,
                     **widths)
    if readout:
        cfg = dataclasses.replace(cfg, mpnn=dataclasses.replace(
            cfg.mpnn, readout=readout))
    net = network_init(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match=f"the {family} family cannot use "
                                         f"the {hook} hook"):
        sparse_mpnn_apply(net.mpnn, {}, training=True, **{hook: _hook})
