"""The ECFP task on the CPU against the JAX package: the per-atom Morgan
bits, their packing onto the node axis, the ecfp_mse loss (the exact
per-graph collapse), the encoded_ecfp network's eval with its output norm
(obn) through the port's per-step op and its plain model, three Adam steps
in lockstep with the JAX package's train(), and JAX-written checkpoints
served by the port's `predict` at the experiment's 16,384 bits.

The JAX side runs its network with the MPNN core through the Pallas
per-step eval op in interpret mode (eval) or its packed XLA path
(train). Depth as the zoo has it (T 3), the edge-MLP tail cut to ×2,
every norm, running statistic and message bias perturbed, obn's too.

Tolerances: forward values rtol 1e-4 / atol 1e-5 (float32 on both sides,
sums in other orders); losses rtol 1e-4 (1e-6 for the loss alone on the
same `out`); parameters after three Adam steps rtol 1e-4 / atol 2e-5,
running statistics rtol 2e-4 / atol 1e-6. The leaves whose gradient is
zero in theory (ROADMAP §3.3: each step's message_bias under the message
bn1d, the encoders' last bias under the input bn1d) follow noise-level
gradients; they and the running means that take their drift are handled
as tests/test_torch_psteps_train.py handles them.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from mpnn_tpu import graphs as JG
from mpnn_tpu.chem import mol_from_smiles as jax_mol
from mpnn_tpu.chem.ecfp import ecfp_bits_per_atom as jax_bits
from mpnn_tpu.models import zoo as jzoo
from mpnn_tpu.models.fused_train import make_fused_eval_for_batch
from mpnn_tpu.models.network import network_apply_packed as jax_apply
from mpnn_tpu.models.network import network_init as jax_init
from mpnn_tpu.train import cli as jcli
from mpnn_tpu.train import trainer as jtrainer
from mpnn_tpu.train.checkpoint import save_checkpoint as jax_save
from mpnn_tpu_torch import graphs as TG
from mpnn_tpu_torch.chem import mol_from_smiles as port_mol
from mpnn_tpu_torch.chem.ecfp import ecfp_bits_per_atom as port_bits
from mpnn_tpu_torch.models import zoo as tzoo
from mpnn_tpu_torch.models.network import network_apply_packed
from mpnn_tpu_torch.train import cli as tcli
from mpnn_tpu_torch.train import trainer as ttrainer
from mpnn_tpu_torch.train.checkpoint import (module_to_jax_arrays,
                                             params_from_jax_arrays)
from test_torch_psteps_model import arrays_of, cut, jax_batch, perturb

RTOL, ATOL = 1e-4, 1e-5
LOCK_ATOL = 2e-5
NBITS = 64
SMILES = bench.SMILES + ["C", "O", "CCO", "CCN", "c1ccccc1", "CC(=O)O",
                         "C#N", "C=CC=O", "CCOC", "CCCC"]


def ecfp_graphs(smiles, nbits, tmp_path):
    """(JAX graphs, port graphs, the port's encoder): labels are each
    atom's Morgan bits at radius 3, the port's through its CSV loader."""
    raw = []
    for s in smiles:
        mol = jax_mol(s)
        g = JG.from_mol(mol, label=0.0)
        g.label = jax_bits(mol, radius=3, nbits=nbits)
        raw.append(g)
    jg, _ = JG.encode_molgraphs(raw)
    csv = os.path.join(str(tmp_path), "ecfp.csv")
    with open(csv, "w") as fh:
        fh.write("smiles,target\n" + "".join(f"{s},0\n" for s in smiles))
    tg, ge = TG.load_ecfp_dataset(csv, "smiles", "target", nbits=nbits)
    for a, b in zip(jg, tg):
        np.testing.assert_array_equal(a.label, b.label)
    return jg, tg, ge


def setup(tmp_path, smiles=SMILES[:16], seed=0, nbits=NBITS):
    """(JAX graphs, port graphs, JAX cfg, port cfg, params, state, port
    net transplanted from them) of encoded_ecfp at `nbits`, every norm
    (obn among them) perturbed."""
    jg, tg, ge = ecfp_graphs(smiles, nbits, tmp_path)
    kw = dict(afm=ge.atom_width(), bfm=ge.bond_width(), n_out=nbits)
    jcfg = cut(jzoo.build("encoded_ecfp", **kw))
    tcfg = cut(tzoo.build("encoded_ecfp", **kw))
    params, state = jax_init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.RandomState(seed)
    params, state = perturb(params, state, rng)
    p, s = params["mpnn"]["obn"], state["mpnn"]["obn"]
    p["weight"] = (1 + 0.3 * rng.randn(32)).astype(np.float32)
    p["bias"] = (0.3 * rng.randn(32)).astype(np.float32)
    s["running_mean"] = (0.5 * rng.randn(32)).astype(np.float32)
    s["running_var"] = (0.3 + rng.rand(32)).astype(np.float32)
    net = params_from_jax_arrays(arrays_of(params, state), tcfg, "cpu")
    return jg, tg, jcfg, tcfg, params, state, net


@pytest.mark.parametrize("radius,nbits", [(3, 16384), (2, 64), (1, 7)])
def test_ecfp_bits_match_jax(radius, nbits):
    """ecfp_bits_per_atom bit for bit: the (atoms, nbits) float32 matrix."""
    for s in SMILES + ["[NH4+]", "OC[C@H]1OC(O)[C@H](O)[C@@H](O)[C@@H]1O"]:
        want = jax_bits(jax_mol(s), radius=radius, nbits=nbits)
        got = port_bits(port_mol(s), radius=radius, nbits=nbits)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=s)
        assert got.any()


def test_node_labels_packed_as_jax(tmp_path):
    """collate_packed puts each atom's bits on its node row (zeros at the
    padded and dummy rows, the label's dtype) exactly as the JAX package
    does; the per-graph labels are zeros; a batch of scalar labels has no
    node_labels."""
    jg, tg, _ = ecfp_graphs(SMILES[:12], NBITS, tmp_path)
    jb = JG.collate_packed(jg).as_dict()
    tb = TG.collate_packed(tg).as_dict()
    assert set(tb) == set(jb)
    for k in ("node_labels", "labels", "node_mask", "node_graph"):
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    assert tb["node_labels"].dtype == np.float32
    n = sum(g.num_atoms for g in tg)
    assert tb["node_labels"].shape[1] == NBITS and not tb["node_labels"][
        n:].any()
    loader = next(iter(TG.GraphLoader(tg, 12)))
    np.testing.assert_array_equal(loader["node_labels"], jb["node_labels"][
        :loader["node_labels"].shape[0]])
    plain, _ = TG.encode_molgraphs(TG.generate_molgraphs(SMILES[:4],
                                                         [0.1] * 4))
    assert "node_labels" not in TG.collate_packed(plain).as_dict()


def test_ecfp_mse_matches_jax(tmp_path):
    """ecfp_mse on the same `out` as the JAX package's make_loss_fn (its
    packed branch, eval mode), and against the literal per-atom mean of
    (sigmoid(out_g) − y_v)² over the real atoms."""
    jg, tg, jcfg, _, params, state, _ = setup(tmp_path)
    jb = jax_batch(jg, 16)
    loss_fn = jtrainer.make_loss_fn(jcfg, "ecfp_mse")
    jloss, (jout, _) = loss_fn(jax.tree.map(jnp.asarray, params),
                               jax.tree.map(jnp.asarray, state), jb, False)
    tb = ttrainer.batch_to_device(next(iter(TG.GraphLoader(tg, 16))), "cpu")
    out = torch.tensor(np.asarray(jout))
    got = ttrainer.batch_loss("ecfp_mse", out, tb)
    np.testing.assert_allclose(float(got), float(jloss), rtol=1e-6)
    real = tb["node_mask"][:, 0] > 0
    p = torch.sigmoid(out.double())[tb["node_graph"][real].long()]
    literal = ((p - tb["node_labels"][real].double()) ** 2).mean()
    np.testing.assert_allclose(float(got), float(literal), rtol=1e-6)


@pytest.mark.parametrize("fused", [True, False])
def test_encoded_ecfp_eval_matches_jax(fused, tmp_path):
    """Serving with obn: the JAX network (per-step eval op in interpret
    mode, obn in XLA after it) against the port's network with its MPNN
    core through fused_psteps_eval + obn (fused=True) or the plain sparse
    model (fused=False)."""
    jg, tg, jcfg, _, params, state, net = setup(tmp_path)
    jb = jax_batch(jg, 16)
    op = make_fused_eval_for_batch(jcfg.mpnn, jb, interpret=True)
    jout, _ = jax_apply(jax.tree.map(jnp.asarray, params),
                        jax.tree.map(jnp.asarray, state), jcfg, jb,
                        training=False, eval_op=op)
    tb = ttrainer.batch_to_device(next(iter(TG.GraphLoader(tg, 16))), "cpu")
    with torch.no_grad():
        out = network_apply_packed(net, tb, fused=fused)
    assert out.shape == (16, NBITS) and np.abs(np.asarray(jout)).max() > 1e-2
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=RTOL,
                               atol=ATOL)
    with torch.no_grad():                            # obn is on the path
        net.mpnn.obn.running_mean.add_(1.0)
        moved = network_apply_packed(net, tb, fused=fused)
    assert not torch.allclose(moved, out)


def test_lockstep_three_adam_steps_encoded_ecfp(monkeypatch, tmp_path):
    """Three Adam steps (lr 1e-3, coupled weight decay 1e-5, ecfp_mse at
    nbits 64, shuffled batches of 8, seed 317) of encoded_ecfp through the
    port's train() and the JAX package's trainer.train() (packed XLA
    path) from the same weights, then validation: per-step losses, every
    parameter and running statistic after step 3 (obn's among them), and
    the validation loss."""
    jg, tg, jcfg, tcfg, params, state, net = setup(
        tmp_path, (SMILES * 2)[:30], seed=3)
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
              weight_decay=1e-5, loss="ecfp_mse", seed=317)
    jp, js, _, jhist = jtrainer.train(
        jcfg, jtrainer.TrainConfig(packed=True, **kw), jg[:24], jg[24:],
        params=jax.tree.map(jnp.asarray, params),
        state=jax.tree.map(jnp.asarray, state), with_nafm=False)
    log = os.path.join(str(tmp_path), "train.jsonl")
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
    # noise-level gradients; their norm's running mean takes the drift
    # exactly: one EMA update per step
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
    for k in ("params/mpnn/obn/weight", "state/mpnn/obn/running_var",
              "params/head/0/w"):
        assert not np.array_equal(want[k], before[k]), k
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
    val = ttrainer.evaluate(tnet, TG.GraphLoader(tg[24:], 8), "ecfp_mse",
                            device="cpu")
    assert set(val) == {"loss"}
    np.testing.assert_allclose(val["loss"], jhist[0]["val_loss"], rtol=RTOL)


def test_jax_checkpoint_served_by_port_predict(tmp_path, capsys):
    """A JAX-written encoded_ecfp checkpoint at the experiment's 16,384
    bits (perturbed weights, obn's too) served by the port's `predict
    --experiment encoded_ecfp` and by the JAX package's (packed XLA
    path): the same records {"index", "pred"} (each molecule's first
    logit, as the JAX verb prints), and the port's full rows against the
    JAX network's."""
    smiles = SMILES[:12]
    csv = os.path.join(str(tmp_path), "new.csv")
    with open(csv, "w") as fh:
        fh.write("smiles,target\n" + "".join(f"{s},0\n" for s in smiles))
    gs, ge = TG.load_ecfp_dataset(csv, "smiles", "target")
    assert gs[0].label.shape[1] == 16384
    kw = dict(afm=ge.atom_width(), bfm=ge.bond_width(), n_out=16384)
    jcfg = jzoo.build("encoded_ecfp", **kw)
    params, state = jax_init(jax.random.PRNGKey(5), jcfg)
    params, state = perturb(params, state, np.random.RandomState(5))
    ckpt = os.path.join(str(tmp_path), "jax.npz")
    jax_save(ckpt, params=params, state=state)
    args = ["predict", "--experiment", "encoded_ecfp", "--data", csv,
            "--ckpt", ckpt]
    jcli.main(args + ["--packed"])
    jl = [json.loads(x) for x in capsys.readouterr().out.split("\n") if x]
    tcli.main(args + ["--device", "cpu"])
    tl = [json.loads(x) for x in capsys.readouterr().out.split("\n") if x]
    assert [r["index"] for r in tl] == [r["index"] for r in jl] \
        == list(range(len(smiles)))
    np.testing.assert_allclose([r["pred"] for r in tl],
                               [r["pred"] for r in jl], rtol=RTOL,
                               atol=ATOL)
    # the whole rows of the first request
    net = params_from_jax_arrays(arrays_of(params, state),
                                 tzoo.build("encoded_ecfp", **kw), "cpu")
    tb = ttrainer.batch_to_device(next(iter(TG.GraphLoader(gs, 128))), "cpu")
    with torch.no_grad():
        out = network_apply_packed(net, tb)
    np.testing.assert_allclose(out[:, 0].numpy(), [r["pred"] for r in tl],
                               rtol=RTOL, atol=ATOL)
    assert out.shape == (len(smiles), 16384)
