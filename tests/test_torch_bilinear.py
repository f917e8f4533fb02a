"""The bilinear family (ecfp_bilinear) on the CPU against the JAX package:
the op's plain version (kernels/fused_bilinear.py::fused_bilinear_reference,
under autograd) against the Pallas kernel make_fused_bilinear_op in
interpret mode, and the port's model through that op against the JAX
package's plain sparse_mpnn_apply; ecfp_bilinear served against the JAX
package's fused_mpnn_eval; three Adam steps of ecfp_mse in lockstep with
the JAX package's train(); a JAX checkpoint served by the port; and the
CLI's refusal of the model on featurized SMILES, which the JAX package's
CLI shares (the bilinear message is coherent only at ef = nf³).

The model is reached as the reference reaches it, through the Python API
(mpnn_tpu's tests/test_fused_bilinear.py): node features cut to nf, and
each distinct bond row replaced by a random row of width nf³ (the zero
row kept), so that every W(e) is non-symmetric and a transposed index
order would show.

Tolerances, those of tests/test_fused_bilinear.py: outputs rtol 2e-4 /
atol 1e-5; h0 and parameter gradients rtol 2e-3 / atol 2e-5 (float32,
sums in other orders). Lockstep losses rtol 1e-4; parameters after three
Adam steps rtol 1e-4 / atol 2e-5.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from mpnn_tpu import graphs as JG
from mpnn_tpu.models import zoo as jzoo
from mpnn_tpu.models.config import MPNNConfig as JMPNNConfig
from mpnn_tpu.models.fused_train import (fused_mpnn_eval,
                                         make_fused_eval_for_batch,
                                         make_fused_step_for_batch)
from mpnn_tpu.models.mpnn import mpnn_init
from mpnn_tpu.models.network import network_apply_packed as jax_apply
from mpnn_tpu.models.network import network_init as jax_init
from mpnn_tpu.models.sparse import sparse_mpnn_apply as jax_sparse
from mpnn_tpu.train import cli as jcli
from mpnn_tpu.train import trainer as jtrainer
from mpnn_tpu.train.checkpoint import save_checkpoint as jax_save
from mpnn_tpu.train.checkpoint import tree_to_arrays
from mpnn_tpu_torch import graphs as TG
from mpnn_tpu_torch.graphs.batching import attach_fused_plan, plan_from_batch
from mpnn_tpu_torch.kernels import fused_bilinear as B
from mpnn_tpu_torch.models import zoo as tzoo
from mpnn_tpu_torch.models.config import MPNNConfig
from mpnn_tpu_torch.models.fused_train import bilinear_table, fused_mpnn_out
from mpnn_tpu_torch.models.sparse import sparse_mpnn_apply
from mpnn_tpu_torch.train import cli as tcli
from mpnn_tpu_torch.train import trainer as ttrainer
from mpnn_tpu_torch.train.checkpoint import (jax_key_map, load_checkpoint,
                                             module_to_jax_arrays,
                                             params_from_jax_arrays)
from test_torch_ecfp import ecfp_graphs

RTOL, ATOL = 2e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-5
LOCK_RTOL, LOCK_ATOL = 1e-4, 2e-5
SMILES = bench.SMILES + ["C", "O", "CCO", "CCN", "c1ccccc1", "CC(=O)O",
                         "C#N", "C=CC=O"]


def arrays_of(params, state, prefix=""):
    out = {f"params/{prefix}{k}": np.asarray(v)
           for k, v in tree_to_arrays(params).items()}
    out.update({f"state/{prefix}{k}": np.asarray(v)
                for k, v in tree_to_arrays(state).items()})
    return out


def bilinear_graphs(graphs, nf, seed=0):
    """Node features cut to nf; each distinct bond row replaced by a
    seeded random row of width nf³ (the all-zero row stays zero)."""
    rng = np.random.RandomState(seed)
    rows = {}
    out = []
    for g in graphs:
        ef = np.asarray(g.edge_feats, np.float32)
        new = np.zeros((ef.shape[0], nf ** 3), np.float32)
        for i, r in enumerate(ef):
            if r.any():
                key = r.tobytes()
                if key not in rows:
                    rows[key] = rng.randn(nf ** 3).astype(np.float32) * 0.7
                new[i] = rows[key]
        out.append(dataclasses.replace(
            g, afm=np.concatenate([g.afm, g.nafm], -1)[:, :nf],
            edge_feats=new))
    return out


def graphs_both(smiles, nf, labels=None, seed=0):
    labels = labels or [0] * len(smiles)
    jg, _ = JG.encode_molgraphs(JG.generate_molgraphs(smiles, labels))
    tg, _ = TG.encode_molgraphs(TG.generate_molgraphs(smiles, labels))
    return bilinear_graphs(jg, nf, seed), bilinear_graphs(tg, nf, seed)


def batches(jg, n):
    """The JAX loader's packed batch with its fused-step plan (jnp), and
    the same arrays as the port's CPU batch with the port's index plan."""
    b = next(iter(JG.GraphLoader(jg, n, collate="packed", use_native=False,
                                 fused_step_plan=True)))
    jb = {k: (jnp.asarray(v) if not np.isscalar(v) else v)
          for k, v in b.items() if k != "num_graphs"}
    npb = {k: np.asarray(v) for k, v in b.items()
           if not np.isscalar(v) and not k.startswith("fs_")}
    return jb, ttrainer.batch_to_device(attach_fused_plan(npb), "cpu")


def mpnn_cfg(nf, steps):
    kw = dict(node_features=nf, edge_features=nf ** 3, message_features=nf,
              output_dim=32, message_fn="bilinear", aggregation="adj",
              message_steps=steps, message_input="state",
              update_hidden="initial", concat_state_history=True)
    return JMPNNConfig(**kw), MPNNConfig(**kw)


def _close_tree(got, want, rtol, atol):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("nf,steps", [(2, 1), (2, 2), (2, 3), (3, 3)])
def test_plain_op_matches_pallas_kernel_and_sparse_model(nf, steps):
    """The op: hist and the gradients of h0 and the GRU leaves (cotangent
    Σ hist·c) against make_fused_bilinear_op in interpret mode, amat's
    gradient zero on both sides. The model: the port's fused path (this
    op, then the readout over cat[h0, hist]) against the JAX package's
    sparse_mpnn_apply — out, and the gradients of every parameter and of
    the node features under Σ out·c."""
    jg, _ = graphs_both(SMILES, nf, seed=nf + steps)
    jb, tb = batches(jg, len(SMILES))
    jcfg, tcfg = mpnn_cfg(nf, steps)
    params, state = mpnn_init(jax.random.PRNGKey(steps), jcfg)
    net = params_from_jax_arrays(arrays_of(params, state), tcfg, "cpu")
    np.testing.assert_array_equal(tb["edge_vid"].numpy(),
                                  np.asarray(jb["edge_vid"]))
    # the op, both packages, on the same table
    amat_t = bilinear_table(tb, nf)
    ef = jb["edge_feats"] * jb["edge_mask"][:, None]
    amat_j = jnp.transpose(ef[jb["edge_vfirst"]].reshape(-1, nf, nf, nf),
                           (0, 2, 1, 3)).reshape(-1, nf, nf * nf)
    np.testing.assert_array_equal(amat_t.numpy(), np.asarray(amat_j))
    assert not amat_t[0].any()
    op = make_fused_step_for_batch(jcfg, jb, interpret=True)
    h0j = jb["node_feats"] * jb["node_mask"]
    rng = np.random.RandomState(nf * steps)
    c = rng.randn(h0j.shape[0], steps * nf).astype(np.float32)

    def jf(amat, h0, gru):
        return op(amat, h0, jb["node_mask"], gru, jb["edge_vid"],
                  jb["edge_src"], jb["edge_dst"], jb["fs_win"])
    jhist, vjp = jax.vjp(jf, amat_j, h0j, params["gru"])
    jd_amat, jd_h0, jd_gru = vjp(jnp.asarray(c))
    leaves = {"h0": (tb["node_feats"] * tb["node_mask"]).requires_grad_(),
              **{k: v.detach().clone().requires_grad_()
                 for k, v in net.gru.as_dict().items()}}
    amat = amat_t.clone().requires_grad_()
    hist = B.fused_bilinear(
        amat, leaves["h0"], tb["node_mask"], tb["node_graph"],
        {k: leaves[k] for k in B._GRU_LEAVES}, tb["edge_vid"],
        tb["edge_src"], tb["edge_dst"], plan_from_batch(tb), steps=steps)
    (hist * torch.tensor(c)).sum().backward()
    np.testing.assert_allclose(hist.detach().numpy(), np.asarray(jhist),
                               rtol=RTOL, atol=ATOL)
    assert not np.asarray(jd_amat).any()
    assert amat.grad is None or not amat.grad.any()
    want = {"h0": np.asarray(jd_h0),
            **{k: np.asarray(v) for k, v in jd_gru.items()}}
    _close_tree({k: v.grad.numpy() for k, v in leaves.items()}, want,
                GRAD_RTOL, GRAD_ATOL)

    # the model: the port's op path against the JAX plain model
    co = rng.randn(jb["graph_mask"].shape[0], 32).astype(np.float32)

    def jloss(p, x):
        b = dict(jb)
        b["node_feats"] = x
        out, _ = jax_sparse(p, state, jcfg, b, training=True)
        return (out * co).sum(), out
    (_, jout), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jb["node_feats"])
    x = tb["node_feats"].clone().requires_grad_()
    out, new_state = fused_mpnn_out(net, {**tb, "node_feats": x})
    (out * torch.tensor(co)).sum().backward()
    assert new_state == {}
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    got = {k: (t.grad.t() if tr else t.grad).numpy()
           for k, (t, tr) in jax_key_map(net).items()
           if k.startswith("params/")}
    want = {f"params/{k}": np.asarray(v)
            for k, v in tree_to_arrays(jgp).items()}
    got["x"], want["x"] = x.grad.numpy(), np.asarray(jgx)
    _close_tree(got, want, GRAD_RTOL, GRAD_ATOL)
    # and the port's own plain model on the same batch
    with torch.no_grad():
        plain = sparse_mpnn_apply(net, tb)
    np.testing.assert_allclose(plain.numpy(), np.asarray(jout), rtol=RTOL,
                               atol=ATOL)



def ecfp_graphs_both(smiles, nbits, tmp_path, nf=2, seed=0):
    """The ECFP task's graphs in both packages (tests/test_torch_ecfp.py),
    then the bilinear cut."""
    jg, tg, _ = ecfp_graphs(smiles, nbits, tmp_path)
    return bilinear_graphs(jg, nf, seed), bilinear_graphs(tg, nf, seed)


def test_ecfp_bilinear_served_from_a_jax_checkpoint(tmp_path):
    """zoo ecfp_bilinear (nf 2, ef 8, T 2, od 32, head 'none'): a
    checkpoint the JAX package writes, loaded by the port and served
    through its eval step (the bilinear op), against the JAX package's
    fused_mpnn_eval (the Pallas kernel in interpret mode)."""
    jg, tg = ecfp_graphs_both(SMILES[:16], 32, tmp_path, seed=5)
    jcfg = jzoo.build("ecfp_bilinear", afm=2, bfm=8, n_out=32)
    tcfg = tzoo.build("ecfp_bilinear", afm=2, bfm=8, n_out=32)
    params, state = jax_init(jax.random.PRNGKey(3), jcfg)
    ckpt = os.path.join(str(tmp_path), "ckpt.npz")
    jax_save(ckpt, params=params, state=state, meta={"epoch": 0})
    net, _ = load_checkpoint(ckpt, tcfg, device="cpu")
    assert not len(net.head) and not len(net.mpnn.message)
    jb, _ = batches(jg, 16)
    eval_op = make_fused_eval_for_batch(jcfg.mpnn, jb, interpret=True)
    want = fused_mpnn_eval(params["mpnn"], state["mpnn"], jcfg.mpnn, jb,
                           eval_op)
    batch = next(iter(TG.GraphLoader(tg, 16)))
    step = ttrainer.eval_step_for_batch(tcfg, "ecfp_mse", batch)
    loss, out = step(net, ttrainer.batch_to_device(batch, "cpu"))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    jout, _ = jax_apply(params, state, jcfg, jb, training=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=RTOL,
                               atol=ATOL)
    assert np.isfinite(float(loss))


def test_lockstep_three_adam_steps_ecfp_bilinear(monkeypatch, tmp_path):
    """Three Adam steps (lr 1e-3, coupled weight decay 1e-5, ecfp_mse at
    nbits 32, shuffled batches of 8, seed 317) of ecfp_bilinear through
    the port's train() (the bilinear op's plain version) and the JAX
    package's trainer.train() (its packed XLA path) from the same
    weights, then validation: per-step losses, every parameter after
    step 3, and the validation loss."""
    jg, tg = ecfp_graphs_both((SMILES * 2)[:30], 32, tmp_path, seed=7)
    jcfg = jzoo.build("ecfp_bilinear", afm=2, bfm=8, n_out=32)
    tcfg = tzoo.build("ecfp_bilinear", afm=2, bfm=8, n_out=32)
    params, state = jax.tree.map(np.array,
                                 jax_init(jax.random.PRNGKey(4), jcfg))
    net = params_from_jax_arrays(arrays_of(params, state), tcfg, "cpu")
    kw = dict(epochs=1, batch_size=8, learning_rate=1e-3,
              weight_decay=1e-5, loss="ecfp_mse", seed=317)
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
        jcfg, jtrainer.TrainConfig(packed=True, **kw), jg[:24], jg[24:],
        params=jax.tree.map(jnp.asarray, params),
        state=jax.tree.map(jnp.asarray, state), with_nafm=False)
    monkeypatch.undo()
    log = os.path.join(str(tmp_path), "train.jsonl")
    tnet, thist = ttrainer.train(tcfg, ttrainer.TrainConfig(
        log_path=log, **kw), tg[:24], tg[24:], net=net, device="cpu")
    with open(log) as fh:
        tlosses = [json.loads(x)["loss"] for x in fh if '"step"' in x]
    assert len(jlosses) == len(tlosses) == 3
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOCK_RTOL)
    got, want = module_to_jax_arrays(tnet), arrays_of(jp, js)
    before = arrays_of(params, state)
    assert set(got) == set(want)
    for k, w in want.items():
        assert not np.array_equal(w, before[k]), k
        np.testing.assert_allclose(got[k], w, rtol=LOCK_RTOL,
                                   atol=LOCK_ATOL, err_msg=k)
    np.testing.assert_allclose(thist[0]["val_loss"], jhist[0]["val_loss"],
                               rtol=LOCK_RTOL)


def test_cli_refuses_ecfp_bilinear_on_featurized_smiles(tmp_path):
    """`train --experiment ecfp_bilinear` on SMILES: nf comes from the
    featurized atoms and ef from the bonds, so ef ≠ nf³ and both packages'
    CLIs raise the coherence error (the reference's own limit)."""
    csv = os.path.join(str(tmp_path), "x.csv")
    with open(csv, "w") as fh:
        fh.write("smiles,target\n" + "".join(f"{s},0\n" for s in SMILES))
    argv = ["train", "--experiment", "ecfp_bilinear", "--data", csv,
            "--epochs", "1", "--batch-size", "8"]
    msg = r"bilinear message requires ef == nf\^3 for shape coherence"
    with pytest.raises(ValueError, match=msg):
        tcli.main(argv + ["--device", "cpu"])
    with pytest.raises(AssertionError, match=msg):
        jcli.main(argv)


@pytest.mark.parametrize("nf", [2, 3])
def test_bilinear_message_matches_jax_dense_pairs(nf):
    """ops/message.py::bilinear_message per edge against the JAX package's
    dense per-pair bilinear_edge_network_apply (destination v, source w)
    on random non-symmetric W rows; both refuse ef ≠ nf³."""
    from mpnn_tpu.ops.message import bilinear_edge_network_apply
    from mpnn_tpu_torch.ops.message import bilinear_message
    rng = np.random.RandomState(nf)
    b, n = 2, 5
    h = rng.randn(b, n, nf).astype(np.float32)
    bfm = rng.randn(b, n, n, nf ** 3).astype(np.float32)
    want = np.asarray(bilinear_edge_network_apply(jnp.asarray(h),
                                                  jnp.asarray(bfm), nf=nf))
    bi, v, w = np.meshgrid(np.arange(b), np.arange(n), np.arange(n),
                           indexing="ij")
    got = bilinear_message(torch.tensor(h[bi, w].reshape(-1, nf)),
                           torch.tensor(h[bi, v].reshape(-1, nf)),
                           torch.tensor(bfm.reshape(-1, nf ** 3)), nf)
    np.testing.assert_allclose(got.numpy().reshape(want.shape), want,
                               rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match=r"ef == nf\^3"):
        bilinear_message(torch.zeros(3, nf), torch.zeros(3, nf),
                         torch.zeros(3, nf ** 3 + 1), nf)
    with pytest.raises(AssertionError, match=r"ef == nf\^3"):
        bilinear_edge_network_apply(jnp.asarray(h),
                                    jnp.asarray(bfm[..., :-1]), nf=nf)
