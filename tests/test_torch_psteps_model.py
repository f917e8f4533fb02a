"""The per-step family's networks (zoo graph_norm and encoded) on the CPU
against the JAX package, the weights transplanted from the JAX init with
every norm, running statistic and message bias perturbed: eval outputs
and the transplant here, one training step's cross-entropy loss, out,
every parameter gradient and every running statistic in
tests/test_torch_psteps_train.py (which shares these helpers), with the
MPNN core through the port's per-step ops (their plain versions here) or
its plain sparse model; and per-step checkpoints written by one package
and served by the other's `predict`.
The JAX side runs its network with the MPNN core through the Pallas
per-step ops in interpret mode. Depth as the zoo has it (T 3), the
edge-MLP tail cut to ×2.

Tolerances: forward values rtol 1e-4 / atol 1e-5; gradient leaves, each
divided by its max abs, rtol 2e-4 / atol 1e-5; running statistics rtol
2e-4 / atol 1e-6 (float32 on both sides, batch-wide sums in other
orders). Two leaves have zero gradient in theory and are held to an
absolute bound of 1e-5: each step's message_bias under the message bn1d,
and the encoders' last bias (enc/1/b) under the input bn1d, which takes a
per-feature constant out of its input.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import bench
from mpnn_tpu import graphs as JG
from mpnn_tpu.models import zoo as jzoo
from mpnn_tpu.models.fused_train import (fused_eval_eligible,
                                         make_fused_eval_for_batch)
from mpnn_tpu.models.network import network_apply_packed as jax_apply
from mpnn_tpu.models.network import network_init as jax_init
from mpnn_tpu.train import cli as jcli
from mpnn_tpu.train.checkpoint import save_checkpoint as jax_save
from mpnn_tpu.train.checkpoint import tree_to_arrays
from mpnn_tpu_torch import graphs as TG
from mpnn_tpu_torch.models import zoo as tzoo
from mpnn_tpu_torch.models.network import network_apply_packed, network_init
from mpnn_tpu_torch.train import cli as tcli
from mpnn_tpu_torch.train import trainer as ttrainer
from mpnn_tpu_torch.train.checkpoint import (jax_key_map,
                                             module_to_jax_arrays,
                                             params_from_jax_arrays,
                                             save_checkpoint)

RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL = 2e-4
MODELS = ["graph_norm", "encoded"]
SMILES = bench.SMILES + ["C", "O", "CCO", "CCN", "c1ccccc1", "CC(=O)O"]


def cut(cfg):
    """The zoo config at its widths and depth, the ×50 tail cut to ×2."""
    return dataclasses.replace(cfg, mpnn=dataclasses.replace(
        cfg.mpnn, edge_mlp_tail_repeats=2))


def arrays_of(params, state):
    out = {f"params/{k}": np.asarray(v)
           for k, v in tree_to_arrays(params).items()}
    out.update({f"state/{k}": np.asarray(v)
                for k, v in tree_to_arrays(state).items()})
    return out


def perturb(params, state, rng):
    """Random affine norms, running statistics and message biases on top
    of the JAX init (which leaves them at 1/0 and would hide a swap)."""
    params = jax.tree.map(np.array, params)
    state = jax.tree.map(np.array, state)
    m, ms = params["mpnn"], state["mpnn"]

    def bn(p, s):
        f = p["weight"].shape[0]
        p["weight"] = (1 + 0.2 * rng.randn(f)).astype(np.float32)
        p["bias"] = (0.2 * rng.randn(f)).astype(np.float32)
        s["running_mean"] = (0.3 * rng.randn(f)).astype(np.float32)
        s["running_var"] = (0.3 + rng.rand(f)).astype(np.float32)
    for key in ("ma_bn", "bn"):
        for p, s in zip(m.get(key, []), ms.get(key, [])):
            bn(p, s)
    for key in ("aebn", "bebn"):
        if key in m:
            bn(m[key], ms[key])
    for mp in m["message"]:
        f = mp["message_bias"].shape[0]
        mp["message_bias"] = (0.2 * rng.randn(f)).astype(np.float32)
    return params, state


def setup(model, smiles=SMILES[:16], seed=0, n_out=4):
    """(JAX graphs, port graphs, JAX cfg, port cfg, params, state, port
    net transplanted from them); labels are n_out integer classes."""
    labels = [(3 * i) % n_out for i in range(len(smiles))]
    jg, ge = JG.encode_molgraphs(JG.generate_molgraphs(smiles, labels))
    tg, _ = TG.encode_molgraphs(TG.generate_molgraphs(smiles, labels))
    kw = dict(afm=ge.atom_width(), bfm=ge.bond_width(), nafm=3,
              n_out=n_out)
    jcfg, tcfg = cut(jzoo.build(model, **kw)), cut(tzoo.build(model, **kw))
    params, state = jax_init(jax.random.PRNGKey(seed), jcfg)
    params, state = perturb(params, state, np.random.RandomState(seed))
    net = params_from_jax_arrays(arrays_of(params, state), tcfg, "cpu")
    return jg, tg, jcfg, tcfg, params, state, net


def jax_batch(jg, n):
    b = next(iter(JG.GraphLoader(jg, n, collate="packed", use_native=False,
                                 fused_step_plan=True)))
    return {k: (jnp.asarray(v) if not np.isscalar(v) else v)
            for k, v in b.items() if k != "num_graphs"}


def port_grads(net):
    """The port's parameter gradients, keyed and laid out as JAX leaves
    (zeros for a parameter the loss does not reach)."""
    return {k: (np.zeros(tuple(t.shape[::-1]) if tr else tuple(t.shape),
                         np.float32) if t.grad is None
                else (t.grad.t() if tr else t.grad).numpy())
            for k, (t, tr) in jax_key_map(net).items()
            if k.startswith("params/")}


def zero_in_theory(key, cfg):
    """A gradient leaf a batch-statistics norm right after it zeroes."""
    return ((key.endswith("message_bias") and cfg.msg_norm == "bn1d")
            or (key.endswith("encoder/enc/1/b") and cfg.input_norm))


def assert_grads(got, want, cfg):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if zero_in_theory(k, cfg):
            assert np.abs(g - w).max() <= ATOL, k
            continue
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g / scale, w / scale, rtol=GRAD_RTOL,
                                   atol=ATOL, err_msg=k)


def jax_ce(out, labels, gm):
    import optax
    per = optax.softmax_cross_entropy_with_integer_labels(
        out, labels.astype(jnp.int32))
    return (per * gm).sum() / gm.sum()


@functools.lru_cache(maxsize=None)
def jax_eval(model):
    """The JAX network's eval output on setup(model)'s first batch of 16,
    its MPNN core through the per-step eval op in interpret mode,
    computed once for both port paths."""
    jg, _, jcfg, _, params, state, _ = setup(model)
    jb = jax_batch(jg, 16)
    assert fused_eval_eligible(jcfg.mpnn, jb)
    op = make_fused_eval_for_batch(jcfg.mpnn, jb, interpret=True)
    jout, _ = jax_apply(jax.tree.map(jnp.asarray, params),
                        jax.tree.map(jnp.asarray, state), jcfg, jb,
                        training=False, eval_op=op)
    return np.asarray(jout)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("model", MODELS)
def test_network_eval_matches_jax(model, fused):
    """Serving: jax_eval against the port's network with its MPNN core
    through fused_psteps_eval (fused=True) or the plain sparse model
    (fused=False)."""
    _, tg, _, _, _, _, net = setup(model)
    jout = jax_eval(model)
    tb = ttrainer.batch_to_device(next(iter(TG.GraphLoader(tg, 16))), "cpu")
    with torch.no_grad():
        out = network_apply_packed(net, tb, fused=fused)
    assert np.abs(jout).max() > 1e-2
    np.testing.assert_allclose(out.numpy(), jout, rtol=RTOL, atol=ATOL)


def test_transplant_consumes_every_leaf_of_both_models():
    """Every JAX leaf of both models — the T message networks, the
    per-step norms, the autoencoders' encoder, decoder and BatchNorm, the
    input norms — has its counterpart, and the round trip is exact."""
    for model in MODELS:
        _, _, jcfg, tcfg, params, state, net = setup(model, seed=2)
        arrays = arrays_of(params, state)
        back = module_to_jax_arrays(net)
        assert set(back) == set(arrays)
        for k, v in arrays.items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)
        n_msg = sum(k.endswith("message_bias") for k in arrays)
        assert n_msg == jcfg.mpnn.message_steps == 3
        if model == "encoded":
            assert "params/mpnn/atom_encoder/dec/1/w" in arrays
            assert "state/mpnn/bond_encoder/bn/running_var" in arrays
            assert "params/mpnn/ma_bn/2/weight" in arrays


def _csv(tmp_path, n=30):
    path = os.path.join(str(tmp_path), "cls.csv")
    smiles = (SMILES * 3)[:n]
    pd.DataFrame({"smiles": smiles,
                  "target": [(5 * i) % 4 for i in range(n)]}
                 ).to_csv(path, index=False)
    return path


def _predict(main, argv, capsys):
    main(argv)
    return [json.loads(x) for x in capsys.readouterr().out.split("\n") if x]


@pytest.mark.parametrize("exp,model", [
    ("graph_norm_classification", "graph_norm"),
    ("encoded_classification", "encoded")])
def test_checkpoints_cross_served(exp, model, tmp_path, capsys):
    """A JAX-written per-step checkpoint (perturbed weights) served by the
    port's `predict`, and a port-written one served by the JAX package's:
    the same records {"index", "pred": argmax, "logits"} from both."""
    csv = _csv(tmp_path)
    gs, ge = TG.encode_molgraphs(TG.generate_molgraphs(
        pd.read_csv(csv)["smiles"].tolist()))
    kw = dict(afm=ge.atom_width(), bfm=ge.bond_width(), nafm=3, n_out=4)
    params, state = jax_init(jax.random.PRNGKey(5), jzoo.build(model, **kw))
    params, state = perturb(params, state, np.random.RandomState(5))
    ck_jax = os.path.join(str(tmp_path), "jax.npz")
    jax_save(ck_jax, params=params, state=state)
    ck_port = os.path.join(str(tmp_path), "port.npz")
    save_checkpoint(ck_port, network_init(
        tzoo.build(model, **kw), torch.Generator().manual_seed(5), "cpu"))
    for ck in (ck_jax, ck_port):
        args = ["predict", "--experiment", exp, "--data", csv, "--ckpt", ck]
        jl = _predict(jcli.main, args + ["--packed"], capsys)
        tl = _predict(tcli.main, args + ["--device", "cpu"], capsys)
        assert [r["index"] for r in tl] == [r["index"] for r in jl] \
            == list(range(30))
        np.testing.assert_allclose([r["logits"] for r in tl],
                                   [r["logits"] for r in jl], rtol=RTOL,
                                   atol=1e-5)
        margin = np.sort(np.asarray([r["logits"] for r in jl]), -1)
        sure = margin[:, -1] - margin[:, -2] > 1e-4
        assert [r["pred"] for r, s in zip(tl, sure) if s] \
            == [r["pred"] for r, s in zip(jl, sure) if s]
        assert len(tl[0]["logits"]) == 4
