"""The serving slice end to end on the CPU: the port's lipo network
(graph_norm wrapper → MPNN core through the eval op → head BN → halving
head) against the JAX package's network_apply_packed(training=False), both
from the same transplanted weights with random running statistics, at the
flagship widths (nf 10, T 6, edge-MLP tail ×50) on bench.py's molecules.

Tolerance rtol 1e-4 / atol 1e-5 (float32 on both sides, sums in other
orders, through a ×50 tail); the largest error seen when this test was
written was below 1e-6 absolute.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

import bench
from mpnn_tpu import graphs as JG
from mpnn_tpu.models import zoo as jzoo
from mpnn_tpu.models.network import network_apply_packed as jax_apply
from mpnn_tpu.models.network import network_init
from mpnn_tpu.train import cli as jcli
from mpnn_tpu.train.checkpoint import save_checkpoint, tree_to_arrays
from mpnn_tpu_torch import graphs as TG
from mpnn_tpu_torch.models import zoo as tzoo
from mpnn_tpu_torch.models.network import network_apply_packed
from mpnn_tpu_torch.train import cli as tcli
from mpnn_tpu_torch.train import experiments
from mpnn_tpu_torch.train.checkpoint import params_from_jax_arrays
from mpnn_tpu_torch.train.trainer import batch_to_device, evaluate

RTOL, ATOL = 1e-4, 1e-5
SMILES = bench.SMILES + ["C", "O"] + bench.SMILES[:8] + ["CCN", "c1ccccc1"]


def _perturb(params, state, rng):
    """Random norms, running stats and message bias on top of the JAX
    init (the init leaves them at 1/0, which would hide a swapped eps)."""
    def bn(p, s, f):
        p["weight"] = (1 + 0.2 * rng.randn(f)).astype(np.float32)
        p["bias"] = (0.2 * rng.randn(f)).astype(np.float32)
        s["running_mean"] = (0.3 * rng.randn(f)).astype(np.float32)
        s["running_var"] = (0.3 + rng.rand(f)).astype(np.float32)
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    m, ms = params["mpnn"], state["mpnn"]
    for key in ("ma_bn", "bn"):
        bn(m[key][0], ms[key][0], m[key][0]["weight"].shape[0])
    for key in ("nafm_bn", "head_bn"):
        bn(params[key], state[key], params[key]["weight"].shape[0])
    m["message"][0]["message_bias"] = (
        0.2 * rng.randn(m["message"][0]["message_bias"].shape[0])
    ).astype(np.float32)
    return params, state


def _setup(smiles, seed=0):
    labels = [0.1 * i for i in range(len(smiles))]
    jg, ge = JG.encode_molgraphs(JG.generate_molgraphs(smiles, labels))
    tg, _ = TG.encode_molgraphs(TG.generate_molgraphs(smiles, labels))
    afm, bfm = ge.atom_width(), ge.bond_width()
    jcfg = jzoo.lipo(afm, bfm, 3)
    params, state = network_init(jax.random.PRNGKey(seed), jcfg)
    params, state = _perturb(params, state, np.random.RandomState(seed))
    arrays = {f"params/{k}": v for k, v in tree_to_arrays(params).items()}
    arrays.update({f"state/{k}": v for k, v in tree_to_arrays(state).items()})
    net = params_from_jax_arrays(arrays, tzoo.lipo(afm, bfm, 3), "cpu")
    return jg, tg, jcfg, params, state, net


def _jax_outputs(jg, jcfg, params, state, batch_size):
    outs = []
    for b in JG.GraphLoader(jg, batch_size, collate="packed",
                            use_native=False):
        jb = {k: jnp.asarray(v) for k, v in b.items() if k != "num_graphs"}
        out, _ = jax_apply(params, state, jcfg, jb, training=False)
        outs.append(np.asarray(out))
    return np.concatenate(outs)


def test_flagship_widths():
    _, tg, jcfg, _, _, net = _setup(SMILES)
    m = net.cfg.mpnn
    assert (m.node_features, m.message_steps, m.edge_mlp_tail_repeats,
            m.output_dim) == (10, 6, 50, 14)
    assert net.mpnn.message[0].shared.weight.shape == (36, 36)


@pytest.mark.parametrize("fused", [True, False])
def test_network_matches_jax(fused):
    """fused=True: the serving path (eval op; its plain version on the
    CPU). fused=False: the port's plain sparse model."""
    jg, tg, jcfg, params, state, net = _setup(SMILES)
    want = _jax_outputs(jg, jcfg, params, state, 16)
    got = []
    for b in TG.GraphLoader(tg, 16, collate="packed"):
        got.append(network_apply_packed(net, batch_to_device(b, "cpu"),
                                        fused=fused).detach().numpy())
    got = np.concatenate(got)
    assert got.shape == want.shape == (len(SMILES), 1)
    assert np.all(np.isfinite(got)) and np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_evaluate_matches_jax():
    jg, tg, jcfg, params, state, net = _setup(SMILES)
    want = _jax_outputs(jg, jcfg, params, state, 16).reshape(-1)
    labels = np.asarray([g.label for g in tg], np.float64)
    res = evaluate(net, TG.GraphLoader(tg, 16, collate="packed"), "mse",
                   device="cpu")
    mse = float(((want - labels) ** 2).mean())
    np.testing.assert_allclose(res["mse"], mse, rtol=1e-4)
    np.testing.assert_allclose(res["rmse"], np.sqrt(mse), rtol=1e-4)


def test_cli_predict_matches_jax_cli(tmp_path, capsys):
    """One checkpoint written by mpnn_tpu's save_checkpoint; the JAX
    `predict --packed` and the port's `predict --device cpu` on one CSV
    print the same predictions."""
    smiles = SMILES[:14]
    csv = os.path.join(str(tmp_path), "new.csv")
    pd.DataFrame({"smiles": smiles,
                  "exp": [0.5 - 0.1 * i for i in range(len(smiles))]}
                 ).to_csv(csv, index=False)
    gs, ge = JG.load_number_dataset(csv, "smiles", "exp")
    jcfg = jzoo.lipo(ge.atom_width(), ge.bond_width(), 3)
    params, state = network_init(jax.random.PRNGKey(5), jcfg)
    params, state = _perturb(params, state, np.random.RandomState(5))
    ckpt = os.path.join(str(tmp_path), "ckpt.npz")
    save_checkpoint(ckpt, params=params, state=state)

    jcli.main(["predict", "--experiment", "lipo", "--data", csv,
               "--ckpt", ckpt, "--packed"])
    jl = [json.loads(x) for x in capsys.readouterr().out.split("\n") if x]
    tcli.main(["predict", "--experiment", "lipo", "--data", csv,
               "--ckpt", ckpt, "--device", "cpu"])
    tl = [json.loads(x) for x in capsys.readouterr().out.split("\n") if x]
    assert [r["index"] for r in tl] == [r["index"] for r in jl] \
        == list(range(len(smiles)))
    np.testing.assert_allclose([r["pred"] for r in tl],
                               [r["pred"] for r in jl], rtol=RTOL,
                               atol=ATOL)


def test_predict_defaults_to_cuda(tmp_path):
    """Without --device the verb asks for the card; on a host without
    one it raises instead of running on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["predict", "--experiment", "lipo", "--data", "x.csv",
                   "--ckpt", "x.npz"])
    assert experiments.get("lipo").loss == "mse"
