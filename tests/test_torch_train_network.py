"""The lipo network's training step on the CPU against the JAX package:
the loss, every gradient and every running statistic of one step, with
the MPNN core through the training op (its plain version here) or the
plain sparse model, and the bare MPNN's in-kernel-loss flavor. Inputs,
cut depth and tolerances as in tests/test_torch_train.py, whose helpers
these tests share."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from mpnn_tpu import graphs as JG
from mpnn_tpu.models.fused_train import (fused_step_eligible,
                                         make_fused_step_for_batch)
from mpnn_tpu.models.network import network_apply_packed as jax_apply
from mpnn_tpu.train.checkpoint import tree_to_arrays
from mpnn_tpu_torch import graphs as TG
from mpnn_tpu_torch.kernels import fused_step as K
from mpnn_tpu_torch.models.network import assign_state, network_apply_packed
from mpnn_tpu_torch.train import trainer as ttrainer
from mpnn_tpu_torch.train.checkpoint import (module_to_jax_arrays,
                                             params_from_jax_arrays)
from test_torch_train import (ATOL, RTOL, SMILES, _arrays, _assert_grads,
                              _port_grads, _setup)


@pytest.mark.parametrize("fused", [True, False])
def test_network_training_step_matches_jax(fused):
    """One training step of the lipo network: the JAX network with its
    MPNN core through the Pallas training op (interpret mode) against the
    port's through fused_step (fused=True) or its plain sparse model
    (fused=False): masked-MSE loss, out, every parameter gradient, and
    every running statistic after the step (nafm_bn, the T-fold ma_bn, bn,
    head_bn)."""
    jg, tg, jcfg, tcfg, params, state, net = _setup(SMILES[:16])
    jl = JG.GraphLoader(jg, 16, collate="packed", use_native=False,
                        fused_step_plan=True)
    b = next(iter(jl))
    jb = {k: (jnp.asarray(v) if not np.isscalar(v) else v)
          for k, v in b.items() if k != "num_graphs"}
    assert fused_step_eligible(jcfg.mpnn, jb, training=True)
    op = make_fused_step_for_batch(jcfg.mpnn, jb, interpret=True)
    labels = jb["labels"]

    def loss_fn(p):
        out, ns = jax_apply(p, state, jcfg, jb, training=True, fused_op=op)
        gm = jb["graph_mask"][:, None]
        return (((out - labels[:, None]) ** 2) * gm).sum() / gm.sum(), (
            out, ns)

    (jloss, (jout, jstate)), jgrads = jax.value_and_grad(
        loss_fn, has_aux=True)(jax.tree.map(jnp.asarray, params))

    tb = ttrainer.batch_to_device(next(iter(TG.GraphLoader(tg, 16))), "cpu")
    K.reset_launch_counts()
    out, new_state = network_apply_packed(net, tb, fused=fused,
                                          training=True)
    loss = ttrainer.mse_loss(out, tb["labels"], tb["graph_mask"])
    loss.backward()
    assert sum(K.launch_counts.values()) == 0       # plain version on CPU
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    _assert_grads(_port_grads(net),
                  {f"params/{k}": np.asarray(v)
                   for k, v in tree_to_arrays(jgrads).items()})
    assign_state(net, new_state)
    got = {k: v for k, v in module_to_jax_arrays(net).items()
           if k.startswith("state/")}
    want = {f"state/{k}": np.asarray(v)
            for k, v in tree_to_arrays(jstate).items()}
    assert set(got) == set(want) and len(want) == 8
    for k, w in want.items():
        assert not np.allclose(w, _arrays(params, state)[k]), k   # moved
        np.testing.assert_allclose(got[k], w, rtol=2e-4, atol=1e-6,
                                   err_msg=k)


def test_bare_mpnn_in_kernel_loss_matches_jax():
    """fused_flagship_loss, the flavor with the masked MSE inside the
    training op (a bare MPNN, bench.py's flagship widths, depth cut),
    against the JAX package's on the same batch: loss, out, every
    gradient and the running statistics."""
    from mpnn_tpu.models.fused_train import fused_flagship_loss as jax_loss
    from mpnn_tpu.models.mpnn import mpnn_init
    from mpnn_tpu_torch.models.config import MPNNConfig
    from mpnn_tpu_torch.models.fused_train import fused_flagship_loss
    smiles = SMILES[:12]
    labels = [0.3 * np.cos(i) for i in range(len(smiles))]
    jg, ge = JG.encode_molgraphs(JG.generate_molgraphs(smiles, labels))
    tg, _ = TG.encode_molgraphs(TG.generate_molgraphs(smiles, labels))
    jcfg = dataclasses.replace(bench.flagship_mpnn_cfg(ge), message_steps=2,
                               edge_mlp_tail_repeats=2)
    tcfg = MPNNConfig(**{f.name: getattr(jcfg, f.name)
                         for f in jcfg.__dataclass_fields__.values()})
    params, state = mpnn_init(jax.random.PRNGKey(4), jcfg)
    net = params_from_jax_arrays(_arrays(params, state), tcfg, "cpu")
    b = next(iter(JG.GraphLoader(jg, 12, collate="packed", use_native=False,
                                 fused_step_plan=True)))
    b["node_feats"] = np.concatenate([b["node_feats"], b["node_nafm"]], -1)
    jb = {k: (jnp.asarray(v) if not np.isscalar(v) else v)
          for k, v in b.items() if k != "num_graphs"}
    op = make_fused_step_for_batch(jcfg, jb, interpret=True)
    (jl, (jout, jstate)), jgrads = jax.value_and_grad(
        lambda p: (lambda r: (r[0], (r[1], r[2])))(
            jax_loss(p, state, jcfg, jb, jb["labels"], op)),
        has_aux=True)(jax.tree.map(jnp.asarray, params))
    tb = ttrainer.batch_to_device(next(iter(TG.GraphLoader(tg, 12))), "cpu")
    tb["node_feats"] = torch.cat([tb["node_feats"], tb["node_nafm"]], -1)
    loss, out, new_state = fused_flagship_loss(net, tb, tb["labels"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=RTOL)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    _assert_grads(_port_grads(net),
                  {f"params/{k}": np.asarray(v)
                   for k, v in tree_to_arrays(jgrads).items()})
    for key in ("ma_bn", "bn"):
        for field in ("running_mean", "running_var"):
            np.testing.assert_allclose(
                new_state[key][0][field].numpy(),
                np.asarray(jstate[key][0][field]), rtol=2e-4, atol=1e-6,
                err_msg=f"{key}.{field}")
