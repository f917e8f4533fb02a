"""The weight transplant JAX → port (mpnn_tpu_torch.train.checkpoint):
every JAX leaf of zoo.lipo and of bench.py::flagship_mpnn_cfg is consumed
exactly once and comes back unchanged; a missing key, an unused key or a
wrong shape raises."""

import jax
import numpy as np
import pytest

import bench
from mpnn_tpu.models import zoo as jzoo
from mpnn_tpu.models.mpnn import mpnn_init
from mpnn_tpu.models.network import network_init
from mpnn_tpu.train.checkpoint import tree_to_arrays
from mpnn_tpu_torch.models import zoo as tzoo
from mpnn_tpu_torch.models.config import MPNNConfig
from mpnn_tpu_torch.train.checkpoint import (module_to_jax_arrays,
                                             params_from_jax_arrays)


def _jax_arrays(which):
    """(arrays keyed params/… state/…, the port's config)."""
    gs, ge = bench.build_batch(16)
    afm, bfm = ge.atom_width(), ge.bond_width()
    key = jax.random.PRNGKey(3)
    if which == "lipo":
        p, s = network_init(key, jzoo.lipo(afm, bfm, 3))
        cfg = tzoo.lipo(afm, bfm, 3)
    else:
        jcfg = bench.flagship_mpnn_cfg(ge)
        p, s = mpnn_init(key, jcfg)
        cfg = MPNNConfig(**{f.name: getattr(jcfg, f.name)
                            for f in jcfg.__dataclass_fields__.values()})
    arrays = {f"params/{k}": v for k, v in tree_to_arrays(p).items()}
    arrays.update({f"state/{k}": v for k, v in tree_to_arrays(s).items()})
    rng = np.random.RandomState(0)
    # distinct values everywhere, so a swapped leaf cannot go unnoticed
    arrays = {k: rng.randn(*v.shape).astype(np.float32)
              for k, v in arrays.items()}
    return arrays, cfg


@pytest.mark.parametrize("which", ["lipo", "flagship_mpnn"])
def test_every_leaf_consumed_once_and_round_trips(which):
    arrays, cfg = _jax_arrays(which)
    module = params_from_jax_arrays(arrays, cfg, "cpu")
    back = module_to_jax_arrays(module)
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # no two port tensors share storage: each leaf landed in its own place
    n_tensors = sum(1 for _ in module.parameters()) + sum(
        1 for n, _ in module.named_buffers() if "running_" in n)
    assert n_tensors == len(arrays)


def test_linear_weights_are_transposed():
    arrays, cfg = _jax_arrays("lipo")
    net = params_from_jax_arrays(arrays, cfg, "cpu")
    np.testing.assert_array_equal(
        net.mpnn.readout.i.weight.detach().numpy(),
        arrays["params/mpnn/readout/i/w"].T)
    np.testing.assert_array_equal(net.mpnn.gru.w_ih.detach().numpy(),
                                  arrays["params/mpnn/gru/w_ih"])
    np.testing.assert_array_equal(
        net.head_bn.running_var.numpy(),
        arrays["state/head_bn/running_var"])


def test_opt_state_ignored():
    arrays, cfg = _jax_arrays("lipo")
    arrays["opt_state/0/mu/head/0/w"] = np.zeros((14, 7), np.float32)
    params_from_jax_arrays(arrays, cfg, "cpu")


@pytest.mark.parametrize("fault", ["missing", "unused", "shape"])
def test_bad_checkpoint_raises(fault):
    arrays, cfg = _jax_arrays("lipo")
    if fault == "missing":
        arrays.pop("state/mpnn/bn/0/running_var")
        err, match = KeyError, "missing"
    elif fault == "unused":
        arrays["params/mpnn/message/1/message_bias"] = np.zeros(10,
                                                                np.float32)
        err, match = KeyError, "no counterpart"
    else:
        arrays["params/mpnn/gru/w_hh"] = np.zeros((30, 10), np.float32)
        err, match = ValueError, "shape mismatch"
    with pytest.raises(err, match=match):
        params_from_jax_arrays(arrays, cfg, "cpu")
