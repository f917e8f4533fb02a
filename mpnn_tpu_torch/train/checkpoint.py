"""Checkpoints in the JAX package's format, and the weight transplant
(counterpart of mpnn_tpu/train/checkpoint.py).

A checkpoint is an .npz of arrays keyed by tree path — `params/<path>`,
`state/<path>`, `opt_state/<path>` — plus a JSON sidecar. The port's
modules mirror the JAX parameter tree, so a module path maps onto a JAX
path: `mpnn.message.0.head.0` ↔ `mpnn/message/0/head/0`. An nn.Linear's
`weight` (out, in) is the JAX `w` (in, out) transposed, its `bias` is `b`;
BatchNorm running statistics live under `state/`. The optimizer state is
the JAX package's optax tree (train/optim.py::adam_state_prefix):
`opt_state/count`, `opt_state/hyperparams/learning_rate` (the current
rate, after any plateau cut) and Adam's `count`, `mu/<path>` and
`nu/<path>` — torch's step, exp_avg and exp_avg_sq, a Linear's moments
transposed as its `w` — so either package resumes the other's run.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from mpnn_tpu_torch.device import resolve_device
from mpnn_tpu_torch.models.config import MPNNConfig
from mpnn_tpu_torch.models.network import NetworkConfig, make_module
from mpnn_tpu_torch.train.optim import (adam_state_prefix, get_learning_rate,
                                        set_learning_rate)

_STATE_BUFFERS = ("running_mean", "running_var")


def jax_key_map(module: nn.Module) -> Dict[str, Tuple[torch.Tensor, bool]]:
    """{jax key: (tensor of `module`, transposed?)} for every parameter and
    running statistic of `module`."""
    out: Dict[str, Tuple[torch.Tensor, bool]] = {}
    for path, mod in module.named_modules():
        prefix = path.replace(".", "/")
        join = (lambda n: f"{prefix}/{n}") if prefix else (lambda n: n)
        if isinstance(mod, nn.Linear):
            out["params/" + join("w")] = (mod.weight, True)
            if mod.bias is not None:
                out["params/" + join("b")] = (mod.bias, False)
            continue
        for name, p in mod.named_parameters(recurse=False):
            out["params/" + join(name)] = (p, False)
        for name, b in mod.named_buffers(recurse=False):
            if name in _STATE_BUFFERS:
                out["state/" + join(name)] = (b, False)
    return out


def params_from_jax_arrays(arrays: Dict[str, np.ndarray],
                           net_cfg: Union[NetworkConfig, MPNNConfig],
                           device=None) -> nn.Module:
    """The port's module for `net_cfg` (a Network, or a bare MPNN for an
    MPNNConfig) holding the JAX arrays `arrays` — keyed `params/<path>` and
    `state/<path>` as save_checkpoint writes them; `opt_state/` keys are
    load_opt_state's — on `cuda` unless device='cpu'. Raises on a missing key, an
    unused key or a shape mismatch."""
    module = make_module(net_cfg, resolve_device(device))
    want = jax_key_map(module)
    given = {k: v for k, v in arrays.items()
             if not k.startswith("opt_state/")}
    missing = sorted(set(want) - set(given))
    if missing:
        raise KeyError(f"checkpoint missing leaf {missing[0]} "
                       f"({len(missing)} missing)")
    unused = sorted(set(given) - set(want))
    if unused:
        raise KeyError(f"checkpoint leaf {unused[0]} has no counterpart in "
                       f"the port's model ({len(unused)} unused)")
    with torch.no_grad():
        for key, (t, transpose) in want.items():
            arr = np.asarray(given[key])
            shape = tuple(t.shape[::-1]) if transpose else tuple(t.shape)
            if arr.shape != shape:
                raise ValueError(f"shape mismatch at {key}: checkpoint "
                                 f"{arr.shape} vs model {shape}")
            src = torch.from_numpy(np.array(arr)).to(t.dtype)
            t.copy_(src.t() if transpose else src)
    return module


def module_to_jax_arrays(module: nn.Module) -> Dict[str, np.ndarray]:
    """Inverse of params_from_jax_arrays: the module as JAX-keyed arrays."""
    return {k: (t.detach().t() if tr else t.detach()).cpu().numpy().copy()
            for k, (t, tr) in jax_key_map(module).items()}


def opt_state_arrays(module: nn.Module, opt: torch.optim.Optimizer
                     ) -> Dict[str, np.ndarray]:
    """`opt` (train/optim.py::adam over module.parameters()) as the JAX
    package's `opt_state/` arrays. A parameter Adam has not stepped yet
    has zero moments."""
    prefix = "opt_state/" + adam_state_prefix(opt)
    count = 0
    out = {}
    for key, (t, tr) in jax_key_map(module).items():
        if not key.startswith("params/"):
            continue
        st = opt.state.get(t, {})
        path = key[len("params/"):]
        for name, torch_name in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            v = st.get(torch_name)
            v = torch.zeros_like(t) if v is None else v.detach()
            out[f"{prefix}{name}/{path}"] = (v.t() if tr else v
                                             ).cpu().numpy().copy()
        if "step" in st:
            count = max(count, int(st["step"]))
    out["opt_state/count"] = np.asarray(count, np.int32)
    out[prefix + "count"] = np.asarray(count, np.int32)
    out["opt_state/hyperparams/learning_rate"] = np.asarray(
        get_learning_rate(opt), np.float32)
    return out


def load_opt_state(arrays: Dict[str, np.ndarray], module: nn.Module,
                   opt: torch.optim.Optimizer) -> None:
    """Set `opt` (adam over module.parameters()) from a checkpoint's
    `opt_state/` arrays, written by either package: the learning rate,
    and each parameter's step and moments. Raises on a missing key or a
    shape mismatch."""
    prefix = "opt_state/" + adam_state_prefix(opt)

    def get(key):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        return np.asarray(arrays[key])
    step = float(get(prefix + "count"))
    set_learning_rate(opt, float(get("opt_state/hyperparams/learning_rate")))
    for key, (t, tr) in jax_key_map(module).items():
        if not key.startswith("params/"):
            continue
        path = key[len("params/"):]
        st = {"step": torch.tensor(step)}
        for name, torch_name in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            arr = get(f"{prefix}{name}/{path}")
            shape = tuple(t.shape[::-1]) if tr else tuple(t.shape)
            if arr.shape != shape:
                raise ValueError(f"shape mismatch at {prefix}{name}/{path}: "
                                 f"checkpoint {arr.shape} vs model {shape}")
            v = torch.from_numpy(np.array(arr, np.float32)).to(t.device)
            st[torch_name] = (v.t() if tr else v).contiguous()
        opt.state[t] = st


def read_arrays(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def latest_checkpoint(ckpt_dir: str, prefix: str = "ckpt") -> Optional[str]:
    """The `<prefix>_<epoch>.npz` of the highest epoch in ckpt_dir, or
    None (mpnn_tpu/train/checkpoint.py::latest_checkpoint)."""
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_epoch = None, -1
    pat = re.compile(rf"^{re.escape(prefix)}_(\d+)\.npz$")
    for name in os.listdir(ckpt_dir):
        m = pat.match(name)
        if m and int(m.group(1)) > best_epoch:
            best_epoch = int(m.group(1))
            best = os.path.join(ckpt_dir, name)
    return best


def load_checkpoint(path: str, net_cfg: Union[NetworkConfig, MPNNConfig],
                    device=None) -> Tuple[nn.Module, dict]:
    """(module, meta) from a checkpoint written by either package, the
    module on `cuda` unless device='cpu'."""
    module = params_from_jax_arrays(read_arrays(path), net_cfg, device)
    meta = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return module, meta


def save_checkpoint(path: str, module: nn.Module,
                    meta: Optional[dict] = None,
                    opt: Optional[torch.optim.Optimizer] = None) -> None:
    """Write `module`, and with `opt` its optimizer state, in the JAX
    package's checkpoint format."""
    arrays = module_to_jax_arrays(module)
    if opt is not None:
        arrays.update(opt_state_arrays(module, opt))
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    with open(path + ".meta.json", "w") as f:
        json.dump(meta or {}, f)
