"""Checkpoints in the JAX package's format, and the weight transplant
(counterpart of mpnn_tpu/train/checkpoint.py).

A checkpoint is an .npz of arrays keyed by tree path — `params/<path>`,
`state/<path>`, `opt_state/<path>` — plus a JSON sidecar. The port's
modules mirror the JAX parameter tree, so a module path maps onto a JAX
path: `mpnn.message.0.head.0` ↔ `mpnn/message/0/head/0`. An nn.Linear's
`weight` (out, in) is the JAX `w` (in, out) transposed, its `bias` is `b`;
BatchNorm running statistics live under `state/`. Optimizer state is not
read.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from mpnn_tpu_torch.device import resolve_device
from mpnn_tpu_torch.models.config import MPNNConfig
from mpnn_tpu_torch.models.network import NetworkConfig, make_module

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
    ignored — on `cuda` unless device='cpu'. Raises on a missing key, an
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


def load_checkpoint(path: str, net_cfg: Union[NetworkConfig, MPNNConfig],
                    device=None) -> Tuple[nn.Module, dict]:
    """(module, meta) from a checkpoint written by either package, the
    module on `cuda` unless device='cpu'."""
    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files}
    module = params_from_jax_arrays(arrays, net_cfg, device)
    meta = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return module, meta


def save_checkpoint(path: str, module: nn.Module,
                    meta: Optional[dict] = None) -> None:
    """Write `module` in the JAX package's checkpoint format."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, **module_to_jax_arrays(module))
    os.replace(tmp, path)
    with open(path + ".meta.json", "w") as f:
        json.dump(meta or {}, f)
