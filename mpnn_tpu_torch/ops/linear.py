"""Linear layers (counterpart of mpnn_tpu/ops/linear.py).

The port holds linear layers as `nn.Linear`, whose weight is (out, in); the
JAX package stores (in, out). train/checkpoint.py transposes on transplant.
Initialization draws from an explicit `torch.Generator`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def make_linear(in_dim: int, out_dim: int, bias: bool = True,
                device=None) -> nn.Linear:
    """An nn.Linear with uninitialized storage: fill it with linear_init_."""
    return nn.utils.skip_init(nn.Linear, in_dim, out_dim, bias=bias,
                              device="cpu" if device is None else device)


def uniform_(t: torch.Tensor, bound: float,
             generator: Optional[torch.Generator]) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


def linear_init_(layer: nn.Linear, init: str = "torch_default",
                 generator: Optional[torch.Generator] = None) -> nn.Linear:
    """init: 'torch_default' (U(±1/√fan_in) for w and b) | 'kaiming_relu'
    (U(±√(6/fan_in)) weights, zero bias — the reference's init_weights pass)
    | 'zeros'."""
    fan_in = layer.in_features
    with torch.no_grad():
        if init == "kaiming_relu":
            uniform_(layer.weight, math.sqrt(6.0 / fan_in), generator)
            if layer.bias is not None:
                layer.bias.zero_()
        elif init == "zeros":
            layer.weight.zero_()
            if layer.bias is not None:
                layer.bias.zero_()
        else:
            bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
            uniform_(layer.weight, bound, generator)
            if layer.bias is not None:
                uniform_(layer.bias, bound, generator)
    return layer
