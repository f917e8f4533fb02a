"""Edge-network message function (counterpart of mpnn_tpu/ops/message.py,
the edge-MLP part).

The reference edge MLP (edge_network.py:16-21) is a width-squaring head,
then ONE weight-shared square layer applied `tail_repeats` (50) times with
relu, then a final projection pf → nf·mf. The port runs the head and the
tail here; the final projection is folded into per-vocab A matrices by
models/sparse.py and models/fused_train.py.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mpnn_tpu_torch.ops.linear import linear_init_, make_linear


def edge_mlp_head_dims(ef: int, nf: int, mf: int):
    """Width-squaring schedule: while in² < nf·mf, append Linear(in, in²).
    Returns the list of (in, out) dims for the head and the penultimate
    width."""
    dims = []
    in_layer = ef
    while in_layer ** 2 < nf * mf:
        dims.append((in_layer, in_layer ** 2))
        in_layer = in_layer ** 2
    return dims, in_layer


class EdgeNetwork(nn.Module):
    def __init__(self, nf: int, ef: int, mf: int, device=None):
        super().__init__()
        head_dims, pf = edge_mlp_head_dims(ef, nf, mf)
        self.head = nn.ModuleList(make_linear(i, o, device=device)
                                  for i, o in head_dims)
        self.shared = make_linear(pf, pf, bias=False, device=device)
        self.final = make_linear(pf, nf * mf, device=device)
        self.message_bias = nn.Parameter(torch.zeros(mf, device=device))

    def reset_parameters(self, init: str,
                         generator: Optional[torch.Generator] = None):
        for layer in [*self.head, self.shared, self.final]:
            linear_init_(layer, init, generator)
        with torch.no_grad():
            self.message_bias.zero_()


def _edge_mlp_penultimate(mp: EdgeNetwork, e: torch.Tensor,
                          tail_repeats: int) -> torch.Tensor:
    """The edge MLP up to (not including) the final projection:
    (..., ef) → (..., pf)."""
    x = e
    for layer in mp.head:
        x = torch.relu(layer(x))
    for _ in range(tail_repeats):
        x = torch.relu(mp.shared(x))
    return x
