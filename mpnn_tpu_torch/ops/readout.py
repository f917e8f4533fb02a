"""Gated graph-level readout (counterpart of mpnn_tpu/ops/readout.py,
graph_level_output).

Reference: mpnn_functions/readout/graph_level_output.py:9-47. Parity quirk
kept: the gate is a softmax over the FEATURE (output) axis of i(x·mask),
not a sigmoid and not a softmax over nodes. The packed (per-graph sum) form
is models/sparse.py::sparse_graph_level_output.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mpnn_tpu_torch.ops.linear import linear_init_, make_linear


class GraphLevelOutput(nn.Module):
    """i, j: Linear(2·nf → out) over the readout input cat[h_T, h_0]."""

    def __init__(self, node_features: int, output_dim: int, device=None):
        super().__init__()
        self.i = make_linear(2 * node_features, output_dim, device=device)
        self.j = make_linear(2 * node_features, output_dim, device=device)

    def reset_parameters(self, init: str,
                         generator: Optional[torch.Generator] = None):
        linear_init_(self.i, init, generator)
        linear_init_(self.j, init, generator)


def gated_rows(ro: GraphLevelOutput, x, mask):
    """Per-node gated rows softmax_feat(i(x·m)) ⊙ j(x·m) ⊙ m."""
    xm = x * mask
    return torch.softmax(ro.i(xm), dim=-1) * ro.j(xm) * mask
