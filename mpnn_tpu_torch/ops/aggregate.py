"""The learned 'att' message aggregator (counterpart of
mpnn_tpu/ops/aggregate.py::att_agg_init / att_agg).

Reference attention_message_agg.py:8-24: a Linear(1 → 1) over the
adjacency entry, then a softmax over the LAST axis of its (…, 1) output —
a singleton axis, so every weight is exactly 1 and the aggregation is a
plain sum over all pairs (models/sparse.py decomposes it exactly). The
layer is a parameter only: its gradient is exactly zero in both packages,
and it exists for checkpoint parity.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mpnn_tpu_torch.ops.linear import linear_init_, make_linear


class AttAggregate(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.att = make_linear(1, 1, device=device)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        linear_init_(self.att, "torch_default", generator)
