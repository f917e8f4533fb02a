"""Masked GRU node update (counterpart of mpnn_tpu/ops/update.py).

Reference semantics (mpnn_functions/update/gru_update.py:5-69): explicit
r/z/n gates from two weight matmuls, each gate masked before the blend,
h' = (1−z)·n + z·h, output re-masked. Weights are kept in the JAX layout
(in, 3·f) with gates in r|z|n order — the layout the CUDA eval kernel
reads — so they transplant without a transpose.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from mpnn_tpu_torch.ops.linear import uniform_


class GRU(nn.Module):
    def __init__(self, nf: int, mf: int, device=None):
        super().__init__()
        if nf != mf:
            raise ValueError("reference GRU weight shapes are only coherent "
                             f"when message_features == node_features "
                             f"(got nf={nf}, mf={mf})")
        self.w_ih = nn.Parameter(torch.empty(mf, 3 * nf, device=device))
        self.w_hh = nn.Parameter(torch.empty(nf, 3 * nf, device=device))
        self.b_ih = nn.Parameter(torch.zeros(3 * nf, device=device))
        self.b_hh = nn.Parameter(torch.zeros(3 * nf, device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """xavier-uniform (sigmoid gain 1) weights, zero biases."""
        for w in (self.w_ih, self.w_hh):
            uniform_(w, math.sqrt(6.0 / (w.shape[0] + w.shape[1])), generator)
        with torch.no_grad():
            self.b_ih.zero_()
            self.b_hh.zero_()

    def as_dict(self):
        return {"w_ih": self.w_ih, "w_hh": self.w_hh, "b_ih": self.b_ih,
                "b_hh": self.b_hh}


def gru_apply(gru: GRU, messages, node_states, mask):
    """messages, node_states: (N, f); mask (N, 1). Returns masked (N, f)."""
    f = node_states.shape[-1]
    ri, zi, ni = (messages @ gru.w_ih + gru.b_ih).split(f, dim=-1)
    rh, zh, nh = (node_states @ gru.w_hh + gru.b_hh).split(f, dim=-1)
    r = torch.sigmoid(ri + rh) * mask
    z = torch.sigmoid(zi + zh) * mask
    n = torch.tanh(ni + r * nh) * mask
    return ((1.0 - z) * n + z * node_states) * mask
