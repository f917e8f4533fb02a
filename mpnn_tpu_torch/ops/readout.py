"""Readouts (counterpart of mpnn_tpu/ops/readout.py).

  * GraphLevelOutput — reference graph_level_output.py:9-47. Parity quirk
    kept: the gate is a softmax over the FEATURE (output) axis of
    i(x·mask), not a sigmoid and not a softmax over nodes. The packed
    (per-graph sum) form is models/sparse.py::sparse_graph_level_output.
  * Set2Vec — reference set2vec.py:13-151: T steps (100) of an input-less
    LSTM and an attention read over the set, width w = 2·nf, output
    m = [lstm_h ‖ read] (2w). The LSTM weights are raw (2w, w) parameters
    in the JAX layout (gate = m·W + b, biases (1, w)), not nn.Linear, so
    they transplant untransposed; q_attn and e_attn are bias-free
    nn.Linear. The packed loop is kernels/set2vec.py::set2vec_reference.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from mpnn_tpu_torch.ops.linear import linear_init_, make_linear, uniform_


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


LSTM_GATES = ("i", "f", "g", "o")


class LSTMHidden(nn.Module):
    """The input-less LSTM cell of set2vec.py:64-67: weights w_h{i,f,g,o}
    (hidden, cell) and biases b_h{i,f,g,o} (1, cell)."""

    def __init__(self, hidden: int, cell: int, device=None):
        super().__init__()
        for k in LSTM_GATES:
            setattr(self, f"w_h{k}", nn.Parameter(
                torch.empty(hidden, cell, device=device)))
            setattr(self, f"b_h{k}", nn.Parameter(
                torch.empty(1, cell, device=device)))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """U(±1/√hidden) for the weights AND the biases."""
        bound = 1.0 / math.sqrt(self.w_hi.shape[0])
        for k in LSTM_GATES:
            uniform_(getattr(self, f"w_h{k}"), bound, generator)
            uniform_(getattr(self, f"b_h{k}"), bound, generator)

    def as_dict(self):
        return {f"{p}_h{k}": getattr(self, f"{p}_h{k}")
                for k in LSTM_GATES for p in ("w", "b")}


def _lstm_hidden_apply(p, hprev, cprev):
    """One LSTM step with no input: (h, c) from the previous (h, c); `p`
    holds the JAX-layout leaves w_h*, b_h*."""
    i = torch.sigmoid(hprev @ p["w_hi"] + p["b_hi"])
    f = torch.sigmoid(hprev @ p["w_hf"] + p["b_hf"])
    g = torch.tanh(hprev @ p["w_hg"] + p["b_hg"])
    o = torch.sigmoid(hprev @ p["w_ho"] + p["b_ho"])
    c = f * cprev + i * g
    return o * torch.tanh(c), c


class Set2Vec(nn.Module):
    """`node_features` as the reference constructor takes it; the set's
    width is w = 2·node_features (the input is cat[h_T, h_0])."""

    def __init__(self, node_features: int, device=None):
        super().__init__()
        w = 2 * node_features
        self.q_attn = make_linear(w, w, bias=False, device=device)
        self.e_attn = make_linear(w, 1, bias=False, device=device)
        self.lstm = LSTMHidden(2 * w, w, device=device)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The JAX package's set2vec_init: torch-default linears and the
        LSTM's uniform, whatever the model's init."""
        linear_init_(self.q_attn, "torch_default", generator)
        linear_init_(self.e_attn, "torch_default", generator)
        self.lstm.reset_parameters(generator)

    def as_jax(self):
        """The readout's leaves in the JAX layout: {"lstm": {w_h*, b_h*},
        "q_attn": {"w": (w, w)}, "e_attn": {"w": (w, 1)}}."""
        return {"lstm": self.lstm.as_dict(),
                "q_attn": {"w": self.q_attn.weight.t()},
                "e_attn": {"w": self.e_attn.weight.t()}}
