"""Batch normalization, eval mode (counterpart of mpnn_tpu/ops/norm.py and
of the plain BN in mpnn_tpu/ops/autoencoders.py::_bn_rows_apply).

Three forms, with two epsilon conventions — a reference quirk kept exactly:

  * MaskedBatchNorm1d — the masked MaskBatchNorm1d with running stats
    (bn1d_apply). Eval normalizes by (running_var**0.5 + eps): eps OUTSIDE
    the sqrt; the output is re-masked.
  * fold_bn1d — the same eval map as a per-feature affine
    scale = w / (rv**0.5 + eps), shift = b − rm·scale, the form the CUDA
    eval kernel takes.
  * bn_rows_eval — torch's plain BatchNorm1d over graph rows (the lipo
    head BN): (x − rm) / sqrt(rv + eps), eps INSIDE the sqrt.

Training-mode statistics are not part of this slice.
"""

from __future__ import annotations

import torch
from torch import nn


class MaskedBatchNorm1d(nn.Module):
    """Affine params + running stats of the reference MaskBatchNorm1d."""

    def __init__(self, num_features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(num_features, device=device))
        self.register_buffer("running_var",
                             torch.ones(num_features, device=device))

    def reset_parameters(self):
        """torch BatchNorm1d defaults: weight 1, bias 0, mean 0, var 1."""
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return bn1d_eval(x, mask, self.weight, self.bias, self.running_mean,
                         self.running_var, self.eps)


def bn1d_eval(x, mask, weight, bias, running_mean, running_var,
              eps: float = 1e-5):
    """bn1d_apply(training=False): x (R, f), mask (R, 1)."""
    out = (x - running_mean) / (running_var ** 0.5 + eps)
    return (weight * out + bias) * mask


def fold_bn1d(weight, bias, running_mean, running_var, eps: float = 1e-5):
    """(scale, shift) with bn1d_eval(x) == (scale·x + shift)·mask."""
    scale = weight / (running_var ** 0.5 + eps)
    return scale, bias - running_mean * scale


def bn_rows_eval(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """Plain BatchNorm1d in eval mode over rows, eps inside the sqrt."""
    out = (x - bn.running_mean) / torch.sqrt(bn.running_var + bn.eps)
    return bn.weight * out + bn.bias
