"""Batch normalization (counterpart of mpnn_tpu/ops/norm.py and of the
plain BN in mpnn_tpu/ops/autoencoders.py::_bn_rows_apply).

Three norms, with three epsilon conventions — reference quirks kept
exactly:

  * the stateless masked norm (mask_batch_norm): no affine, no running
    statistics, batch statistics in eval mode too, eps 1e-6 INSIDE the
    sqrt; the mean is the sum over ALL rows divided by the mask count,
    right only because the rows come in pre-masked;
  * the masked MaskBatchNorm1d with running stats (MaskedBatchNorm1d,
    bn1d_apply). Training normalizes by the batch statistics over the
    masked rows, (x − mean) / (sqrt(max(var, 1e-12)) + eps), and feeds the
    BIASED var to the running-stat EMA (bn1d_train, ema); eval by
    (running_var**0.5 + eps) (bn1d_eval, folded to a per-feature affine by
    fold_bn1d for the CUDA eval kernel). eps is OUTSIDE the sqrt in both;
    the output is re-masked. These are not nn.BatchNorm1d.
  * torch's plain BatchNorm1d over graph rows (the lipo head BN): eps
    INSIDE the sqrt; training normalizes by the biased batch var and feeds
    the UNBIASED var to the EMA (bn_rows_train), eval uses the running
    stats (bn_rows_eval).
"""

from __future__ import annotations

import torch
from torch import nn


BN_EPS = 1e-5
VAR_CLAMP = 1e-12
STATELESS_EPS = 1e-6
MOMENTUM = 0.1


def mask_batch_norm_stats(x, mask, eps: float = STATELESS_EPS):
    """mask_batch_norm of x (R, f), mask (R, 1): returns (out, (mean,
    biased var)). The mean sums all rows (x must be pre-masked)."""
    c = mask.sum()
    mean = x.sum(0) / c
    cen = (x - mean) * mask
    var = (cen ** 2).sum(0) / c
    return cen / torch.sqrt(var + eps), (mean, var)


def mask_batch_norm(x, mask, eps: float = STATELESS_EPS):
    """The reference's stateless MaskBatchNorm over rows."""
    return mask_batch_norm_stats(x, mask, eps)[0]


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


def masked_stats(x, mask):
    """(mean, biased var) over the masked rows of x (R, f), mask (R, 1)."""
    c = mask.sum()
    mean = (x * mask).sum(0) / c
    var = (((x - mean) * mask) ** 2).sum(0) / c
    return mean, var


def bn1d_train(x, mask, weight, bias, eps: float = BN_EPS):
    """bn1d_apply(training=True): returns (out, (mean, var)), the batch
    statistics for the caller's running-stat EMA. The clamp inside the
    sqrt keeps the gradient finite for a zero-variance feature."""
    mean, var = masked_stats(x, mask)
    out = (x - mean) / (torch.sqrt(torch.clamp(var, min=VAR_CLAMP)) + eps)
    return (weight * out + bias) * mask, (mean, var)


def ema(state, stats, momentum: float = MOMENTUM):
    """One running-stat update {running_mean, running_var} from one batch's
    (mean, var), detached from the graph."""
    mean, var = (s.detach() for s in stats)
    return {"running_mean": (1 - momentum) * state["running_mean"]
            + momentum * mean,
            "running_var": (1 - momentum) * state["running_var"]
            + momentum * var}


def running_state(mod: nn.Module):
    """The {running_mean, running_var} dict of a BN module."""
    return {"running_mean": mod.running_mean, "running_var": mod.running_var}


def bn1d_eval(x, mask, weight, bias, running_mean, running_var,
              eps: float = 1e-5):
    """bn1d_apply(training=False): x (R, f), mask (R, 1)."""
    out = (x - running_mean) / (running_var ** 0.5 + eps)
    return (weight * out + bias) * mask


def fold_bn1d(weight, bias, running_mean, running_var, eps: float = 1e-5):
    """(scale, shift) with bn1d_eval(x) == (scale·x + shift)·mask."""
    scale = weight / (running_var ** 0.5 + eps)
    return scale, bias - running_mean * scale


def bn_rows_train(bn: nn.BatchNorm1d, x: torch.Tensor):
    """Plain BatchNorm1d in training mode over rows: normalize by the
    biased batch var (eps inside the sqrt), EMA the unbiased one — what
    nn.BatchNorm1d does in train mode, and also defined for one row.
    Returns (out, new running state)."""
    mean = x.mean(0)
    var = x.var(0, unbiased=False)
    n = x.shape[0]
    unbiased = var.detach() * n / max(n - 1, 1)
    new_state = ema(running_state(bn), (mean, unbiased), bn.momentum)
    out = (x - mean) / torch.sqrt(var + bn.eps)
    return bn.weight * out + bn.bias, new_state


def bn_rows_eval(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """Plain BatchNorm1d in eval mode over rows, eps inside the sqrt."""
    out = (x - bn.running_mean) / torch.sqrt(bn.running_var + bn.eps)
    return bn.weight * out + bn.bias
