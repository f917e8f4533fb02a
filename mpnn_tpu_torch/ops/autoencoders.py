"""The tanh autoencoder of the encoded models (counterpart of
mpnn_tpu/ops/autoencoders.py::tanh_autoencoder_init, tanh_encoder_apply).

The reference injects the encoder half of a small autoencoder into the
model (atom 30→15→8, bond 8→4→2; here in → max(in//2, e) → e). The model
applies only the encoder, Linear (no bias) → tanh → Linear. The parameter
tree also holds the decoder (`dec/0`, `dec/1`) and a BatchNorm (`bn`,
affine + running statistics) that the model never reads: they are in the
checkpoint, and Adam's coupled weight decay moves them all the same.
Nothing freezes the encoder: it trains with the rest of the model.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mpnn_tpu_torch.ops.linear import linear_init_, make_linear
from mpnn_tpu_torch.ops.norm import MaskedBatchNorm1d


class TanhAutoencoder(nn.Module):
    def __init__(self, in_dim: int, mid_dim: int, e_dim: int, device=None):
        super().__init__()
        self.enc = nn.ModuleList([
            make_linear(in_dim, mid_dim, bias=False, device=device),
            make_linear(mid_dim, e_dim, device=device)])
        self.dec = nn.ModuleList([
            make_linear(e_dim, mid_dim, device=device),
            make_linear(mid_dim, in_dim, device=device)])
        self.bn = MaskedBatchNorm1d(e_dim, device=device)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """torch-default linears (the JAX package's linear_init default),
        BatchNorm at weight 1, bias 0, mean 0, var 1."""
        for layer in [*self.enc, *self.dec]:
            linear_init_(layer, "torch_default", generator)
        self.bn.reset_parameters()


def tanh_encoder_apply(ae: TanhAutoencoder, x: torch.Tensor) -> torch.Tensor:
    """The encoder half: Linear (no bias) → tanh → Linear."""
    return ae.enc[1](torch.tanh(ae.enc[0](x)))
