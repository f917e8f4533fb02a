"""Full network = input wrapper → MPNN → (BN) → dense head, packed batches,
eval and training mode (counterpart of mpnn_tpu/models/network.py).

The lipo composition (test_lipo.py:103-129): the graph_norm wrapper
(masked bn1d over nafm, concatenated onto afm), the MPNN core, torch's
plain BatchNorm1d over the graph embeddings, and the halving head. The
per-step family's (test_graph_norm.py, test_graph_encode_norm.py) and
the basic shell's (test.py): the plain wrapper, the MPNN core and one
linear head; single_target's (test_single_target.py) an MLP head of
head_dims with relu between its layers. Head 'none' (basic_model_ecfp.py,
the autoencoder's encoder): the MPNN core's output is the network's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from mpnn_tpu_torch.device import resolve_device
from mpnn_tpu_torch.models.config import MPNNConfig
from mpnn_tpu_torch.models.mpnn import MPNN
from mpnn_tpu_torch.ops.linear import linear_init_, make_linear
from mpnn_tpu_torch.ops.norm import (MaskedBatchNorm1d, bn1d_train,
                                     bn_rows_eval, bn_rows_train, ema,
                                     running_state)


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    mpnn: MPNNConfig
    input_wrapper: str = "plain"        # plain|graph_norm|batch_norm
    nafm_features: int = 0              # needed for graph_norm wrapper
    head: str = "linear"                # linear|halving|mlp|none
    head_dims: Tuple[int, ...] = ()     # for 'mlp': hidden+output widths
    head_output: int = 1                # final width for linear/halving
    head_bn: bool = False               # nn.BatchNorm1d on graph embeddings
    kaiming_head: bool = True           # drivers apply init_weights (kaiming)


def halving_dims(start: int, floor: int = 10) -> Sequence[Tuple[int, int]]:
    """test_lipo.py:104-110: halve (ceil) until ≤ floor, then Linear(→1)."""
    dims = []
    den = start
    while den > floor:
        new_den = int(math.ceil(den / 2))
        dims.append((den, new_den))
        den = new_den
    return dims


def head_widths(cfg: NetworkConfig) -> Sequence[Tuple[int, int]]:
    """(in, out) of each head layer (mpnn_tpu/models/network.py::
    network_init): 'linear' one Linear(emb → head_output); 'halving'
    test_lipo.py's halving stack, then → head_output; 'mlp' emb →
    head_dims[0] → … → head_dims[-1]; 'none' no layer."""
    emb = cfg.mpnn.effective_output_dim
    if cfg.head == "none":
        return []
    if cfg.head == "mlp":
        widths = [emb, *cfg.head_dims]
        return list(zip(widths[:-1], widths[1:]))
    widths = list(halving_dims(emb)) if cfg.head == "halving" else []
    last = widths[-1][1] if widths else emb
    return widths + [(last, cfg.head_output)]


class Network(nn.Module):
    def __init__(self, cfg: NetworkConfig, device=None):
        super().__init__()
        if cfg.input_wrapper not in ("plain", "graph_norm") \
                or cfg.head not in ("halving", "linear", "mlp", "none"):
            raise NotImplementedError(
                f"input wrapper {cfg.input_wrapper!r} / head {cfg.head!r}: "
                "the port has the plain and graph_norm wrappers and the "
                "linear, halving, mlp and none heads; the batch_norm "
                "wrapper is still to port (ROADMAP)")
        self.cfg = cfg
        self.mpnn = MPNN(cfg.mpnn, device=device)
        if cfg.input_wrapper == "graph_norm":
            self.nafm_bn = MaskedBatchNorm1d(cfg.nafm_features,
                                             device=device)
        if cfg.head_bn:
            self.head_bn = nn.BatchNorm1d(cfg.mpnn.effective_output_dim,
                                          eps=1e-5, momentum=0.1,
                                          device=device)
        self.head = nn.ModuleList(
            make_linear(i, o, device=device)
            for i, o in head_widths(cfg))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.mpnn.reset_parameters(generator)
        init = "kaiming_relu" if self.cfg.kaiming_head else "torch_default"
        for layer in self.head:
            linear_init_(layer, init, generator)
        for name in ("nafm_bn", "head_bn"):
            if hasattr(self, name):
                getattr(self, name).reset_parameters()


def make_module(cfg: Union[NetworkConfig, MPNNConfig], device
                ) -> nn.Module:
    """A Network, or a bare MPNN for an MPNNConfig (bench.py's flagship),
    with uninitialized weights on `device`, in eval mode."""
    mod = Network(cfg, device=device) if isinstance(cfg, NetworkConfig) \
        else MPNN(cfg, device=device)
    return mod.eval()


def network_init(cfg: Union[NetworkConfig, MPNNConfig],
                 generator: Optional[torch.Generator] = None,
                 device=None) -> nn.Module:
    """make_module, initialized from `generator` (drawn on the CPU, so a
    seed gives the same weights on every device), on `cuda` unless
    device='cpu'."""
    device = resolve_device(device)
    mod = make_module(cfg, "cpu")
    mod.reset_parameters(generator)
    return mod.to(device)


def mpnn_input(net: Network, batch, *, training: bool = False):
    """The batch the MPNN core sees: with the graph_norm wrapper, the
    masked-bn1d nafm columns concatenated onto node_feats (gradients flow
    through the concatenation into the nafm norm). Eval mode returns the
    batch; training mode (batch, nafm_bn's new running state or None)."""
    mb = dict(batch)
    new_state = None
    if net.cfg.input_wrapper == "graph_norm":
        bn = net.nafm_bn
        if training:
            nafm, stats = bn1d_train(batch["node_nafm"], batch["node_mask"],
                                     bn.weight, bn.bias)
            new_state = ema(running_state(bn), stats)
        else:
            nafm = bn(batch["node_nafm"], batch["node_mask"])
        mb["node_feats"] = torch.cat([batch["node_feats"], nafm], dim=-1)
    return (mb, new_state) if training else mb


def network_apply_packed(net: Network, batch, *, fused: bool = True,
                         training: bool = False,
                         hooks: Optional[dict] = None):
    """Packed-batch network forward. With `fused` the MPNN core runs
    through the whole-step kernels (models/fused_train.py): the eval
    kernel, or in training the forward/backward kernels; with fused=False
    through the plain model (models/sparse.py). `hooks` — the keyword
    hooks of sparse_mpnn_apply (spmm_vocab_fn, recurrence_fn, edge_mlp_fn
    for the edge-network families; sddmm_fn, edge_mlp_fn, set2vec_fn for
    the attention families) — select the JAX package's decomposed path:
    the plain model with those ops, whatever `fused` says; a hook the
    config's family cannot use raises. Eval mode returns out
    (num_graphs, head_output); training mode normalizes with batch
    statistics and returns (out, new_state) — the running statistics
    after this step in the JAX state layout (nafm_bn, mpnn, head_bn);
    write them into the module with assign_state."""
    from mpnn_tpu_torch.models.fused_train import (fused_mpnn_eval,
                                                   fused_mpnn_out)
    from mpnn_tpu_torch.models.sparse import sparse_mpnn_apply
    if hooks is not None:
        fused = False
    hooks = hooks or {}
    if not training:
        mb = mpnn_input(net, batch)
        out = fused_mpnn_eval(net.mpnn, mb) if fused \
            else sparse_mpnn_apply(net.mpnn, mb, **hooks)
        if net.cfg.head_bn:
            out = bn_rows_eval(net.head_bn, out)
        return _head(net, out)
    new_state = {}
    mb, nafm_state = mpnn_input(net, batch, training=True)
    if nafm_state is not None:
        new_state["nafm_bn"] = nafm_state
    out, new_state["mpnn"] = fused_mpnn_out(net.mpnn, mb) if fused \
        else sparse_mpnn_apply(net.mpnn, mb, training=True, **hooks)
    if net.cfg.head_bn:
        out, new_state["head_bn"] = bn_rows_train(net.head_bn, out)
    return _head(net, out), new_state


def _head(net: Network, out):
    if not len(net.head):
        return out
    for layer in net.head[:-1]:
        out = torch.relu(layer(out))
    return net.head[-1](out)


def assign_state(net: Network, new_state: dict) -> None:
    """Write the running statistics of a training step (network_apply_packed
    (training=True)'s new_state) into the module's buffers."""
    pairs = [(getattr(net, k), v) for k, v in new_state.items()
             if k != "mpnn"]
    for key, states in new_state.get("mpnn", {}).items():
        mod = getattr(net.mpnn, key)
        pairs += (list(zip(mod, states)) if isinstance(mod, nn.ModuleList)
                  else [(mod, states)])
    with torch.no_grad():
        for mod, st in pairs:
            mod.running_mean.copy_(st["running_mean"])
            mod.running_var.copy_(st["running_var"])
