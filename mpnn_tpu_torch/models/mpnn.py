"""The MPNN's parameters as an nn.Module (counterpart of
mpnn_tpu/models/mpnn.py::mpnn_init).

Submodule names follow the JAX parameter tree (`message/0/head/0`, `gru`,
`ma_bn/0`, `bn/0`, `readout/i`), so train/checkpoint.py maps one onto the
other by path. The forward passes are functions over this module:
models/sparse.py (plain) and models/fused_train.py (the CUDA kernel).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mpnn_tpu_torch.models.config import MPNNConfig
from mpnn_tpu_torch.ops.message import EdgeNetwork
from mpnn_tpu_torch.ops.norm import MaskedBatchNorm1d
from mpnn_tpu_torch.ops.readout import GraphLevelOutput
from mpnn_tpu_torch.ops.update import GRU


def supported(cfg: MPNNConfig) -> bool:
    """The slice of the config space the port runs: the shared-weight
    edge-network family with msg/state norm in {bn1d, none} and the gated
    graph-level readout (lipo, and bench.py's flagship MPNN) — exactly what
    the whole-step eval kernel computes."""
    return (cfg.message_fn == "edge_network"
            and cfg.share_message_weights
            and cfg.message_input == "initial"
            and cfg.update_hidden == "state"
            and cfg.msg_norm in ("bn1d", "none")
            and cfg.state_norm in ("bn1d", "none")
            and not cfg.per_step_norms
            and cfg.readout == "graph_level"
            and cfg.atom_encoder is None and cfg.bond_encoder is None
            and not cfg.input_norm and not cfg.output_norm
            and not cfg.concat_state_history)


def check_supported(cfg: MPNNConfig) -> None:
    if not supported(cfg):
        raise NotImplementedError(
            "mpnn_tpu_torch runs the shared-weight edge_network family with "
            "msg/state norm in {bn1d, none} and graph_level readout; other "
            "configs are still to port (ROADMAP queue 2)")


class MPNN(nn.Module):
    def __init__(self, cfg: MPNNConfig, device=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        nf, mf = cfg.node_features, cfg.message_features
        self.message = nn.ModuleList(
            [EdgeNetwork(nf, cfg.edge_features, mf, device=device)])
        self.gru = GRU(nf, mf, device=device)
        self.ma_bn = nn.ModuleList(
            [MaskedBatchNorm1d(mf, device=device)]
            if cfg.msg_norm == "bn1d" else [])
        self.bn = nn.ModuleList(
            [MaskedBatchNorm1d(nf, device=device)]
            if cfg.state_norm == "bn1d" else [])
        self.readout = GraphLevelOutput(cfg.readout_node_features,
                                        cfg.output_dim, device=device)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init = "kaiming_relu" if self.cfg.reference_init else "torch_default"
        for mp in self.message:
            mp.reset_parameters(init, generator)
        self.gru.reset_parameters(generator)
        self.readout.reset_parameters(init, generator)
        for bn in [*self.ma_bn, *self.bn]:
            bn.reset_parameters()
