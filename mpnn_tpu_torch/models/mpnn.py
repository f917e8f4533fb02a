"""The MPNN's parameters as an nn.Module (counterpart of
mpnn_tpu/models/mpnn.py::mpnn_init).

Submodule names follow the JAX parameter tree (`message/0/head/0`,
`message/0/attn`, `agg/att`, `gru`, `ma_bn/0`, `bn/0`, `readout/i`,
`readout/lstm`, `atom_encoder/enc/0`, `aebn`), so
train/checkpoint.py maps one onto the other by path. The forward passes
are functions over this module: models/sparse.py (plain) and
models/fused_train.py (the CUDA kernels).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mpnn_tpu_torch.models.config import MPNNConfig
from mpnn_tpu_torch.ops.autoencoders import TanhAutoencoder
from mpnn_tpu_torch.ops.aggregate import AttAggregate
from mpnn_tpu_torch.ops.message import AttEdgeNetwork, EdgeNetwork
from mpnn_tpu_torch.ops.norm import MaskedBatchNorm1d
from mpnn_tpu_torch.ops.readout import GraphLevelOutput, Set2Vec
from mpnn_tpu_torch.ops.update import GRU


def shared_shape(cfg: MPNNConfig) -> bool:
    """The shared-weight family (lipo, bench.py's flagship): one message
    network and one norm pair for all steps, msg/state norm in
    {bn1d, none}."""
    return (cfg.message_fn == "edge_network"
            and cfg.share_message_weights
            and cfg.msg_norm in ("bn1d", "none")
            and cfg.state_norm in ("bn1d", "none")
            and not cfg.per_step_norms
            and cfg.atom_encoder is None and cfg.bond_encoder is None
            and not cfg.input_norm)


def psteps_shape(cfg: MPNNConfig) -> bool:
    """The per-step family (graph_norm, encoded; mpnn_tpu/models/
    fused_train.py::_psteps_shape): one message network per step, and a
    bn1d norm, where there is one, per step too; msg norm in {bn1d, none},
    state norm in {bn1d, stateless, none}; encoders only with the input
    norm (it re-masks the padded rows the kernels rely on)."""
    any_bn1d = cfg.msg_norm == "bn1d" or cfg.state_norm == "bn1d"
    has_encoder = (cfg.atom_encoder is not None
                   or cfg.bond_encoder is not None)
    return (cfg.message_fn == "edge_network"
            and not cfg.share_message_weights
            and (cfg.per_step_norms or not any_bn1d)
            and cfg.msg_norm in ("bn1d", "none")
            and cfg.state_norm in ("bn1d", "stateless", "none")
            and cfg.atom_encoder in (None, "atom_ae")
            and cfg.bond_encoder in (None, "bond_ae")
            and not (has_encoder and not cfg.input_norm))


def att_shape(cfg: MPNNConfig) -> bool:
    """The collapsed attention family (adv; mpnn_tpu/models/fused_train.py:
    202-234 with update_hidden='initial'): gated messages from the initial
    state with the 'att' or 'adj' aggregation, shared weights, GRU hidden
    = the initial state, no norms and no encoders — every message step is
    then the same GRU(msgs, h0), and one application is exact."""
    return (cfg.message_fn == "att_edge_network"
            and cfg.aggregation in ("att", "adj")
            and cfg.update_hidden == "initial"
            and cfg.share_message_weights
            and cfg.msg_norm == "none" and cfg.state_norm == "none"
            and not cfg.per_step_norms
            and cfg.atom_encoder is None and cfg.bond_encoder is None
            and not cfg.input_norm
            and cfg.readout in ("set2vec", "graph_level"))


def supported(cfg: MPNNConfig) -> bool:
    """The slice of the config space the port runs, exactly what the
    whole-step kernels compute: messages from the initial state, and
    either the edge network with GRU on the evolving state, the gated
    graph-level readout and the shared or the per-step family, or the
    collapsed attention family (att_shape). Output norm (obn) is still to
    port."""
    edge = (cfg.message_fn == "edge_network"
            and cfg.update_hidden == "state"
            and cfg.readout == "graph_level"
            and (shared_shape(cfg) or psteps_shape(cfg)))
    return (cfg.message_input == "initial"
            and not cfg.output_norm
            and not cfg.concat_state_history
            and (edge or att_shape(cfg)))


def check_supported(cfg: MPNNConfig) -> None:
    if not supported(cfg):
        raise NotImplementedError(
            "mpnn_tpu_torch runs the edge_network families with graph_level "
            "readout (shared weights with msg/state norm in {bn1d, none}, "
            "or per-step weights with state norm in {bn1d, stateless, "
            "none}) and the collapsed attention family (att or adj "
            "aggregation, GRU hidden = the initial state, no norms, set2vec "
            "or graph_level readout); other configs (output_norm among "
            "them) are still to port (ROADMAP)")


class MPNN(nn.Module):
    def __init__(self, cfg: MPNNConfig, device=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        nf, mf, ef = cfg.node_features, cfg.message_features, \
            cfg.edge_features
        n_msg = 1 if cfg.share_message_weights else cfg.message_steps
        msg = AttEdgeNetwork if cfg.message_fn == "att_edge_network" \
            else EdgeNetwork
        self.message = nn.ModuleList(
            [msg(nf, ef, mf, device=device) for _ in range(n_msg)])
        if cfg.aggregation == "att":
            self.agg = AttAggregate(device=device)
        self.gru = GRU(nf, mf, device=device)
        n_norm = cfg.message_steps if cfg.per_step_norms else 1
        self.ma_bn = nn.ModuleList(
            [MaskedBatchNorm1d(mf, device=device) for _ in range(n_norm)]
            if cfg.msg_norm == "bn1d" else [])
        self.bn = nn.ModuleList(
            [MaskedBatchNorm1d(nf, device=device) for _ in range(n_norm)]
            if cfg.state_norm == "bn1d" else [])
        if cfg.atom_encoder == "atom_ae":
            i = cfg.atom_encoder_in
            self.atom_encoder = TanhAutoencoder(i, max(i // 2, nf), nf,
                                                device=device)
        if cfg.bond_encoder == "bond_ae":
            i = cfg.bond_encoder_in
            self.bond_encoder = TanhAutoencoder(i, max(i // 2, ef), ef,
                                                device=device)
        if cfg.input_norm:
            self.aebn = MaskedBatchNorm1d(nf, device=device)
            self.bebn = MaskedBatchNorm1d(ef, device=device)
        self.readout = (Set2Vec(cfg.readout_node_features, device=device)
                        if cfg.readout == "set2vec" else
                        GraphLevelOutput(cfg.readout_node_features,
                                         cfg.output_dim, device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init = "kaiming_relu" if self.cfg.reference_init else "torch_default"
        for mp in self.message:
            mp.reset_parameters(init, generator)
        self.gru.reset_parameters(generator)
        if self.cfg.readout == "set2vec":       # its own init, always
            self.readout.reset_parameters(generator)
        else:
            self.readout.reset_parameters(init, generator)
        for name in ("agg", "atom_encoder", "bond_encoder"):
            if hasattr(self, name):
                getattr(self, name).reset_parameters(generator)
        inputs = [getattr(self, n) for n in ("aebn", "bebn")
                  if hasattr(self, n)]
        for bn in [*self.ma_bn, *self.bn, *inputs]:
            bn.reset_parameters()
