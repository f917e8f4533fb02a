"""Named model configurations (counterpart of mpnn_tpu/models/zoo.py).
The port carries the flagship `lipo`, the per-step family's `graph_norm`
and `encoded`, and the attention model `adv`; the other families are
still to port (ROADMAP).

Naming trap: the `graph_norm` MODEL (test_graph_norm.py) has the `plain`
input wrapper; the lipo shell's `graph_norm` WRAPPER is another thing."""

from __future__ import annotations

from typing import Callable, Dict

from mpnn_tpu_torch.models.config import MPNNConfig
from mpnn_tpu_torch.models.network import NetworkConfig


def lipo(afm: int, bfm: int, nafm: int, n_out: int = 1) -> NetworkConfig:
    """Lipophilicity regression (test_lipo.py): the flagship config."""
    nf = afm + nafm
    return NetworkConfig(
        mpnn=MPNNConfig(
            node_features=nf, edge_features=bfm, message_features=nf,
            output_dim=2 * afm, message_steps=6,
            share_message_weights=True, reference_init=True,
            msg_norm="bn1d", state_norm="bn1d", per_step_norms=False),
        input_wrapper="graph_norm", nafm_features=nafm,
        head="halving", head_output=n_out, head_bn=True, kaiming_head=True)


def adv(afm: int, bfm: int, nafm: int = 0, n_out: int = 4) -> NetworkConfig:
    """MolGraphModelNoRep (test_adv.py): attention message + 'att'
    aggregation, set2vec readout (100 steps, batch-global softmax), GRU
    hidden = the initial features every step (models/models.py:122)."""
    return NetworkConfig(
        mpnn=MPNNConfig(
            node_features=afm, edge_features=bfm, message_features=afm,
            output_dim=4 * afm, message_fn="att_edge_network",
            aggregation="att", update_hidden="initial",
            readout="set2vec"),
        head="linear", head_output=n_out, kaiming_head=False)


def graph_norm(afm: int, bfm: int, nafm: int = 0,
               n_out: int = 4) -> NetworkConfig:
    """normed_basic_model: per-step message fns + stateless masked BN."""
    return NetworkConfig(
        mpnn=MPNNConfig(
            node_features=afm, edge_features=bfm, message_features=afm,
            output_dim=4 * afm, message_steps=3,
            share_message_weights=False, state_norm="stateless"),
        head="linear", head_output=n_out, kaiming_head=False)


def encoded(afm: int = 30, bfm: int = 8, nafm: int = 0,
            n_out: int = 4, enc_afm: int = 8,
            enc_bfm: int = 2) -> NetworkConfig:
    """normed_encoded_basic_model: tanh encoders compress the raw widths
    (afm/bfm) down to enc_afm/enc_bfm; per-step bn1d pairs; input norms."""
    return NetworkConfig(
        mpnn=MPNNConfig(
            node_features=enc_afm, edge_features=enc_bfm,
            message_features=enc_afm,
            atom_encoder_in=afm, bond_encoder_in=bfm,
            output_dim=2 * enc_afm, message_steps=3,
            share_message_weights=False, per_step_norms=True,
            msg_norm="bn1d", state_norm="bn1d",
            atom_encoder="atom_ae", bond_encoder="bond_ae",
            input_norm=True),
        head="linear", head_output=n_out, kaiming_head=True)


ZOO: Dict[str, Callable[..., NetworkConfig]] = {
    "lipo": lipo,
    "adv": adv,
    "graph_norm": graph_norm,
    "encoded": encoded,
}


def build(name: str, **kw) -> NetworkConfig:
    return ZOO[name](**kw)
