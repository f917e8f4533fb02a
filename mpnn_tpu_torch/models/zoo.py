"""Named model configurations (counterpart of mpnn_tpu/models/zoo.py).
The port carries the flagship `lipo`, the basic shell's `basic`,
`single_target` and `autoencoder` (the shared family without norms), the
per-step family's `graph_norm`, `encoded` and `encoded_ecfp`, the
attention models `adv` and `att`, and the bilinear `ecfp_bilinear`;
`lipo_ggnn` is still to port (ROADMAP).

Naming trap: the `graph_norm` MODEL (test_graph_norm.py) has the `plain`
input wrapper; the lipo shell's `graph_norm` WRAPPER is another thing."""

from __future__ import annotations

from typing import Callable, Dict

from mpnn_tpu_torch.models.config import MPNNConfig
from mpnn_tpu_torch.models.network import NetworkConfig


def basic(afm: int, bfm: int, nafm: int = 0, n_out: int = 4) -> NetworkConfig:
    """Multi-class classification (test.py): shared messages, no norms,
    out = 4·afm, one Linear head."""
    return NetworkConfig(
        mpnn=MPNNConfig(
            node_features=afm, edge_features=bfm, message_features=afm,
            output_dim=4 * afm, message_steps=3,
            share_message_weights=True),
        head="linear", head_output=n_out, kaiming_head=False)


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


def att(afm: int, bfm: int, nafm: int = 0, n_out: int = 4) -> NetworkConfig:
    """att_model (models/att_model.py:6-59): AttEdgeNetwork messages with
    the adjacency aggregation, PER-STEP message fns, stateless masked BN
    after each GRU update (hidden = evolving state), Set2Vec readout."""
    return NetworkConfig(
        mpnn=MPNNConfig(
            node_features=afm, edge_features=bfm, message_features=afm,
            output_dim=4 * afm, message_fn="att_edge_network",
            aggregation="adj", message_steps=3,
            share_message_weights=False, state_norm="stateless",
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


def encoded_ecfp(afm: int = 30, bfm: int = 8, nafm: int = 0,
                 n_out: int = 16384, enc_afm: int = 8,
                 enc_bfm: int = 2) -> NetworkConfig:
    """ECFP multi-label: encoded model + output BN + wide head
    (test_graph_encode_norm_ecfp.py:95-100: out=32 → Linear(32, 16384))."""
    return NetworkConfig(
        mpnn=MPNNConfig(
            node_features=enc_afm, edge_features=enc_bfm,
            message_features=enc_afm,
            atom_encoder_in=afm, bond_encoder_in=bfm,
            output_dim=32, message_steps=3,
            share_message_weights=False, per_step_norms=True,
            msg_norm="bn1d", state_norm="none",
            atom_encoder="atom_ae", bond_encoder="bond_ae",
            input_norm=True, output_norm=True),
        head="linear", head_output=n_out, kaiming_head=True)


def ecfp_bilinear(afm: int = 2, bfm: int = 8, nafm: int = 0,
                  n_out: int = 16384) -> NetworkConfig:
    """basic_model_ecfp: bilinear message (ef == nf³ coherence), 2 shared
    steps, message from evolving state, GRU hidden = afm, state-history
    readout."""
    return NetworkConfig(
        mpnn=MPNNConfig(
            node_features=afm, edge_features=bfm, message_features=afm,
            output_dim=n_out if n_out <= 64 else 32,
            message_fn="bilinear", aggregation="adj",
            message_steps=2, message_input="state", update_hidden="initial",
            concat_state_history=True),
        head="none")


def autoencoder(afm: int, bfm: int, nafm: int = 0,
                n_out: int = 0) -> NetworkConfig:
    """basic_graph_autoencoder Encoder.encode(): the basic MPNN and its
    readout give the graph embeddings (decode() is an empty skeleton in
    the reference, basic_graph_autoencoder.py:44-45)."""
    return NetworkConfig(
        mpnn=MPNNConfig(
            node_features=afm, edge_features=bfm, message_features=afm,
            output_dim=n_out or 2 * afm, message_steps=3,
            share_message_weights=True),
        head="none")


def single_target(afm: int, bfm: int, nafm: int = 0,
                  n_out: int = 2) -> NetworkConfig:
    """Binary one-vs-rest (test_single_target.py:78-98): the basic MPNN
    with out = 4·afm and a 4-layer halving MLP head → 2 logits."""
    out = 4 * afm
    return NetworkConfig(
        mpnn=MPNNConfig(
            node_features=afm, edge_features=bfm, message_features=afm,
            output_dim=out, message_steps=3, share_message_weights=True),
        head="mlp",
        head_dims=(out // 2, out // 4, max(out // 8, 4), n_out),
        kaiming_head=False)


ZOO: Dict[str, Callable[..., NetworkConfig]] = {
    "single_target": single_target,
    "basic": basic,
    "lipo": lipo,
    "adv": adv,
    "att": att,
    "graph_norm": graph_norm,
    "encoded": encoded,
    "encoded_ecfp": encoded_ecfp,
    "ecfp_bilinear": ecfp_bilinear,
    "autoencoder": autoencoder,
}


def build(name: str, **kw) -> NetworkConfig:
    return ZOO[name](**kw)
