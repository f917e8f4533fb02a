"""Named model configurations (counterpart of mpnn_tpu/models/zoo.py).
The port carries the flagship only; the other families are still to port
(ROADMAP queue 2)."""

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


ZOO: Dict[str, Callable[..., NetworkConfig]] = {
    "lipo": lipo,
}


def build(name: str, **kw) -> NetworkConfig:
    return ZOO[name](**kw)
