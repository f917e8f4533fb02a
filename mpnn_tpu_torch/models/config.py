"""Model configuration (a copy of mpnn_tpu/models/config.py: the port keeps
the same dataclass and contract checks, with no JAX import).

One configurable MPNN covers the reference's eight model compositions
(SURVEY.md §2.4 table). The axes of variation, with the reference file that
motivates each:

  message_fn / aggregation      models/*.py defaults
  share_message_weights         basic_model.py:29 vs normed_basic_model.py:30-33
  message_input                 'initial' everywhere except basic_model_ecfp.py:61
                                (messages computed from the ORIGINAL afm each
                                step — a documented reference quirk)
  update_hidden                 'state' in most; 'initial' in models/models.py:61,122
                                and basic_model_ecfp.py:61
  msg_norm / state_norm         lipo_basic_model.py:47-48,85 (bn1d, shared),
                                normed_basic_model.py:38,58 (stateless),
                                normed_encoded_basic_model.py:34-40 (bn1d per step)
  input_encoders + input_norm   normed_encoded_basic_model.py:48-49,67-68
  output_norm                   normed_encoded_basic_model_ecfp.py:44,70-71
  readout                       graph_level vs set2vec (att_model.py:12)
  concat_state_history          basic_model_ecfp.py:55-63

Aggregation contract (SURVEY.md §2.4 "contract hazard"): fused message fns
(edge_network, ggnn) already sum over neighbors; piping them through a
per-pair aggregator is shape-incoherent in the reference (broadcast only
works when B==N). We make the contract explicit: fused fns require
aggregation='fused'; per-pair fns (att_edge_network, bilinear) require a real
aggregator. Configs named after reference models use the proven-coherent
fused path (the lipo model's, lipo_basic_model.py:85).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MPNNConfig:
    node_features: int              # nf — node state width inside the MPNN
    edge_features: int              # ef — encoded bond feature width
    message_features: int           # mf (== nf for GRU coherence)
    output_dim: int                 # readout output width

    message_fn: str = "edge_network"   # edge_network|att_edge_network|bilinear|ggnn
    aggregation: str = "fused"         # fused|adj|wadj|att
    message_steps: int = 3
    share_message_weights: bool = True
    message_input: str = "initial"     # initial|state
    update_hidden: str = "state"       # state|initial

    msg_norm: str = "none"             # none|bn1d          (reference ma_bn)
    state_norm: str = "none"           # none|stateless|bn1d (reference bn)
    per_step_norms: bool = False       # fresh bn/ma_bn per step

    atom_encoder: Optional[str] = None  # none|'atom_ae' — in-graph frozen encoder
    bond_encoder: Optional[str] = None
    # raw input widths when encoders are present (the reference hardcodes
    # 30→15→8 and 8→4→2 for ITS dataset, atom_autoencoder.py:4-21; here the
    # AEs are sized to the data: in → in//2 → node/edge_features)
    atom_encoder_in: int = 30
    bond_encoder_in: int = 8
    input_norm: bool = False            # aebn/bebn after the encoders
    output_norm: bool = False           # obn after readout

    readout: str = "graph_level"       # graph_level|set2vec
    set2vec_steps: int = 100
    set2vec_batch_softmax: bool = True  # reference quirk (set2vec.py:139)
    concat_state_history: bool = False

    edge_mlp_tail_repeats: int = 50    # reference ×50 weight-shared tail
    ggnn_num_edge_types: int = 7
    reference_init: bool = False       # model.apply(init_weights) pass:
                                       # kaiming every Linear, zero biases
                                       # (lipo_basic_model.py:88-107); the
                                       # lipo driver depends on it — the
                                       # ×50 shared relu tail collapses
                                       # under torch-default init
    remat: bool = False                # recompute each message step in
                                       # the backward (training only)

    def __post_init__(self):
        fused = self.message_fn in ("edge_network", "ggnn")
        if fused and self.aggregation != "fused":
            raise ValueError(
                f"{self.message_fn} returns pre-aggregated messages; "
                f"aggregation must be 'fused' (got {self.aggregation!r}). "
                "See SURVEY.md §2.4 contract hazard.")
        if not fused and self.aggregation == "fused":
            raise ValueError(
                f"{self.message_fn} returns per-pair messages; pick a real "
                f"aggregator (adj|wadj|att).")
        if self.message_features != self.node_features:
            raise ValueError(
                "GRU weight shapes require message_features == node_features "
                f"(got mf={self.message_features}, nf={self.node_features}); "
                "all runnable reference configs satisfy this (SURVEY.md §2.3).")

    @property
    def readout_node_features(self) -> int:
        """The `node_features` handed to the readout constructor. The readout
        input is cat([h_T, h_0]) (width 2·nf) normally, or the full state
        history (width (steps+1)·nf) for concat_state_history — the reference
        passes 3·nf/2 as `node_features` there (basic_model_ecfp.py:26,
        steps=2 → in_dim 2·(3·nf/2) = 3·nf)."""
        if self.concat_state_history:
            return (self.message_steps + 1) * self.node_features // 2
        return self.node_features

    @property
    def effective_output_dim(self) -> int:
        """Set2Vec ignores `output_dim` and returns width 4·readout_nf
        (set2vec.py:85,148: m = [lstm_h ‖ read], each 2·nf wide)."""
        if self.readout == "set2vec":
            return 4 * self.readout_node_features
        return self.output_dim
