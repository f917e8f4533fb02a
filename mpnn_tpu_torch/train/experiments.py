"""Experiment registry (counterpart of mpnn_tpu/train/experiments.py): the
dataset flavor, model-zoo builder, loss and hyperparameters of each
reference training script. The port carries the flagship `lipo`, the
basic shell's `basic_classification` and `single_target`, the per-step
family's `graph_norm_classification` and `encoded_classification`, the
attention models' `adv_classification` and `att_classification`, and the
ECFP task's `encoded_ecfp` and `ecfp_bilinear`. The autoencoder model has
no experiment in either package: it is served through the API."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from mpnn_tpu_torch.train.trainer import TrainConfig


@dataclasses.dataclass(frozen=True)
class Experiment:
    name: str
    task: str                       # classification|regression|affinity|ecfp
    model: str                      # zoo builder name
    loss: str
    train: TrainConfig
    mol_col: str = "smiles"
    label_col: str = "target"
    # the reference drivers' preprocessing (train/cli.py::
    # apply_experiment_transforms; graphs/filters.py)
    binarize_target_class: Optional[int] = None   # one-vs-rest
    affinity_target_class: Optional[int] = None   # label ← affinity
    filter_lower_count: Optional[int] = None      # class-count filter
    filter_upper_count: Optional[int] = None
    filter_keep_first: Optional[int] = None
    embed_features: bool = False    # pretrained embedding features
    notes: str = ""


EXPERIMENTS: Dict[str, Experiment] = {}


def _register(e: Experiment):
    EXPERIMENTS[e.name] = e
    return e


# test.py: multi-class classification, bs 16, 500 epochs, plain Adam,
# F1 > 0.78 checkpoint gate
_register(Experiment(
    name="basic_classification", task="classification", model="basic",
    loss="ce",
    train=TrainConfig(epochs=500, batch_size=16, learning_rate=1e-3,
                      loss="ce", metric_average="weighted",
                      ckpt_f1_gate=0.78),
    notes="test.py: shared messages, no norms, one Linear head"))

# test_single_target.py: binary one-vs-rest on a hard-coded target class
# (243), basic model + 4-layer MLP head
_register(Experiment(
    name="single_target", task="classification", model="single_target",
    loss="ce",
    train=TrainConfig(epochs=500, batch_size=16, learning_rate=1e-3,
                      loss="ce", metric_average="binary"),
    binarize_target_class=243,
    notes="test_single_target.py: one-vs-rest target 243, MLP head"))

# test_adv.py: attention model, early stop once an epoch's summed train
# loss is below 0.02
_register(Experiment(
    name="adv_classification", task="classification", model="adv",
    loss="ce",
    train=TrainConfig(epochs=500, batch_size=16, learning_rate=1e-3,
                      loss="ce", early_stop_loss=0.02),
    notes="test_adv.py: MolGraphModelNoRep (AttEdge+AttAgg+Set2Vec)"))

# models/att_model.py: AttEdgeNetwork + AdjMsgAgg + per-step fns +
# stateless masked BN + Set2Vec; the reference composition has no training
# script of its own, so the hyperparameters follow the sibling attention
# script (test_adv.py) without its early stop, as the JAX package
# registers it
_register(Experiment(
    name="att_classification", task="classification", model="att",
    loss="ce",
    train=TrainConfig(epochs=500, batch_size=16, learning_rate=1e-3,
                      loss="ce"),
    notes="models/att_model.py: per-step AttEdge + stateless BN + "
          "Set2Vec (reference composition without a script of its own)"))

# test_lipo.py: regression, Adam 1e-2 / wd 1e-4 + ReduceLROnPlateau,
# batch 16, 1000 epochs
_register(Experiment(
    name="lipo", task="regression", model="lipo", loss="mse",
    train=TrainConfig(epochs=1000, batch_size=16, learning_rate=1e-2,
                      weight_decay=1e-4, loss="mse", plateau=True),
    label_col="exp",
    notes="test_lipo.py: the flagship Lipophilicity config"))

# test_graph_norm.py: normed model classification, F1 > 0.78 gate
_register(Experiment(
    name="graph_norm_classification", task="classification",
    model="graph_norm", loss="ce",
    train=TrainConfig(epochs=500, batch_size=16, learning_rate=1e-3,
                      loss="ce", ckpt_f1_gate=0.78),
    notes="test_graph_norm.py: per-step messages + stateless masked BN"))

# test_graph_encode_norm.py: encoded model, bs 128, Adam 1e-3 wd 1e-5,
# micro metrics, F1 > 0.8 gate
_register(Experiment(
    name="encoded_classification", task="classification", model="encoded",
    loss="ce",
    train=TrainConfig(epochs=500, batch_size=128, learning_rate=1e-3,
                      weight_decay=1e-5, loss="ce", metric_average="micro",
                      ckpt_f1_gate=0.8),
    notes="test_graph_encode_norm.py: tanh encoders + per-step BN pairs"))


# test_graph_encode_norm_ecfp.py: ECFP multi-label, bs 128
_register(Experiment(
    name="encoded_ecfp", task="ecfp", model="encoded_ecfp", loss="ecfp_mse",
    train=TrainConfig(epochs=500, batch_size=128, learning_rate=1e-3,
                      weight_decay=1e-5, loss="ecfp_mse"),
    notes="test_graph_encode_norm_ecfp.py: 16384-bit Morgan multi-label"))

# models/basic_model_ecfp.py: bilinear message + state-history readout on
# the per-atom ECFP multi-label task — the reference composition has no
# training script of its own; hyperparameters follow the ECFP script
_register(Experiment(
    name="ecfp_bilinear", task="ecfp", model="ecfp_bilinear",
    loss="ecfp_mse",
    train=TrainConfig(epochs=500, batch_size=128, learning_rate=1e-3,
                      weight_decay=1e-5, loss="ecfp_mse"),
    notes="models/basic_model_ecfp.py: BiLiniearEdgeNetwork + "
          "concat-state-history readout (reference composition without "
          "a script of its own)"))


def get(name: str) -> Experiment:
    if name not in EXPERIMENTS:
        raise NotImplementedError(
            f"experiment {name!r} is still to port (ported: "
            f"{', '.join(sorted(EXPERIMENTS))})")
    return EXPERIMENTS[name]
