"""Experiment registry (counterpart of mpnn_tpu/train/experiments.py): the
dataset flavor, model-zoo builder, loss and hyperparameters of each
reference training script. The port carries the flagship `lipo`, the
per-step family's `graph_norm_classification` and
`encoded_classification`, and the attention model's
`adv_classification`."""

from __future__ import annotations

import dataclasses
from typing import Dict

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
    notes: str = ""


EXPERIMENTS: Dict[str, Experiment] = {}


def _register(e: Experiment):
    EXPERIMENTS[e.name] = e
    return e


# test_adv.py: attention model, early stop once an epoch's summed train
# loss is below 0.02
_register(Experiment(
    name="adv_classification", task="classification", model="adv",
    loss="ce",
    train=TrainConfig(epochs=500, batch_size=16, learning_rate=1e-3,
                      loss="ce", early_stop_loss=0.02),
    notes="test_adv.py: MolGraphModelNoRep (AttEdge+AttAgg+Set2Vec)"))

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


def get(name: str) -> Experiment:
    if name not in EXPERIMENTS:
        raise NotImplementedError(
            f"experiment {name!r} is still to port (ported: "
            f"{', '.join(sorted(EXPERIMENTS))})")
    return EXPERIMENTS[name]
