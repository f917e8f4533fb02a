"""Experiment registry (counterpart of mpnn_tpu/train/experiments.py): the
dataset flavor, model-zoo builder, loss and hyperparameters of each
reference driver. The port carries the flagship `lipo` entry."""

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


# test_lipo.py: regression, Adam 1e-2 / wd 1e-4 + ReduceLROnPlateau,
# batch 16, 1000 epochs
_register(Experiment(
    name="lipo", task="regression", model="lipo", loss="mse",
    train=TrainConfig(epochs=1000, batch_size=16, learning_rate=1e-2,
                      weight_decay=1e-4, plateau=True),
    label_col="exp",
    notes="test_lipo.py: the flagship Lipophilicity config"))


def get(name: str) -> Experiment:
    if name not in EXPERIMENTS:
        raise NotImplementedError(
            f"experiment {name!r} is still to port (ported: "
            f"{', '.join(sorted(EXPERIMENTS))})")
    return EXPERIMENTS[name]
