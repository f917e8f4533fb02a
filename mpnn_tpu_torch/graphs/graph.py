"""Graph containers produced by featurization and consumed by the batch
compiler. Two forms:

  * MolGraph  — per-molecule arrays (dense afm/nafm/bfm/adj + COO edges),
                the analog of the reference Graph2D (mol_graph.py:93-155)
                with the sparse form added for the TPU path.
  * from_mol  — featurize + build in one step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from mpnn_tpu_torch.chem.featurize import (
    atom_features, bond_features_dense, edge_list,
)
from mpnn_tpu_torch.chem.mol import Mol
from mpnn_tpu_torch.graphs.encoders import GraphEncoder


@dataclasses.dataclass
class MolGraph:
    afm: np.ndarray                 # (A, 4) raw or (A, enc) encoded
    nafm: np.ndarray                # (A, 3) raw / scaled
    bfm: np.ndarray                 # (A, A, 4) raw or (A, A, enc) encoded
    adj: np.ndarray                 # (A, A)
    edge_src: np.ndarray            # (2E,) int32
    edge_dst: np.ndarray            # (2E,) int32
    edge_feats: np.ndarray          # (2E, 4) raw or (2E, enc) encoded
    label: object = None
    affinity: Optional[float] = None
    is_encoded: bool = False
    e_dist: Optional[np.ndarray] = None     # (A, A) 3D distances (Graph3D)

    @property
    def num_atoms(self) -> int:
        return self.afm.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_src.shape[0]

    def encode(self, ge: GraphEncoder) -> "MolGraph":
        """Apply fitted encoders (mol_graph.py:136-141). Idempotent."""
        if self.is_encoded:
            return self
        self.afm = ge.encode_afm(self.afm)
        self.nafm = ge.scale_nafm(self.nafm)
        self.bfm = ge.encode_bfm(self.bfm, self.adj)
        if self.num_edges:
            self.edge_feats = ge.encode_edge_feats(self.edge_feats)
        else:
            self.edge_feats = np.zeros((0, ge.bond_width()), np.float32)
        self.is_encoded = True
        return self


def from_mol(mol: Mol, label=None, affinity=None) -> MolGraph:
    afm, nafm = atom_features(mol)
    bfm, adj = bond_features_dense(mol)
    src, dst, feats = edge_list(mol)
    return MolGraph(afm=afm, nafm=nafm, bfm=bfm, adj=adj,
                    edge_src=src, edge_dst=dst, edge_feats=feats,
                    label=label, affinity=affinity)
