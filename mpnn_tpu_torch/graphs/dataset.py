"""Dataset loaders: CSV → molecules → encoded MolGraphs (copied from
mpnn_tpu/graphs/dataset.py; the classification, regression and ECFP
flavors, and the CSV is read with the stdlib `csv` module instead of pandas).

Reference semantics (pre_process/load_dataset.py:86-167): read CSV, parse
each molecule (skip unparseable rows), featurize, fit encoders on the FULL
dataset, encode, attach labels.
"""

from __future__ import annotations

import csv
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from mpnn_tpu_torch.chem import mol_from_smiles
from mpnn_tpu_torch.chem.ecfp import ecfp_bits_per_atom
from mpnn_tpu_torch.graphs.encoders import GraphEncoder, LabelEncoder
from mpnn_tpu_torch.graphs.graph import MolGraph, from_mol


def _read_csv_columns(path: str, columns: Sequence[str]):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    out = []
    for c in columns:
        if rows and c not in rows[0]:
            raise KeyError(c)
        out.append([r[c] for r in rows])
    return out


def _to_float(s: str) -> float:
    s = s.strip()
    return float(s) if s else float("nan")


def generate_molgraphs(mol_strs, labels=None, affinities=None,
                       parser: Callable = mol_from_smiles) -> List[MolGraph]:
    """Parse and featurize; unparseable rows are skipped."""
    graphs = []
    n = len(mol_strs)
    labels = labels if labels is not None else [None] * n
    affinities = affinities if affinities is not None else [None] * n
    for s, lab, aff in zip(mol_strs, labels, affinities):
        mol = parser(s)
        if mol is None:
            continue
        graphs.append(from_mol(mol, label=lab, affinity=aff))
    return graphs


def fit_encoders(graphs: List[MolGraph]) -> GraphEncoder:
    """Fit atom/bond encoders over the whole dataset
    (load_dataset.py:59-84)."""
    ge = GraphEncoder()
    all_afm = np.vstack([g.afm for g in graphs])
    all_nafm = np.vstack([g.nafm for g in graphs])
    ge.fit_atoms(all_afm, all_nafm)
    nfe = graphs[0].bfm.shape[-1]
    all_bfm = np.vstack([g.bfm.reshape(-1, nfe) for g in graphs])
    adj_mask = np.concatenate([g.adj.reshape(-1) for g in graphs]) == 1
    ge.fit_bonds(all_bfm, adj_mask)
    return ge


def encode_molgraphs(graphs: List[MolGraph],
                     ge: Optional[GraphEncoder] = None
                     ) -> Tuple[List[MolGraph], GraphEncoder]:
    if ge is None:
        ge = fit_encoders(graphs)
    for g in graphs:
        g.encode(ge)
    return graphs, ge


def _typed_labels(values):
    """CSV label strings typed as pandas' reader types a column: all
    integers → int, else all numbers → float, else the strings."""
    for cast in (int, float):
        try:
            return [cast(v) for v in values]
        except ValueError:
            continue
    return list(values)


def load_classification_dataset(path: str, mol_col: str, label_col: str,
                                parser=mol_from_smiles,
                                ge: Optional[GraphEncoder] = None):
    """→ (graphs, n_classes, encoded_labels, graph_encoder): labels
    LabelEncoder-encoded over the parsed molecules (load_dataset.py)."""
    mols, labels = _read_csv_columns(path, [mol_col, label_col])
    graphs = generate_molgraphs(mols, _typed_labels(labels), parser=parser)
    graphs, ge = encode_molgraphs(graphs, ge)
    le = LabelEncoder()
    encoded = le.fit_transform([g.label for g in graphs])
    ge.label_enc = le
    for g, lab in zip(graphs, encoded):
        g.label = int(lab)
    return graphs, int(encoded.max()) + 1, encoded, ge


def load_number_dataset(path: str, mol_col: str, label_col: str,
                        parser=mol_from_smiles,
                        ge: Optional[GraphEncoder] = None):
    """Regression: labels kept as floats (load_dataset.py:160-167)."""
    mols, labels = _read_csv_columns(path, [mol_col, label_col])
    graphs = generate_molgraphs(mols, [_to_float(x) for x in labels],
                                parser=parser)
    graphs, ge = encode_molgraphs(graphs, ge)
    for g in graphs:
        g.label = float(g.label)
    return graphs, ge


def load_ecfp_dataset(path: str, mol_col: str, label_col: str,
                      parser=mol_from_smiles, nbits: int = 16384,
                      radius: int = 3, ge: Optional[GraphEncoder] = None):
    """Labels := per-atom Morgan bit matrices (num_atoms, nbits), float32
    (load_dataset.py:123-132); the CSV's label column is read and
    replaced."""
    mols, labels = _read_csv_columns(path, [mol_col, label_col])
    out = []
    for s, lab in zip(mols, labels):
        mol = parser(s)
        if mol is None:
            continue
        g = from_mol(mol, label=lab)
        g.label = ecfp_bits_per_atom(mol, radius=radius, nbits=nbits)
        out.append(g)
    return encode_molgraphs(out, ge)
