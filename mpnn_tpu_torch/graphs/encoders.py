"""Feature encoders — numpy-native equivalents of the sklearn transformers
the reference fits over the whole dataset (pre_process/load_dataset.py:59-84):

  * LabelBinarizer  — one-hot over observed classes; sklearn quirk kept: with
    exactly 2 classes transform yields a SINGLE binary column (the reference
    relies on this at mol_graph.py:129: `len(classes_) if > 2 else 1`).
  * LabelEncoder    — sorted-unique → integer index.
  * MinMaxScaler    — (x-min)/(max-min) per column; zero ranges → scale 1
    (sklearn _handle_zeros_in_scale).

Plus the GraphEncoder registry: the fitted encoder bundle that the reference
keeps in a pickled process-global singleton (mol_graph.py:15-22,
pre_process/utils.py:16-22). Here it is an explicit serializable object —
no global state.
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence, Tuple

import numpy as np


class LabelBinarizer:
    def __init__(self):
        self.classes_: Optional[np.ndarray] = None

    def fit(self, y):
        self.classes_ = np.unique(np.asarray(y))
        return self

    @property
    def width(self) -> int:
        n = len(self.classes_)
        return n if n > 2 else 1

    def transform(self, y):
        y = np.asarray(y)
        n = len(self.classes_)
        idx = np.searchsorted(self.classes_, y)
        idx = np.clip(idx, 0, n - 1)
        known = self.classes_[idx] == y
        if n == 2:
            out = ((idx == 1) & known).astype(np.int64)[:, None]
        elif n == 1:
            out = np.zeros((len(y), 1), np.int64)  # sklearn: all-zero column
        else:
            out = np.zeros((len(y), n), np.int64)
            rows = np.nonzero(known)[0]
            out[rows, idx[rows]] = 1
        return out

    def to_dict(self):
        return {"classes": self.classes_.tolist()}

    @classmethod
    def from_dict(cls, d):
        lb = cls()
        lb.classes_ = np.asarray(d["classes"])
        return lb


class LabelEncoder:
    def __init__(self):
        self.classes_: Optional[np.ndarray] = None

    def fit(self, y):
        self.classes_ = np.unique(np.asarray(y))
        return self

    def transform(self, y):
        y = np.asarray(y)
        idx = np.searchsorted(self.classes_, y)
        if np.any(self.classes_[np.clip(idx, 0, len(self.classes_) - 1)] != y):
            raise ValueError("unseen labels in transform")
        return idx

    def fit_transform(self, y):
        return self.fit(y).transform(y)

    def inverse_transform(self, idx):
        return self.classes_[np.asarray(idx)]

    def to_dict(self):
        return {"classes": self.classes_.tolist()}

    @classmethod
    def from_dict(cls, d):
        le = cls()
        le.classes_ = np.asarray(d["classes"])
        return le


class MinMaxScaler:
    def __init__(self):
        self.data_min_ = None
        self.data_max_ = None

    def fit(self, x):
        x = np.asarray(x, np.float64)
        self.data_min_ = x.min(axis=0)
        self.data_max_ = x.max(axis=0)
        return self

    def transform(self, x):
        x = np.asarray(x, np.float64)
        rng = self.data_max_ - self.data_min_
        scale = np.where(rng == 0, 1.0, rng)
        return ((x - self.data_min_) / scale).astype(np.float32)

    def to_dict(self):
        return {"min": self.data_min_.tolist(), "max": self.data_max_.tolist()}

    @classmethod
    def from_dict(cls, d):
        s = cls()
        s.data_min_ = np.asarray(d["min"], np.float64)
        s.data_max_ = np.asarray(d["max"], np.float64)
        return s


class GraphEncoder:
    """Fitted encoder bundle: per-hot-feature atom binarizers + numeric
    scaler + bond binarizer + label encoder. JSON-serializable (replaces the
    reference's pickled singleton)."""

    def __init__(self):
        self.atom_enc: Optional[List[Tuple[int, LabelBinarizer]]] = None
        self.atom_scaler: Optional[MinMaxScaler] = None
        self.bond_enc: Optional[List[Tuple[int, LabelBinarizer]]] = None
        self.label_enc: Optional[LabelEncoder] = None

    # -- fitting (load_dataset.py:59-84 semantics) ---------------------------

    def fit_atoms(self, all_afm: np.ndarray, all_nafm: np.ndarray,
                  hot_features: Sequence[int] = (0, 1)):
        self.atom_enc = [(i, LabelBinarizer().fit(all_afm[:, i]))
                         for i in hot_features]
        self.atom_scaler = MinMaxScaler().fit(all_nafm)
        return self

    def fit_bonds(self, all_bfm_rows: np.ndarray, adj_mask: np.ndarray,
                  hot_features: Sequence[int] = (0,)):
        """all_bfm_rows: (R, bond_feats) stacked rows; adj_mask: (R,) bool —
        fit only on real-bond positions (load_dataset.py:74-84)."""
        self.bond_enc = [(i, LabelBinarizer().fit(all_bfm_rows[adj_mask, i]))
                         for i in hot_features]
        return self

    # -- encoded widths ------------------------------------------------------

    def atom_width(self, n_hot: int = 2, n_bool: int = 2) -> int:
        return sum(lb.width for _, lb in self.atom_enc) + n_bool

    def bond_width(self, n_bool: int = 3) -> int:
        return sum(lb.width for _, lb in self.bond_enc) + n_bool

    # -- application (mol_graph.py:111-141 semantics) ------------------------

    def encode_afm(self, afm: np.ndarray, n_features: int = 4) -> np.ndarray:
        """One-hot the hot columns, pass bool columns through; column order:
        [hot_0 1-hot ‖ hot_1 1-hot ‖ bool columns]."""
        hot_idx = [i for i, _ in self.atom_enc]
        parts = [lb.transform(afm[:, i]) for i, lb in self.atom_enc]
        bool_cols = [afm[:, i:i + 1] for i in range(n_features)
                     if i not in hot_idx]
        return np.hstack(parts + bool_cols).astype(np.float32)

    def scale_nafm(self, nafm: np.ndarray) -> np.ndarray:
        return self.atom_scaler.transform(nafm)

    def encode_bfm(self, bfm: np.ndarray, adj: np.ndarray,
                   n_features: int = 4) -> np.ndarray:
        """One-hot the bond-type column ONLY at real-bond positions (padding
        and non-bonds stay all-zero — mol_graph.py:125-133); bools pass
        through."""
        a = bfm.shape[0]
        rows = bfm.reshape(-1, n_features)
        mask = adj.reshape(-1) == 1
        hot_idx = [i for i, _ in self.bond_enc]
        parts = []
        for i, lb in self.bond_enc:
            t = np.zeros((rows.shape[0], lb.width), np.float32)
            t[mask] = lb.transform(rows[mask, i])
            parts.append(t)
        bool_cols = [rows[:, i:i + 1].astype(np.float32)
                     for i in range(n_features) if i not in hot_idx]
        out = np.hstack(parts + bool_cols)
        return out.reshape(a, a, -1)

    def encode_edge_feats(self, feats: np.ndarray,
                          n_features: int = 4) -> np.ndarray:
        """COO variant: encode (E, n_features) rows of REAL bonds."""
        hot_idx = [i for i, _ in self.bond_enc]
        parts = [lb.transform(feats[:, i]).astype(np.float32)
                 for i, lb in self.bond_enc]
        bool_cols = [feats[:, i:i + 1].astype(np.float32)
                     for i in range(n_features) if i not in hot_idx]
        return np.hstack(parts + bool_cols)

    # -- serialization -------------------------------------------------------

    def to_json(self) -> str:
        return json.dumps({
            "atom_enc": [[i, lb.to_dict()] for i, lb in (self.atom_enc or [])],
            "atom_scaler": self.atom_scaler.to_dict() if self.atom_scaler else None,
            "bond_enc": [[i, lb.to_dict()] for i, lb in (self.bond_enc or [])],
            "label_enc": self.label_enc.to_dict() if self.label_enc else None,
        })

    @classmethod
    def from_json(cls, s: str) -> "GraphEncoder":
        d = json.loads(s)
        ge = cls()
        if d["atom_enc"]:
            ge.atom_enc = [(i, LabelBinarizer.from_dict(x))
                           for i, x in d["atom_enc"]]
        if d["atom_scaler"]:
            ge.atom_scaler = MinMaxScaler.from_dict(d["atom_scaler"])
        if d["bond_enc"]:
            ge.bond_enc = [(i, LabelBinarizer.from_dict(x))
                           for i, x in d["bond_enc"]]
        if d["label_enc"]:
            ge.label_enc = LabelEncoder.from_dict(d["label_enc"])
        return ge
