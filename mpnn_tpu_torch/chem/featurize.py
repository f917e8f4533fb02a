"""Atom/bond featurization — identical output semantics to the reference
(mol_graph/mol_graph.py:25-90), RDKit-free.

Atom features (AtomFeatures.DEAFULT_FEATURES, :37-40):
  hot   : [atomic_num, hybridization]           (one-hot encoded downstream)
  bool  : [in_ring, aromatic]                   (passed through)
  numeric: [formal_charge, total_num_hs, neighbor_count]  (min-max scaled)

Bond features (BondFeatures, :60-90): [2·bond_order, aromatic, conjugated,
in_ring], with 2·order so the aromatic 1.5 becomes integer class 3 and 0 is
reserved for "no bond".
"""

from __future__ import annotations

import numpy as np

from mpnn_tpu_torch.chem.mol import Mol


# Perception-semantics version: bump whenever a chem/featurization change
# alters feature VALUES (hybridization, conjugation, ring perception, …) so
# stale graph caches refuse to load instead of silently mixing semantics
# (graphs/dataset.py::load_cache). v2 = the round-3 steric-number
# hybridization + RDKit-pairwise conjugation fixes.
FEATURIZER_VERSION = 2

ATOM_HOT_FEATURES = 2       # atomic_num, hybridization
ATOM_BOOL_FEATURES = 2      # in_ring, aromatic
ATOM_NUMERIC_FEATURES = 3   # formal_charge, total_hs, neighbor_count
BOND_FEATURES = 4           # 2·order, aromatic, conjugated, in_ring


def atom_features(mol: Mol):
    """→ (afm (A, 4) int, nafm (A, 3) int): hot+bool and numeric blocks."""
    a = mol.num_atoms()
    afm = np.empty((a, ATOM_HOT_FEATURES + ATOM_BOOL_FEATURES), np.int64)
    nafm = np.empty((a, ATOM_NUMERIC_FEATURES), np.int64)
    for atom in mol.atoms:
        i = atom.idx
        afm[i, 0] = atom.atomic_num
        afm[i, 1] = atom.hybridization
        afm[i, 2] = int(atom.in_ring)
        afm[i, 3] = int(atom.aromatic)
        nafm[i, 0] = atom.formal_charge
        nafm[i, 1] = atom.total_hs
        nafm[i, 2] = mol.degree(i)
    return afm, nafm


def bond_features_dense(mol: Mol):
    """→ (bfm (A, A, 4) int, adj (A, A) int) — symmetric dense bond-feature
    tensor + adjacency (mol_graph.py:207-219)."""
    a = mol.num_atoms()
    bfm = np.zeros((a, a, BOND_FEATURES), np.int64)
    adj = np.zeros((a, a), np.int64)
    for bond in mol.bonds:
        feats = (int(2 * bond.order), int(bond.aromatic),
                 int(bond.conjugated), int(bond.in_ring))
        i, j = bond.begin, bond.end
        bfm[i, j] = feats
        bfm[j, i] = feats
        adj[i, j] = 1
        adj[j, i] = 1
    return bfm, adj


def topological_distance(mol: Mol) -> np.ndarray:
    """(A, A) shortest-path (bond-count) matrix — the reference's
    populate_t_dist / GetDistanceMatrix (mol_graph.py:221-222; disabled in
    the reference's create_graph but part of the capability surface).
    Unreachable pairs get 1e8 (RDKit convention)."""
    import collections
    a = mol.num_atoms()
    dist = np.full((a, a), 1e8)
    for start in range(a):
        dist[start, start] = 0
        q = collections.deque([start])
        while q:
            cur = q.popleft()
            for nb in mol.neighbors(cur):
                if dist[start, nb] > dist[start, cur] + 1:
                    dist[start, nb] = dist[start, cur] + 1
                    q.append(nb)
    return dist


def edge_list(mol: Mol):
    """→ (src (2E,), dst (2E,), bond_feats (2E, 4)) — COO form, both
    directions per bond (the sparse-path native format)."""
    src, dst, feats = [], [], []
    for bond in mol.bonds:
        f = (int(2 * bond.order), int(bond.aromatic),
             int(bond.conjugated), int(bond.in_ring))
        src += [bond.begin, bond.end]
        dst += [bond.end, bond.begin]
        feats += [f, f]
    return (np.asarray(src, np.int32), np.asarray(dst, np.int32),
            np.asarray(feats, np.int64).reshape(-1, BOND_FEATURES))
