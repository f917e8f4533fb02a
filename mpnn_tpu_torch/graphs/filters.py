"""Dataset filtering and relabeling of the reference drivers (counterpart
of mpnn_tpu/graphs/filters.py; numpy only).

  * filter_by_label_count — keep only the classes whose sample count
    passes the cutoffs, relabeled to a dense 0..K-1 range
    (test_lipo.py:25-45, test_graph_encode_norm.py:25-46: lower and upper
    count cutoffs, an optional cap of the first passing classes).
  * binarize_target — one-vs-rest labels for one target class
    (test_single_target.py:101, target 243).
  * affinity_labels — label := affinity where label == target class, else
    a constant (test_graph_encode_affinity.py:126-128).

Each relabels the graphs in place, as the JAX package's functions do.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from mpnn_tpu_torch.graphs.graph import MolGraph


def filter_by_label_count(graphs: List[MolGraph],
                          lower_cutoff: Optional[int] = None,
                          upper_cutoff: Optional[int] = None,
                          keep_first: Optional[int] = None
                          ) -> Tuple[List[MolGraph], List[int], int]:
    """(the graphs of the kept classes, relabeled; their new labels; the
    number of kept classes). A class is kept when its count is above
    lower_cutoff and below upper_cutoff; keep_first then keeps only the
    first that many of them, in label order."""
    labels = np.asarray([g.label for g in graphs])
    uniq, count = np.unique(labels, return_counts=True)
    mask = np.ones_like(uniq, dtype=bool)
    if lower_cutoff is not None:
        mask = count > lower_cutoff
    if upper_cutoff is not None:
        mask = np.logical_and(mask, count < upper_cutoff)
    if keep_first is not None:
        positive = np.argwhere(mask).reshape(-1)[:keep_first]
        mask = np.zeros_like(uniq, dtype=bool)
        mask[positive] = True
    keep = set(uniq[mask].tolist())
    relabel = {lab: i for i, lab in enumerate(sorted(keep))}
    out, new_labels = [], []
    for g in graphs:
        if g.label in keep:
            g.label = relabel[g.label]
            new_labels.append(g.label)
            out.append(g)
    return out, new_labels, len(keep)


def binarize_target(graphs: List[MolGraph], target) -> List[MolGraph]:
    """label ← 1 if label == target else 0 (one-vs-rest)."""
    for g in graphs:
        g.label = int(g.label == target)
    return graphs


def affinity_labels(graphs: List[MolGraph], target,
                    default: float = 4.0) -> List[MolGraph]:
    """label ← the graph's affinity where its class is `target`, else
    `default` (the reference's constant 4 for the other molecules)."""
    for g in graphs:
        g.label = float(g.affinity) if g.label == target else float(default)
    return graphs
