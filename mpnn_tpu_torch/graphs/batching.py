"""Packed batches: variable-size graphs → one flat node axis and one flat
edge axis, padded to bucketed capacities (copied from
mpnn_tpu/graphs/batching.py; the dense layouts are not part of the port yet).

Padded edges point at a dedicated dummy node slot (the last one) with zero
features; padded nodes carry node_graph == num_graphs and mask 0. Graphs
are laid out node-contiguous and edge-contiguous, in batch order — the
property the CUDA eval kernel's per-graph index plan relies on
(plan_fused_eval below).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np

from mpnn_tpu_torch.graphs.graph import MolGraph


DEFAULT_NODE_BUCKETS = (8, 16, 24, 32, 48, 64, 96, 128)


def bucket_for(n: int, buckets: Sequence[int] = DEFAULT_NODE_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return int(np.ceil(n / 128.0)) * 128


@dataclasses.dataclass
class PackedBatch:
    """Flat node axis of capacity `node_cap` (last slot = dummy sink for
    padded edges), edge axis of capacity `edge_cap`.

    node_feats : (node_cap, f)    zero rows at padding + dummy
    node_nafm  : (node_cap, fn)
    node_mask  : (node_cap, 1)    1 = real node
    node_graph : (node_cap,)      graph id per node (dummy/pad → num_graphs)
    edge_src   : (edge_cap,)      into the node axis (pad → node_cap-1)
    edge_dst   : (edge_cap,)
    edge_feats : (edge_cap, e)    zero rows at padding
    edge_mask  : (edge_cap,)      1 = real edge
    num_graphs : int
    labels     : (num_graphs, …)
    graph_mask : (num_graphs,)    1 = real graph (for padded graph slots)
    node_labels: (node_cap, nbits) per-atom label rows (the ECFP task's
                 bit matrices), zero at padding; absent otherwise
    """
    node_feats: np.ndarray
    node_nafm: np.ndarray
    node_mask: np.ndarray
    node_graph: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_feats: np.ndarray
    edge_mask: np.ndarray
    labels: np.ndarray
    graph_mask: np.ndarray
    num_graphs: int
    node_labels: Optional[np.ndarray] = None

    def as_dict(self) -> Dict[str, np.ndarray]:
        """The fields by name, without copies (dataclasses.asdict would
        deep-copy every array, node_labels' hundreds of MB among them);
        node_labels only where the batch has them."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if f.name != "node_labels" or self.node_labels is not None}


def collate_packed(graphs: List[MolGraph],
                   node_cap: Optional[int] = None,
                   edge_cap: Optional[int] = None,
                   num_graphs: Optional[int] = None) -> PackedBatch:
    total_nodes = sum(g.num_atoms for g in graphs)
    total_edges = sum(g.num_edges for g in graphs)
    node_cap = node_cap or bucket_for(total_nodes + 1)
    edge_cap = edge_cap or bucket_for(total_edges)
    ng = num_graphs or len(graphs)
    if total_nodes + 1 > node_cap or total_edges > edge_cap:
        raise ValueError("batch exceeds packed capacity")

    fa = graphs[0].afm.shape[-1]
    fn = graphs[0].nafm.shape[-1]
    fe = graphs[0].edge_feats.shape[-1]
    node_feats = np.zeros((node_cap, fa), np.float32)
    node_nafm = np.zeros((node_cap, fn), np.float32)
    node_mask = np.zeros((node_cap, 1), np.float32)
    node_graph = np.full((node_cap,), ng, np.int32)
    edge_src = np.full((edge_cap,), node_cap - 1, np.int32)
    edge_dst = np.full((edge_cap,), node_cap - 1, np.int32)
    edge_feats = np.zeros((edge_cap, fe), np.float32)
    edge_mask = np.zeros((edge_cap,), np.float32)
    graph_mask = np.zeros((ng,), np.float32)

    n_off = e_off = 0
    for gi, g in enumerate(graphs):
        a, e = g.num_atoms, g.num_edges
        node_feats[n_off:n_off + a] = g.afm
        node_nafm[n_off:n_off + a] = g.nafm
        node_mask[n_off:n_off + a] = 1.0
        node_graph[n_off:n_off + a] = gi
        edge_src[e_off:e_off + e] = g.edge_src + n_off
        edge_dst[e_off:e_off + e] = g.edge_dst + n_off
        edge_feats[e_off:e_off + e] = g.edge_feats
        edge_mask[e_off:e_off + e] = 1.0
        graph_mask[gi] = 1.0
        n_off += a
        e_off += e

    node_labels = None
    first = np.asarray(graphs[0].label) if graphs[0].label is not None \
        else None
    if first is not None and first.ndim == 2 \
            and first.shape[0] == graphs[0].num_atoms:
        # per-atom label matrices (the ECFP task) ride the node axis
        node_labels = np.zeros((node_cap, first.shape[-1]), first.dtype)
        n_off = 0
        for g in graphs:
            node_labels[n_off:n_off + g.num_atoms] = g.label
            n_off += g.num_atoms
        labels = np.zeros((ng,), np.float32)
    else:
        labels = np.stack([np.asarray(g.label) for g in graphs]) \
            if first is not None else np.zeros((len(graphs),))
        if labels.shape[0] < ng:
            pad = np.zeros((ng - labels.shape[0],) + labels.shape[1:],
                           labels.dtype)
            labels = np.concatenate([labels, pad])
    return PackedBatch(node_feats, node_nafm, node_mask, node_graph,
                       edge_src, edge_dst, edge_feats, edge_mask,
                       labels, graph_mask, ng, node_labels)


def build_edge_vocab(graphs, vocab_cap: int = 32):
    """Dataset-wide edge vocabulary, computed once per run: the distinct
    encoded bond-feature rows with the all-zero (padding) row pinned at
    id 0, plus a cached per-graph vid array.

    Returns (rows (vocab_cap, ef) float32, vids: list aligned with
    `graphs`) or (None, None) when the dataset has more than vocab_cap
    distinct rows. Exact: identical rows map to identical penultimates;
    id 0 = the zero row makes A_0 the exact zero matrix."""
    efs = [g.edge_feats for g in graphs if g.num_edges]
    if efs:
        uniq = np.unique(np.concatenate(efs, axis=0), axis=0)
    else:
        uniq = np.zeros((0, graphs[0].edge_feats.shape[-1]
                         if graphs else 0), np.float32)
    fe = uniq.shape[1]
    zero = np.zeros((1, fe), uniq.dtype)
    nonzero = uniq[np.any(uniq != 0, axis=1)]
    rows = np.concatenate([zero, nonzero], axis=0)
    if rows.shape[0] > vocab_cap:
        return None, None
    lookup = {r.tobytes(): i for i, r in enumerate(rows)}
    vids = []
    for g in graphs:
        vids.append(np.asarray(
            [lookup[r.tobytes()] for r in np.asarray(g.edge_feats)],
            np.int32))
    rows = np.concatenate(
        [rows, np.zeros((vocab_cap - rows.shape[0], fe), rows.dtype)])
    return rows.astype(np.float32), vids


def attach_edge_vocab(batch: Dict[str, np.ndarray],
                      vocab_cap: int = 32) -> Dict[str, np.ndarray]:
    """Append the edge-feature vocabulary to a packed batch:

      edge_vid    (edge_cap,)   int32 — distinct-row id per edge
      edge_vfirst (vocab_cap,)  int32 — first edge index carrying each id

    The ×50-tail edge MLP then runs once per distinct feature row, not once
    per edge (models/sparse.py::_edge_penultimates). If the batch has more
    than vocab_cap distinct rows, the keys are not added."""
    ef = np.asarray(batch["edge_feats"])
    uniq, first_idx, inv = np.unique(ef, axis=0, return_index=True,
                                     return_inverse=True)
    if uniq.shape[0] > vocab_cap:
        return batch
    out = dict(batch)
    out["edge_vid"] = inv.reshape(-1).astype(np.int32)
    vfirst = np.zeros((vocab_cap,), np.int32)
    vfirst[:first_idx.shape[0]] = first_idx
    out["edge_vfirst"] = vfirst
    return out


# ---------------------------------------------------------------------------
# the CUDA eval kernel's index plan (kernels/fused_step.py)
# ---------------------------------------------------------------------------

class FusedEvalPlan(NamedTuple):
    edge_order: np.ndarray      # (E,) int32 edge ids, stably sorted by dst
    dst_ptr: np.ndarray         # (N+1,) int32 row pointers into edge_order
    graph_node_ptr: np.ndarray  # (G+1,) int32 node range of each graph
    graph_edge_ptr: np.ndarray  # (G+1,) int32 edge range of each graph


PLAN_KEYS = ("plan_edge_order", "plan_dst_ptr", "plan_graph_node_ptr",
             "plan_graph_edge_ptr")


def plan_fused_eval(edge_dst: np.ndarray, node_graph: np.ndarray,
                    num_graphs: int) -> FusedEvalPlan:
    """The kernel's index plan for one packed batch. The stable sort keeps
    each node's incoming edges in batch order, so sums run in a fixed
    order. collate_packed lays graphs out node- and edge-contiguous and the
    padded edges point at the last (dummy) node, so graph g's edges occupy
    the same range before and after the sort."""
    dst = np.asarray(edge_dst).astype(np.int64)
    ng = np.asarray(node_graph).astype(np.int64)
    n = ng.shape[0]
    order = np.argsort(dst, kind="stable").astype(np.int32)
    counts = np.bincount(dst, minlength=n)
    dst_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    gnp = np.searchsorted(ng, np.arange(num_graphs + 1),
                          side="left").astype(np.int32)
    return FusedEvalPlan(order, dst_ptr, gnp, dst_ptr[gnp].astype(np.int32))


def attach_fused_plan(batch: dict) -> dict:
    """Append the index plan (PLAN_KEYS) to a packed batch dict."""
    plan = plan_fused_eval(batch["edge_dst"], batch["node_graph"],
                           int(np.asarray(batch["graph_mask"]).shape[0]))
    out = dict(batch)
    for k, v in zip(PLAN_KEYS, plan):
        out[k] = v
    return out


def plan_from_batch(batch: dict) -> FusedEvalPlan:
    return FusedEvalPlan(*(batch[k] for k in PLAN_KEYS))
