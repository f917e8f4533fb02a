"""Packed batching iterator (copied from mpnn_tpu/graphs/dataloader.py, packed
path only; the native C++ packer and the TPU window plans are not part of
the port).

Batch composition (input order, or with `shuffle` one
RandomState(seed).shuffle of the indices per epoch) and the fixed packed
capacities are identical to the reference loader, so the two produce the
same arrays batch for batch, epoch after epoch. In place of the TPU window
plan, every batch carries the CUDA eval kernel's index plan
(graphs/batching.py::plan_fused_eval), computed on the host in numpy.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np

from mpnn_tpu_torch.graphs.batching import (attach_fused_plan, bucket_for,
                                            build_edge_vocab, collate_packed)
from mpnn_tpu_torch.graphs.graph import MolGraph


class GraphLoader:
    """Iterates packed batch dicts of numpy arrays (move them to a device
    with train/trainer.py::batch_to_device)."""

    def __init__(self, graphs: List[MolGraph], batch_size: int,
                 shuffle: bool = False, seed: int = 317,
                 collate: str = "packed"):
        if collate != "packed":
            raise NotImplementedError(
                "the port's loader has the packed collation only "
                "(ROADMAP: dense path)")
        self.graphs = graphs
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        # ONE packed shape for the whole run: cap = the worst possible batch
        # (top-batch_size graphs by node/edge count)
        self._packed_caps = None
        if graphs:
            a = sorted((g.num_atoms for g in graphs), reverse=True)
            e = sorted((g.num_edges for g in graphs), reverse=True)
            self._packed_caps = (
                bucket_for(sum(a[:batch_size]) + 1),
                bucket_for(max(sum(e[:batch_size]), 1)))
        # ONE edge-vocab capacity for the whole run: the dataset-wide
        # distinct edge-feature rows bound every batch's vocabulary. Past 64
        # distinct rows no vocab is attached and the eval kernel does not
        # apply.
        self._vocab_cap = None
        self._vocab_vids = None
        if graphs:
            efs = [g.edge_feats for g in graphs if g.num_edges]
            # +1 for the all-zero padding row (absent in real edges)
            n_distinct = (np.unique(np.concatenate(efs, axis=0),
                                    axis=0).shape[0] + 1) if efs else 1
            if n_distinct <= 64:
                self._vocab_cap = max(8, bucket_for(n_distinct))
                _, self._vocab_vids = build_edge_vocab(graphs,
                                                       self._vocab_cap)

    def __len__(self):
        return (len(self.graphs) + self.batch_size - 1) // self.batch_size

    def _epoch_chunks(self):
        idx = np.arange(len(self.graphs))
        if self.shuffle:
            self.rng.shuffle(idx)
        return [idx[s:s + self.batch_size]
                for s in range(0, len(idx), self.batch_size)]

    def __iter__(self) -> Iterator[dict]:
        for idx_chunk in self._epoch_chunks():
            yield self._collate_chunk(idx_chunk)

    def _collate_chunk(self, idx_chunk) -> dict:
        chunk = [self.graphs[i] for i in idx_chunk]
        node_cap, edge_cap = self._packed_caps
        batch = collate_packed(chunk, node_cap=node_cap,
                               edge_cap=edge_cap).as_dict()
        if self._vocab_vids is not None:
            vid = np.zeros(batch["edge_src"].shape[0], np.int32)
            off = 0
            for i in idx_chunk:
                v = self._vocab_vids[i]
                vid[off:off + v.shape[0]] = v
                off += v.shape[0]
            vfirst = np.zeros((self._vocab_cap,), np.int32)
            present, first = np.unique(vid, return_index=True)
            # ids absent from this batch keep index 0: they gather the
            # zero row, and no edge carries them — unused
            vfirst[present] = first
            batch["edge_vid"] = vid
            batch["edge_vfirst"] = vfirst
        return attach_fused_plan(batch)
