"""The port's host pipeline (mpnn_tpu_torch.chem / .graphs, numpy only)
against mpnn_tpu's: featurize → collate_packed → attach_edge_vocab →
GraphLoader(collate="packed") must give bit-identical arrays, and the
eval kernel's index plan must agree with edge_dst and node_graph."""

import os

import numpy as np
import pytest

import bench
from mpnn_tpu import graphs as JG
from mpnn_tpu_torch import graphs as TG
from mpnn_tpu_torch.graphs.batching import PLAN_KEYS, plan_fused_eval

# bench.py's ten molecules plus single-atom molecules (no edges)
SMILES = bench.SMILES + ["C", "O", "CCO"]


def _graphs(mod, smiles):
    gs = mod.generate_molgraphs(smiles, [0.1 * i for i in range(len(smiles))])
    return mod.encode_molgraphs(gs)


def _assert_same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a, b), what


def test_featurize_bit_identical():
    jg, jge = _graphs(JG, SMILES)
    tg, tge = _graphs(TG, SMILES)
    assert len(jg) == len(tg) == len(SMILES)
    assert jge.to_json() == tge.to_json()
    for i, (a, b) in enumerate(zip(jg, tg)):
        for field in ("afm", "nafm", "bfm", "adj", "edge_src", "edge_dst",
                      "edge_feats"):
            _assert_same(getattr(a, field), getattr(b, field),
                         f"graph {i} {field}")


def test_collate_and_vocab_bit_identical():
    jg, _ = _graphs(JG, SMILES)
    tg, _ = _graphs(TG, SMILES)
    jb = JG.attach_edge_vocab(JG.collate_packed(jg).as_dict(), 16)
    tb = TG.attach_edge_vocab(TG.collate_packed(tg).as_dict(), 16)
    assert set(jb) == set(tb)
    for k in jb:
        _assert_same(jb[k], tb[k], k)


@pytest.mark.parametrize("batch_size,use_native", [(16, False), (16, True),
                                                   (5, False), (5, True)])
def test_graphloader_bit_identical(batch_size, use_native):
    """Same batch composition, caps, vocab ids — the python packer and the
    native one of the reference both agree with the port."""
    smiles = (SMILES * 4)[:45]
    jg, _ = _graphs(JG, smiles)
    tg, _ = _graphs(TG, smiles)
    jl = JG.GraphLoader(jg, batch_size, collate="packed",
                        use_native=use_native)
    tl = TG.GraphLoader(tg, batch_size, collate="packed")
    jbs, tbs = list(jl), list(tl)
    assert len(jbs) == len(tbs) == len(jl) == len(tl)
    for jb, tb in zip(jbs, tbs):
        assert set(tb) - set(jb) == set(PLAN_KEYS)
        for k in jb:
            if k == "num_graphs":
                assert int(jb[k]) == int(tb[k])
                continue
            _assert_same(jb[k], tb[k], k)


def test_index_plan_consistent():
    smiles = (SMILES * 3)[:37]
    tg, _ = _graphs(TG, smiles)
    for b in TG.GraphLoader(tg, 16, collate="packed"):
        dst, src = b["edge_dst"], b["edge_src"]
        ng, g = b["node_graph"], b["graph_mask"].shape[0]
        order = b["plan_edge_order"]
        n = ng.shape[0]
        # a stable destination sort: a permutation, sorted by dst, ties in
        # batch order
        assert sorted(order.tolist()) == list(range(dst.shape[0]))
        assert np.all(np.diff(dst[order]) >= 0)
        for d in range(n):
            seg = order[b["plan_dst_ptr"][d]:b["plan_dst_ptr"][d + 1]]
            assert np.all(dst[seg] == d) and np.all(np.diff(seg) > 0)
        gnp, gep = b["plan_graph_node_ptr"], b["plan_graph_edge_ptr"]
        assert gnp.shape == gep.shape == (g + 1,)
        for gi in range(g):
            assert np.all(ng[gnp[gi]:gnp[gi + 1]] == gi)
            seg = order[gep[gi]:gep[gi + 1]]
            # graph gi's edges: same range before and after the sort, both
            # endpoints inside the graph
            assert np.array_equal(np.sort(seg), np.arange(gep[gi],
                                                          gep[gi + 1]))
            assert np.all(ng[src[seg]] == gi) and np.all(ng[dst[seg]] == gi)
        assert np.all(ng[gnp[g]:] == g)
        for k in PLAN_KEYS:
            assert b[k].dtype == np.int32


def test_plan_single_atom_graphs():
    """Edgeless graphs get empty edge ranges; their nodes empty rows."""
    node_graph = np.array([0, 1, 1, 2, 3, 3], np.int32)
    dst = np.array([1, 2, 5, 5], np.int32)          # two pad edges → node 5
    plan = plan_fused_eval(dst, node_graph, 3)
    assert plan.graph_node_ptr.tolist() == [0, 1, 3, 4]
    assert plan.graph_edge_ptr.tolist() == [0, 0, 2, 2]
    assert plan.dst_ptr.tolist() == [0, 0, 1, 2, 2, 2, 4]


def test_csv_dataset_matches_pandas_reader(tmp_path):
    import pandas as pd
    p = os.path.join(str(tmp_path), "d.csv")
    pd.DataFrame({"smiles": SMILES,
                  "exp": [0.37 * i - 1.1 for i in range(len(SMILES))]}
                 ).to_csv(p, index=False)
    jg, jge = JG.load_number_dataset(p, "smiles", "exp")
    tg, tge = TG.load_number_dataset(p, "smiles", "exp")
    assert jge.to_json() == tge.to_json()
    # pandas' default float parser may differ from the correctly rounded
    # float() by an ulp of the double; labels enter the model as float32
    np.testing.assert_array_equal(
        np.asarray([g.label for g in jg], np.float32),
        np.asarray([g.label for g in tg], np.float32))
    np.testing.assert_allclose([g.label for g in jg],
                               [g.label for g in tg], rtol=1e-13)
    for a, b in zip(jg, tg):
        _assert_same(a.afm, b.afm, "afm")
        _assert_same(a.edge_feats, b.edge_feats, "edge_feats")
