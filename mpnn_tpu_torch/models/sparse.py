"""Sparse (packed COO) MPNN forward in plain PyTorch, eval and training
mode (counterpart of mpnn_tpu/models/sparse.py) — the model the CUDA
kernels' paths are tested against. Differentiable throughout: the edge-MLP
tail and the A-form fold get their gradient from autograd. The attention
family runs per edge (the penultimates through the final layer, the gate
from the edge's own features) and takes every message step literally, as
the JAX package's loop does: nothing here assumes the kernels' collapse.
The bilinear family runs its per-edge message from the edge features
themselves, in the reference's literal index order.

The families take the JAX package's hooks of the decomposed training path
(its `train --packed --spmm kernel`). The edge-network families:
`spmm_vocab_fn`, the A-form message sum (kernels/spmm.py),
`recurrence_fn`, the whole BN→GRU→BN chain of the lipo family in one op
(kernels/recurrence.py, where recurrence_eligible), and `edge_mlp_fn`,
the vocab chain (kernels/edge_mlp.py). The attention families:
`sddmm_fn`, the gated message sum (kernels/sddmm.py), `edge_mlp_fn`, and
`set2vec_fn`, the set2vec readout (kernels/set2vec.py). The bilinear
family takes none. A hook that the config's family cannot use raises:
none is dropped. Without hooks every piece is plain PyTorch.

Exactness of the A-form for the edge-network family (bias leakage): with
A(e) = W̃(p_e) + Bf and p_e the edge-MLP penultimate features,

    m_v = Σ_{real edges w→v} (A(e) − A(0)) h_w  +  A(0) · Σ_{w∈graph} h_w

Padded edges carry the zero row's vocab id, so A(e) − A(0) = 0 for them.
"""

from __future__ import annotations

import torch

from mpnn_tpu_torch.graphs.batching import plan_from_batch
from mpnn_tpu_torch.models.config import MPNNConfig
from mpnn_tpu_torch.kernels.set2vec import set2vec_reference
from mpnn_tpu_torch.models.mpnn import (MPNN, att_shape, att_steps_shape,
                                        bilinear_shape, check_supported,
                                        shared_shape)
from mpnn_tpu_torch.ops.autoencoders import tanh_encoder_apply
from mpnn_tpu_torch.ops.message import (AttEdgeNetwork, EdgeNetwork,
                                        _edge_mlp_penultimate,
                                        bilinear_message)
from mpnn_tpu_torch.ops.norm import (bn1d_train, ema, mask_batch_norm,
                                     running_state)
from mpnn_tpu_torch.ops.readout import GraphLevelOutput, Set2Vec, gated_rows
from mpnn_tpu_torch.ops.update import gru_apply


def _edge_penultimates(mp: EdgeNetwork, edge_feats, cfg: MPNNConfig,
                       edge_vfirst, edge_mlp_fn=None):
    """The zero-edge penultimate (1, pf) and the vocab table (K, pf): the
    ×50-tail MLP runs on the K distinct rows plus the zero row, in one
    chain. (The A-form needs no per-edge gather of the table.)

    edge_mlp_fn(e, head_ws, head_bs, shared_w), weights in the JAX layout
    (in, out) — optional: the chain as one op (kernels/edge_mlp.py), as
    the JAX package's hook of the same name takes it."""
    zero = edge_feats.new_zeros((1, edge_feats.shape[-1]))
    vocab = edge_feats[edge_vfirst.long()]                    # (K, ef)
    rows = torch.cat([vocab, zero], dim=0)
    if edge_mlp_fn is None:
        pen_both = _edge_mlp_penultimate(mp, rows, cfg.edge_mlp_tail_repeats)
    else:
        pen_both = edge_mlp_fn(rows, tuple(l.weight.t() for l in mp.head),
                               tuple(l.bias for l in mp.head),
                               mp.shared.weight.t())
    return pen_both[-1:], pen_both[:-1]


def final_weights(mp: EdgeNetwork, nf: int, mf: int):
    """The final projection as wf (pf, mf, nf) and bf (mf, nf) — the JAX
    layout, from nn.Linear's (nf·mf, pf) weight."""
    pf = mp.final.weight.shape[1]
    wf = mp.final.weight.t().reshape(pf, mf, nf)
    bf = mp.final.bias.reshape(mf, nf)
    return wf, bf


def a_form(mp: EdgeNetwork, pen0, pen_vocab, nf: int, mf: int):
    """Fold the penultimates through the final layer: A_k = Σ_p (pen_k −
    pen_0)[p]·W̃[p] (K, mf, nf), and the bias-leakage matrix
    A0 = Σ_p pen_0[p]·W̃[p] + Bf (mf, nf)."""
    wf, bf = final_weights(mp, nf, mf)
    amat = torch.einsum("kp,pmf->kmf", pen_vocab - pen0, wf)
    a0 = torch.einsum("p,pmf->mf", pen0[0], wf) + bf
    return amat, a0


def sparse_edge_network_fused(mp: EdgeNetwork, pen0, h, edge_src,
                              edge_dst, node_graph, graph_mask, *, nf: int,
                              mf: int, pen_vocab, edge_vid,
                              spmm_vocab_fn=None, plan=None):
    """m = SpMM(edges) + A(0)·S_graph + message_bias (the A-form branch).
    h: (node_cap, nf) → (node_cap, mf). With spmm_vocab_fn the SpMM is
    spmm_vocab_fn(amat, h, vid, src, dst, plan) (plan: the batch's index
    plan); the A0 term and message_bias stay here, as the JAX package
    keeps them in XLA."""
    node_cap = h.shape[0]
    amat, a0 = a_form(mp, pen0, pen_vocab, nf, mf)
    if spmm_vocab_fn is not None:
        agg = spmm_vocab_fn(amat, h, edge_vid, edge_src, edge_dst, plan)
    else:
        v2 = torch.einsum("kmf,nf->knm", amat, h)             # (K, N, mf)
        edge_msg = v2[edge_vid.long(), edge_src.long()]
        agg = h.new_zeros((node_cap, mf)).index_add_(0, edge_dst.long(),
                                                     edge_msg)
    num_graphs = graph_mask.shape[0]
    ng = node_graph.long()
    s = h.new_zeros((num_graphs + 1, h.shape[1])).index_add_(0, ng, h)
    base = s[ng] @ a0.T
    return agg + base + mp.message_bias


def sparse_graph_level_output(ro: GraphLevelOutput, x, node_mask,
                              node_graph, num_graphs: int):
    """Packed gated readout: per-node gating, then a sum per graph."""
    gated = gated_rows(ro, x, node_mask)
    out = gated.new_zeros((num_graphs + 1, gated.shape[-1]))
    return out.index_add_(0, node_graph.long(), gated)[:-1]


def sparse_att_edge_network(mp: AttEdgeNetwork, pen0, pen_vocab, h,
                            edge_feats, edge_vid, edge_src, edge_dst,
                            node_graph, num_graphs: int, *, nf: int, mf: int,
                            aggregation: str, edge_vfirst=None,
                            sddmm_fn=None, plan=None):
    """The attention message family (mpnn_tpu/models/sparse.py::
    sparse_att_edge_network): per pair m(v, w) = A(e_vw)·(softmax_feat(
    attn([h_v ‖ e_vw])) ⊙ h_w) with A(e) = W̃·pen(e) + Bf. 'adj' sums the
    real edges; 'att' (the learned singleton softmax, constant 1) sums
    every pair of the graph: the non-edges, whose edge features are zero,
    decompose per node into A(0)·(g0_v ⊙ S_g) minus the same term over the
    real edges. h: (node_cap, nf) → (node_cap, mf).

    The edge sum runs per edge in PyTorch, or with sddmm_fn as
    sddmm_fn(aprime, evocab, wa, ba, h, vid, src, dst, plan) (plan: the
    batch's index plan) on the per-vocab matrices A'_k = Σ_p pen_k[p]·W̃[p]
    + Bf (the final bias kept: not the A-form's pen_k − pen_0), the vocab's
    bond rows and attn's weight in the JAX (in, out) layout. The 'att'
    correction stays here, as the JAX package keeps it in XLA."""
    node_cap = h.shape[0]
    wf, bf = final_weights(mp, nf, mf)
    src, dst = edge_src.long(), edge_dst.long()
    h_src = h[src]
    if sddmm_fn is not None:
        aprime = torch.einsum("kp,pmf->kmf", pen_vocab, wf) + bf
        evocab = edge_feats[edge_vfirst.long()]
        agg = sddmm_fn(aprime, evocab, mp.attn.weight.t(), mp.attn.bias, h,
                       edge_vid, edge_src, edge_dst, plan)
    else:
        pen = pen_vocab[edge_vid.long()]                      # (E, pf)
        gate = torch.softmax(mp.attn(torch.cat([h[dst], edge_feats], -1)),
                             -1)
        g = gate * h_src
        t = torch.einsum("pmf,ef->epm", wf, g)
        edge_msg = torch.einsum("ep,epm->em", pen, t) + g @ bf.T
        agg = h.new_zeros((node_cap, mf)).index_add_(0, dst, edge_msg)
    if aggregation == "att":
        ng = node_graph.long()
        zero_e = h.new_zeros((node_cap, edge_feats.shape[-1]))
        g0 = torch.softmax(mp.attn(torch.cat([h, zero_e], -1)), -1)
        a0 = torch.einsum("p,pmf->mf", pen0[0], wf) + bf
        s = h.new_zeros((num_graphs + 1, h.shape[1])).index_add_(0, ng, h)
        agg = agg + (g0 * s[ng]) @ a0.T
        corr = h.new_zeros((node_cap, nf)).index_add_(0, dst, g0[dst] * h_src)
        agg = agg - corr @ a0.T
    return agg


def sparse_bilinear(h, edge_feats, edge_src, edge_dst, *, nf: int):
    """The bilinear message (mpnn_tpu/models/sparse.py::sparse_bilinear,
    ef == nf³), 'adj'-aggregated: ops/message.py::bilinear_message per
    edge, summed per destination. W(0) = 0, so padded edges add nothing.
    h: (node_cap, nf) → (node_cap, nf)."""
    src, dst = edge_src.long(), edge_dst.long()
    msg = bilinear_message(h[src], h[dst], edge_feats, nf)
    return h.new_zeros((h.shape[0], nf)).index_add_(0, dst, msg)


def _sparse_bilinear_apply(mpnn: MPNN, batch):
    """The bilinear family's plain loop, as mpnn_tpu's sparse_mpnn_apply
    runs it: step t's messages from the EVOLVING state h_{t−1}, the GRU
    from the INITIAL state (update_hidden='initial'), and the gated
    readout over the whole state history cat[h0, h_1..h_T]. No norms, so
    training and eval are one forward and the state is empty."""
    cfg = mpnn.cfg
    mask = batch["node_mask"]
    h0 = batch["node_feats"] * mask
    edge_feats = batch["edge_feats"] * batch["edge_mask"][:, None]
    h, history = h0, [h0]
    for _ in range(cfg.message_steps):
        msgs = sparse_bilinear(h, edge_feats, batch["edge_src"],
                               batch["edge_dst"], nf=cfg.node_features)
        h = gru_apply(mpnn.gru, msgs, h0, mask)
        history.append(h)
    return sparse_graph_level_output(mpnn.readout, torch.cat(history, -1),
                                     mask, batch["node_graph"],
                                     batch["graph_mask"].shape[0])


def output_norm(mpnn: MPNN, out, graph_mask, *, training: bool):
    """The output norm (obn, normed_encoded_basic_model_ecfp.py:70-71): a
    masked bn1d over the graph rows of the readout's out, the padded graph
    slots masked out. Returns (out, {"obn": new running state}) in
    training, (out, {}) in eval, and out unchanged without obn."""
    if not mpnn.cfg.output_norm:
        return out, {}
    gm = graph_mask[:, None]
    if not training:
        return mpnn.obn(out, gm), {}
    out, st = bn1d_train(out, gm, mpnn.obn.weight, mpnn.obn.bias)
    return out, {"obn": ema(running_state(mpnn.obn), st)}


def sparse_set2vec(ro: Set2Vec, x, node_mask, node_graph, graph_node_ptr, *,
                   time_steps: int, batch_softmax: bool, set2vec_fn=None):
    """Packed set2set readout (mpnn_tpu/models/sparse.py::sparse_set2vec):
    the plain loop of kernels/set2vec.py on the module's leaves, or with
    set2vec_fn as set2vec_fn(rparams, x, mask, node_graph,
    graph_node_ptr), its steps and softmax mode bound (the op
    kernels/set2vec.py::set2vec)."""
    if set2vec_fn is not None:
        return set2vec_fn(ro.as_jax(), x, node_mask, node_graph,
                          graph_node_ptr)
    return set2vec_reference(ro.as_jax(), x, node_mask, node_graph,
                             graph_node_ptr, time_steps=time_steps,
                             batch_softmax=batch_softmax)


def _sparse_att_apply(mpnn: MPNN, batch, *, sddmm_fn=None, edge_mlp_fn=None,
                      set2vec_fn=None):
    """The attention families' plain loop, as mpnn_tpu's sparse_mpnn_apply
    runs it: step t's messages from the INITIAL state through message
    network t (per-step weights) or network 0 (shared weights: computed
    once, as the JAX loop's msgs_const branch does), the GRU from the
    previous state (update_hidden='state', the att model) or from the
    initial one (update_hidden='initial', adv), the stateless norm after
    each GRU where configured, then the readout on [h_T ‖ h0]. The only
    norm is stateless, so training and eval are one forward and the state
    is empty. The hooks as in sparse_mpnn_apply: the SDDMM and the chain
    once per message network, set2vec once."""
    cfg = mpnn.cfg
    mask = batch["node_mask"]
    node_graph = batch["node_graph"]
    num_graphs = batch["graph_mask"].shape[0]
    plan = plan_from_batch(batch) if sddmm_fn is not None else None
    h0 = batch["node_feats"] * mask
    edge_feats = batch["edge_feats"] * batch["edge_mask"][:, None]
    msgs = None
    h = h0
    for step in range(cfg.message_steps):
        if msgs is None or not cfg.share_message_weights:
            mp = mpnn.message[0 if cfg.share_message_weights else step]
            pen0, pen_vocab = _edge_penultimates(mp, edge_feats, cfg,
                                                 batch["edge_vfirst"],
                                                 edge_mlp_fn)
            msgs = sparse_att_edge_network(
                mp, pen0, pen_vocab, h0, edge_feats, batch["edge_vid"],
                batch["edge_src"], batch["edge_dst"], node_graph,
                num_graphs, nf=cfg.node_features, mf=cfg.message_features,
                aggregation=cfg.aggregation,
                edge_vfirst=batch["edge_vfirst"], sddmm_fn=sddmm_fn,
                plan=plan)
        hidden = h if cfg.update_hidden == "state" else h0
        h = gru_apply(mpnn.gru, msgs, hidden, mask)
        if cfg.state_norm == "stateless":
            h = mask_batch_norm(h, mask)
    x = torch.cat([h, h0], dim=-1)
    if cfg.readout == "set2vec":
        return sparse_set2vec(mpnn.readout, x, mask, node_graph,
                              batch["plan_graph_node_ptr"],
                              time_steps=cfg.set2vec_steps,
                              batch_softmax=cfg.set2vec_batch_softmax,
                              set2vec_fn=set2vec_fn)
    return sparse_graph_level_output(mpnn.readout, x, mask, node_graph,
                                     num_graphs)


def mpnn_new_state(mpnn: MPNN, ma_stats, step_stats) -> dict:
    """The MPNN's running statistics after one training step, in the JAX
    state layout {"ma_bn": [..], "bn": [..]} (the norms the config has).
    The EMAs of mpnn_tpu/models/sparse.py::fold_recurrence_emas (momentum
    0.1): the SHARED ma_bn sees the same constant-message stats once per
    step, `steps` times; the shared bn sees each step's stats once."""
    state = {}
    if mpnn.cfg.msg_norm == "bn1d":
        ma = running_state(mpnn.ma_bn[0])
        for _ in range(mpnn.cfg.message_steps):
            ma = ema(ma, ma_stats)
        state["ma_bn"] = [ma]
    if mpnn.cfg.state_norm == "bn1d":
        bn = running_state(mpnn.bn[0])
        for st in step_stats:
            bn = ema(bn, st)
        state["bn"] = [bn]
    return state


def _norm_train(mod, x, mask, stats_out):
    """bn1d_train with the module's affine; its batch statistics are
    appended to stats_out."""
    out, st = bn1d_train(x, mask, mod.weight, mod.bias)
    stats_out.append(st)
    return out


def input_transforms(mpnn: MPNN, batch, *, training: bool):
    """The encoded family's input pipeline (mpnn_tpu/models/fused_train.py::
    _input_transforms, sparse.py's prologue): mask → tanh encoders → input
    bn1d (aebn over nodes, bebn over edges masked by edge_mask). Returns
    (h0, edge_feats, state updates {aebn, bebn} in training, else {}). The
    bn1d re-masks its output, so padded rows come back exactly zero."""
    cfg = mpnn.cfg
    mask = batch["node_mask"]
    emask = batch["edge_mask"][:, None]
    h0 = batch["node_feats"] * mask
    edge_feats = batch["edge_feats"] * emask
    if cfg.atom_encoder == "atom_ae":
        h0 = tanh_encoder_apply(mpnn.atom_encoder, h0)
    if cfg.bond_encoder == "bond_ae":
        edge_feats = tanh_encoder_apply(mpnn.bond_encoder, edge_feats)
    updates = {}
    if cfg.input_norm:
        if training:
            h0, st_a = bn1d_train(h0, mask, mpnn.aebn.weight, mpnn.aebn.bias)
            edge_feats, st_b = bn1d_train(edge_feats, emask,
                                          mpnn.bebn.weight, mpnn.bebn.bias)
            updates = {"aebn": ema(running_state(mpnn.aebn), st_a),
                       "bebn": ema(running_state(mpnn.bebn), st_b)}
        else:
            h0 = mpnn.aebn(h0, mask)
            edge_feats = mpnn.bebn(edge_feats, emask)
    return h0, edge_feats, updates


def psteps_new_state(mpnn: MPNN, ma_stats, step_stats) -> dict:
    """The per-step family's running statistics after one training step:
    each per-step norm gets exactly ONE EMA update from its own step's
    statistics (the sequential bn1d_apply loop; not the shared family's
    T-fold fold)."""
    state = {}
    if mpnn.cfg.msg_norm == "bn1d":
        state["ma_bn"] = [ema(running_state(m), st)
                          for m, st in zip(mpnn.ma_bn, ma_stats)]
    if mpnn.cfg.state_norm == "bn1d":
        state["bn"] = [ema(running_state(m), st)
                       for m, st in zip(mpnn.bn, step_stats)]
    return state


def _sparse_psteps_apply(mpnn: MPNN, batch, *, training: bool,
                         spmm_vocab_fn=None, edge_mlp_fn=None):
    """The per-step family's plain loop: step t's messages from the
    INITIAL state through its own message network, its own norms, the
    stateless norm where configured, the gated readout. The hooks as in
    sparse_mpnn_apply: the SpMM once per step, as the JAX loop calls it."""
    cfg = mpnn.cfg
    mask = batch["node_mask"]
    node_graph = batch["node_graph"]
    graph_mask = batch["graph_mask"]
    plan = plan_from_batch(batch) if spmm_vocab_fn is not None else None
    h0, edge_feats, updates = input_transforms(mpnn, batch,
                                               training=training)
    ma_stats, step_stats = [], []
    h = h0
    for t, mp in enumerate(mpnn.message):
        pen0, pen_vocab = _edge_penultimates(mp, edge_feats, cfg,
                                             batch["edge_vfirst"],
                                             edge_mlp_fn)
        msgs = sparse_edge_network_fused(
            mp, pen0, h0, batch["edge_src"], batch["edge_dst"], node_graph,
            graph_mask, nf=cfg.node_features, mf=cfg.message_features,
            pen_vocab=pen_vocab, edge_vid=batch["edge_vid"],
            spmm_vocab_fn=spmm_vocab_fn, plan=plan)
        if cfg.msg_norm == "bn1d":
            msgs = _norm_train(mpnn.ma_bn[t], msgs, mask, ma_stats) \
                if training else mpnn.ma_bn[t](msgs, mask)
        h = gru_apply(mpnn.gru, msgs, h, mask)
        if cfg.state_norm == "stateless":
            h = mask_batch_norm(h, mask)
        elif cfg.state_norm == "bn1d":
            h = _norm_train(mpnn.bn[t], h, mask, step_stats) \
                if training else mpnn.bn[t](h, mask)
    out = sparse_graph_level_output(mpnn.readout, torch.cat([h, h0], -1),
                                    mask, node_graph, graph_mask.shape[0])
    out, obn = output_norm(mpnn, out, graph_mask, training=training)
    if not training:
        return out
    new_state = psteps_new_state(mpnn, ma_stats, step_stats)
    new_state.update(updates)
    new_state.update(obn)
    return out, new_state


def recurrence_eligible(cfg: MPNNConfig, *, training: bool) -> bool:
    """True when the fused recurrence (kernels/recurrence.py) computes
    exactly this config's step loop: messages constant across steps
    (message_input='initial' + shared weights) and one shared bn1d pair
    (a copy of mpnn_tpu/models/sparse.py::recurrence_eligible; training
    only, as there)."""
    return (training
            and cfg.message_fn in ("edge_network", "ggnn")
            and cfg.message_features == cfg.node_features
            and cfg.share_message_weights
            and cfg.message_input == "initial"
            and cfg.update_hidden == "state"
            and cfg.msg_norm == "bn1d" and cfg.state_norm == "bn1d"
            and not cfg.per_step_norms
            and not cfg.concat_state_history
            and not cfg.remat)


def usable_hooks(cfg: MPNNConfig, *, training: bool):
    """(the config's family, the hooks of sparse_mpnn_apply it can use)."""
    if bilinear_shape(cfg):
        return "bilinear", ()
    if att_shape(cfg) or att_steps_shape(cfg):
        return "attention", ("sddmm_fn", "edge_mlp_fn") + (
            ("set2vec_fn",) if cfg.readout == "set2vec" else ())
    if shared_shape(cfg):
        return "shared edge-network", ("spmm_vocab_fn", "edge_mlp_fn") + (
            ("recurrence_fn",) if recurrence_eligible(cfg, training=training)
            else ())
    return "per-step edge-network", ("spmm_vocab_fn", "edge_mlp_fn")


def check_hooks(cfg: MPNNConfig, hooks: dict, *, training: bool) -> None:
    """Raise for a hook (not None) that the config's family cannot use,
    naming it and the family: no hook is dropped."""
    family, usable = usable_hooks(cfg, training=training)
    for name, fn in hooks.items():
        if fn is not None and name not in usable:
            raise ValueError(
                f"sparse_mpnn_apply: the {family} family cannot use the "
                f"{name} hook; it takes {', '.join(usable) or 'no hook'}"
                f" (training={training})")


def sparse_mpnn_apply(mpnn: MPNN, batch, *, training: bool = False,
                      spmm_vocab_fn=None, recurrence_fn=None,
                      edge_mlp_fn=None, sddmm_fn=None, set2vec_fn=None):
    """Packed-batch MPNN forward. batch: dict of tensors with node_feats,
    node_mask, node_graph, edge_src, edge_dst, edge_feats, edge_mask,
    graph_mask, edge_vid, edge_vfirst (and the index plan, PLAN_KEYS, for
    spmm_vocab_fn and sddmm_fn). Eval mode returns out (G, od); training
    mode normalizes with batch statistics and returns (out, new_state),
    new_state as mpnn_new_state (shared family) or psteps_new_state
    (per-step family, with the output norm's) gives it, empty for the
    attention and bilinear families (no norm with running state).

    The hooks of mpnn_tpu's sparse_mpnn_apply: the edge-network families
    take spmm_vocab_fn(amat, h, vid, src, dst, plan) for the message sum,
    edge_mlp_fn for the vocab chain, and in training recurrence_fn(msgs,
    h0, mask, gru, ma_bn, bn) → (h_T, ma_stats, step_stats) for the whole
    step chain where recurrence_eligible; the attention families
    sddmm_fn(aprime, evocab, wa, ba, h, vid, src, dst, plan) for the gated
    message sum, edge_mlp_fn, and with the set2vec readout set2vec_fn. A
    hook the family cannot use raises ValueError (usable_hooks)."""
    cfg = mpnn.cfg
    check_supported(cfg)
    check_hooks(cfg, dict(spmm_vocab_fn=spmm_vocab_fn,
                          recurrence_fn=recurrence_fn,
                          edge_mlp_fn=edge_mlp_fn, sddmm_fn=sddmm_fn,
                          set2vec_fn=set2vec_fn), training=training)
    if bilinear_shape(cfg):
        out = _sparse_bilinear_apply(mpnn, batch)
        return (out, {}) if training else out
    if att_shape(cfg) or att_steps_shape(cfg):
        out = _sparse_att_apply(mpnn, batch, sddmm_fn=sddmm_fn,
                                edge_mlp_fn=edge_mlp_fn,
                                set2vec_fn=set2vec_fn)
        return (out, {}) if training else out
    if not shared_shape(cfg):
        return _sparse_psteps_apply(mpnn, batch, training=training,
                                    spmm_vocab_fn=spmm_vocab_fn,
                                    edge_mlp_fn=edge_mlp_fn)
    mask = batch["node_mask"]
    node_graph = batch["node_graph"]
    graph_mask = batch["graph_mask"]
    num_graphs = graph_mask.shape[0]
    h0 = batch["node_feats"] * mask
    edge_feats = batch["edge_feats"] * batch["edge_mask"][:, None]
    mp = mpnn.message[0]
    pen0, pen_vocab = _edge_penultimates(mp, edge_feats, cfg,
                                         batch["edge_vfirst"], edge_mlp_fn)
    # messages from the INITIAL features with shared weights: constant
    # across steps, computed once
    msgs = sparse_edge_network_fused(
        mp, pen0, h0, batch["edge_src"], batch["edge_dst"], node_graph,
        graph_mask, nf=cfg.node_features, mf=cfg.message_features,
        pen_vocab=pen_vocab, edge_vid=batch["edge_vid"],
        spmm_vocab_fn=spmm_vocab_fn,
        plan=plan_from_batch(batch) if spmm_vocab_fn is not None else None)
    if recurrence_fn is not None:
        # the whole BN→GRU→BN chain in one op; the running statistics
        # folded as the sequential loop would have recorded them
        h, ma_stats, step_stats = recurrence_fn(
            msgs, h0, mask, mpnn.gru.as_dict(),
            {"weight": mpnn.ma_bn[0].weight, "bias": mpnn.ma_bn[0].bias},
            {"weight": mpnn.bn[0].weight, "bias": mpnn.bn[0].bias})
        out = sparse_graph_level_output(mpnn.readout,
                                        torch.cat([h, h0], dim=-1), mask,
                                        node_graph, num_graphs)
        return out, mpnn_new_state(mpnn, ma_stats, step_stats)
    ma_stats, step_stats = None, []
    if cfg.msg_norm == "bn1d":
        ma = mpnn.ma_bn[0]
        if training:
            msgs, ma_stats = bn1d_train(msgs, mask, ma.weight, ma.bias)
        else:
            msgs = ma(msgs, mask)
    h = h0
    for _ in range(cfg.message_steps):
        h = gru_apply(mpnn.gru, msgs, h, mask)
        if cfg.state_norm == "stateless":
            h = mask_batch_norm(h, mask)
        elif cfg.state_norm == "bn1d":
            bn = mpnn.bn[0]
            if training:
                h, st = bn1d_train(h, mask, bn.weight, bn.bias)
                step_stats.append(st)
            else:
                h = bn(h, mask)
    readout_in = torch.cat([h, h0], dim=-1)
    out = sparse_graph_level_output(mpnn.readout, readout_in, mask,
                                    node_graph, num_graphs)
    if not training:
        return out
    return out, mpnn_new_state(mpnn, ma_stats, step_stats)
