"""The MPNN core through the whole-step kernels (counterpart of
mpnn_tpu/models/fused_train.py for the shared-weight, the per-step and the
collapsed attention families): _build_a_form / _build_a_form_psteps /
_build_att_form and fused_eval_eligible (both paths); fused_mpnn_eval
(serving, one eval-kernel launch; the attention family one message+GRU
and one set2vec launch); fused_mpnn_out and fused_flagship_loss (training,
one forward and one backward launch of each kernel).

The plain PyTorch work left around the kernels is the per-step family's
input transforms (tanh encoders, input bn1d), the edge-MLP vocab chain
(K+1 rows through the ×50 tail, once per message network) and the
A-matrix fold, whose gradients autograd takes from the kernels' dA and
dA0, and the running-stat EMAs.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from mpnn_tpu_torch.graphs.batching import PLAN_KEYS, plan_from_batch
from mpnn_tpu_torch.kernels.fused_att import fused_att
from mpnn_tpu_torch.kernels.fused_psteps import fused_psteps, fused_psteps_eval
from mpnn_tpu_torch.kernels.fused_step import fused_eval, fused_step
from mpnn_tpu_torch.kernels.set2vec import set2vec
from mpnn_tpu_torch.models.config import MPNNConfig
from mpnn_tpu_torch.models.mpnn import (MPNN, att_shape, shared_shape,
                                        supported)
from mpnn_tpu_torch.models.sparse import (_edge_penultimates, a_form,
                                          final_weights, input_transforms,
                                          mpnn_new_state, psteps_new_state,
                                          sparse_graph_level_output)


def _build_a_form(mpnn: MPNN, batch):
    """Per-edge A-matrix form of the message op: (amat (K, mf, nf),
    a0 (mf, nf), vid (E,)) — the edge vocab penultimates folded through
    the final linear layer; A0 is the bias-leakage matrix."""
    cfg = mpnn.cfg
    mp = mpnn.message[0]
    edge_feats = batch["edge_feats"] * batch["edge_mask"][:, None]
    pen0, pen_vocab = _edge_penultimates(mp, edge_feats, cfg,
                                         batch["edge_vfirst"])
    amat, a0 = a_form(mp, pen0, pen_vocab, cfg.node_features,
                      cfg.message_features)
    return amat, a0, batch["edge_vid"]


def _build_a_form_psteps(mpnn: MPNN, batch, edge_feats):
    """Per-STEP A-matrix form: (amat (T, K, mf, nf), a0 (T, mf, nf),
    mbias (T, mf)) — one vocab fold per step's message network, on the
    edge features after the input transforms (the vocab rows are gathered
    from the transformed features, mpnn_tpu/models/sparse.py:74-81)."""
    cfg = mpnn.cfg
    amats, a0s = [], []
    for mp in mpnn.message:
        pen0, pen_vocab = _edge_penultimates(mp, edge_feats, cfg,
                                             batch["edge_vfirst"])
        amat, a0 = a_form(mp, pen0, pen_vocab, cfg.node_features,
                          cfg.message_features)
        amats.append(amat)
        a0s.append(a0)
    mbias = torch.stack([mp.message_bias for mp in mpnn.message])
    return torch.stack(amats), torch.stack(a0s), mbias


def _build_att_form(mpnn: MPNN, batch):
    """The attention kernel's operands (mpnn_tpu/models/fused_train.py::
    _build_att_form): aprime (K, mf, nf) = fold(pen_vocab) + Bf — the
    per-vocab message matrices WITH the final bias, which the attention
    message keeps per edge (unlike the edge network's A_k − A_0); a0 =
    fold(pen0) + Bf, the non-edge matrix; qv (K, nf) = evocab·W_e + b, the
    gate's per-vocab pre-activation; q0 = b, the zero edge's; wh =
    attn.w[:nf], the h_dst block."""
    cfg = mpnn.cfg
    nf, mf = cfg.node_features, cfg.message_features
    mp = mpnn.message[0]
    edge_feats = batch["edge_feats"] * batch["edge_mask"][:, None]
    pen0, pen_vocab = _edge_penultimates(mp, edge_feats, cfg,
                                         batch["edge_vfirst"])
    wf, bf = final_weights(mp, nf, mf)
    aprime = torch.einsum("kp,pmf->kmf", pen_vocab, wf) + bf
    a0 = torch.einsum("p,pmf->mf", pen0[0], wf) + bf
    evocab = edge_feats[batch["edge_vfirst"].long()]
    w = mp.attn.weight.t()                                  # (nf + ef, nf)
    qv = evocab @ w[nf:] + mp.attn.bias
    return (aprime.contiguous(), a0.contiguous(), qv.contiguous(),
            mp.attn.bias, w[:nf].contiguous())


def fused_att_out(mpnn: MPNN, batch) -> torch.Tensor:
    """The attention family through its kernels (mpnn_tpu/models/
    fused_train.py::fused_att_out): gating, messages, the 'att'
    correction and the GRU in one launch, then the set2vec readout in one
    more (a graph-level readout stays plain PyTorch). Serves eval and
    training alike — the family has no norms, so the state is empty.
    Returns out (G, output_dim)."""
    cfg = mpnn.cfg
    mask, ng = batch["node_mask"], batch["node_graph"]
    h0 = (batch["node_feats"] * mask).contiguous()
    aprime, a0, qv, q0, wh = _build_att_form(mpnn, batch)
    h = fused_att(aprime, a0, qv, q0, wh, h0, mask, ng, mpnn.gru.as_dict(),
                  batch["edge_vid"], batch["edge_src"], batch["edge_dst"],
                  plan_from_batch(batch),
                  with_corr=cfg.aggregation == "att")
    x = torch.cat([h, h0], dim=-1)
    if cfg.readout == "set2vec":
        return set2vec(mpnn.readout.as_jax(), x, mask, ng,
                       batch["plan_graph_node_ptr"],
                       time_steps=cfg.set2vec_steps,
                       batch_softmax=cfg.set2vec_batch_softmax)
    return sparse_graph_level_output(mpnn.readout, x, mask, ng,
                                     batch["graph_mask"].shape[0])


def _norm_dicts(mods):
    """The per-step norms as the kernels' lists of (params, state) dicts
    (empty for a mode without them)."""
    return ([{"weight": m.weight, "bias": m.bias} for m in mods],
            [{"running_mean": m.running_mean,
              "running_var": m.running_var} for m in mods])


def _psteps_args(mpnn: MPNN, batch, *, training: bool):
    """The per-step family's common kernel arguments for one batch:
    ((amat, a0, mbias, h0), the input norms' state updates)."""
    h0, edge_feats, updates = input_transforms(mpnn, batch,
                                               training=training)
    amat, a0, mbias = _build_a_form_psteps(mpnn, batch, edge_feats)
    return (amat.contiguous(), a0.contiguous(), mbias.contiguous(),
            h0.contiguous()), updates


def fused_psteps_eval_args(mpnn: MPNN, batch):
    """(args, kwargs) of the fused_psteps_eval call for this batch."""
    cfg = mpnn.cfg
    (amat, a0, mbias, h0), _ = _psteps_args(mpnn, batch, training=False)
    ma_p, ma_s = _norm_dicts(mpnn.ma_bn)
    bn_p, bn_s = _norm_dicts(mpnn.bn)
    args = (amat, a0, mbias, h0, batch["node_mask"], batch["node_graph"],
            mpnn.gru.as_dict(), ma_p, ma_s, bn_p, bn_s, _ro_jax(mpnn),
            batch["edge_vid"], batch["edge_src"], batch["edge_dst"],
            plan_from_batch(batch))
    return args, dict(steps=cfg.message_steps, msg_norm=cfg.msg_norm,
                      state_norm=cfg.state_norm)


def fused_psteps_args(mpnn: MPNN, batch, labels):
    """((args, kwargs) of the fused_psteps call, the input norms' state
    updates) for this training batch."""
    cfg = mpnn.cfg
    (amat, a0, mbias, h0), updates = _psteps_args(mpnn, batch,
                                                  training=True)
    ma_p, _ = _norm_dicts(mpnn.ma_bn)
    bn_p, _ = _norm_dicts(mpnn.bn)
    args = (amat, a0, mbias, h0, batch["node_mask"], batch["node_graph"],
            mpnn.gru.as_dict(), ma_p, bn_p, _ro_jax(mpnn), labels,
            batch["graph_mask"], batch["edge_vid"], batch["edge_src"],
            batch["edge_dst"], plan_from_batch(batch))
    return (args, dict(steps=cfg.message_steps, msg_norm=cfg.msg_norm,
                       state_norm=cfg.state_norm)), updates


def _psteps_train(mpnn: MPNN, batch, labels):
    """(loss, out, new_state) of the per-step training kernels: each
    per-step norm's EMA from its own statistics, plus the input norms'."""
    (args, kwargs), updates = fused_psteps_args(mpnn, batch, labels)
    loss, out, ma_stats, bn_stats = fused_psteps(*args, **kwargs)
    new_state = psteps_new_state(mpnn, ma_stats, bn_stats)
    new_state.update(updates)
    return loss, out, new_state


def fused_eval_eligible(cfg: MPNNConfig, batch) -> bool:
    """True when the eval kernel (and the training kernels) compute
    exactly this config's forward on this batch: a supported config
    (models/mpnn.py: any of the three families) and a packed batch that
    carries the edge vocab and the kernels' index plan."""
    return (supported(cfg) and "edge_vid" in batch
            and all(k in batch for k in PLAN_KEYS))


def _bn_or_dummy(mods, f: int, like: torch.Tensor):
    """(params, state) dicts of the first norm, or identity stand-ins for a
    config without one (the kernel ignores them for mode 'none')."""
    if len(mods):
        m = mods[0]
        return ({"weight": m.weight, "bias": m.bias},
                {"running_mean": m.running_mean,
                 "running_var": m.running_var})
    one = torch.ones(f, dtype=like.dtype, device=like.device)
    zero = torch.zeros(f, dtype=like.dtype, device=like.device)
    return ({"weight": one, "bias": zero},
            {"running_mean": zero, "running_var": one})


def _ro_jax(mpnn: MPNN):
    """The readout weights in the JAX layout (in, out)."""
    ro = mpnn.readout
    return {"i": {"w": ro.i.weight.t().contiguous(), "b": ro.i.bias},
            "j": {"w": ro.j.weight.t().contiguous(), "b": ro.j.bias}}


def fused_eval_args(mpnn: MPNN, batch):
    """(args, kwargs) of the fused_eval call for this batch: the A-form,
    the pre-masked h0, the weights in the JAX layout and the index plan."""
    cfg = mpnn.cfg
    h0 = batch["node_feats"] * batch["node_mask"]
    amat, a0, vid = _build_a_form(mpnn, batch)
    ma_p, ma_s = _bn_or_dummy(mpnn.ma_bn, cfg.message_features, h0)
    bn_p, bn_s = _bn_or_dummy(mpnn.bn, cfg.node_features, h0)
    args = (amat.contiguous(), a0.contiguous(),
            mpnn.message[0].message_bias, h0.contiguous(),
            batch["node_mask"], batch["node_graph"], mpnn.gru.as_dict(),
            ma_p, ma_s, bn_p, bn_s, _ro_jax(mpnn), vid, batch["edge_src"],
            batch["edge_dst"], plan_from_batch(batch))
    return args, dict(steps=cfg.message_steps, msg_norm=cfg.msg_norm,
                      state_norm=cfg.state_norm)


def _psteps_eval(mpnn: MPNN, batch) -> torch.Tensor:
    args, kwargs = fused_psteps_eval_args(mpnn, batch)
    return fused_psteps_eval(*args, **kwargs)


def _shared_eval(mpnn: MPNN, batch) -> torch.Tensor:
    args, kwargs = fused_eval_args(mpnn, batch)
    return fused_eval(*args, **kwargs)


def fused_step_args(mpnn: MPNN, batch, labels):
    """(args, kwargs) of the fused_step call for this batch: the A-form,
    the pre-masked h0, the weights in the JAX layout, the labels and the
    index plan."""
    cfg = mpnn.cfg
    h0 = batch["node_feats"] * batch["node_mask"]
    amat, a0, vid = _build_a_form(mpnn, batch)
    ma_p, _ = _bn_or_dummy(mpnn.ma_bn, cfg.message_features, h0)
    bn_p, _ = _bn_or_dummy(mpnn.bn, cfg.node_features, h0)
    args = (amat.contiguous(), a0.contiguous(),
            mpnn.message[0].message_bias, h0.contiguous(),
            batch["node_mask"], batch["node_graph"], mpnn.gru.as_dict(),
            ma_p, bn_p, _ro_jax(mpnn), labels, batch["graph_mask"], vid,
            batch["edge_src"], batch["edge_dst"], plan_from_batch(batch))
    return args, dict(steps=cfg.message_steps, msg_norm=cfg.msg_norm,
                      state_norm=cfg.state_norm)


def _shared_train(mpnn: MPNN, batch, labels):
    """(loss, out, new_state) of the shared family's training kernels."""
    args, kwargs = fused_step_args(mpnn, batch, labels)
    loss, out, ma_stats, step_stats = fused_step(*args, **kwargs)
    return loss, out, mpnn_new_state(mpnn, ma_stats, step_stats)


class _Family(NamedTuple):
    infer: Callable   # (mpnn, batch) -> out
    out: Callable     # (mpnn, batch) -> (out, new_state), loss outside


def _loss_free(train):
    """A family's training `out` from its in-kernel-loss step: the loss
    against zero labels is discarded, its cotangent is zero, so the
    backward kernel is driven by the `out` cotangent alone."""
    def out(mpnn: MPNN, batch):
        _, o, new_state = train(mpnn, batch,
                                torch.zeros_like(batch["graph_mask"]))
        return o, new_state
    return out


_SHARED = _Family(_shared_eval, _loss_free(_shared_train))
_PSTEPS = _Family(_psteps_eval, _loss_free(_psteps_train))
_ATT = _Family(fused_att_out,
               lambda mpnn, batch: (fused_att_out(mpnn, batch), {}))
# the families whose training kernels carry the masked MSE:
# (mpnn, batch, labels) -> (loss, out, new_state)
_KERNEL_LOSS = {_SHARED: _shared_train, _PSTEPS: _psteps_train}


def _family(cfg: MPNNConfig) -> _Family:
    """The one place that tells the families apart on the kernel path."""
    if att_shape(cfg):
        return _ATT
    return _SHARED if shared_shape(cfg) else _PSTEPS


def fused_mpnn_eval(mpnn: MPNN, batch) -> torch.Tensor:
    """Inference through the whole-step eval kernel of the config's
    family — the serving path. Returns out (G, output_dim). Equal to
    sparse_mpnn_apply within f32 summation-order error."""
    return _family(mpnn.cfg).infer(mpnn, batch)


def fused_flagship_loss(mpnn: MPNN, batch, labels):
    """The bare MPNN's training step through the kernels with the masked
    MSE in the kernel: (loss, out, new_state), new_state as
    models/sparse.py::mpnn_new_state (psteps_new_state) gives it. The
    shared-weight and per-step families only: the attention kernels carry
    no loss (their readout is a second kernel)."""
    train = _KERNEL_LOSS.get(_family(mpnn.cfg))
    if train is None:
        raise NotImplementedError(
            "the attention family's kernels carry no in-kernel loss; use "
            "fused_mpnn_out and the loss outside")
    return train(mpnn, batch, labels)


def fused_mpnn_out(mpnn: MPNN, batch):
    """The MPNN core through the training kernels, loss OUTSIDE: returns
    (out (G, output_dim), new_state) — a drop-in for
    sparse_mpnn_apply(training=True), so a network with a wrapper, head
    BN or dense head (the lipo model) runs messages → readout as one
    forward launch per kernel."""
    return _family(mpnn.cfg).out(mpnn, batch)
