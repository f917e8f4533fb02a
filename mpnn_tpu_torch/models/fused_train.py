"""The MPNN core through the whole-step inference kernel (counterpart of
mpnn_tpu/models/fused_train.py: _build_a_form, fused_eval_eligible,
fused_mpnn_eval for the shared-weight family).

The plain PyTorch work left around the one kernel launch is the edge-MLP
vocab chain (K+1 rows through the ×50 tail) and the A-matrix fold.
"""

from __future__ import annotations

import torch

from mpnn_tpu_torch.graphs.batching import PLAN_KEYS, plan_from_batch
from mpnn_tpu_torch.kernels.fused_step import fused_eval
from mpnn_tpu_torch.models.config import MPNNConfig
from mpnn_tpu_torch.models.mpnn import MPNN, supported
from mpnn_tpu_torch.models.sparse import _edge_penultimates, a_form


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


def fused_eval_eligible(cfg: MPNNConfig, batch) -> bool:
    """True when the eval kernel computes exactly this config's eval
    forward on this batch: a supported config (models/mpnn.py) and a packed
    batch that carries the edge vocab and the kernel's index plan."""
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


def fused_eval_args(mpnn: MPNN, batch):
    """(args, kwargs) of the fused_eval call for this batch: the A-form,
    the pre-masked h0, the weights in the JAX layout and the index plan."""
    cfg = mpnn.cfg
    h0 = batch["node_feats"] * batch["node_mask"]
    amat, a0, vid = _build_a_form(mpnn, batch)
    ro = mpnn.readout
    ma_p, ma_s = _bn_or_dummy(mpnn.ma_bn, cfg.message_features, h0)
    bn_p, bn_s = _bn_or_dummy(mpnn.bn, cfg.node_features, h0)
    args = (amat.contiguous(), a0.contiguous(),
            mpnn.message[0].message_bias, h0.contiguous(),
            batch["node_mask"], batch["node_graph"], mpnn.gru.as_dict(),
            ma_p, ma_s, bn_p, bn_s,
            {"i": {"w": ro.i.weight.t().contiguous(), "b": ro.i.bias},
             "j": {"w": ro.j.weight.t().contiguous(), "b": ro.j.bias}},
            vid, batch["edge_src"], batch["edge_dst"],
            plan_from_batch(batch))
    return args, dict(steps=cfg.message_steps, msg_norm=cfg.msg_norm,
                      state_norm=cfg.state_norm)


def fused_mpnn_eval(mpnn: MPNN, batch) -> torch.Tensor:
    """Inference through the whole-step eval kernel — the serving path.
    Returns out (G, output_dim). Equal to sparse_mpnn_apply
    within f32 summation-order error."""
    args, kwargs = fused_eval_args(mpnn, batch)
    return fused_eval(*args, **kwargs)
