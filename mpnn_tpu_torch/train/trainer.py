"""Training and evaluation on packed batches (counterpart of
mpnn_tpu/train/trainer.py: train, the train step, eval_step_for_batch and
evaluate, the mse, ce and ecfp_mse losses, the F1 checkpoint gate).

On an eligible config every training batch takes the whole-step training
kernels (one forward and one backward launch per step) and every
evaluation batch the whole-step eval kernel — on `cuda` the CUDA kernels,
on `cpu` their plain versions. With fuse_step=False the training step
takes the decomposed path instead (mpnn_tpu's `train --packed --spmm
kernel`): the plain model with the SpMM kernels for the edge-network
families' message sum (with fuse_recurrence also the fused recurrence
kernels for the lipo family's step chain) or the SDDMM kernels for the
attention models' (with the set2vec kernels for their readout), and the
edge-MLP chain kernels (decomposed_hooks); validation stays on the eval
kernels. There is no small-batch crossover and no
silent fallback: an ineligible config raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from mpnn_tpu_torch.device import require_on, resolve_device
from mpnn_tpu_torch.graphs.dataloader import GraphLoader
from mpnn_tpu_torch.kernels.edge_mlp import make_edge_mlp_op
from mpnn_tpu_torch.kernels.recurrence import make_recurrence_op
from mpnn_tpu_torch.kernels.sddmm import make_sddmm_op
from mpnn_tpu_torch.kernels.set2vec import set2vec
from mpnn_tpu_torch.kernels.spmm import make_spmm_op
from mpnn_tpu_torch.models.fused_train import fused_eval_eligible
from mpnn_tpu_torch.models.mpnn import (att_shape, att_steps_shape,
                                        decomposed_shape)
from mpnn_tpu_torch.models.network import (Network, NetworkConfig,
                                           assign_state, network_apply_packed,
                                           network_init)
from mpnn_tpu_torch.train import metrics as M
from mpnn_tpu_torch.train.checkpoint import (latest_checkpoint,
                                             load_checkpoint, load_opt_state,
                                             read_arrays, save_checkpoint)
from mpnn_tpu_torch.train.optim import (ReduceLROnPlateau, adam,
                                        get_learning_rate, set_learning_rate)


@dataclasses.dataclass
class TrainConfig:
    """mpnn_tpu's TrainConfig fields that the ported path reads. The
    packed collation and a shuffled loader are the only path, so
    `packed`/`shuffle` have no switch here. The training step takes the
    whole-step kernels (fuse_step, the default: the port's first path) or
    the decomposed path (fuse_step=False: the SpMM kernels, and with
    fuse_recurrence the recurrence kernels, for the edge-network
    families, the SDDMM kernels for the attention families, as the JAX
    package's spmm='kernel' path, whose fuse_step defaults to False; the
    port has no other SpMM backend, so `spmm` has no switch either). The loss
    defaults to mse (the port's first experiment, lipo)."""
    epochs: int = 100
    batch_size: int = 16
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    loss: str = "mse"                # mse | ce | ecfp_mse
    seed: int = 317
    plateau: bool = False            # ReduceLROnPlateau on the val loss
    metric_average: str = "weighted"  # classification report averaging
    ckpt_dir: Optional[str] = None   # one checkpoint per epoch
    ckpt_f1_gate: Optional[float] = None   # save only when val f1 > gate
    # stop after the epoch (and its checkpoint) whose SUMMED batch loss is
    # below this (test_adv.py:96-98)
    early_stop_loss: Optional[float] = None
    log_path: Optional[str] = None   # JSON lines: every step, every epoch
    # the whole-step kernels (one forward and one backward launch per
    # step); False: the decomposed path below (edge-network and attention
    # families)
    fuse_step: bool = True
    # the decomposed path runs the lipo family's BN→GRU→BN chain as one
    # op (kernels/recurrence.py; configs where recurrence_eligible)
    fuse_recurrence: bool = False


def batch_to_device(batch: dict, device) -> dict:
    """Numpy batch dict → tensors on `device`: floats as float32, integers
    as int32; Python scalars stay as they are."""
    out = {}
    for k, v in batch.items():
        if not isinstance(v, np.ndarray):
            out[k] = v
            continue
        dt = torch.float32 if np.issubdtype(v.dtype, np.floating) \
            else torch.int32
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(
            device=device, dtype=dt, non_blocking=False)
    return out


def mse_loss(out: torch.Tensor, labels: torch.Tensor,
             graph_mask: torch.Tensor) -> torch.Tensor:
    target = labels.to(out.dtype)
    if target.ndim == out.ndim - 1:
        target = target[..., None]
    per = (out - target) ** 2
    return (per * graph_mask[:, None]).sum() \
        / (graph_mask.sum() * out.shape[-1])


def ce_loss(out: torch.Tensor, labels: torch.Tensor,
            graph_mask: torch.Tensor) -> torch.Tensor:
    """Masked softmax cross entropy with integer labels:
    Σ_g per_g·gm_g / Σ_g gm_g."""
    per = torch.logsumexp(out, dim=-1) \
        - out.gather(-1, labels.long()[:, None])[:, 0]
    return (per * graph_mask).sum() / graph_mask.sum()


def ecfp_mse_loss(out: torch.Tensor, node_labels: torch.Tensor,
                  node_mask: torch.Tensor, node_graph: torch.Tensor
                  ) -> torch.Tensor:
    """MSE of sigmoid(out) against the per-atom bits, over the real atom
    entries (test_graph_encode_norm_ecfp.py:137; the JAX package's packed
    branch). Every atom of graph g shares the prediction row σ_g, so with
    s1_g = Σ_{v∈g} y_v (bits are 0/1, so Σ y² = s1) the per-graph sum
    collapses exactly: Σ_{v∈g} (σ_g − y_v)² = n_g·σ_g² − 2·σ_g·s1_g + s1_g.
    s1 is a plain segment sum over the node axis (sums of 0/1 in float32
    are exact in any order); padded atoms carry node_graph == G and fall
    into a dropped row."""
    g = out.shape[0]
    ng = node_graph.long()
    s1 = out.new_zeros((g + 1, node_labels.shape[1])).index_add_(
        0, ng, node_labels.to(out.dtype))[:g]
    n_g = out.new_zeros(g + 1).index_add_(0, ng, node_mask[:, 0].to(
        out.dtype))[:g]
    p = torch.sigmoid(out)
    per = n_g[:, None] * (p * p) - 2.0 * p * s1 + s1
    return per.sum() / (node_mask.sum() * out.shape[-1])


LOSSES = {"mse": mse_loss, "ce": ce_loss, "ecfp_mse": ecfp_mse_loss}


def batch_loss(kind: str, out: torch.Tensor, tb: dict) -> torch.Tensor:
    """The `kind` loss of the network output on the device batch `tb`."""
    if kind not in LOSSES:
        raise NotImplementedError(f"loss {kind!r} is still to port")
    if kind == "ecfp_mse":
        return ecfp_mse_loss(out, tb["node_labels"], tb["node_mask"],
                             tb["node_graph"])
    return LOSSES[kind](out, tb["labels"], tb["graph_mask"])


def decomposed_hooks(net_cfg: NetworkConfig, cfg: TrainConfig
                     ) -> Optional[dict]:
    """The decomposed path's ops for a run (None with cfg.fuse_step), as
    mpnn_tpu/train/trainer.py builds them once per run: for the attention
    families the SDDMM hook, the edge-MLP chain op and, with the set2vec
    readout, the set2vec op bound to the config's steps and softmax mode
    (the JAX package runs set2vec in XLA there; here the ported kernels,
    since the plain loop would set the step's pace); for the edge-network
    families the SpMM hook, the edge-MLP chain op, and with
    cfg.fuse_recurrence the recurrence op where the config is
    recurrence_eligible."""
    from mpnn_tpu_torch.models.sparse import recurrence_eligible
    if cfg.fuse_step:
        return None
    m = net_cfg.mpnn
    if att_shape(m) or att_steps_shape(m):
        hooks = {"sddmm_fn": make_sddmm_op(),
                 "edge_mlp_fn": make_edge_mlp_op(m.edge_mlp_tail_repeats)}
        if m.readout == "set2vec":
            hooks["set2vec_fn"] = functools.partial(
                set2vec, time_steps=m.set2vec_steps,
                batch_softmax=m.set2vec_batch_softmax)
        return hooks
    rec = None
    if cfg.fuse_recurrence and recurrence_eligible(m, training=True):
        rec = make_recurrence_op(m.message_steps, m.node_features)
    return {"spmm_vocab_fn": make_spmm_op(), "recurrence_fn": rec,
            "edge_mlp_fn": make_edge_mlp_op(m.edge_mlp_tail_repeats)}


def train_step(net: Network, opt: torch.optim.Optimizer, tb: dict,
               fused: bool = True, loss_kind: str = "mse",
               hooks: Optional[dict] = None) -> torch.Tensor:
    """One optimizer step on a device batch: the network in training mode
    (the training kernels with `fused`, else the plain model; the plain
    model with the decomposed path's `hooks` from decomposed_hooks where
    given), the masked loss, its gradient, Adam, and the running
    statistics written back. A parameter the loss does not reach (the
    autoencoders' decoders) gets a zero gradient, so the coupled weight
    decay moves it as the JAX package's optimizer does. Returns the loss
    (a device scalar, not synchronized)."""
    opt.zero_grad(set_to_none=True)
    out, new_state = network_apply_packed(net, tb, fused=fused,
                                          training=True, hooks=hooks)
    loss = batch_loss(loss_kind, out, tb)
    loss.backward()
    for p in net.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    opt.step()
    assign_state(net, new_state)
    return loss.detach()


def eval_step_for_batch(net_cfg: NetworkConfig, loss_kind: str, batch
                        ) -> Callable[[Network, dict], tuple]:
    """The eval step for one packed batch: the whole-step eval kernel of
    the config's family. Returns step(net, device_batch) → (loss, out)."""
    if loss_kind not in LOSSES:
        raise NotImplementedError(f"loss {loss_kind!r} is still to port")
    if not fused_eval_eligible(net_cfg.mpnn, batch):
        raise NotImplementedError(
            "this config or batch is not served by the fused eval kernels; "
            "the other families are still to port (ROADMAP)")

    def step(net: Network, tb: dict):
        with torch.no_grad():
            out = network_apply_packed(net, tb, fused=True)
            return batch_loss(loss_kind, out, tb), out

    return step


def evaluate(net: Network, loader: GraphLoader, loss_kind: str = "mse",
             metric_average: str = "weighted", device=None
             ) -> Dict[str, float]:
    """Eval-mode loss and metrics over a loader — mse and rmse, or for
    'ce' the classification report of the arg-max predictions with
    `metric_average`, or for 'ecfp_mse' the loss alone — on `cuda` unless
    device='cpu'. Raises when `net` is not on that device."""
    device = resolve_device(device)
    require_on(net, device)
    tot_loss, preds, trues = 0.0, [], []
    n_batches = 0
    for batch in loader:
        step = eval_step_for_batch(net.cfg, loss_kind, batch)
        loss, out = step(net, batch_to_device(batch, device))
        tot_loss += float(loss)
        n_batches += 1
        if loss_kind == "ecfp_mse":
            continue
        out = out.cpu().numpy()
        if loss_kind == "ce":
            preds.extend(out.argmax(-1).tolist())
            trues.extend(np.asarray(batch["labels"]).tolist())
        else:
            preds.extend(out.reshape(-1).tolist())
            trues.extend(np.asarray(batch["labels"]).reshape(-1).tolist())
    result = {"loss": tot_loss / max(n_batches, 1)}
    if loss_kind == "ce":
        result.update(M.classification_report(trues, preds, metric_average))
    elif loss_kind == "mse":
        result["mse"] = M.mean_squared_error(trues, preds)
        result["rmse"] = M.rmse(trues, preds)
    return result


def _gate_ok(cfg: TrainConfig, record: dict) -> bool:
    """The reference scripts' F1 gate: with ckpt_f1_gate set, an epoch's
    checkpoint is written only when its validation f1 is finite and above
    the gate."""
    if cfg.ckpt_f1_gate is None:
        return True
    f1 = record.get("val_f1")
    return f1 is not None and bool(np.isfinite(f1)) \
        and f1 > cfg.ckpt_f1_gate


def _check_trainable(net_cfg: NetworkConfig, cfg: TrainConfig,
                     loader: GraphLoader) -> None:
    probe = loader._collate_chunk(
        np.arange(min(loader.batch_size, len(loader.graphs))))
    if not fused_eval_eligible(net_cfg.mpnn, probe):
        raise NotImplementedError(
            "this config or batch is not trained by the fused step "
            "kernels; the other families are still to port (ROADMAP)")
    if cfg.fuse_step:
        return
    if not decomposed_shape(net_cfg.mpnn):      # the bilinear family
        raise NotImplementedError(
            "the bilinear family's decomposed path runs no kernel in the "
            "JAX package (its message is plain XLA); train it with the "
            "whole-step kernels (fuse_step)")


def train(net_cfg: NetworkConfig, cfg: TrainConfig, train_graphs,
          val_graphs=None, *, net: Optional[Network] = None,
          resume: bool = False, device=None
          ) -> Tuple[Network, List[dict]]:
    """The epoch loop of mpnn_tpu's train(): Adam (coupled weight decay)
    on shuffled packed batches through the training kernels (or, with
    cfg.fuse_step=False, the decomposed path's kernels), the running
    statistics written back after each step, per-epoch validation through
    the eval kernel, the plateau schedule on the validation loss, and one
    checkpoint per epoch (`ckpt_<epoch>.npz` in cfg.ckpt_dir, readable by
    `predict` in either package; with cfg.ckpt_f1_gate only the epochs
    whose validation f1 passes it), and with cfg.early_stop_loss a stop
    after the first epoch whose summed step loss is below it. `net`
    defaults to network_init from cfg.seed; runs on `cuda` unless
    device='cpu'. With cfg.log_path every
    step's loss and every epoch's record are appended there as JSON lines.
    Each checkpoint carries the optimizer state and the plateau schedule's
    in the JAX package's layout. With `resume` (mpnn_tpu's train --resume)
    the run restarts from the latest `ckpt_<epoch>.npz` in cfg.ckpt_dir,
    written by either package — weights, running statistics, Adam's step
    and moments, the learning rate, the schedule — at that epoch + 1.
    Returns (net, history)."""
    device = resolve_device(device)
    ckpt = latest_checkpoint(cfg.ckpt_dir) if resume and cfg.ckpt_dir \
        else None
    meta = {}
    if ckpt:
        net, meta = load_checkpoint(ckpt, net_cfg, device)
    elif net is None:
        net = network_init(net_cfg, torch.Generator().manual_seed(cfg.seed),
                           device)
    require_on(net, device)
    opt = adam(net.parameters(), cfg.learning_rate,
               weight_decay=cfg.weight_decay)
    sched = ReduceLROnPlateau(cfg.learning_rate) if cfg.plateau else None
    if ckpt:
        load_opt_state(read_arrays(ckpt), net, opt)
        if sched and meta.get("sched"):
            sched.load_state_dict(meta["sched"])
    start_epoch = int(meta.get("epoch", -1)) + 1
    train_loader = GraphLoader(train_graphs, cfg.batch_size, shuffle=True,
                               seed=cfg.seed)
    val_loader = (GraphLoader(val_graphs, cfg.batch_size)
                  if val_graphs else None)
    _check_trainable(net_cfg, cfg, train_loader)
    hooks = decomposed_hooks(net_cfg, cfg)
    history, step = [], 0
    with contextlib.ExitStack() as stack:
        log = (stack.enter_context(open(cfg.log_path, "a"))
               if cfg.log_path else None)
        for epoch in range(start_epoch, cfg.epochs):
            epoch_loss = 0.0
            for batch in train_loader:
                loss = float(train_step(net, opt,
                                        batch_to_device(batch, device),
                                        loss_kind=cfg.loss, hooks=hooks))
                epoch_loss += loss
                if log:
                    log.write(json.dumps({"epoch": epoch, "step": step,
                                          "loss": loss}) + "\n")
                step += 1
            record = {"epoch": epoch, "train_loss": epoch_loss,
                      "lr": get_learning_rate(opt)}
            if val_loader is not None:
                val = evaluate(net, val_loader, cfg.loss,
                               cfg.metric_average, device=device)
                record.update({f"val_{k}": v for k, v in val.items()})
                if sched:
                    set_learning_rate(opt, sched.step(val["loss"]))
            history.append(record)
            if log:
                log.write(json.dumps(record) + "\n")
                log.flush()
            if cfg.ckpt_dir and _gate_ok(cfg, record):
                os.makedirs(cfg.ckpt_dir, exist_ok=True)
                save_checkpoint(
                    os.path.join(cfg.ckpt_dir, f"ckpt_{epoch}.npz"), net,
                    meta={"epoch": epoch,
                          "sched": sched.state_dict() if sched else None},
                    opt=opt)
            if cfg.early_stop_loss is not None \
                    and epoch_loss < cfg.early_stop_loss:
                break
    return net, history
