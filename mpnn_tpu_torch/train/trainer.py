"""Training and evaluation on packed batches (counterpart of
mpnn_tpu/train/trainer.py: train, the train step, eval_step_for_batch and
evaluate, the mse and ce losses, the F1 checkpoint gate).

On an eligible config every training batch takes the whole-step training
kernels (one forward and one backward launch per step) and every
evaluation batch the whole-step eval kernel — on `cuda` the CUDA kernels,
on `cpu` their plain versions. There is no small-batch crossover and no
silent fallback: an ineligible config raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from mpnn_tpu_torch.device import require_on, resolve_device
from mpnn_tpu_torch.graphs.dataloader import GraphLoader
from mpnn_tpu_torch.models.fused_train import fused_eval_eligible
from mpnn_tpu_torch.models.network import (Network, NetworkConfig,
                                           assign_state, network_apply_packed,
                                           network_init)
from mpnn_tpu_torch.train import metrics as M
from mpnn_tpu_torch.train.checkpoint import save_checkpoint
from mpnn_tpu_torch.train.optim import (ReduceLROnPlateau, adam,
                                        get_learning_rate, set_learning_rate)


@dataclasses.dataclass
class TrainConfig:
    """mpnn_tpu's TrainConfig fields that the ported path reads. The
    packed collation, the whole-step kernels and a shuffled loader are the
    only path, so `packed`/`fuse_step`/`shuffle` have no switch here. The
    loss defaults to mse (the port's first experiment, lipo)."""
    epochs: int = 100
    batch_size: int = 16
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    loss: str = "mse"                # mse | ce
    seed: int = 317
    plateau: bool = False            # ReduceLROnPlateau on the val loss
    metric_average: str = "weighted"  # classification report averaging
    ckpt_dir: Optional[str] = None   # one checkpoint per epoch
    ckpt_f1_gate: Optional[float] = None   # save only when val f1 > gate
    # stop after the epoch (and its checkpoint) whose SUMMED batch loss is
    # below this (test_adv.py:96-98)
    early_stop_loss: Optional[float] = None
    log_path: Optional[str] = None   # JSON lines: every step, every epoch


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


LOSSES = {"mse": mse_loss, "ce": ce_loss}


def _loss_fn(kind: str):
    if kind not in LOSSES:
        raise NotImplementedError(f"loss {kind!r} is still to port")
    return LOSSES[kind]


def train_step(net: Network, opt: torch.optim.Optimizer, tb: dict,
               fused: bool = True, loss_kind: str = "mse") -> torch.Tensor:
    """One optimizer step on a device batch: the network in training mode
    (the training kernels with `fused`, else the plain model), the masked
    loss, its gradient, Adam, and the running statistics written back.
    A parameter the loss does not reach (the autoencoders' decoders) gets
    a zero gradient, so the coupled weight decay moves it as the JAX
    package's optimizer does. Returns the loss (a device scalar, not
    synchronized)."""
    opt.zero_grad(set_to_none=True)
    out, new_state = network_apply_packed(net, tb, fused=fused,
                                          training=True)
    loss = _loss_fn(loss_kind)(out, tb["labels"], tb["graph_mask"])
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
    loss_fn = _loss_fn(loss_kind)
    if not fused_eval_eligible(net_cfg.mpnn, batch):
        raise NotImplementedError(
            "this config or batch is not served by the fused eval kernels; "
            "the other families are still to port (ROADMAP)")

    def step(net: Network, tb: dict):
        with torch.no_grad():
            out = network_apply_packed(net, tb, fused=True)
            return loss_fn(out, tb["labels"], tb["graph_mask"]), out

    return step


def evaluate(net: Network, loader: GraphLoader, loss_kind: str = "mse",
             metric_average: str = "weighted", device=None
             ) -> Dict[str, float]:
    """Eval-mode loss and metrics over a loader — mse and rmse, or for
    'ce' the classification report of the arg-max predictions with
    `metric_average` — on `cuda` unless device='cpu'. Raises when `net` is
    not on that device."""
    device = resolve_device(device)
    require_on(net, device)
    tot_loss, preds, trues = 0.0, [], []
    n_batches = 0
    for batch in loader:
        step = eval_step_for_batch(net.cfg, loss_kind, batch)
        loss, out = step(net, batch_to_device(batch, device))
        tot_loss += float(loss)
        n_batches += 1
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
    else:
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


def _check_trainable(net_cfg: NetworkConfig, loader: GraphLoader) -> None:
    probe = loader._collate_chunk(
        np.arange(min(loader.batch_size, len(loader.graphs))))
    if not fused_eval_eligible(net_cfg.mpnn, probe):
        raise NotImplementedError(
            "this config or batch is not trained by the fused step "
            "kernels; the other families are still to port (ROADMAP)")


def train(net_cfg: NetworkConfig, cfg: TrainConfig, train_graphs,
          val_graphs=None, *, net: Optional[Network] = None, device=None
          ) -> Tuple[Network, List[dict]]:
    """The epoch loop of mpnn_tpu's train(): Adam (coupled weight decay)
    on shuffled packed batches through the training kernels, the running
    statistics written back after each step, per-epoch validation through
    the eval kernel, the plateau schedule on the validation loss, and one
    checkpoint per epoch (`ckpt_<epoch>.npz` in cfg.ckpt_dir, readable by
    `predict` in either package; with cfg.ckpt_f1_gate only the epochs
    whose validation f1 passes it), and with cfg.early_stop_loss a stop
    after the first epoch whose summed step loss is below it. `net`
    defaults to network_init from cfg.seed; runs on `cuda` unless
    device='cpu'. With cfg.log_path every
    step's loss and every epoch's record are appended there as JSON lines.
    Returns (net, history). Resume and optimizer state in checkpoints are
    still to port."""
    device = resolve_device(device)
    if net is None:
        net = network_init(net_cfg, torch.Generator().manual_seed(cfg.seed),
                           device)
    require_on(net, device)
    opt = adam(net.parameters(), cfg.learning_rate,
               weight_decay=cfg.weight_decay)
    sched = ReduceLROnPlateau(cfg.learning_rate) if cfg.plateau else None
    train_loader = GraphLoader(train_graphs, cfg.batch_size, shuffle=True,
                               seed=cfg.seed)
    val_loader = (GraphLoader(val_graphs, cfg.batch_size)
                  if val_graphs else None)
    _check_trainable(net_cfg, train_loader)
    history, step = [], 0
    with contextlib.ExitStack() as stack:
        log = (stack.enter_context(open(cfg.log_path, "a"))
               if cfg.log_path else None)
        for epoch in range(cfg.epochs):
            epoch_loss = 0.0
            for batch in train_loader:
                loss = float(train_step(net, opt,
                                        batch_to_device(batch, device),
                                        loss_kind=cfg.loss))
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
                          "sched": sched.state_dict() if sched else None})
            if cfg.early_stop_loss is not None \
                    and epoch_loss < cfg.early_stop_loss:
                break
    return net, history
