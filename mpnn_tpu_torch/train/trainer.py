"""Training and evaluation on packed batches (counterpart of
mpnn_tpu/train/trainer.py: train, the train step, eval_step_for_batch and
evaluate, mse loss).

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
    packed collation, the whole-step kernels, the mse loss and a shuffled
    loader are the only path, so `packed`/`fuse_step`/`loss`/`shuffle`
    have no switch here."""
    epochs: int = 100
    batch_size: int = 16
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    seed: int = 317
    plateau: bool = False            # ReduceLROnPlateau on the val loss
    ckpt_dir: Optional[str] = None   # one checkpoint per epoch
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


def train_step(net: Network, opt: torch.optim.Optimizer, tb: dict,
               fused: bool = True) -> torch.Tensor:
    """One optimizer step on a device batch: the network in training mode
    (the training kernels with `fused`, else the plain model), the masked
    MSE, its gradient, Adam, and the running statistics written back.
    Returns the loss (a device scalar, not synchronized)."""
    opt.zero_grad(set_to_none=True)
    out, new_state = network_apply_packed(net, tb, fused=fused,
                                          training=True)
    loss = mse_loss(out, tb["labels"], tb["graph_mask"])
    loss.backward()
    opt.step()
    assign_state(net, new_state)
    return loss.detach()


def eval_step_for_batch(net_cfg: NetworkConfig, loss_kind: str, batch
                        ) -> Callable[[Network, dict], tuple]:
    """The eval step for one packed batch: the whole-step eval kernel.
    Returns step(net, device_batch) → (loss, out)."""
    if loss_kind != "mse":
        raise NotImplementedError(f"loss {loss_kind!r} is still to port")
    if not fused_eval_eligible(net_cfg.mpnn, batch):
        raise NotImplementedError(
            "this config or batch is not served by the fused eval kernel; "
            "the other families are still to port (ROADMAP queue 2)")

    def step(net: Network, tb: dict):
        with torch.no_grad():
            out = network_apply_packed(net, tb, fused=True)
            return mse_loss(out, tb["labels"], tb["graph_mask"]), out

    return step


def evaluate(net: Network, loader: GraphLoader, loss_kind: str = "mse",
             device=None) -> Dict[str, float]:
    """Eval-mode loss, mse and rmse over a loader, on `cuda` unless
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
        preds.extend(out.cpu().numpy().reshape(-1).tolist())
        trues.extend(np.asarray(batch["labels"]).reshape(-1).tolist())
    return {"loss": tot_loss / max(n_batches, 1),
            "mse": M.mean_squared_error(trues, preds),
            "rmse": M.rmse(trues, preds)}


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
    `predict` in either package). `net` defaults to network_init from
    cfg.seed; runs on `cuda` unless device='cpu'. With cfg.log_path every
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
                                        batch_to_device(batch, device)))
                epoch_loss += loss
                if log:
                    log.write(json.dumps({"epoch": epoch, "step": step,
                                          "loss": loss}) + "\n")
                step += 1
            record = {"epoch": epoch, "train_loss": epoch_loss,
                      "lr": get_learning_rate(opt)}
            if val_loader is not None:
                val = evaluate(net, val_loader, device=device)
                record.update({f"val_{k}": v for k, v in val.items()})
                if sched:
                    set_learning_rate(opt, sched.step(val["loss"]))
            history.append(record)
            if log:
                log.write(json.dumps(record) + "\n")
                log.flush()
            if cfg.ckpt_dir:
                os.makedirs(cfg.ckpt_dir, exist_ok=True)
                save_checkpoint(
                    os.path.join(cfg.ckpt_dir, f"ckpt_{epoch}.npz"), net,
                    meta={"epoch": epoch,
                          "sched": sched.state_dict() if sched else None})
    return net, history
