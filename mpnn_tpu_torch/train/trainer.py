"""Evaluation on packed batches (counterpart of mpnn_tpu/train/trainer.py:
eval_step_for_batch and evaluate, mse loss).

On an eligible config every batch takes the whole-step eval kernel — on
`cuda` the CUDA kernel, on `cpu` its plain version. There is no small-batch
crossover and no silent fallback: an ineligible config raises.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from mpnn_tpu_torch.device import require_on, resolve_device
from mpnn_tpu_torch.graphs.dataloader import GraphLoader
from mpnn_tpu_torch.models.fused_train import fused_eval_eligible
from mpnn_tpu_torch.models.network import (Network, NetworkConfig,
                                           network_apply_packed)
from mpnn_tpu_torch.train import metrics as M


@dataclasses.dataclass
class TrainConfig:
    """The experiment hyperparameters the serving path reads; the training
    ones (lr, weight decay, schedules) come with the training loop."""
    batch_size: int = 16


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
