"""Optimizer and schedule (counterpart of mpnn_tpu/train/optim.py).

adam(): torch.optim.Adam with `weight_decay` — L2 weight decay COUPLED
(added to the gradient before the moment updates; not AdamW), eps outside
the sqrt: the reference scripts' optimizer (test_lipo.py:139
Adam(lr=1e-2, weight_decay=1e-4)), as mpnn_tpu's optax chain reproduces
it.

ReduceLROnPlateau: a copy of mpnn_tpu's host-side controller (torch's
defaults factor 0.1, patience 10, rel threshold 1e-4, mode 'min'). It is
not torch.optim.lr_scheduler.ReduceLROnPlateau, whose extra `eps` rule
(skip a reduction smaller than eps) the JAX package does not have.
"""

from __future__ import annotations

import torch


def adam(params, learning_rate: float = 1e-3, b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0
         ) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=learning_rate, betas=(b1, b2),
                            eps=eps, weight_decay=weight_decay)


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def get_learning_rate(opt: torch.optim.Optimizer) -> float:
    return float(opt.param_groups[0]["lr"])


class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau default semantics."""

    def __init__(self, lr: float, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4,
                 threshold_mode: str = "rel", cooldown: int = 0,
                 min_lr: float = 0.0):
        assert mode in ("min", "max") and threshold_mode in ("rel", "abs")
        self.lr = lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = float("inf") if mode == "min" else float("-inf")
        self.num_bad = 0
        self.cooldown_counter = 0

    def _is_better(self, metric: float) -> bool:
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return metric < self.best * (1 - self.threshold)
            return metric < self.best - self.threshold
        if self.threshold_mode == "rel":
            return metric > self.best * (1 + self.threshold)
        return metric > self.best + self.threshold

    def step(self, metric: float) -> float:
        """Record an epoch metric; returns the (possibly reduced) lr."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.cooldown_counter = self.cooldown
                self.num_bad = 0
        return self.lr

    def state_dict(self):
        return {k: getattr(self, k) for k in
                ("lr", "best", "num_bad", "cooldown_counter")}

    def load_state_dict(self, d):
        for k, v in d.items():
            setattr(self, k, v)


def adam_state_prefix(opt: torch.optim.Optimizer) -> str:
    """Where the JAX package's optimizer state (mpnn_tpu/train/optim.py::
    adam: inject_hyperparams over the chain [add_decayed_weights, when
    weight_decay > 0,] scale_by_adam, scale) keeps Adam's count and
    moments: `inner_state/<i>/` with i the chain index of scale_by_adam."""
    return f"inner_state/{int(opt.param_groups[0]['weight_decay'] > 0)}/"
