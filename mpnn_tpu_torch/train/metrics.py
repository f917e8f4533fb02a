"""Regression metrics, numpy-native (counterpart of
mpnn_tpu/train/metrics.py; test_lipo.py:72 mean_squared_error)."""

from __future__ import annotations

import numpy as np


def mean_squared_error(y_true, y_pred) -> float:
    y_true = np.asarray(y_true, np.float64)
    y_pred = np.asarray(y_pred, np.float64)
    return float(((y_true - y_pred) ** 2).mean())


def rmse(y_true, y_pred) -> float:
    return float(np.sqrt(mean_squared_error(y_true, y_pred)))
