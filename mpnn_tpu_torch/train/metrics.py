"""Evaluation metrics, numpy-native (counterpart of
mpnn_tpu/train/metrics.py): the sklearn calls the reference scripts make
(test.py:45-49 accuracy/precision/recall weighted, test_graph_encode_norm.py
micro, test_single_target.py:43-47 binary, test_lipo.py:72
mean_squared_error)."""

from __future__ import annotations

import numpy as np


def accuracy(y_true, y_pred) -> float:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    return float((y_true == y_pred).mean()) if len(y_true) else 0.0


def _per_class_counts(y_true, y_pred, classes):
    tp = np.array([np.sum((y_pred == c) & (y_true == c)) for c in classes],
                  np.float64)
    fp = np.array([np.sum((y_pred == c) & (y_true != c)) for c in classes],
                  np.float64)
    fn = np.array([np.sum((y_pred != c) & (y_true == c)) for c in classes],
                  np.float64)
    support = np.array([np.sum(y_true == c) for c in classes], np.float64)
    return tp, fp, fn, support


def _safe_div(a, b):
    return np.where(b > 0, a / np.maximum(b, 1), 0.0)


def precision_recall_f1(y_true, y_pred, average: str = "weighted",
                        pos_label: int = 1):
    """average: 'weighted' | 'micro' | 'macro' | 'binary'."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    if average == "binary":
        classes = np.array([pos_label])
    else:
        classes = np.union1d(np.unique(y_true), np.unique(y_pred))
    tp, fp, fn, support = _per_class_counts(y_true, y_pred, classes)
    if average == "micro":
        p = _safe_div(tp.sum(), tp.sum() + fp.sum())
        r = _safe_div(tp.sum(), tp.sum() + fn.sum())
        f = _safe_div(2 * p * r, p + r)
        return float(p), float(r), float(f)
    p = _safe_div(tp, tp + fp)
    r = _safe_div(tp, tp + fn)
    f = _safe_div(2 * p * r, p + r)
    if average == "binary":
        return float(p[0]), float(r[0]), float(f[0])
    if average == "macro":
        return float(p.mean()), float(r.mean()), float(f.mean())
    w = _safe_div(support, support.sum())
    return (float((p * w).sum()), float((r * w).sum()),
            float((f * w).sum()))


def mean_squared_error(y_true, y_pred) -> float:
    y_true = np.asarray(y_true, np.float64)
    y_pred = np.asarray(y_pred, np.float64)
    return float(((y_true - y_pred) ** 2).mean())


def rmse(y_true, y_pred) -> float:
    return float(np.sqrt(mean_squared_error(y_true, y_pred)))


def classification_report(y_true, y_pred, average: str = "weighted"):
    p, r, f = precision_recall_f1(y_true, y_pred, average)
    return {"accuracy": accuracy(y_true, y_pred),
            "precision": p, "recall": r, "f1": f}
