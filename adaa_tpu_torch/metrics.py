"""Host-side evaluation metrics (port of ``adaa_tpu/metrics.py``), numpy
and scipy only.

EER via the ROC and brentq root finding, plus accuracy / precision /
recall / F1 / AUC with the reference's label handling (callers flip the
labels before the EER: ``y_for_eer = 1 - y``). The JAX package takes the
ROC, the AUC and the binary precision / recall / F1 from sklearn; here
they are plain numpy that gives sklearn's values. The EER interpolates
over the ROC's points, so ``roc_curve`` keeps exactly sklearn's point
set: one point per distinct score (ties merged), collinear interior
points dropped (``drop_intermediate``) and a leading (0, 0) point.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
from scipy.interpolate import interp1d
from scipy.optimize import brentq


def roc_curve(y_true, y_score) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """sklearn.metrics.roc_curve for binary {0, 1} labels (positive 1)."""
    y_true = (np.asarray(y_true) == 1).astype(np.float64)
    y_score = np.asarray(y_score)
    if not np.isfinite(y_score).all():
        raise ValueError("Input y_score contains NaN or infinity.")
    # descending, ties in input order (every tie group is merged below)
    order = np.argsort(-y_score, kind="stable")
    y_score, y_true = y_score[order], y_true[order]
    threshold_idxs = np.r_[np.nonzero(np.diff(y_score))[0], y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[threshold_idxs]
    fps = 1 + threshold_idxs.astype(np.float64) - tps
    thresholds = y_score[threshold_idxs]
    if fps.shape[0] > 2:  # drop interior points collinear with their neighbours
        keep = np.nonzero(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds.astype(np.float64)]
    fpr = np.full(fps.shape, np.nan) if fps[-1] <= 0 else fps / fps[-1]
    tpr = np.full(tps.shape, np.nan) if tps[-1] <= 0 else tps / tps[-1]
    return fpr, tpr, thresholds


def roc_auc_score(y_true, y_score) -> float:
    """sklearn.metrics.roc_auc_score, binary: nan when one class is present."""
    if len(np.unique(np.asarray(y_true))) != 2:
        return float("nan")
    fpr, tpr, _ = roc_curve(y_true, y_score)
    return float((np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0).sum())  # np.trapezoid


def precision_recall_f1(y_true, y_pred) -> Tuple[float, float, float]:
    """Binary precision / recall / F1 of the positive class 1, 0 where a
    denominator is 0 (sklearn's ``zero_division=0``)."""
    y_true = np.asarray(y_true) == 1
    y_pred = np.asarray(y_pred) == 1
    tp = float((y_true & y_pred).sum())
    pred_sum, true_sum = float(y_pred.sum()), float(y_true.sum())
    precision = tp / pred_sum if pred_sum else 0.0
    recall = tp / true_sum if true_sum else 0.0
    f1 = 2.0 * tp / (true_sum + pred_sum) if true_sum + pred_sum else 0.0
    return precision, recall, f1


def calculate_eer(y, y_score) -> Tuple[float, float, np.ndarray, np.ndarray]:
    """Equal error rate on (flipped) labels (reference src/metrics.py:9-14):
    the ROC of the negated scores, and the root of
    ``1 - x - interp1d(fpr, tpr)(x)``. Returns (threshold, eer, fpr, tpr)."""
    fpr, tpr, thresholds = roc_curve(np.asarray(y), -np.asarray(y_score))
    eer = brentq(lambda x: 1.0 - x - interp1d(fpr, tpr)(x), 0.0, 1.0)
    thresh = interp1d(fpr, thresholds)(eer)
    return thresh, eer, fpr, tpr


def classification_report(y: np.ndarray, y_pred: np.ndarray,
                          y_pred_label: np.ndarray) -> Dict[str, float]:
    """The eval metric set with the reference's conventions: accuracy in
    percent, binary precision / recall / F1, AUC on the raw sigmoid
    scores, EER on flipped labels."""
    y = np.asarray(y).astype(np.float64)
    y_pred = np.asarray(y_pred).astype(np.float64)
    y_pred_label = np.asarray(y_pred_label).astype(np.int64)

    num_correct = float((y_pred_label == y.astype(np.int64)).sum())
    accuracy = (num_correct / max(len(y), 1)) * 100.0
    precision, recall, f1_score = precision_recall_f1(y, y_pred_label)
    auc_score = roc_auc_score(y, y_pred)
    try:
        _, eer, _, _ = calculate_eer(y=1 - y, y_score=y_pred)
    except (ValueError, ZeroDivisionError):
        eer = float("nan")
    return {
        "eer": float(eer),
        "accuracy": float(accuracy),
        "precision": float(precision),
        "recall": float(recall),
        "f1_score": float(f1_score),
        "auc": float(auc_score),
    }


def format_metrics(prefix: str, m: Dict[str, float]) -> str:
    """The reference's log line, e.g. ``eval/eer: 0.0123, eval/accuracy: 98.7000, ...``."""
    order = ["eer", "accuracy", "precision", "recall", "f1_score", "auc"]
    return ", ".join(f"{prefix}/{k}: {m[k]:.4f}" for k in order if k in m)
