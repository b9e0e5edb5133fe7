"""Detector evaluation: ROC and equal-error rate (a copy of the JAX
package's `metrics/eer.py`, pure numpy).

The EER is the crossing of FPR(t) and 1 - TPR(t), found by linear
interpolation on the ROC polyline; tied scores share one threshold, as in
sklearn's `roc_curve`.
"""

from __future__ import annotations

import numpy as np


def roc_curve(scores: np.ndarray, labels: np.ndarray):
    """-> (fpr, tpr) sorted by decreasing threshold. labels in {0,1},
    higher score = more positive."""
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = np.asarray(labels).ravel().astype(bool)
    order = np.argsort(-scores, kind="stable")
    sorted_scores = scores[order]
    labels = labels[order]
    tps = np.cumsum(labels)
    fps = np.cumsum(~labels)
    # Tied scores share one threshold: keep only the cumulative counts at the
    # end of each tied group (intermediate staircase vertices are not on the
    # ROC — matches sklearn.metrics.roc_curve's drop of duplicate thresholds).
    distinct = np.concatenate([sorted_scores[1:] != sorted_scores[:-1], [True]])
    tps = tps[distinct]
    fps = fps[distinct]
    tpr = tps / max(tps[-1], 1)
    fpr = fps / max(fps[-1], 1)
    return np.concatenate([[0.0], fpr]), np.concatenate([[0.0], tpr])


def compute_eer(scores: np.ndarray, labels: np.ndarray) -> float:
    """EER: the rate where FPR == FNR (== 1 - TPR)."""
    fpr, tpr = roc_curve(scores, labels)
    fnr = 1.0 - tpr
    diff = fpr - fnr
    idx = int(np.searchsorted(diff, 0.0, side="left"))
    if idx == 0:
        return float(fpr[0])
    if idx >= len(diff):
        return float(fnr[-1])
    # linear interpolation between the bracketing ROC vertices
    x0, x1 = diff[idx - 1], diff[idx]
    w = 0.0 if x1 == x0 else -x0 / (x1 - x0)
    return float((1 - w) * fpr[idx - 1] + w * fpr[idx])
