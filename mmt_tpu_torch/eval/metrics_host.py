"""Host-side eval metrics: AUC-PR (Keras-compatible bucketing).

The port's own copy of ``mmt_tpu/eval/metrics_host.py:auc_pr``, numpy on
the host: ``tf.keras.metrics.AUC(curve='PR')`` as the reference's
classification task used it (``src/tasks/classification.py:132-148``),
200 evenly spaced thresholds and Keras' interpolated precision-recall
summation, so that reported numbers are comparable.
"""

from __future__ import annotations

import numpy as np


def auc_pr(
    labels: np.ndarray,
    probs: np.ndarray,
    weights: np.ndarray = None,
    num_thresholds: int = 200,
) -> float:
    labels = np.asarray(labels, np.float64).reshape(-1)
    probs = np.asarray(probs, np.float64).reshape(-1)
    weights = (
        np.ones_like(labels)
        if weights is None
        else np.asarray(weights, np.float64).reshape(-1)
    )

    # Keras threshold set: -eps, linspace interior, 1+eps.
    eps = 1e-7
    thresholds = np.concatenate(
        [[-eps], np.linspace(0, 1, num_thresholds)[1:-1], [1 + eps]]
    )

    # Confusion-matrix counts per threshold (prediction > threshold).
    pred_pos = probs[None, :] > thresholds[:, None]  # [T, N]
    w = weights[None, :]
    lab = labels[None, :]
    tp = np.sum(pred_pos * lab * w, axis=1)
    fp = np.sum(pred_pos * (1 - lab) * w, axis=1)
    fn = np.sum((~pred_pos) * lab * w, axis=1)

    # Keras PR interpolation (Davis & Goadrich): between consecutive
    # thresholds, integrate precision over recall analytically.
    dtp = tp[:-1] - tp[1:]
    p = tp + fp
    dp = p[:-1] - p[1:]
    prec_slope = dtp / np.maximum(dp, 1e-10)
    intercept = tp[1:] - prec_slope * p[1:]

    safe_p_ratio = np.where(
        (p[:-1] > 0) & (p[1:] > 0),
        p[:-1] / np.maximum(p[1:], 1e-10),
        np.ones_like(p[1:]),
    )
    total_pos = tp + fn
    areas = (
        prec_slope
        * (dtp + intercept * np.log(safe_p_ratio))
        / np.maximum(total_pos[1:], 1e-10)
    )
    return float(np.sum(np.where(total_pos[1:] > 0, areas, 0.0)))
