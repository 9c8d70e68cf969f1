"""Recall@K over retrieval prediction results, numpy only.

Counterpart of ``mmt_tpu/eval/recall.py`` without pandas.  Given per-pair
rows (image_index, text_index, gt_image_index, output) this reproduces the
reference's metric with its quirks:

* duplicate (image, text) rows are averaged;
* pairs absent from the grid score -1 (all real scores are probabilities
  in [0, 1], so they always lose) and count as negatives;
* ranks come from a double argsort, so tied scores get distinct ranks in
  numpy's (unstable) sort order;
* a query with at least one ground-truth match counts as a hit if *any*
  of its matches ranks in the top k; queries with no ground truth are
  excluded from the denominator (a pool with none at all gives 'nan').
"""

from __future__ import annotations

import collections
from typing import Dict

import numpy as np

_MISSING_SCORE = -1.0


def _mean_grid(rows, cols, values, fill):
    """Dense [n_rows, n_cols] grid of duplicate-averaged values; cells
    with no observation get ``fill``."""
    shape = (rows.max() + 1, cols.max() + 1)
    flat = rows * shape[1] + cols
    total = np.bincount(flat, weights=values, minlength=shape[0] * shape[1])
    count = np.bincount(flat, minlength=shape[0] * shape[1])
    seen = count > 0
    grid = np.full(shape[0] * shape[1], float(fill))
    grid[seen] = total[seen] / count[seen]
    return grid.reshape(shape)


def _descending_ranks(scores, axis):
    """1-based rank of each score within its slice, best score = rank 1."""
    ascending = np.argsort(np.argsort(scores, axis=axis), axis=axis)
    return scores.shape[axis] - ascending


def _recall_from_ranks(ranks, gt, axis, k):
    """Fraction of queries whose best-ranked ground-truth match is within
    the top k, with the reference's fractional-gt weighting."""
    weighted = ranks * gt
    hit_per_pair = (weighted > 0) & (weighted <= k)
    hits = hit_per_pair.any(axis=axis)
    denom = np.clip(gt.sum(axis=axis), 0.0, 1.0).sum()
    return hits.sum() / denom if denom else float("nan")


def get_recall_at_k(image_index, text_index, gt_image_index, output,
                    topks=(1, 3, 5, 10)) -> Dict[str, str]:
    """Returns the reference's formatted recall dict, e.g.
    ``{'i2t @  1': '0.1234', ...}``, from per-row numpy arrays."""
    image_index = np.asarray(image_index)
    _, row = np.unique(image_index, return_inverse=True)
    _, col = np.unique(np.asarray(text_index), return_inverse=True)
    scores = _mean_grid(row, col, np.asarray(output, float), _MISSING_SCORE)
    positive = (image_index == np.asarray(gt_image_index)).astype(float)
    gt = _mean_grid(row, col, positive, 0.0)

    result = collections.OrderedDict()
    for name, axis in (("i2t", 1), ("t2i", 0)):
        ranks = _descending_ranks(scores, axis=axis)
        for k in topks:
            recall = _recall_from_ranks(ranks, gt, axis, k)
            result[f"{name} @ {k:>2}"] = f"{recall:.4f}"
    return result
