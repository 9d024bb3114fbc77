"""Segmentation metrics (counterpart of
behindthescenes_tpu/utils/metrics_extra.py, its numpy copied as it is;
reference utils/metrics.py:44-133): the foreground Adjusted Rand Index
of object-centric evaluations."""
from __future__ import annotations

import numpy as np


def adjusted_rand_index(true_ids: np.ndarray, pred_ids: np.ndarray) -> float:
    """ARI between two integer label maps over the same pixels."""
    true_ids = np.asarray(true_ids).ravel()
    pred_ids = np.asarray(pred_ids).ravel()
    n = true_ids.size
    if n == 0:
        return float("nan")

    t_classes, t_inv = np.unique(true_ids, return_inverse=True)
    p_classes, p_inv = np.unique(pred_ids, return_inverse=True)
    contingency = np.zeros((len(t_classes), len(p_classes)), dtype=np.int64)
    np.add.at(contingency, (t_inv, p_inv), 1)

    def comb2(x):
        return x * (x - 1) / 2.0

    sum_comb_c = comb2(contingency).sum()
    sum_comb_a = comb2(contingency.sum(axis=1)).sum()
    sum_comb_b = comb2(contingency.sum(axis=0)).sum()
    total = comb2(np.float64(n))
    expected = sum_comb_a * sum_comb_b / total if total > 0 else 0.0
    max_index = 0.5 * (sum_comb_a + sum_comb_b)
    denom = max_index - expected
    if denom == 0:
        return 1.0
    return float((sum_comb_c - expected) / denom)


def fg_ari(true_masks: np.ndarray, pred_masks: np.ndarray,
           bg_class: int = 0) -> float:
    """Foreground ARI: ARI restricted to pixels whose TRUE label is not the
    background class (reference utils/metrics.py FG_ARI semantics).

    true_masks / pred_masks: integer label maps of the same shape, or
    one-hot stacks (k, ...) which are argmaxed first.
    """
    true_masks = np.asarray(true_masks)
    pred_masks = np.asarray(pred_masks)
    if true_masks.ndim > 2 and true_masks.shape[0] > 1 and \
            true_masks.dtype != np.int64 and true_masks.dtype != np.int32:
        true_masks = true_masks.argmax(0)
    if pred_masks.ndim > 2 and pred_masks.shape[0] > 1 and \
            pred_masks.dtype != np.int64 and pred_masks.dtype != np.int32:
        pred_masks = pred_masks.argmax(0)
    fg = true_masks != bg_class
    if not fg.any():
        return float("nan")
    return adjusted_rand_index(true_masks[fg], pred_masks[fg])
