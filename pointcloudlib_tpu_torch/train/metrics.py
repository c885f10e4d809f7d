"""Evaluation metrics (counterpart of ``pointcloudlib_tpu/train/metrics.py``):
the ShapeNet part table, the per-shape mean part IoU, the confusion
matrix and the balanced accuracy, in numpy."""

from __future__ import annotations

import numpy as np

# per-category part counts and first part ids (reference
# train_partseg.py:24-25)
SEG_NUM = [4, 2, 2, 4, 4, 3, 3, 2, 4, 2, 6, 2, 3, 3, 3, 3]
INDEX_START = [0, 4, 6, 8, 12, 16, 19, 22, 24, 28, 30, 36, 38, 41, 44, 47]


def shape_ious(pred: np.ndarray, seg: np.ndarray, label: np.ndarray
               ) -> np.ndarray:
    """Per-shape mean part IoU over the shape's category's parts
    (reference ``calculate_shape_IoU``); a part absent from both the
    prediction and the truth counts as IoU 1. ``pred``, ``seg`` [B, N]
    part ids, ``label`` [B] category ids → [B] float64."""
    out = np.empty(len(pred), np.float64)
    for i in range(len(pred)):
        c = int(label[i])
        start, num = INDEX_START[c], SEG_NUM[c]
        ious = []
        for part in range(start, start + num):
            inter = np.sum((pred[i] == part) & (seg[i] == part))
            union = np.sum((pred[i] == part) | (seg[i] == part))
            ious.append(1.0 if union == 0 else inter / union)
        out[i] = np.mean(ious)
    return out


def balanced_accuracy(true: np.ndarray, pred: np.ndarray, n_classes: int
                      ) -> float:
    """Mean recall over the classes present in ``true`` (sklearn's
    ``balanced_accuracy_score``, which the reference uses); 0 when none
    is."""
    cm = fast_confusion(true, pred, n_classes)
    per_class = np.diag(cm) / np.maximum(cm.sum(axis=1), 1)
    present = cm.sum(axis=1) > 0
    return float(per_class[present].mean()) if present.any() else 0.0


def fast_confusion(true: np.ndarray, pred: np.ndarray, n_classes: int
                   ) -> np.ndarray:
    """Confusion matrix ``[n_classes, n_classes]`` int64 by one bincount:
    row = true class, column = predicted class."""
    idx = true.astype(np.int64) * n_classes + pred.astype(np.int64)
    return np.bincount(idx, minlength=n_classes * n_classes).reshape(
        n_classes, n_classes
    )
