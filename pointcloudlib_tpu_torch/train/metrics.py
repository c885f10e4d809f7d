"""Part-segmentation metrics (counterpart of
``pointcloudlib_tpu/train/metrics.py:1-31``): the ShapeNet part table and
the per-shape mean part IoU, in numpy."""

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
