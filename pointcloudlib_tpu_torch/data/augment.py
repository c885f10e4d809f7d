"""Host-side numpy augmentations (counterpart of
``pointcloudlib_tpu/data/augment.py``; only what serving needs)."""

from __future__ import annotations

import numpy as np


def normalize_unit_sphere(pts: np.ndarray) -> np.ndarray:
    """Center at the centroid, scale to the unit sphere."""
    pts = pts - pts.mean(axis=0, keepdims=True)
    scale = np.max(np.linalg.norm(pts, axis=1))
    return pts / np.maximum(scale, 1e-12)
