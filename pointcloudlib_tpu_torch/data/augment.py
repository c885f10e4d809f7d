"""Host-side numpy augmentations (counterpart of
``pointcloudlib_tpu/data/augment.py``), run in the input pipeline.

The reference's ModelNet40 recipe: unit-sphere normalization, train-time
anisotropic scale in [2/3, 3/2] and translation in ±0.2, a per-item
point shuffle; KPConv's rotation about the gravity axis and jitter. For
the same ``np.random.Generator`` state every function makes the JAX
package's draws, in the same order and dtypes, so the outputs are
bit-identical.
"""

from __future__ import annotations

import numpy as np


def normalize_unit_sphere(pts: np.ndarray) -> np.ndarray:
    """Center at the centroid, scale to the unit sphere."""
    pts = pts - pts.mean(axis=0, keepdims=True)
    scale = np.max(np.linalg.norm(pts, axis=1))
    return pts / np.maximum(scale, 1e-12)


def random_scale_translate(
    pts: np.ndarray,
    rng: np.random.Generator,
    scale_lo: float = 2.0 / 3.0,
    scale_hi: float = 3.0 / 2.0,
    translate: float = 0.2,
) -> np.ndarray:
    """Anisotropic per-axis scale, then a translation."""
    s = rng.uniform(scale_lo, scale_hi, size=(1, 3)).astype(pts.dtype)
    t = rng.uniform(-translate, translate, size=(1, 3)).astype(pts.dtype)
    return pts * s + t


def random_permutation(n: int, rng: np.random.Generator) -> np.ndarray:
    return rng.permutation(n)


def normalize_unit_sphere_batch(pts: np.ndarray) -> np.ndarray:
    """:func:`normalize_unit_sphere` of each cloud of ``[B, N, 3]`` in one
    numpy call per stage."""
    pts = pts - pts.mean(axis=1, keepdims=True)
    # einsum square-norm: no [B, N, 3] temporary like linalg.norm
    scale = np.sqrt(np.einsum("bnc,bnc->bn", pts, pts).max(axis=1))
    return pts / np.maximum(scale, 1e-12)[:, None, None]


def random_scale_translate_batch(
    pts: np.ndarray,
    rng: np.random.Generator,
    scale_lo: float = 2.0 / 3.0,
    scale_hi: float = 3.0 / 2.0,
    translate: float = 0.2,
) -> np.ndarray:
    """:func:`random_scale_translate` with independent draws per cloud of
    ``[B, N, 3]``."""
    b = pts.shape[0]
    s = rng.uniform(scale_lo, scale_hi, size=(b, 1, 3)).astype(pts.dtype)
    t = rng.uniform(-translate, translate, size=(b, 1, 3)).astype(pts.dtype)
    return pts * s + t


def subsample_rows_batch(
    n_total: int, n_points: int, b: int, rng: np.random.Generator
) -> np.ndarray:
    """``[B, n_points]`` independent uniform subsets of ``range(n_total)``
    without replacement: the subsets of ``rng.permutation(n_total)
    [:n_points]`` per item, in argpartition's order."""
    keys = rng.random((b, n_total), dtype=np.float32)  # f32: 2x faster
    return np.argpartition(keys, n_points, axis=1)[:, :n_points]


def rotate_z(pts: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Random rotation about the gravity axis (KPConv's 'vertical'
    mode)."""
    theta = rng.uniform(0, 2 * np.pi)
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=pts.dtype)
    return pts @ rot.T


def jitter(
    pts: np.ndarray, rng: np.random.Generator, sigma: float = 0.001
) -> np.ndarray:
    return pts + rng.normal(0, sigma, pts.shape).astype(pts.dtype)
