"""Procedural synthetic point clouds (counterpart of
``pointcloudlib_tpu/data/synthetic.py``; classification, eval split).

Parametric surface primitives (sphere, cube, cylinder, cone, torus,
plane, helix, two spheres) with per-class deformation, normalized to the
unit sphere: real ball-query occupancy for the serving path, which
Gaussian noise would not give.
"""

from __future__ import annotations

import numpy as np

from pointcloudlib_tpu_torch.data.augment import normalize_unit_sphere

_SHAPES = [
    "sphere", "cube", "cylinder", "cone", "torus",
    "plane", "helix", "two_spheres",
]


def _unit(v, axis=-1, keepdims=True):
    return v / np.maximum(np.linalg.norm(v, axis=axis, keepdims=keepdims), 1e-12)


def _sample_shape(kind: str, n: int, rng: np.random.Generator):
    """Returns (points [n,3], normals [n,3])."""
    if kind == "sphere":
        d = _unit(rng.standard_normal((n, 3)))
        return d, d
    if kind == "two_spheres":
        d = _unit(rng.standard_normal((n, 3))) * 0.5
        side = rng.integers(0, 2, n)[:, None]
        off = np.where(side == 0, -0.55, 0.55)
        pts = d + np.concatenate([off, np.zeros((n, 2))], axis=1)
        return pts, _unit(d)
    if kind == "cube":
        face = rng.integers(0, 6, n)
        uv = rng.uniform(-1, 1, (n, 2))
        pts = np.empty((n, 3)); nrm = np.zeros((n, 3))
        ax, sign = face % 3, np.where(face < 3, 1.0, -1.0)
        rows = np.arange(n)
        comp = np.array([[1, 2], [0, 2], [0, 1]])  # axes ⊥ to ax
        pts[rows, ax] = sign
        pts[rows, comp[ax, 0]] = uv[:, 0]
        pts[rows, comp[ax, 1]] = uv[:, 1]
        nrm[rows, ax] = sign
        return pts * 0.7, nrm
    if kind == "cylinder":
        theta = rng.uniform(0, 2 * np.pi, n)
        z = rng.uniform(-1, 1, n)
        pts = np.stack([np.cos(theta), np.sin(theta), z], 1) * [0.6, 0.6, 1.0]
        nrm = np.stack([np.cos(theta), np.sin(theta), np.zeros(n)], 1)
        return pts, nrm
    if kind == "cone":
        h = rng.uniform(0, 1, n) ** 0.5
        theta = rng.uniform(0, 2 * np.pi, n)
        r = (1 - h) * 0.7
        pts = np.stack([r * np.cos(theta), r * np.sin(theta), h * 1.4 - 0.7], 1)
        nrm = _unit(np.stack([np.cos(theta), np.sin(theta), np.full(n, 0.5)], 1))
        return pts, nrm
    if kind == "torus":
        u = rng.uniform(0, 2 * np.pi, n)
        v = rng.uniform(0, 2 * np.pi, n)
        R, r = 0.7, 0.25
        pts = np.stack(
            [(R + r * np.cos(v)) * np.cos(u),
             (R + r * np.cos(v)) * np.sin(u),
             r * np.sin(v)], 1)
        nrm = np.stack(
            [np.cos(v) * np.cos(u), np.cos(v) * np.sin(u), np.sin(v)], 1)
        return pts, nrm
    if kind == "plane":
        uv = rng.uniform(-1, 1, (n, 2))
        pts = np.concatenate([uv, 0.05 * np.sin(3 * uv[:, :1])], 1)
        nrm = np.tile(np.array([[0.0, 0.0, 1.0]]), (n, 1))
        return pts, nrm
    if kind == "helix":
        t = rng.uniform(0, 4 * np.pi, n)
        jitter = rng.normal(0, 0.05, (n, 3))
        pts = np.stack([0.7 * np.cos(t), 0.7 * np.sin(t), t / (2 * np.pi) - 1], 1)
        return pts + jitter, _unit(jitter + 1e-3)
    raise ValueError(kind)


class SyntheticModelNet:
    """ModelNet40-shaped synthetic classification set, without train-time
    augmentation: per item ``(pts [N,3] f32, normals [N,3] f32, label)``.
    The same ``seed`` and ``train`` give the same items as the JAX
    package's ``SyntheticModelNet(..., augment=False)``."""

    def __init__(
        self,
        n_points: int = 1024,
        n_classes: int = 40,
        size: int = 512,
        train: bool = False,
        seed: int = 0,
    ):
        self.n_points = n_points
        self.n_classes = n_classes
        self.size = size
        rng = np.random.default_rng(seed + (0 if train else 10_000))
        # fixed per-item seeds -> deterministic dataset
        self._seeds = rng.integers(0, 2**31 - 1, size)
        self._labels = (np.arange(size) % n_classes).astype(np.int32)

    def __len__(self):
        return self.size

    def __getitem__(self, i: int):
        rng = np.random.default_rng(self._seeds[i])
        label = int(self._labels[i])
        kind = _SHAPES[label % len(_SHAPES)]
        pts, nrm = _sample_shape(kind, self.n_points, rng)
        # class-dependent deterministic deformation distinguishes the
        # 5 classes sharing one primitive
        variant = label // len(_SHAPES)
        stretch = 1.0 + 0.15 * variant
        pts = pts * np.array([1.0, stretch, 1.0 / stretch])
        pts = normalize_unit_sphere(pts.astype(np.float32))
        return pts.astype(np.float32), nrm.astype(np.float32), label

    def batch(self, start: int, count: int):
        """Items ``[start, start+count)`` stacked: ``(pts [count,N,3],
        normals [count,N,3], labels [count])``."""
        items = [self[i] for i in range(start, start + count)]
        return (np.stack([p for p, _, _ in items]),
                np.stack([n for _, n, _ in items]),
                np.array([l for _, _, l in items], np.int32))
