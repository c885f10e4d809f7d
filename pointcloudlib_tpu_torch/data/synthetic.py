"""Procedural synthetic point clouds (counterpart of
``pointcloudlib_tpu/data/synthetic.py``): ModelNet40-shaped
classification, with the train-time augmentation, and ShapeNet-part-shaped
segmentation.

Parametric surface primitives (sphere, cube, cylinder, cone, torus,
plane, helix, two spheres) with per-class deformation, normalized to the
unit sphere: real ball-query occupancy for the serving path, which
Gaussian noise would not give. The same arguments give the JAX
package's items, bit for bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pointcloudlib_tpu_torch.data import augment as A
from pointcloudlib_tpu_torch.train.metrics import INDEX_START, SEG_NUM

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
    """ModelNet40-shaped synthetic classification set: per item ``(pts
    [N,3] f32, normals [N,3] f32, label)``, unit-sphere normalized, and
    with ``augment`` the train-time scale, translation and point shuffle.

    ``train`` defaults to False here (the JAX class defaults to True): the
    port's tools and ``chip_smoke.py`` take un-augmented test-split items
    without naming the split. ``augment=None`` follows ``train``, as in
    the JAX class. The per-item seeds are the first draws of the
    dataset's generator ``_rng``; each augmented item then draws a child
    generator from it, so a pass's augmentations depend on the items read
    before (fresh randomness per epoch and vote). The same arguments and
    reads give the JAX package's items, bit for bit."""

    def __init__(
        self,
        n_points: int = 1024,
        n_classes: int = 40,
        size: int = 512,
        train: bool = False,
        seed: int = 0,
        augment: Optional[bool] = None,
    ):
        self.n_points = n_points
        self.n_classes = n_classes
        self.size = size
        self.train = train
        self.augment = train if augment is None else augment
        self._rng = np.random.default_rng(seed + (0 if train else 10_000))
        # fixed per-item seeds -> deterministic dataset
        self._seeds = self._rng.integers(0, 2**31 - 1, size)
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
        pts = A.normalize_unit_sphere(pts.astype(np.float32))
        nrm = nrm.astype(np.float32)
        if self.augment:
            # voting passes need fresh randomness per epoch/vote
            arng = np.random.default_rng(self._rng.integers(2**31 - 1))
            pts = A.random_scale_translate(pts, arng)
            perm = arng.permutation(self.n_points)
            pts, nrm = pts[perm], nrm[perm]
        return pts.astype(np.float32), nrm, label

    def batch(self, start: int, count: int):
        """Items ``[start, start+count)`` stacked: ``(pts [count,N,3],
        normals [count,N,3], labels [count])``."""
        items = [self[i] for i in range(start, start + count)]
        return (np.stack([p for p, _, _ in items]),
                np.stack([n for _, n, _ in items]),
                np.array([l for _, _, l in items], np.int32))


class SyntheticShapeNetPart:
    """ShapeNet-part-shaped synthetic segmentation set: per item ``(pts
    [N,3] f32, label int (16 categories, in turn), seg [N] int32 (50
    parts))``, the parts being bands of the shape along a
    category-dependent axis; with ``class_choice`` (a name of
    :data:`CATEGORIES`) every item is of that category. The same
    arguments give the same items as the JAX package's
    ``SyntheticShapeNetPart``."""

    N_CATEGORIES = 16
    N_PARTS = 50
    # the category order of the reference's hdf5 set
    CATEGORIES = ["airplane", "bag", "cap", "car", "chair", "earphone",
                  "guitar", "knife", "lamp", "laptop", "motorbike", "mug",
                  "pistol", "rocket", "skateboard", "table"]

    def __init__(self, n_points: int = 2048, size: int = 256,
                 train: bool = True, seed: int = 0,
                 class_choice: Optional[str] = None):
        self.n_points = n_points
        self.size = size
        self.train = train
        rng = np.random.default_rng(seed + (0 if train else 20_000))
        self._seeds = rng.integers(0, 2**31 - 1, size)
        if class_choice is not None:
            cat = self.CATEGORIES.index(class_choice.lower())
            self._labels = np.full(size, cat, np.int32)
        else:
            self._labels = (
                np.arange(size) % self.N_CATEGORIES).astype(np.int32)

    def __len__(self):
        return self.size

    def __getitem__(self, i: int):
        rng = np.random.default_rng(self._seeds[i])
        label = int(self._labels[i])
        kind = _SHAPES[label % len(_SHAPES)]
        pts, _ = _sample_shape(kind, self.n_points, rng)
        pts = pts.astype(np.float32)
        n_parts = SEG_NUM[label]
        coord = pts[:, label % 3]
        edges = np.quantile(coord, np.linspace(0, 1, n_parts + 1)[1:-1])
        seg = np.searchsorted(edges, coord).astype(np.int32)
        seg = seg + INDEX_START[label]
        if self.train:
            perm = rng.permutation(self.n_points)
            pts, seg = pts[perm], seg[perm]
        return pts, label, seg

    def batch(self, start: int, count: int):
        """Items ``[start, start+count)`` stacked: ``(pts [count,N,3],
        labels [count], seg [count,N])``."""
        items = [self[i] for i in range(start, start + count)]
        return (np.stack([p for p, _, _ in items]),
                np.array([l for _, l, _ in items], np.int32),
                np.stack([s for _, _, s in items]))
