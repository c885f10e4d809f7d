"""Kernel-point dispositions (counterpart of
``pointcloudlib_tpu/models/kpconv/kernel_points.py``; numpy, the same
code and seeds, so the points are bit-identical to the JAX package's).

K points in the unit ball from a seeded optimizer: mutual inverse-square
repulsion plus a spring toward the origin, the first point pinned at the
center, the mean non-center radius normalized to 0.66; above 30 points a
Monte-Carlo Lloyd relaxation instead. The unit layout is cached as a ply
under ``dispositions/`` beside this module (written at first use, not
kept in the repository); :func:`load_kernels` rotates it about z, adds
0.01 Gaussian noise from ``default_rng(seed)`` and scales it to the
radius.
"""

from __future__ import annotations

import functools
import os
from pathlib import Path

import numpy as np

from pointcloudlib_tpu_torch.utils.ply import read_ply, write_ply

_CACHE_DIR = Path(__file__).parent / "dispositions"


def _optimize_dispositions(
    k: int, dim: int = 3, n_iter: int = 3000, seed: int = 42
) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # init: random in unit ball, first point at origin
    pts = rng.standard_normal((k, dim))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    pts *= rng.uniform(0.3, 1.0, (k, 1)) ** (1.0 / dim)
    pts[0] = 0.0

    lr = 0.01
    for _ in range(n_iter):
        diff = pts[:, None, :] - pts[None, :, :]          # [K, K, dim]
        d = np.linalg.norm(diff, axis=-1) + 1e-9
        np.fill_diagonal(d, np.inf)
        # inverse-square repulsion + linear attraction to the center
        rep = np.sum(diff / (d**3)[..., None], axis=1)
        grad = rep - 2.0 * pts
        pts = pts + lr * grad
        pts[0] = 0.0
        # keep inside the unit ball
        r = np.linalg.norm(pts, axis=1, keepdims=True)
        pts = np.where(r > 1.0, pts / np.maximum(r, 1e-9), pts)

    # normalize spread: non-center points' mean radius → 0.66
    r = np.linalg.norm(pts[1:], axis=1).mean()
    pts = pts * (0.66 / max(r, 1e-9))
    pts[0] = 0.0
    return pts.astype(np.float32)


def _ball_uniform(rng, n: int, dim: int) -> np.ndarray:
    """n points uniform in the unit ball (direction × r^(1/dim))."""
    v = rng.standard_normal((n, dim))
    v /= np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
    return v * rng.uniform(0.0, 1.0, (n, 1)) ** (1.0 / dim)


def _lloyd_dispositions(
    k: int,
    dim: int = 3,
    n_samples: int = 20000,
    n_iter: int = 200,
    momentum: float = 0.9,
    seed: int = 42,
) -> np.ndarray:
    """Centroidal-Voronoi layout by Monte-Carlo Lloyd relaxation: each
    iteration draws uniform-ball samples, assigns them to the nearest
    kernel point and moves each point part of the way to its cell's
    centroid; the center stays pinned, and there is no 0.66
    renormalization."""
    rng = np.random.default_rng(seed)
    pts = _ball_uniform(rng, k, dim)
    pts[0] = 0.0
    for _ in range(n_iter):
        s = _ball_uniform(rng, n_samples, dim)
        d2 = ((s[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        assign = np.argmin(d2, axis=1)
        cnt = np.bincount(assign, minlength=k).astype(np.float64)
        sums = np.zeros((k, dim))
        np.add.at(sums, assign, s)
        cent = np.where(cnt[:, None] > 0, sums / np.maximum(
            cnt[:, None], 1.0), pts)
        pts = momentum * pts + (1.0 - momentum) * cent
        pts[0] = 0.0
    return pts.astype(np.float32)


def kernel_dispositions(k: int, dim: int = 3) -> np.ndarray:
    """Unit-scale kernel point layout ``[k, dim]``, cached on disk as a
    ply; up to 30 points the repulsive optimizer, above it Lloyd."""
    _CACHE_DIR.mkdir(parents=True, exist_ok=True)
    cache = _CACHE_DIR / f"k_{k:03d}_center_{dim}D.ply"
    if cache.exists():
        d = read_ply(cache)
        return np.vstack([d[c] for c in ("x", "y", "z")[:dim]]).T.astype(
            np.float32
        )
    if k > 30:
        pts = _lloyd_dispositions(k, dim)
    else:
        pts = _optimize_dispositions(k, dim)
    # written aside and renamed: a process that finds the file reads it
    # whole
    part = cache.with_name(f"{cache.name}.{os.getpid()}.part")
    write_ply(part, {"xyz": pts})
    os.replace(part, cache)
    return pts


@functools.lru_cache(maxsize=64)
def load_kernels(
    radius: float,
    num_kpoints: int,
    dimension: int = 3,
    fixed: str = "center",
    seed: int = 0,
) -> np.ndarray:
    """Kernel points ``[num_kpoints, dimension]`` scaled to ``radius``:
    in 3-D a rotation about z by an angle from ``default_rng(seed)``, then
    0.01 Gaussian noise from the same generator, the center kept at 0 for
    ``fixed="center"``."""
    pts = kernel_dispositions(num_kpoints, dimension).copy()
    rng = np.random.default_rng(seed)
    if dimension == 3:
        theta = rng.uniform(0, 2 * np.pi)
        c, s = np.cos(theta), np.sin(theta)
        q = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        pts = pts @ q.T
    noise = rng.standard_normal(pts.shape).astype(np.float32) * 0.01
    pts = pts + noise
    if fixed == "center":
        pts[0] = 0.0
    return (pts * radius).astype(np.float32)
