"""Plain PyTorch point-cloud geometry (counterpart of
``pointcloudlib_tpu/ops/geometry.py``).

Conventions are the JAX package's: channel-last ``[B, N, C]`` float32
clouds, ``int32`` neighbour indices of static width, repeat-first
padding. Every function here runs on any device as ordinary tensor ops;
the sequential and hot pieces of the serving path have CUDA kernels in
``ops/kernels`` that these functions are the plain versions of.

Distances are summed channel by channel in index order, one rounding per
operation: no fused multiply-add and no reordered reduction, so the CPU,
these ops on the card and the CUDA kernels form bit-identical d², and
FPS picks and ball-query membership agree exactly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = [
    "square_distance",
    "index_points",
    "ball_query",
    "farthest_point_sample",
    "group_points",
    "group_all",
]


def _sumsq(x: torch.Tensor) -> torch.Tensor:
    """``((x0·x0 + x1·x1) + x2·x2)…`` over the last axis."""
    s = x[..., 0] * x[..., 0]
    for c in range(1, x.shape[-1]):
        s = s + x[..., c] * x[..., c]
    return s


def square_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distance ``[B, N, C] × [B, M, C] → [B, N, M]``
    in the expanded form ``|a|² − 2·a·b + |b|²`` of the JAX package
    (``geometry.py:71``), clamped at 0, in float32."""
    a = a.float()
    b = b.float()
    inner = a[:, :, None, 0] * b[:, None, :, 0]
    for c in range(1, a.shape[-1]):
        inner = inner + a[:, :, None, c] * b[:, None, :, c]
    d2 = (_sumsq(a)[:, :, None] - 2.0 * inner) + _sumsq(b)[:, None, :]
    return torch.clamp_min(d2, 0.0)


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather: ``points [B, N, C]``, ``idx [B, ...]`` →
    ``[B, ..., C]``."""
    b, _, c = points.shape
    flat = idx.reshape(b, -1, 1).long().expand(-1, -1, c)
    return torch.gather(points, 1, flat).reshape(*idx.shape, c)


def ball_query(
    centers: torch.Tensor,
    points: torch.Tensor,
    radius: float,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """First ``k`` in-radius points in index order (strict ``d² < r²``).

    Returns ``(idx [B, M, k] int32, cnt [B, M] int32)``; short rows
    repeat their first hit, rows with none fall back to index 0
    (``geometry.py:219``)."""
    n = points.shape[1]
    d2 = square_distance(centers, points)
    mask = d2 < radius * radius
    ar = torch.arange(n, device=points.device, dtype=torch.int64)
    pos = torch.where(mask, ar, torch.full_like(ar, n))
    sel = torch.sort(pos, dim=-1).values[..., : min(k, n)]
    if k > n:
        sel = torch.cat(
            [sel, torch.full((*sel.shape[:-1], k - n), n, dtype=sel.dtype,
                             device=sel.device)], dim=-1)
    valid = sel < n
    first = torch.where(valid[..., :1], sel[..., :1],
                        torch.zeros_like(sel[..., :1]))
    idx = torch.where(valid, sel, first)
    cnt = mask.sum(-1)
    return idx.to(torch.int32), cnt.to(torch.int32)


def farthest_point_sample(
    xyz: torch.Tensor,
    n_samples: int,
    skip_near_origin: bool = True,
) -> torch.Tensor:
    """Iterative farthest-point sampling → ``idx [B, n_samples] int32``
    (``geometry.py:264``): seed index 0, running min-d² cache, argmax
    with the lowest index on ties, points with ``|p|² ≤ 1e-3`` never
    picked (score −1) when ``skip_near_origin``."""
    b, n, _ = xyz.shape
    xyz = xyz.float()
    x, y, z = xyz.unbind(-1)
    out = torch.zeros((b, n_samples), dtype=torch.int32, device=xyz.device)
    if skip_near_origin:
        eligible = _sumsq(xyz) > 1e-3
    else:
        eligible = torch.ones((b, n), dtype=torch.bool, device=xyz.device)
    min_d2 = torch.full((b, n), 1e10, dtype=torch.float32,
                        device=xyz.device)
    neg = torch.full_like(min_d2, -1.0)
    rows = torch.arange(b, device=xyz.device)
    last = torch.zeros(b, dtype=torch.int64, device=xyz.device)
    for j in range(1, n_samples):
        lp = xyz[rows, last]                              # [B, 3]
        dx = x - lp[:, 0:1]
        dy = y - lp[:, 1:2]
        dz = z - lp[:, 2:3]
        d2 = (dx * dx + dy * dy) + dz * dz
        min_d2 = torch.minimum(min_d2, d2)
        last = torch.where(eligible, min_d2, neg).argmax(-1)
        out[:, j] = last.to(torch.int32)
    return out


def group_points(
    points: torch.Tensor,
    feats: Optional[torch.Tensor],
    centers: torch.Tensor,
    idx: torch.Tensor,
    use_xyz: bool = True,
) -> torch.Tensor:
    """Gather neighbours and recentre their xyz → ``[B, M, K, 3+C]``
    with features ordered ``[local_xyz, feats]`` (``geometry.py:390``)."""
    if use_xyz and feats is not None:
        both = index_points(torch.cat([points, feats], -1), idx)
        local = both[..., :3] - centers[:, :, None, :]
        return torch.cat([local, both[..., 3:]], dim=-1)
    if use_xyz:
        return index_points(points, idx) - centers[:, :, None, :]
    if feats is not None:
        return index_points(feats, idx)
    raise ValueError("need use_xyz=True or feats is not None")


def group_all(xyz: torch.Tensor, feats: torch.Tensor,
              use_xyz: bool = True) -> torch.Tensor:
    """Single group of every point → ``[B, 1, N, C(+3)]``, with the
    ABSOLUTE xyz prepended, not recentred (``geometry.py:470``)."""
    if use_xyz:
        feats = torch.cat([xyz, feats], dim=-1)
    return feats[:, None, :, :]
