"""Plain PyTorch point-cloud geometry (counterpart of
``pointcloudlib_tpu/ops/geometry.py``).

Conventions are the JAX package's: channel-last ``[B, N, C]`` float32
clouds, ``int32`` neighbour indices of static width, repeat-first
padding. Every function here runs on any device as ordinary tensor ops,
except ``knn``, ``three_nn_interpolate``, ``gather_points`` and
``sample_and_group``, which send CUDA tensors to their kernels; the
sequential and hot pieces of the model paths have
CUDA kernels in ``ops/kernels`` that these functions are the plain
versions of.

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
    "knn",
    "knn_plain",
    "three_nn",
    "three_nn_interpolate",
    "gather_takes_kernel",
    "gather_points",
    "compute_density",
    "sample_and_group",
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
    # channel-major copies: each channel's product broadcasts over
    # contiguous rows; without gradients the products reuse one buffer
    at = a.permute(2, 0, 1).contiguous()
    bt = b.permute(2, 0, 1).contiguous()
    inner = at[0][:, :, None] * bt[0][:, None, :]
    grad = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)
    prod = None if grad else torch.empty_like(inner)
    for c in range(1, a.shape[-1]):
        if grad:
            inner = inner + at[c][:, :, None] * bt[c][:, None, :]
        else:
            torch.mul(at[c][:, :, None], bt[c][:, None, :], out=prod)
            inner.add_(prod)
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


def repeat_last(d2: torch.Tensor, idx: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(d², idx)`` of fewer than ``k`` neighbours widened to ``k`` by
    repeating the last, as the JAX ``knn`` does for ``k > N``."""
    short = k - d2.shape[-1]
    if short > 0:
        d2 = torch.cat([d2, d2[..., -1:].expand(*d2.shape[:-1], short)], -1)
        idx = torch.cat([idx, idx[..., -1:].expand(*idx.shape[:-1], short)],
                        -1)
    return d2, idx


# most d² elements the plain kNN holds at once (1 GB of float32): a
# DGCNN layer at B=32, N=10,000 is 3.2·10⁹ pairs
_KNN_CHUNK = 1 << 28


def knn_plain(query: torch.Tensor, points: torch.Tensor, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbours → ``(d² [B, M, k], idx [B, M, k] int32)``,
    ascending by :func:`square_distance` with the lower index first on
    ties, as ``lax.top_k`` orders them (``geometry.py:181``); for
    ``k > N`` the last neighbour repeats. Query rows go in chunks of at
    most ``_KNN_CHUNK`` pairs; each row's result is the same."""
    b, m = query.shape[:2]
    n = points.shape[1]
    rows = max(1, _KNN_CHUNK // max(1, b * n))
    d2s, idxs = [], []
    for s in range(0, m, rows):
        d2, idx = torch.sort(square_distance(query[:, s:s + rows], points),
                             dim=-1, stable=True)
        d2s.append(d2[..., :min(k, n)])
        idxs.append(idx[..., :min(k, n)].to(torch.int32))
    return repeat_last(torch.cat(d2s, 1), torch.cat(idxs, 1), k)


def knn(query: torch.Tensor, points: torch.Tensor, k: int
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`knn_plain` for CPU tensors, the ``knn`` kernel
    (``ops/kernels/knn.py``, bit-identical, its d² carrying no gradient)
    for CUDA tensors."""
    # the kernel wrappers import this module
    from pointcloudlib_tpu_torch.ops.kernels.knn import knn as knn_kernel

    return knn_kernel(query, points, k)


def _inverse_distance_weights(d2: torch.Tensor) -> torch.Tensor:
    """``1/(d²+1e-8)`` over the last axis of 3, normalized as
    ``inv_j / ((inv_0 + inv_1) + inv_2)`` (``geometry.py:315``)."""
    inv = 1.0 / (d2 + 1e-8)
    return inv / ((inv[..., 0:1] + inv[..., 1:2]) + inv[..., 2:3])


def three_nn(query: torch.Tensor, points: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 3 nearest support points of each query and their weights →
    ``(idx [B, M, 3] int32, w [B, M, 3])`` (``geometry.py:324``). The
    weights take d² recomputed exactly as ``Σ(q − p)²`` from the selected
    coordinates, so a query equal to a support point gets d² = 0 and a
    hard copy of its features."""
    _, idx = knn_plain(query, points, 3)
    g = index_points(points.float(), idx)                  # [B, M, 3, 3]
    return idx, _inverse_distance_weights(
        _sumsq(query.float()[:, :, None, :] - g))


def three_nn_interpolate(query: torch.Tensor, points: torch.Tensor,
                         feats: torch.Tensor) -> torch.Tensor:
    """Inverse-distance-weighted 3-NN interpolation ``query [B, M, 3]``,
    ``points [B, N, 3]``, ``feats [B, N, C]`` → ``[B, M, C]``
    (``geometry.py:349``): the ``three_interp`` kernel for CUDA tensors,
    its plain version for CPU ones, with the scatter-add backward to
    ``feats``. No gradient flows to ``query`` or ``points``."""
    # the kernel wrappers import this module
    from pointcloudlib_tpu_torch.ops.kernels.three_interp import ThreeInterp

    return ThreeInterp.apply(query.detach(), points.detach(), feats)


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


def gather_takes_kernel(n: int, c: int, rows: int) -> bool:
    """The cost gate of the JAX ``index_points`` (``geometry.py:123-173``)
    for a float32 cloud of ``n`` points of ``c`` channels and an index of
    ``rows`` entries: the row-gather kernel when ``n ≥ 128`` and
    ``rows·(6e-6 + 4e-7·c − 3.5e-9·(n + pad)) > 1``, with
    ``pad = −n % 128``."""
    pad = -n % 128
    return n >= 128 and rows * (6e-6 + 4e-7 * c - 3.5e-9 * (n + pad)) > 1.0


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """:func:`index_points` routed as the JAX ``index_points`` routes it:
    a float32 ``points [B, N, C]`` with an ``idx [B, M]`` or ``[B, M, K]``
    that passes :func:`gather_takes_kernel` goes through
    ``dispatch.gather_neighbors`` (the kernel for CUDA tensors, its plain
    version for CPU ones, the scatter-add backward), every other gather
    through :func:`index_points`. PointConv's gathers call it; the plain
    versions of the other kernels keep :func:`index_points`."""
    if (points.dtype == torch.float32 and idx.dim() in (2, 3)
            and points.dim() == 3
            and gather_takes_kernel(points.shape[1], points.shape[2],
                                    idx.numel())):
        # the kernel wrappers import this module
        from pointcloudlib_tpu_torch.ops.dispatch import gather_neighbors

        return gather_neighbors(points, idx)
    return index_points(points, idx)


def compute_density(xyz: torch.Tensor, bandwidth: float) -> torch.Tensor:
    """Gaussian-KDE point density ``[B, N]`` (``geometry.py:481``): the
    mean over every point of ``exp(−d²/(2σ²))/(2.5σ)`` with d² from
    :func:`square_distance`."""
    d2 = square_distance(xyz, xyz)
    g = torch.exp(-d2 / (2.0 * bandwidth * bandwidth)) / (2.5 * bandwidth)
    return g.mean(-1)


def sample_and_group(
    xyz: torch.Tensor,
    feats: Optional[torch.Tensor],
    n_points: int,
    k: int,
    density: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """PointConv grouping (``geometry.py:416-467``) → ``(new_xyz [B,
    n_points, 3], grouped [B, n_points, k, 3+C], grouped_density [B,
    n_points, k, 1] or None)``, grouped as ``[local xyz ‖ feats]``. FPS
    without the near-origin skip picks the centers; then, for float32 at
    N % 128 == 0 with ``[xyz ‖ feats ‖ density]`` at least 16 wide, the
    fused kNN + gather (``dispatch.knn_gather``), else :func:`knn` and
    :func:`gather_points` of ``[xyz ‖ feats]`` and of the density. Only
    ``feats`` and ``density`` carry gradients."""
    # the kernel wrappers import this module
    from pointcloudlib_tpu_torch.ops.dispatch import fps, knn_gather

    new_xyz = gather_points(xyz, fps(xyz, n_points, skip_near_origin=False))
    c = 0 if feats is None else feats.shape[-1]
    cv = 3 + c + (0 if density is None else 1)
    if xyz.shape[1] % 128 == 0 and cv >= 16 and xyz.dtype == torch.float32:
        cols = [xyz] + ([] if feats is None else [feats]) + (
            [] if density is None else [density[..., None]])
        _, g = knn_gather(new_xyz, xyz, torch.cat(cols, dim=-1), k)
        local = g[..., :3] - new_xyz[:, :, None, :]
        grouped = torch.cat([local, g[..., 3:3 + c]], dim=-1) if c else local
        return new_xyz, grouped, (None if density is None
                                  else g[..., 3 + c:4 + c])
    _, idx = knn(new_xyz, xyz, k)
    if feats is None:
        grouped = gather_points(xyz, idx) - new_xyz[:, :, None, :]
    else:
        both = gather_points(torch.cat([xyz, feats], dim=-1), idx)
        grouped = torch.cat([both[..., :3] - new_xyz[:, :, None, :],
                             both[..., 3:]], dim=-1)
    return new_xyz, grouped, (None if density is None
                              else gather_points(density[..., None], idx))
