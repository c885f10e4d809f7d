"""The multi-scale pyramid, built on the model's device (counterpart of
``pointcloudlib_tpu/models/kpconv/pyramid.py``): grid subsampling and
radius neighbours over dense padded ``[B, N_l, ...]`` tensors with
validity masks, one static shape per layer, and no host sync.

* :func:`grid_subsample` — voxel keys ``floor(p / dl)`` (a true f32
  division) shifted by the cloud's origin cell and clipped to
  ``[0, 1024)`` per axis, a stable sort of the keys, and each occupied
  voxel's barycentre in the first ``n_max`` slots by key order. The
  voxel sums are differences of the float64 running sums of the sorted
  points: exact wherever the running sums fit float64's 53 bits (points
  of float32 coordinates within 2^10 of each other down to 2^-43), so
  the same on every device and in every run, whatever order a device
  adds in; the JAX package adds each voxel's points in order in float32,
  so barycentres differ from its by a rounding of the sum.
* :func:`radius_neighbors` — the k nearest supports within the radius:
  masked supports moved to 1e9, the k nearest by
  :func:`~pointcloudlib_tpu_torch.ops.geometry.knn` (the ``knn`` kernel
  for CUDA tensors) where the support layer has at least 256 points, as
  the JAX package takes ``knn_pallas`` there, else by ``knn_plain``;
  then masked by ``d² < r²``. Both form d² as ``knn_plain`` does, so the
  card and the CPU find the same lists; the JAX package forms the cross
  term by a matrix product, so a support within a rounding of r², or of
  the k-th neighbour, can fall the other way there.
* :func:`build_pyramid` — the architecture's walk: radius neighbours at
  each layer, stride-2 voxel pooling between layers.

Invalid neighbour slots hold the sentinel ``N_l`` (one past the end)
beside a boolean mask.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from pointcloudlib_tpu_torch.ops import geometry

_GRID = 1024  # voxel coordinates clamped to [0, _GRID) per axis
_FAR = 1e9    # where masked supports move for the kNN
# support layers from this size take the kNN kernel (``pyramid.py:162``)
KNN_MIN_SUPPORTS = 256


def _true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` by an IEEE division on every device: the divisor as a
    tensor on ``x``'s device (a CUDA division by a host scalar multiplies
    by its reciprocal instead)."""
    return x / x.new_full((), d)


def voxel_keys(xyz: torch.Tensor, mask: torch.Tensor, dl: float
               ) -> torch.Tensor:
    """Packed voxel key ``[B, N]`` int32 of each point (masked rows
    ``INT32_MAX``): ``floor(p / dl)`` less the cloud's origin cell
    ``floor(min / dl)``, clipped to ``[0, 1024)`` per axis."""
    inf = torch.full_like(xyz, float("inf"))
    origin = torch.where(mask[..., None], xyz, inf).amin(dim=-2,
                                                         keepdim=True)
    origin_cell = torch.floor(_true_div(origin, dl))
    v = torch.clamp(
        (torch.floor(_true_div(xyz, dl)) - origin_cell).to(torch.int32),
        0, _GRID - 1)
    key = (v[..., 0] * _GRID + v[..., 1]) * _GRID + v[..., 2]
    return torch.where(mask, key,
                       torch.full_like(key, torch.iinfo(torch.int32).max))


def _sorted_voxels(xyz: torch.Tensor, mask: torch.Tensor, dl: float):
    """``(sorted keys, order, sorted mask, first)``: the keys stably
    sorted, and the first valid point of each voxel in that order."""
    key = voxel_keys(xyz, mask, dl)
    sk, order = torch.sort(key, dim=1, stable=True)
    smask = torch.gather(mask, 1, order)
    first = torch.cat([torch.ones_like(sk[:, :1], dtype=torch.bool),
                       sk[:, 1:] != sk[:, :-1]], dim=1) & smask
    return sk, order, smask, first


def grid_subsample_counted(xyz: torch.Tensor, mask: torch.Tensor, dl: float,
                           n_max: int
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """``xyz [B, N, 3]``, ``mask [B, N]`` → ``(centers [B, n_max, 3],
    vmask [B, n_max], dropped [B] int64)``: the barycentre of each
    occupied voxel in key order, the first ``n_max`` of them, and how
    many occupied voxels that cap cut off."""
    b, n, _ = xyz.shape
    _, order, smask, first = _sorted_voxels(xyz, mask, dl)
    sx = torch.gather(xyz, 1, order[..., None].expand(-1, -1, 3))
    # valid points sort before every masked one: their voxel ordinals
    # rise from 0; masked points get n, past every slot
    rank = torch.cumsum(first, dim=1) - 1
    rank = torch.where(smask, rank, torch.full_like(rank, n))
    slots = torch.arange(n_max, device=xyz.device).expand(b, -1)
    start = torch.searchsorted(rank, slots.contiguous(), side="left")
    end = torch.searchsorted(rank, slots.contiguous(), side="right")
    vals = torch.cat([torch.where(smask[..., None], sx,
                                  torch.zeros_like(sx)),
                      smask[..., None].to(sx.dtype)], dim=-1).double()
    run = torch.cat([vals.new_zeros(b, 1, 4), torch.cumsum(vals, dim=1)],
                    dim=1)
    sums = (torch.gather(run, 1, end[..., None].expand(-1, -1, 4))
            - torch.gather(run, 1, start[..., None].expand(-1, -1, 4)))
    sums = sums.float()
    cnt = sums[..., 3]
    centers = sums[..., :3] / torch.clamp_min(cnt, 1.0)[..., None]
    dropped = torch.clamp_min(first.sum(dim=1) - n_max, 0)
    return centers, cnt > 0, dropped


def grid_subsample(xyz: torch.Tensor, mask: torch.Tensor, dl: float,
                   n_max: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched voxel-grid subsampling ``[B, N, 3] → [B, n_max, 3]`` and
    its mask."""
    return grid_subsample_counted(xyz, mask, dl, n_max)[:2]


def occupancy(xyz: torch.Tensor, mask: torch.Tensor, dl: float
              ) -> torch.Tensor:
    """Occupied voxels of each cloud ``[B]`` int64: above a cap, that
    cap's :func:`grid_subsample` drops voxels."""
    return _sorted_voxels(xyz, mask, dl)[3].sum(dim=1)


def _far_supports(support: torch.Tensor, smask: torch.Tensor
                  ) -> torch.Tensor:
    return torch.where(smask[..., None], support,
                       torch.full_like(support, _FAR))


def neighbor_counts(query: torch.Tensor, qmask: torch.Tensor,
                    support: torch.Tensor, smask: torch.Tensor,
                    radius: float) -> torch.Tensor:
    """Uncapped in-radius support count of each query ``[B, M]`` (0 for
    invalid queries), d² as ``knn_plain`` forms it: calibration's
    input."""
    r2 = float(np.float32(radius * radius))
    d2 = geometry.square_distance(query, support)
    valid = smask[:, None, :] & (d2 < r2)
    return valid.sum(dim=-1) * qmask.to(torch.int64)


def radius_neighbors(query: torch.Tensor, qmask: torch.Tensor,
                     support: torch.Tensor, smask: torch.Tensor,
                     radius: float, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest in-radius supports of each query → ``(idx [B, M, k]
    int32, nmask [B, M, k] bool)``, nearest first, the lower index first
    on ties; invalid slots hold the sentinel N. For ``k > N`` the slots
    past N are invalid, as in the JAX package (``knn`` would repeat the
    last neighbour). On the card a layer of at least
    :data:`KNN_MIN_SUPPORTS` supports launches the ``knn`` kernel (its
    rank route for ``k > knn.MAX_K``, as the neighbour limits of the
    uncalibrated shapes ask from 4,096 points up)."""
    n = support.shape[1]
    kk = min(k, n)
    far = _far_supports(support, smask)
    find = geometry.knn if n >= KNN_MIN_SUPPORTS else geometry.knn_plain
    d2k, idx = find(query, far, kk)
    nmask = d2k < float(np.float32(radius * radius))
    if k > n:
        pad = (*idx.shape[:-1], k - n)
        idx = torch.cat([idx, idx.new_zeros(pad)], dim=-1)
        nmask = torch.cat([nmask, nmask.new_zeros(pad)], dim=-1)
    nmask = nmask & qmask[:, :, None]
    idx = torch.where(nmask, idx, torch.full_like(idx, n))
    return idx.to(torch.int32), nmask


class Pyramid(NamedTuple):
    """Per layer l: points ``[B, N_l, 3]``, masks ``[B, N_l]``, neighbors
    ``[B, N_l, K_l]`` (self-layer) with their masks, and for l < L − 1
    pools ``[B, N_{l+1}, K_l]`` (the stride-2 links into layer l) with
    theirs; ``overflow [B, sites]`` counts the voxels each subsampling
    cut (all 0 when the caps are lossless)."""

    points: List[torch.Tensor]
    masks: List[torch.Tensor]
    neighbors: List[torch.Tensor]
    neighbor_masks: List[torch.Tensor]
    pools: List[torch.Tensor]
    pool_masks: List[torch.Tensor]
    overflow: Optional[torch.Tensor] = None


def layer_blocks(architecture: Sequence[str]) -> List[List[str]]:
    """The architecture's blocks grouped by layer: a new layer after
    each pooling or strided block, up to the first global or upsample
    block."""
    groups: List[List[str]] = [[]]
    for block in architecture:
        if "global" in block or "upsample" in block:
            break
        groups[-1].append(block)
        if "pool" in block or "strided" in block:
            groups.append([])
    return groups


def layer_deform_flags(blocks: Sequence[str]) -> Tuple[bool, bool]:
    """``(deform_conv, deform_pool)`` of one layer: its self-neighbours
    take the deformable radius if a non-strided block is deformable, its
    pools if the strided or pooling block is."""
    conv = any("deformable" in bl for bl in blocks
               if not ("pool" in bl or "strided" in bl))
    pool = any("deformable" in bl for bl in blocks
               if "pool" in bl or "strided" in bl)
    return conv, pool


def pyramid_shapes(n_points: int, n_layers: int,
                   neighborhood_limits: Sequence[int]
                   ) -> Tuple[List[int], List[int]]:
    """Uncalibrated caps (``max(16, N / 4^l)``) and the neighbour
    widths."""
    caps = [max(16, n_points // (4**l)) for l in range(n_layers)]
    ks = list(neighborhood_limits[:n_layers])
    return caps, ks


def build_pyramid(xyz: torch.Tensor, mask: torch.Tensor, first_dl: float,
                  conv_radius: float, deform_radius: float,
                  architecture: Sequence[str],
                  neighborhood_limits: Sequence[int],
                  subsample_input: bool = True,
                  caps: Optional[Sequence[int]] = None) -> Pyramid:
    """Every layer's points, neighbours and pools for the architecture
    (``build_pyramid``, ``pyramid.py:262``)."""
    groups = layer_blocks(architecture)
    n_layers = len(groups)
    default_caps, ks = pyramid_shapes(xyz.shape[1], n_layers,
                                      neighborhood_limits)
    if caps is None:
        caps = default_caps

    points, masks, overflow = [], [], []
    if subsample_input:
        p0, m0, d0 = grid_subsample_counted(xyz, mask, first_dl, caps[0])
        overflow.append(d0)
    else:
        p0, m0 = xyz, mask
    points.append(p0)
    masks.append(m0)

    neighbors, nmasks, pools, pmasks = [], [], [], []
    r = first_dl * conv_radius
    dl = first_dl
    for l, blocks in enumerate(groups):
        deform_conv, deform_pool = layer_deform_flags(blocks)
        wide = r * (deform_radius / conv_radius)
        idx, nm = radius_neighbors(points[l], masks[l], points[l], masks[l],
                                   wide if deform_conv else r, ks[l])
        neighbors.append(idx)
        nmasks.append(nm)
        if l + 1 < n_layers:
            nxt_p, nxt_m, nxt_d = grid_subsample_counted(
                points[l], masks[l], 2 * dl, caps[l + 1])
            overflow.append(nxt_d)
            pidx, pm = radius_neighbors(nxt_p, nxt_m, points[l], masks[l],
                                        wide if deform_pool else r, ks[l])
            points.append(nxt_p)
            masks.append(nxt_m)
            pools.append(pidx)
            pmasks.append(pm)
            dl *= 2
            r *= 2
    ov = torch.stack(overflow, dim=1) if overflow else None
    return Pyramid(points, masks, neighbors, nmasks, pools, pmasks, ov)
