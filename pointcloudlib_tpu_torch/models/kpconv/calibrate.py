"""The pyramid's shapes from data (counterpart of
``pointcloudlib_tpu/models/kpconv/calibrate.py``): walk the pyramid over
a sample of clouds on the model's device and derive each layer's

* cap — its static point budget: the largest occupancy seen (or its
  ``cap_quantile``) times a margin, rounded up to a multiple of 8 (above
  256 points to the nearest multiple of 64, as the JAX package rounds
  for its kernels' tiles);
* neighbour limit — the ``untouched_ratio`` quantile of the uncapped
  in-radius neighbour counts.

The occupancy counts are exact integers on every device; the neighbour
counts take d² as ``knn_plain`` forms it, so a support within a rounding
of the radius may count where the JAX package's does not.

Bucketed calibration splits the sample by layer-0 occupancy
(:func:`occupancy_np` on the host, the same keys) and calibrates each
bucket; every bucket's step shares one model, and the merged shapes (the
element-wise maximum) serve any cloud.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from pointcloudlib_tpu_torch.models.kpconv.pyramid import (
    _GRID,
    grid_subsample,
    layer_blocks,
    neighbor_counts,
    occupancy,
)
from pointcloudlib_tpu_torch.ops.dispatch import resolve_device

Device = Optional[Union[str, torch.device]]
_CHUNK = 8  # clouds a neighbour count takes at once ([8, N, N] d²)


@dataclasses.dataclass(frozen=True)
class PyramidCalibration:
    caps: Tuple[int, ...]                 # per-layer static point budget
    neighborhood_limits: Tuple[int, ...]  # per-layer neighbor width
    max_occupancy: Tuple[int, ...]        # observed max voxels per layer
    mean_neighbors: Tuple[float, ...]     # observed mean in-radius count

    def describe(self) -> str:
        return (
            f"caps={list(self.caps)} "
            f"neighborhood_limits={list(self.neighborhood_limits)} "
            f"(max occupancy {list(self.max_occupancy)}, "
            f"mean neighbors {[round(m, 1) for m in self.mean_neighbors]})"
        )


def _round8(n: int) -> int:
    return max(8, (n + 7) // 8 * 8)


def _round_cap(n: int) -> int:
    """Caps above 256 to the nearest multiple of 64, else up to a
    multiple of 8 (``calibrate.py:58``)."""
    if n > 256:
        return (n + 32) // 64 * 64
    return _round8(n)


def _counts(pts: torch.Tensor, msk: torch.Tensor, radius: float
            ) -> np.ndarray:
    """:func:`neighbor_counts` of each layer point in its own layer, a
    few clouds at a time."""
    out = [neighbor_counts(pts[i:i + _CHUNK], msk[i:i + _CHUNK],
                           pts[i:i + _CHUNK], msk[i:i + _CHUNK], radius)
           for i in range(0, pts.shape[0], _CHUNK)]
    return torch.cat(out).cpu().numpy()


@torch.no_grad()
def calibrate_pyramid(
    clouds: np.ndarray,
    first_dl: float,
    conv_radius: float,
    deform_radius: float,
    architecture: Sequence[str],
    untouched_ratio: float = 0.9,
    margin: float = 1.15,
    subsample_input: bool = True,
    cap_quantile: Optional[float] = None,
    device: Device = None,
) -> PyramidCalibration:
    """Measure clouds ``[S, N, 3]`` on ``device`` (the card unless
    ``"cpu"``) and derive the pyramid's shapes (``calibrate.py:73``).
    With ``cap_quantile`` a layer's cap comes from that occupancy
    quantile, so the clouds above it lose voxels (counted as the
    overflow); layers after a capped one are measured on the truncated
    pyramid, as the model sees it."""
    dev = resolve_device(device)
    clouds = np.asarray(clouds, np.float32)
    s, n, _ = clouds.shape
    pts = torch.from_numpy(clouds).to(dev)
    msk = torch.ones((s, n), dtype=torch.bool, device=dev)
    groups = layer_blocks(architecture)

    caps: List[int] = []
    limits: List[int] = []
    max_occ: List[int] = []
    mean_nb: List[float] = []
    r = first_dl * conv_radius
    dl = first_dl

    def _cap_from(o: np.ndarray) -> int:
        budget = (o.max() if cap_quantile is None
                  else np.quantile(o, cap_quantile))
        return _round_cap(int(np.ceil(budget * margin)))

    for l, blocks in enumerate(groups):
        if l == 0:
            if subsample_input:
                o = occupancy(pts, msk, dl).cpu().numpy()
                cap = min(_cap_from(o), n)
                pts, msk = grid_subsample(pts, msk, dl, cap)
            else:
                o = np.full((s,), n)
                cap = n
        else:
            o = occupancy(pts, msk, 2 * dl).cpu().numpy()
            cap = min(_cap_from(o), pts.shape[1])
            pts, msk = grid_subsample(pts, msk, 2 * dl, cap)
            dl *= 2
            r *= 2
        caps.append(cap)
        max_occ.append(int(o.max()))

        deform = any("deformable" in bl for bl in blocks)
        r_l = r * (deform_radius / conv_radius) if deform else r
        valid = _counts(pts, msk, r_l)[msk.cpu().numpy()]
        limits.append(
            max(1, int(np.ceil(np.quantile(valid, untouched_ratio)))))
        mean_nb.append(float(valid.mean()))

    return PyramidCalibration(
        caps=tuple(caps),
        neighborhood_limits=tuple(limits),
        max_occupancy=tuple(max_occ),
        mean_neighbors=tuple(mean_nb),
    )


def bench_calibration(clouds: np.ndarray, architecture: Sequence[str],
                      device: Device = None) -> PyramidCalibration:
    """The calibration ``bench.py:129-155`` gives its KPConv rows: the
    first 64 clouds at the adapter's grid, the 0.9 occupancy quantile
    with margin 1.0, here on the model's own ``architecture`` (the
    deformable radius where its blocks are deformable)."""
    from pointcloudlib_tpu_torch.models.kpconv.adapter import (
        FIRST_SUBSAMPLING_DL,
    )
    from pointcloudlib_tpu_torch.models.kpconv.model import KPConvConfig

    base = KPConvConfig()
    return calibrate_pyramid(clouds[:64], FIRST_SUBSAMPLING_DL,
                             base.conv_radius, base.deform_radius,
                             architecture, cap_quantile=0.9, margin=1.0,
                             device=device)


def occupancy_np(cloud: np.ndarray, dl: float) -> int:
    """Occupied voxels of one cloud on the host, by the pyramid's key
    convention (the same grid and origin cell)."""
    origin_cell = np.floor(cloud.min(0) / dl)
    v = np.clip((np.floor(cloud / dl) - origin_cell).astype(np.int64),
                0, _GRID - 1)
    key = (v[:, 0] * _GRID + v[:, 1]) * _GRID + v[:, 2]
    return int(np.unique(key).size)


@dataclasses.dataclass(frozen=True)
class BucketedCalibration:
    """Per-bucket pyramid shapes and the layer-0 occupancy bounds that
    route a cloud to its bucket."""

    buckets: Tuple[PyramidCalibration, ...]
    bounds: Tuple[int, ...]   # upper bounds, len == n_buckets - 1
    first_dl: float

    def bucket_of(self, cloud: np.ndarray) -> int:
        o = occupancy_np(cloud, self.first_dl)
        for b, hi in enumerate(self.bounds):
            if o <= hi:
                return b
        return len(self.buckets) - 1

    def describe(self) -> str:
        parts = [
            f"bucket {b} (occ<= {'inf' if b >= len(self.bounds) else self.bounds[b]}): "
            f"caps={list(c.caps)}"
            for b, c in enumerate(self.buckets)
        ]
        return "; ".join(parts)

    def merged(self) -> PyramidCalibration:
        """The element-wise maximum across buckets: shapes for any cloud
        (a low-occupancy cloud is denser, so its neighbour counts can
        exceed the top bucket's limits)."""
        n_layers = len(self.buckets[0].caps)
        return PyramidCalibration(
            caps=tuple(max(c.caps[l] for c in self.buckets)
                       for l in range(n_layers)),
            neighborhood_limits=tuple(
                max(c.neighborhood_limits[l] for c in self.buckets)
                for l in range(n_layers)),
            max_occupancy=tuple(
                max(c.max_occupancy[l] for c in self.buckets)
                for l in range(n_layers)),
            mean_neighbors=tuple(
                float(np.mean([c.mean_neighbors[l] for c in self.buckets]))
                for l in range(n_layers)),
        )


def calibrate_buckets(
    clouds: np.ndarray,
    first_dl: float,
    conv_radius: float,
    deform_radius: float,
    architecture: Sequence[str],
    n_buckets: int = 2,
    **kw,
) -> BucketedCalibration:
    """Split the sample at the layer-0 occupancy quantiles and calibrate
    each bucket (a bucket of fewer than 4 clouds on the whole sample);
    ``n_buckets=1`` is one global calibration. ``kw`` goes to
    :func:`calibrate_pyramid`."""
    clouds = np.asarray(clouds, np.float32)
    occ = np.array([occupancy_np(c, first_dl) for c in clouds])
    qs = [int(np.quantile(occ, i / n_buckets))
          for i in range(1, n_buckets)]
    assign = np.searchsorted(qs, occ, side="left")
    cals = []
    for b in range(n_buckets):
        sel = clouds[assign == b]
        if len(sel) < 4:  # degenerate bucket: calibrate on everything
            sel = clouds
        cals.append(calibrate_pyramid(
            sel, first_dl, conv_radius, deform_radius, architecture,
            **kw))
    return BucketedCalibration(tuple(cals), tuple(qs), first_dl)
