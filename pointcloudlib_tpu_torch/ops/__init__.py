"""Point-cloud ops: plain geometry, device resolution and kernel dispatch."""

from pointcloudlib_tpu_torch.ops.dispatch import (
    ball_query,
    fps,
    resolve_device,
)
from pointcloudlib_tpu_torch.ops.geometry import (
    farthest_point_sample,
    group_all,
    group_points,
    index_points,
    square_distance,
)

__all__ = [
    "ball_query",
    "farthest_point_sample",
    "fps",
    "group_all",
    "group_points",
    "index_points",
    "resolve_device",
    "square_distance",
]
