"""Point-cloud ops: plain geometry, device resolution and kernel dispatch."""

from pointcloudlib_tpu_torch.ops.dispatch import (
    ball_query,
    fps,
    resolve_device,
    scatter_rows,
    three_interp,
)
from pointcloudlib_tpu_torch.ops.geometry import (
    farthest_point_sample,
    group_all,
    group_points,
    index_points,
    knn,
    square_distance,
    three_nn,
    three_nn_interpolate,
)

__all__ = [
    "ball_query",
    "farthest_point_sample",
    "fps",
    "group_all",
    "group_points",
    "index_points",
    "knn",
    "resolve_device",
    "scatter_rows",
    "square_distance",
    "three_interp",
    "three_nn",
    "three_nn_interpolate",
]
