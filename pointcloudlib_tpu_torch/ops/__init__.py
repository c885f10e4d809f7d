"""Point-cloud ops: plain geometry, device resolution and kernel dispatch."""

from pointcloudlib_tpu_torch.ops.dispatch import (
    ball_query,
    fps,
    gather_neighbors,
    knn_gather,
    resolve_device,
    scatter_rows,
    three_interp,
)
from pointcloudlib_tpu_torch.ops.geometry import (
    compute_density,
    farthest_point_sample,
    gather_points,
    group_all,
    group_points,
    index_points,
    knn,
    sample_and_group,
    square_distance,
    three_nn,
    three_nn_interpolate,
)

__all__ = [
    "ball_query",
    "compute_density",
    "farthest_point_sample",
    "fps",
    "gather_neighbors",
    "gather_points",
    "group_all",
    "group_points",
    "index_points",
    "knn",
    "knn_gather",
    "resolve_device",
    "sample_and_group",
    "scatter_rows",
    "square_distance",
    "three_interp",
    "three_nn",
    "three_nn_interpolate",
]
