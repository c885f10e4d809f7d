"""Data parallelism (counterpart of ``pointcloudlib_tpu/parallel``): one
process per device in a ``torch.distributed`` group, the batch split
over the ranks, every BatchNorm statistic and the gradients summed over
them. ``mesh.py`` and ``multihost.py`` name the JAX function each one
stands for."""

from pointcloudlib_tpu_torch.parallel.mesh import (
    DPGroup,
    all_gather_rows,
    all_reduce_sum,
    all_reduce_sum_grad,
    get_group,
    init_group,
    make_group,
    rank_seed,
    replicate,
    run_ranks,
    shard_batch,
    start_ranks,
    sync_batchnorm,
)
from pointcloudlib_tpu_torch.parallel.multihost import (
    global_group,
    initialize_multihost,
)

__all__ = [
    "DPGroup",
    "all_gather_rows",
    "all_reduce_sum",
    "all_reduce_sum_grad",
    "get_group",
    "global_group",
    "init_group",
    "initialize_multihost",
    "make_group",
    "rank_seed",
    "replicate",
    "run_ranks",
    "shard_batch",
    "start_ranks",
    "sync_batchnorm",
]
