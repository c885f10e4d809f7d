"""Several hosts (counterpart of ``pointcloudlib_tpu/parallel/multihost.py``).

The JAX package starts ``jax.distributed`` from its coordinator's
environment and builds one mesh over every host's devices. Here every
process, on every host, joins one ``torch.distributed`` process group
from ``torchrun``'s environment (``MASTER_ADDR``, ``MASTER_PORT``,
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), and drives the card of its
local rank:

    torchrun --nnodes 2 --nproc-per-node 4 --rdzv-endpoint host0:29500 \\
        -m pointcloudlib_tpu_torch.cli.train_cls --multihost ...

- ``initialize_multihost()`` → :func:`initialize_multihost`.
- ``global_mesh()`` → :func:`global_group`, the group over every process.
- ``host_local_batch_to_global`` has no counterpart and needs none: each
  rank keeps its own rows of the global batch (``mesh.shard_batch``), so
  no array spans processes.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from pointcloudlib_tpu_torch.parallel.mesh import Device, DPGroup, make_group


def initialize_multihost(backend: Optional[str] = None) -> bool:
    """Start the default process group from ``torchrun``'s environment
    (``init_method="env://"``) and return whether more than one process
    runs. Without that environment (no ``RANK`` / ``WORLD_SIZE``) it is a
    no-op that returns False; with a group already started it returns
    whether that group spans more than one process. ``backend`` defaults
    to NCCL where there is a card (on ``cuda:<LOCAL_RANK>``), else
    gloo."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, init_method="env://",
                            world_size=int(env["WORLD_SIZE"]),
                            rank=int(env["RANK"]))
    return dist.get_world_size() > 1


def global_group(device: Device = None) -> DPGroup:
    """The group over every process of every host (``mesh.make_group``)."""
    return make_group(device=device)
