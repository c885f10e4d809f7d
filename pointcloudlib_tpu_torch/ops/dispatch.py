"""Device resolution and the FPS and ball-query entry points.

The JAX package picks Pallas or XLA per process from the backend. Here
the choice follows the tensor: a CUDA tensor goes to the hand-written
kernel (or raises), a CPU tensor to the plain PyTorch version. Entry
points take ``device=None`` to mean the card, and raise when there is
none — a caller that wants the CPU says so.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from pointcloudlib_tpu_torch.ops.kernels import ball_query as _bq_kernel
from pointcloudlib_tpu_torch.ops.kernels import fps as _fps_kernel


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → ``cuda``; raise if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def fps(xyz: torch.Tensor, n_samples: int,
        skip_near_origin: bool = True) -> torch.Tensor:
    """Farthest-point sampling indices ``[B, n_samples] int32`` — the
    CUDA kernel for a CUDA tensor, the plain loop for a CPU tensor.
    Both give bit-identical indices."""
    return _fps_kernel.fps(xyz, n_samples, skip_near_origin)


def ball_query(centers: torch.Tensor, points: torch.Tensor, radius: float,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """First ``k`` in-radius points in index order → ``(idx [B, M, k],
    cnt [B, M])`` int32 — the CUDA kernel for CUDA tensors, the plain
    ``geometry.ball_query`` for CPU tensors. Both give bit-identical
    results."""
    return _bq_kernel.ball_query(centers, points, radius, k)
