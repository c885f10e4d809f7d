"""Device resolution and the FPS, ball-query, 3-NN interpolation, row
gather, fused kNN + gather and row scatter-add entry points.

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
from pointcloudlib_tpu_torch.ops.kernels import gather as _gather_kernel
from pointcloudlib_tpu_torch.ops.kernels import (
    knn_gather as _knn_gather_kernel,
)
from pointcloudlib_tpu_torch.ops.kernels import (
    three_interp as _three_interp_kernel,
)


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


def three_interp(query: torch.Tensor, points: torch.Tensor,
                 feats: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """3-NN inverse-distance interpolation → ``(out [B, M, C], idx
    [B, M, 3] int32, w [B, M, 3])`` — the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors, ``idx`` bit-identical between
    them. ``geometry.three_nn_interpolate`` is the differentiable form."""
    return _three_interp_kernel.three_interp_fwd(query, points, feats)


def gather_neighbors(points: torch.Tensor, idx: torch.Tensor
                     ) -> torch.Tensor:
    """``points[b, idx[b, ...], :]`` → ``[B, ..., C]``, zero rows for
    indices outside ``[0, N)``, differentiable in ``points`` (scatter-add
    backward) — the CUDA kernel for CUDA tensors, ``torch.gather`` for
    CPU tensors, bit-identical. ``geometry.gather_points`` applies the
    JAX package's cost gate in front of it."""
    return _gather_kernel.GatherNeighbors.apply(points, idx)


def knn_gather(query: torch.Tensor, points: torch.Tensor,
               values: torch.Tensor, k: int, stride: int = 1
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN of ``query`` in ``points`` and the ``values`` rows of ranks 0,
    ``stride``, 2·``stride``, … → ``(idx [B, M, k] int32, grouped [B, M,
    k, Cv])``, differentiable in ``values`` — the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors, bit-identical."""
    return _knn_gather_kernel.KnnGather.apply(query, points, values, k,
                                              stride)


def scatter_rows(g: torch.Tensor, idx: torch.Tensor, n: int
                 ) -> torch.Tensor:
    """Scatter-add of ``g [B, M, K, C]`` at ``idx [B, M, K]`` into
    ``[B, n, C]``, indices outside ``[0, n)`` dropped — the CUDA kernel
    for CUDA tensors, ``index_add_`` for CPU tensors."""
    return _gather_kernel.scatter_rows(g, idx, n)
