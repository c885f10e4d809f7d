"""Ball query: the CUDA kernel ``csrc/ball_query.cu`` and its plain
version.

Replaces the TPU kernel ``pointcloudlib_tpu/ops/pallas/neighbors.py``
(``_ball_query_pallas_jit`` → ``_ball_query_kernel``). The plain version
is ``geometry.ball_query``; the kernel's ``idx`` and ``cnt`` are
bit-identical to it (the same round-to-nearest distance, hits ranked in
index order).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pointcloudlib_tpu_torch.ops import geometry
from pointcloudlib_tpu_torch.ops.kernels import _build

# largest cloud the kernel stages in shared memory (16 bytes a point)
MAX_POINTS = 14336


def _lib() -> ctypes.CDLL:
    lib = _build.load("ball_query")
    fn = lib.ball_query_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


ball_query_plain = geometry.ball_query


def ball_query(centers: torch.Tensor, points: torch.Tensor, radius: float,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(idx [B, M, k] int32, cnt [B, M] int32)`` for ``centers
    [B, M, 3]`` and ``points [B, N, 3]``: the first ``k`` points in index
    order with ``d² < radius²``, short rows repeating their first hit,
    empty rows all 0; ``cnt`` counts every hit. The kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if points.device.type == "cpu":
        return ball_query_plain(centers, points, radius, k)
    if points.device.type != "cuda":
        raise ValueError(f"ball_query: unsupported device {points.device}")
    if (centers.dim() != 3 or points.dim() != 3 or centers.shape[-1] != 3
            or points.shape[-1] != 3 or centers.shape[0] != points.shape[0]):
        raise ValueError(f"ball_query: centers [B, M, 3] and points "
                         f"[B, N, 3] expected, got {tuple(centers.shape)} "
                         f"and {tuple(points.shape)}")
    if centers.device != points.device:
        raise ValueError(f"ball_query: centers on {centers.device}, points "
                         f"on {points.device}")
    b, n, _ = points.shape
    m = centers.shape[1]
    if not 1 <= n <= MAX_POINTS or m < 1 or k < 1:
        raise ValueError(f"ball_query: need 1 <= N <= {MAX_POINTS}, M >= 1 "
                         f"and k >= 1, got N={n}, M={m}, k={k}")
    centers = centers.float().contiguous()
    points = points.float().contiguous()
    dev = points.device
    idx = torch.empty((b, m, k), dtype=torch.int32, device=dev)
    cnt = torch.empty((b, m), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().ball_query_launch(
            centers.data_ptr(), points.data_ptr(), idx.data_ptr(),
            cnt.data_ptr(), b, n, m, k, radius * radius, stream)
    _build.check(err, "ball_query")
    ball_query.launches += 1
    return idx, cnt


ball_query.launches = 0
