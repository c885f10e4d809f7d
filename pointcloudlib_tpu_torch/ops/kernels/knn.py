"""k nearest neighbours: the CUDA kernel ``csrc/knn.cu`` and its plain
version.

Replaces the TPU kernel ``pointcloudlib_tpu/ops/pallas/neighbors.py``
(``knn_pallas`` → ``_knn_kernel``): ``(d² [B, M, k], idx [B, M, k]
int32)``, ascending, the lower index first on ties. The plain version is
``geometry.knn_plain``; the kernel's idx and d² are bit-identical to it
(d² formed in f32 channel by channel without FMA, in the plain order, so
``knn_pallas``'s ``exact`` flag has no counterpart here). DGCNN's
EdgeConvs take it at N % 128 ≠ 0; ``geometry.knn`` sends CUDA tensors
here.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pointcloudlib_tpu_torch.ops import geometry
from pointcloudlib_tpu_torch.ops.kernels import _build
from pointcloudlib_tpu_torch.ops.kernels.fused_sa import _SMEM_LIMIT, _aligned
from pointcloudlib_tpu_torch.ops.kernels.fused_sa_train import (
    _expect,
    _on_card,
    _stream,
)

MAX_K = 40  # longest neighbour list of the kNN kernels (csrc/edge_knn.cuh)


def _lib() -> ctypes.CDLL:
    lib = _build.load("knn")
    if lib.knn_launch.argtypes is None:
        lib.knn_launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                                   + [ctypes.c_void_p])
        lib.knn_launch.restype = ctypes.c_int
        lib.knn_smem.argtypes = [ctypes.c_int] * 2
        lib.knn_smem.restype = ctypes.c_longlong
    return lib


knn_plain = geometry.knn_plain


def knn(query: torch.Tensor, points: torch.Tensor, k: int
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(d² [B, M, k] float32, idx [B, M, k] int32)`` of ``query [B, M,
    C]`` in ``points [B, N, C]``, as :func:`knn_plain`: the kernel for
    CUDA tensors (float32, at most ``MAX_K`` neighbours), the plain
    version for CPU tensors. For ``k > N`` the kernel finds all N and the
    last repeats, as in the plain version."""
    if not _on_card("knn", points):
        return knn_plain(query, points, k)
    b, m, c = query.shape
    n = points.shape[1]
    kk = min(k, n)
    _expect("knn", points.device, query=(query, (b, m, c), torch.float32),
            points=(points, (b, n, c), torch.float32))
    if not 1 <= kk <= MAX_K:
        raise ValueError(f"knn: the kernel finds 1 to {MAX_K} neighbours, "
                         f"got k={k} (N={n})")
    lib = _lib()
    smem = lib.knn_smem(c, kk)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"knn: width C={c} and k={kk} need {smem} bytes of "
                         f"shared memory, above one block's {_SMEM_LIMIT}")
    dev = points.device
    d2 = torch.empty((b, m, kk), dtype=torch.float32, device=dev)
    idx = torch.empty((b, m, kk), dtype=torch.int32, device=dev)
    query, points = _aligned(query), _aligned(points)
    with torch.cuda.device(dev):
        err = lib.knn_launch(query.data_ptr(), points.data_ptr(),
                             d2.data_ptr(), idx.data_ptr(), b, m, n, c, kk,
                             _stream(dev))
    _build.check(err, "knn")
    knn.launches += 1
    return geometry.repeat_last(d2, idx, k)


knn.launches = 0
