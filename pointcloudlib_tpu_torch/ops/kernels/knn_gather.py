"""Fused k nearest neighbours and row gather: the CUDA kernel
``csrc/knn_gather.cu`` and its plain version.

Replaces the TPU kernel ``pointcloudlib_tpu/ops/pallas/neighbors.py``
(``knn_gather`` → ``_knn_gather_fwd_call`` → ``_knn_gather_kernel``):
the kNN of each query in ``points`` and the ``values`` rows of its
neighbours, ``(idx [B, M, k] int32, grouped [B, M, k, Cv] float32)``.
``stride=D`` keeps ranks 0, D, 2D, … of the ``k·D`` nearest (PointCNN's
dilated kNN, ``neighbors.py:342-359``). Slots are always in ascending
(d², index) order, so the JAX ``ordered`` flag, a documented no-op there
(``:412-423``), has no counterpart. PointConv's ``sample_and_group``
(``geometry.sample_and_group``) takes it at N % 128 == 0 with values of
16 channels or more.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pointcloudlib_tpu_torch.ops import geometry
from pointcloudlib_tpu_torch.ops.kernels import _build
from pointcloudlib_tpu_torch.ops.kernels.fused_sa_train import (
    _expect,
    _on_card,
    _stream,
)
from pointcloudlib_tpu_torch.ops.kernels.gather import scatter_rows

MAX_POINTS = 227 * 1024 // 4  # one warp's d² row in shared memory


def _lib() -> ctypes.CDLL:
    lib = _build.load("knn_gather")
    if lib.knn_gather_launch.argtypes is None:
        lib.knn_gather_launch.argtypes = ([ctypes.c_void_p] * 5
                                          + [ctypes.c_int] * 7
                                          + [ctypes.c_void_p])
        lib.knn_gather_launch.restype = ctypes.c_int
    return lib


def _check_ranks(k: int, stride: int, n: int) -> None:
    if k < 1 or stride < 1 or k * stride > n:
        raise ValueError(f"knn_gather: needs 1 <= k·stride <= N, got k={k}, "
                         f"stride={stride}, N={n}")


def knn_gather_plain(query: torch.Tensor, points: torch.Tensor,
                     values: torch.Tensor, k: int, stride: int = 1
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(idx [B, M, k] int32, grouped [B, M, k, Cv] float32)``: the
    ``k·stride`` nearest by ``geometry.knn_plain``, every ``stride``-th
    rank of them, then ``index_points`` of ``values``."""
    _check_ranks(k, stride, points.shape[1])
    _, idx = geometry.knn_plain(query, points, k * stride)
    idx = idx[..., ::stride].contiguous()
    return idx, geometry.index_points(values.float(), idx)


def knn_gather(query: torch.Tensor, points: torch.Tensor,
               values: torch.Tensor, k: int, stride: int = 1
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`knn_gather_plain`: the kernel for CUDA tensors (float32,
    N up to :data:`MAX_POINTS`; idx and grouped bit-identical to the
    plain version), the plain version for CPU tensors. No gradient: see
    :class:`KnnGather`."""
    if not _on_card("knn_gather", points):
        return knn_gather_plain(query, points, values, k, stride)
    b, m, c = query.shape
    n, cv = values.shape[1], values.shape[2]
    _expect("knn_gather", points.device,
            query=(query, (b, m, c), torch.float32),
            points=(points, (b, n, c), torch.float32),
            values=(values, (b, n, cv), torch.float32))
    _check_ranks(k, stride, n)
    if n > MAX_POINTS:
        raise ValueError(f"knn_gather: N={n} is above the kernel's "
                         f"{MAX_POINTS} points (one d² row in shared "
                         f"memory)")
    dev = points.device
    query, points = query.contiguous(), points.contiguous()
    values = values.contiguous()
    idx = torch.empty((b, m, k), dtype=torch.int32, device=dev)
    grouped = torch.empty((b, m, k, cv), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().knn_gather_launch(
            query.data_ptr(), points.data_ptr(), values.data_ptr(),
            idx.data_ptr(), grouped.data_ptr(), b, m, n, c, cv, k, stride,
            _stream(dev))
    _build.check(err, "knn_gather")
    knn_gather.launches += 1
    return idx, grouped


knn_gather.launches = 0


class KnnGather(torch.autograd.Function):
    """:func:`knn_gather` with the gradient of ``values`` (the custom VJP
    of ``neighbors.py:426-445``): ``scatter_rows`` of the grouped
    gradient at ``idx``. The selection is discrete: no gradient to
    ``query`` or ``points``."""

    @staticmethod
    def forward(ctx, query, points, values, k, stride):
        idx, grouped = knn_gather(query.detach(), points.detach(), values,
                                  k, stride)
        ctx.mark_non_differentiable(idx)
        ctx.save_for_backward(idx)
        ctx.n = values.shape[1]
        return idx, grouped

    @staticmethod
    def backward(ctx, _didx, dgrouped):
        (idx,) = ctx.saved_tensors
        return None, None, scatter_rows(dgrouped, idx, ctx.n), None, None
