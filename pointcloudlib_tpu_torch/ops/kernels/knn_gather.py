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

Two routes (``csrc/knn_gather.cu``), chosen from the shapes by
:func:`knn_gather_route`: ``select`` (every rank chosen before any row
is copied: a bisection on the d² keys' bits, the chosen points ranked by
their (key, index) words, then one pass of copies over the query's
k·Cv output words) where (k − 1)·stride + 1 ≤ :data:`SELECT_MAX_RANKS`
and a warp's part fits shared memory, else ``rounds`` (the first version:
a shuffle argmin a rank, rows of up to :data:`MAX_POINTS` points).
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
ROUTES = {0: "rounds", 1: "select"}  # as the launcher numbers them
SELECT_MAX_RANKS = 256  # csrc/knn_gather.cu kKgSelMaxRanks
_SELECT_CAND = 64       # kKgCand


def select_warp_bytes(n: int, k: int, stride: int) -> int:
    """Shared memory bytes of one warp of the select route
    (``csrc/knn_gather.cu`` ``kg_sel_warp_bytes``): the key row in whole
    16-byte words, a 64-bit word a rank and a candidate, and a slot a
    neighbour."""
    ranks = (k - 1) * stride + 1
    return (-(-n // 4) * 16 + 8 * (ranks + _SELECT_CAND) + 4 * k
            + 15) // 16 * 16


def knn_gather_route(n: int, k: int, stride: int) -> int:
    """The launcher's route for these sizes (``kg_route``): 1 (select)
    where its ranks and one warp's part fit, else 0 (rounds)."""
    fits = select_warp_bytes(n, k, stride) <= 227 * 1024
    return 1 if (k - 1) * stride + 1 <= SELECT_MAX_RANKS and fits else 0


def order_key(d2: torch.Tensor) -> torch.Tensor:
    """The select route's order of the points of each row of ``d2``
    (float32, ≥ 0 as ``square_distance`` clamps it) as int64 words: the
    d² bits with the sign cleared (−0 as +0), then the index. Ascending
    words are ascending (d², index), the plain version's order."""
    bits = d2.float().contiguous().view(torch.int32).to(torch.int64)
    j = torch.arange(d2.shape[-1], dtype=torch.int64, device=d2.device)
    return (bits & 0x7FFFFFFF) << 32 | j


def _lib() -> ctypes.CDLL:
    lib = _build.load("knn_gather")
    fn = lib.knn_gather_route_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
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
    N up to :data:`MAX_POINTS`, on the route of :func:`knn_gather_route`;
    idx and grouped bit-identical to the plain version), the plain
    version for CPU tensors. No gradient: see :class:`KnnGather`."""
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
        err = _lib().knn_gather_route_launch(
            query.data_ptr(), points.data_ptr(), values.data_ptr(),
            idx.data_ptr(), grouped.data_ptr(), b, m, n, c, cv, k, stride,
            knn_gather_route(n, k, stride), _stream(dev))
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
