"""Ball query: the CUDA kernel ``csrc/ball_query.cu`` and its plain
version.

Replaces the TPU kernel ``pointcloudlib_tpu/ops/pallas/neighbors.py``
(``_ball_query_pallas_jit`` → ``_ball_query_kernel``). The plain version
is ``geometry.ball_query``; the kernel's ``idx`` and ``cnt`` are
bit-identical to it (the same round-to-nearest distance, hits ranked in
index order).

Two routes (``csrc/ball_query.cu``), chosen by :func:`ball_query_route`:
``scan`` tests every (center, point) pair, a warp walking 1 or 2
centers together; ``cull`` (clouds of :data:`CULL_MIN_POINTS` points or
more, which the train steps and the predictors Hilbert-sort) walks only
the 32-point chunks whose bounding box may hold a hit, by a test with a
rounding margin (:func:`chunk_far` repeats it in PyTorch) that never
skips a chunk holding one.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pointcloudlib_tpu_torch.ops import geometry
from pointcloudlib_tpu_torch.ops.kernels import _build

# largest cloud the kernel stages in shared memory (16 bytes a point)
MAX_POINTS = 14336
ROUTES = {0: "scan", 1: "cull"}  # as the launcher numbers them
CULL_MIN_POINTS = 4096  # the Hilbert sort's smallest N (ops/spatial.py)
CHUNK = 32              # points a box of the cull route
_SMEM = 227 * 1024


def route_smem(route: int, n: int) -> int:
    """Shared memory bytes of a block (``csrc/ball_query.cu``
    ``bq_smem``): the cloud at 16 bytes a point, and on the cull route
    32 bytes a box of each chunk and super-chunk (4 chunks), 16 for the
    cloud's largest |p|₁ and each of the 32 warps' lists of near
    chunks."""
    if route != 1:
        return 16 * n
    chunks = -(-n // CHUNK)
    return 16 * n + 32 * (chunks + -(-chunks // 4)) + 16 + 32 * 4 * chunks


def ball_query_route(n: int) -> int:
    """The route for a cloud of ``n`` points: 1 (cull) from
    :data:`CULL_MIN_POINTS` points where its shared memory fits, else 0
    (scan)."""
    return 1 if n >= CULL_MIN_POINTS and route_smem(1, n) <= _SMEM else 0


def _l1(x: torch.Tensor) -> torch.Tensor:
    a = x.abs()
    return (a[..., 0] + a[..., 1]) + a[..., 2]


def chunk_boxes(points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(lo, hi)``, each ``[B, chunks, 3]``: the bounding boxes of the
    cull route's chunks of :data:`CHUNK` consecutive points (the last one
    padded with its last point, as the kernel's lanes past N are)."""
    b, n, _ = points.shape
    pts = points.float()
    pad = -n % CHUNK
    if pad:
        pts = torch.cat([pts, pts[:, -1:].expand(b, pad, 3)], dim=1)
    chunks = pts.view(b, -1, CHUNK, 3)
    return chunks.amin(2), chunks.amax(2)


def chunk_far(centers: torch.Tensor, points: torch.Tensor,
              radius: float) -> torch.Tensor:
    """``[B, M, chunks]`` bool: the cull route's test (``bq_thr``,
    ``bq_far``) in float32 in the kernel's order. A chunk is skipped when
    its box's squared distance from the center is at least
    (r² + 2⁻²¹·S)(1 + 2⁻²¹) + 2⁻¹⁰⁰, S = (|c|₁ + max |p|₁)² with the max
    over the cloud: a bound on sq_dist's rounding for every point (derived
    in ``csrc/ball_query.cu``)."""
    lo, hi = chunk_boxes(points)
    c = centers.float()[:, :, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=c.device)
    g = torch.fmax(torch.fmax(lo[:, None] - c, c - hi[:, None]), zero)
    dbox = (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]) \
        + g[..., 2] * g[..., 2]
    s = _l1(centers.float()) + _l1(points.float()).amax(1, keepdim=True)
    r2 = torch.tensor(radius * radius, dtype=torch.float32, device=c.device)
    if not r2 > 0:  # the launcher's r² then: no point is a hit
        r2 = torch.tensor(float("-inf"), device=c.device)
    thr = ((r2 + (s * s) * 2.0 ** -21) * (1.0 + 2.0 ** -21)
           + 2.0 ** -100)[..., None]
    return (dbox >= thr) & (thr < float("inf"))


def pairs_tested(centers: torch.Tensor, points: torch.Tensor,
                 radius: float) -> int:
    """The (center, point) pairs the cull route tests: the points of the
    chunks :func:`chunk_far` keeps."""
    n = points.shape[1]
    sizes = torch.full((-(-n // CHUNK),), CHUNK, device=points.device)
    sizes[-1] = n - CHUNK * (sizes.numel() - 1)
    return int(((~chunk_far(centers, points, radius)) * sizes).sum())


def _lib() -> ctypes.CDLL:
    lib = _build.load("ball_query")
    fn = lib.ball_query_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


ball_query_plain = geometry.ball_query


def ball_query(centers: torch.Tensor, points: torch.Tensor, radius: float,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(idx [B, M, k] int32, cnt [B, M] int32)`` for ``centers
    [B, M, 3]`` and ``points [B, N, 3]``: the first ``k`` points in index
    order with ``d² < radius²``, short rows repeating their first hit,
    empty rows all 0; ``cnt`` counts every hit. The kernel for CUDA
    tensors (on the route of :func:`ball_query_route`), the plain version
    for CPU tensors."""
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
            cnt.data_ptr(), b, n, m, k, radius * radius,
            ball_query_route(n), stream)
    _build.check(err, "ball_query")
    ball_query.launches += 1
    return idx, cnt


ball_query.launches = 0
