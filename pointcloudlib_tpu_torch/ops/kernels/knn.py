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

Three routes (``csrc/knn.cu``), chosen from the shapes by
:func:`knn_route`. For k ≤ :data:`MAX_K`: ``select`` (a block of 128 or
256 queries, the points streamed through a ring of shared-memory tiles,
d² filtered in registers against each query's k-th and the survivors
merged into lists that 8 lanes hold; at C % 4 == 0 an FMA pass with an
error bound in front, its near pairs recomputed in the plain order) for
large clouds and grids, else ``block`` (the first version's 64-query
blocks, which also take widths up to 379 at k = 40). Above it, ``rank``
(one warp a query: the d² row as order keys in shared memory, the k
smallest chosen by a bisection on the keys' bits, exact on ties; the
selection of ``csrc/knn_gather.cu``, shared through
``csrc/knn_rank.cuh``), for any k ≤ N whose warp part fits a block
(:func:`rank_warp_bytes`): KPConv's radius neighbours ask for k = 41 and
up on layers of 256 supports or more.
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

MAX_K = 40  # longest list of the block and select routes (csrc/edge_knn.cuh)
RANK_ROUTE = 4  # the rank route, as the launcher numbers it (knn.cu)
_RANK_CAND = 64  # candidates a warp's bisection finishes in registers
# the select route's instances, as the launcher numbers them: (queries a
# thread, tiles in the ring, the fast pass); a block takes 32 queries a
# thread; the fast pass takes C % 4 == 0
SELECT = {1: (4, 3, False), 2: (4, 3, True), 3: (8, 2, True)}
_SEL_T = 64  # candidates a tile
_SEL_MAX_K8 = 24  # longest list with 8 queries a thread


def _sel_stride(c: int) -> int:
    p = (c + 3) // 4 * 4
    return p if p % 8 else p + 4


def select_smem(qpt: int, stages: int, c: int) -> int:
    """Shared memory bytes of a select block (``csrc/knn.cu``
    ``sel_smem``)."""
    q, p = 32 * qpt, _sel_stride(c)
    return 4 * (q * p + stages * _SEL_T * (p + 1) + q)


# below both, the select route's merges of the first tiles (every
# candidate of tile 0 enters the lists) and a grid of at most one block
# an SM leave it slower than the block route (PERF.md §5)
_SEL_MIN_N = 2048     # points a cloud
_SEL_MIN_BLOCKS = 256  # blocks of 128 queries


def block_smem(c: int, k: int) -> int:
    """Shared memory bytes of a block of the block route (``csrc/knn.cu``
    ``knn_smem``, which the launcher checks again): the query and
    candidate tiles, the d² tile, the norms and the lists."""
    return 4 * (128 * c + 64 * 68 + 128 + 2 * 64 * k)


def rank_warp_bytes(n: int, k: int) -> int:
    """Shared memory bytes of one warp (one query) of the rank route
    (``csrc/knn.cu`` ``kr_warp_bytes``): the N keys in whole 16-byte
    words, then k list words and 64 candidates of 8 bytes."""
    return (-(-n // 4) * 16 + 8 * (k + _RANK_CAND) + 15) // 16 * 16


def knn_route(b: int, m: int, n: int, c: int, k: int) -> int:
    """The launcher's route for these shapes. Above :data:`MAX_K`
    neighbours the rank route (:data:`RANK_ROUTE`). The select route where the
    clouds have at least :data:`_SEL_MIN_N` points or its grid at least
    :data:`_SEL_MIN_BLOCKS` blocks of 128 queries: with the fast pass
    where C % 4 == 0 and the clouds have at least :data:`_SEL_MIN_N`
    points (over fewer tiles its first, exact tiles and the pairs it
    forms again outweigh it), 256 queries a block and a ring of 2 tiles
    at C ≥ 96 and k ≤ 24 where they fit a block (C ≤ 148), else 128
    queries and 3 tiles. Else, or where no select instance fits a block,
    0 (the block route)."""
    if k > MAX_K:
        return RANK_ROUTE
    block_fits = block_smem(c, k) <= _SMEM_LIMIT
    if block_fits and n < _SEL_MIN_N and b * -(-m // 128) < _SEL_MIN_BLOCKS:
        return 0
    fast = c % 4 == 0 and n >= _SEL_MIN_N
    wants = [(4, 3, fast)]
    if fast and c >= 96 and k <= _SEL_MAX_K8:
        wants.insert(0, (8, 2, True))
    for want in wants:
        for route, inst in SELECT.items():
            if inst == want and select_smem(*inst[:2], c) <= _SMEM_LIMIT:
                return route
    return 0


# The EdgeConv kernels with the kNN inside (csrc/edge_knn_f1.cu,
# edge_knn_eval.cu, edge2_knn_eval.cu) take the same two routes by one
# rule (:func:`_edge_route`) and one table of select instances, as their
# launchers number them (knn_select.cuh kEdgeRoutes): (list entries a
# lane, the output width C), DGCNN's k = 20 at C = 64, 128, 256 and its
# part segmentation's k = 40 at C = 64 (the two-layer kernel builds the
# two at C = 64), without the FMA pass (slower at N = 2,048, PERF.md §5);
# route 0 is the block route. Each walks 128 queries a block through a
# ring of three tiles, but the one-layer eval kernel's C = 256 instance
# (DGCNN's EC4) 256 queries through two (:func:`_walk`)
EDGE_SELECT = {1: (3, 64), 2: (3, 128), 3: (3, 256), 4: (5, 64)}
EDGE_ROUTES = (0, *EDGE_SELECT)
_EDGE2_C = 64  # the width C1 = C2 the two-layer kernels are built for
_EDGE2_CHAIN = 19456  # the block route's two-layer chain (edge2.cuh
                      # Edge2Layout<64, 64>::bytes)


def _ceil(x: int, m: int) -> int:
    return -(-x // m) * m


def _walk(route: int, layers: int) -> Tuple[int, int]:
    """(queries a thread, tiles in the ring) of a select instance of pass
    1 (``layers`` 0) or of an eval kernel (1, 2; ``csrc/edge_knn_eval.cu``
    ``EvalWalk``)."""
    return (8, 2) if layers == 1 and EDGE_SELECT[route][1] == 256 else (4, 3)


def _lists_smem(cin: int, k: int, qpt: int = 4, stages: int = 3) -> int:
    """A select block's walk, whose tiles then hold its lists."""
    return max(select_smem(qpt, stages, cin), 4 * 32 * qpt * k)


def edge_f1_smem(route: int, cin: int, c: int, k: int) -> int:
    """Shared memory bytes of a block of ``edge_knn_f1`` on ``route``
    (``csrc/edge_knn_f1.cu`` ``f1_sel_smem`` / ``edge_knn_f1_smem``,
    which the launcher checks again)."""
    if route == 0:
        return 4 * (128 * cin + 64 * 68 + 128 + 64 * k + 2 * c)
    return _ceil(_lists_smem(cin, k), 16) + 8 * c


def edge_eval_smem(route: int, cin: int, c: int, k: int,
                   layers: int = 1) -> int:
    """Shared memory bytes of a block of ``edge_knn_eval`` (``layers`` 1)
    or ``edge2_knn_eval`` (2) on ``route`` (``csrc/edge_knn_eval.cu``
    ``eval_sel_smem`` / ``edge_knn_eval_smem``, ``csrc/edge2_knn_eval.cu``
    ``E2SelLayout`` / ``edge2_knn_eval_smem``, which the launchers check
    again): the walk's tiles, then the lists and, with two layers, W2 and
    two y1 tiles of 64 rows."""
    if route == 0:
        knn = 4 * (128 * cin + 64 * 68 + 128 + 64 * k)
        return knn if layers == 1 else _ceil(knn, 16) + _EDGE2_CHAIN
    if layers == 1:
        return _ceil(_lists_smem(cin, k, *_walk(route, 1)), 16)
    chain = _ceil(4 * 128 * k, 128) + 2 * c * c + 2 * 64 * c * 2
    return _ceil(max(select_smem(4, 3, cin), chain), 128)


def _route_fits(smem: int, route: int, n: int, c: int, k: int) -> bool:
    if route:
        entries, width = EDGE_SELECT[route]
        if width != c or 8 * entries < k:
            return False
    return 1 <= k <= min(n, MAX_K) and smem <= _SMEM_LIMIT


def edge_f1_route_fits(route: int, n: int, cin: int, c: int, k: int
                       ) -> bool:
    """Whether ``edge_knn_f1``'s launcher takes these shapes on
    ``route``."""
    return _route_fits(edge_f1_smem(route, cin, c, k), route, n, c, k)


def edge_eval_route_fits(route: int, n: int, cin: int, c: int, k: int,
                         layers: int = 1) -> bool:
    """Whether the launcher of ``edge_knn_eval`` (``layers`` 1) or
    ``edge2_knn_eval`` (2, C = C1 = C2) takes these shapes on
    ``route``."""
    if layers == 2 and c != _EDGE2_C:
        return False
    return _route_fits(edge_eval_smem(route, cin, c, k, layers), route, n,
                       c, k)


def _edge_route(fits, b: int, n: int, c: int, k: int) -> int:
    """The route of a kernel with the kNN inside, by :func:`knn_route`'s
    rule: the select instance of this list length (``ceil(k / 8)``
    entries a lane) and width where the clouds have at least
    :data:`_SEL_MIN_N` points or the grid at least
    :data:`_SEL_MIN_BLOCKS` blocks of 128 queries; else, or where none
    is built or fits (``fits(route)``), 0 (the block route)."""
    if n < _SEL_MIN_N and b * -(-n // 128) < _SEL_MIN_BLOCKS and fits(0):
        return 0
    for route, inst in EDGE_SELECT.items():
        if inst == (-(-k // 8), c) and fits(route):
            return route
    return 0


def edge_f1_route(b: int, n: int, cin: int, c: int, k: int) -> int:
    """``edge_knn_f1``'s route for these shapes (:func:`_edge_route`)."""
    return _edge_route(lambda r: edge_f1_route_fits(r, n, cin, c, k), b, n,
                       c, k)


def edge_eval_route(b: int, n: int, cin: int, c: int, k: int,
                    layers: int = 1) -> int:
    """The route of ``edge_knn_eval`` (``layers`` 1) or
    ``edge2_knn_eval`` (2, C = C1 = C2) for these shapes: pass 1's rule
    (:func:`_edge_route`) and instances."""
    return _edge_route(
        lambda r: edge_eval_route_fits(r, n, cin, c, k, layers), b, n, c, k)


def edge_route_name(route: int, layers: int = 0) -> str:
    """The name of a route of pass 1 (``layers`` 0) or of an eval kernel
    (1, 2): its walk (queries a block x tiles in the ring), list length
    and width."""
    if route == 0:
        return "block"
    e, c = EDGE_SELECT[route]
    qpt, stages = _walk(route, layers)
    return f"select {32 * qpt}x{stages} k<={8 * e} C={c}"


def route_name(route: int) -> str:
    if route == 0:
        return "block"
    if route == RANK_ROUTE:
        return "rank"
    qpt, stages, fast = SELECT[route]
    return f"select {32 * qpt}x{stages}" + (" fast" if fast else "")


def _lib() -> ctypes.CDLL:
    lib = _build.load("knn")
    if lib.knn_launch.argtypes is None:
        lib.knn_launch.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                                   + [ctypes.c_void_p])
        lib.knn_launch.restype = ctypes.c_int
    return lib


knn_plain = geometry.knn_plain


def knn(query: torch.Tensor, points: torch.Tensor, k: int
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(d² [B, M, k] float32, idx [B, M, k] int32)`` of ``query [B, M,
    C]`` in ``points [B, N, C]``, as :func:`knn_plain`: the kernel for
    CUDA tensors (float32) on the route :func:`knn_route` picks, the
    plain version for CPU tensors. Above :data:`MAX_K` neighbours the
    rank route takes any k whose warp part fits a block's shared memory
    (:func:`rank_warp_bytes`: N up to 57,900 at k = 41, and N = k up
    to 19,328); the wrapper raises above that. For ``k > N``
    the kernel finds all N and the last repeats, as in the plain
    version."""
    if not _on_card("knn", points):
        return knn_plain(query, points, k)
    b, m, c = query.shape
    n = points.shape[1]
    kk = min(k, n)
    _expect("knn", points.device, query=(query, (b, m, c), torch.float32),
            points=(points, (b, n, c), torch.float32))
    if kk < 1:
        raise ValueError(f"knn: needs k >= 1 and N >= 1, got k={k}, N={n}")
    lib = _lib()
    route = knn_route(b, m, n, c, kk)
    if route == RANK_ROUTE:
        smem = rank_warp_bytes(n, kk)
        if smem > _SMEM_LIMIT:
            raise ValueError(
                f"knn: k={kk} > {MAX_K} takes the rank route, which holds "
                f"a query's N keys and k list words in shared memory: N={n} "
                f"and k={kk} need {smem} bytes, above one block's "
                f"{_SMEM_LIMIT}")
    smem = block_smem(c, kk)
    if route == 0 and smem > _SMEM_LIMIT:
        raise ValueError(f"knn: width C={c} and k={kk} need {smem} bytes of "
                         f"shared memory, above one block's {_SMEM_LIMIT}")
    dev = points.device
    d2 = torch.empty((b, m, kk), dtype=torch.float32, device=dev)
    idx = torch.empty((b, m, kk), dtype=torch.int32, device=dev)
    # the select route's |p|^2 of every point (csrc/knn.cu knn_norms_kernel)
    norms = torch.empty(b * n if route in SELECT else 1,
                        dtype=torch.float32, device=dev)
    query, points = _aligned(query), _aligned(points)
    with torch.cuda.device(dev):
        err = lib.knn_launch(query.data_ptr(), points.data_ptr(),
                             d2.data_ptr(), idx.data_ptr(), norms.data_ptr(),
                             b, m, n, c, kk, route, _stream(dev))
    _build.check(err, "knn")
    knn.launches += 1
    _LAUNCHES_BY_ROUTE[route] += 1
    return geometry.repeat_last(d2, idx, k)


knn.launches = 0
# by route: 0 block, 1-3 the select instances, RANK_ROUTE (module-level,
# so that a wrapper swapped in for ``knn`` leaves it counting)
_LAUNCHES_BY_ROUTE = {r: 0 for r in (0, *SELECT, RANK_ROUTE)}
knn.launches_by_route = _LAUNCHES_BY_ROUTE
