"""Fused DGCNN EdgeConv: the CUDA kernels of ``csrc/edge_knn_eval.cu``,
``edge_knn_f1.cu``, ``edge_eval.cu``, ``edge_f1.cu``, ``edge_out.cu`` and
``edge_bwd.cu``, their plain versions, and the autograd functions that
chain them.

Replaces ``pointcloudlib_tpu/ops/pallas/fused_edge.py`` on both of the
JAX model's routes. Where it builds the graph inside its kernels (N % 128
== 0): ``fused_edge_eval_knn`` → ``_ke_knn_eval``, and
``fused_edge_conv_knn`` with its custom VJP: forward ``_ke_knn_f1`` then
``_ke_out``, backward ``_ke_bwd``. Where it takes the standalone kNN
first (N % 128 ≠ 0, ``ops/kernels/knn.py``): ``fused_edge_eval`` →
``_ke_eval``, and ``fused_edge_conv``: forward ``_call_ef1`` → ``_ke_f1``
then ``_ke_out``, backward ``_ke_bwd``.

One EdgeConv is ``max_k leaky(BN(concat(x_j − x_i, x_i)·W))`` over the k
nearest points j of x_i in feature space. With ``W = [Wa; Wb]`` the
pre-activation of an edge is ``h = Q[j] − Off[i]``, ``Q = X·Wa`` (bf16)
and ``Off = X·(Wa − Wb)``, both computed outside, so the edge tensor
``[B, N, k, 2C]`` never exists and every weight gradient flows through
``dQ``/``dOff`` by ordinary autograd. The kernels take the folded BN rows
``(sc, bi, rs, mrs)``: ``z = h·sc + bi``, ``x̂ = h·rs − mrs``. Between
them, plain tensor ops do what the JAX package leaves to XLA: the BN
moments, the folding (``_stack_stats``) and the affine assembly of
``dq``/``doff`` from the backward's sums (``fused_edge.py:469-480``).

The two-layer EdgeConv of DGCNN part segmentation (``Fused2EdgeConv``)
runs ``max_k leaky(BN2(bf16(leaky(BN1(h1)))·W2))`` with the same first
pass (``edge_knn_f1`` or ``edge_f1``) and six kernels of its own:
``edge2_stats2`` and ``edge2_out`` (``csrc/edge2_tail.cu``; ``_ke2_stats2``,
``_ke2_out``), ``edge2_p1`` and ``edge2_p2`` (``csrc/edge2_bwd_p1.cu``,
``edge2_bwd_p2.cu``; ``_ke2_p1``, ``_ke2_p2``), ``edge2_eval`` and
``edge2_knn_eval`` (``csrc/edge2_eval.cu``, ``edge2_knn_eval.cu``;
``_ke2_eval``, ``_ke2_knn_eval``). Between pass 1 and pass 2 of the
backward, ``_combine_p1`` (``ops/kernels/fused_sa_train.py``) turns the
sums of pass 1 into dW2 and the BN1 sums, as in the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from pointcloudlib_tpu_torch.ops import geometry
from pointcloudlib_tpu_torch.ops.kernels import _build
from pointcloudlib_tpu_torch.ops.kernels import knn as _knn
from pointcloudlib_tpu_torch.ops.kernels.fused_sa import (
    _SMEM_LIMIT,
    _aligned,
    _bf16_mm,
    _stack_stats,
)
from pointcloudlib_tpu_torch.ops.kernels.fused_sa_train import (
    _bf,
    _combine_p1,
    _expect,
    _moments,
    _on_card,
    _stream,
    _sums,
    _xhat,
    _z,
)
from pointcloudlib_tpu_torch.ops.kernels.knn import MAX_K
from pointcloudlib_tpu_torch.parallel.mesh import (
    DPGroup,
    all_reduce_sums,
    summed,
    synced,
    world_of,
)


class EdgeStats(NamedTuple):
    """BatchNorm statistics of one EdgeConv (biased variance)."""

    mean: torch.Tensor
    var: torch.Tensor


def _leaky(z: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(z > 0, z, slope * z)


def _maxpool_dz(z: torch.Tensor, dout: torch.Tensor, slope: float):
    """Gradient at ``z [B, M, k, C]`` of ``max_k leaky(z)``: ``dout``
    split evenly among the slots that reach a center's max (as
    ``jnp.max``'s gradient), times ``slope`` where ``z ≤ 0``."""
    y = _leaky(z, slope)
    ties = (y == y.amax(dim=2, keepdim=True)).float()
    da = dout[:, :, None] * ties / ties.sum(dim=2, keepdim=True)
    return torch.where(z > 0, da, slope * da)


def _edges(q, off, idx) -> torch.Tensor:
    """The f32 edge pre-activations ``float(bf16 q)[idx] − off``,
    ``[B, N, k, C]``."""
    return geometry.index_points(_bf(q), idx) - off[:, :, None]


# ---------------------------------------------------------------- plain


def edge_knn_eval_plain(x, q, off, st, k: int, slope: float = 0.2):
    """``out [B, N, C]`` as ``_ke_knn_eval`` computes it: the k nearest
    points of each point of ``x`` (``geometry.knn_plain``: ascending d², the
    lower index first on ties), then ``max_k leaky(sc·(float(bf16
    q)[j] − off_i) + bi)``."""
    _, idx = geometry.knn_plain(x, x, k)
    return _leaky(_z(_edges(q, off, idx), st), slope).amax(dim=2)


def edge_knn_f1_plain(x, q, off, k: int):
    """``(idx [B,N,k] i32, h [B,N,k,C] bf16, psum [2,C])`` as
    ``_ke_knn_f1`` computes them: the kNN of ``x``, ``h = bf16(float(bf16
    q)[idx] − off)`` and ``psum = [Σh, Σh²]`` of the f32 h before its
    rounding."""
    _, idx = geometry.knn_plain(x, x, k)
    h = _edges(q, off, idx)
    return idx, h.bfloat16(), _sums(h)


def edge_eval_plain(q, off, idx, st, slope: float = 0.2):
    """``out [B, M, C]`` as ``_ke_eval`` computes it from a given index
    ``idx [B, M, k]``: ``max_k leaky(sc·(float(bf16 q)[idx] − off) +
    bi)``."""
    return _leaky(_z(_edges(q, off, idx), st), slope).amax(dim=2)


def edge_f1_plain(q, off, idx):
    """``(h [B,M,k,C] bf16, psum [2,C])`` as ``_ke_f1`` computes them from
    a given index: ``h = bf16(float(bf16 q)[idx] − off)`` and ``psum =
    [Σh, Σh²]`` of the f32 h before its rounding."""
    h = _edges(q, off, idx)
    return h.bfloat16(), _sums(h)


def edge_out_plain(h, st, slope: float = 0.2):
    """``out = max_k leaky(sc·h + bi)`` ``[B, N, C]`` from the bf16
    checkpoint (``_ke_out``)."""
    return _leaky(_z(h.float(), st), slope).amax(dim=2)


def edge_bwd_plain(h, dout, idx, st, slope: float, n: int):
    """``(ps [2,C], scat [B,n,2C+1], d1, d2 [B,N,C])`` of ``_ke_bwd``:
    ``dz`` splits ``dout`` evenly among the slots that reach a center's
    max (as ``jnp.max``'s gradient) and scales it by ``slope`` where
    ``z ≤ 0``; ``ps = [Σdz, Σdz·x̂]``; ``scat[b, j] = Σ_{rows with idx =
    j} [bf16 dz ‖ bf16 x̂ ‖ 1]`` summed in f32 (the TPU's transposed
    one-hot product); ``d1``/``d2`` the per-center sums over k of ``dz``
    and ``x̂``."""
    b, m, k, c = h.shape
    hf = h.float()
    dz = _maxpool_dz(_z(hf, st), dout, slope)
    xh = _xhat(hf, st)
    ps = torch.stack([dz.sum((0, 1, 2)), (dz * xh).sum((0, 1, 2))])
    vals = torch.cat([_bf(dz), _bf(xh), torch.ones_like(dz[..., :1])],
                     dim=-1).reshape(b, m * k, 2 * c + 1)
    at = idx.reshape(b, m * k, 1).long().expand(-1, -1, 2 * c + 1)
    scat = torch.zeros((b, n, 2 * c + 1), dtype=torch.float32,
                       device=h.device).scatter_add_(1, at, vals)
    return ps, scat, dz.sum(2), xh.sum(2)


# ------------------------------------------------------------- launchers

_SIGNATURES = {
    "edge_knn_eval": {
        "edge_knn_eval_launch": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                                 + [ctypes.c_float, ctypes.c_void_p],
                                 ctypes.c_int),
        "edge_knn_eval_smem": ([ctypes.c_int] * 2, ctypes.c_longlong),
    },
    "edge_knn_f1": {
        "edge_knn_f1_launch": ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                               + [ctypes.c_void_p], ctypes.c_int),
        "edge_knn_f1_smem": ([ctypes.c_int] * 3, ctypes.c_longlong),
    },
    "edge_eval": {
        "edge_eval_launch": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                             + [ctypes.c_float, ctypes.c_void_p],
                             ctypes.c_int),
        "edge_eval_smem": ([ctypes.c_int] * 3, ctypes.c_longlong),
    },
    "edge_f1": {
        "edge_f1_launch": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                           + [ctypes.c_void_p], ctypes.c_int),
        "edge_f1_smem": ([ctypes.c_int] * 3, ctypes.c_longlong),
    },
    "edge_out": {
        "edge_out_launch": ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                            + [ctypes.c_int] * 2
                            + [ctypes.c_float, ctypes.c_void_p],
                            ctypes.c_int),
    },
    "edge_bwd": {
        "edge_bwd_launch": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                            + [ctypes.c_float, ctypes.c_void_p],
                            ctypes.c_int),
    },
    "edge2_tail": {
        f"edge2_{stage}_launch": ([ctypes.c_void_p] * 4
                                  + [ctypes.c_longlong] + [ctypes.c_int] * 3
                                  + [ctypes.c_float, ctypes.c_void_p],
                                  ctypes.c_int)
        for stage in ("stats2", "out")
    },
    "edge2_bwd_p1": {
        "edge2_bwd_p1_launch": ([ctypes.c_void_p] * 7 + [ctypes.c_longlong]
                                + [ctypes.c_int] * 3
                                + [ctypes.c_float, ctypes.c_void_p],
                                ctypes.c_int),
    },
    "edge2_bwd_p2": {
        "edge2_bwd_p2_launch": ([ctypes.c_void_p] * 8 + [ctypes.c_longlong]
                                + [ctypes.c_int] * 5
                                + [ctypes.c_float, ctypes.c_void_p],
                                ctypes.c_int),
    },
    "edge2_eval": {
        "edge2_eval_launch": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                              + [ctypes.c_float, ctypes.c_void_p],
                              ctypes.c_int),
        "edge2_eval_smem": ([ctypes.c_int], ctypes.c_longlong),
    },
    "edge2_knn_eval": {
        "edge2_knn_eval_launch": ([ctypes.c_void_p] * 7
                                  + [ctypes.c_int] * 7
                                  + [ctypes.c_float, ctypes.c_void_p],
                                  ctypes.c_int),
        "edge2_knn_eval_smem": ([ctypes.c_int] * 2, ctypes.c_longlong),
    },
}

SOURCES = tuple(_SIGNATURES)


def _lib(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    for fn, (args, res) in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        if f.argtypes is None:
            f.argtypes, f.restype = args, res
    return lib


def _width_ok(what: str, c: int) -> None:
    """The kernels keep one channel pair a thread of a 256-thread block."""
    if c < 2 or c % 2 or 256 % (c // 2):
        raise ValueError(f"{what}: width C={c} not taken; C must be even "
                         f"with C/2 dividing 256")


def _knn_ok(what: str, lib, smem_fn, n: int, k: int, smem_args) -> None:
    if not 1 <= k <= min(n, MAX_K):
        raise ValueError(f"{what}: needs 1 <= k <= min(N, {MAX_K}), got "
                         f"k={k}, N={n}")
    smem = getattr(lib, smem_fn)(*smem_args)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{what}: input width {smem_args[0]} and k={k} "
                         f"need {smem} bytes of shared memory, above one "
                         f"block's {_SMEM_LIMIT}")


def edge_knn_eval(x, q, off, st, k: int, slope: float = 0.2):
    """Eval-mode fused EdgeConv → ``out [B, N, C]`` float32, as
    :func:`edge_knn_eval_plain`. ``x [B, N, Cin]`` and ``off [B, N, C]``
    float32, ``q [B, N, C]`` bfloat16, ``st [4, C]`` the folded BN rows.
    The kernel for CUDA tensors on the route ``knn.edge_eval_route``
    picks, the plain version for CPU tensors."""
    if not _on_card("edge_knn_eval", q):
        return edge_knn_eval_plain(x, q, off, st, k, slope)
    b, n, c = q.shape
    cin = x.shape[-1]
    _width_ok("edge_knn_eval", c)
    _expect("edge_knn_eval", q.device, q=(q, (b, n, c), torch.bfloat16),
            x=(x, (b, n, cin), torch.float32),
            off=(off, (b, n, c), torch.float32),
            st=(st, (4, c), torch.float32))
    lib = _lib("edge_knn_eval")
    route = _knn.edge_eval_route(b, n, cin, c, k)
    if route == 0:
        _knn_ok("edge_knn_eval", lib, "edge_knn_eval_smem", n, k, (cin, k))
    dev = q.device
    out = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    # the select route's |p|^2 of every point (csrc/knn_select.cuh)
    norms = torch.empty(b * n if route else 1, dtype=torch.float32,
                        device=dev)
    x, q, off, st = map(_aligned, (x, q, off, st))
    with torch.cuda.device(dev):
        err = lib.edge_knn_eval_launch(
            x.data_ptr(), q.data_ptr(), off.data_ptr(), st.data_ptr(),
            out.data_ptr(), norms.data_ptr(), b, n, cin, c, k, route, slope,
            _stream(dev))
    _build.check(err, "edge_knn_eval")
    edge_knn_eval.launches += 1
    return out


edge_knn_eval.launches = 0


def edge_knn_f1(x, q, off, k: int):
    """Forward pass 1 → ``(idx, h, psum)`` as :func:`edge_knn_f1_plain`:
    the kernel for CUDA tensors (``q`` bfloat16) on the route
    ``knn.edge_f1_route`` picks, the plain version for CPU tensors."""
    if not _on_card("edge_knn_f1", q):
        return edge_knn_f1_plain(x, q, off, k)
    b, n, c = q.shape
    cin = x.shape[-1]
    _width_ok("edge_knn_f1", c)
    _expect("edge_knn_f1", q.device, q=(q, (b, n, c), torch.bfloat16),
            x=(x, (b, n, cin), torch.float32),
            off=(off, (b, n, c), torch.float32))
    lib = _lib("edge_knn_f1")
    route = _knn.edge_f1_route(b, n, cin, c, k)
    if route == 0:
        _knn_ok("edge_knn_f1", lib, "edge_knn_f1_smem", n, k, (cin, c, k))
    dev = q.device
    idx = torch.empty((b, n, k), dtype=torch.int32, device=dev)
    h = torch.empty((b, n, k, c), dtype=torch.bfloat16, device=dev)
    psum = torch.zeros((2, c), dtype=torch.float32, device=dev)
    # the select route's |p|^2 of every point (csrc/knn_select.cuh)
    norms = torch.empty(b * n if route else 1, dtype=torch.float32,
                        device=dev)
    x, q, off = map(_aligned, (x, q, off))
    with torch.cuda.device(dev):
        err = lib.edge_knn_f1_launch(
            x.data_ptr(), q.data_ptr(), off.data_ptr(), idx.data_ptr(),
            h.data_ptr(), psum.data_ptr(), norms.data_ptr(), b, n, cin, c,
            k, route, _stream(dev))
    _build.check(err, "edge_knn_f1")
    edge_knn_f1.launches += 1
    return idx, h, psum


edge_knn_f1.launches = 0


def _given_idx(what: str, q, off, idx, smem: int, route: str = ""):
    """``(b, m, n, c, k)`` of a given-index EdgeConv kernel's inputs
    (``q`` bfloat16, ``off`` float32, ``idx`` int32); raise on what the
    kernel (on its ``route``, needing ``smem`` bytes a block) does not
    take."""
    b, n, c = q.shape
    m, k = idx.shape[1:]
    _width_ok(what, c)
    _expect(what, q.device, q=(q, (b, n, c), torch.bfloat16),
            off=(off, (b, m, c), torch.float32),
            idx=(idx, (b, m, k), torch.int32))
    if smem > _SMEM_LIMIT:
        on = f" on the {route} route" if route else ""
        raise ValueError(f"{what}: k={k} needs {smem} bytes of shared "
                         f"memory{on}, above one block's {_SMEM_LIMIT}")
    return b, m, n, c, k


def edge_eval(q, off, idx, st, slope: float = 0.2):
    """Eval-mode EdgeConv from a given index → ``out [B, M, C]`` float32,
    as :func:`edge_eval_plain`. ``q [B, N, C]`` bfloat16, ``off [B, M,
    C]`` float32, ``idx [B, M, k]`` int32 with every entry in ``[0, N)``,
    ``st [4, C]`` the folded BN rows. The kernel for CUDA tensors on the
    route :func:`edge_eval_route` picks, the plain version for CPU
    tensors."""
    if not _on_card("edge_eval", q):
        return edge_eval_plain(q, off, idx, st, slope)
    lib = _lib("edge_eval")
    route = edge_eval_route(q.shape[-1])
    b, m, n, c, k = _given_idx(
        "edge_eval", q, off, idx,
        lib.edge_eval_smem(q.shape[-1], idx.shape[-1], route),
        EDGE_EVAL_ROUTES[route])
    _expect("edge_eval", q.device, st=(st, (4, c), torch.float32))
    dev = q.device
    out = torch.empty((b, m, c), dtype=torch.float32, device=dev)
    q, idx, off, st = map(_aligned, (q, idx, off, st))
    with torch.cuda.device(dev):
        err = lib.edge_eval_launch(
            q.data_ptr(), idx.data_ptr(), off.data_ptr(), st.data_ptr(),
            out.data_ptr(), b, m, n, c, k, route, slope, _stream(dev))
    _build.check(err, "edge_eval")
    edge_eval.launches += 1
    return out


edge_eval.launches = 0


# the routes of edge_eval (csrc/edge_eval.cu): the block pass of the first
# version, and a warp a center with the extreme of the rows taken first
# at the widths it is compiled for
EDGE_EVAL_ROUTES = {0: "rows", 1: "center"}
EDGE_EVAL_CENTER_WIDTHS = (64, 128, 256)


def edge_eval_route_fits(route: int, c: int) -> bool:
    """Whether ``edge_eval``'s route takes width ``c``."""
    return route == 0 or c in EDGE_EVAL_CENTER_WIDTHS


def edge_eval_route(c: int) -> int:
    """``edge_eval``'s route at width ``c``: center where it is compiled,
    else rows. Distinct from ``knn.edge_eval_route``, which routes the
    eval kernels with the kNN inside."""
    return 1 if edge_eval_route_fits(1, c) else 0


# the routes of edge_f1 (csrc/edge_f1.cu): the block pass of the first
# version, and the set abstraction's given-index pass 1 at the widths it
# is compiled for
EDGE_F1_ROUTES = {0: "rows", 1: "center"}
EDGE_F1_CENTER_WIDTHS = (64, 128, 256)


def edge_f1_route_fits(route: int, c: int) -> bool:
    """Whether ``edge_f1``'s route takes width ``c``."""
    return route == 0 or c in EDGE_F1_CENTER_WIDTHS


def edge_f1_route(c: int) -> int:
    """``edge_f1``'s route at width ``c``: center where it is compiled,
    else rows."""
    return 1 if edge_f1_route_fits(1, c) else 0


def edge_f1(q, off, idx):
    """Forward pass 1 from a given index → ``(h, psum)`` as
    :func:`edge_f1_plain`: the kernel for CUDA tensors (as
    :func:`edge_eval` takes them) on the route :func:`edge_f1_route`
    picks, the plain version for CPU tensors."""
    if not _on_card("edge_f1", q):
        return edge_f1_plain(q, off, idx)
    lib = _lib("edge_f1")
    route = edge_f1_route(q.shape[-1])
    b, m, n, c, k = _given_idx("edge_f1", q, off, idx, lib.edge_f1_smem(
        q.shape[-1], idx.shape[-1], route), EDGE_F1_ROUTES[route])
    dev = q.device
    h = torch.empty((b, m, k, c), dtype=torch.bfloat16, device=dev)
    psum = torch.zeros((2, c), dtype=torch.float32, device=dev)
    q, idx, off = map(_aligned, (q, idx, off))
    with torch.cuda.device(dev):
        err = lib.edge_f1_launch(
            q.data_ptr(), idx.data_ptr(), off.data_ptr(), h.data_ptr(),
            psum.data_ptr(), b, m, n, c, k, route, _stream(dev))
    _build.check(err, "edge_f1")
    edge_f1.launches += 1
    return h, psum


edge_f1.launches = 0


def edge_out(h, st, slope: float = 0.2):
    """Forward pass 2 → ``out [B, N, C]`` as :func:`edge_out_plain`: the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if not _on_card("edge_out", h):
        return edge_out_plain(h, st, slope)
    b, m, k, c = h.shape
    if c < 2 or c % 2:
        raise ValueError(f"edge_out: width C={c} must be even")
    _expect("edge_out", h.device, h=(h, (b, m, k, c), torch.bfloat16),
            st=(st, (4, c), torch.float32))
    dev = h.device
    out = torch.empty((b, m, c), dtype=torch.float32, device=dev)
    h, st = _aligned(h), _aligned(st)
    with torch.cuda.device(dev):
        err = _lib("edge_out").edge_out_launch(
            h.data_ptr(), st.data_ptr(), out.data_ptr(), b * m, k, c, slope,
            _stream(dev))
    _build.check(err, "edge_out")
    edge_out.launches += 1
    return out


edge_out.launches = 0


def edge_bwd(h, dout, idx, st, slope: float, n: int):
    """The backward pass → ``(ps, scat, d1, d2)`` as
    :func:`edge_bwd_plain`: the kernel for CUDA tensors (``idx`` int32
    with every entry in ``[0, n)``), the plain version for CPU tensors."""
    if not _on_card("edge_bwd", h):
        return edge_bwd_plain(h, dout, idx, st, slope, n)
    b, m, k, c = h.shape
    if m != n:
        raise ValueError(f"edge_bwd: the kernel takes self-kNN rows (M = N),"
                         f" got M={m}, N={n}")
    if c < 4 or c % 4 or 256 % (c // 4):
        raise ValueError(f"edge_bwd: width C={c} not taken; C must be a "
                         f"multiple of 4 with C/4 dividing 256")
    dev = h.device
    _expect("edge_bwd", dev, h=(h, (b, m, k, c), torch.bfloat16),
            dout=(dout, (b, m, c), torch.float32),
            idx=(idx, (b, m, k), torch.int32),
            st=(st, (4, c), torch.float32))
    ps = torch.zeros((2, c), dtype=torch.float32, device=dev)
    # rows of 2C + 4 keep the kernel's 16-byte atomics aligned
    scat = torch.zeros((b, n, 2 * c + 4), dtype=torch.float32, device=dev)
    d1 = torch.empty((b, m, c), dtype=torch.float32, device=dev)
    d2 = torch.empty((b, m, c), dtype=torch.float32, device=dev)
    h, dout, idx, st = map(_aligned, (h, dout, idx, st))
    with torch.cuda.device(dev):
        err = _lib("edge_bwd").edge_bwd_launch(
            h.data_ptr(), dout.data_ptr(), idx.data_ptr(), st.data_ptr(),
            ps.data_ptr(), scat.data_ptr(), d1.data_ptr(), d2.data_ptr(),
            b, n, k, c, slope, _stream(dev))
    _build.check(err, "edge_bwd")
    edge_bwd.launches += 1
    return ps, scat[..., :2 * c + 1], d1, d2


edge_bwd.launches = 0


# ------------------------------------------------------ the entry points


def fused_edge_eval_knn(x, q, off, gamma, beta, stats: EdgeStats, k: int,
                        slope: float = 0.2) -> torch.Tensor:
    """Eval-mode EdgeConv with the graph built inside the kernel → ``out
    [B, N, C]`` (``fused_edge_eval_knn``, ``fused_edge.py:281``); ``q``
    is rounded to bf16 here, as the JAX function does."""
    st = _stack_stats(stats.mean, stats.var, gamma, beta)
    return edge_knn_eval(x.float(), q.bfloat16(), off.float(), st, k, slope)


def assemble_grads(ps, scat, d1, d2, st, k: int,
                   group: Optional[DPGroup] = None):
    """``(dq, doff, dγ, dβ)`` from the backward pass's sums
    (``_edge_bwd_rule``, ``fused_edge.py:469-480``): the BN backward
    ``dh = sc·(dz − u1 − x̂·u2)`` with ``u = ps / R`` is affine in them, so
    ``dq`` (the scatter of ``dh`` onto the neighbour rows) and ``doff``
    (minus its per-center sum) follow from ``scat``, ``d1`` and ``d2``.
    Over a group, u from ``ps`` summed over the ranks and ``R`` over all
    their edges; dγ and dβ stay this rank's partial sums."""
    b, m, c = d1.shape
    r = float(b * m * k * world_of(group))
    sc = st[0]
    ps_g = summed(ps, group)
    u1 = ps_g[0] / r
    u2 = ps_g[1] / r
    dq = sc * (scat[..., :c] - scat[..., 2 * c:] * u1
               - scat[..., c:2 * c] * u2)
    doff = -sc * (d1 - float(k) * u1 - d2 * u2)
    return dq, doff, ps[1], ps[0]


def fused_edge_eval(q, off, idx, gamma, beta, stats: EdgeStats,
                    slope: float = 0.2) -> torch.Tensor:
    """Eval-mode EdgeConv from a given neighbour index → ``out [B, M, C]``
    (``fused_edge_eval``, ``fused_edge.py:536``); ``q`` is rounded to bf16
    here, as the JAX function does."""
    st = _stack_stats(stats.mean, stats.var, gamma, beta)
    return edge_eval(q.bfloat16(), off.float(), idx.int(), st, slope)


class _EdgeTrain(torch.autograd.Function):
    """The train-mode EdgeConv's tail and backward, shared by its two
    routes: from pass 1's ``(idx, h, psum)``, the batch moments over all
    B·M·k edges, the folded rows, ``edge_out``; backward ``edge_bwd`` and
    the dq/doff assembly. ``q`` is rounded to bf16 before pass 1, so
    ``dq`` comes back float32; the graph carries no gradient. Given a
    data-parallel group, the moments' sums and the backward's ``ps`` are
    summed over its ranks (``fused_edge.py:405-407,469``)."""

    @staticmethod
    def _tail(ctx, idx, h, psum, gamma, beta, slope, group):
        b, m, k, _ = h.shape
        mean, var = _moments(summed(psum, group),
                             float(b * m * k * world_of(group)))
        st = _stack_stats(mean, var, gamma, beta)
        out = edge_out(h, st, slope)
        ctx.save_for_backward(idx, h, st)
        ctx.slope, ctx.group = slope, group
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def _grads(ctx, dout):
        """``(dq, doff, dγ, dβ)``."""
        idx, h, st = ctx.saved_tensors
        sums = edge_bwd(h, dout.float().contiguous(), idx, st, ctx.slope,
                        h.shape[1])
        return assemble_grads(*sums, st, h.shape[2], ctx.group)


class FusedEdgeKnnTrain(_EdgeTrain):
    """Train-mode EdgeConv with the graph built inside
    (``fused_edge_conv_knn`` and its custom VJP). Inputs ``x [B,N,Cin]``,
    ``q [B,N,C]`` and ``off [B,N,C]`` float32, ``gamma``/``beta [C]``,
    k, the LeakyReLU slope and the data-parallel group (or ``None``).
    Returns ``out [B,N,C]`` and the batch mean and biased variance over
    all B·N·k edges (not differentiable). ``x`` gets no gradient here,
    and reaches its gradient through ``q`` and ``off``, computed from it
    outside."""

    @staticmethod
    def forward(ctx, x, q, off, gamma, beta, k, slope, group):
        idx, h, psum = edge_knn_f1(x.detach().float(), q.bfloat16(),
                                   off.float(), k)
        return _EdgeTrain._tail(ctx, idx, h, psum, gamma, beta, slope, group)

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        return (None, *_EdgeTrain._grads(ctx, dout), None, None, None)


class FusedEdgeTrain(_EdgeTrain):
    """Train-mode EdgeConv from a given self-kNN index ``idx [B,N,k]``
    (``fused_edge_conv`` and its custom VJP): inputs ``q``, ``off``,
    ``idx``, ``gamma``, ``beta``, the slope and the group; returns as
    :class:`FusedEdgeKnnTrain`."""

    @staticmethod
    def forward(ctx, q, off, idx, gamma, beta, slope, group):
        idx = idx.int()
        h, psum = edge_f1(q.bfloat16(), off.float(), idx)
        return _EdgeTrain._tail(ctx, idx, h, psum, gamma, beta, slope, group)

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        dq, doff, dgamma, dbeta = _EdgeTrain._grads(ctx, dout)
        return dq, doff, None, dgamma, dbeta, None, None


def fused_edge_conv_knn(x, q, off, gamma, beta, k: int, slope: float = 0.2,
                        group: Optional[DPGroup] = None
                        ) -> Tuple[torch.Tensor, EdgeStats]:
    """``(out [B, N, C], EdgeStats)`` of the train-mode EdgeConv with the
    graph built inside (``fused_edge_conv_knn``, ``fused_edge.py:487``),
    with its hand-written backward; with a ``group``, sync-BN over its
    ranks."""
    out, mean, var = FusedEdgeKnnTrain.apply(x, q, off, gamma, beta, k,
                                             slope, group)
    return out, EdgeStats(mean, var)


def fused_edge_conv(q, off, idx, gamma, beta, slope: float = 0.2,
                    group: Optional[DPGroup] = None
                    ) -> Tuple[torch.Tensor, EdgeStats]:
    """``(out [B, N, C], EdgeStats)`` of the train-mode EdgeConv from a
    given self-kNN index (``fused_edge_conv``, ``fused_edge.py:387``), with
    its hand-written backward; with a ``group``, sync-BN over its
    ranks."""
    out, mean, var = FusedEdgeTrain.apply(q, off, idx, gamma, beta, slope,
                                          group)
    return out, EdgeStats(mean, var)


# ------------------------------------------------ the two-layer EdgeConv


class Edge2Stats(NamedTuple):
    """BatchNorm statistics of a two-layer EdgeConv (biased variance),
    as ``Edge2Stats`` (``fused_edge.py:726``)."""

    m1: torch.Tensor
    v1: torch.Tensor
    m2: torch.Tensor
    v2: torch.Tensor


# (C1, C2) the two-layer kernels are compiled for (csrc/edge2.cuh)
EDGE2_WIDTHS = ((64, 64),)
# The forward tails' blocks (csrc/edge2_tail.cu): raw h1 tiles a block
# (kT2Ring) and the blocks an SM the kernel is built for (kT2Blocks)
TAIL2_RING, TAIL2_BLOCKS = 3, 2
# edge2_eval's blocks (csrc/edge2_eval.cu): tiles of 64 centers a block
# (kE2EvalTiles) and the blocks an SM it is built for
EVAL2_TILES, EVAL2_BLOCKS = 1, 2


def edge2_tail_smem(c1: int, c2: int) -> int:
    """Dynamic shared memory bytes of one block of ``edge2_stats2`` or
    ``edge2_out`` (``csrc/edge2_tail.cu`` ``T2Layout``): W2 (bf16), both
    layers' folded rows and the sums' scratch (f32), the raw h1 tiles (64
    rows of C1 + 8 bf16) and two y1 tiles of 64 rows."""
    head = -(-(2 * c1 * c2 + 16 * (c1 + c2) + 8 * c2) // 128) * 128
    return head + TAIL2_RING * 64 * (c1 + 8) * 2 + 2 * 64 * c1 * 2


def edge2_eval_smem(c1: int, c2: int, k: int) -> int:
    """Dynamic shared memory bytes of one block of ``edge2_eval``
    (``csrc/edge2_eval.cu`` ``E2EvalLayout``): the lists of its centers
    slot-major (i32), W2 (bf16) and two y1 tiles of 64 rows (bf16)."""
    lists = -(-4 * EVAL2_TILES * 64 * k // 128) * 128
    return lists + 2 * c1 * c2 + 2 * 64 * c1 * 2


def _chain2(h1f, st1, st2, w2, slope: float):
    """``(z1, y1, h2, z2)`` of the two-layer chain from the f32 view of
    h1: ``y1 = leaky(BN1(h1))``, ``h2 = bf16(y1)·bf16(W2)`` with f32
    sums, ``z2 = BN2(h2)``."""
    z1 = _z(h1f, st1)
    y1 = _leaky(z1, slope)
    h2 = _bf16_mm(y1, w2)
    return z1, y1, h2, _z(h2, st2)


def edge2_stats2_plain(h1, st1, w2, slope: float = 0.2):
    """``[Σh2, Σh2²]`` ``[2, C2]`` over every row of the bf16 checkpoint
    ``h1 [B, M, k, C1]`` (``_ke2_stats2``)."""
    h2 = _bf16_mm(_leaky(_z(h1.float(), st1), slope), w2)
    return _sums(h2)


def edge2_out_plain(h1, st1, st2, w2, slope: float = 0.2):
    """``out = max_k leaky(BN2(h2))`` ``[B, M, C2]`` from the bf16
    checkpoint (``_ke2_out``)."""
    z2 = _chain2(h1.float(), st1, st2, w2, slope)[3]
    return _leaky(z2, slope).amax(dim=2)


def _leaky_mask(z: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(z > 0, 1.0, slope)


def edge2_p1_plain(h1, dout, st1, st2, w2, slope: float = 0.2):
    """``(ps2 [2,C2], vecs [3C1], mats [3C1,2C2])`` of ``_ke2_p1``:
    ``dz2`` the max-pool gradient (even tie split, slope where z2 ≤ 0),
    ``ps2 = [Σdz2, Σdz2·x̂2]``, ``vecs = Σ[y1‖m1‖m1·x̂1]`` with ``m1`` the
    LeakyReLU mask (1 or slope), ``mats = bf16[y1‖m1‖m1·x̂1]ᵀ ·
    bf16[dz2‖x̂2]``."""
    h1f = h1.float()
    z1, y1, h2, z2 = _chain2(h1f, st1, st2, w2, slope)
    dz2 = _maxpool_dz(z2, dout, slope)
    xh2 = _xhat(h2, st2)
    m1 = _leaky_mask(z1, slope)
    left = torch.cat([y1, m1, m1 * _xhat(h1f, st1)], dim=-1)
    right = torch.cat([dz2, xh2], dim=-1)
    left = left.reshape(-1, left.shape[-1])
    right = right.reshape(-1, right.shape[-1])
    ps2 = torch.stack([dz2.sum((0, 1, 2)), (dz2 * xh2).sum((0, 1, 2))])
    return ps2, left.sum(0), _bf(left).t() @ _bf(right)


def edge2_p2_plain(h1, dout, idx, st1, st2, w2, us2, us1, slope: float,
                   n: int):
    """``(dq [B,n,C1], doff [B,M,C1])`` of ``_ke2_p2``, given the
    pre-divided BN sums ``us2 [2,C2]`` and ``us1 [2,C1]``: per row
    ``dh2 = sc2·(dz2 − us2[0] − x̂2·us2[1])``, ``dy1 = bf16(dh2)·
    bf16(W2ᵀ)``, ``dh1 = sc1·(m1·dy1 − us1[0] − x̂1·us1[1])``; ``doff =
    −Σ_k dh1`` and ``dq`` the rows of dh1 added at ``idx`` (the TPU's
    hi/lo bf16 one-hot product is an almost exact f32 scatter)."""
    b, m, k, c1 = h1.shape
    h1f = h1.float()
    z1, _, h2, z2 = _chain2(h1f, st1, st2, w2, slope)
    dz2 = _maxpool_dz(z2, dout, slope)
    dh2 = st2[0] * (dz2 - us2[0] - _xhat(h2, st2) * us2[1])
    dz1 = _leaky_mask(z1, slope) * _bf16_mm(dh2, w2.t())
    dh1 = st1[0] * (dz1 - us1[0] - _xhat(h1f, st1) * us1[1])
    rows = (idx.long() + n * torch.arange(b, device=idx.device)[:, None,
                                                                None])
    dq = torch.zeros((b * n, c1), dtype=torch.float32, device=h1.device)
    dq.index_add_(0, rows.reshape(-1), dh1.reshape(-1, c1))
    return dq.reshape(b, n, c1), -dh1.sum(2)


def edge2_eval_plain(q, off, idx, st1, st2, w2, slope: float = 0.2):
    """``out [B, M, C2]`` as ``_ke2_eval`` computes it from a given index
    ``idx [B, M, k]``: ``h1 = float(bf16 q)[idx] − off``, then the chain
    and the max over k."""
    z2 = _chain2(_edges(q, off, idx), st1, st2, w2, slope)[3]
    return _leaky(z2, slope).amax(dim=2)


def edge2_knn_eval_plain(x, q, off, st1, st2, w2, k: int,
                         slope: float = 0.2):
    """``out [B, N, C2]`` as ``_ke2_knn_eval`` computes it: the chain of
    :func:`edge2_eval_plain` over the k nearest points of each point of
    ``x`` (``geometry.knn_plain``, as :func:`edge_knn_eval_plain`)."""
    _, idx = geometry.knn_plain(x, x, k)
    return edge2_eval_plain(q, off, idx, st1, st2, w2, slope)




def _widths2(what: str, c1: int, c2: int) -> None:
    if (c1, c2) not in EDGE2_WIDTHS:
        raise ValueError(f"{what}: no kernel instance for widths "
                         f"(C1, C2) = {(c1, c2)}; compiled: {EDGE2_WIDTHS}")


def _rows2(what: str, h1, w2, st1, st2=None):
    """``(b, m, k, c1, c2)`` of a two-layer train kernel's checkpoint
    ``h1`` and ``w2``; raise on what the kernel does not take."""
    b, m, k, c1 = h1.shape
    c2 = w2.shape[1]
    _widths2(what, c1, c2)
    dev = h1.device
    _expect(what, dev, h1=(h1, (b, m, k, c1), torch.bfloat16),
            w2=(w2, (c1, c2), w2.dtype), st1=(st1, (4, c1), torch.float32))
    if st2 is not None:
        _expect(what, dev, st2=(st2, (4, c2), torch.float32))
    return b, m, k, c1, c2


def _st2(st1, st2) -> torch.Tensor:
    """The folded rows of both layers as one ``[4·C1 + 4·C2]`` vector."""
    return _aligned(torch.cat([st1.reshape(-1), st2.reshape(-1)]).float())


def _tail2(stage: str, h1, st1, st2, w2, slope: float) -> torch.Tensor:
    b, m, k, c1, c2 = _rows2(f"edge2_{stage}", h1, w2, st1, st2)
    dev = h1.device
    if stage == "stats2":
        out = torch.zeros((2, c2), dtype=torch.float32, device=dev)
        st2 = torch.zeros((4, c2), dtype=torch.float32, device=dev)
    else:
        out = torch.empty((b, m, c2), dtype=torch.float32, device=dev)
    h1, st, w2b = _aligned(h1), _st2(st1, st2), _aligned(w2.bfloat16())
    with torch.cuda.device(dev):
        err = getattr(_lib("edge2_tail"), f"edge2_{stage}_launch")(
            h1.data_ptr(), st.data_ptr(), w2b.data_ptr(), out.data_ptr(),
            b * m, k, c1, c2, slope, _stream(dev))
    _build.check(err, f"edge2_{stage}")
    return out


def edge2_stats2(h1, st1, w2, slope: float = 0.2):
    """``[Σh2, Σh2²]`` as :func:`edge2_stats2_plain`: the kernel for CUDA
    tensors (``h1`` bfloat16, ``st1 [4, C1]``), the plain version for CPU
    tensors."""
    if not _on_card("edge2_stats2", h1):
        return edge2_stats2_plain(h1, st1, w2, slope)
    out = _tail2("stats2", h1, st1, None, w2, slope)
    edge2_stats2.launches += 1
    return out


edge2_stats2.launches = 0


def edge2_out(h1, st1, st2, w2, slope: float = 0.2):
    """Forward pass 3 → ``out [B, M, C2]`` as :func:`edge2_out_plain`:
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    if not _on_card("edge2_out", h1):
        return edge2_out_plain(h1, st1, st2, w2, slope)
    out = _tail2("out", h1, st1, st2, w2, slope)
    edge2_out.launches += 1
    return out


edge2_out.launches = 0


def edge2_p1(h1, dout, st1, st2, w2, slope: float = 0.2):
    """Backward pass 1 → ``(ps2, vecs, mats)`` as :func:`edge2_p1_plain`:
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    if not _on_card("edge2_p1", h1):
        return edge2_p1_plain(h1, dout, st1, st2, w2, slope)
    b, m, k, c1, c2 = _rows2("edge2_p1", h1, w2, st1, st2)
    dev = h1.device
    _expect("edge2_p1", dev, dout=(dout, (b, m, c2), torch.float32))
    ps2 = torch.zeros((2, c2), dtype=torch.float32, device=dev)
    vecs = torch.zeros(3 * c1, dtype=torch.float32, device=dev)
    mats = torch.zeros((3 * c1, 2 * c2), dtype=torch.float32, device=dev)
    h1, dout, st = _aligned(h1), _aligned(dout), _st2(st1, st2)
    w2b = _aligned(w2.bfloat16())
    with torch.cuda.device(dev):
        err = _lib("edge2_bwd_p1").edge2_bwd_p1_launch(
            h1.data_ptr(), dout.data_ptr(), st.data_ptr(), w2b.data_ptr(),
            ps2.data_ptr(), vecs.data_ptr(), mats.data_ptr(), b * m, k, c1,
            c2, slope, _stream(dev))
    _build.check(err, "edge2_p1")
    edge2_p1.launches += 1
    return ps2, vecs, mats


edge2_p1.launches = 0


def edge2_p2(h1, dout, idx, st1, st2, w2, us2, us1, slope: float, n: int):
    """Backward pass 2 → ``(dq, doff)`` as :func:`edge2_p2_plain`: the
    kernel for CUDA tensors (``idx`` int32 with every entry in ``[0,
    n)``), the plain version for CPU tensors."""
    if not _on_card("edge2_p2", h1):
        return edge2_p2_plain(h1, dout, idx, st1, st2, w2, us2, us1, slope,
                              n)
    b, m, k, c1, c2 = _rows2("edge2_p2", h1, w2, st1, st2)
    dev = h1.device
    _expect("edge2_p2", dev, dout=(dout, (b, m, c2), torch.float32),
            idx=(idx, (b, m, k), torch.int32),
            us2=(us2, (2, c2), torch.float32),
            us1=(us1, (2, c1), torch.float32))
    dq = torch.zeros((b, n, c1), dtype=torch.float32, device=dev)
    doff = torch.empty((b, m, c1), dtype=torch.float32, device=dev)
    h1, dout, idx, st = _aligned(h1), _aligned(dout), _aligned(idx), \
        _st2(st1, st2)
    us = _aligned(torch.cat([us2.reshape(-1), us1.reshape(-1)]))
    w2b = _aligned(w2.bfloat16())
    with torch.cuda.device(dev):
        err = _lib("edge2_bwd_p2").edge2_bwd_p2_launch(
            h1.data_ptr(), dout.data_ptr(), idx.data_ptr(), st.data_ptr(),
            us.data_ptr(), w2b.data_ptr(), dq.data_ptr(), doff.data_ptr(),
            b * m, m, n, k, c1, c2, slope, _stream(dev))
    _build.check(err, "edge2_p2")
    edge2_p2.launches += 1
    return dq, doff


edge2_p2.launches = 0


def edge2_eval(q, off, idx, st1, st2, w2, slope: float = 0.2):
    """Eval-mode two-layer EdgeConv from a given index → ``out [B, M,
    C2]`` float32, as :func:`edge2_eval_plain`. ``q [B, N, C1]``
    bfloat16, ``off [B, M, C1]`` float32, ``idx [B, M, k]`` int32 with
    every entry in ``[0, N)``, ``st1``/``st2`` the folded BN rows. The
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if not _on_card("edge2_eval", q):
        return edge2_eval_plain(q, off, idx, st1, st2, w2, slope)
    lib = _lib("edge2_eval")
    b, m, n, c1, k = _given_idx("edge2_eval", q, off, idx,
                                lib.edge2_eval_smem(idx.shape[-1]))
    c2 = w2.shape[1]
    _widths2("edge2_eval", c1, c2)
    dev = q.device
    _expect("edge2_eval", dev, st1=(st1, (4, c1), torch.float32),
            st2=(st2, (4, c2), torch.float32))
    out = torch.empty((b, m, c2), dtype=torch.float32, device=dev)
    q, idx, off, st = _aligned(q), _aligned(idx), _aligned(off), \
        _st2(st1, st2)
    w2b = _aligned(w2.bfloat16())
    with torch.cuda.device(dev):
        err = lib.edge2_eval_launch(
            q.data_ptr(), idx.data_ptr(), off.data_ptr(), st.data_ptr(),
            w2b.data_ptr(), out.data_ptr(), b, m, n, c1, c2, k, slope,
            _stream(dev))
    _build.check(err, "edge2_eval")
    edge2_eval.launches += 1
    return out


edge2_eval.launches = 0


def edge2_knn_eval(x, q, off, st1, st2, w2, k: int, slope: float = 0.2):
    """Eval-mode two-layer EdgeConv with the graph built inside → ``out
    [B, N, C2]`` float32, as :func:`edge2_knn_eval_plain`. ``x [B, N,
    Cin]`` and ``off [B, N, C1]`` float32, ``q [B, N, C1]`` bfloat16. The
    kernel for CUDA tensors on the route ``knn.edge_eval_route`` picks
    (two layers), the plain version for CPU tensors."""
    if not _on_card("edge2_knn_eval", q):
        return edge2_knn_eval_plain(x, q, off, st1, st2, w2, k, slope)
    b, n, c1 = q.shape
    c2 = w2.shape[1]
    cin = x.shape[-1]
    _widths2("edge2_knn_eval", c1, c2)
    dev = q.device
    _expect("edge2_knn_eval", dev, q=(q, (b, n, c1), torch.bfloat16),
            x=(x, (b, n, cin), torch.float32),
            off=(off, (b, n, c1), torch.float32),
            st1=(st1, (4, c1), torch.float32),
            st2=(st2, (4, c2), torch.float32))
    lib = _lib("edge2_knn_eval")
    route = _knn.edge_eval_route(b, n, cin, c2, k, layers=2)
    if route == 0:
        _knn_ok("edge2_knn_eval", lib, "edge2_knn_eval_smem", n, k,
                (cin, k))
    out = torch.empty((b, n, c2), dtype=torch.float32, device=dev)
    # the select route's |p|^2 of every point (csrc/knn_select.cuh)
    norms = torch.empty(b * n if route else 1, dtype=torch.float32,
                        device=dev)
    x, q, off, st = _aligned(x), _aligned(q), _aligned(off), _st2(st1, st2)
    w2b = _aligned(w2.bfloat16())
    with torch.cuda.device(dev):
        err = lib.edge2_knn_eval_launch(
            x.data_ptr(), q.data_ptr(), off.data_ptr(), st.data_ptr(),
            w2b.data_ptr(), out.data_ptr(), norms.data_ptr(), b, n, cin, c1,
            c2, k, route, slope, _stream(dev))
    _build.check(err, "edge2_knn_eval")
    edge2_knn_eval.launches += 1
    return out


edge2_knn_eval.launches = 0


class _Edge2Train(torch.autograd.Function):
    """The train-mode two-layer EdgeConv after its first pass, shared by
    its two routes (``_e2_fwd`` and ``_e2_bwd_rule``,
    ``fused_edge.py:733-868``): the BN1 moments over all B·M·k edges,
    ``edge2_stats2``, the BN2 moments, ``edge2_out``; backward
    ``edge2_p1`` → ``_combine_p1`` (dW2 and the BN1 sums) → ``edge2_p2``.
    ``q`` is rounded to bf16 before pass 1, so ``dq`` comes back
    float32; the graph carries no gradient. Given a data-parallel group,
    both layers' moment sums and the backward's ``ps2``, ``vecs`` and
    ``mats`` are summed over its ranks; dW2 and the BN parameters'
    gradients stay this rank's partials against the global u-terms
    (``fused_edge.py:737-754,794-868``)."""

    @staticmethod
    def _tail(ctx, idx, h1, psum1, w2, g1, b1, g2, b2, slope, n, group):
        b, m, k, _ = h1.shape
        r = float(b * m * k * world_of(group))
        m1, v1 = _moments(summed(psum1, group), r)
        st1 = _stack_stats(m1, v1, g1, b1)
        m2, v2 = _moments(
            summed(edge2_stats2(h1, st1, w2, slope), group), r)
        st2 = _stack_stats(m2, v2, g2, b2)
        out = edge2_out(h1, st1, st2, w2, slope)
        ctx.save_for_backward(idx, h1, st1, st2, w2)
        ctx.slope, ctx.n, ctx.group = slope, n, group
        ctx.mark_non_differentiable(m1, v1, m2, v2)
        return out, m1, v1, m2, v2

    @staticmethod
    def _grads(ctx, dout):
        """``(dq, doff, dw2, dγ1, dβ1, dγ2, dβ2)``."""
        idx, h1, st1, st2, w2 = ctx.saved_tensors
        group = ctx.group
        b, m, k, _ = h1.shape
        r = float(b * m * k * world_of(group))
        dout = dout.float().contiguous()
        ps2, vecs, mats = edge2_p1(h1, dout, st1, st2, w2, ctx.slope)
        ps2_g, vecs_g, mats_g = all_reduce_sums([ps2, vecs, mats], group)
        # dW2 and the BN1 parameters' sums from this rank's rows
        dw2, s1 = _combine_p1(ps2_g, vecs, mats, st2, w2, r)
        s1_g = (_combine_p1(ps2_g, vecs_g, mats_g, st2, w2, r)[1]
                if synced(group) else s1)
        dq, doff = edge2_p2(h1, dout, idx, st1, st2, w2, ps2_g / r, s1_g / r,
                            ctx.slope, ctx.n)
        return dq, doff, dw2, s1[1], s1[0], ps2[1], ps2[0]


class FusedEdge2KnnTrain(_Edge2Train):
    """Train-mode two-layer EdgeConv with the graph built inside
    (``fused_edge2_conv_knn`` and its custom VJP). Inputs ``x [B,N,Cin]``,
    ``q [B,N,C1]`` and ``off [B,N,C1]`` float32, ``w2 [C1,C2]``, the BN
    scales and offsets of both layers, k, the LeakyReLU slope and the
    data-parallel group (or ``None``). Returns ``out [B,N,C2]`` and the
    four batch statistics (not differentiable)."""

    @staticmethod
    def forward(ctx, x, q, off, w2, g1, b1, g2, b2, k, slope, group):
        idx, h1, psum = edge_knn_f1(x.detach().float(), q.bfloat16(),
                                    off.float(), k)
        return _Edge2Train._tail(ctx, idx, h1, psum, w2, g1, b1, g2, b2,
                                 slope, q.shape[1], group)

    @staticmethod
    def backward(ctx, dout, *_):
        return (None, *_Edge2Train._grads(ctx, dout), None, None, None)


class FusedEdge2Train(_Edge2Train):
    """Train-mode two-layer EdgeConv from a given self-kNN index
    ``idx [B,N,k]`` (``fused_edge2_conv`` and its custom VJP); returns as
    :class:`FusedEdge2KnnTrain`."""

    @staticmethod
    def forward(ctx, q, off, idx, w2, g1, b1, g2, b2, slope, group):
        idx = idx.int()
        h1, psum = edge_f1(q.bfloat16(), off.float(), idx)
        return _Edge2Train._tail(ctx, idx, h1, psum, w2, g1, b1, g2, b2,
                                 slope, q.shape[1], group)

    @staticmethod
    def backward(ctx, dout, *_):
        dq, doff, *rest = _Edge2Train._grads(ctx, dout)
        return (dq, doff, None, *rest, None, None)


def fused_edge2_conv_knn(x, q, off, w2, g1, b1, g2, b2, k: int,
                         slope: float = 0.2, group: Optional[DPGroup] = None
                         ) -> Tuple[torch.Tensor, Edge2Stats]:
    """``(out [B, N, C2], Edge2Stats)`` of the train-mode two-layer
    EdgeConv with the graph built inside (``fused_edge2_conv_knn``,
    ``fused_edge.py:931``), with its hand-written backward."""
    out, *stats = FusedEdge2KnnTrain.apply(x, q, off, w2, g1, b1, g2, b2,
                                           k, slope, group)
    return out, Edge2Stats(*stats)


def fused_edge2_conv(q, off, idx, w2, g1, b1, g2, b2, slope: float = 0.2,
                     group: Optional[DPGroup] = None
                     ) -> Tuple[torch.Tensor, Edge2Stats]:
    """``(out [B, N, C2], Edge2Stats)`` of the train-mode two-layer
    EdgeConv from a given self-kNN index (``fused_edge2_conv``,
    ``fused_edge.py:770``), with its hand-written backward."""
    out, *stats = FusedEdge2Train.apply(q, off, idx, w2, g1, b1, g2, b2,
                                        slope, group)
    return out, Edge2Stats(*stats)


def _folded2(g1, b1, g2, b2, stats: Edge2Stats):
    return (_stack_stats(stats.m1, stats.v1, g1, b1),
            _stack_stats(stats.m2, stats.v2, g2, b2))


def fused_edge2_eval(q, off, idx, w2, g1, b1, g2, b2, stats: Edge2Stats,
                     slope: float = 0.2) -> torch.Tensor:
    """Eval-mode two-layer EdgeConv from a given neighbour index → ``out
    [B, M, C2]`` (``fused_edge2_eval``, ``fused_edge.py:874``); ``q`` is
    rounded to bf16 here, as the JAX function does."""
    st1, st2 = _folded2(g1, b1, g2, b2, stats)
    return edge2_eval(q.bfloat16(), off.float(), idx.int(), st1, st2, w2,
                      slope)


def fused_edge2_eval_knn(x, q, off, w2, g1, b1, g2, b2, stats: Edge2Stats,
                         k: int, slope: float = 0.2) -> torch.Tensor:
    """Eval-mode two-layer EdgeConv with the graph built inside → ``out
    [B, N, C2]`` (``fused_edge2_eval_knn``, ``fused_edge.py:1033``)."""
    st1, st2 = _folded2(g1, b1, g2, b2, stats)
    return edge2_knn_eval(x.float(), q.bfloat16(), off.float(), st1, st2,
                          w2, k, slope)
