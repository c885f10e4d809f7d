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
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from pointcloudlib_tpu_torch.ops import geometry
from pointcloudlib_tpu_torch.ops.kernels import _build
from pointcloudlib_tpu_torch.ops.kernels.fused_sa import (
    _SMEM_LIMIT,
    _aligned,
    _stack_stats,
)
from pointcloudlib_tpu_torch.ops.kernels.fused_sa_train import (
    _bf,
    _expect,
    _moments,
    _on_card,
    _stream,
    _sums,
    _xhat,
    _z,
)
from pointcloudlib_tpu_torch.ops.kernels.knn import MAX_K


class EdgeStats(NamedTuple):
    """BatchNorm statistics of one EdgeConv (biased variance)."""

    mean: torch.Tensor
    var: torch.Tensor


def _leaky(z: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(z > 0, z, slope * z)


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
    z = _z(hf, st)
    y = _leaky(z, slope)
    ties = (y == y.amax(dim=2, keepdim=True)).float()
    da = dout[:, :, None] * ties / ties.sum(dim=2, keepdim=True)
    dz = torch.where(z > 0, da, slope * da)
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
        "edge_knn_eval_launch": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                                 + [ctypes.c_float, ctypes.c_void_p],
                                 ctypes.c_int),
        "edge_knn_eval_smem": ([ctypes.c_int] * 2, ctypes.c_longlong),
    },
    "edge_knn_f1": {
        "edge_knn_f1_launch": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                               + [ctypes.c_void_p], ctypes.c_int),
        "edge_knn_f1_smem": ([ctypes.c_int] * 3, ctypes.c_longlong),
    },
    "edge_eval": {
        "edge_eval_launch": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                             + [ctypes.c_float, ctypes.c_void_p],
                             ctypes.c_int),
        "edge_eval_smem": ([ctypes.c_int], ctypes.c_longlong),
    },
    "edge_f1": {
        "edge_f1_launch": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p], ctypes.c_int),
        "edge_f1_smem": ([ctypes.c_int] * 2, ctypes.c_longlong),
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
    The kernel for CUDA tensors, the plain version for CPU tensors."""
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
    _knn_ok("edge_knn_eval", lib, "edge_knn_eval_smem", n, k, (cin, k))
    dev = q.device
    out = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    x, q, off, st = map(_aligned, (x, q, off, st))
    with torch.cuda.device(dev):
        err = lib.edge_knn_eval_launch(
            x.data_ptr(), q.data_ptr(), off.data_ptr(), st.data_ptr(),
            out.data_ptr(), b, n, cin, c, k, slope, _stream(dev))
    _build.check(err, "edge_knn_eval")
    edge_knn_eval.launches += 1
    return out


edge_knn_eval.launches = 0


def edge_knn_f1(x, q, off, k: int):
    """Forward pass 1 → ``(idx, h, psum)`` as :func:`edge_knn_f1_plain`:
    the kernel for CUDA tensors (``q`` bfloat16), the plain version for
    CPU tensors."""
    if not _on_card("edge_knn_f1", q):
        return edge_knn_f1_plain(x, q, off, k)
    b, n, c = q.shape
    cin = x.shape[-1]
    _width_ok("edge_knn_f1", c)
    _expect("edge_knn_f1", q.device, q=(q, (b, n, c), torch.bfloat16),
            x=(x, (b, n, cin), torch.float32),
            off=(off, (b, n, c), torch.float32))
    lib = _lib("edge_knn_f1")
    _knn_ok("edge_knn_f1", lib, "edge_knn_f1_smem", n, k, (cin, c, k))
    dev = q.device
    idx = torch.empty((b, n, k), dtype=torch.int32, device=dev)
    h = torch.empty((b, n, k, c), dtype=torch.bfloat16, device=dev)
    psum = torch.zeros((2, c), dtype=torch.float32, device=dev)
    x, q, off = map(_aligned, (x, q, off))
    with torch.cuda.device(dev):
        err = lib.edge_knn_f1_launch(
            x.data_ptr(), q.data_ptr(), off.data_ptr(), idx.data_ptr(),
            h.data_ptr(), psum.data_ptr(), b, n, cin, c, k, _stream(dev))
    _build.check(err, "edge_knn_f1")
    edge_knn_f1.launches += 1
    return idx, h, psum


edge_knn_f1.launches = 0


def _given_idx(what: str, q, off, idx, smem: int):
    """``(b, m, n, c, k)`` of a given-index EdgeConv kernel's inputs
    (``q`` bfloat16, ``off`` float32, ``idx`` int32); raise on what the
    kernel does not take."""
    b, n, c = q.shape
    m, k = idx.shape[1:]
    _width_ok(what, c)
    _expect(what, q.device, q=(q, (b, n, c), torch.bfloat16),
            off=(off, (b, m, c), torch.float32),
            idx=(idx, (b, m, k), torch.int32))
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{what}: k={k} needs {smem} bytes of shared "
                         f"memory, above one block's {_SMEM_LIMIT}")
    return b, m, n, c, k


def edge_eval(q, off, idx, st, slope: float = 0.2):
    """Eval-mode EdgeConv from a given index → ``out [B, M, C]`` float32,
    as :func:`edge_eval_plain`. ``q [B, N, C]`` bfloat16, ``off [B, M,
    C]`` float32, ``idx [B, M, k]`` int32 with every entry in ``[0, N)``,
    ``st [4, C]`` the folded BN rows. The kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if not _on_card("edge_eval", q):
        return edge_eval_plain(q, off, idx, st, slope)
    lib = _lib("edge_eval")
    b, m, n, c, k = _given_idx("edge_eval", q, off, idx,
                               lib.edge_eval_smem(idx.shape[-1]))
    _expect("edge_eval", q.device, st=(st, (4, c), torch.float32))
    dev = q.device
    out = torch.empty((b, m, c), dtype=torch.float32, device=dev)
    q, idx, off, st = map(_aligned, (q, idx, off, st))
    with torch.cuda.device(dev):
        err = lib.edge_eval_launch(
            q.data_ptr(), idx.data_ptr(), off.data_ptr(), st.data_ptr(),
            out.data_ptr(), b, m, n, c, k, slope, _stream(dev))
    _build.check(err, "edge_eval")
    edge_eval.launches += 1
    return out


edge_eval.launches = 0


def edge_f1(q, off, idx):
    """Forward pass 1 from a given index → ``(h, psum)`` as
    :func:`edge_f1_plain`: the kernel for CUDA tensors (as
    :func:`edge_eval` takes them), the plain version for CPU tensors."""
    if not _on_card("edge_f1", q):
        return edge_f1_plain(q, off, idx)
    lib = _lib("edge_f1")
    b, m, n, c, k = _given_idx("edge_f1", q, off, idx,
                               lib.edge_f1_smem(q.shape[-1], idx.shape[-1]))
    dev = q.device
    h = torch.empty((b, m, k, c), dtype=torch.bfloat16, device=dev)
    psum = torch.zeros((2, c), dtype=torch.float32, device=dev)
    q, idx, off = map(_aligned, (q, idx, off))
    with torch.cuda.device(dev):
        err = lib.edge_f1_launch(
            q.data_ptr(), idx.data_ptr(), off.data_ptr(), h.data_ptr(),
            psum.data_ptr(), b, m, n, c, k, _stream(dev))
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


def assemble_grads(ps, scat, d1, d2, st, k: int):
    """``(dq, doff, dγ, dβ)`` from the backward pass's sums
    (``_edge_bwd_rule``, ``fused_edge.py:469-480``): the BN backward
    ``dh = sc·(dz − u1 − x̂·u2)`` with ``u = ps / R`` is affine in them, so
    ``dq`` (the scatter of ``dh`` onto the neighbour rows) and ``doff``
    (minus its per-center sum) follow from ``scat``, ``d1`` and ``d2``."""
    b, m, c = d1.shape
    r = float(b * m * k)
    sc = st[0]
    u1 = ps[0] / r
    u2 = ps[1] / r
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
    ``dq`` comes back float32; the graph carries no gradient."""

    @staticmethod
    def _tail(ctx, idx, h, psum, gamma, beta, slope):
        b, m, k, _ = h.shape
        mean, var = _moments(psum, float(b * m * k))
        st = _stack_stats(mean, var, gamma, beta)
        out = edge_out(h, st, slope)
        ctx.save_for_backward(idx, h, st)
        ctx.slope = slope
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def _grads(ctx, dout):
        """``(dq, doff, dγ, dβ)``."""
        idx, h, st = ctx.saved_tensors
        sums = edge_bwd(h, dout.float().contiguous(), idx, st, ctx.slope,
                        h.shape[1])
        return assemble_grads(*sums, st, h.shape[2])


class FusedEdgeKnnTrain(_EdgeTrain):
    """Train-mode EdgeConv with the graph built inside
    (``fused_edge_conv_knn`` and its custom VJP). Inputs ``x [B,N,Cin]``,
    ``q [B,N,C]`` and ``off [B,N,C]`` float32, ``gamma``/``beta [C]``, k
    and the LeakyReLU slope. Returns ``out [B,N,C]`` and the batch mean and
    biased variance over all B·N·k edges (not differentiable). ``x`` gets
    no gradient here, and reaches its gradient through ``q`` and ``off``,
    computed from it outside."""

    @staticmethod
    def forward(ctx, x, q, off, gamma, beta, k, slope):
        idx, h, psum = edge_knn_f1(x.detach().float(), q.bfloat16(),
                                   off.float(), k)
        return _EdgeTrain._tail(ctx, idx, h, psum, gamma, beta, slope)

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        return (None, *_EdgeTrain._grads(ctx, dout), None, None)


class FusedEdgeTrain(_EdgeTrain):
    """Train-mode EdgeConv from a given self-kNN index ``idx [B,N,k]``
    (``fused_edge_conv`` and its custom VJP): inputs ``q``, ``off``,
    ``idx``, ``gamma``, ``beta``, the slope; returns as
    :class:`FusedEdgeKnnTrain`."""

    @staticmethod
    def forward(ctx, q, off, idx, gamma, beta, slope):
        idx = idx.int()
        h, psum = edge_f1(q.bfloat16(), off.float(), idx)
        return _EdgeTrain._tail(ctx, idx, h, psum, gamma, beta, slope)

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        dq, doff, dgamma, dbeta = _EdgeTrain._grads(ctx, dout)
        return dq, doff, None, dgamma, dbeta, None


def fused_edge_conv_knn(x, q, off, gamma, beta, k: int, slope: float = 0.2
                        ) -> Tuple[torch.Tensor, EdgeStats]:
    """``(out [B, N, C], EdgeStats)`` of the train-mode EdgeConv with the
    graph built inside (``fused_edge_conv_knn``, ``fused_edge.py:487``),
    with its hand-written backward."""
    out, mean, var = FusedEdgeKnnTrain.apply(x, q, off, gamma, beta, k,
                                             slope)
    return out, EdgeStats(mean, var)


def fused_edge_conv(q, off, idx, gamma, beta, slope: float = 0.2
                    ) -> Tuple[torch.Tensor, EdgeStats]:
    """``(out [B, N, C], EdgeStats)`` of the train-mode EdgeConv from a
    given self-kNN index (``fused_edge_conv``, ``fused_edge.py:387``), with
    its hand-written backward."""
    out, mean, var = FusedEdgeTrain.apply(q, off, idx, gamma, beta, slope)
    return out, EdgeStats(mean, var)
