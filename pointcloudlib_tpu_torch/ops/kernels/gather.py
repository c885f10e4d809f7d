"""Row gather and row scatter-add: the CUDA kernels
``csrc/gather_rows.cu`` and ``csrc/scatter_rows.cu`` and their plain
versions.

Replace the TPU kernels of ``pointcloudlib_tpu/ops/pallas/gather.py``:
``gather_neighbors`` → ``_gather_fwd_impl`` → ``_gather_kernel`` (the row
gather, exact copies here) and ``scatter_rows`` → ``_gather_bwd_impl`` →
``_scatter_kernel`` (its backward, and that of every fused gather).
:class:`GatherNeighbors` is the differentiable gather;
``geometry.gather_points`` routes to it behind the JAX package's cost
gate.
"""

from __future__ import annotations

import ctypes

import torch

from pointcloudlib_tpu_torch.ops.kernels import _build


# The scatter-add's narrow route keeps a copy of out[b] in each block's
# shared memory. It takes rows the wide route cannot add as 16-byte units
# (C % 4 != 0) where out[b] (n·C·4 bytes) is at most this; the rest take
# the wide route (global atomics into a zeroed out). Measured on an H100
# at 16,384 rows a batch (tools/kernel_variants.py --only rows), the
# narrow route wins up to 32 KB at C = 1 and 3, up to 16 KB at C = 6, and
# nowhere at C = 4 or 12.
SCATTER_NARROW_BYTES = 16 * 1024
_INT32 = 2 ** 31


def _lib(name: str = "scatter_rows") -> ctypes.CDLL:
    """``csrc/scatter_rows.cu`` or ``csrc/gather_rows.cu``: both launchers
    take ``(a, idx, out, b, rows_per_batch, n, c, narrow, stream)``."""
    lib = _build.load(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check_int32(what: str, rows: int, n: int, c: int) -> None:
    """The kernels index within a batch in 32 bits."""
    if rows * c >= _INT32 or n * c >= _INT32:
        raise ValueError(f"{what}: a batch's rows·C = {rows * c} or N·C = "
                         f"{n * c} reaches 2^31, the kernels' index range")


def gather_route(points: torch.Tensor) -> str:
    """The row gather's route for a contiguous ``points [B, N, C]``:
    ``"wide"`` (one float4 a thread) where C % 4 == 0 and the rows are
    16-byte aligned, else ``"narrow"`` (the batch's cloud staged in shared
    memory where it fits, rows assembled by warps)."""
    return ("wide" if points.shape[-1] % 4 == 0
            and points.data_ptr() % 16 == 0 else "narrow")


def scatter_route(n: int, c: int) -> str:
    """The row scatter-add's route into ``[B, n, C]``: ``"narrow"`` (a
    cluster of blocks a batch, adding in shared memory, every element of
    out written once) where C % 4 != 0 and out[b] fits
    ``SCATTER_NARROW_BYTES``, else ``"wide"`` (atomics into a zeroed
    out)."""
    return ("narrow" if c % 4 and 4 * n * c <= SCATTER_NARROW_BYTES
            else "wide")


def gather_neighbors_plain(points: torch.Tensor, idx: torch.Tensor
                           ) -> torch.Tensor:
    """``points [B, N, C]``, ``idx [B, ...]`` → ``[B, ..., C]`` float32:
    ``points[b, idx[b, ...], :]`` by ``torch.gather``, and a zero row
    where the index lies outside ``[0, N)`` (``gather.py:127-129``)."""
    b, n, c = points.shape
    flat = idx.reshape(b, -1).long()
    keep = (flat >= 0) & (flat < n)
    rows = torch.gather(points.float(), 1,
                        torch.where(keep, flat, 0)[..., None].expand(-1, -1,
                                                                     c))
    return torch.where(keep[..., None], rows, 0.0).reshape(*idx.shape, c)


def gather_neighbors(points: torch.Tensor, idx: torch.Tensor
                     ) -> torch.Tensor:
    """The row gather of :func:`gather_neighbors_plain` for ``points [B,
    N, C]`` float32 and an int ``idx [B, M]`` or ``[B, M, K]``: the kernel
    for CUDA tensors (by :func:`gather_route`; an exact copy,
    bit-identical to the plain version),
    the plain version for CPU tensors. No gradient: see
    :class:`GatherNeighbors`."""
    if points.device.type == "cpu":
        return gather_neighbors_plain(points, idx)
    if points.device.type != "cuda":
        raise ValueError(f"gather_neighbors: unsupported device "
                         f"{points.device}")
    if (points.dim() != 3 or idx.dim() not in (2, 3)
            or idx.shape[0] != points.shape[0]):
        raise ValueError(f"gather_neighbors: points [B, N, C] and idx "
                         f"[B, M] or [B, M, K] expected, got "
                         f"{tuple(points.shape)} and {tuple(idx.shape)}")
    if points.dtype != torch.float32:
        raise TypeError(f"gather_neighbors: points must be float32, got "
                        f"{points.dtype}")
    if idx.device != points.device or idx.dtype not in (torch.int32,
                                                        torch.int64):
        raise ValueError(f"gather_neighbors: idx must be an int tensor on "
                         f"{points.device}, got {idx.dtype} on {idx.device}")
    b, n, c = points.shape
    per_batch = idx[0].numel()
    if b < 1 or n < 1 or c < 1 or per_batch < 1:
        raise ValueError(f"gather_neighbors: empty sizes B={b}, N={n}, "
                         f"C={c}, rows {per_batch}")
    _check_int32("gather_neighbors", per_batch, n, c)
    points = points.contiguous()
    idx = idx.to(torch.int32).contiguous()
    out = torch.empty((*idx.shape, c), dtype=torch.float32,
                      device=points.device)
    narrow = gather_route(points) == "narrow"
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib("gather_rows").gather_rows_launch(
            points.data_ptr(), idx.data_ptr(), out.data_ptr(), b, per_batch,
            n, c, int(narrow), stream)
    _build.check(err, "gather_neighbors")
    gather_neighbors.launches += 1
    return out


gather_neighbors.launches = 0


class GatherNeighbors(torch.autograd.Function):
    """:func:`gather_neighbors` with its gradient to ``points``
    (``gather.py:248-257``): the backward is :func:`scatter_rows` of the
    output gradient at ``idx``, the sentinel rows adding nothing. No
    gradient to ``idx``."""

    @staticmethod
    def forward(ctx, points, idx):
        ctx.save_for_backward(idx)
        ctx.n = points.shape[1]
        return gather_neighbors(points, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return scatter_rows(g, idx, ctx.n), None


def scatter_rows_plain(g: torch.Tensor, idx: torch.Tensor, n: int
                       ) -> torch.Tensor:
    """``out[b, idx[b, m, k]] += g[b, m, k]`` → ``[B, n, C]`` float32 by
    ``index_add_`` over the rows whose index lies in ``[0, n)``; the
    others add nothing."""
    b, c = g.shape[0], g.shape[-1]
    flat = idx.reshape(b, -1).long()
    keep = (flat >= 0) & (flat < n)
    target = flat + n * torch.arange(b, device=g.device)[:, None]
    out = torch.zeros((b * n, c), dtype=torch.float32, device=g.device)
    out.index_add_(0, target[keep], g.reshape(b, -1, c).float()[keep])
    return out.reshape(b, n, c)


def scatter_rows(g: torch.Tensor, idx: torch.Tensor, n: int
                 ) -> torch.Tensor:
    """Scatter-add of the rows of ``g [B, M, K, C]`` into ``[B, n, C]``
    float32 at ``idx [B, M, K]``; an index outside ``[0, n)`` adds
    nothing (``_scatter_xla``'s ``mode="drop"``). The kernel for CUDA
    tensors (by :func:`scatter_route`), the plain version for CPU tensors.
    The kernel adds with f32 atomics, so the last bits change from run to
    run."""
    if g.device.type == "cpu":
        return scatter_rows_plain(g, idx, n)
    if g.device.type != "cuda":
        raise ValueError(f"scatter_rows: unsupported device {g.device}")
    if g.dim() < 2 or tuple(idx.shape) != tuple(g.shape[:-1]):
        raise ValueError(f"scatter_rows: g [B, ..., C] and idx [B, ...] "
                         f"expected, got {tuple(g.shape)} and "
                         f"{tuple(idx.shape)}")
    if idx.device != g.device:
        raise ValueError(f"scatter_rows: g on {g.device}, idx on "
                         f"{idx.device}")
    b, c = g.shape[0], g.shape[-1]
    per_batch = idx[0].numel()
    if b < 1 or per_batch < 1 or n < 1 or c < 1:
        raise ValueError(f"scatter_rows: empty sizes B={b}, rows "
                         f"{per_batch}, n={n}, C={c}")
    _check_int32("scatter_rows", per_batch, n, c)
    g = g.float().contiguous()
    idx = idx.to(torch.int32).contiguous()
    # the narrow route writes every element of out; the wide one adds
    narrow = scatter_route(n, c) == "narrow"
    out = (torch.empty if narrow else torch.zeros)(
        (b, n, c), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().scatter_rows_launch(g.data_ptr(), idx.data_ptr(),
                                         out.data_ptr(), b, per_batch, n, c,
                                         int(narrow), stream)
    _build.check(err, "scatter_rows")
    scatter_rows.launches += 1
    return out


scatter_rows.launches = 0
