"""Row scatter-add: the CUDA kernel ``csrc/scatter_rows.cu`` and its
plain version.

Replaces the TPU kernel ``pointcloudlib_tpu/ops/pallas/gather.py``
(``scatter_rows`` → ``_gather_bwd_impl`` → ``_scatter_kernel``), the
backward pass of the row gathers. The gather itself (``_gather_kernel``)
is not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from pointcloudlib_tpu_torch.ops.kernels import _build


def _lib() -> ctypes.CDLL:
    lib = _build.load("scatter_rows")
    fn = lib.scatter_rows_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


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
    tensors, the plain version for CPU tensors. The kernel adds with f32
    atomics, so the last bits change from run to run."""
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
    g = g.float().contiguous()
    idx = idx.to(torch.int32).contiguous()
    out = torch.zeros((b, n, c), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().scatter_rows_launch(g.data_ptr(), idx.data_ptr(),
                                         out.data_ptr(), b, per_batch, n, c,
                                         stream)
    _build.check(err, "scatter_rows")
    scatter_rows.launches += 1
    return out


scatter_rows.launches = 0
