"""3-NN inverse-distance interpolation: the CUDA kernel
``csrc/three_interp.cu``, its plain version and the autograd function of
the feature-propagation decoders.

Replaces the TPU kernel ``pointcloudlib_tpu/ops/pallas/neighbors.py``
(``_three_interp_fwd_call`` → ``_k_three_interp``, with the custom VJP of
``three_interp``). The kernel's ``idx`` is bit-identical to the plain
version's; ``w`` and ``out`` take the same round-to-nearest operations in
the same order.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pointcloudlib_tpu_torch.ops import geometry
from pointcloudlib_tpu_torch.ops.kernels import _build
from pointcloudlib_tpu_torch.ops.kernels.gather import scatter_rows

# largest support cloud the kernel stages in shared memory (16 bytes a
# point, beside 3 KB of the kernel's own)
MAX_POINTS = 14000
# lanes a query the kernel is compiled for (a block of 256 threads takes
# 256 / G queries)
GROUPS = (2, 4, 8, 16, 32)
# blocks of a grid that fills an H100 (132 SMs): about two an SM
FILL_BLOCKS = 256


def interp_group(b: int, m: int) -> int:
    """Lanes a query for ``b`` clouds of ``m`` queries: the fewest whose
    grid of ``b · ⌈m / (256 / G)⌉`` blocks reaches ``FILL_BLOCKS``, else
    the most. (Timed at every group at the six main-path launches,
    ``tools/kernel_variants.py --only interp``: more lanes a query cost
    merge steps, fewer leave SMs idle.)"""
    for g in GROUPS:
        if b * -(-m // (256 // g)) >= FILL_BLOCKS:
            return g
    return GROUPS[-1]


def _lib() -> ctypes.CDLL:
    lib = _build.load("three_interp")
    fn = lib.three_interp_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def three_interp_plain(query: torch.Tensor, points: torch.Tensor,
                       feats: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(out [B, M, C], idx [B, M, 3] int32, w [B, M, 3])``:
    ``geometry.three_nn``, then ``out = (w_0 f_0 + w_1 f_1) + w_2 f_2``."""
    idx, w = geometry.three_nn(query, points)
    g = geometry.index_points(feats.float(), idx)          # [B, M, 3, C]
    w3 = w[..., None]
    out = (w3[:, :, 0] * g[:, :, 0] + w3[:, :, 1] * g[:, :, 1]) \
        + w3[:, :, 2] * g[:, :, 2]
    return out, idx, w


def three_interp_fwd(query: torch.Tensor, points: torch.Tensor,
                     feats: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three outputs of ``_k_three_interp`` for ``query [B, M, 3]``,
    ``points [B, N, 3]`` and ``feats [B, N, C]``: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if points.device.type == "cpu":
        return three_interp_plain(query, points, feats)
    if points.device.type != "cuda":
        raise ValueError(f"three_interp: unsupported device {points.device}")
    if (query.dim() != 3 or points.dim() != 3 or feats.dim() != 3
            or query.shape[-1] != 3 or points.shape[-1] != 3
            or query.shape[0] != points.shape[0]
            or feats.shape[:2] != points.shape[:2]):
        raise ValueError(
            f"three_interp: query [B, M, 3], points [B, N, 3] and feats "
            f"[B, N, C] expected, got {tuple(query.shape)}, "
            f"{tuple(points.shape)} and {tuple(feats.shape)}")
    if not (query.device == points.device == feats.device):
        raise ValueError(f"three_interp: query on {query.device}, points on "
                         f"{points.device}, feats on {feats.device}")
    b, n, c = feats.shape
    m = query.shape[1]
    if not 3 <= n <= MAX_POINTS or m < 1 or c < 1:
        raise ValueError(f"three_interp: need 3 <= N <= {MAX_POINTS}, "
                         f"M >= 1 and C >= 1, got N={n}, M={m}, C={c}")
    query = query.float().contiguous()
    points = points.float().contiguous()
    feats = feats.float().contiguous()
    dev = points.device
    out = torch.empty((b, m, c), dtype=torch.float32, device=dev)
    idx = torch.empty((b, m, 3), dtype=torch.int32, device=dev)
    w = torch.empty((b, m, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().three_interp_launch(
            query.data_ptr(), points.data_ptr(), feats.data_ptr(),
            out.data_ptr(), idx.data_ptr(), w.data_ptr(), b, n, m, c,
            interp_group(b, m), stream)
    _build.check(err, "three_interp")
    three_interp_fwd.launches += 1
    return out, idx, w


three_interp_fwd.launches = 0


class ThreeInterp(torch.autograd.Function):
    """``three_interp`` with its gradient to ``feats`` (the custom VJP of
    ``neighbors.py:577-594``): forward ``three_interp_fwd``, saving
    ``idx`` and ``w``; backward ``dg = w·dout`` per slot as a tensor op,
    then ``scatter_rows(dg, idx, N)``. The selection is discrete: no
    gradient to ``query`` or ``points``."""

    @staticmethod
    def forward(ctx, query, points, feats):
        out, idx, w = three_interp_fwd(query, points, feats)
        ctx.save_for_backward(idx, w)
        ctx.n = points.shape[1]
        return out

    @staticmethod
    def backward(ctx, dout):
        idx, w = ctx.saved_tensors
        dg = w[..., None] * dout[:, :, None, :]              # [B, M, 3, C]
        return None, None, scatter_rows(dg, idx, ctx.n)
