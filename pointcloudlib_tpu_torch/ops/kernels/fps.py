"""Farthest-point sampling: the CUDA kernel ``csrc/fps.cu`` and its plain
version.

Replaces the TPU kernel ``pointcloudlib_tpu/ops/pallas/fps.py``
(``fps_pallas`` → ``_fps_kernel``). The plain version is
``geometry.farthest_point_sample``; the kernel's indices are
bit-identical to it.
"""

from __future__ import annotations

import ctypes

import torch

from pointcloudlib_tpu_torch.ops import geometry
from pointcloudlib_tpu_torch.ops.kernels import _build

# largest cloud the kernel stages in shared memory (12 bytes a point)
MAX_POINTS = 16384


def _lib() -> ctypes.CDLL:
    lib = _build.load("fps")
    fn = lib.fps_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


fps_plain = geometry.farthest_point_sample


def fps(xyz: torch.Tensor, n_samples: int,
        skip_near_origin: bool = True) -> torch.Tensor:
    """FPS indices ``[B, n_samples] int32`` for ``xyz [B, N, 3]``: the
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if xyz.device.type == "cpu":
        return fps_plain(xyz, n_samples, skip_near_origin)
    if xyz.device.type != "cuda":
        raise ValueError(f"fps: unsupported device {xyz.device}")
    if xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"fps: xyz must be [B, N, 3], got {tuple(xyz.shape)}")
    b, n, _ = xyz.shape
    if not 1 <= n <= MAX_POINTS or n_samples < 1:
        raise ValueError(f"fps: need 1 <= N <= {MAX_POINTS} and "
                         f"n_samples >= 1, got N={n}, m={n_samples}")
    xyz = xyz.float().contiguous()
    out = torch.empty((b, n_samples), dtype=torch.int32, device=xyz.device)
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().fps_launch(xyz.data_ptr(), out.data_ptr(), b, n,
                                n_samples, int(skip_near_origin), stream)
    _build.check(err, "fps")
    fps.launches += 1
    return out


fps.launches = 0
