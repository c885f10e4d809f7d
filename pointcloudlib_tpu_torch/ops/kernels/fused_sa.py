"""Eval-mode fused set abstraction: the CUDA kernels
``csrc/fused_sa_bq_eval.cu`` (ball query inside) and
``csrc/fused_sa_eval.cu`` (from a given neighbour index), and their plain
versions.

Replaces the TPU kernels of ``pointcloudlib_tpu/ops/pallas/fused_sa.py``
``fused_sa_bq_eval`` → ``_k_bqeval`` and ``fused_sa_eval`` →
``_fused_sa_eval_jit`` → ``_k_eval``. The layer's first Dense is folded
outside the kernels into ``q = [xyz‖f]·W1`` (bf16) and
``off = new_xyz·W1[:3]``, so the grouped first-layer pre-activation is
``h1 = q[idx] − off``; a kernel runs (ball query,) gather, the
BN→ReLU→Dense chain and the max over neighbours without writing any
grouped tensor to device memory.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from pointcloudlib_tpu_torch.ops import geometry
from pointcloudlib_tpu_torch.ops.kernels import _build

_EPS = 1e-5  # BatchNorm epsilon (nn/layers.py DenseBNAct)

_SMEM_LIMIT = 227 * 1024  # shared memory one block may use on Hopper

# (C1, C2, C3) the eval kernels are compiled for (csrc/fused_sa_eval.cuh)
EVAL_WIDTHS = ((32, 32, 64), (64, 64, 128), (64, 96, 128), (128, 128, 256))


class SAParams(NamedTuple):
    """Learned parameters of the fused 3-layer SA MLP (no Dense biases;
    W1 lives outside, folded into q and off)."""

    w2: torch.Tensor  # [C1, C2]
    w3: torch.Tensor  # [C2, C3]
    g1: torch.Tensor  # BN scale / offset per layer
    b1: torch.Tensor
    g2: torch.Tensor
    b2: torch.Tensor
    g3: torch.Tensor
    b3: torch.Tensor


class SAStats(NamedTuple):
    """Per-layer BatchNorm running statistics (biased variance)."""

    m1: torch.Tensor
    v1: torch.Tensor
    m2: torch.Tensor
    v2: torch.Tensor
    m3: torch.Tensor
    v3: torch.Tensor


def _stack_stats(mu, var, gam, bet) -> torch.Tensor:
    """Fold BN into ``[4, C]`` rows ``(sc, bi, rs, mrs)``:
    ``rs = rsqrt(var + 1e-5)``, ``sc = γ·rs``, ``bi = β − μ·sc``,
    ``mrs = μ·rs`` (``fused_sa.py:1431``)."""
    rs = torch.rsqrt(var + _EPS)
    sc = gam * rs
    bi = bet - mu * sc
    return torch.stack([sc, bi, rs, mu * rs]).float()


def _folded(params: SAParams, stats: SAStats):
    return (_stack_stats(stats.m1, stats.v1, params.g1, params.b1),
            _stack_stats(stats.m2, stats.v2, params.g2, params.b2),
            _stack_stats(stats.m3, stats.v3, params.g3, params.b3))


def _bf16_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 operands, f32 accumulation: exact products in f32 (TF32 is
    off package-wide)."""
    return a.bfloat16().float() @ b.bfloat16().float()


def _chain(h1: torch.Tensor, st, w2, w3) -> torch.Tensor:
    st1, st2, st3 = st
    y1 = torch.clamp_min(h1 * st1[0] + st1[1], 0.0)
    y2 = torch.clamp_min(_bf16_mm(y1, w2) * st2[0] + st2[1], 0.0)
    return torch.clamp_min(_bf16_mm(y2, w3) * st3[0] + st3[1], 0.0)


def fused_sa_bq_eval_plain(new_xyz, pts, q, off, params: SAParams,
                           stats: SAStats, radius: float, k: int
                           ) -> torch.Tensor:
    """The eval semantics of ``_k_bqeval`` written out: ball query,
    gather ``float(bf16 q)[idx] − off``, the chain per slot, then the
    max over live slots (slot < cnt; a cnt==0 row keeps slot 0, whose
    index is the fallback point 0)."""
    idx, cnt = geometry.ball_query(new_xyz, pts, radius, k)
    h1 = geometry.index_points(q.bfloat16().float(), idx) - off[:, :, None]
    y3 = _chain(h1, _folded(params, stats), params.w2, params.w3)
    slot = torch.arange(k, device=cnt.device)
    live = slot < torch.clamp_min(cnt, 1)[..., None]
    return torch.where(live[..., None], y3, float("-inf")).amax(dim=2)


def fused_sa_eval_plain(q, off, idx, params: SAParams, stats: SAStats,
                        cnt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The eval semantics of ``_k_eval`` written out: gather
    ``float(bf16 q)[idx] − off``, the chain per slot, the max over all k
    slots. ``cnt`` changes nothing: the slots past it repeat slot 0."""
    h1 = geometry.index_points(q.bfloat16().float(), idx) - off[:, :, None]
    return _chain(h1, _folded(params, stats), params.w2,
                  params.w3).amax(dim=2)


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_sa_bq_eval")
    fn = lib.sa_bq_eval_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.sa_bq_eval_smem.argtypes = [ctypes.c_int] * 5
        lib.sa_bq_eval_smem.restype = ctypes.c_longlong
    return lib


def _lib_idx() -> ctypes.CDLL:
    lib = _build.load("fused_sa_eval")
    fn = lib.sa_eval_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.sa_eval_smem.argtypes = [ctypes.c_int] * 4
        lib.sa_eval_smem.restype = ctypes.c_longlong
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _eval_operands(params: SAParams, stats: SAStats):
    """``(st, w2, w3)`` as the eval kernels take them: the folded BN rows
    in one float32 vector, ``sc`` of the three layers, then ``bi``
    (``_stack_stats``' arithmetic element by element, on the three layers
    at once: a served batch is host-bound, and this launches 10
    operations where a fold a layer launches 25), the weights in bf16."""
    mu = torch.cat([stats.m1, stats.m2, stats.m3])
    var = torch.cat([stats.v1, stats.v2, stats.v3])
    gam = torch.cat([params.g1, params.g2, params.g3])
    bet = torch.cat([params.b1, params.b2, params.b3])
    sc = gam * torch.rsqrt(var + _EPS)
    st = torch.cat([sc, bet - mu * sc]).float()
    return (_aligned(st), _aligned(params.w2.bfloat16()),
            _aligned(params.w3.bfloat16()))


def fused_sa_bq_eval(new_xyz, pts, q, off, params: SAParams,
                     stats: SAStats, radius: float, k: int) -> torch.Tensor:
    """Eval-mode fused SA → ``[B, M, C3]`` float32.

    ``new_xyz [B, M, 3]`` and ``pts [B, N, 3]`` float32, ``q [B, N, C1]``
    bfloat16, ``off [B, M, C1]`` float32. The kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return fused_sa_bq_eval_plain(new_xyz, pts, q, off, params, stats,
                                      radius, k)
    if q.device.type != "cuda":
        raise ValueError(f"fused_sa_bq_eval: unsupported device {q.device}")
    b, n, c1 = q.shape
    m = new_xyz.shape[1]
    widths = (c1, params.w2.shape[1], params.w3.shape[1])
    if q.dtype != torch.bfloat16:
        raise TypeError(f"fused_sa_bq_eval: q must be bfloat16, got {q.dtype}")
    for name, t, shape in (("new_xyz", new_xyz, (b, m, 3)),
                           ("pts", pts, (b, n, 3)),
                           ("off", off, (b, m, c1))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"fused_sa_bq_eval: {name} must be float32 "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"fused_sa_bq_eval: {name} on {t.device}, "
                             f"q on {q.device}")
    lib = _lib()
    smem = lib.sa_bq_eval_smem(n, *widths, k)
    if smem == 0:
        raise ValueError(f"fused_sa_bq_eval: no kernel instance for widths "
                         f"{widths}")
    if smem > _SMEM_LIMIT:
        raise ValueError(f"fused_sa_bq_eval: N={n}, k={k} need {smem} bytes "
                         f"of shared memory, above one block's {_SMEM_LIMIT}")
    st, w2, w3 = _eval_operands(params, stats)
    new_xyz, pts, q, off = map(_aligned, (new_xyz, pts, q, off))
    out = torch.empty((b, m, widths[2]), dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sa_bq_eval_launch(
            new_xyz.data_ptr(), pts.data_ptr(), q.data_ptr(), off.data_ptr(),
            st.data_ptr(), w2.data_ptr(), w3.data_ptr(), out.data_ptr(),
            b, n, m, *widths, k, radius * radius, stream)
    _build.check(err, "fused_sa_bq_eval")
    fused_sa_bq_eval.launches += 1
    return out


fused_sa_bq_eval.launches = 0


def fused_sa_eval(q, off, idx, params: SAParams, stats: SAStats,
                  cnt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eval-mode fused SA from a given neighbour index → ``[B, M, C3]``
    float32.

    ``q [B, N, C1]`` bfloat16, ``off [B, M, C1]`` float32, ``idx
    [B, M, k]`` int32 with every entry in ``[0, N)`` and, optionally, the
    ball query's ``cnt [B, M]`` int32: the kernel then runs only the
    first ``max(min(cnt, k), 1)`` slots of a center (the rest repeat slot
    0 and cannot raise the max). The kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if q.device.type == "cpu":
        return fused_sa_eval_plain(q, off, idx, params, stats, cnt)
    if q.device.type != "cuda":
        raise ValueError(f"fused_sa_eval: unsupported device {q.device}")
    b, n, c1 = q.shape
    _, m, k = idx.shape
    widths = (c1, params.w2.shape[1], params.w3.shape[1])
    if widths not in EVAL_WIDTHS:
        raise ValueError(f"fused_sa_eval: no kernel instance for widths "
                         f"{widths}; compiled: {EVAL_WIDTHS}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"fused_sa_eval: q must be bfloat16, got {q.dtype}")
    checks = [("off", off, (b, m, c1), torch.float32),
              ("idx", idx, (b, m, k), torch.int32)]
    if cnt is not None:
        checks.append(("cnt", cnt, (b, m), torch.int32))
    for name, t, shape, dtype in checks:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"fused_sa_eval: {name} must be {dtype} "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"fused_sa_eval: {name} on {t.device}, q on "
                             f"{q.device}")
    lib = _lib_idx()
    smem = lib.sa_eval_smem(*widths, k)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"fused_sa_eval: k={k} needs {smem} bytes of shared "
                         f"memory, above one block's {_SMEM_LIMIT}")
    st, w2, w3 = _eval_operands(params, stats)
    q, off, idx = map(_aligned, (q, off, idx))
    cnt_ptr = None if cnt is None else _aligned(cnt).data_ptr()
    out = torch.empty((b, m, widths[2]), dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sa_eval_launch(
            q.data_ptr(), off.data_ptr(), idx.data_ptr(), cnt_ptr,
            st.data_ptr(), w2.data_ptr(), w3.data_ptr(), out.data_ptr(),
            b, n, m, *widths, k, stream)
    _build.check(err, "fused_sa_eval")
    fused_sa_eval.launches += 1
    return out


fused_sa_eval.launches = 0
