"""Train-mode fused set abstraction: the CUDA kernels of
``csrc/fused_sa_bq_f1.cu``, ``fused_sa_f1.cu``, ``fused_sa_tail.cu``,
``fused_sa_bwd_p1.cu`` and ``fused_sa_bwd_p2.cu``, their plain versions,
and the two ``torch.autograd.Function``s that chain them.

Replaces ``pointcloudlib_tpu/ops/pallas/fused_sa.py``
``fused_sa_bq_train`` and ``fused_sa_train`` and their custom VJPs.
Forward pass 1 is ``_k_bqf1`` (ball query inside) or ``_k_f1`` (from a
given neighbour index): gather, bf16 h1 checkpoint, Σ/Σ² of h1. From
there the two routes are the same code: ``_k_stats2``, ``_k_stats3`` and
``_k_out`` (``fused_sa_tail.cu``, one wrapper: stage 2 on CUDA cores,
stages 3 and 4 on the tensor cores), then ``_k_p1`` and ``_k_p2`` in the
backward. Between the kernels, plain tensor ops do what the JAX
package leaves to XLA: the BN moments, the folded BN rows
(``_stack_stats``), ``_combine_p1`` and the affine assembly of ``dq`` and
``doff``.

Grouped rows are ``[B, M, k, C]``, every one of the k slots counted in
the BN statistics (repeat-first padding included). The BN rows are
folded as ``(sc, bi, rs, mrs)``: ``z = h·sc + bi``, ``x̂ = h·rs − mrs``.
Products take bf16 operands with f32 sums; h1 is checkpointed in bf16,
its statistics taken before the rounding (``fused_sa.py:1957-1960``).

Data parallelism (sync-BN, the JAX functions' ``axis_name`` / ``world``):
given a group of more than one rank, the forward sums pass 1's ``p1``
and tail stages 2 and 3 over the ranks before each moment, over ``R =
B·M·k·W`` rows; the backward sums pass 1's ``ps3``, ``vecs`` and
``mats`` before the BN2 sums and ``ps1`` before dq and doff
(``fused_sa.py:1332-1341,1741,1760,1879``). The parameter gradients stay
this rank's partials, taken against the global u-terms
(``fused_sa.py:1893-1910``), so that the step's sum over the ranks counts
each row once. The JAX package's slot-capped variants need every shard
on one branch (``_maxcnt_pred``'s ``pmax``, ``:1589``); the kernels here
run every slot and have no such branch.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from pointcloudlib_tpu_torch.ops import geometry
from pointcloudlib_tpu_torch.ops.kernels import _build
from pointcloudlib_tpu_torch.ops.kernels.fused_sa import (
    _EPS,
    _SMEM_LIMIT,
    EVAL_WIDTHS,
    SAParams,
    SAStats,
    _aligned,
    _bf16_mm,
    _stack_stats,
)
from pointcloudlib_tpu_torch.parallel.mesh import (
    DPGroup,
    all_reduce_sums,
    summed,
    synced,
    world_of,
)

_TILE_ROWS = 64  # grouped rows per kernel tile; k divides it or is a multiple
_WIDTHS = EVAL_WIDTHS  # (C1, C2, C3) compiled (csrc/fused_sa_common.cuh)
_F1_WIDTHS = (32, 64, 128)  # C1 the two pass-1 kernels are compiled for

# ---------------------------------------------------------------- plain


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def _z(h, st):
    return h * st[0] + st[1]


def _xhat(h, st):
    return h * st[2] - st[3]


def _sums(h: torch.Tensor) -> torch.Tensor:
    """``[Σh, Σh²]`` over every row of ``[..., C]`` → ``[2, C]``."""
    flat = h.reshape(-1, h.shape[-1])
    return torch.stack([flat.sum(0), (flat * flat).sum(0)])


def _chain(h1f, st1, st2, w2, w3):
    """``(y1, z1, h2, z2, y2, h3)`` recomputed from the f32 view of h1."""
    z1 = _z(h1f, st1)
    y1 = torch.relu(z1)
    h2 = _bf16_mm(y1, w2)
    z2 = _z(h2, st2)
    y2 = torch.relu(z2)
    return y1, z1, h2, z2, y2, _bf16_mm(y2, w3)


def _maxpool_dz(h3, dout, st3):
    """Gradient at z3 of ``max_k relu(z3)``: split evenly among the slots
    that reach the max, replicas included, then ``z3 > 0``
    (``_maxpool_dz``, ``fused_sa.py:305``)."""
    z = _z(h3, st3)
    y = torch.relu(z)
    ties = (y == y.amax(dim=2, keepdim=True)).float()
    da = dout[:, :, None] * ties / ties.sum(dim=2, keepdim=True)
    return torch.where(z > 0, da, 0.0)


def bq_f1_plain(new_xyz, pts, q, off, radius: float, k: int):
    """``(idx [B,M,k] i32, h1 [B,M,k,C1] bf16, cnt [B,M] i32, psum [2,C1])``
    as ``_k_bqf1`` computes them: ``h1 = bf16(float(bf16 q)[idx] − off)``
    with ``psum`` taken on the f32 h1 before its rounding."""
    idx, cnt = geometry.ball_query(new_xyz, pts, radius, k)
    h1, psum = sa_f1_plain(q, off, idx)
    return idx, h1, cnt, psum


def sa_f1_plain(q, off, idx):
    """``(h1 [B,M,k,C1] bf16, psum [2,C1])`` as ``_k_f1`` computes them
    from a given ``idx``: ``h1 = bf16(float(bf16 q)[idx] − off)`` with
    ``psum`` taken on the f32 h1 before its rounding."""
    h = geometry.index_points(_bf(q), idx) - off[:, :, None]
    return h.bfloat16(), _sums(h)


def sa_tail_plain(stage: int, h1, st1, st2, st3, w2, w3) -> torch.Tensor:
    """Stage 2 → ``[Σh2, Σh2²]``, stage 3 → ``[Σh3, Σh3²]``, stage 4 →
    ``out = max_k relu(BN3(h3))`` ``[B, M, C3]``, recomputed from the
    bf16 h1 (``_k_stats2``, ``_k_stats3``, ``_k_out``)."""
    h2 = _bf16_mm(torch.relu(_z(h1.float(), st1)), w2)
    if stage == 2:
        return _sums(h2)
    h3 = _bf16_mm(torch.relu(_z(h2, st2)), w3)
    if stage == 3:
        return _sums(h3)
    if stage != 4:
        raise ValueError(f"sa_tail: stage must be 2, 3 or 4, got {stage}")
    return torch.relu(_z(h3, st3)).amax(dim=2)


def sa_bwd_p1_plain(h1, dout, st1, st2, st3, w2, w3):
    """``(ps3 [2,C3], vecs [3C2], mats [3C2,2C3])`` of ``_k_p1``:
    ``ps3 = [Σdz3, Σdz3·x̂3]``, ``vecs = Σ[y2‖m2‖m2·x̂2]`` and
    ``mats = bf16[y2‖m2‖m2·x̂2]ᵀ · bf16[dz3‖x̂3]``."""
    _, _, h2, z2, y2, h3 = _chain(h1.float(), st1, st2, w2, w3)
    dz3 = _maxpool_dz(h3, dout, st3)
    xh3 = _xhat(h3, st3)
    m2 = (z2 > 0).float()
    left = torch.cat([y2, m2, m2 * _xhat(h2, st2)], dim=-1)
    right = torch.cat([dz3, xh3], dim=-1)
    left = left.reshape(-1, left.shape[-1])
    right = right.reshape(-1, right.shape[-1])
    ps3 = torch.stack([dz3.sum((0, 1, 2)), (dz3 * xh3).sum((0, 1, 2))])
    return ps3, left.sum(0), _bf(left).t() @ _bf(right)


def sa_bwd_p2_plain(h1, dout, idx, st1, st2, st3, w2, w3, us3, us2,
                    n: int):
    """``(dw2 [C1,C2], ps1 [2,C1], scat [B,N,2C1+1], d1, d2 [B,M,C1])`` of
    ``_k_p2``, given the pre-divided BN sums ``us3 [2,C3]``, ``us2
    [2,C2]``: ``scat[b, j] = Σ_{rows with idx = j} [bf16 dz1 ‖ bf16 x̂1 ‖
    1]`` (the TPU's transposed one-hot matmul), ``d1``/``d2`` the
    per-center Σ_k of the f32 ``dz1`` and ``x̂1``."""
    b, m, k, c1 = h1.shape
    h1f = h1.float()
    y1, z1, h2, z2, _, h3 = _chain(h1f, st1, st2, w2, w3)
    dz3 = _maxpool_dz(h3, dout, st3)
    dh3 = st3[0] * (dz3 - us3[0] - _xhat(h3, st3) * us3[1])
    dz2 = torch.where(z2 > 0, _bf16_mm(dh3, w3.t()), 0.0)
    dh2 = st2[0] * (dz2 - us2[0] - _xhat(h2, st2) * us2[1])
    dw2 = (_bf(y1).reshape(-1, c1).t()
           @ _bf(dh2).reshape(-1, dh2.shape[-1]))
    dz1 = torch.where(z1 > 0, _bf16_mm(dh2, w2.t()), 0.0)
    xh1 = _xhat(h1f, st1)
    ps1 = torch.stack([dz1.sum((0, 1, 2)), (dz1 * xh1).sum((0, 1, 2))])
    vals = torch.cat([_bf(dz1), _bf(xh1), torch.ones_like(dz1[..., :1])],
                     dim=-1).reshape(b, m * k, 2 * c1 + 1)
    at = idx.reshape(b, m * k, 1).long().expand(-1, -1, 2 * c1 + 1)
    scat = torch.zeros((b, n, 2 * c1 + 1), dtype=torch.float32,
                       device=h1.device).scatter_add_(1, at, vals)
    return dw2, ps1, scat, dz1.sum(2), xh1.sum(2)


def fused_sa_reference_plain(new_xyz, pts, q, off, params: SAParams,
                             radius: float, k: int):
    """:func:`fused_sa_idx_reference_plain` with the ball query in
    front."""
    idx, _ = geometry.ball_query(new_xyz, pts, radius, k)
    return fused_sa_idx_reference_plain(q, off, idx, params)


def fused_sa_idx_reference_plain(q, off, idx, params: SAParams):
    """The train-mode math of the whole layer as differentiable tensor
    ops (``fused_sa_reference``, ``fused_sa.py:1929``): every rounding
    the kernels make, BN statistics over all k slots. Torch autograd over
    it is the oracle for the hand-written backward; ``amax`` splits its
    gradient among ties as ``jnp.max`` does. Returns ``(out [B,M,C3],
    SAStats)``."""
    h1 = geometry.index_points(_bf(q), idx) - off[:, :, None]

    def moments(h):
        flat = h.reshape(-1, h.shape[-1])
        mean = flat.mean(0)
        return mean, torch.clamp_min((flat * flat).mean(0) - mean * mean,
                                     0.0)

    def bn_relu(h, stats, gam, bet):
        mean, var = stats
        return torch.relu(gam * (h - mean) * torch.rsqrt(var + _EPS) + bet)

    s1 = moments(h1)
    y1 = bn_relu(_bf(h1), s1, params.g1, params.b1)
    h2 = _bf16_mm(y1, params.w2)
    s2 = moments(h2)
    y2 = bn_relu(h2, s2, params.g2, params.b2)
    h3 = _bf16_mm(y2, params.w3)
    s3 = moments(h3)
    out = bn_relu(h3, s3, params.g3, params.b3).amax(dim=2)
    return out, SAStats(s1[0], s1[1], s2[0], s2[1], s3[0], s3[1])


# ------------------------------------------------------------- launchers

_SIGNATURES = {
    "fused_sa_bq_f1": {
        "sa_bq_f1_launch": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                            + [ctypes.c_float, ctypes.c_void_p],
                            ctypes.c_int),
        "sa_bq_f1_smem": ([ctypes.c_int] * 3, ctypes.c_longlong),
    },
    "fused_sa_f1": {
        "sa_f1_launch": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                         + [ctypes.c_void_p], ctypes.c_int),
    },
    "fused_sa_tail": {
        "sa_tail_launch": ([ctypes.c_int] + [ctypes.c_void_p] * 5
                           + [ctypes.c_longlong] + [ctypes.c_int] * 4
                           + [ctypes.c_void_p], ctypes.c_int),
    },
    "fused_sa_bwd_p1": {
        "sa_bwd_p1_launch": ([ctypes.c_void_p] * 10 + [ctypes.c_longlong]
                             + [ctypes.c_int] * 4 + [ctypes.c_void_p],
                             ctypes.c_int),
    },
    "fused_sa_bwd_p2": {
        "sa_bwd_p2_launch": ([ctypes.c_void_p] * 12 + [ctypes.c_longlong]
                             + [ctypes.c_int] * 6 + [ctypes.c_void_p],
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


def _on_card(what: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raise otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return True


def _expect(what: str, dev, **tensors) -> None:
    """Each keyword is ``(tensor, shape, dtype)``: raise on a mismatch."""
    for name, (t, shape, dtype) in tensors.items():
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{what}: {name} must be {dtype} "
                             f"{tuple(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, expected "
                             f"{dev}")


def _rows_ok(what: str, rows: int, k: int, widths) -> None:
    if tuple(widths) not in _WIDTHS:
        raise ValueError(f"{what}: no kernel instance for widths "
                         f"{tuple(widths)}; compiled: {_WIDTHS}")
    if (k < 8 or k % 8 or (_TILE_ROWS % k and k % _TILE_ROWS)
            or rows % _TILE_ROWS):
        raise ValueError(f"{what}: needs k in (8, 16, 32) or a multiple of "
                         f"{_TILE_ROWS}, and B·M·k a multiple of "
                         f"{_TILE_ROWS}, got k={k}, rows={rows}")


def _pack_st(widths, *sts) -> torch.Tensor:
    """``[4, C1] ++ [4, C2] ++ [4, C3]`` folded rows, zeros for a layer
    whose statistics are not known yet."""
    dev = next(s for s in sts if s is not None).device
    parts = [torch.zeros(4 * c, device=dev) if s is None
             else s.float().reshape(-1) for c, s in zip(widths, sts)]
    return _aligned(torch.cat(parts))


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def bq_f1(new_xyz, pts, q, off, radius: float, k: int):
    """Forward pass 1 → ``(idx, h1, cnt, psum)`` as
    :func:`bq_f1_plain`: the kernel for CUDA tensors (``q`` bfloat16),
    the plain version for CPU tensors."""
    if not _on_card("bq_f1", q):
        return bq_f1_plain(new_xyz, pts, q, off, radius, k)
    b, n, c1 = q.shape
    m = new_xyz.shape[1]
    _expect("bq_f1", q.device, q=(q, (b, n, c1), torch.bfloat16),
            new_xyz=(new_xyz, (b, m, 3), torch.float32),
            pts=(pts, (b, n, 3), torch.float32),
            off=(off, (b, m, c1), torch.float32))
    lib = _lib("fused_sa_bq_f1")
    smem = lib.sa_bq_f1_smem(n, c1, k)
    if smem == 0:
        raise ValueError(f"bq_f1: no kernel instance for C1={c1}")
    if smem > _SMEM_LIMIT:
        raise ValueError(f"bq_f1: N={n}, k={k} need {smem} bytes of shared "
                         f"memory, above one block's {_SMEM_LIMIT}")
    dev = q.device
    idx = torch.empty((b, m, k), dtype=torch.int32, device=dev)
    h1 = torch.empty((b, m, k, c1), dtype=torch.bfloat16, device=dev)
    cnt = torch.empty((b, m), dtype=torch.int32, device=dev)
    psum = torch.zeros((2, c1), dtype=torch.float32, device=dev)
    new_xyz, pts, q, off = map(_aligned, (new_xyz, pts, q, off))
    with torch.cuda.device(dev):
        err = lib.sa_bq_f1_launch(
            new_xyz.data_ptr(), pts.data_ptr(), q.data_ptr(), off.data_ptr(),
            idx.data_ptr(), h1.data_ptr(), cnt.data_ptr(), psum.data_ptr(),
            b, n, m, c1, k, radius * radius, _stream(dev))
    _build.check(err, "bq_f1")
    bq_f1.launches += 1
    return idx, h1, cnt, psum


bq_f1.launches = 0


def sa_f1(q, off, idx):
    """Forward pass 1 from a given ``idx`` → ``(h1, psum)`` as
    :func:`sa_f1_plain`: the kernel for CUDA tensors (``q`` bfloat16,
    ``idx`` int32 with every entry in ``[0, N)``), the plain version for
    CPU tensors."""
    if not _on_card("sa_f1", q):
        return sa_f1_plain(q, off, idx)
    b, n, c1 = q.shape
    _, m, k = idx.shape
    if c1 not in _F1_WIDTHS:
        raise ValueError(f"sa_f1: no kernel instance for C1={c1}; "
                         f"compiled: {_F1_WIDTHS}")
    dev = q.device
    _expect("sa_f1", dev, q=(q, (b, n, c1), torch.bfloat16),
            off=(off, (b, m, c1), torch.float32),
            idx=(idx, (b, m, k), torch.int32))
    h1 = torch.empty((b, m, k, c1), dtype=torch.bfloat16, device=dev)
    psum = torch.zeros((2, c1), dtype=torch.float32, device=dev)
    q, off, idx = map(_aligned, (q, off, idx))
    with torch.cuda.device(dev):
        err = _lib("fused_sa_f1").sa_f1_launch(
            q.data_ptr(), off.data_ptr(), idx.data_ptr(), h1.data_ptr(),
            psum.data_ptr(), b, n, m, c1, k, _stream(dev))
    _build.check(err, "sa_f1")
    sa_f1.launches += 1
    return h1, psum


sa_f1.launches = 0


def sa_tail(stage: int, h1, st1, st2: Optional[torch.Tensor],
            st3: Optional[torch.Tensor], w2, w3) -> torch.Tensor:
    """Forward tail ``stage`` (2, 3 or 4) as :func:`sa_tail_plain`; the
    folded BN rows not needed by the stage may be ``None``. The kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if not _on_card("sa_tail", h1):
        return sa_tail_plain(stage, h1, st1, st2, st3, w2, w3)
    if stage not in (2, 3, 4):
        raise ValueError(f"sa_tail: stage must be 2, 3 or 4, got {stage}")
    b, m, k, c1 = h1.shape
    c2, c3 = w2.shape[1], w3.shape[1]
    rows = b * m * k
    _rows_ok("sa_tail", rows, k, (c1, c2, c3))
    _expect("sa_tail", h1.device, h1=(h1, (b, m, k, c1), torch.bfloat16),
            w2=(w2, (c1, c2), w2.dtype), w3=(w3, (c2, c3), w3.dtype))
    dev = h1.device
    h1 = _aligned(h1)
    w2b = _aligned(w2.bfloat16())
    if stage == 2:  # the kernel reads BN1's rows of st and W2 alone
        st, w3b = _aligned(st1.float()), w2b
    else:
        st = _pack_st((c1, c2, c3), st1, st2,
                      st3 if stage == 4 else None)
        w3b = _aligned(w3.bfloat16())
    if stage == 4:
        out = torch.empty((b, m, c3), dtype=torch.float32, device=dev)
    else:
        out = torch.zeros((2, c2 if stage == 2 else c3), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        err = _lib("fused_sa_tail").sa_tail_launch(
            stage, h1.data_ptr(), st.data_ptr(), w2b.data_ptr(),
            w3b.data_ptr(), out.data_ptr(), rows, k, c1, c2, c3,
            _stream(dev))
    _build.check(err, f"sa_tail stage {stage}")
    sa_tail.launches += 1
    sa_tail.launches_by_stage[stage] += 1
    return out


sa_tail.launches = 0
sa_tail.launches_by_stage = {2: 0, 3: 0, 4: 0}  # the three TPU kernels


def sa_bwd_p1(h1, dout, st1, st2, st3, w2, w3):
    """Backward pass 1 → ``(ps3, vecs, mats)`` as
    :func:`sa_bwd_p1_plain`: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if not _on_card("sa_bwd_p1", h1):
        return sa_bwd_p1_plain(h1, dout, st1, st2, st3, w2, w3)
    b, m, k, c1 = h1.shape
    c2, c3 = w2.shape[1], w3.shape[1]
    rows = b * m * k
    _rows_ok("sa_bwd_p1", rows, k, (c1, c2, c3))
    dev = h1.device
    _expect("sa_bwd_p1", dev, h1=(h1, (b, m, k, c1), torch.bfloat16),
            dout=(dout, (b, m, c3), torch.float32))
    st = _pack_st((c1, c2, c3), st1, st2, st3)
    ps3 = torch.zeros((2, c3), dtype=torch.float32, device=dev)
    vecs = torch.zeros(3 * c2, dtype=torch.float32, device=dev)
    mats = torch.zeros((3 * c2, 2 * c3), dtype=torch.float32, device=dev)
    left = torch.empty((rows, 3 * c2), dtype=torch.bfloat16, device=dev)
    right = torch.empty((rows, 2 * c3), dtype=torch.bfloat16, device=dev)
    h1, dout = _aligned(h1), _aligned(dout)
    w2b = _aligned(w2.bfloat16())
    w3b = _aligned(w3.bfloat16())
    with torch.cuda.device(dev):
        err = _lib("fused_sa_bwd_p1").sa_bwd_p1_launch(
            h1.data_ptr(), dout.data_ptr(), st.data_ptr(), w2b.data_ptr(),
            w3b.data_ptr(), ps3.data_ptr(), vecs.data_ptr(), left.data_ptr(),
            right.data_ptr(), mats.data_ptr(), rows, k, c1, c2, c3,
            _stream(dev))
    _build.check(err, "sa_bwd_p1")
    sa_bwd_p1.launches += 1
    return ps3, vecs, mats


sa_bwd_p1.launches = 0


def sa_bwd_p2(h1, dout, idx, st1, st2, st3, w2, w3, us3, us2, n: int):
    """Backward pass 2 → ``(dw2, ps1, scat, d1, d2)`` as
    :func:`sa_bwd_p2_plain`: the kernel for CUDA tensors (``scat`` a view
    of rows padded to 2·C1 + 4 floats), the plain version for CPU
    tensors."""
    if not _on_card("sa_bwd_p2", h1):
        return sa_bwd_p2_plain(h1, dout, idx, st1, st2, st3, w2, w3, us3,
                               us2, n)
    b, m, k, c1 = h1.shape
    c2, c3 = w2.shape[1], w3.shape[1]
    rows = b * m * k
    _rows_ok("sa_bwd_p2", rows, k, (c1, c2, c3))
    dev = h1.device
    _expect("sa_bwd_p2", dev, h1=(h1, (b, m, k, c1), torch.bfloat16),
            dout=(dout, (b, m, c3), torch.float32),
            idx=(idx, (b, m, k), torch.int32),
            us3=(us3, (2, c3), torch.float32),
            us2=(us2, (2, c2), torch.float32))
    st = _pack_st((c1, c2, c3), st1, st2, st3)
    us = _aligned(torch.cat([us3.reshape(-1), us2.reshape(-1)]))
    dw2 = torch.zeros((c1, c2), dtype=torch.float32, device=dev)
    ps1 = torch.zeros((2, c1), dtype=torch.float32, device=dev)
    # rows of 2·C1 + 4 floats: the kernel adds four channels at a time
    scat = torch.zeros((b, n, 2 * c1 + 4), dtype=torch.float32, device=dev)
    d1 = torch.empty((b, m, c1), dtype=torch.float32, device=dev)
    d2 = torch.empty((b, m, c1), dtype=torch.float32, device=dev)
    h1, dout, idx = _aligned(h1), _aligned(dout), _aligned(idx)
    w2b, w3b = _aligned(w2.bfloat16()), _aligned(w3.bfloat16())
    with torch.cuda.device(dev):
        err = _lib("fused_sa_bwd_p2").sa_bwd_p2_launch(
            h1.data_ptr(), dout.data_ptr(), idx.data_ptr(), st.data_ptr(),
            us.data_ptr(), w2b.data_ptr(), w3b.data_ptr(), dw2.data_ptr(),
            ps1.data_ptr(), scat.data_ptr(), d1.data_ptr(), d2.data_ptr(),
            rows, n, m * k, k, c1, c2, c3, _stream(dev))
    _build.check(err, "sa_bwd_p2")
    sa_bwd_p2.launches += 1
    return dw2, ps1, scat[..., :2 * c1 + 1], d1, d2


sa_bwd_p2.launches = 0


# --------------------------------------------------------- the Function


def _moments(psum: torch.Tensor, r: float):
    """Mean and biased variance from ``[Σ, Σ²]`` over r rows."""
    mean = psum[0] / r
    return mean, torch.clamp_min(psum[1] / r - mean * mean, 0.0)


def _combine_p1(ps3, vecs, mats, st3, w3, r: float):
    """``(dw3, s2)`` from pass 1's sums (``_combine_p1``,
    ``fused_sa.py:1736``): dh3 is affine in the BN3 sums, so dW3 and the
    BN2 sums ``s2 = [Σdz2, Σdz2·x̂2]`` follow from row contractions."""
    c2, c3 = w3.shape
    w3 = w3.float()
    sc3 = st3[0]
    u1 = ps3[0] / r
    u2 = ps3[1] / r
    vy2, vm2, vmx = vecs[:c2], vecs[c2:2 * c2], vecs[2 * c2:]
    a3, c3m = mats[:c2, :c3], mats[:c2, c3:]
    e, g = mats[c2:2 * c2, :c3], mats[c2:2 * c2, c3:]
    ep, gp = mats[2 * c2:, :c3], mats[2 * c2:, c3:]
    dw3 = sc3[None, :] * (a3 - vy2[:, None] * u1[None, :]
                          - c3m * u2[None, :])
    w3s = w3 * sc3[None, :]
    s2_1 = ((e - g * u2[None, :]) * w3s).sum(1) - vm2 * (w3s @ u1)
    s2_2 = ((ep - gp * u2[None, :]) * w3s).sum(1) - vmx * (w3s @ u1)
    return dw3, torch.stack([s2_1, s2_2])


def _forward_tail(h1, p1, params: SAParams, group: Optional[DPGroup] = None):
    """The forward after pass 1, shared by the two routes
    (``tail_from``, ``fused_sa.py:1614``): ``(out, SAStats, (st1, st2,
    st3))`` from the bf16 h1 and its ``[Σ, Σ²]``, each sum over every
    rank of ``group``."""
    r = float(h1.shape[0] * h1.shape[1] * h1.shape[2] * world_of(group))
    m1, v1 = _moments(summed(p1, group), r)
    st1 = _stack_stats(m1, v1, params.g1, params.b1)
    m2, v2 = _moments(summed(sa_tail(2, h1, st1, None, None, params.w2,
                                      params.w3), group), r)
    st2 = _stack_stats(m2, v2, params.g2, params.b2)
    m3, v3 = _moments(summed(sa_tail(3, h1, st1, st2, None, params.w2,
                                      params.w3), group), r)
    st3 = _stack_stats(m3, v3, params.g3, params.b3)
    out = sa_tail(4, h1, st1, st2, st3, params.w2, params.w3)
    return out, SAStats(m1, v1, m2, v2, m3, v3), (st1, st2, st3)


def _backward(dout, idx, h1, st1, st2, st3, w2, w3, n: int,
              group: Optional[DPGroup] = None):
    """``(dq, doff, SAParams of gradients)`` (``_fused_train_bwd``,
    ``fused_sa.py:1848``). Over a group: dq and doff of this rank's rows
    from the global sums, the parameter gradients this rank's partials
    against the global u-terms."""
    b, m, k, c1 = h1.shape
    r = float(b * m * k * world_of(group))
    ps3, vecs, mats = sa_bwd_p1(h1, dout, st1, st2, st3, w2, w3)
    ps3_g, vecs_g, mats_g = all_reduce_sums([ps3, vecs, mats], group)
    # dW3 and the BN2 parameters' sums from this rank's rows
    dw3, s2 = _combine_p1(ps3_g, vecs, mats, st3, w3, r)
    s2_g = (_combine_p1(ps3_g, vecs_g, mats_g, st3, w3, r)[1]
            if synced(group) else s2)
    dw2, ps1, scat, d1, d2 = sa_bwd_p2(h1, dout, idx, st1, st2, st3, w2, w3,
                                       ps3_g / r, s2_g / r, n)
    ps1_g = summed(ps1, group)
    sc1 = st1[0]
    u1 = ps1_g[0] / r
    u2 = ps1_g[1] / r
    dq = sc1 * (scat[..., :c1] - scat[..., 2 * c1:] * u1
                - scat[..., c1:2 * c1] * u2)
    doff = -sc1 * (d1 - float(k) * u1 - d2 * u2)
    grads = SAParams(w2=dw2, w3=dw3, g1=ps1[1], b1=ps1[0], g2=s2[1],
                     b2=s2[0], g3=ps3[1], b3=ps3[0])
    return dq, doff, grads


class _FusedSAFunction(torch.autograd.Function):
    """What the two routes share: after pass 1 the forward tails, and the
    whole backward. A subclass's ``forward`` calls :meth:`finish`."""

    @staticmethod
    def finish(ctx, idx, h1, p1, params: SAParams, n: int,
               group: Optional[DPGroup]):
        out, stats, (st1, st2, st3) = _forward_tail(h1, p1, params, group)
        ctx.save_for_backward(idx, h1, st1, st2, st3, params.w2, params.w3)
        ctx.n, ctx.group = n, group
        ctx.mark_non_differentiable(*stats)
        return (out, *stats)

    @staticmethod
    def grads(ctx, dout):
        """``(dq, doff, *SAParams gradients)``."""
        idx, h1, st1, st2, st3, w2, w3 = ctx.saved_tensors
        dq, doff, g = _backward(dout.float().contiguous(), idx, h1, st1, st2,
                                st3, w2, w3, ctx.n, ctx.group)
        return (dq, doff, *g)


class FusedSABqTrain(_FusedSAFunction):
    """Train-mode fused SA with the ball query inside. Inputs
    ``new_xyz [B,M,3]``, ``pts [B,N,3]``, ``q [B,N,C1]`` and ``off
    [B,M,C1]`` float32, then the eight :class:`SAParams` tensors, the
    radius, k and the data-parallel group (or ``None``). Returns ``out
    [B,M,C3]`` and the six batch statistics (not differentiable). ``q``
    is rounded to bf16 inside, so ``dq`` comes back float32; the
    grouping inputs get no gradient."""

    @staticmethod
    def forward(ctx, new_xyz, pts, q, off, w2, w3, g1, b1, g2, b2, g3, b3,
                radius, k, group):
        idx, h1, _, p1 = bq_f1(new_xyz, pts, q.bfloat16(), off, radius, k)
        return _FusedSAFunction.finish(
            ctx, idx, h1, p1, SAParams(w2, w3, g1, b1, g2, b2, g3, b3),
            pts.shape[1], group)

    @staticmethod
    def backward(ctx, dout, *_):
        return (None, None, *_FusedSAFunction.grads(ctx, dout), None, None,
                None)


class FusedSATrain(_FusedSAFunction):
    """Train-mode fused SA from a given neighbour index. Inputs
    ``q [B,N,C1]`` and ``off [B,M,C1]`` float32, ``idx [B,M,k]`` int32,
    then the eight :class:`SAParams` tensors and the data-parallel group
    (or ``None``). Returns as :class:`FusedSABqTrain`; no gradient flows
    to ``idx``."""

    @staticmethod
    def forward(ctx, q, off, idx, w2, w3, g1, b1, g2, b2, g3, b3, group):
        h1, p1 = sa_f1(q.bfloat16(), off, idx)
        return _FusedSAFunction.finish(
            ctx, idx, h1, p1, SAParams(w2, w3, g1, b1, g2, b2, g3, b3),
            q.shape[1], group)

    @staticmethod
    def backward(ctx, dout, *_):
        dq, doff, *g = _FusedSAFunction.grads(ctx, dout)
        return (dq, doff, None, *g, None)


def fused_sa_bq_train(new_xyz, pts, q, off, params: SAParams, radius: float,
                      k: int, group: Optional[DPGroup] = None
                      ) -> Tuple[torch.Tensor, SAStats]:
    """``(out [B,M,C3], SAStats)`` of the train-mode fused SA, with its
    hand-written backward; with a ``group``, sync-BN over its ranks."""
    out, *stats = FusedSABqTrain.apply(new_xyz, pts, q, off, *params,
                                       radius, k, group)
    return out, SAStats(*stats)


def fused_sa_train(q, off, idx, params: SAParams,
                   cnt: Optional[torch.Tensor] = None,
                   group: Optional[DPGroup] = None
                   ) -> Tuple[torch.Tensor, SAStats]:
    """``(out [B,M,C3], SAStats)`` of the train-mode fused SA from a given
    ``idx [B,M,k]``, with its hand-written backward. ``cnt`` (the ball
    query's counts) is accepted as the JAX function accepts it; the JAX
    package only uses it to pick slot-capped variants of the same passes,
    which give the same result, and the kernels here run every slot.
    With a ``group``, sync-BN over its ranks (the JAX ``axis_name``)."""
    out, *stats = FusedSATrain.apply(q, off, idx, *params, group)
    return out, SAStats(*stats)
