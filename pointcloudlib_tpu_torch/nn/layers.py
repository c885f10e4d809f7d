"""Shared NN building blocks, channel-last (counterpart of
``pointcloudlib_tpu/nn/layers.py``).

Pointwise convolutions are Dense layers over the trailing feature axis.
BatchNorm uses eps 1e-5 and flax's running update: momentum 0.9 on the
biased batch variance (torch's own BatchNorm would update with the
unbiased one).

Mixed precision follows the JAX package: on the card a Dense layer
takes bf16 operands with f32 accumulation and a bf16 result, as
``nn.Dense(dtype=bf16)`` does on the TPU; on the CPU it runs in f32, as
the JAX package does off the TPU. BatchNorm is always f32.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pointcloudlib_tpu_torch.ops import (
    ball_query,
    fps,
    group_all,
    index_points,
    three_nn_interpolate,
)
from pointcloudlib_tpu_torch.ops.kernels.fused_sa import (
    SAParams,
    SAStats,
    fused_sa_bq_eval,
    fused_sa_eval,
)
from pointcloudlib_tpu_torch.ops.kernels.fused_sa_train import (
    fused_sa_bq_train,
    fused_sa_train,
)
from pointcloudlib_tpu_torch.ops.spatial import window_width

_BN_EPS = 1e-5
_BN_MOMENTUM = 0.9  # flax convention: running = 0.9·running + 0.1·batch
# largest n_samples that takes the kernels with the ball query inside
# (the JAX package's default gate, ``_bq_kmax``, ``nn/layers.py:147``)
_BQ_KMAX = 64


@torch.no_grad()
def reference_linear_init(w: torch.Tensor, fan_in: int) -> torch.Tensor:
    """U(±1/√fan_in) in place — the torch Conv/Linear default the JAX
    package reproduces (``nn/layers.py:45``)."""
    bound = 1.0 / math.sqrt(fan_in)
    return w.uniform_(-bound, bound)


def compute_dtype(device: torch.device) -> torch.dtype:
    """Dense operand dtype: bf16 on the card, f32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def _bf16_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16-rounded operands, f32 accumulation — exact in f32 because a
    bf16×bf16 product fits in f32 (TF32 is off package-wide)."""
    return a.bfloat16().float() @ b.bfloat16().float()


@torch.no_grad()
def update_running(running: torch.Tensor, batch: torch.Tensor) -> None:
    """``running ← 0.9·running + 0.1·batch`` in place (flax's update,
    ``nn/layers.py:357``)."""
    running.copy_(_BN_MOMENTUM * running + (1.0 - _BN_MOMENTUM) * batch)


class BatchNorm(nn.Module):
    """BatchNorm over ``[R, C]`` rows with flax's running statistics.

    Normalises with the batch's biased statistics in training and the
    running ones in eval (``F.batch_norm``); in training it then updates
    ``running_mean``/``running_var`` with the batch mean and the
    *biased* variance ``E[x²] − E[x]²``, as ``flax.linen.BatchNorm``
    does. Names follow ``nn.BatchNorm1d`` (``weight``, ``bias``,
    ``running_mean``, ``running_var``)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, _BN_EPS)
        with torch.no_grad():
            mean = x.mean(0)
            var = torch.clamp_min((x * x).mean(0) - mean * mean, 0.0)
        update_running(self.running_mean, mean)
        update_running(self.running_var, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            _BN_EPS)


class DenseBNAct(nn.Module):
    """Dense → BatchNorm → activation over the last axis
    (``nn/layers.py:70``). ``act`` is ReLU by default or ``None``; the
    Dense has a bias only with ``use_bias`` (zero-initialized, as flax's).
    ``dtype`` fixes the Dense operands' type on every device; ``None``
    takes :func:`compute_dtype`."""

    def __init__(self, in_features: int, features: int,
                 act: Optional[Callable[[torch.Tensor],
                                        torch.Tensor]] = F.relu,
                 use_bias: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.dense = nn.Linear(in_features, features, bias=use_bias)
        reference_linear_init(self.dense.weight, in_features)
        if use_bias:
            nn.init.zeros_(self.dense.bias)
        self.bn = BatchNorm(features)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(x.device) if self.dtype is None else self.dtype
        bias = self.dense.bias
        x = F.linear(x.to(dt), self.dense.weight.to(dt),
                     None if bias is None else bias.to(dt)).float()
        shape = x.shape
        x = self.bn(x.reshape(-1, shape[-1])).reshape(shape)
        return x if self.act is None else self.act(x)


class PointMLP(nn.Sequential):
    """Stack of DenseBNAct blocks over the trailing channel axis, their
    Dense operands in ``dtype`` (``None``: :func:`compute_dtype`)."""

    def __init__(self, in_features: int, features: Sequence[int],
                 dtype: Optional[torch.dtype] = None):
        dims = [in_features, *features]
        super().__init__(*[DenseBNAct(i, o, dtype=dtype)
                           for i, o in zip(dims, dims[1:])])


class FusedSetAbstraction(nn.Module):
    """Fused SA layer: FPS, then ball query + gather + (BN→ReLU, Dense)
    ×3 + max (``nn/layers.py:221``). Eval runs one kernel with the
    running statistics; training runs the fused train kernels with batch
    statistics over every grouped row and then updates the running ones
    (biased variance, momentum 0.9). Grouped features are
    ``[recentred xyz ‖ features]``.

    Routing follows the JAX layer (``nn/layers.py:265-290``): the kernels
    with the ball query inside when no neighbour index is given, N is a
    multiple of 128 below 4096 (from 4096 up the JAX layer takes its
    windowed kernels, ``ops/spatial.window_width``) and ``n_samples`` ≤ 64;
    else the standalone ball
    query, then the kernels that take its index.

    Parameters keep the JAX names and layouts (``w1 [3+C, C1]``,
    ``w2``, ``w3``, ``bn{l}_scale``/``bn{l}_bias``; buffers
    ``mean{l}``/``var{l}``)."""

    def __init__(self, in_channels: int, mlp: Sequence[int], n_points: int,
                 radius: float, n_samples: int):
        super().__init__()
        c1, c2, c3 = mlp
        self.n_points, self.radius, self.n_samples = n_points, radius, n_samples
        c0 = 3 + in_channels
        for name, shape in (("w1", (c0, c1)), ("w2", (c1, c2)),
                            ("w3", (c2, c3))):
            w = nn.Parameter(torch.empty(shape))
            reference_linear_init(w, shape[0])
            self.register_parameter(name, w)
        for l, c in ((1, c1), (2, c2), (3, c3)):
            self.register_parameter(f"bn{l}_scale", nn.Parameter(torch.ones(c)))
            self.register_parameter(f"bn{l}_bias", nn.Parameter(torch.zeros(c)))
            self.register_buffer(f"mean{l}", torch.zeros(c))
            self.register_buffer(f"var{l}", torch.ones(c))

    def sa_params(self) -> SAParams:
        return SAParams(self.w2, self.w3, self.bn1_scale, self.bn1_bias,
                        self.bn2_scale, self.bn2_bias, self.bn3_scale,
                        self.bn3_bias)

    def sa_stats(self) -> SAStats:
        return SAStats(self.mean1, self.var1, self.mean2, self.var2,
                       self.mean3, self.var3)

    def prepare(self, xyz: torch.Tensor, feats: Optional[torch.Tensor],
                new_xyz: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(new_xyz, q, off)``: the centers (FPS unless given) and the
        kernels' folded first layer ``q = [xyz‖f]·W1`` and ``off =
        new_xyz·W1[:3]``, both float32 from bf16-rounded operands with f32
        accumulation (``nn/layers.py:303-314``). The kernels round ``q``
        to bf16 (``fused_sa.py:1259,1427``): eval before its call,
        training inside the autograd function, so that ``dq`` stays
        float32."""
        if new_xyz is None:
            new_xyz = index_points(xyz, fps(xyz, self.n_points))
        p = xyz if feats is None else torch.cat([xyz, feats], dim=-1)
        q = _bf16_mm(p, self.w1)
        off = _bf16_mm(new_xyz, self.w1[:3])
        return new_xyz, q, off

    def fuses_ball_query(self, n: int) -> bool:
        """Whether a cloud of ``n`` points takes the kernels with the ball
        query inside (``fuse_bq``, ``nn/layers.py:278``)."""
        return (window_width(n) is None and n % 128 == 0
                and self.n_samples <= _BQ_KMAX)

    def forward(self, xyz: torch.Tensor, feats: Optional[torch.Tensor], *,
                new_xyz: Optional[torch.Tensor] = None,
                nidx: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``new_xyz`` and ``nidx`` may be given by the caller (MSG shares
        one FPS across its scales)."""
        new_xyz, q, off = self.prepare(xyz, feats, new_xyz)
        ncnt = None
        fuse_bq = nidx is None and self.fuses_ball_query(xyz.shape[1])
        if not fuse_bq and nidx is None:
            nidx, ncnt = ball_query(new_xyz, xyz, self.radius,
                                    self.n_samples)
        if not self.training:
            if fuse_bq:
                out = fused_sa_bq_eval(new_xyz, xyz, q.bfloat16(), off,
                                       self.sa_params(), self.sa_stats(),
                                       self.radius, self.n_samples)
            else:
                out = fused_sa_eval(q.bfloat16(), off, nidx,
                                    self.sa_params(), self.sa_stats(),
                                    cnt=ncnt)
            return new_xyz, out
        if fuse_bq:
            out, batch = fused_sa_bq_train(new_xyz, xyz, q, off,
                                           self.sa_params(), self.radius,
                                           self.n_samples)
        else:
            # every slot runs in training: the counts change nothing
            out, batch = fused_sa_train(q, off, nidx, self.sa_params())
        for running, value in zip(self.sa_stats(), batch):
            update_running(running, value)
        return new_xyz, out


class SetAbstraction(nn.Module):
    """PointNet++ single-scale set abstraction (``nn/layers.py:170``).

    ``n_points=None`` is the group-all final layer (absolute xyz ‖
    features → PointMLP → max). A grouped layer with 3 widths and
    ``n_samples % 8 == 0`` runs :class:`FusedSetAbstraction` on every
    device; the unfused grouped path is not ported."""

    def __init__(self, in_channels: int, mlp: Sequence[int],
                 n_points: Optional[int] = None,
                 radius: Optional[float] = None,
                 n_samples: Optional[int] = None):
        super().__init__()
        self.n_points = n_points
        if n_points is None:
            self.mlp = PointMLP(in_channels + 3, mlp)
        elif len(mlp) == 3 and n_samples is not None and n_samples % 8 == 0:
            self.fused = FusedSetAbstraction(in_channels, mlp, n_points,
                                             radius, n_samples)
        else:
            raise NotImplementedError(
                "the unfused grouped set abstraction (an MLP of other than "
                "3 layers, or n_samples not a multiple of 8) is not ported; "
                "no model of the JAX package takes it when its fused set "
                "abstraction is on (ROADMAP.md)")

    def forward(self, xyz: torch.Tensor, feats: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.n_points is not None:
            return self.fused(xyz, feats)
        h = self.mlp(group_all(xyz, feats))
        new_xyz = xyz.new_zeros((xyz.shape[0], 1, 3))
        return new_xyz, h.amax(dim=2)


class SetAbstractionMSG(nn.Module):
    """PointNet++ multi-scale-grouping set abstraction
    (``nn/layers.py:375``): one FPS, one :class:`FusedSetAbstraction` per
    ``(radius, n_samples, mlp)`` scale on the shared centers, the scales'
    features concatenated on the last axis. Every scale must be fusable
    (3 widths, ``n_samples % 8 == 0``), as every scale of the JAX
    package's models is; the unfused branch is not ported."""

    def __init__(self, in_channels: int, n_points: int,
                 radii: Sequence[float], n_samples: Sequence[int],
                 mlps: Sequence[Sequence[int]]):
        super().__init__()
        if not (len(radii) == len(n_samples) == len(mlps)):
            raise ValueError("SetAbstractionMSG: radii, n_samples and mlps "
                             "must have one entry per scale")
        if any(len(m) != 3 for m in mlps) or any(k % 8 for k in n_samples):
            raise NotImplementedError(
                "SetAbstractionMSG: the unfused branch (an MLP of other "
                "than 3 layers, or n_samples not a multiple of 8) is not "
                "ported (ROADMAP.md)")
        self.n_points = n_points
        self.scales = nn.ModuleList(
            FusedSetAbstraction(in_channels, mlp, n_points, r, k)
            for r, k, mlp in zip(radii, n_samples, mlps))

    def forward(self, xyz: torch.Tensor, feats: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        new_xyz = index_points(xyz, fps(xyz, self.n_points))
        outs = [scale(xyz, feats, new_xyz=new_xyz)[1]
                for scale in self.scales]
        return new_xyz, torch.cat(outs, dim=-1)


class FeaturePropagation(nn.Module):
    """PointNet++ feature propagation, the decoder layer
    (``nn/layers.py:419``): the coarse features interpolated up to the fine
    points (3-NN, inverse squared distance; a single coarse point is
    broadcast), ``[feats_fine ‖ up]`` when fine features are given, then
    a :class:`PointMLP`."""

    def __init__(self, in_fine: int, in_coarse: int, mlp: Sequence[int]):
        super().__init__()
        self.mlp = PointMLP(in_fine + in_coarse, mlp)

    def forward(self, xyz_fine: torch.Tensor, xyz_coarse: torch.Tensor,
                feats_fine: Optional[torch.Tensor],
                feats_coarse: torch.Tensor) -> torch.Tensor:
        b, n = xyz_fine.shape[:2]
        if xyz_coarse.shape[1] == 1:
            up = feats_coarse.expand(b, n, feats_coarse.shape[-1])
        else:
            up = three_nn_interpolate(xyz_fine, xyz_coarse, feats_coarse)
        if feats_fine is not None:
            up = torch.cat([feats_fine, up], dim=-1)
        return self.mlp(up)
