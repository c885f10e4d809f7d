"""Shared NN building blocks, channel-last (counterpart of
``pointcloudlib_tpu/nn/layers.py``).

Pointwise convolutions are Dense layers over the trailing feature axis.
BatchNorm uses eps 1e-5 and torch momentum 0.1 (flax's 0.9).

Mixed precision follows the JAX package: on the card a Dense layer
takes bf16 operands with f32 accumulation and a bf16 result, as
``nn.Dense(dtype=bf16)`` does on the TPU; on the CPU it runs in f32, as
the JAX package does off the TPU. BatchNorm is always f32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pointcloudlib_tpu_torch.ops import fps, group_all, index_points
from pointcloudlib_tpu_torch.ops.kernels.fused_sa import (
    SAParams,
    SAStats,
    fused_sa_bq_eval,
)

_BN_EPS = 1e-5
_BN_MOMENTUM = 0.1
_TRAIN_SLICE = ("training the fused set abstraction is not ported yet "
                "(ROADMAP.md, queue 1, item 2: the train slice — _k_bqf1, "
                "the tails, _k_p1/_k_p2 and the train step)")


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


class DenseBNAct(nn.Module):
    """Dense (no bias) → BatchNorm → ReLU over the last axis."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.dense = nn.Linear(in_features, features, bias=False)
        reference_linear_init(self.dense.weight, in_features)
        self.bn = nn.BatchNorm1d(features, eps=_BN_EPS, momentum=_BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(x.device)
        x = F.linear(x.to(dt), self.dense.weight.to(dt)).float()
        shape = x.shape
        return F.relu(self.bn(x.reshape(-1, shape[-1])).reshape(shape))


class PointMLP(nn.Sequential):
    """Stack of DenseBNAct blocks over the trailing channel axis."""

    def __init__(self, in_features: int, features: Sequence[int]):
        dims = [in_features, *features]
        super().__init__(*[DenseBNAct(i, o) for i, o in zip(dims, dims[1:])])


class FusedSetAbstraction(nn.Module):
    """Fused SA layer, eval only: FPS, then ball query + gather +
    (BN→ReLU, Dense) ×3 + max in one kernel (``nn/layers.py:221``).
    Grouped features are ``[recentred xyz ‖ features]``.

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

    def prepare(self, xyz: torch.Tensor, feats: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(new_xyz, q, off)``: FPS centers and the kernel's folded
        first layer ``q = [xyz‖f]·W1`` (rounded to bf16, as
        ``fused_sa.py:1427`` casts it) and ``off = new_xyz·W1[:3]``, both
        from bf16-rounded operands with f32 accumulation
        (``nn/layers.py:303-314``)."""
        new_xyz = index_points(xyz, fps(xyz, self.n_points))
        p = xyz if feats is None else torch.cat([xyz, feats], dim=-1)
        q = _bf16_mm(p, self.w1)
        off = _bf16_mm(new_xyz, self.w1[:3])
        return new_xyz, q.bfloat16(), off

    def forward(self, xyz: torch.Tensor, feats: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.training:
            raise NotImplementedError(_TRAIN_SLICE)
        new_xyz, q, off = self.prepare(xyz, feats)
        out = fused_sa_bq_eval(new_xyz, xyz, q, off, self.sa_params(),
                               self.sa_stats(), self.radius, self.n_samples)
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
                "unfused grouped set abstraction is not ported yet "
                "(ROADMAP.md, queue 1, item 6: PointNet++ MSG and the "
                "standalone ball-query kernel)")

    def forward(self, xyz: torch.Tensor, feats: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.n_points is not None:
            return self.fused(xyz, feats)
        h = self.mlp(group_all(xyz, feats))
        new_xyz = xyz.new_zeros((xyz.shape[0], 1, 3))
        return new_xyz, h.amax(dim=2)
