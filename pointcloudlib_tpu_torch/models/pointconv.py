"""PointConv (density-reweighted) classification and part segmentation
(counterpart of ``pointcloudlib_tpu/models/pointconv.py``).

Classification: SA(512, k=32, [64,64,128], bw .1) → SA(128, k=64,
[128,128,256], bw .2) → SA(all, [256,512,1024], bw .4) → FC 512 → 256 →
n_classes with dropout 0.4 after the first two. Part segmentation: four
SA layers (1024/256/64/36 centers, k=32, bw .1–.8), four interpolation
decoders ([512,512], [256,256], [128,128], [128,128,128]), then
DenseBNAct(128) → dropout 0.4 → Dense(part_num); it ignores the object
one-hot and the features, as the JAX model does (``:209``).

A layer (:class:`PointConvSA`, :class:`PointConvInterp`) groups k
neighbours, runs a :class:`PointMLP` over ``[local xyz ‖ feats]`` scaled
by the neighbours' :class:`DensityNet` output, weighs them by a
:class:`WeightNet` of the local coordinates, sums over the neighbours
(``einsum("bskc,bskw->bscw")``, C-major reshape), then a float32 Dense
with a bias, BatchNorm and ReLU. The grouping takes the kernels as the
JAX code does (``ops/geometry.sample_and_group``, ``gather_points``); the
neighbour sum stays a ``torch.einsum``, as the JAX package leaves it to
XLA.

Precision: every Dense layer takes f32 operands on the card too, where
the JAX package's ``DenseBNAct`` takes bf16 on its accelerator. The
model's train-mode BatchNorms leave the DensityNet and WeightNet
gradients as small remainders of cancelling sums, and bf16 rounding
swamps them: against the CPU's f32 gradients on 8 clouds, bf16 operands
fail ``tools/grad_check.py``'s bounds on both models, and so do f32
DensityNets or f32 DensityNets and WeightNets with the rest in bf16; f32
throughout passes (``tools/dense_precision.py``, which also times each
choice).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pointcloudlib_tpu_torch.models.pointnet2 import dropout
from pointcloudlib_tpu_torch.nn.layers import (
    BatchNorm,
    DenseBNAct,
    PointMLP,
    reference_linear_init,
)
from pointcloudlib_tpu_torch.ops import (
    compute_density,
    gather_points,
    knn,
    sample_and_group,
    three_nn_interpolate,
)

WEIGHTS = 16  # WeightNet's output width: the weights a neighbour gets


def _dense_bn_stack(dims: Sequence[int]) -> list:
    """DenseBNAct blocks with a Dense bias, ReLU after each, in f32."""
    return [DenseBNAct(i, o, use_bias=True, dtype=torch.float32)
            for i, o in zip(dims, dims[1:])]


class DensityNet(nn.Sequential):
    """Density-scale MLP 1 → 8 → 8 → 1 (``models/pointconv.py:46``), over
    ``[B, N, 1]``."""

    def __init__(self):
        super().__init__(*_dense_bn_stack((1, 8, 8, 1)))


class WeightNet(nn.Sequential):
    """Weight MLP 3 → 8 → 8 → 16 on local coordinates
    (``models/pointconv.py:62``)."""

    def __init__(self):
        super().__init__(*_dense_bn_stack((3, 8, 8, WEIGHTS)))


class _PointConv(nn.Module):
    """What :class:`PointConvSA` and :class:`PointConvInterp` share: the
    DensityNet, the PointMLP over ``in_channels`` grouped channels, the
    WeightNet and the output Dense (f32, bias) and BatchNorm, in the JAX
    layers' order of creation."""

    def __init__(self, in_channels: int, mlp: Sequence[int],
                 bandwidth: float):
        super().__init__()
        self.bandwidth = bandwidth
        self.density_net = DensityNet()
        self.mlp = PointMLP(in_channels, mlp, torch.float32)
        self.weight_net = WeightNet()
        self.dense = nn.Linear(mlp[-1] * WEIGHTS, mlp[-1])
        reference_linear_init(self.dense.weight, mlp[-1] * WEIGHTS)
        nn.init.zeros_(self.dense.bias)
        self.bn = BatchNorm(mlp[-1])

    def scale(self, xyz: torch.Tensor) -> torch.Tensor:
        """The DensityNet of the points' KDE density → ``[B, N, 1]``."""
        density = compute_density(xyz, self.bandwidth)
        return self.density_net(density[..., None])

    def conv(self, grouped: torch.Tensor, grouped_xyz: torch.Tensor,
             grouped_density: torch.Tensor) -> torch.Tensor:
        """``[B, S, K, ·]`` neighbourhoods → ``[B, S, C]``: the density-
        scaled PointMLP weighed by the WeightNet and summed over K, then
        Dense, BatchNorm, ReLU (``models/pointconv.py:110-131``)."""
        b, s = grouped.shape[:2]
        h = self.mlp(grouped) * grouped_density
        w = self.weight_net(grouped_xyz)
        # [B,S,C,K] @ [B,S,K,16] → [B,S,C,16] → [B,S,C·16], C-major
        agg = torch.einsum("bskc,bskw->bscw", h, w).reshape(b, s, -1)
        out = self.bn(self.dense(agg).reshape(b * s, -1))
        return F.relu(out).reshape(b, s, -1)


class PointConvSA(_PointConv):
    """Density-weighted PointConv set abstraction
    (``models/pointconv.py:76``): ``n_points`` centers by FPS and their
    ``k`` nearest neighbours (``sample_and_group``), or with ``n_points
    = None`` one group of every point, centred at the origin, with the
    absolute xyz."""

    def __init__(self, in_channels: int, mlp: Sequence[int],
                 bandwidth: float, n_points: Optional[int] = None,
                 k: Optional[int] = None):
        super().__init__(3 + in_channels, mlp, bandwidth)
        self.n_points, self.k = n_points, k

    def forward(self, xyz: torch.Tensor, feats: Optional[torch.Tensor]):
        b = xyz.shape[0]
        scale = self.scale(xyz)                              # [B, N, 1]
        if self.n_points is None:
            new_xyz = xyz.new_zeros((b, 1, 3))
            grouped_xyz = xyz[:, None]                       # absolute
            grouped = (grouped_xyz if feats is None
                       else torch.cat([xyz, feats], dim=-1)[:, None])
            grouped_density = scale[:, None]
        else:
            new_xyz, grouped, grouped_density = sample_and_group(
                xyz, feats, self.n_points, self.k, density=scale[..., 0])
            grouped_xyz = grouped[..., :3]
        return new_xyz, self.conv(grouped, grouped_xyz, grouped_density)


class PointConvInterp(_PointConv):
    """Density-weighted PointConv interpolation, the decoder layer
    (``models/pointconv.py:135``): the coarse features 3-NN-interpolated
    up to the fine points, then a PointConv over each fine point's ``k``
    nearest fine neighbours, in the fine points' own order (identity, not
    the reference's FPS order, ``:143-147``)."""

    def __init__(self, in_coarse: int, mlp: Sequence[int], bandwidth: float,
                 k: int = 16):
        super().__init__(3 + in_coarse, mlp, bandwidth)
        self.k = k

    def forward(self, xyz_fine: torch.Tensor, xyz_coarse: torch.Tensor,
                feats_coarse: torch.Tensor) -> torch.Tensor:
        up = three_nn_interpolate(xyz_fine, xyz_coarse, feats_coarse)
        scale = self.scale(xyz_fine)
        _, idx = knn(xyz_fine, xyz_fine, self.k)
        local = gather_points(xyz_fine, idx) - xyz_fine[:, :, None, :]
        grouped = torch.cat([local, gather_points(up, idx)], dim=-1)
        return self.conv(grouped, local, gather_points(scale, idx))


class PointConvDensityCls(nn.Module):
    """PointConv classification (``models/pointconv.py:239``).
    ``feat_channels``: per-point input features (3 for normals, 0 for xyz
    only); ``dropout`` 0.4 is the reference rate, 0 for deterministic
    comparisons."""

    def __init__(self, n_classes: int = 40, feat_channels: int = 3,
                 dropout: float = 0.4):
        super().__init__()
        self.sa1 = PointConvSA(feat_channels, [64, 64, 128], 0.1,
                               n_points=512, k=32)
        self.sa2 = PointConvSA(128, [128, 128, 256], 0.2, n_points=128,
                               k=64)
        self.sa3 = PointConvSA(256, [256, 512, 1024], 0.4)
        self.fc1 = DenseBNAct(1024, 512, use_bias=True,
                              dtype=torch.float32)
        self.fc2 = DenseBNAct(512, 256, use_bias=True,
                              dtype=torch.float32)
        self.dropout = dropout
        self.out = nn.Linear(256, n_classes)
        reference_linear_init(self.out.weight, 256)
        nn.init.zeros_(self.out.bias)

    def forward(self, xyz: torch.Tensor,
                feats: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits ``[B, n_classes]``; ``generator`` draws the dropout
        masks in training."""
        xyz, f = self.sa1(xyz, feats)
        xyz, f = self.sa2(xyz, f)
        _, f = self.sa3(xyz, f)
        x = dropout(self.fc1(f[:, 0]), self.dropout, self.training,
                    generator)
        x = dropout(self.fc2(x), self.dropout, self.training, generator)
        return self.out(x)


class PointConvPartSeg(nn.Module):
    """PointConv part segmentation (``models/pointconv.py:189``). It reads
    xyz alone: ``cls_label`` and ``feats`` are ignored, and
    ``feat_channels`` is accepted for the registry's sake and ignored.
    ``dropout`` 0.4 is the reference rate (fixed in the JAX model), 0 for
    deterministic comparisons."""

    def __init__(self, part_num: int = 50, feat_channels: int = 0,
                 dropout: float = 0.4):
        super().__init__()
        del feat_channels
        self.sa1 = PointConvSA(0, [32, 32, 64], 0.1, n_points=1024, k=32)
        self.sa2 = PointConvSA(64, [64, 64, 128], 0.2, n_points=256, k=32)
        self.sa3 = PointConvSA(128, [128, 128, 256], 0.4, n_points=64, k=32)
        self.sa4 = PointConvSA(256, [256, 256, 512], 0.8, n_points=36, k=32)
        self.fp4 = PointConvInterp(512, [512, 512], 0.8)
        self.fp3 = PointConvInterp(512, [256, 256], 0.4)
        self.fp2 = PointConvInterp(256, [128, 128], 0.2)
        self.fp1 = PointConvInterp(128, [128, 128, 128], 0.1)
        self.head = DenseBNAct(128, 128, use_bias=True,
                               dtype=torch.float32)
        self.dropout = dropout
        self.out = nn.Linear(128, part_num)
        reference_linear_init(self.out.weight, 128)
        nn.init.zeros_(self.out.bias)

    def forward(self, xyz: torch.Tensor, cls_label: torch.Tensor,
                feats: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Per-point logits ``[B, N, part_num]``; ``generator`` draws the
        dropout mask in training."""
        del cls_label, feats
        l1x, l1f = self.sa1(xyz, None)
        l2x, l2f = self.sa2(l1x, l1f)
        l3x, l3f = self.sa3(l2x, l2f)
        l4x, l4f = self.sa4(l3x, l3f)
        l3f = self.fp4(l3x, l4x, l4f)
        l2f = self.fp3(l2x, l3x, l3f)
        l1f = self.fp2(l1x, l2x, l2f)
        l0f = self.fp1(xyz, l1x, l1f)
        h = dropout(self.head(l0f), self.dropout, self.training, generator)
        return self.out(h)
