"""PointNet classification and part segmentation (counterpart of
``pointcloudlib_tpu/models/pointnet.py``).

Classification: a shared MLP 3 → 64 → 64 → 64 → 128 → 1024, the global
max over the points, DenseBNAct(512), dropout (0.5, the reference rate;
0 for deterministic comparisons) and a float32 Dense with a bias to
``n_classes``. Part segmentation: an input STN (k = 3) on xyz, three
PointMLPs 64 / 128 / 128, a feature STN (k = 128), a PointMLP 512, conv5
as DenseBNAct(2048) without activation, then the 4,944-channel concat of
``[global max ‖ object one-hot]`` at every point and the five maps, a
PointMLP 256 / 256 / 128 and a float32 Dense to ``part_num``.

The models run no hand-written kernel: dense layers, BatchNorm and max.
Every global max is ``amax``, which splits the gradient evenly among
tied points as ``jnp.max`` does (the Predictor's cyclic padding repeats
points).

Precision: every Dense layer takes f32 operands on the card too, where
the JAX package's ``DenseBNAct`` takes bf16 on its accelerator (the
plain ``nn.Dense`` layers, each STN's last and the heads', declare no
dtype and are f32 there as well). The train-mode BatchNorms after a
global max see one row a cloud, and where a channel's rows lie close
together they scale the operands' rounding up; each STN stacks two of
them and feeds the result into every point. With bf16 operands,
against the CPU's f32 gradients on 8 clouds (``tools/grad_check.py``,
seeds 5 and 6, an NVIDIA H100 80GB HBM3 at 700 W), classification fails
one bound at seed 6 (a least cosine of 0.84) and part segmentation
fails 38 and 43 of its 57 compared gradients (median cosine
0.73–0.77). ``tools/dense_precision.py`` measures both choices'
gradients and time.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pointcloudlib_tpu_torch.models.pointnet2 import dropout
from pointcloudlib_tpu_torch.nn.layers import (
    DenseBNAct,
    PointMLP,
    reference_linear_init,
)

F32 = torch.float32  # every Dense's operands, on every device (above)


def _dense(in_features: int, features: int) -> nn.Linear:
    """A float32 Dense with a bias: kernel U(±1/√fan_in), bias 0 (flax's
    ``nn.Dense`` with ``reference_linear_init``)."""
    dense = nn.Linear(in_features, features)
    reference_linear_init(dense.weight, in_features)
    nn.init.zeros_(dense.bias)
    return dense


class PointNet(nn.Module):
    """``PointNet`` (``models/pointnet.py:25``). ``feat_channels`` is
    accepted and ignored: the model reads xyz only."""

    def __init__(self, n_classes: int = 40, dropout: float = 0.5,
                 feat_channels: int = 0):
        super().__init__()
        del feat_channels
        self.mlp = PointMLP(3, [64, 64, 64, 128, 1024], F32)
        self.fc = DenseBNAct(1024, 512, dtype=F32)
        self.dropout = dropout
        self.out = _dense(512, n_classes)

    def forward(self, xyz: torch.Tensor,
                feats: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits ``[B, n_classes]``; ``feats`` is ignored, ``generator``
        draws the dropout mask in training."""
        del feats
        x = self.mlp(xyz).amax(dim=1)
        x = dropout(self.fc(x), self.dropout, self.training, generator)
        return self.out(x)


class STN(nn.Module):
    """Spatial transformer (``models/pointnet.py:53``): PointMLP 64 / 128 /
    1024 over ``in_features`` channels, the max over the points, PointMLP
    512 / 256, then a float32 Dense to ``k·k`` (zero-initialised) plus the
    identity → ``[B, k, k]``."""

    def __init__(self, in_features: int, k: int):
        super().__init__()
        self.k = k
        self.mlp1 = PointMLP(in_features, [64, 128, 1024], F32)
        self.mlp2 = PointMLP(1024, [512, 256], F32)
        self.dense = nn.Linear(256, k * k)
        nn.init.zeros_(self.dense.weight)
        nn.init.zeros_(self.dense.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.mlp2(self.mlp1(x).amax(dim=1))
        eye = torch.eye(self.k, dtype=h.dtype, device=h.device)
        return (self.dense(h) + eye.reshape(-1)).reshape(-1, self.k, self.k)


class PointNetPartSeg(nn.Module):
    """``PointNetPartSeg`` (``models/pointnet.py:74``). ``feats`` is
    ignored; ``feat_channels`` is accepted for the registry's sake and
    ignored. The model has no dropout: ``dropout`` is accepted and
    ignored, and so is a train step's ``generator``."""

    def __init__(self, part_num: int = 50, feat_channels: int = 0,
                 dropout: float = 0.0):
        super().__init__()
        del feat_channels, dropout
        self.stn = STN(3, 3)
        self.mlp1 = PointMLP(3, [64], F32)
        self.mlp2 = PointMLP(64, [128], F32)
        self.mlp3 = PointMLP(128, [128], F32)
        self.fstn = STN(128, 128)
        self.mlp4 = PointMLP(128, [512], F32)
        self.conv5 = DenseBNAct(512, 2048, act=None, dtype=F32)
        # [gmax 2048 ‖ one-hot 16] + 64 + 128 + 128 + 512 + 2048 = 4944
        self.head = PointMLP(2048 + 16 + 64 + 128 + 128 + 512 + 2048,
                             [256, 256, 128], F32)
        self.out = _dense(128, part_num)

    def forward(self, xyz: torch.Tensor, cls_label: torch.Tensor,
                feats: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Per-point logits ``[B, N, part_num]``."""
        del feats, generator
        x = torch.bmm(xyz, self.stn(xyz))
        out1 = self.mlp1(x)
        out2 = self.mlp2(out1)
        out3 = self.mlp3(out2)
        xt = torch.bmm(out3, self.fstn(out3))
        out4 = self.mlp4(xt)
        out5 = self.conv5(out4)
        gvec = torch.cat([out5.amax(dim=1), cls_label.to(x.dtype)], dim=-1)
        expand = gvec[:, None, :].expand(-1, xyz.shape[1], -1)
        h = torch.cat([expand, out1, out2, out3, out4, out5], dim=-1)
        return self.out(self.head(h))
