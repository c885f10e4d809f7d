"""PointNet++ SSG and MSG classification and SSG part segmentation
(counterpart of ``pointcloudlib_tpu/models/pointnet2.py``).

SSG: SA(512, r=.2, k=64, [64,64,128]) → SA(128, r=.4, k=64,
[128,128,256]) → SA(all, [256,512,1024]) → the head.
MSG: MSG(512, r=(.1,.2,.4), k=(16,32,128), [32,32,64], [64,64,128],
[64,96,128]) → MSG(128, r=(.2,.4,.8), k=(32,64,128), [64,64,128],
[128,128,256], [128,128,256]) → SA(all, [256,512,1024]) → the head.
The head is FC 512→256→n_classes with dropout (0.5, the reference rate;
0 for deterministic comparisons). Input features are the raw normals.
Part segmentation: the SSG encoder, then FP [256,256], FP [256,128] and
FP [128,128,128] with the object one-hot, xyz and the input features
joined at the last, and the head DenseBNAct(128, no ReLU) → dropout →
Dense(part_num).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pointcloudlib_tpu_torch.nn.layers import (
    DenseBNAct,
    FeaturePropagation,
    SetAbstraction,
    SetAbstractionMSG,
    reference_linear_init,
)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout as flax's ``nn.Dropout``: in training keep a unit
    where ``rand < 1 − rate`` and scale it by ``1/(1 − rate)``; the
    uniform draws come from ``generator`` (the train step's own), never
    from the global RNG."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    draw = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(draw < keep, x / keep, 0.0)


class ClsHead(nn.Module):
    """DenseBNAct(512) → DenseBNAct(256) → :func:`dropout` →
    Dense(n_classes)."""

    def __init__(self, in_features: int, n_classes: int,
                 dropout: float = 0.5):
        super().__init__()
        self.fc1 = DenseBNAct(in_features, 512)
        self.fc2 = DenseBNAct(512, 256)
        self.dropout = dropout
        self.out = nn.Linear(256, n_classes)
        reference_linear_init(self.out.weight, 256)
        nn.init.zeros_(self.out.bias)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.fc2(self.fc1(x))
        return self.out(dropout(x, self.dropout, self.training, generator))


class PointNet2SSG(nn.Module):
    """``feat_channels``: per-point input features (3 for normals, 0 for
    xyz only)."""

    def __init__(self, n_classes: int = 40, feat_channels: int = 3,
                 dropout: float = 0.5):
        super().__init__()
        self.sa1 = SetAbstraction(feat_channels, [64, 64, 128], n_points=512,
                                  radius=0.2, n_samples=64)
        self.sa2 = SetAbstraction(128, [128, 128, 256], n_points=128,
                                  radius=0.4, n_samples=64)
        self.sa3 = SetAbstraction(256, [256, 512, 1024])
        self.head = ClsHead(1024, n_classes, dropout)

    def forward(self, xyz: torch.Tensor,
                feats: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits ``[B, n_classes]``; ``generator`` draws the head's
        dropout mask in training."""
        xyz, f = self.sa1(xyz, feats)
        xyz, f = self.sa2(xyz, f)
        _, f = self.sa3(xyz, f)
        return self.head(f[:, 0], generator)


class PointNet2MSG(nn.Module):
    """Multi-scale grouping (``models/pointnet2.py:135``). The JAX model
    fixes the head's dropout at 0.5; here it is an argument, as in
    :class:`PointNet2SSG`, for deterministic comparisons."""

    def __init__(self, n_classes: int = 40, feat_channels: int = 3,
                 dropout: float = 0.5):
        super().__init__()
        self.sa1 = SetAbstractionMSG(
            feat_channels, n_points=512, radii=[0.1, 0.2, 0.4],
            n_samples=[16, 32, 128],
            mlps=[[32, 32, 64], [64, 64, 128], [64, 96, 128]])
        self.sa2 = SetAbstractionMSG(
            64 + 128 + 128, n_points=128, radii=[0.2, 0.4, 0.8],
            n_samples=[32, 64, 128],
            mlps=[[64, 64, 128], [128, 128, 256], [128, 128, 256]])
        self.sa3 = SetAbstraction(128 + 256 + 256, [256, 512, 1024])
        self.head = ClsHead(1024, n_classes, dropout)

    def forward(self, xyz: torch.Tensor,
                feats: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits ``[B, n_classes]``; ``generator`` draws the head's
        dropout mask in training."""
        xyz, f = self.sa1(xyz, feats)
        xyz, f = self.sa2(xyz, f)
        _, f = self.sa3(xyz, f)
        return self.head(f[:, 0], generator)


N_CATEGORIES = 16  # ShapeNet part's object categories, one-hot


class PointNet2PartSeg(nn.Module):
    """PointNet++ SSG part segmentation (``models/pointnet2.py:77``).
    ``feat_channels``: per-point input features (3 when xyz is passed
    again as features, as the reference's training does). The JAX model
    fixes the head's dropout at 0.5; here it is an argument, for
    deterministic comparisons."""

    def __init__(self, part_num: int = 50, feat_channels: int = 3,
                 dropout: float = 0.5):
        super().__init__()
        self.sa1 = SetAbstraction(feat_channels, [64, 64, 128], n_points=512,
                                  radius=0.2, n_samples=64)
        self.sa2 = SetAbstraction(128, [128, 128, 256], n_points=128,
                                  radius=0.4, n_samples=64)
        self.sa3 = SetAbstraction(256, [256, 512, 1024])
        self.fp3 = FeaturePropagation(256, 1024, [256, 256])
        self.fp2 = FeaturePropagation(128, 256, [256, 128])
        self.fp1 = FeaturePropagation(N_CATEGORIES + 3 + feat_channels, 128,
                                      [128, 128, 128])
        self.head = DenseBNAct(128, 128, act=None, use_bias=True)
        self.dropout = dropout
        self.out = nn.Linear(128, part_num)
        reference_linear_init(self.out.weight, 128)
        nn.init.zeros_(self.out.bias)

    def forward(self, xyz: torch.Tensor, cls_label: torch.Tensor,
                feats: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Per-point logits ``[B, N, part_num]`` for ``xyz [B, N, 3]`` and
        the object one-hot ``cls_label [B, 16]``; ``generator``
        draws the head's dropout mask in training."""
        b, n, _ = xyz.shape
        l1_xyz, l1_f = self.sa1(xyz, feats)
        l2_xyz, l2_f = self.sa2(l1_xyz, l1_f)
        l3_xyz, l3_f = self.sa3(l2_xyz, l2_f)
        l2_f = self.fp3(l2_xyz, l3_xyz, l2_f, l3_f)
        l1_f = self.fp2(l1_xyz, l2_xyz, l1_f, l2_f)
        one_hot = cls_label[:, None, :].to(xyz.dtype).expand(
            b, n, cls_label.shape[-1])
        skip = torch.cat([one_hot, xyz] + ([] if feats is None else [feats]),
                         dim=-1)
        f = self.head(self.fp1(xyz, l1_xyz, skip, l1_f))
        return self.out(dropout(f, self.dropout, self.training, generator))
