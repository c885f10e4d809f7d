"""PointCNN (X-transform convolution) classification and part
segmentation (counterpart of ``pointcloudlib_tpu/models/pointcnn.py``).

Classification: XConv layers (3→48, K=8, D=1, all points), (48→96, 12,
2, 384 points), (96→192, 16, 2, 128), (192→384, 16, 3, 128), then
DenseBlock 192, DenseBlock 128 with dropout (0.5, the reference rate; 0
for deterministic comparisons), a DenseBlock to ``n_classes`` without
BatchNorm or activation, and the mean over the points. Input features
are the given ``feats``, else the coordinates. Part segmentation: four
encoders (3→256→256→512→1024; all / 768 / 384 / 128 points; K = 8, 12,
16, 16) and four decoders, each a :class:`PointCNNLayer` from the coarser
level onto the finer level's points, the skip features joined, then a
DenseBlock; the last one ends in BN and ReLU, so the logits are ≥ 0, as
in the reference. It ignores the object one-hot and the features.

A layer's neighbourhoods come from FPS (where 0 < P < N) and the dilated
kNN: the K·D nearest points, every D-th rank kept, in ascending (d²,
index) order, which XConv consumes positionally. Where N % 128 == 0,
K·D ≤ N and everything is float32 (every layer of both models at the
bench sizes), the fused kNN + gather (``dispatch.knn_gather``) gathers
``[xyz ‖ features]`` in one launch, its backward the row scatter-add;
else :func:`~pointcloudlib_tpu_torch.ops.geometry.knn` and
:func:`~pointcloudlib_tpu_torch.ops.geometry.gather_points`. The dense
parts (the lifts, the X-transform, the depthwise product) stay PyTorch
operations, as the JAX package leaves them to XLA.

Precision: every Dense here is float32 with a bias on every device (the
JAX ``nn.Dense`` of ``DenseBlock`` and XConv declares no dtype), and
BatchNorm keeps flax's momentum 0.9, "90 % old" (``DenseBlock``'s
docstring in the JAX module).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pointcloudlib_tpu_torch.models.pointnet2 import dropout
from pointcloudlib_tpu_torch.nn.layers import BatchNorm, reference_linear_init
from pointcloudlib_tpu_torch.ops import dispatch, geometry


class DenseBlock(nn.Module):
    """``DenseBlock`` (``models/pointcnn.py:39``): a float32 Dense with a
    bias, then BatchNorm and ReLU in that order, or with
    ``act_before_bn`` ReLU then BatchNorm; ``with_bn`` and ``act`` drop
    either; then dropout at ``drop_rate``. Works on any rank: BatchNorm
    normalises over every axis but the last."""

    def __init__(self, in_features: int, features: int, with_bn: bool = True,
                 act: bool = True, act_before_bn: bool = False,
                 drop_rate: float = 0.0):
        super().__init__()
        self.dense = nn.Linear(in_features, features)
        reference_linear_init(self.dense.weight, in_features)
        nn.init.zeros_(self.dense.bias)
        self.bn = BatchNorm(features) if with_bn else None
        self.act, self.act_before_bn = act, act_before_bn
        self.drop_rate = drop_rate

    def _bn(self, x: torch.Tensor) -> torch.Tensor:
        if self.bn is None:
            return x
        return self.bn(x.reshape(-1, x.shape[-1])).reshape(x.shape)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.dense(x)
        if self.act_before_bn:
            x = self._bn(F.relu(x) if self.act else x)
        else:
            x = self._bn(x)
            x = F.relu(x) if self.act else x
        return dropout(x, self.drop_rate, self.training, generator)


class XConv(nn.Module):
    """X-transform convolution over one neighbourhood
    (``models/pointcnn.py:85``): the local coordinates lifted to
    ``c_mid`` by two DenseBlocks and joined with the neighbours' features
    (``c_in`` channels, 0 for none); a K×K matrix X learned from the
    flattened local coordinates (three DenseBlocks of K², the first with
    ReLU before BatchNorm, the last without either); ``X·cat``; a
    depthwise ``(c, K, depth_multiplier)`` product over the neighbour
    axis, channel-major, plus its bias; then a bias-free Dense to
    ``c_out``, ReLU and BatchNorm. Parameters keep the JAX layout:
    ``depthwise [c, K, dm]``, ``depthwise_bias [c·dm]``."""

    def __init__(self, c_in: int, c_out: int, k: int, c_mid: int,
                 depth_multiplier: int):
        super().__init__()
        self.k = k
        self.lift1 = DenseBlock(3, c_mid)
        self.lift2 = DenseBlock(c_mid, c_mid)
        self.x1 = DenseBlock(k * 3, k * k, act_before_bn=True)
        self.x2 = DenseBlock(k * k, k * k)
        self.x3 = DenseBlock(k * k, k * k, with_bn=False, act=False)
        c = c_mid + c_in
        # variance_scaling(1/3, fan_in, uniform, batch_axis=0): the fan
        # is K alone (channels are groups), so U(±1/√K)
        self.depthwise = nn.Parameter(torch.empty(c, k, depth_multiplier))
        reference_linear_init(self.depthwise, k)
        self.depthwise_bias = nn.Parameter(torch.zeros(c * depth_multiplier))
        self.dense = nn.Linear(c * depth_multiplier, c_out, bias=False)
        reference_linear_init(self.dense.weight, c * depth_multiplier)
        self.bn = BatchNorm(c_out)

    def forward(self, rep: torch.Tensor, pts: torch.Tensor,
                fts: Optional[torch.Tensor]) -> torch.Tensor:
        """``rep [B, P, 3]``, ``pts [B, P, K, 3]``, ``fts [B, P, K, C_in]``
        or None → ``[B, P, C_out]``."""
        b, p, k = pts.shape[:3]
        local = pts - rep[:, :, None, :]
        lifted = self.lift2(self.lift1(local))
        cat = lifted if fts is None else torch.cat([lifted, fts], dim=-1)
        x = self.x3(self.x2(self.x1(local.reshape(b, p, k * 3))))
        h = torch.matmul(x.reshape(b, p, k, k), cat)    # [B, P, K, c]
        h = torch.einsum("bpkc,ckm->bpcm", h, self.depthwise)
        h = h.reshape(b, p, -1) + self.depthwise_bias
        h = F.relu(self.dense(h))  # the reference's SepConv: act before BN
        return self.bn(h.reshape(b * p, -1)).reshape(b, p, -1)


class PointCNNLayer(nn.Module):
    """FPS (optional) + dilated kNN + :class:`XConv`
    (``models/pointcnn.py:157``). ``p`` representatives, -1 for every
    point; ``c_in`` 0 for a layer without input features."""

    def __init__(self, c_in: int, c_out: int, k: int, d: int = 1,
                 p: int = -1, feat_in: Optional[int] = None):
        """``feat_in``: the width of the features the layer is given
        (``c_in`` unless said)."""
        super().__init__()
        self.k, self.d, self.p = k, d, p
        if c_in != 0:
            self.lift = DenseBlock(c_in if feat_in is None else feat_in,
                                   c_out // 2)
            c_mid, dm, c_feat = c_out // 4, int(math.ceil(c_out / c_in)), \
                c_out // 2
        else:
            self.lift = None
            c_mid, dm, c_feat = c_out // 2, 4, 0
        self.xconv = XConv(c_feat, c_out, k, c_mid, dm)

    def neighbours(self, rep: torch.Tensor, pts: torch.Tensor,
                   fts: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``(pts_reg [B, P, K, 3], fts_reg [B, P, K, C] or None)``: every
        ``d``-th of each representative's ``k·d`` nearest points, by the
        JAX layer's route rule (``models/pointcnn.py:193-217``)."""
        n = pts.shape[1]
        if (n % 128 == 0 and self.k * self.d <= n and fts is not None
                and pts.dtype == torch.float32
                and fts.dtype == torch.float32):
            _, g = dispatch.knn_gather(rep, pts, torch.cat([pts, fts], -1),
                                       self.k, stride=self.d)
            return g[..., :3], g[..., 3:]
        _, idx = geometry.knn(rep, pts, self.k * self.d)
        idx = idx[..., ::self.d]
        return (geometry.gather_points(pts, idx),
                None if fts is None else geometry.gather_points(fts, idx))

    def forward(self, pts: torch.Tensor, fts: Optional[torch.Tensor],
                rep: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(rep [B, P, 3], out [B, P, c_out])``; ``rep`` given (the
        decoders) skips FPS."""
        if rep is None:
            if 0 < self.p < pts.shape[1]:
                rep = geometry.gather_points(pts, dispatch.fps(pts, self.p))
            else:
                rep = pts
        fts = None if self.lift is None or fts is None else self.lift(fts)
        pts_reg, fts_reg = self.neighbours(rep, pts, fts)
        return rep, self.xconv(rep, pts_reg, fts_reg)


class PointCNNCls(nn.Module):
    """``PointCNNCls`` (``models/pointcnn.py:273``). ``feat_channels``:
    the width of the per-point features the model is given (0: none, the
    coordinates stand in for them)."""

    def __init__(self, n_classes: int = 40, dropout: float = 0.5,
                 feat_channels: int = 0):
        super().__init__()
        self.layers = nn.ModuleList([
            PointCNNLayer(3, 48, k=8, d=1, p=-1,
                          feat_in=feat_channels or 3),
            PointCNNLayer(48, 96, k=12, d=2, p=384),
            PointCNNLayer(96, 192, k=16, d=2, p=128),
            PointCNNLayer(192, 384, k=16, d=3, p=128)])
        self.fc1 = DenseBlock(384, 192)
        self.fc2 = DenseBlock(192, 128, drop_rate=dropout)
        self.out = DenseBlock(128, n_classes, with_bn=False, act=False)

    def forward(self, xyz: torch.Tensor,
                feats: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits ``[B, n_classes]``; ``generator`` draws the dropout mask
        in training."""
        pts, fts = xyz, (feats if feats is not None else xyz)
        for layer in self.layers:
            pts, fts = layer(pts, fts)
        h = self.fc2(self.fc1(fts), generator)
        return self.out(h).mean(dim=1)


class PointCNNPartSeg(nn.Module):
    """``PointCNNPartSeg`` (``models/pointcnn.py:224``). ``cls_label`` and
    ``feats`` are ignored; ``feat_channels`` and ``dropout`` are accepted
    for the registry's sake and ignored (the model has no dropout), and
    so is a train step's ``generator``."""

    def __init__(self, part_num: int = 50, feat_channels: int = 0,
                 dropout: float = 0.0):
        super().__init__()
        del feat_channels, dropout
        self.encoders = nn.ModuleList([
            PointCNNLayer(3, 256, k=8, d=1, p=-1),
            PointCNNLayer(256, 256, k=12, d=1, p=768),
            PointCNNLayer(256, 512, k=16, d=1, p=384),
            PointCNNLayer(512, 1024, k=16, d=1, p=128)])
        # (c_in, c_out, k, skip width) of the decoders, coarsest first
        dec = ((1024, 1024, 16, 1024), (1024, 512, 16, 512),
               (512, 256, 12, 256), (256, part_num, 8, 256))
        self.decoders = nn.ModuleList(
            PointCNNLayer(ci, co, k=k) for ci, co, k, _ in dec)
        self.fuse = nn.ModuleList(DenseBlock(co + skip, co)
                                  for _, co, _, skip in dec)

    def forward(self, xyz: torch.Tensor, cls_label: torch.Tensor,
                feats: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Per-point logits ``[B, N, part_num]``."""
        del cls_label, feats, generator
        levels, pts, fts = [], xyz, xyz
        for enc in self.encoders:
            pts, fts = enc(pts, fts)
            levels.append((pts, fts))
        # the coarsest decoder projects the coarsest level onto itself
        pts_l, fts_l = levels[-1]
        for dec, fuse, (pts_h, fts_h) in zip(self.decoders, self.fuse,
                                             reversed(levels)):
            _, proj = dec(pts_l, fts_l, rep=pts_h)
            pts_l, fts_l = pts_h, fuse(torch.cat([proj, fts_h], dim=-1))
        return fts_l
