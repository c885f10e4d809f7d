"""DGCNN classification (counterpart of
``pointcloudlib_tpu/models/dgcnn.py``).

k=20 nearest neighbours in the current feature space, edge features
``concat(x_j − x_i, x_i)``, four EdgeConvs 64/64/128/256, conv5 → 1024
on their 512-wide concatenation, global max ‖ mean, then the head
512 → 256 (with a Dense bias) → n_classes with dropout after each of the
first two; LeakyReLU(0.2) throughout.

Every EdgeConv takes the fused route of the JAX model
(``ops/kernels/fused_edge.py``): at N % 128 == 0 with the graph built
inside the kernels, at other N the standalone kNN (``ops/kernels/knn.py``)
and then the kernels that take its index.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pointcloudlib_tpu_torch.models.pointnet2 import dropout
from pointcloudlib_tpu_torch.nn.layers import (
    DenseBNAct,
    _bf16_mm,
    reference_linear_init,
    update_running,
)
from pointcloudlib_tpu_torch.ops import index_points, knn
from pointcloudlib_tpu_torch.ops.kernels.fused_edge import (
    EdgeStats,
    fused_edge_conv,
    fused_edge_conv_knn,
    fused_edge_eval,
    fused_edge_eval_knn,
)

SLOPE = 0.2


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, SLOPE)


def edge_features(x: torch.Tensor, k: int) -> torch.Tensor:
    """Dynamic-graph edge features ``[B, N, k, 2C]``: the kNN of each
    point in the current feature space, then ``concat(x_j − x_i, x_i)``
    (``edge_features``, ``models/dgcnn.py:23``). The fused route never
    forms them; tests build the unfused layer from them."""
    _, idx = knn(x, x, k)
    nbr = index_points(x, idx)
    ctr = x[:, :, None, :].expand_as(nbr)
    return torch.cat([nbr - ctr, ctr], dim=-1)


class FusedEdgeConv(nn.Module):
    """One EdgeConv through the fused kernels (``FusedEdgeConv``,
    ``models/dgcnn.py:65``): ``q = x·Wa`` and ``off = x·(Wa − Wb)`` from
    bf16-rounded operands with f32 sums, ``Wa − Wb`` formed in f32 and then
    rounded, as the JAX layer does. At N % 128 == 0 the kernels build the
    kNN graph inside; at other N the graph comes from :func:`knn` first,
    with no gradient through it (``models/dgcnn.py:93-96``). Eval runs one
    kernel with the running statistics; training runs the train kernels
    with batch statistics over every edge, then updates the running ones
    (biased variance, momentum 0.9). Parameters keep the JAX names and
    layouts: ``w [2C, F]``, ``bn_scale``, ``bn_bias``; buffers ``mean``,
    ``var``."""

    def __init__(self, in_channels: int, features: int, k: int):
        super().__init__()
        self.k = k
        self.w = nn.Parameter(torch.empty(2 * in_channels, features))
        reference_linear_init(self.w, 2 * in_channels)
        self.bn_scale = nn.Parameter(torch.ones(features))
        self.bn_bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def prepare(self, x: torch.Tensor):
        """``(q, off)`` of the input ``x [B, N, C]``, float32."""
        c = x.shape[-1]
        wa, wb = self.w[:c], self.w[c:]
        return _bf16_mm(x, wa), _bf16_mm(x, wa - wb)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        idx = None
        if x.shape[1] % 128:
            _, idx = knn(x.detach(), x.detach(), self.k)
        q, off = self.prepare(x)
        if not self.training:
            stats = EdgeStats(self.mean, self.var)
            if idx is None:
                return fused_edge_eval_knn(x, q, off, self.bn_scale,
                                           self.bn_bias, stats, self.k,
                                           SLOPE)
            return fused_edge_eval(q, off, idx, self.bn_scale, self.bn_bias,
                                   stats, SLOPE)
        if idx is None:
            out, batch = fused_edge_conv_knn(x, q, off, self.bn_scale,
                                             self.bn_bias, self.k, SLOPE)
        else:
            out, batch = fused_edge_conv(q, off, idx, self.bn_scale,
                                         self.bn_bias, SLOPE)
        update_running(self.mean, batch.mean)
        update_running(self.var, batch.var)
        return out


class EdgeConv(nn.Module):
    """``EdgeConv`` (``models/dgcnn.py:37``) with its fused path on: it
    holds one :class:`FusedEdgeConv`, so that the JAX tree's
    ``EdgeConv_i/FusedEdgeConv_0`` maps one to one."""

    def __init__(self, in_channels: int, features: int, k: int):
        super().__init__()
        self.fused = FusedEdgeConv(in_channels, features, k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fused(x)


class DGCNN(nn.Module):
    """``DGCNN`` (``models/dgcnn.py:226``). ``feat_channels`` is accepted
    and ignored: the model reads xyz only."""

    def __init__(self, n_classes: int = 40, k: int = 20,
                 dropout: float = 0.5, feat_channels: int = 0):
        super().__init__()
        del feat_channels
        widths = ((3, 64), (64, 64), (64, 128), (128, 256))
        self.edge = nn.ModuleList(EdgeConv(i, o, k) for i, o in widths)
        self.conv5 = DenseBNAct(512, 1024, act=_lrelu)
        self.fc1 = DenseBNAct(2048, 512, act=_lrelu)
        self.fc2 = DenseBNAct(512, 256, act=_lrelu, use_bias=True)
        self.dropout = dropout
        self.out = nn.Linear(256, n_classes)
        reference_linear_init(self.out.weight, 256)
        nn.init.zeros_(self.out.bias)

    def forward(self, xyz: torch.Tensor,
                feats: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits ``[B, n_classes]``; ``feats`` is ignored, ``generator``
        draws the head's two dropout masks in training, in order."""
        del feats
        xs, x = [], xyz
        for ec in self.edge:
            x = ec(x)
            xs.append(x)
        x = self.conv5(torch.cat(xs, dim=-1))
        x = torch.cat([x.amax(dim=1), x.mean(dim=1)], dim=-1)
        x = dropout(self.fc1(x), self.dropout, self.training, generator)
        x = dropout(self.fc2(x), self.dropout, self.training, generator)
        return self.out(x)
