"""DGCNN classification and part segmentation (counterpart of
``pointcloudlib_tpu/models/dgcnn.py``).

Classification: k=20 nearest neighbours in the current feature space, edge features
``concat(x_j − x_i, x_i)``, four EdgeConvs 64/64/128/256, conv5 → 1024
on their 512-wide concatenation, global max ‖ mean, then the head
512 → 256 (with a Dense bias) → n_classes with dropout after each of the
first two; LeakyReLU(0.2) throughout. Part segmentation: k=40, two
two-layer EdgeConvs (64, 64) and one EdgeConv 64, conv6 192 → 1024 and
a global max, a label embedding 16 → 64, and the decoder 1280 → 256 →
256 → 128 → part_num with dropout after the first two.

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

from pointcloudlib_tpu_torch.models.pointnet2 import N_CATEGORIES, dropout
from pointcloudlib_tpu_torch.nn.layers import (
    DenseBNAct,
    _bf16_mm,
    reference_linear_init,
    update_running,
)
from pointcloudlib_tpu_torch.ops import index_points, knn
from pointcloudlib_tpu_torch.ops.kernels.fused_edge import (
    Edge2Stats,
    EdgeStats,
    fused_edge2_conv,
    fused_edge2_conv_knn,
    fused_edge2_eval,
    fused_edge2_eval_knn,
    fused_edge_conv,
    fused_edge_conv_knn,
    fused_edge_eval,
    fused_edge_eval_knn,
)
from pointcloudlib_tpu_torch.parallel.mesh import DPGroup

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


def _graph(x: torch.Tensor, k: int) -> Optional[torch.Tensor]:
    """The neighbour index of the route of N % 128 ≠ 0 (the standalone
    kNN, no gradient through it), or ``None`` where the kernels build the
    graph inside (``models/dgcnn.py:93-96,169-172``)."""
    if x.shape[1] % 128 == 0:
        return None
    return knn(x.detach(), x.detach(), k)[1]


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
    ``var``. With a ``group`` of more than one rank
    (``parallel.sync_batchnorm``) the train kernels' statistics and
    backward sums are summed over the ranks."""

    group: Optional[DPGroup] = None

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
        idx = _graph(x, self.k)
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
                                             self.bn_bias, self.k, SLOPE,
                                             group=self.group)
        else:
            out, batch = fused_edge_conv(q, off, idx, self.bn_scale,
                                         self.bn_bias, SLOPE,
                                         group=self.group)
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


class Fused2EdgeConv(nn.Module):
    """The two-layer EdgeConv of part segmentation (``Fused2EdgeConv``,
    ``models/dgcnn.py:144``): ``max_k leaky(BN2(leaky(BN1(h1))·W2))`` with
    ``h1 = q[j] − off_i`` as in :class:`FusedEdgeConv`, whose
    :meth:`~FusedEdgeConv.prepare` forms ``q`` and ``off``; the same two
    routes and running-statistics updates. Parameters keep the JAX names
    and layouts: ``w [2C, F1]``, ``w2 [F1, F2]``, ``bn{1,2}_scale``,
    ``bn{1,2}_bias``; buffers ``mean{1,2}``, ``var{1,2}``. A ``group``
    syncs both layers' statistics as in :class:`FusedEdgeConv`."""

    group: Optional[DPGroup] = None

    def __init__(self, in_channels: int, features, k: int):
        super().__init__()
        f1, f2 = features
        self.k = k
        self.w = nn.Parameter(torch.empty(2 * in_channels, f1))
        reference_linear_init(self.w, 2 * in_channels)
        self.w2 = nn.Parameter(torch.empty(f1, f2))
        reference_linear_init(self.w2, f1)
        for l, c in ((1, f1), (2, f2)):
            self.register_parameter(f"bn{l}_scale", nn.Parameter(torch.ones(c)))
            self.register_parameter(f"bn{l}_bias", nn.Parameter(torch.zeros(c)))
            self.register_buffer(f"mean{l}", torch.zeros(c))
            self.register_buffer(f"var{l}", torch.ones(c))

    prepare = FusedEdgeConv.prepare

    def stats(self) -> Edge2Stats:
        return Edge2Stats(self.mean1, self.var1, self.mean2, self.var2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        idx = _graph(x, self.k)
        q, off = self.prepare(x)
        p = (self.w2, self.bn1_scale, self.bn1_bias, self.bn2_scale,
             self.bn2_bias)
        if not self.training:
            if idx is None:
                return fused_edge2_eval_knn(x, q, off, *p, self.stats(),
                                            self.k, SLOPE)
            return fused_edge2_eval(q, off, idx, *p, self.stats(), SLOPE)
        if idx is None:
            out, batch = fused_edge2_conv_knn(x, q, off, *p, self.k, SLOPE,
                                              group=self.group)
        else:
            out, batch = fused_edge2_conv(q, off, idx, *p, SLOPE,
                                          group=self.group)
        for running, value in zip(self.stats(), batch):
            update_running(running, value)
        return out


class DGCNNPartSeg(nn.Module):
    """``DGCNNPartSeg`` (``models/dgcnn.py:260``) with its fused path on.
    ``feat_channels`` is accepted and ignored: the model reads xyz only.
    The JAX model fixes both decoder dropouts at 0.5; here the rate is an
    argument, for deterministic comparisons."""

    def __init__(self, part_num: int = 50, k: int = 40,
                 feat_channels: int = 0, dropout: float = 0.5):
        super().__init__()
        del feat_channels
        self.edge1 = Fused2EdgeConv(3, (64, 64), k)
        self.edge2 = Fused2EdgeConv(64, (64, 64), k)
        self.edge3 = FusedEdgeConv(64, 64, k)
        self.conv6 = DenseBNAct(192, 1024, act=_lrelu)
        self.label = DenseBNAct(N_CATEGORIES, 64, act=_lrelu)
        self.dec1 = DenseBNAct(1280, 256, act=_lrelu)
        self.dec2 = DenseBNAct(256, 256, act=_lrelu)
        self.dec3 = DenseBNAct(256, 128, act=_lrelu)
        self.dropout = dropout
        self.out = nn.Linear(128, part_num, bias=False)
        reference_linear_init(self.out.weight, 128)

    def forward(self, xyz: torch.Tensor, cls_label: torch.Tensor,
                feats: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Per-point logits ``[B, N, part_num]`` for ``xyz [B, N, 3]`` and
        the object one-hot ``cls_label [B, 16]``; ``feats`` is ignored,
        ``generator`` draws the decoder's two dropout masks in training,
        in order."""
        del feats
        b, n, _ = xyz.shape
        x1 = self.edge1(xyz)
        x2 = self.edge2(x1)
        x3 = self.edge3(x2)
        x = self.conv6(torch.cat([x1, x2, x3], dim=-1))
        g = torch.cat([x.amax(dim=1),
                       self.label(cls_label.to(xyz.dtype))], dim=-1)
        h = torch.cat([g[:, None, :].expand(b, n, g.shape[-1]), x1, x2, x3],
                      dim=-1)
        h = dropout(self.dec1(h), self.dropout, self.training, generator)
        h = dropout(self.dec2(h), self.dropout, self.training, generator)
        return self.out(self.dec3(h))
