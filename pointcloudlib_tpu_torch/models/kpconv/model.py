"""KPCNN, the kernel-point CNN for classification, rigid and deformable
(counterpart of ``pointcloudlib_tpu/models/kpconv/model.py``): dense
``[B, N_l, C]`` layers with validity masks over the on-device pyramid
(``pyramid.py``).

A KPConv gathers ``[support xyz ‖ features]`` at its neighbour indices
in one :func:`~pointcloudlib_tpu_torch.ops.geometry.gather_points` (the
JAX ``index_points``' cost gate: the row-gather kernel on the card where
the gate says so, its backward the row scatter-add), weighs each
neighbour by its linear influence on each kernel point and applies the
kernel points' weights as two einsums in float32, as the JAX package
declares them. The deformable KPConv predicts its kernel points' offsets
(and with ``modulated`` their modulations ``2σ(·)``) by a rigid KPConv
over the same neighbourhood, and adds the fitting and repulsive
regulariser, averaged over the valid queries only.

A forward leaves ``aux`` on the model: ``reg_loss`` (the sum of the
deformable layers' regularisers; ``None`` for the rigid model) and
``voxel_overflow`` (the voxels the pyramid's caps cut, float32), both
tensors on the model's device, read by the train step without a host
sync. They replace the JAX package's ``sow``.

BatchNorm is masked (statistics over valid points, the biased variance)
with flax's momentum 0.95; LeakyReLU has slope 0.1 and, as flax's,
gradient 1 at 0. The strided blocks' max-pool splits its gradient among
tied maxima, as ``jnp.max`` does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pointcloudlib_tpu_torch.models.kpconv.kernel_points import load_kernels
from pointcloudlib_tpu_torch.models.kpconv.pyramid import (
    Pyramid,
    build_pyramid,
)
from pointcloudlib_tpu_torch.nn.layers import reference_linear_init
from pointcloudlib_tpu_torch.ops import geometry
from pointcloudlib_tpu_torch.parallel.mesh import (
    DPGroup,
    all_reduce_sum_grad,
    synced,
)

_BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class KPConvConfig:
    """The ModelNet40 configuration (``model.py:36``)."""

    num_classes: int = 40
    architecture: Tuple[str, ...] = (
        "simple",
        "resnetb",
        "resnetb_strided",
        "resnetb",
        "resnetb",
        "resnetb_strided",
        "resnetb",
        "resnetb",
        "resnetb_strided",
        "resnetb",
        "resnetb",
        "resnetb_strided",
        "resnetb",
        "resnetb",
        "global_average",
    )
    num_kernel_points: int = 15
    first_subsampling_dl: float = 0.02
    conv_radius: float = 2.5
    deform_radius: float = 6.0
    kp_extent: float = 1.2
    kp_influence: str = "linear"          # constant | linear | gaussian
    aggregation_mode: str = "sum"         # sum | closest
    in_features_dim: int = 1
    first_features_dim: int = 64
    modulated: bool = True
    use_batch_norm: bool = True
    batch_norm_momentum: float = 0.95     # flax's convention
    # neighbour widths per layer; calibrate.calibrate_pyramid derives
    # them from data (the CLI does)
    neighborhood_limits: Tuple[int, ...] = (22, 35, 41, 42, 37)
    # static per-layer point caps; None → pyramid.pyramid_shapes'
    caps: Optional[Tuple[int, ...]] = None
    deform_fitting_power: float = 1.0
    repulse_extent: float = 1.2


def deformable_architecture(architecture: Tuple[str, ...]
                            ) -> Tuple[str, ...]:
    """The deformable variant's blocks: from the tenth on, every
    ``resnetb`` block deformable (``adapter.py:75-81``)."""
    return tuple(b.replace("resnetb", "resnetb_deformable")
                 if i >= 9 and b.startswith("resnetb") else b
                 for i, b in enumerate(architecture))


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.1) with flax's gradient 1 at 0."""
    return torch.where(x >= 0, x, 0.1 * x)


class MaskedBatchNorm(nn.Module):
    """BatchNorm whose statistics see valid points only (``model.py:104``):
    in training the masked mean and biased variance over every axis but
    the last, the running ones updated as ``m·running + (1 − m)·batch``;
    in eval the running ones. ``use_bn=False`` is a learned bias alone.
    Names as ``nn.BatchNorm1d``'s (``weight`` for flax's ``scale``). With
    a ``group`` of more than one rank (``parallel.sync_batchnorm``) the
    masked count and Σx, then Σ(x − mean)², are summed over the ranks
    (``_masked_moments`` with ``axis_name``, ``model.py:84-98``): ranks
    carry different valid counts, so the sums are reduced, never the
    moments."""

    group: Optional[DPGroup] = None

    def __init__(self, features: int, use_bn: bool = True,
                 momentum: float = 0.95):
        super().__init__()
        self.use_bn, self.momentum = use_bn, momentum
        self.bias = nn.Parameter(torch.zeros(features))
        if use_bn:
            self.weight = nn.Parameter(torch.ones(features))
            self.register_buffer("running_mean", torch.zeros(features))
            self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if not self.use_bn:
            return x + self.bias
        if self.training:
            w = mask.to(x.dtype)[..., None]
            dims = tuple(range(x.dim() - 1))
            if synced(self.group):
                s = all_reduce_sum_grad(
                    torch.cat([(x * w).sum(dims), w.sum().reshape(1)]),
                    self.group)
                cnt = torch.clamp_min(s[-1], 1.0)
                mean = s[:-1] / cnt
                var = all_reduce_sum_grad(
                    (w * (x - mean) ** 2).sum(dims), self.group) / cnt
            else:
                cnt = torch.clamp_min(w.sum(), 1.0)
                mean = (x * w).sum(dims) / cnt
                var = (w * (x - mean) ** 2).sum(dims) / cnt
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * torch.rsqrt(var + _BN_EPS) * self.weight \
            + self.bias


class UnaryBlock(nn.Module):
    """A bias-free float32 Dense, :class:`MaskedBatchNorm` and
    LeakyReLU(0.1) unless ``no_relu`` (``model.py:152``)."""

    def __init__(self, in_dim: int, out_dim: int, use_bn: bool = True,
                 momentum: float = 0.95, no_relu: bool = False):
        super().__init__()
        self.dense = nn.Linear(in_dim, out_dim, bias=False)
        reference_linear_init(self.dense.weight, in_dim)
        self.bn = MaskedBatchNorm(out_dim, use_bn, momentum)
        self.no_relu = no_relu

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.bn(F.linear(x, self.dense.weight), mask)
        return x if self.no_relu else _lrelu(x)


class KPConvOp(nn.Module):
    """The kernel-point convolution (``model.py:170``): ``q [B, M, 3]``,
    ``s [B, N, 3]``, ``feats [B, N, C]``, ``idx [B, M, K]`` (sentinel N
    allowed), ``nmask [B, M, K]`` → ``([B, M, out_dim], regulariser or
    None)``. ``weights [P, C, out_dim]`` as the JAX parameter; the kernel
    points are a buffer made by ``load_kernels(radius, P)``, outside the
    state dict."""

    def __init__(self, in_dim: int, out_dim: int, radius: float,
                 kp_extent: float, num_kpoints: int = 15,
                 influence: str = "linear", aggregation: str = "sum",
                 deformable: bool = False, modulated: bool = False,
                 fitting_power: float = 1.0, repulse_extent: float = 1.2):
        super().__init__()
        if influence not in ("constant", "linear", "gaussian"):
            raise ValueError(influence)
        if aggregation not in ("sum", "closest"):
            raise ValueError(aggregation)
        p = num_kpoints
        self.p, self.kp_extent = p, kp_extent
        self.influence, self.aggregation = influence, aggregation
        self.deformable, self.modulated = deformable, modulated
        self.fitting_power = fitting_power
        self.repulse_extent = repulse_extent
        self.register_buffer(
            "kernel_points", torch.tensor(load_kernels(radius, p)),
            persistent=False)
        # variance_scaling(2.0, "fan_in", "uniform"), fan-in P·C
        self.weights = nn.Parameter(torch.empty(p, in_dim, out_dim))
        bound = math.sqrt(6.0 / (p * in_dim))
        nn.init.uniform_(self.weights, -bound, bound)
        if deformable:
            off_dim = (3 + 1) * p if modulated else 3 * p
            self.offset_conv = KPConvOp(in_dim, off_dim, radius, kp_extent,
                                        p, influence, aggregation)
            self.offset_bias = nn.Parameter(torch.zeros(off_dim))

    def _regulariser(self, d2: torch.Tensor, kpts: torch.Tensor,
                     nmask: torch.Tensor) -> torch.Tensor:
        """Fitting (each kernel point's nearest valid neighbour) plus
        repulsion between kernel points, over the valid queries only
        (``model.py:250-296``)."""
        p, ext = self.p, self.kp_extent
        inf = torch.full_like(d2, float("inf"))
        min_d2 = torch.where(nmask[..., None], d2, inf).amin(dim=2)
        valid_q = nmask.any(dim=2)
        vq = valid_q.to(d2.dtype)
        nvalid = torch.clamp_min(vq.sum(), 1.0)
        finite = torch.where(torch.isfinite(min_d2), min_d2,
                             torch.zeros_like(min_d2))
        fitting = (finite * vq[..., None]).sum() / (nvalid * p) / ext**2
        locs = kpts / ext
        pd = torch.sqrt(((locs[..., :, None, :] - locs[..., None, :, :])
                         ** 2).sum(-1) + 1e-12)
        off_diag = 1.0 - torch.eye(p, device=d2.device, dtype=d2.dtype)
        rep = torch.clamp_max(pd - self.repulse_extent, 0.0) ** 2 * off_diag
        repulsive = (rep.sum(dim=(-2, -1)) * vq).sum() / nvalid / p
        return self.fitting_power * (2.0 * fitting + repulsive)

    def forward(self, q: torch.Tensor, s: torch.Tensor, feats: torch.Tensor,
                idx: torch.Tensor, nmask: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        kp = self.kernel_points
        p = self.p
        n = s.shape[1]
        safe = torch.clamp_max(idx, n - 1)
        # one gather of [coordinates ‖ features]; the coordinates carry
        # no gradient (the pyramid is geometry)
        g = geometry.gather_points(torch.cat([s, feats], dim=-1), safe)
        nbr = g[..., :3].detach() - q[:, :, None, :]
        nfeat = torch.where(nmask[..., None], g[..., 3:],
                            torch.zeros_like(g[..., 3:]))

        reg = modul = None
        if self.deformable:
            raw, _ = self.offset_conv(q, s, feats, idx, nmask)
            raw = raw + self.offset_bias
            offsets = raw[..., :3 * p].reshape(*q.shape[:2], p, 3)
            kpts = kp + offsets * self.kp_extent              # [B, M, P, 3]
            if self.modulated:
                modul = 2.0 * torch.sigmoid(raw[..., 3 * p:])
            d2 = ((nbr[:, :, :, None, :] - kpts[:, :, None, :, :]) ** 2
                  ).sum(-1)                                  # [B, M, K, P]
            reg = self._regulariser(d2, kpts, nmask)
        else:
            d2 = ((nbr[:, :, :, None, :] - kp) ** 2).sum(-1)

        if self.influence == "constant":
            infl = torch.ones_like(d2)
        elif self.influence == "linear":
            # eps inside the sqrt: its gradient at 0 is inf
            infl = torch.maximum(
                1.0 - torch.sqrt(d2 + 1e-12) / self.kp_extent,
                torch.zeros_like(d2))
        else:
            sigma = self.kp_extent * 0.3
            infl = torch.exp(-d2 / (2 * sigma * sigma))
        if self.aggregation == "closest":
            infl = infl * F.one_hot(d2.argmin(dim=-1), p).to(infl.dtype)
        infl = torch.where(nmask[..., None], infl, torch.zeros_like(infl))

        weighted = torch.einsum("bmkp,bmkc->bmpc", infl, nfeat)
        if modul is not None:
            weighted = weighted * modul[..., None]
        return torch.einsum("bmpc,pcd->bmd", weighted, self.weights), reg


def _pool_max(feats: torch.Tensor, idx: torch.Tensor, nmask: torch.Tensor
              ) -> torch.Tensor:
    """Max over the valid pooled neighbours (``model.py:339``), 0 for a
    row with none; the gradient split among ties."""
    n = feats.shape[1]
    g = geometry.gather_points(feats, torch.clamp_max(idx, n - 1))
    g = torch.where(nmask[..., None], g, torch.full_like(g, -float("inf")))
    out = g.amax(dim=2)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def _block_inputs(pyr: Pyramid, layer: int, strided: bool):
    """``(q, qmask, idx, nmask)`` of a block at ``layer``: the next
    layer's points and the pools where ``strided``, else the layer's own
    points and neighbours."""
    if strided:
        return (pyr.points[layer + 1], pyr.masks[layer + 1],
                pyr.pools[layer], pyr.pool_masks[layer])
    return (pyr.points[layer], pyr.masks[layer], pyr.neighbors[layer],
            pyr.neighbor_masks[layer])


def _kpconv(cfg: KPConvConfig, in_dim: int, out_dim: int, radius: float,
            extent: float, deformable: bool) -> KPConvOp:
    return KPConvOp(in_dim, out_dim, radius, extent, cfg.num_kernel_points,
                    cfg.kp_influence, cfg.aggregation_mode, deformable,
                    cfg.modulated and deformable, cfg.deform_fitting_power,
                    cfg.repulse_extent)


class SimpleBlock(nn.Module):
    """KPConv to ``out_dim / 2``, MaskedBatchNorm, LeakyReLU
    (``model.py:352``)."""

    def __init__(self, in_dim: int, out_dim: int, radius: float,
                 kp_extent: float, cfg: KPConvConfig, strided: bool = False,
                 deformable: bool = False):
        super().__init__()
        self.strided = strided
        self.conv = _kpconv(cfg, in_dim, out_dim // 2, radius, kp_extent,
                            deformable)
        self.bn = MaskedBatchNorm(out_dim // 2, cfg.use_batch_norm,
                                  cfg.batch_norm_momentum)

    def forward(self, x, pyr: Pyramid, layer: int):
        q, qm, idx, nm = _block_inputs(pyr, layer, self.strided)
        h, reg = self.conv(q, pyr.points[layer], x, idx, nm)
        return _lrelu(self.bn(h, qm)), reg


class ResnetBottleneckBlock(nn.Module):
    """A unary to ``out_dim / 4`` (where the input is not that wide),
    KPConv, MaskedBatchNorm, LeakyReLU, a unary to ``out_dim`` without
    activation, plus the shortcut (max-pooled where strided, a unary
    where the widths differ), then LeakyReLU (``model.py:390``)."""

    def __init__(self, in_dim: int, out_dim: int, radius: float,
                 kp_extent: float, cfg: KPConvConfig, strided: bool = False,
                 deformable: bool = False):
        super().__init__()
        self.strided = strided
        bn, mom = cfg.use_batch_norm, cfg.batch_norm_momentum
        mid = out_dim // 4
        self.unary1 = (UnaryBlock(in_dim, mid, bn, mom)
                       if in_dim != mid else None)
        self.conv = _kpconv(cfg, mid, mid, radius, kp_extent, deformable)
        self.bn = MaskedBatchNorm(mid, bn, mom)
        self.unary2 = UnaryBlock(mid, out_dim, bn, mom, no_relu=True)
        self.shortcut = (UnaryBlock(in_dim, out_dim, bn, mom, no_relu=True)
                         if in_dim != out_dim else None)

    def forward(self, x, pyr: Pyramid, layer: int):
        q, qm, idx, nm = _block_inputs(pyr, layer, self.strided)
        s, sm = pyr.points[layer], pyr.masks[layer]
        h = x if self.unary1 is None else self.unary1(x, sm)
        h, reg = self.conv(q, s, h, idx, nm)
        h = self.unary2(_lrelu(self.bn(h, qm)), qm)
        shortcut = _pool_max(x, idx, nm) if self.strided else x
        if self.shortcut is not None:
            shortcut = self.shortcut(shortcut, qm)
        return _lrelu(h + shortcut), reg


class KPCNN(nn.Module):
    """The architecture's blocks in order (``model.py:450``), the global
    average over the last layer's valid points, then a 1024-wide unary
    and the class logits, both with a bias and without BatchNorm.
    ``blocks[i]`` holds ``(layer, block)``."""

    def __init__(self, cfg: KPConvConfig = KPConvConfig()):
        super().__init__()
        self.cfg = cfg
        r = cfg.first_subsampling_dl * cfg.conv_radius
        in_dim, out_dim, layer = cfg.in_features_dim, cfg.first_features_dim, 0
        blocks, self.layers = [], []
        for block in cfg.architecture:
            if "global" in block or "upsample" in block:
                break
            extent = r * cfg.kp_extent / cfg.conv_radius
            strided = "strided" in block
            deformable = "deformable" in block
            if "simple" in block:
                blocks.append(SimpleBlock(in_dim, out_dim, r, extent, cfg,
                                          strided, deformable))
                in_dim = out_dim // 2
            elif "resnetb" in block:
                blocks.append(ResnetBottleneckBlock(
                    in_dim, out_dim, r, extent, cfg, strided, deformable))
                in_dim = out_dim
            elif block == "unary":
                blocks.append(UnaryBlock(in_dim, out_dim,
                                         cfg.use_batch_norm,
                                         cfg.batch_norm_momentum))
                in_dim = out_dim
            else:
                raise ValueError(f"unknown block {block!r}")
            self.layers.append(layer)
            if strided:
                layer += 1
                r *= 2
                out_dim *= 2
        self.blocks = nn.ModuleList(blocks)
        self.head = UnaryBlock(in_dim, 1024, use_bn=False)
        self.out = UnaryBlock(1024, cfg.num_classes, use_bn=False,
                              no_relu=True)
        self.last_layer = layer
        self.aux: dict = {}

    def pyramid(self, xyz: torch.Tensor, mask: Optional[torch.Tensor] = None,
                subsample_input: bool = True) -> Pyramid:
        cfg = self.cfg
        if mask is None:
            mask = torch.ones(xyz.shape[:2], dtype=torch.bool,
                              device=xyz.device)
        return build_pyramid(xyz, mask, cfg.first_subsampling_dl,
                             cfg.conv_radius, cfg.deform_radius,
                             cfg.architecture, cfg.neighborhood_limits,
                             subsample_input=subsample_input, caps=cfg.caps)

    def forward_pyramid(self, pyr: Pyramid) -> torch.Tensor:
        """Logits ``[B, num_classes]`` of the blocks and head on ``pyr``;
        sets ``aux["reg_loss"]``."""
        x = pyr.masks[0][..., None].to(torch.float32).expand(
            -1, -1, self.cfg.in_features_dim)
        regs: List[torch.Tensor] = []
        for layer, block in zip(self.layers, self.blocks):
            if isinstance(block, UnaryBlock):
                x = block(x, pyr.masks[layer])
                continue
            x, reg = block(x, pyr, layer)
            if reg is not None:
                regs.append(reg)
        m = pyr.masks[self.last_layer][..., None].to(x.dtype)
        g = (x * m).sum(dim=1) / torch.clamp_min(m.sum(dim=1), 1.0)
        ones = torch.ones(g.shape[0], dtype=torch.bool, device=g.device)
        self.aux["reg_loss"] = (torch.stack(regs).sum() if regs else None)
        return self.out(self.head(g, ones), ones)

    def forward(self, xyz: torch.Tensor, mask: Optional[torch.Tensor] = None,
                subsample_input: bool = True) -> torch.Tensor:
        """Logits of clouds ``xyz [B, N, 3]``; sets ``aux["reg_loss"]`` and
        ``aux["voxel_overflow"]``."""
        pyr = self.pyramid(xyz, mask, subsample_input)
        logits = self.forward_pyramid(pyr)
        self.aux["voxel_overflow"] = (
            None if pyr.overflow is None
            else pyr.overflow.sum().to(torch.float32))
        return logits
