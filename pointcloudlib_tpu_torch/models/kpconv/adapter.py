"""KPCNN behind the registry's classification interface (counterpart of
``pointcloudlib_tpu/models/kpconv/adapter.py``): ``model(xyz, feats,
generator)`` → logits. KPConv reads the coordinates alone (its input
feature is the constant 1), so ``feats`` is ignored, as are the
registry's ``feat_channels`` and ``dropout`` (KPCNN has no dropout).

``caps`` and ``neighborhood_limits`` fix the pyramid's shapes; the CLI
and the tools pass values calibrated on data (``calibrate.py``), and
``None`` / the default limits are the JAX package's uncalibrated ones.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from pointcloudlib_tpu_torch.models.kpconv.model import (
    KPCNN,
    KPConvConfig,
    deformable_architecture,
)

# ModelNet clouds are unit-sphere normalized; with N ≈ 1024 a 0.05 grid
# gives an occupancy like the reference's 0.02 on its denser clouds
FIRST_SUBSAMPLING_DL = 0.05
NEIGHBORHOOD_LIMITS = (22, 35, 41, 42, 37)


class KPConvCls(nn.Module):
    """Rigid KPConv classification (``adapter.py:22``)."""

    deformable = False

    def __init__(self, n_classes: int = 40,
                 first_subsampling_dl: float = FIRST_SUBSAMPLING_DL,
                 caps: Optional[Tuple[int, ...]] = None,
                 neighborhood_limits: Tuple[int, ...] = NEIGHBORHOOD_LIMITS,
                 feat_channels: int = 0, dropout: float = 0.0):
        super().__init__()
        del feat_channels, dropout
        arch = KPConvConfig().architecture
        if self.deformable:
            arch = deformable_architecture(arch)
        self.cfg = KPConvConfig(
            num_classes=n_classes, first_subsampling_dl=first_subsampling_dl,
            architecture=arch,
            caps=None if caps is None else tuple(caps),
            neighborhood_limits=tuple(neighborhood_limits))
        self.kpcnn = KPCNN(self.cfg)

    def with_shapes(self, caps: Tuple[int, ...],
                    neighborhood_limits: Tuple[int, ...]) -> "KPConvCls":
        """A model that builds its pyramid at these shapes and shares
        every parameter, buffer and block with this one: an occupancy
        bucket's (the JAX CLI's one program per bucket over one train
        state)."""
        other = copy.copy(self)
        other._modules = dict(self._modules)  # a shallow copy shares it
        other.kpcnn = copy.copy(self.kpcnn)  # shares its blocks and head
        other.cfg = other.kpcnn.cfg = dataclasses.replace(
            self.cfg, caps=tuple(caps),
            neighborhood_limits=tuple(neighborhood_limits))
        other.kpcnn.aux = {}
        return other

    @property
    def aux(self) -> dict:
        """``reg_loss`` and ``voxel_overflow`` of the last forward."""
        return self.kpcnn.aux

    def forward(self, xyz: torch.Tensor, feats: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        del feats, generator
        return self.kpcnn(xyz)


class KPConvDeformCls(KPConvCls):
    """Deformable KPConv classification (``adapter.py:53``): every
    ``resnetb`` block from the tenth on, the last two layers, deformable
    and modulated."""

    deformable = True
