"""KPConv, kernel-point convolution networks (counterpart of
``pointcloudlib_tpu/models/kpconv``): the pyramid is built on the
model's device per batch (``pyramid.py``) over dense padded ``[B, N_l,
...]`` tensors with validity masks, so one set of shapes serves every
batch."""

from pointcloudlib_tpu_torch.models.kpconv.adapter import (
    KPConvCls,
    KPConvDeformCls,
)
from pointcloudlib_tpu_torch.models.kpconv.kernel_points import load_kernels
from pointcloudlib_tpu_torch.models.kpconv.model import KPCNN, KPConvConfig
from pointcloudlib_tpu_torch.models.kpconv.pyramid import (
    Pyramid,
    build_pyramid,
    grid_subsample,
    radius_neighbors,
)

__all__ = [
    "KPCNN",
    "KPConvCls",
    "KPConvConfig",
    "KPConvDeformCls",
    "Pyramid",
    "build_pyramid",
    "grid_subsample",
    "load_kernels",
    "radius_neighbors",
]
