"""Host-side data (counterpart of ``pointcloudlib_tpu/data``; numpy only):
dataset loaders, augmentations and fixed-shape batching."""

from pointcloudlib_tpu_torch.data.loader import (
    cls_batches,
    kpconv_cls_batches,
    prefetch,
    seg_batches,
)
from pointcloudlib_tpu_torch.data.modelnet40 import ModelNet40, make_modelnet40
from pointcloudlib_tpu_torch.data.sampler import (
    PotentialSampler,
    kpconv_augment,
)
from pointcloudlib_tpu_torch.data.shapenet import ShapeNetPart, make_shapenet
from pointcloudlib_tpu_torch.data.synthetic import (
    SyntheticModelNet,
    SyntheticShapeNetPart,
)

__all__ = [
    "ModelNet40",
    "PotentialSampler",
    "ShapeNetPart",
    "SyntheticModelNet",
    "SyntheticShapeNetPart",
    "cls_batches",
    "kpconv_augment",
    "kpconv_cls_batches",
    "make_modelnet40",
    "make_shapenet",
    "prefetch",
    "seg_batches",
]
