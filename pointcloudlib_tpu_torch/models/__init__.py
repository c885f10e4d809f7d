"""Model registry (counterpart of ``pointcloudlib_tpu/models``).

PointNet++ SSG and MSG, DGCNN and PointConv classification, and
PointNet++, DGCNN and PointConv part segmentation are ported so far; the
other entries of the JAX registry follow in later slices (ROADMAP.md)."""

from __future__ import annotations

from pointcloudlib_tpu_torch.models.dgcnn import DGCNN, DGCNNPartSeg
from pointcloudlib_tpu_torch.models.pointconv import (
    PointConvDensityCls,
    PointConvPartSeg,
)
from pointcloudlib_tpu_torch.models.pointnet2 import (
    PointNet2MSG,
    PointNet2PartSeg,
    PointNet2SSG,
)

CLS_MODELS = {"pointnet2": PointNet2SSG, "pointnet2_msg": PointNet2MSG,
              "dgcnn": DGCNN, "pointconv": PointConvDensityCls}
SEG_MODELS = {"pointnet2": PointNet2PartSeg, "dgcnn": DGCNNPartSeg,
              "pointconv": PointConvPartSeg}


def get_cls_model(name: str, n_classes: int = 40, **kw):
    if name not in CLS_MODELS:
        raise NotImplementedError(
            f"cls model {name!r} is not yet ported; ported: "
            f"{sorted(CLS_MODELS)}")
    return CLS_MODELS[name](n_classes=n_classes, **kw)


def get_seg_model(name: str, part_num: int = 50, **kw):
    if name not in SEG_MODELS:
        raise NotImplementedError(
            f"seg model {name!r} is not yet ported; ported: "
            f"{sorted(SEG_MODELS)}")
    return SEG_MODELS[name](part_num=part_num, **kw)
