"""Model registry (counterpart of ``pointcloudlib_tpu/models``).

PointNet, PointNet++ SSG and MSG, DGCNN, PointConv and PointCNN
classification, and PointNet, PointNet++, DGCNN, PointConv and PointCNN
part segmentation are ported; KPConv (``kpconv``, ``kpconv_deform``)
follows in a later slice (ROADMAP.md)."""

from __future__ import annotations

from pointcloudlib_tpu_torch.models.dgcnn import DGCNN, DGCNNPartSeg
from pointcloudlib_tpu_torch.models.pointcnn import (
    PointCNNCls,
    PointCNNPartSeg,
)
from pointcloudlib_tpu_torch.models.pointconv import (
    PointConvDensityCls,
    PointConvPartSeg,
)
from pointcloudlib_tpu_torch.models.pointnet import PointNet, PointNetPartSeg
from pointcloudlib_tpu_torch.models.pointnet2 import (
    PointNet2MSG,
    PointNet2PartSeg,
    PointNet2SSG,
)

CLS_MODELS = {"pointnet": PointNet, "pointnet2": PointNet2SSG,
              "pointnet2_msg": PointNet2MSG, "dgcnn": DGCNN,
              "pointconv": PointConvDensityCls, "pointcnn": PointCNNCls}
SEG_MODELS = {"pointnet": PointNetPartSeg, "pointnet2": PointNet2PartSeg,
              "dgcnn": DGCNNPartSeg, "pointconv": PointConvPartSeg,
              "pointcnn": PointCNNPartSeg}


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
