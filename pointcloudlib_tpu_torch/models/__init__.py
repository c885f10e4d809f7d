"""Model registry (counterpart of ``pointcloudlib_tpu/models``): every
entry of the JAX package's — PointNet, PointNet++ SSG and MSG, DGCNN,
PointConv, PointCNN and KPConv (rigid and deformable) classification,
and PointNet, PointNet++, DGCNN, PointConv and PointCNN part
segmentation."""

from __future__ import annotations

from pointcloudlib_tpu_torch.models.dgcnn import DGCNN, DGCNNPartSeg
from pointcloudlib_tpu_torch.models.kpconv.adapter import (
    KPConvCls,
    KPConvDeformCls,
)
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
              "pointconv": PointConvDensityCls, "pointcnn": PointCNNCls,
              "kpconv": KPConvCls, "kpconv_deform": KPConvDeformCls}
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
