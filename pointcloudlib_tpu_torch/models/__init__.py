"""Model registry (counterpart of ``pointcloudlib_tpu/models``).

PointNet++ SSG and MSG classification are ported so far; the other
entries of the JAX registry follow in later slices (ROADMAP.md)."""

from __future__ import annotations

from pointcloudlib_tpu_torch.models.pointnet2 import (
    PointNet2MSG,
    PointNet2SSG,
)

CLS_MODELS = {"pointnet2": PointNet2SSG, "pointnet2_msg": PointNet2MSG}


def get_cls_model(name: str, n_classes: int = 40, **kw):
    if name not in CLS_MODELS:
        raise NotImplementedError(
            f"cls model {name!r} is not yet ported; ported: "
            f"{sorted(CLS_MODELS)}")
    return CLS_MODELS[name](n_classes=n_classes, **kw)
