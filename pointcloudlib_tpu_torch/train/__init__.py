"""Training: losses, schedules, the optimizer and the step factories
(counterpart of ``pointcloudlib_tpu/train``)."""

from pointcloudlib_tpu_torch.train.losses import (
    accuracy,
    cross_entropy_seg,
    soft_cross_entropy,
)
from pointcloudlib_tpu_torch.train.schedules import (
    cosine_with_warmup,
    reference_flat_lr,
    step_decay,
)
from pointcloudlib_tpu_torch.train.state import (
    KPCONV_CLIP_NORM,
    clip_grad_global_norm,
    kpconv_optimizer,
    sgd_momentum,
)
from pointcloudlib_tpu_torch.train.metrics import (
    balanced_accuracy,
    fast_confusion,
    shape_ious,
)
from pointcloudlib_tpu_torch.train.trainer import (
    make_cls_eval_step,
    make_cls_pred_step,
    make_cls_train_step,
    make_seg_eval_step,
    make_seg_train_step,
)

__all__ = [
    "KPCONV_CLIP_NORM",
    "accuracy",
    "balanced_accuracy",
    "clip_grad_global_norm",
    "cosine_with_warmup",
    "cross_entropy_seg",
    "fast_confusion",
    "kpconv_optimizer",
    "make_cls_eval_step",
    "make_cls_pred_step",
    "make_cls_train_step",
    "make_seg_eval_step",
    "make_seg_train_step",
    "reference_flat_lr",
    "sgd_momentum",
    "shape_ious",
    "soft_cross_entropy",
    "step_decay",
]
