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
from pointcloudlib_tpu_torch.train.state import sgd_momentum
from pointcloudlib_tpu_torch.train.trainer import (
    make_cls_eval_step,
    make_cls_train_step,
)

__all__ = [
    "accuracy",
    "cosine_with_warmup",
    "cross_entropy_seg",
    "make_cls_eval_step",
    "make_cls_train_step",
    "reference_flat_lr",
    "sgd_momentum",
    "soft_cross_entropy",
    "step_decay",
]
