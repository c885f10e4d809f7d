"""The optimizer (counterpart of ``pointcloudlib_tpu/train/state.py``),
the global-norm clip and KPConv's recipe.

The JAX package carries params, BN statistics and optimizer state in one
``TrainState``; here the model holds the first two and
``torch.optim.SGD`` the third."""

from __future__ import annotations

from typing import Iterable

import torch


def sgd_momentum(params: Iterable[torch.nn.Parameter], lr: float,
                 momentum: float = 0.9,
                 weight_decay: float = 0.0) -> torch.optim.SGD:
    """SGD with heavy-ball momentum, the reference's optimizer
    (``train_cls.py:404``). It is the update of ``optax.sgd(lr,
    momentum)`` after ``optax.add_decayed_weights(weight_decay)``:
    ``g ← g + wd·p``, ``m ← momentum·m + g`` (m starts at 0), ``p ← p −
    lr·m``; no dampening, no Nesterov."""
    return torch.optim.SGD(params, lr=lr, momentum=momentum, dampening=0.0,
                           weight_decay=weight_decay, nesterov=False)


@torch.no_grad()
def clip_grad_global_norm(params: Iterable[torch.nn.Parameter],
                          max_norm: float) -> torch.Tensor:
    """Scale every gradient by ``max_norm / ‖g‖`` where the global norm
    ``‖g‖`` (over all of ``params``' gradients) reaches ``max_norm``, in
    place, as ``optax.clip_by_global_norm``; returns ``‖g‖``, a tensor,
    without a host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


KPCONV_CLIP_NORM = 100.0
KPCONV_LR, KPCONV_MOMENTUM = 1e-2, 0.98
KPCONV_DECAY = 0.1 ** (1 / 100)   # per epoch's worth of steps, staircase


def kpconv_optimizer(model: torch.nn.Module, steps_per_epoch: int,
                     deform_lr_factor: float = 0.0):
    """``(optimizer, set_lr)`` of the reference KPConv recipe (the JAX
    CLI's, ``train_cls.py:296-330``): SGD with momentum 0.98, the
    parameters whose name holds ``offset`` (a deformable KPConv's offset
    convolution and bias) in a group whose updates are scaled by
    ``deform_lr_factor``; ``set_lr(step)`` sets lr ``1e-2 · (0.1^(1/100))
    ^⌊step / steps_per_epoch⌋`` (optax's staircase ``exponential_decay``)
    before each step. The step clips the gradients to a global norm of
    :data:`KPCONV_CLIP_NORM` first (``make_cls_train_step(clip_norm=)``)."""
    named = list(model.named_parameters())
    groups = [{"params": [p for k, p in named if "offset" not in k],
               "factor": 1.0}]
    offsets = [p for k, p in named if "offset" in k]
    if offsets:
        groups.append({"params": offsets, "factor": deform_lr_factor})
    opt = sgd_momentum(groups, KPCONV_LR, momentum=KPCONV_MOMENTUM)

    def set_lr(step: int) -> None:
        lr = KPCONV_LR * KPCONV_DECAY ** (step // steps_per_epoch)
        for g in opt.param_groups:
            g["lr"] = lr * g["factor"]

    return opt, set_lr
