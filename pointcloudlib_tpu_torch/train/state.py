"""The optimizer (counterpart of ``pointcloudlib_tpu/train/state.py``).

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
