"""Learning-rate schedules of the reference recipes (counterpart of
``pointcloudlib_tpu/train/schedules.py``).

Each schedule is a plain function of the step that returns the learning
rate. ``torch.optim.lr_scheduler.LambdaLR`` multiplies the optimizer's
initial rate by it, so build the optimizer with ``lr=1.0``::

    opt = sgd_momentum(model.parameters(), 1.0)
    sched = LambdaLR(opt, step_decay(0.001, decay_step=15000 // 64))
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def step_decay(base_lr: float, decay: float = 0.6, decay_step: int = 15000,
               floor_factor: float = 2e-5) -> Schedule:
    """``lr = base · max(decay^⌊step/decay_step⌋, floor_factor)``, the
    reference LRScheduler's formula (``misc/utils.py:8-19``)."""

    def schedule(step: int) -> float:
        return base_lr * max(decay ** math.floor(step / decay_step),
                             floor_factor)

    return schedule


def reference_flat_lr(base_lr: float, n_train: int, batch_size: int,
                      drop_last: bool = False) -> float:
    """The constant lr the reference CLIs effectively train at: they step
    their scheduler with the same argument every epoch, so the decay
    exponent ``int(n_batches·batch_size/15000)`` never grows (0 for
    ModelNet40's 9840 training clouds)."""
    n_batches = (n_train // batch_size if drop_last
                 else -(-n_train // batch_size))
    decay = 0.6 ** int(n_batches * batch_size / 15000)
    return base_lr * max(decay, 2e-5)


def cosine_with_warmup(base_lr: float, warmup_steps: int, total_steps: int,
                       floor: float = 1e-5) -> Schedule:
    """Linear warmup from 0 to ``base_lr`` over ``warmup_steps``, then a
    cosine to ``floor`` at ``total_steps`` (optax's
    ``warmup_cosine_decay_schedule``)."""
    decay_steps = total_steps - warmup_steps
    alpha = floor / base_lr

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * step / warmup_steps
        t = min(step - warmup_steps, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
        return base_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule
