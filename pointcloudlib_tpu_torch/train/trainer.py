"""Step factories (counterpart of ``pointcloudlib_tpu/train/trainer.py``).

A step runs on the model's device: the card unless the caller asks for
``"cpu"``, and it raises when there is no card. Metrics stay on the
device as tensors; the caller fetches them when it wants them.

The JAX step Hilbert-sorts each batch first (``_canon_batch``) only where
a windowed kernel would run, at N ≥ 4096; the ported sizes never reach
it, so the port does not sort.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from pointcloudlib_tpu_torch.ops import resolve_device
from pointcloudlib_tpu_torch.train.losses import accuracy, soft_cross_entropy

Device = Optional[Union[str, torch.device]]


def _inputs(batch: Mapping, dev: torch.device):
    """``(xyz, feats or None, label)`` as tensors on ``dev``."""

    def put(x, dtype):
        if x is None:
            return None
        t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        return t.to(device=dev, dtype=dtype)

    return (put(batch["xyz"], torch.float32),
            put(batch.get("feats"), torch.float32),
            put(batch.get("label"), torch.int64))


def make_cls_train_step(model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer,
                        smoothing: bool = True, device: Device = None
                        ) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(batch, generator=None) -> {"loss", "acc"}`` for
    classification. ``batch = {"xyz" [B,N,3], "feats" (optional),
    "label" [B]}`` as arrays or tensors. The model moves to ``device``
    (the card by default) in place, so an optimizer built on its
    parameters before stays valid. ``generator`` draws the dropout
    mask; it must live on the same device."""
    dev = resolve_device(device)
    model.to(dev)

    def step(batch: Mapping, generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        xyz, feats, label = _inputs(batch, dev)
        model.train()
        logits = model(xyz, feats, generator=generator)
        loss = soft_cross_entropy(logits, label, smoothing=smoothing)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach(), "acc": accuracy(logits.detach(),
                                                       label)}

    return step


def make_cls_eval_step(model: torch.nn.Module, device: Device = None
                       ) -> Callable[[Mapping], Tuple[torch.Tensor,
                                                      torch.Tensor]]:
    """``eval_step(batch) -> (correct, total)`` counts on the device;
    an optional boolean ``batch["valid"]`` masks padded clouds out."""
    dev = resolve_device(device)
    model.to(dev)

    @torch.no_grad()
    def step(batch: Mapping) -> Tuple[torch.Tensor, torch.Tensor]:
        xyz, feats, label = _inputs(batch, dev)
        model.eval()
        pred = model(xyz, feats).argmax(-1)
        valid = batch.get("valid")
        valid = (torch.ones_like(pred, dtype=torch.bool) if valid is None
                 else torch.as_tensor(valid, device=dev).bool())
        correct = ((pred == label) & valid).sum()
        return correct, valid.sum()

    return step
