"""Losses and metrics (counterpart of ``pointcloudlib_tpu/train/losses.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def soft_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                       smoothing: bool = True,
                       eps: float = 0.2) -> torch.Tensor:
    """Label-smoothed CE of the reference (``train_cls.py:31-50``): the
    true class weighs ``1 − eps``, every other ``eps/(n_class − 1)``
    (not torch's ``label_smoothing`` convention, ``1 − eps + eps/n`` /
    ``eps/n``). Mean over the batch; plain CE without ``smoothing``."""
    logits = logits.float()
    labels = labels.reshape(-1).long()
    if not smoothing:
        return F.cross_entropy(logits, labels)
    n_class = logits.shape[-1]
    one_hot = F.one_hot(labels, n_class).to(logits.dtype)
    soft = one_hot * (1.0 - eps) + (1.0 - one_hot) * (eps / (n_class - 1))
    return -(soft * F.log_softmax(logits, dim=-1)).sum(-1).mean()


def cross_entropy_seg(logits: torch.Tensor, seg: torch.Tensor,
                      reduce: bool = True) -> torch.Tensor:
    """Per-point CE over ``[B, N, parts]`` logits; ``reduce=False`` gives
    the per-point losses ``[B, N]``."""
    per = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                          seg.reshape(-1).long(), reduction="none")
    return per.mean() if reduce else per.reshape(seg.shape)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Share of argmax predictions equal to the labels."""
    pred = logits.argmax(-1)
    return (pred == labels.reshape(pred.shape)).float().mean()
