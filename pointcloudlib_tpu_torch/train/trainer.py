"""Step factories (counterpart of ``pointcloudlib_tpu/train/trainer.py``).

A step runs on the model's device: the card unless the caller asks for
``"cpu"``, and it raises when there is no card. Metrics stay on the
device as tensors; the caller fetches them when it wants them.

Every step first Hilbert-sorts the batch's points where the JAX step
does (``ops/spatial.canonicalize_batch``: N % 128 == 0 and N ≥ 4096,
whatever the model). Per-point features and part
labels ride along, and the part-segmentation eval step returns its ids in
the caller's point order.

A model may leave ``aux`` after its forward (KPConv does): the
classification step adds ``aux["reg_loss"]`` to the loss and returns
``aux["voxel_overflow"]`` among its metrics, both as tensors.

Data parallelism (the JAX factories' ``mesh`` / ``axis_name``): given a
``group`` (``parallel.DPGroup``), a step runs on the group's device,
takes the GLOBAL batch and keeps this rank's rows
(``parallel.shard_batch``), and the factory sets the group on the
model's BatchNorms and fused kernel modules (``parallel.sync_batchnorm``:
sync-BN). After ``backward`` the gradients are summed over the ranks in
one explicit flat all-reduce, not by DDP: DDP always averages, which the
segmentation step must not. Classification takes each rank's local-mean
loss, then averages gradients, loss and accuracy and sums
``voxel_overflow``; segmentation divides by the global valid count, then
sums gradients, loss and accuracy. A clip acts on the reduced gradient.
The eval steps sum their counts, and the prediction steps gather every
rank's rows, so that every rank returns the global batch's result.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from pointcloudlib_tpu_torch.ops import resolve_device
from pointcloudlib_tpu_torch.parallel.mesh import (
    DPGroup,
    all_gather_rows,
    all_reduce_metrics,
    all_reduce_sums,
    reduce_gradients,
    shard_batch,
    summed,
    sync_batchnorm,
)
from pointcloudlib_tpu_torch.ops.spatial import canonicalize_batch, unsort_rows
from pointcloudlib_tpu_torch.train.losses import (
    accuracy,
    cross_entropy_seg,
    soft_cross_entropy,
)
from pointcloudlib_tpu_torch.train.state import clip_grad_global_norm

Device = Optional[Union[str, torch.device]]


def _setup(model: torch.nn.Module, device: Device,
           group: Optional[DPGroup]) -> torch.device:
    """The step's device (the group's, if any), the model moved there
    and its batch statistics synced over the group."""
    if group is None:
        dev = resolve_device(device)
    else:
        dev = group.device
        if device is not None and torch.device(device) != dev:
            raise ValueError(f"device {device} is not the group's "
                             f"{group.device}")
        sync_batchnorm(model, group)
    model.to(dev)
    return dev


def _local(batch: Mapping, group: Optional[DPGroup]) -> Mapping:
    """This rank's rows of the global batch, or the batch itself."""
    return batch if group is None else shard_batch(group, batch)


def _put(x, dev: torch.device, dtype: torch.dtype):
    """An array or tensor as a tensor on ``dev``; ``None`` passes."""
    if x is None:
        return None
    t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    return t.to(device=dev, dtype=dtype)


def _inputs(batch: Mapping, dev: torch.device):
    """``(xyz, feats or None, label)`` as tensors on ``dev``, the points
    canonicalized."""
    xyz, feats, _ = canonicalize_batch(
        _put(batch["xyz"], dev, torch.float32),
        _put(batch.get("feats"), dev, torch.float32))
    return xyz, feats, _put(batch.get("label"), dev, torch.int64)


def _seg_inputs(batch: Mapping, dev: torch.device):
    """``(xyz, cls_onehot, feats or None, seg or None, order or None)`` as
    tensors on ``dev``, the points canonicalized with their features and
    part labels."""
    xyz, feats, seg, order = canonicalize_batch(
        _put(batch["xyz"], dev, torch.float32),
        _put(batch.get("feats"), dev, torch.float32),
        _put(batch.get("seg"), dev, torch.int64))
    return (xyz, _put(batch["cls_onehot"], dev, torch.float32), feats, seg,
            order)


def make_cls_train_step(model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer,
                        smoothing: bool = True, device: Device = None,
                        clip_norm: Optional[float] = None,
                        group: Optional[DPGroup] = None
                        ) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(batch, generator=None) -> {"loss", "acc"}`` for
    classification (``trainer.py:54``). ``batch = {"xyz" [B,N,3],
    "feats" (optional), "label" [B]}`` as arrays or tensors. The model
    moves to ``device`` (the card by default) in place, so an optimizer
    built on its parameters before stays valid. ``generator`` draws the
    dropout mask; it must live on the same device. A model's
    ``aux["reg_loss"]`` joins the loss, its ``aux["voxel_overflow"]``
    the metrics. ``clip_norm`` clips the gradients by their global norm
    before the update (``optax.clip_by_global_norm``). With a ``group``
    the step takes the global batch (module docstring); ``generator``
    is then this rank's own."""
    dev = _setup(model, device, group)

    def step(batch: Mapping, generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        xyz, feats, label = _inputs(_local(batch, group), dev)
        model.train()
        logits = model(xyz, feats, generator=generator)
        loss = soft_cross_entropy(logits, label, smoothing=smoothing)
        aux = getattr(model, "aux", {})
        if aux.get("reg_loss") is not None:
            loss = loss + aux["reg_loss"]
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if group is not None:
            reduce_gradients(model.parameters(), group, average=True)
        if clip_norm is not None:
            clip_grad_global_norm(model.parameters(), clip_norm)
        optimizer.step()
        metrics = {"loss": loss.detach(),
                   "acc": accuracy(logits.detach(), label)}
        if aux.get("voxel_overflow") is not None:
            metrics["voxel_overflow"] = aux["voxel_overflow"].detach()
        if group is not None:
            metrics = all_reduce_metrics(metrics, group,
                                         mean=("loss", "acc"))
        return metrics

    return step


def make_cls_eval_step(model: torch.nn.Module, device: Device = None,
                       group: Optional[DPGroup] = None
                       ) -> Callable[[Mapping], Tuple[torch.Tensor,
                                                      torch.Tensor]]:
    """``eval_step(batch) -> (correct, total)`` counts on the device;
    an optional boolean ``batch["valid"]`` masks padded clouds out. With
    a ``group``, of the global batch: each rank counts its rows and the
    counts are summed."""
    dev = _setup(model, device, group)

    @torch.no_grad()
    def step(batch: Mapping) -> Tuple[torch.Tensor, torch.Tensor]:
        batch = _local(batch, group)
        xyz, feats, label = _inputs(batch, dev)
        model.eval()
        pred = model(xyz, feats).argmax(-1)
        valid = batch.get("valid")
        valid = (torch.ones_like(pred, dtype=torch.bool) if valid is None
                 else torch.as_tensor(valid, device=dev).bool())
        correct = ((pred == label) & valid).sum()
        total = valid.sum()
        if group is not None:
            correct, total = all_reduce_sums([correct, total], group)
        return correct, total

    return step


def make_cls_pred_step(model: torch.nn.Module, probs: bool = False,
                       device: Device = None,
                       group: Optional[DPGroup] = None
                       ) -> Callable[[Mapping], torch.Tensor]:
    """``pred_step(batch) -> [B]`` argmax class ids on the device, or with
    ``probs`` the softmax probabilities ``[B, n_classes]``
    (``trainer.py:177``): the confusion-matrix eval and the voting test.
    The points are canonicalized as in the eval step. With a ``group``,
    of the global batch: every rank's rows, gathered in rank order."""
    dev = _setup(model, device, group)

    @torch.no_grad()
    def step(batch: Mapping) -> torch.Tensor:
        xyz, feats, _ = _inputs(_local(batch, group), dev)
        model.eval()
        logits = model(xyz, feats)
        out = torch.softmax(logits, -1) if probs else logits.argmax(-1)
        return out if group is None else all_gather_rows(out, group)

    return step


def make_seg_train_step(model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer,
                        device: Device = None,
                        group: Optional[DPGroup] = None
                        ) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(batch, generator=None) -> {"loss", "acc"}`` for part
    segmentation (``trainer.py:215``). ``batch = {"xyz" [B,N,3],
    "cls_onehot" [B,16], "feats" (optional), "seg" [B,N], "valid"
    (optional) [B]}`` as arrays or tensors. Plain per-point CE; loss and
    accuracy are means over the points of the valid clouds. The model
    moves to ``device`` (the card by default) in place; ``generator``
    draws the dropout mask and must live on the same device. With a
    ``group`` the step takes the global batch, and the means are over
    the points of every rank's valid clouds (``trainer.py:262-289``):
    with uneven ``valid`` masks a mean of the ranks' means would weigh
    the points otherwise."""
    dev = _setup(model, device, group)

    def step(batch: Mapping, generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        batch = _local(batch, group)
        xyz, onehot, feats, seg, _ = _seg_inputs(batch, dev)
        model.train()
        logits = model(xyz, onehot, feats, generator=generator)
        valid = batch.get("valid")
        w = (torch.ones(logits.shape[0], device=dev) if valid is None
             else _put(valid, dev, torch.float32))[:, None]
        per = cross_entropy_seg(logits, seg, reduce=False)
        denom = w.sum() * per.shape[1]
        if group is not None:  # the global point count, no gradient
            denom = summed(denom, group)
        denom = torch.clamp_min(denom, 1.0)
        loss = (per * w).sum() / denom
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if group is not None:  # already over the global count: a sum
            reduce_gradients(model.parameters(), group, average=False)
        optimizer.step()
        correct = (logits.detach().argmax(-1) == seg).float()
        metrics = {"loss": loss.detach(), "acc": (correct * w).sum() / denom}
        if group is not None:
            metrics = all_reduce_metrics(metrics, group, mean=())
        return metrics

    return step


def make_seg_eval_step(model: torch.nn.Module, device: Device = None,
                       group: Optional[DPGroup] = None
                       ) -> Callable[[Mapping], torch.Tensor]:
    """``eval_step(batch) -> pred [B, N]`` part ids on the device, for
    ``batch = {"xyz", "cls_onehot", "feats" (optional)}``, in the
    caller's point order; the caller computes IoUs over the epoch
    (``train/metrics.shape_ious``). With a ``group``, of the global
    batch: every rank's rows, gathered in rank order."""
    dev = _setup(model, device, group)

    @torch.no_grad()
    def step(batch: Mapping) -> torch.Tensor:
        xyz, onehot, feats, _, order = _seg_inputs(_local(batch, group),
                                                   dev)
        model.eval()
        pred = model(xyz, onehot, feats).argmax(-1)
        pred = pred if order is None else unsort_rows(pred, order)
        return pred if group is None else all_gather_rows(pred, group)

    return step
