"""Data parallelism over processes (counterpart of
``pointcloudlib_tpu/parallel/mesh.py``).

The JAX package splits the batch over a 1-D ``data`` mesh of devices in
one program and sums over the mesh axis with ``lax.psum``. In PyTorch
data parallelism is one process per device in a ``torch.distributed``
process group: NCCL on the card, gloo on the CPU. Each process runs the
same step on its rows of the global batch; the BatchNorm sums and the
gradients are summed over the group.

The JAX names and theirs here:

- ``Mesh`` with a ``data`` axis → :class:`DPGroup`, a small record of
  the process group, this process's rank, the world size and its
  device; ``make_mesh(n)`` → :func:`make_group`, ``get_mesh()`` →
  :func:`get_group`.
- ``shard_batch(mesh, batch)`` → :func:`shard_batch`: this rank's rows
  ``[r·B/W, (r+1)·B/W)`` of the global batch, on its device.
- ``replicate(mesh, tree)`` → :func:`replicate`: the parameters and
  buffers broadcast from rank 0, in place.
- ``shard_train_step``, ``shard_map_train_step`` and
  ``shard_map_eval_step`` → the ``group=`` argument of the step factories
  (``train/trainer.py``): the step takes the global batch, keeps its
  rows, and reduces gradients and metrics itself. jit-SPMD and shard_map
  have the same semantics in the JAX package, so both map to that one
  step.
- a model built with ``axis_name`` / ``world`` → :func:`sync_batchnorm`,
  which sets the group on every BatchNorm and fused kernel module of a
  built model.
- ``lax.psum`` → :func:`all_reduce_sum` (in place, no gradient) and
  :func:`all_reduce_sum_grad` (differentiable: its backward is the same
  sum of the incoming gradients, as ``psum``'s transpose).
- ``jax.random.fold_in(rng, axis_index)`` → :func:`rank_seed`.
- the devices of one host, which one JAX program drives →
  :func:`start_ranks` / :func:`run_ranks`: one spawned process per
  rank, joined through a file store.

A world of one process needs no group: every function here is then the
identity, and the modules compute exactly what they compute without
one.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import shutil
import tempfile
from typing import Callable, Iterable, List, Mapping, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

Device = Optional[Union[str, torch.device]]


@dataclasses.dataclass(frozen=True)
class DPGroup:
    """One data-parallel group as one process sees it: ``group`` (``None``
    for the default group over every process), this process's ``rank``
    in it, the ``world`` size and the ``device`` this rank computes on."""

    group: Optional[dist.ProcessGroup]
    rank: int
    world: int
    device: torch.device


def world_of(group: Optional[DPGroup]) -> int:
    return 1 if group is None else group.world


def synced(group: Optional[DPGroup]) -> bool:
    """Whether batch statistics are summed over other ranks: a group of
    more than one process. A world of 1 keeps the local arithmetic."""
    return world_of(group) > 1


def _local_rank(rank: int) -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % max(1, torch.cuda.device_count())


def _default_device(rank: int) -> torch.device:
    if torch.cuda.is_available():
        return torch.device("cuda", _local_rank(rank))
    return torch.device("cpu")


def init_group(rank: int, world: int, init_method: str,
               device: Device = None, backend: Optional[str] = None
               ) -> DPGroup:
    """Start the default process group (``init_method`` such as
    ``tcp://localhost:<port>`` or ``file://<path>``) and return the group
    over every process. ``device`` defaults to ``cuda:<local rank>`` where
    there is a card, else the CPU; ``backend`` to NCCL on the card and
    gloo on the CPU."""
    dev = torch.device(device) if device is not None else _default_device(
        rank)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _local_rank(rank))
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    return make_group(device=dev)


def make_group(n_devices: Optional[int] = None, device: Device = None
               ) -> DPGroup:
    """The group over every process of the started default group (a world
    of 1 without one). ``n_devices`` must then be the number of
    processes: one process drives one device."""
    if not dist.is_initialized():
        world, rank = 1, 0
    else:
        world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_group: {n_devices} devices asked for, but "
                         f"{world} processes run (one a device)")
    dev = torch.device(device) if device is not None else _default_device(
        rank)
    return DPGroup(None, rank, world, dev)


@functools.lru_cache(maxsize=1)
def get_group() -> DPGroup:
    """The process-wide group over every process (:func:`make_group`)."""
    return make_group()


def _rows(group: DPGroup, x):
    if x is None:
        return None
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    if t.dim() == 0:
        return t.to(group.device)
    b = t.shape[0]
    if b % group.world:
        raise ValueError(f"shard_batch: batch of {b} not divisible by the "
                         f"{group.world} ranks")
    per = b // group.world
    return t[group.rank * per:(group.rank + 1) * per].to(
        group.device, non_blocking=True)


def shard_batch(group: DPGroup, batch: Mapping) -> dict:
    """This rank's rows ``[r·B/W, (r+1)·B/W)`` of every array or tensor of
    the global ``batch`` (leading axis B), as tensors on the rank's
    device; 0-d leaves are copied whole. B % W ≠ 0 raises."""
    return {k: _rows(group, v) for k, v in batch.items()}


@torch.no_grad()
def replicate(group: DPGroup, model: torch.nn.Module) -> torch.nn.Module:
    """Every parameter and buffer of ``model`` broadcast from rank 0, in
    place; returns the model."""
    if dist.is_initialized():
        for t in [*model.parameters(), *model.buffers()]:
            dist.broadcast(t.data, src=0, group=group.group)
    return model


def all_reduce_sum(t: torch.Tensor, group: Optional[DPGroup]
                   ) -> torch.Tensor:
    """``t`` summed over the ranks, in place and without a gradient; the
    identity for a world of 1."""
    if synced(group):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group.group)
    return t


def all_reduce_sums(tensors, group: Optional[DPGroup]):
    """Each tensor of ``tensors`` summed over the ranks in one flat
    all-reduce in their promoted dtype; new tensors, the inputs
    unchanged. The identity for a world of 1."""
    tensors = list(tensors)
    if not synced(group):
        return tensors
    dtype = functools.reduce(torch.promote_types,
                             [t.dtype for t in tensors])
    flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
    all_reduce_sum(flat, group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


def summed(t: torch.Tensor, group: Optional[DPGroup]) -> torch.Tensor:
    """``t`` summed over the ranks into a new tensor (``lax.psum``); ``t``
    itself for a world of 1."""
    return all_reduce_sums([t], group)[0]


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks, whose gradient is the sum over the ranks of
    the incoming gradients (``psum``'s transpose)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group.group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group.group)
        return grad, None


def all_reduce_sum_grad(t: torch.Tensor, group: Optional[DPGroup]
                        ) -> torch.Tensor:
    """``t`` summed over the ranks, differentiable; the identity for a
    world of 1."""
    return _AllReduceSum.apply(t, group) if synced(group) else t


def all_gather_rows(t: torch.Tensor, group: Optional[DPGroup]
                    ) -> torch.Tensor:
    """Every rank's ``t [b, ...]`` stacked in rank order → ``[W·b, ...]``
    (``out_specs=P(axis)``): a zero buffer with this rank's rows in place,
    summed over the ranks (one all-reduce, on every backend). The
    identity for a world of 1."""
    if not synced(group):
        return t
    b = t.shape[0]
    wide = t.dtype if t.is_floating_point() else torch.int64
    out = torch.zeros((group.world * b, *t.shape[1:]), dtype=wide,
                      device=t.device)
    out[group.rank * b:(group.rank + 1) * b] = t.to(wide)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group.group)
    return out.to(t.dtype)


@torch.no_grad()
def reduce_gradients(params: Iterable[torch.nn.Parameter], group: DPGroup,
                     average: bool) -> None:
    """Each parameter's gradient summed over the ranks
    (:func:`all_reduce_sums`, one flat all-reduce per dtype), then divided
    by the world size where ``average`` (``pmean``), in place; nothing
    for a world of 1. Parameters without a gradient are left out: every
    rank runs the same graph, so the same ones."""
    if not synced(group):
        return
    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        for g, s in zip(grads, all_reduce_sums(grads, group)):
            g.copy_(s / group.world if average else s)


def all_reduce_metrics(metrics: dict, group: DPGroup, mean: Iterable[str]
                       ) -> dict:
    """The step's metrics summed over the ranks in one all-reduce; those
    named in ``mean`` then divided by the world size."""
    keys = list(metrics)
    summed = all_reduce_sums([metrics[k].reshape(1) for k in keys], group)
    mean = set(mean)
    return {k: (s[0] / group.world if k in mean else s[0])
            for k, s in zip(keys, summed)}


def rank_seed(seed: int, rank: int) -> int:
    """The dropout seed of ``rank`` (``fold_in(rng, axis_index)``): the
    seed itself on rank 0, so that a world of 1 draws as without a group,
    and a seed drawn from ``(seed, rank)`` on every other rank."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


def sync_batchnorm(model: torch.nn.Module, group: Optional[DPGroup]
                   ) -> torch.nn.Module:
    """Set ``group`` on every module of ``model`` that forms batch
    statistics: ``nn.layers.BatchNorm``, the KPConv ``MaskedBatchNorm``,
    ``FusedSetAbstraction`` and the fused EdgeConv modules (whose
    kernels' Σ/Σ² and backward sums are then summed over the ranks).
    ``None`` turns it off. Returns the model."""
    from pointcloudlib_tpu_torch.models.dgcnn import (
        Fused2EdgeConv,
        FusedEdgeConv,
    )
    from pointcloudlib_tpu_torch.models.kpconv.model import MaskedBatchNorm
    from pointcloudlib_tpu_torch.nn.layers import (
        BatchNorm,
        FusedSetAbstraction,
    )

    kinds = (BatchNorm, MaskedBatchNorm, FusedSetAbstraction, FusedEdgeConv,
             Fused2EdgeConv)
    for m in model.modules():
        if isinstance(m, kinds):
            m.group = group
    return model


def _rank_main(rank: int, fn: Callable, world: int, tmp: str, args: tuple,
               device: Device, backend: Optional[str],
               threads: Optional[int]) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    group = init_group(rank, world, f"file://{tmp}/store", device=device,
                       backend=backend)
    try:
        out = fn(group, *args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


class RankRun:
    """The ranks that :func:`start_ranks` started."""

    def __init__(self, context, tmp: str, world: int):
        self._context, self._tmp, self._world = context, tmp, world

    def results(self) -> List:
        """Wait for every rank and return what each one's ``fn`` returned,
        by rank. A rank that fails stops the others, and its error is
        raised here (``torch.multiprocessing.ProcessRaisedException``)."""
        try:
            while not self._context.join():
                pass
            return [torch.load(os.path.join(self._tmp, f"rank{r}.pt"),
                               weights_only=False)
                    for r in range(self._world)]
        finally:
            shutil.rmtree(self._tmp, ignore_errors=True)


def start_ranks(fn: Callable, world: int, args: tuple = (),
                device: Device = None, backend: Optional[str] = None,
                threads: Optional[int] = None) -> RankRun:
    """Start ``world`` processes (start method ``spawn``), rank r calling
    ``fn(group, *args)`` in a process group of them all joined through a
    file store in a temporary directory (:func:`init_group`: ``device``,
    by default ``cuda:r`` where there are cards, else the CPU, and
    ``backend``); ``threads`` sets each rank's intra-op threads. ``fn``
    and ``args`` must pickle, and ``fn`` must return what
    ``torch.save`` takes. Returns at once; :meth:`RankRun.results`
    waits."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="ranks-")
    context = mp.start_processes(
        _rank_main, (fn, world, tmp, args, device, backend, threads),
        nprocs=world, join=False, start_method="spawn")
    return RankRun(context, tmp, world)


def run_ranks(fn: Callable, world: int, args: tuple = (),
              device: Device = None, backend: Optional[str] = None,
              threads: Optional[int] = None) -> List:
    """:func:`start_ranks`, then wait: every rank's result, by rank."""
    return start_ranks(fn, world, args, device, backend, threads).results()
