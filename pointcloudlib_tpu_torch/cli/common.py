"""What both training CLIs share: the flags the port adds or refuses, the
device, data parallelism (``--n-devices``, ``--dp``, ``--multihost``),
the model's seeded initialization, the optimizer and the copy of a batch
to the device."""

from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from pointcloudlib_tpu_torch.ops.dispatch import resolve_device
from pointcloudlib_tpu_torch.train import reference_flat_lr, sgd_momentum

ACTDIFF = "ROADMAP.md queue 1, item 8 (the activation audit)"
DEBUG = "ROADMAP.md queue 1, item 9 (the debug checks)"


def add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="where the model runs: cuda (the default; raises "
                        "without a card) or cpu (the plain PyTorch "
                        "versions)")


def refuse_unported(args: argparse.Namespace) -> None:
    """Exit naming the ROADMAP item of each flag that asks for what the
    port does not do yet; a flag at its default passes."""
    checks = (
        (getattr(args, "diff_checkpoint", None) is not None,
         "--diff-checkpoint", ACTDIFF),
        (getattr(args, "diff_trace", None) is not None, "--diff-trace",
         ACTDIFF),
        (getattr(args, "dump_trace", None) is not None, "--dump-trace",
         ACTDIFF),
        (getattr(args, "diff_atol", 1e-2) != 1e-2, "--diff-atol", ACTDIFF),
        (args.debug, "--debug", DEBUG),
    )
    for asked, flag, item in checks:
        if asked:
            raise SystemExit(f"{flag}: not ported to the PyTorch package "
                             f"yet ({item})")


def device_of(args: argparse.Namespace) -> torch.device:
    """``--device``; raises without a card unless it is ``cpu``."""
    return resolve_device(args.device)


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def seeded_model(build: Callable[[], torch.nn.Module], seed: int
                 ) -> torch.nn.Module:
    """``build()`` on the CPU under ``torch.manual_seed(seed)``, without
    touching the caller's generator: one seed, one initial model, on any
    device it then moves to."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def make_optimizer(args: argparse.Namespace, model: torch.nn.Module,
                   n_train: int, weight_decay: float = 0.0,
                   drop_last: bool = False) -> torch.optim.Optimizer:
    """``--optimizer sgd``: momentum SGD at the reference's flat lr
    (``reference_flat_lr``); ``adam``: ``optax.adam(lr)``'s update
    (betas 0.9 / 0.999, eps 1e-8)."""
    if args.optimizer == "sgd":
        lr = reference_flat_lr(args.lr, n_train, args.batch_size,
                               drop_last=drop_last)
        return sgd_momentum(model.parameters(), lr, momentum=args.momentum,
                            weight_decay=weight_decay)
    return torch.optim.Adam(model.parameters(), lr=args.lr,
                            betas=(0.9, 0.999), eps=1e-8)


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def staged(batches: Iterator[Dict[str, np.ndarray]], dev: torch.device,
           prep: Optional[Callable[[dict], dict]] = None
           ) -> Iterator[Dict[str, torch.Tensor]]:
    """Each numpy batch of ``batches`` (after ``prep``) as CPU tensors, in
    pinned memory when ``dev`` is the card, so that :func:`to_device`
    copies it without waiting for the card. Runs in the prefetch thread."""
    for batch in batches:
        if prep is not None:
            batch = prep(batch)
        out = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in batch.items()}
        if dev.type == "cuda":
            out = {k: v.pin_memory() for k, v in out.items()}
        yield out


def to_device(batch: Dict[str, torch.Tensor], dev: torch.device
              ) -> Dict[str, torch.Tensor]:
    return {k: v.to(dev, non_blocking=True) for k, v in batch.items()}


def quiet(*_args, **_kw) -> None:
    """``print`` of the ranks other than 0."""


def dp_devices(args: argparse.Namespace) -> int:
    """``--n-devices``, else every visible card (the JAX mesh's "all");
    with ``--device cpu``, one process."""
    if args.n_devices is not None:
        return args.n_devices
    if args.device == "cpu" or not torch.cuda.is_available():
        return 1
    return torch.cuda.device_count()


def dp_mode(args: argparse.Namespace, world: int) -> str:
    """``--dp``: ``auto`` is ``shard_map`` over more than one device, else
    ``spmd`` (the JAX CLI's rule). Every mode runs the same step (the
    step factories' ``group=``): the JAX package's jit-SPMD and
    shard_map steps have the same semantics, sync-BN included."""
    if args.dp == "auto":
        return "shard_map" if world > 1 else "spmd"
    return args.dp


def from_rank0(obj, group):
    """``obj`` as rank 0 has it, on every rank of ``group`` (``None``: the
    object itself)."""
    if group is None:
        return obj
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=0, group=group.group)
    return box[0]


def launch(run: Callable, args: argparse.Namespace) -> dict:
    """``run(args, group)`` on every device and return rank 0's summary.

    ``--multihost`` starts the process group from ``torchrun``'s
    environment (``parallel.initialize_multihost``): every process runs
    this on the card of its local rank. Else ``--n-devices`` W (by
    default every visible card): W = 1 runs in this process without a
    group; W > 1 starts W processes (start method ``spawn``), rank r on
    ``cuda:r`` over NCCL, or all on the CPU over gloo with ``--device
    cpu``, joined through a file store in a temporary directory. The
    batch size must divide by W. The summary of a spawned run holds
    ``ranks``, every rank's own."""
    if args.multihost:
        import torch.distributed as dist

        from pointcloudlib_tpu_torch.parallel import (
            global_group,
            initialize_multihost,
        )

        active = initialize_multihost("gloo" if args.device == "cpu"
                                      else None)
        n = dist.get_world_size() if dist.is_initialized() else 1
        print(f"multihost: {'active' if active else 'single-process'} "
              f"({n} processes)")
        if dist.is_initialized():
            dev = (torch.device("cpu") if args.device == "cpu" else
                   torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                           0))))
            _check_batch(args, n)
            return run(args, global_group(device=dev))
    world = dp_devices(args)
    _check_batch(args, world)
    if world == 1:
        return run(args, None)
    if args.device != "cpu" and world > torch.cuda.device_count():
        raise SystemExit(f"--n-devices {world}: only "
                         f"{torch.cuda.device_count()} cards are visible")
    return _spawn(run, args, world)


def _check_batch(args: argparse.Namespace, world: int) -> None:
    if args.batch_size % world:
        raise SystemExit(f"batch_size {args.batch_size} not divisible by "
                         f"{world} devices")


def _run_rank(group, run, args: argparse.Namespace) -> dict:
    return run(args, group)


def _spawn(run, args: argparse.Namespace, world: int) -> dict:
    from pointcloudlib_tpu_torch.parallel import run_ranks

    try:
        ranks = run_ranks(_run_rank, world, (run, args),
                          device="cpu" if args.device == "cpu" else None,
                          threads=torch.get_num_threads())
    except Exception as e:  # a rank's failure, which stopped the others
        raise SystemExit(f"data-parallel run failed: {e}") from e
    return {**ranks[0], "ranks": ranks}
