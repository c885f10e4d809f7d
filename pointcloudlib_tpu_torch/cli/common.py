"""What both training CLIs share: the flags the port adds or refuses, the
device, the model's seeded initialization, the optimizer and the copy of
a batch to the device."""

from __future__ import annotations

import argparse
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from pointcloudlib_tpu_torch.ops.dispatch import resolve_device
from pointcloudlib_tpu_torch.train import reference_flat_lr, sgd_momentum

PARALLEL = "ROADMAP.md queue 1, item 7 (parallelism)"
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
        ((args.n_devices or 1) > 1, f"--n-devices {args.n_devices}",
         PARALLEL),
        (args.dp == "shard_map", "--dp shard_map", PARALLEL),
        (args.multihost, "--multihost", PARALLEL),
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
