"""Checkpoints with the reference's best / current / periodic policy
(counterpart of ``pointcloudlib_tpu/utils/checkpoint.py``), in a torch
format.

Each save writes ``current.pt``; a new best also ``best.pt``, and every
``periodic_gap``-th epoch ``step_NNNN.pt``. One file holds a dict that
``torch.load(weights_only=True)`` reads:

* ``model``: the model's ``state_dict`` (parameters and BN buffers);
* ``optimizer``: the optimizer's ``state_dict`` (SGD momentum, Adam
  moments);
* ``step``: train steps taken; ``save_step``: the epoch, for
  ``--resume``; ``metric``: the epoch's test metric, or ``None``.

A file is written to a temporary name in the same directory and moved
into place with ``os.replace``, so a reader never sees half a file. The
names differ from the JAX manager's (``current``, ``best``, ``step_NNNN``
and ``best_metric.json``), so both packages can keep checkpoints in one
directory. The directory is made on the first save.

The port does not read the JAX package's orbax directories (that would
need ``orbax`` and ``jax``): a JAX checkpoint reaches the port as the
numpy leaves of its variables, through
``utils/interop.from_jax_variables``.
"""

from __future__ import annotations

import os
import uuid
from pathlib import Path
from typing import Optional, Tuple

import torch

SUFFIX = ".pt"


def _device_of(model: torch.nn.Module) -> torch.device:
    for t in model.parameters():
        return t.device
    for t in model.buffers():
        return t.device
    return torch.device("cpu")


class CheckpointManager:
    def __init__(self, directory, periodic_gap: int = 50):
        self.directory = Path(directory).absolute()
        self.periodic_gap = periodic_gap

    def _path(self, name: str) -> Path:
        return self.directory / f"{name}{SUFFIX}"

    def _write(self, name: str, tree: dict) -> None:
        tmp = self.directory / (f".{name}.{os.getpid()}."
                                f"{uuid.uuid4().hex}.tmp")
        try:
            with open(tmp, "xb") as fh:
                torch.save(tree, fh)
            os.replace(tmp, self._path(name))
        except BaseException:
            tmp.unlink(missing_ok=True)
            raise

    def save(self, model: torch.nn.Module,
             optimizer: Optional[torch.optim.Optimizer], step: int,
             best: bool = False, metric: Optional[float] = None,
             train_steps: int = 0) -> None:
        """Save after epoch ``step``: ``current``, and ``best`` when
        ``best``, and ``step_NNNN`` when ``step`` is a positive multiple of
        ``periodic_gap``. ``metric`` is kept with the files (the bar a
        resumed run must beat); ``train_steps`` is the step count."""
        self.directory.mkdir(parents=True, exist_ok=True)
        tree = {
            "model": model.state_dict(),
            "optimizer": None if optimizer is None
            else optimizer.state_dict(),
            "step": int(train_steps),
            "save_step": int(step),
            "metric": None if metric is None else float(metric),
        }
        self._write("current", tree)
        if best:
            self._write("best", tree)
        if self.periodic_gap and step and step % self.periodic_gap == 0:
            self._write(f"step_{step:04d}", tree)

    def _load(self, name: str, device: torch.device) -> Optional[dict]:
        path = self._path(name)
        if not path.exists():
            return None
        return torch.load(path, map_location=device, weights_only=True)

    def best_metric(self) -> Optional[float]:
        """The metric saved with ``best``, if any."""
        tree = self._load("best", torch.device("cpu"))
        if tree is None or tree["metric"] is None:
            return None
        return float(tree["metric"])

    def restore(self, model: torch.nn.Module,
                optimizer: Optional[torch.optim.Optimizer] = None,
                name: str = "current") -> Optional[int]:
        """Load checkpoint ``name`` into ``model`` (and ``optimizer``) in
        place, onto the model's device → its step count, or ``None`` if
        there is no such checkpoint."""
        out = self.restore_with_step(model, optimizer, name)
        return None if out is None else out[0]

    def restore_with_step(self, model: torch.nn.Module,
                          optimizer: Optional[torch.optim.Optimizer] = None,
                          name: str = "current"
                          ) -> Optional[Tuple[int, int]]:
        """As :meth:`restore` → ``(step, save_step)``: ``save_step`` is the
        epoch passed to :meth:`save`, for resuming mid-training."""
        tree = self._load(name, _device_of(model))
        if tree is None:
            return None
        model.load_state_dict(tree["model"])
        if optimizer is not None:
            if tree["optimizer"] is None:
                raise ValueError(f"{self._path(name)} holds no optimizer "
                                 "state")
            optimizer.load_state_dict(tree["optimizer"])
        return int(tree["step"]), int(tree["save_step"])

    def restore_variables(self, model: torch.nn.Module, name: str = "best"
                          ) -> Optional[torch.nn.Module]:
        """The model's weights alone, for serving (the optimizer that
        trained them need not be known) → ``model``, or ``None`` if there
        is no such checkpoint."""
        tree = self._load(name, _device_of(model))
        if tree is None:
            return None
        model.load_state_dict(tree["model"])
        return model
