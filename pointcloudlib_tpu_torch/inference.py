"""Serving API (counterpart of ``pointcloudlib_tpu/inference.py``).

``Predictor`` wraps a classification model in eval mode on one device:

* shape bucketing — a cloud's N is padded up to the next bucket by
  repeating real points (cyclic resample), so the kernels see a handful
  of shapes;
* fixed serving batches — the last batch is filled by repeating its last
  row, and only real rows are returned;
* softmax on the device, only the probabilities copied back.

The device defaults to the card and raises when there is none; pass
``device="cpu"`` for the plain PyTorch versions on the CPU. Orbax
checkpoint restore and the part-segmentation predictor come with later
slices (ROADMAP.md); weights arrive through :meth:`Predictor.from_variables`.

Example::

    p = Predictor.from_variables("pointnet2", jax_variables)
    probs = p.predict_proba(clouds, normals)      # [B, 40]

``"pointnet2"`` (SSG) and ``"pointnet2_msg"`` are the ported models.
"""

from __future__ import annotations

from typing import Mapping, Optional, Union

import numpy as np
import torch

from pointcloudlib_tpu_torch.models import get_cls_model
from pointcloudlib_tpu_torch.ops.dispatch import resolve_device
from pointcloudlib_tpu_torch.utils.interop import from_jax_variables

# power-of-two-ish point-count buckets: few shapes, bounded padding
_BUCKETS = (128, 256, 512, 1024, 2048, 4096)
# largest bucket this slice serves: from 4096 up the JAX Predictor
# Hilbert-canonicalizes and takes the windowed fused kernel (_k_evalw)
_MAX_BUCKET = 2048


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return n


def _pad_points(arrays, n):
    """Pad each ``[B, n, ...]`` array up to the shape bucket by repeating
    real points (cyclic resample). Duplicates add no new max-pool values
    and never create phantom origin points. ``None`` entries pass."""
    nb = _bucket(n)
    if nb == n:
        return arrays
    sel = np.arange(nb - n) % n
    return [a if a is None
            else np.concatenate([a, a[:, sel]], axis=1)
            for a in arrays]


def _batches(arrays, batch_size):
    """Yield ``(chunks, real)`` with every array padded to a full batch by
    repeating the last row; ``real`` rows are genuine."""
    b = len(arrays[0])
    for s in range(0, b, batch_size):
        chunks = [None if a is None else a[s:s + batch_size]
                  for a in arrays]
        real = len(chunks[0])
        if real < batch_size:
            reps = batch_size - real
            chunks = [None if c is None
                      else np.concatenate([c, np.repeat(c[-1:], reps, 0)])
                      for c in chunks]
        yield chunks, real


class Predictor:
    def __init__(
        self,
        model: torch.nn.Module,
        with_normals: bool = False,
        batch_size: int = 32,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.with_normals = with_normals
        self.batch_size = batch_size

    @classmethod
    def from_variables(
        cls,
        model_name: str,
        variables: Mapping,
        n_classes: int = 40,
        with_normals: Optional[bool] = None,
        batch_size: int = 32,
        device: Optional[Union[str, torch.device]] = None,
    ) -> "Predictor":
        """Build ``model_name`` and load the JAX package's fused-layout
        ``variables`` (numpy leaves) through the weight bridge."""
        if with_normals is None:
            with_normals = model_name.startswith("pointnet2")
        model = get_cls_model(model_name, n_classes=n_classes,
                              feat_channels=3 if with_normals else 0)
        from_jax_variables(model, variables)
        return cls(model, with_normals=with_normals, batch_size=batch_size,
                   device=device)

    @torch.no_grad()
    def _forward(self, xyz: np.ndarray, feats: Optional[np.ndarray]
                 ) -> torch.Tensor:
        x = torch.from_numpy(xyz).to(self.device)
        f = None if feats is None else torch.from_numpy(feats).to(self.device)
        return torch.softmax(self.model(x, f), dim=-1)

    def predict_proba(
        self,
        clouds: np.ndarray,
        normals: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """``clouds [B, N, 3]`` → class probabilities ``[B, C]``."""
        clouds = np.asarray(clouds, np.float32)
        if self.with_normals and normals is None:
            raise ValueError(
                "this model consumes surface normals as features "
                "(with_normals=True); pass normals=[B, N, 3], or "
                "construct the Predictor with with_normals=False for a "
                "checkpoint trained without them")
        b, n, _ = clouds.shape
        if _bucket(n) > _MAX_BUCKET:
            raise NotImplementedError(
                f"N={n} pads to bucket {_bucket(n)}: buckets of 4096 and "
                "up take Hilbert canonicalization and the windowed fused "
                "kernel, not ported yet (ROADMAP.md)")
        if normals is not None:
            normals = np.asarray(normals, np.float32)
        clouds, normals = _pad_points([clouds, normals], n)
        outs = []
        for (chunk, nchunk), real in _batches([clouds, normals],
                                              self.batch_size):
            feats = nchunk if self.with_normals else None
            probs = self._forward(chunk, feats)
            outs.append(probs[:real].cpu().numpy())
        return np.concatenate(outs)

    def predict(self, clouds, normals=None) -> np.ndarray:
        return self.predict_proba(clouds, normals).argmax(-1)
