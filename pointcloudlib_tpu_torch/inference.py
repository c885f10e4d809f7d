"""Serving API (counterpart of ``pointcloudlib_tpu/inference.py``).

``Predictor`` wraps a classification model and ``SegPredictor`` a
part-segmentation model, in eval mode on one device:

* shape bucketing — a cloud's N is padded up to the next bucket by
  repeating real points (cyclic resample), so the kernels see a handful
  of shapes;
* fixed serving batches — the last batch is filled by repeating its last
  row, and only real rows are returned;
* Hilbert canonicalization where the JAX predictors sort
  (``ops/spatial.canonicalize_batch``: buckets of N % 128 == 0 from 4096
  up); per-point outputs return in the caller's point order;
* softmax on the device, only the probabilities copied back.

The device defaults to the card and raises when there is none; pass
``device="cpu"`` for the plain PyTorch versions on the CPU. Weights come
from the port's checkpoints (``from_checkpoint``, ``utils/checkpoint.py``)
or from the JAX package's variables as numpy leaves
(``from_variables``).

Example::

    p = Predictor.from_checkpoint("checkpoints/pointnet2", "pointnet2")
    probs = p.predict_proba(clouds, normals)      # [B, 40]
    p = Predictor.from_variables("pointnet2", jax_variables)
    probs = p.predict_proba(clouds, normals)      # [B, 40]
    s = SegPredictor.from_variables("pointnet2", jax_seg_variables)
    parts = s.predict(clouds, categories)         # [B, N] part ids

Every model of the JAX registry is served: classification by
``"pointnet"``, ``"pointnet2"`` (SSG, normals as features),
``"pointnet2_msg"``, ``"dgcnn"``, ``"pointconv"`` (normals with
``with_normals=True``, as its bench row runs it), ``"pointcnn"``,
``"kpconv"`` and ``"kpconv_deform"``; part segmentation by
``"pointnet"``, ``"pointnet2"`` (xyz as features), ``"dgcnn"``,
``"pointconv"`` and ``"pointcnn"``. ``from_variables`` and
``from_checkpoint`` build KPConv at its uncalibrated shapes, as the JAX
``from_checkpoint`` does (caps N/4^l of the served bucket); a pyramid
calibrated on data (``models/kpconv/calibrate.py``) is served by
building the model with those shapes and passing it to ``Predictor``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping, Optional, Union

import numpy as np
import torch

from pointcloudlib_tpu_torch.models import get_cls_model, get_seg_model
from pointcloudlib_tpu_torch.models.pointnet2 import N_CATEGORIES
from pointcloudlib_tpu_torch.ops.dispatch import resolve_device
from pointcloudlib_tpu_torch.ops.spatial import canonicalize_batch, unsort_rows
from pointcloudlib_tpu_torch.utils.checkpoint import CheckpointManager
from pointcloudlib_tpu_torch.utils.interop import from_jax_variables

# power-of-two-ish point-count buckets: few shapes, bounded padding;
# above 4096 a cloud keeps its own N (``inference.py:35,58-62``)
_BUCKETS = (128, 256, 512, 1024, 2048, 4096)


def _restore_required(model: torch.nn.Module, ckpt_dir, which: str) -> None:
    """Load checkpoint ``which`` (else ``current``) of ``ckpt_dir`` into
    ``model``, or raise: serving initial weights is never right."""
    mgr = CheckpointManager(Path(ckpt_dir))
    if (mgr.restore_variables(model, name=which) is None
            and mgr.restore_variables(model, name="current") is None):
        raise FileNotFoundError(
            f"no '{which}' or 'current' checkpoint under {mgr.directory} "
            "— refusing to serve randomly-initialized weights")


def _cls_model(model_name: str, n_classes: int,
               with_normals: Optional[bool]):
    """``(model, with_normals)``: by default only PointNet++ reads the
    normals."""
    if with_normals is None:
        with_normals = model_name.startswith("pointnet2")
    return get_cls_model(model_name, n_classes=n_classes,
                         feat_channels=3 if with_normals else 0), with_normals


def _seg_model(model_name: str, part_num: int):
    """``(model, with_xyz_feats)``: PointNet++ takes xyz again as its point
    features."""
    with_xyz = model_name.startswith("pointnet2")
    return get_seg_model(model_name, part_num=part_num,
                         feat_channels=3 if with_xyz else 0), with_xyz


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
        model, with_normals = _cls_model(model_name, n_classes, with_normals)
        from_jax_variables(model, variables)
        return cls(model, with_normals=with_normals, batch_size=batch_size,
                   device=device)

    @classmethod
    def from_checkpoint(
        cls,
        ckpt_dir: Union[str, Path],
        model_name: str,
        n_classes: int = 40,
        with_normals: Optional[bool] = None,
        which: str = "best",
        sample_points: int = 1024,
        batch_size: int = 32,
        device: Optional[Union[str, torch.device]] = None,
    ) -> "Predictor":
        """Build ``model_name`` and load checkpoint ``which`` (falling back
        to ``current``) of ``ckpt_dir``, as ``train_cls`` writes it;
        ``FileNotFoundError`` if there is neither. ``sample_points`` is
        the JAX signature's init shape, which a torch model does not
        need."""
        del sample_points
        model, with_normals = _cls_model(model_name, n_classes, with_normals)
        _restore_required(model, ckpt_dir, which)
        return cls(model, with_normals=with_normals, batch_size=batch_size,
                   device=device)

    @torch.no_grad()
    def _forward(self, xyz: np.ndarray, feats: Optional[np.ndarray]
                 ) -> torch.Tensor:
        x = torch.from_numpy(xyz).to(self.device)
        f = None if feats is None else torch.from_numpy(feats).to(self.device)
        x, f, _ = canonicalize_batch(x, f)  # classes: nothing to un-sort
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


class SegPredictor:
    """Part-segmentation serving (``inference.py:183``): per-point part
    probabilities and ids, with the bucket and batch padding of
    :class:`Predictor`. The object category conditions the model through
    its one-hot, as in training; ``with_xyz_feats`` passes xyz again as
    the input features (PointNet++)."""

    def __init__(
        self,
        model: torch.nn.Module,
        with_xyz_feats: bool = False,
        batch_size: int = 16,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.with_xyz_feats = with_xyz_feats
        self.batch_size = batch_size

    @classmethod
    def from_variables(
        cls,
        model_name: str,
        variables: Mapping,
        part_num: int = 50,
        batch_size: int = 16,
        device: Optional[Union[str, torch.device]] = None,
    ) -> "SegPredictor":
        """Build ``model_name`` and load the JAX package's fused-layout
        ``variables`` (numpy leaves) through the weight bridge."""
        model, with_xyz = _seg_model(model_name, part_num)
        from_jax_variables(model, variables)
        return cls(model, with_xyz_feats=with_xyz, batch_size=batch_size,
                   device=device)

    @classmethod
    def from_checkpoint(
        cls,
        ckpt_dir: Union[str, Path],
        model_name: str,
        part_num: int = 50,
        which: str = "best",
        sample_points: int = 2048,
        batch_size: int = 16,
        device: Optional[Union[str, torch.device]] = None,
    ) -> "SegPredictor":
        """Build ``model_name`` and load checkpoint ``which`` (falling back
        to ``current``) of ``ckpt_dir``, as ``train_partseg`` writes it
        (``<checkpoint-dir>/<model>_partseg``); ``FileNotFoundError`` if
        there is neither. ``sample_points`` is unused, as in
        :meth:`Predictor.from_checkpoint`."""
        del sample_points
        model, with_xyz = _seg_model(model_name, part_num)
        _restore_required(model, ckpt_dir, which)
        return cls(model, with_xyz_feats=with_xyz, batch_size=batch_size,
                   device=device)

    @torch.no_grad()
    def _serve(self, clouds, labels, finish) -> np.ndarray:
        """``finish(probs [b, nb, part_num])`` on the device for each
        batch, its real rows and points copied back."""
        clouds = np.asarray(clouds, np.float32)
        n = clouds.shape[1]
        [clouds] = _pad_points([clouds], n)
        onehot = np.eye(N_CATEGORIES, dtype=np.float32)[np.asarray(labels)]
        outs = []
        for (chunk, oh), real in _batches([clouds, onehot], self.batch_size):
            x, order = canonicalize_batch(
                torch.from_numpy(chunk).to(self.device))
            logits = self.model(x, torch.from_numpy(oh).to(self.device),
                                x if self.with_xyz_feats else None)
            probs = torch.softmax(logits, dim=-1)
            if order is not None:
                probs = unsort_rows(probs, order)
            out = finish(probs)
            outs.append(out[:real, :n].cpu().numpy())
        return np.concatenate(outs)

    def predict_proba(self, clouds: np.ndarray, labels: np.ndarray
                      ) -> np.ndarray:
        """``clouds [B, N, 3]``, ``labels [B]`` category ids → per-point
        part probabilities ``[B, N, part_num]``."""
        return self._serve(clouds, labels, lambda p: p)

    def predict(self, clouds: np.ndarray, labels: np.ndarray) -> np.ndarray:
        """Per-point part ids ``[B, N]`` (the argmax taken on the device,
        only the ids copied back)."""
        return self._serve(clouds, labels, lambda p: p.argmax(-1))
