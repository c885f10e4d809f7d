"""Hilbert canonicalization of point clouds (counterpart of
``pointcloudlib_tpu/ops/spatial.py``).

Each cloud is sorted along a Hilbert curve over its bounding box, so that
index locality implies spatial locality. The JAX package sorts where its
windowed set-abstraction kernels run (N % 128 == 0, N ≥ 4096): they
gather from a narrow index window of the source cloud. The port sorts
behind the same gate (:func:`canonicalize_batch`), in the step factories and
the predictors, so that both packages see the same point order: FPS seeds
from index 0, and the order decides which centers it picks.

The port has no windowed kernels. The JAX package's windowed functions
(``_k_f1w``, ``_k_evalw``, ``_k_p2w``) compute what ``_k_f1``, ``_k_eval``
and ``_k_p2`` compute, "exact for any input order"
(``fused_sa.py:527-531``); the window, the row permutation σ
(``_row_perm``/``_take_rows``) and the window plan only save TPU lanes and
change the order of summation. A CUDA kernel gathers by index anyway, so
the port runs its given-index kernels (``sa_f1``, ``fused_sa_eval``,
``sa_bwd_p2``) at every N and carries none of those over.

Keys are bit-identical to the JAX package's: the quantization takes the
JAX expression's f32 operations one at a time in its order (eager PyTorch
runs each as its own kernel, so nothing fuses into an FMA), the Skilling
transpose and the Gray code run in int32, and the sort is stable, as
``jnp.argsort`` is (duplicate points give equal keys). The JAX package's
``mask`` argument has no caller on its serving or training paths and is
not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def window_width(n: int) -> Optional[int]:
    """The JAX package's gather-window width for a source cloud of ``n``
    points (``_window_width``, ``fused_sa.py:205``), or ``None`` where it
    runs no windowed kernel: unless N % 128 == 0 and N ≥ 4096. Where it is
    not ``None``, the JAX package canonicalizes the batch; so does the
    port, and its set abstraction takes the given-index route."""
    if n % 128 or n < 4096:
        return None
    for w in (-(-max(n // 4, 128) // 128) * 128, n // 2):
        if w < n and n % w == 0:
            return w
    return None


def hilbert_keys(xyz: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """Hilbert-curve index of each point, ``[B, N] int32``
    (``hilbert_keys``, ``spatial.py:39``): ``xyz [B, N, 3]`` quantized per
    cloud to a ``2^bits`` grid over its bounding box, then Skilling's
    transpose ("Programming the Hilbert curve", 2004) and its bits
    interleaved most significant first."""
    assert bits * 3 <= 31, bits
    side = (1 << bits) - 1
    xyz = xyz.float()
    lo = xyz.amin(dim=1, keepdim=True)
    hi = xyz.amax(dim=1, keepdim=True)
    # a true division: ``float / tensor`` would take the reciprocal, then
    # multiply, and round differently
    scale = torch.full_like(lo, side) / torch.clamp_min(hi - lo, 1e-9)
    q = torch.clamp((xyz - lo) * scale, 0, side).to(torch.int32)
    x0, x1, x2 = q.unbind(-1)

    # Skilling's AxestoTranspose, vectorized: branches become where()
    m = 1 << (bits - 1)
    qbit = m
    while qbit > 1:
        p = qbit - 1
        for i in range(3):
            xi = (x0, x1, x2)[i]
            cond = (xi & qbit) != 0
            if i == 0:  # exchanging x0 with itself: only the invert
                x0 = torch.where(cond, x0 ^ p, x0)
                continue
            t = (x0 ^ xi) & p
            new_x0 = torch.where(cond, x0 ^ p, x0 ^ t)
            new_xi = torch.where(cond, xi, xi ^ t)
            x0 = new_x0
            if i == 1:
                x1 = new_xi
            else:
                x2 = new_xi
        qbit >>= 1

    # Gray encode
    x1 = x1 ^ x0
    x2 = x2 ^ x1
    t = torch.zeros_like(x0)
    qbit = m
    while qbit > 1:
        t = torch.where((x2 & qbit) != 0, t ^ (qbit - 1), t)
        qbit >>= 1
    x0, x1, x2 = x0 ^ t, x1 ^ t, x2 ^ t

    key = torch.zeros_like(x0)
    for b in range(bits - 1, -1, -1):
        key = ((key << 3) | (((x0 >> b) & 1) << 2) | (((x1 >> b) & 1) << 1)
               | ((x2 >> b) & 1))
    return key


def take_rows(a: Optional[torch.Tensor], order: torch.Tensor
              ) -> Optional[torch.Tensor]:
    """Rows of ``a [B, N, ...]`` (or ``[B, N]``) in the order ``order
    [B, N]``: ``out[b, i] = a[b, order[b, i]]``, any dtype; ``None``
    passes (``take_rows``, ``spatial.py:143``)."""
    if a is None:
        return None
    rows = torch.arange(a.shape[0], device=a.device)[:, None]
    return a[rows, order.long()]


def unsort_rows(a: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`take_rows`: per-point outputs computed in
    the sorted order back in the caller's order (``spatial.py:164``)."""
    return take_rows(a, torch.argsort(order, dim=1))


def canonicalize(xyz: torch.Tensor, *arrays: Optional[torch.Tensor],
                 bits: int = 10) -> Tuple[Optional[torch.Tensor], ...]:
    """Sort each cloud by Hilbert key → ``(xyz_sorted, *arrays_sorted,
    order)`` with ``sorted = x[order]`` and ``order [B, N] int32``
    (``canonicalize``, ``spatial.py:116``). ``arrays`` (per-point
    features, labels) ride along axis 1; ``None`` entries stay ``None``.
    Equal keys keep their index order."""
    keys = hilbert_keys(xyz, bits)
    order = torch.argsort(keys, dim=1, stable=True).to(torch.int32)
    return (take_rows(xyz, order), *[take_rows(a, order) for a in arrays],
            order)


def canonicalize_batch(xyz: torch.Tensor, *arrays: Optional[torch.Tensor]
                       ) -> Tuple[Optional[torch.Tensor], ...]:
    """:func:`canonicalize` where the JAX package sorts a batch
    (``_canon_batch``, ``train/trainer.py:26-49``; the predictors,
    ``inference.py:111-118,198-210``): where :func:`window_width` is not
    ``None``, whatever the model. Elsewhere the inputs unchanged and
    ``order`` ``None``."""
    if window_width(xyz.shape[1]) is None:
        return (xyz, *arrays, None)
    return canonicalize(xyz, *arrays)
