"""Batch assembly in forked worker processes (counterpart of
``pointcloudlib_tpu/data/workers.py``).

The per-item numpy work (permutation, normalization, augmentation) runs
in ``workers`` forked children while the main process feeds the card.
Fork, not spawn, so a dataset's cached arrays are shared copy-on-write
and never pickled.

* A worker touches numpy only: no torch tensor and no CUDA call. Forking
  after the parent has initialised CUDA is safe because the children
  never call into it; the parent copies their numpy batches to the
  device.
* Each worker reseeds the dataset's generator ``_rng`` with ``[seed,
  worker id]``, so the workers' augmentation draws are independent (a
  plain fork would clone the parent's generator into every child).
* At most two batches per worker are in flight.
"""

from __future__ import annotations

import itertools
import multiprocessing as mp
from collections import deque
from typing import Iterator, Sequence

import numpy as np

# worker-process globals, set once by the fork initializer
_WG: dict = {}


def _init_worker(dataset, kind, batch_size, with_normals, seed, counter):
    with counter.get_lock():
        wid = counter.value
        counter.value += 1
    if hasattr(dataset, "_rng"):
        dataset._rng = np.random.default_rng([seed, wid])
    _WG.update(dataset=dataset, kind=kind, batch_size=batch_size,
               with_normals=with_normals)


def _make_batch(chunk):
    from pointcloudlib_tpu_torch.data import loader

    if _WG["kind"] == "cls":
        return loader._cls_batch_from(
            _WG["dataset"], chunk, _WG["batch_size"], _WG["with_normals"]
        )
    return loader._seg_batch_from(_WG["dataset"], chunk, _WG["batch_size"])


def pool_batches(
    dataset,
    chunks: Sequence[np.ndarray],
    kind: str,
    batch_size: int,
    workers: int,
    with_normals: bool = True,
    seed: int = 0,
) -> Iterator[dict]:
    """Yield the batches of ``chunks`` (index arrays), in order, assembled
    by a pool of ``workers`` forked processes; ``kind`` is ``"cls"`` or
    ``"seg"``."""
    ctx = mp.get_context("fork")
    counter = ctx.Value("i", 0)
    with ctx.Pool(
        workers,
        initializer=_init_worker,
        initargs=(dataset, kind, batch_size, with_normals, seed, counter),
    ) as pool:
        window = 2 * workers
        it = iter(chunks)
        pending: deque = deque(
            pool.apply_async(_make_batch, (c,))
            for c in itertools.islice(it, window)
        )
        while pending:
            batch = pending.popleft().get()
            nxt = next(it, None)
            if nxt is not None:
                pending.append(pool.apply_async(_make_batch, (nxt,)))
            yield batch
