"""Fixed-shape batching (counterpart of ``pointcloudlib_tpu/data/loader.py``).

Every batch has the same shape: a last partial batch is padded by
repeating its last item and flagged in a boolean ``valid`` mask, which
eval divides by, so padding never skews a metric; training passes
``drop_last=True``. Batches are numpy arrays: the caller copies them to
its device. ``kpconv_cls_batches`` is KPConv's epoch: potential-sampled
items, each augmented on its own, optionally gathered by occupancy
bucket.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np


def prefetch(it: Iterator, size: int = 2) -> Iterator:
    """Run an iterator in a background thread with a bounded buffer, so
    batch assembly and numpy augmentation overlap the device's steps.

    An exception of the producer is raised in the consumer. When the
    consumer stops early (``break``, a step cap) or is closed, the thread
    gives up its pending put within 0.1 s and ends."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    _END = object()
    stop = threading.Event()

    def put(item) -> bool:
        # a bounded put that gives up once the consumer has gone, else
        # the thread would block in q.put forever with its batches
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not put(item):
                    return
            put(_END)
        except BaseException as e:  # raised again in the consumer
            put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def _pad_to(arrs: list, batch_size: int):
    n = len(arrs)
    if n == batch_size:
        return np.stack(arrs), np.ones(batch_size, bool)
    pad = [arrs[-1]] * (batch_size - n)
    valid = np.zeros(batch_size, bool)
    valid[:n] = True
    return np.stack(arrs + pad), valid


def _pad_rows(arr: np.ndarray, batch_size: int):
    n = arr.shape[0]
    if n == batch_size:
        return arr, np.ones(batch_size, bool)
    pad = np.repeat(arr[-1:], batch_size - n, axis=0)
    valid = np.zeros(batch_size, bool)
    valid[:n] = True
    return np.concatenate([arr, pad]), valid


def _cls_batch_from(dataset, chunk, batch_size: int, with_normals: bool):
    """One classification batch from item indices (the serial iterator's
    and the worker pool's). A dataset with a vectorised ``get_batch(idx)``
    (ModelNet40) skips the per-item loop."""
    if hasattr(dataset, "get_batch"):
        pts, nrm, lab = dataset.get_batch(np.asarray(chunk, np.int64))
        xyz, valid = _pad_rows(pts, batch_size)
        batch = {
            "xyz": xyz.astype(np.float32, copy=False),
            "label": _pad_rows(lab, batch_size)[0].astype(
                np.int32, copy=False),
            "valid": valid,
        }
        if with_normals:
            batch["feats"] = _pad_rows(nrm, batch_size)[0].astype(
                np.float32, copy=False)
        return batch
    pts, nrm, lab = [], [], []
    for i in chunk:
        p, n, l = dataset[int(i)]
        pts.append(p); nrm.append(n); lab.append(l)
    xyz, valid = _pad_to(pts, batch_size)
    labels, _ = _pad_to(lab, batch_size)
    batch = {
        "xyz": xyz.astype(np.float32),
        "label": labels.astype(np.int32),
        "valid": valid,
    }
    if with_normals:
        batch["feats"] = _pad_to(nrm, batch_size)[0].astype(np.float32)
    return batch


def _seg_batch_from(dataset, chunk, batch_size: int):
    """One part-segmentation batch from item indices."""
    pts, lab, seg = [], [], []
    for i in chunk:
        p, l, s = dataset[int(i)]
        pts.append(p); lab.append(l); seg.append(s)
    xyz, valid = _pad_to(pts, batch_size)
    return {
        "xyz": xyz.astype(np.float32),
        "label": _pad_to(lab, batch_size)[0].astype(np.int32),
        "seg": _pad_to(seg, batch_size)[0].astype(np.int32),
        "valid": valid,
    }


def _chunks(n_items: int, batch_size: int, shuffle: bool, seed: int,
            drop_last: bool):
    order = np.arange(n_items)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    out = []
    for start in range(0, n_items, batch_size):
        chunk = order[start : start + batch_size]
        if len(chunk) < batch_size and drop_last:
            break
        out.append(chunk)
    return out


def cls_batches(
    dataset,
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    drop_last: bool = False,
    with_normals: bool = True,
    workers: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield ``{"xyz", "feats"?, "label", "valid"}`` batches from a
    classification dataset of ``(pts, normals, label)`` items; with
    ``workers > 0`` a fork pool assembles them (``data/workers.py``)."""
    chunks = _chunks(len(dataset), batch_size, shuffle, seed, drop_last)
    if workers > 0:
        from pointcloudlib_tpu_torch.data.workers import pool_batches

        yield from pool_batches(dataset, chunks, "cls", batch_size,
                                workers, with_normals=with_normals,
                                seed=seed)
        return
    for chunk in chunks:
        yield _cls_batch_from(dataset, chunk, batch_size, with_normals)


def kpconv_cls_batches(
    dataset,
    batch_size: int,
    sampler,
    rng: np.random.Generator,
    epoch_n: int | None = None,
    augment: bool = True,
    rotation: str = "none",
    drop_last: bool = True,
    bucket_of=None,
) -> Iterator[Dict[str, np.ndarray]]:
    """KPConv's epoch (``loader.py:176``): ``epoch_n`` items (default
    all) picked by ``sampler`` (a :class:`~pointcloudlib_tpu_torch.data.
    sampler.PotentialSampler`), each cloud augmented by ``kpconv_augment``
    from ``rng`` unless ``augment`` is false, as ``{"xyz", "label",
    "valid"}`` batches; with ``drop_last`` a partial batch is dropped
    and its items' potential bumps refunded.

    ``bucket_of`` (``BucketedCalibration.bucket_of`` or alike, on the
    augmented cloud) batches by occupancy bucket: clouds gather per
    bucket, a batch goes out (with its ``"bucket"``) whenever one fills,
    and with ``drop_last`` the clouds left over at the end are refunded
    and named in a printed line.
    """
    from pointcloudlib_tpu_torch.data.sampler import kpconv_augment

    n = epoch_n if epoch_n is not None else len(dataset)
    order = sampler.sample(n)

    def emit(items, bucket=None):
        pts = [it[0] for it in items]
        lab = [it[1] for it in items]
        xyz, valid = _pad_to(pts, batch_size)
        labels, _ = _pad_to(lab, batch_size)
        out = {
            "xyz": xyz.astype(np.float32),
            "label": labels.astype(np.int32),
            "valid": valid,
        }
        if bucket is not None:
            out["bucket"] = bucket
        return out

    if bucket_of is None:
        for start in range(0, len(order), batch_size):
            chunk = order[start : start + batch_size]
            if len(chunk) < batch_size and drop_last:
                # sampled but not trained on: their bumps come back
                sampler.refund(chunk)
                return
            items = []
            for i in chunk:
                p, _nrm, l = dataset[int(i)]
                if augment:
                    p = kpconv_augment(p, rng, rotation=rotation)
                items.append((p.astype(np.float32), l))
            yield emit(items)
        return

    pend: Dict[int, list] = {}
    for i in order:
        p, _nrm, l = dataset[int(i)]
        if augment:
            p = kpconv_augment(p, rng, rotation=rotation)
        p = p.astype(np.float32)
        b = bucket_of(p)
        pend.setdefault(b, []).append((p, l, int(i)))
        if len(pend[b]) == batch_size:
            yield emit(pend.pop(b), bucket=b)
    if not drop_last:
        for b, items in sorted(pend.items()):
            if items:
                yield emit(items, bucket=b)
    else:
        # up to n_buckets × (batch_size − 1) clouds are left: refund
        # their bumps so they lead the next epoch's sample, and say so
        dropped = [idx for items in pend.values() for *_ , idx in items]
        if dropped:
            sampler.refund(dropped)
            print(f"kpconv bucketed batching: {len(dropped)} tail "
                  f"clouds deferred to next epoch (potentials refunded)")


def seg_batches(
    dataset,
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    drop_last: bool = False,
    workers: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield ``{"xyz", "label", "seg", "valid"}`` batches from a part-seg
    dataset of ``(pts, label, seg)`` items, the tail padded as in
    :func:`cls_batches`; with ``workers > 0`` a fork pool assembles
    them."""
    chunks = _chunks(len(dataset), batch_size, shuffle, seed, drop_last)
    if workers > 0:
        from pointcloudlib_tpu_torch.data.workers import pool_batches

        yield from pool_batches(dataset, chunks, "seg", batch_size,
                                workers, seed=seed)
        return
    for chunk in chunks:
        yield _seg_batch_from(dataset, chunk, batch_size)
