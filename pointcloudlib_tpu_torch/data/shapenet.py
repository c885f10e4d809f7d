"""ShapeNet-Part from the reference's hdf5 files (counterpart of
``pointcloudlib_tpu/data/shapenet.py``), or its synthetic stand-in.

Splits: train / val / test / trainval (train and val files joined). Per
item the first ``n_points`` points, shuffled in training. Items: ``(pts
[N,3] f32, label int, seg [N] int32)``. ``h5py`` is imported only when
a dataset is built from files.
"""

from __future__ import annotations

import glob
from pathlib import Path
from typing import Optional

import numpy as np

from pointcloudlib_tpu_torch.data.synthetic import SyntheticShapeNetPart


class ShapeNetPart:
    def __init__(
        self,
        split: str = "trainval",
        n_points: int = 2048,
        data_root: Optional[str] = None,
        class_choice: Optional[str] = None,
        seed: int = 0,
    ):
        import h5py

        self.n_points = n_points
        self.split = split
        self.train = split in ("train", "trainval")
        self._rng = np.random.default_rng(seed)

        if data_root is None:
            raise FileNotFoundError(
                "ShapeNetPart needs data_root=<dir with the reference "
                "hdf5 files> (shapenet_part_seg_hdf5_data); pass "
                "synthetic=True via make_shapenet to train without "
                "the real dataset")
        root = Path(data_root)
        if split == "trainval":
            files = sorted(glob.glob(str(root / "*train*.h5"))) + sorted(
                glob.glob(str(root / "*val*.h5"))
            )
        else:
            files = sorted(glob.glob(str(root / f"*{split}*.h5")))
        if not files:
            raise FileNotFoundError(
                f"no ShapeNet h5 files for split {split!r} under {data_root!r}"
            )
        pts, labels, segs = [], [], []
        for f in files:
            with h5py.File(f, "r") as h:
                pts.append(h["data"][:].astype(np.float32))
                labels.append(h["label"][:].astype(np.int32).reshape(-1))
                segs.append(h["pid"][:].astype(np.int32))
        self.points = np.concatenate(pts)
        self.labels = np.concatenate(labels)
        self.segs = np.concatenate(segs)

        if class_choice is not None:
            cats = SyntheticShapeNetPart.CATEGORIES
            keep = self.labels == cats.index(class_choice.lower())
            self.points, self.labels, self.segs = (
                self.points[keep], self.labels[keep], self.segs[keep])

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i: int):
        pts = self.points[i][: self.n_points]
        seg = self.segs[i][: self.n_points]
        if self.train:
            perm = self._rng.permutation(len(pts))
            pts, seg = pts[perm], seg[perm]
        return pts, int(self.labels[i]), seg


def make_shapenet(
    split: str,
    n_points: int,
    data_root: Optional[str] = None,
    synthetic: bool = False,
    synthetic_size: int = 256,
    seed: int = 0,
    class_choice: Optional[str] = None,
):
    if synthetic:
        return SyntheticShapeNetPart(
            n_points=n_points,
            size=synthetic_size,
            train=split in ("train", "trainval"),
            seed=seed,
            class_choice=class_choice,
        )
    return ShapeNetPart(split=split, n_points=n_points, data_root=data_root,
                        seed=seed, class_choice=class_choice)
