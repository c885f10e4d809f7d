"""ModelNet40 from files (counterpart of
``pointcloudlib_tpu/data/modelnet40.py``), or its synthetic stand-in.

Two layouts under ``data_root``, as the JAX package reads them:

* the reference's ``modelnet40_normal_resampled`` text tree
  (``modelnet40_shape_names.txt``, ``modelnet40_{train,test}.txt`` and
  ``<category>/<id>.txt`` of comma-separated rows ``x,y,z,nx,ny,nz``),
  read once into ``cache_{train,test}.npz`` (``points [M, P, 6]`` f32,
  ``labels [M]`` int32) beside it; either package reads a cache the
  other wrote;
* one archive ``<data_root>.npz`` holding ``points_train`` /
  ``labels_train`` and ``points_test`` / ``labels_test``, or ``points`` /
  ``labels`` with a ``split`` marker.

Items: ``(pts [N,3], normals [N,3], label)``. Numpy only.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from pointcloudlib_tpu_torch.data import augment as A
from pointcloudlib_tpu_torch.data.synthetic import SyntheticModelNet

_CATEGORY_FILE = "modelnet40_shape_names.txt"
# the reference's category order (modelnet40_shape_names.txt)
CATEGORIES = (
    "airplane", "bathtub", "bed", "bench", "bookshelf", "bottle", "bowl",
    "car", "chair", "cone", "cup", "curtain", "desk", "door", "dresser",
    "flower_pot", "glass_box", "guitar", "keyboard", "lamp", "laptop",
    "mantel", "monitor", "night_stand", "person", "piano", "plant",
    "radio", "range_hood", "sink", "sofa", "stairs", "stool", "table",
    "tent", "toilet", "tv_stand", "vase", "wardrobe", "xbox")


class ModelNet40:
    """The reference loader's item: the first ``n_points`` of a random
    permutation (``permute``, default: ``augment``), xyz normalized to the
    unit sphere, and with ``augment`` (default: ``train``) the anisotropic
    scale and translation. The draws come from the dataset's generator
    ``_rng``, seeded by ``seed``, in the JAX class's order."""

    def __init__(
        self,
        n_points: int = 1024,
        train: bool = True,
        data_root: Optional[str] = None,
        seed: int = 0,
        augment: Optional[bool] = None,
        permute: Optional[bool] = None,
    ):
        self.n_points = n_points
        self.train = train
        # voting eval re-augments the test split
        self.augment = train if augment is None else augment
        self.permute = self.augment if permute is None else permute
        self._rng = np.random.default_rng(seed)
        self._data = None  # (points [M, P, 6], labels [M])
        root = Path(data_root) if data_root else None
        if root and (root / _CATEGORY_FILE).exists():
            self._load_txt_tree(root)
        elif root and root.with_suffix(".npz").exists():
            # a single archive must name its splits: never serve the same
            # rows as both train and test
            z = np.load(root.with_suffix(".npz"))
            sp = "train" if train else "test"
            if f"points_{sp}" in z:
                self._data = (z[f"points_{sp}"], z[f"labels_{sp}"])
            elif "split" in z and str(z["split"]) == sp:
                self._data = (z["points"], z["labels"])
            else:
                raise FileNotFoundError(
                    f"{root.with_suffix('.npz')} has no '{sp}' split "
                    f"(keys: {sorted(z.keys())}); a single archive "
                    "needs points_train/labels_train + points_test/"
                    "labels_test, or a split='train'|'test' marker"
                )
        else:
            raise FileNotFoundError(
                f"ModelNet40 files not found under {data_root!r}; "
                "pass --synthetic to train without the real dataset"
            )

    def _load_txt_tree(self, root: Path):
        cache = root / f"cache_{'train' if self.train else 'test'}.npz"
        if cache.exists():
            z = np.load(cache)
            self._data = (z["points"], z["labels"])
            return
        with open(root / _CATEGORY_FILE) as fh:
            cats = [line.strip() for line in fh]
        split = "train" if self.train else "test"
        with open(root / f"modelnet40_{split}.txt") as fh:
            ids = [line.strip() for line in fh]
        pts_all, labels = [], []
        for sid in ids:
            cat = "_".join(sid.split("_")[:-1])
            arr = np.loadtxt(root / cat / f"{sid}.txt", delimiter=",",
                             dtype=np.float32)
            pts_all.append(arr)
            labels.append(cats.index(cat))
        self._data = (
            np.stack(pts_all),
            np.asarray(labels, np.int32),
        )
        np.savez_compressed(cache, points=self._data[0], labels=self._data[1])

    def __len__(self):
        return len(self._data[1])

    def __getitem__(self, i: int):
        raw, label = self._data[0][i], int(self._data[1][i])
        if self.permute:
            sel = self._rng.permutation(raw.shape[0])[: self.n_points]
        else:
            sel = np.arange(self.n_points)
        item = raw[sel]
        pts, nrm = item[:, :3], item[:, 3:6]
        pts = A.normalize_unit_sphere(pts)
        if self.augment:
            pts = A.random_scale_translate(pts, self._rng)
        return pts.astype(np.float32), nrm.astype(np.float32), label

    def get_batch(self, idx: np.ndarray):
        """The items ``idx`` in one numpy call per stage: the per-item
        semantics (subset distribution, normalization, augment draws) with
        the batched draws of the JAX class's ``get_batch``.

        Returns ``(pts [b, n, 3], normals [b, n, 3], labels [b])``.
        """
        all_pts, m = self._data[0], self._data[0].shape[1]
        b = len(idx)
        if self.permute:
            sel = A.subsample_rows_batch(m, self.n_points, b, self._rng)
            # one fancy index from the full cache
            item = all_pts[np.asarray(idx)[:, None], sel]
        else:
            item = all_pts[idx][:, : self.n_points]
        pts, nrm = item[..., :3], item[..., 3:6]
        pts = A.normalize_unit_sphere_batch(pts)
        if self.augment:
            pts = A.random_scale_translate_batch(pts, self._rng)
        return (pts.astype(np.float32), nrm.astype(np.float32),
                self._data[1][idx].astype(np.int32))


def write_synthetic_tree(root, n_train: int, n_test: int,
                         n_points: int = 2048, seed: int = 0) -> Path:
    """Write a ModelNet40 text tree of :class:`SyntheticModelNet` clouds
    (their un-augmented items, ``x,y,z,nx,ny,nz`` to six decimals, as the
    reference's files) under ``root``: ``n_train`` and ``n_test`` clouds,
    the category of each its synthetic class. For runs of the file
    loader where the dataset is not at hand."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    (root / _CATEGORY_FILE).write_text("\n".join(CATEGORIES) + "\n")
    for split, size in (("train", n_train), ("test", n_test)):
        ds = SyntheticModelNet(n_points=n_points, size=size,
                               train=split == "train", seed=seed,
                               augment=False)
        ids = []
        for i in range(size):
            pts, nrm, label = ds[i]
            cat = CATEGORIES[label]
            sid = f"{cat}_{split}{i:04d}"
            (root / cat).mkdir(exist_ok=True)
            np.savetxt(root / cat / f"{sid}.txt",
                       np.concatenate([pts, nrm], 1), fmt="%.6f",
                       delimiter=",")
            ids.append(sid)
        (root / f"modelnet40_{split}.txt").write_text("\n".join(ids) + "\n")
    return root


def make_modelnet40(
    n_points: int,
    train: bool,
    data_root: Optional[str] = None,
    synthetic: bool = False,
    synthetic_size: int = 512,
    seed: int = 0,
    augment: Optional[bool] = None,
    permute: Optional[bool] = None,
):
    """:class:`ModelNet40`, or with ``synthetic`` the
    :class:`SyntheticModelNet` split (``permute`` does not apply)."""
    if synthetic:
        return SyntheticModelNet(
            n_points=n_points, train=train, size=synthetic_size, seed=seed,
            augment=augment,
        )
    return ModelNet40(n_points=n_points, train=train, data_root=data_root,
                      seed=seed, augment=augment, permute=permute)
