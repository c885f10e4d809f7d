"""The port's data layer against the JAX package's, on the CPU: the
augmentations, the synthetic sets, the ModelNet40 text tree, its cache
and the single archive, the ShapeNet hdf5 files, the batch iterators
(KPConv's potential sampler, augmentation and epochs too), the fork
pool, ``prefetch`` and the confusion metrics. Where numpy draws are
involved the outputs must be bit-identical for the same seeds; the files
are tiny and written by the tests."""

import shutil
import threading

import numpy as np
import pytest

from pointcloudlib_tpu.data import augment as jax_augment
from pointcloudlib_tpu.data import loader as jax_loader
from pointcloudlib_tpu.data import modelnet40 as jax_modelnet40
from pointcloudlib_tpu.data import sampler as jax_sampler
from pointcloudlib_tpu.data import shapenet as jax_shapenet
from pointcloudlib_tpu.data import synthetic as jax_synthetic
from pointcloudlib_tpu.train import metrics as jax_metrics

from pointcloudlib_tpu_torch.data import augment, loader, modelnet40, sampler
from pointcloudlib_tpu_torch.data import shapenet, synthetic
from pointcloudlib_tpu_torch.data.workers import pool_batches
from pointcloudlib_tpu_torch.train import metrics


def _equal_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _equal_items(got, want, dtypes=True):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert not dtypes or np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)


AUGMENTS = {
    "random_scale_translate": lambda m, x, r: m.random_scale_translate(
        x[0], r),
    "random_permutation": lambda m, x, r: m.random_permutation(37, r),
    "normalize_unit_sphere": lambda m, x, r: m.normalize_unit_sphere(x[0]),
    "normalize_unit_sphere_batch":
        lambda m, x, r: m.normalize_unit_sphere_batch(x),
    "random_scale_translate_batch":
        lambda m, x, r: m.random_scale_translate_batch(x, r, 0.5, 2.0, 0.3),
    "subsample_rows_batch":
        lambda m, x, r: m.subsample_rows_batch(50, 20, 3, r),
    "rotate_z": lambda m, x, r: m.rotate_z(x[1], r),
    "jitter": lambda m, x, r: m.jitter(x[2], r, sigma=0.01),
}


@pytest.mark.parametrize("name", sorted(AUGMENTS))
def test_augmentation_bit_identical(name):
    """Each augmentation twice from one generator state on each side: the
    same outputs, dtypes and generator states after."""
    x = np.random.default_rng(1).standard_normal((3, 50, 3)).astype(
        np.float32)
    fn = AUGMENTS[name]
    rngs = [np.random.default_rng(7), np.random.default_rng(7)]
    for _ in range(2):
        got, want = fn(augment, x, rngs[0]), fn(jax_augment, x, rngs[1])
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert rngs[0].bit_generator.state == rngs[1].bit_generator.state


def test_synthetic_modelnet_augmented_over_two_passes():
    """``augment=True``: the per-item seeds and then each item's child
    generator are drawn from the dataset's one generator, so two passes
    in one index order give fresh and equal items on both sides."""
    kw = dict(n_points=48, size=6, seed=3)
    got = synthetic.SyntheticModelNet(train=True, **kw)
    want = jax_synthetic.SyntheticModelNet(train=True, **kw)
    assert got.augment and want.augment
    order = [4, 0, 5, 1, 1, 3]
    passes = [[got[i] for i in order] for _ in range(2)]
    _equal_items(passes[0], [want[i] for i in order])
    _equal_items(passes[1], [want[i] for i in order])
    assert not np.array_equal(passes[0][0][0], passes[1][0][0])


@pytest.mark.parametrize("train", [False, True])
def test_synthetic_modelnet_items_of_existing_callers_unchanged(train):
    """The port's tools and ``chip_smoke.py`` build the set without
    ``train`` or ``augment``: its default stays the test split without
    augmentation, the items of the JAX set at ``augment=False`` (which
    the port's class gave before it had ``augment``), and ``batch`` stacks
    them."""
    kw = dict(n_points=40, size=5, seed=2)
    default = synthetic.SyntheticModelNet(**kw)
    assert not default.train and not default.augment
    got = synthetic.SyntheticModelNet(train=train, augment=False, **kw)
    want = jax_synthetic.SyntheticModelNet(train=train, augment=False, **kw)
    _equal_items([got[i] for i in range(5)], [want[i] for i in range(5)])
    if not train:
        _equal_items([default[i] for i in range(5)],
                     [want[i] for i in range(5)])
        xyz, nrm, lab = default.batch(1, 3)
        np.testing.assert_array_equal(xyz[1], want[2][0])
        np.testing.assert_array_equal(nrm[1], want[2][1])
        assert lab.tolist() == [want[i][2] for i in (1, 2, 3)]


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("choice", [None, "Chair"])
def test_synthetic_shapenet_class_choice(train, choice):
    """The JAX items' part ids are int64 (its part offsets are an int64
    array), the port's the int32 of the documented item; the batches cast
    both to int32 and are bit-identical."""
    kw = dict(n_points=40, size=5, seed=4, train=train, class_choice=choice)
    got = synthetic.SyntheticShapeNetPart(**kw)
    want = jax_synthetic.SyntheticShapeNetPart(**kw)
    assert got.CATEGORIES == want.CATEGORIES
    _equal_items([got[i] for i in range(5)], [want[i] for i in range(5)],
                 dtypes=False)
    assert got[0][2].dtype == np.int32
    _equal_batches(loader.seg_batches(got, 2), jax_loader.seg_batches(want, 2))
    if choice:
        assert {got[i][1] for i in range(5)} == {4}


CATS = ["airplane", "flower_pot", "tv_stand"]


def _write_tree(root, rng):
    """A three-category text tree (two names with an underscore), 40
    rows of 6 columns a cloud, 5 train and 3 test clouds a category."""
    root.mkdir()
    (root / "modelnet40_shape_names.txt").write_text("\n".join(CATS) + "\n")
    ids = {"train": [], "test": []}
    for c in CATS:
        (root / c).mkdir()
        for i in range(8):
            sid = f"{c}_{i:04d}"
            pts = rng.standard_normal((40, 6)).astype(np.float32)
            np.savetxt(root / c / f"{sid}.txt", pts, delimiter=",",
                       fmt="%.6f")
            ids["train" if i < 5 else "test"].append(sid)
    for split, names in ids.items():
        (root / f"modelnet40_{split}.txt").write_text("\n".join(names) + "\n")
    return root


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Two copies of one tree: one first read by the port, one by JAX."""
    base = tmp_path_factory.mktemp("modelnet")
    a = _write_tree(base / "a", np.random.default_rng(0))
    b = base / "b"
    shutil.copytree(a, b)
    return a, b


class _ItemsOnly:
    """A dataset without ``get_batch``: the per-item batch path."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return self.ds[i]


def test_modelnet40_cache_written_by_either_package(trees):
    """The port reads the tree and writes ``cache_{split}.npz``; JAX
    reads that cache (and the other way round), to the same arrays."""
    a, b = trees
    for split in (True, False):
        port = modelnet40.ModelNet40(n_points=16, train=split,
                                     data_root=str(a))
        ref = jax_modelnet40.ModelNet40(n_points=16, train=split,
                                        data_root=str(b))
        name = f"cache_{'train' if split else 'test'}.npz"
        assert (a / name).exists() and (b / name).exists()
        from_port = jax_modelnet40.ModelNet40(n_points=16, train=split,
                                              data_root=str(a))
        from_jax = modelnet40.ModelNet40(n_points=16, train=split,
                                         data_root=str(b))
        for x, y in ((port, ref), (from_port, ref), (from_jax, ref)):
            np.testing.assert_array_equal(x._data[0], y._data[0])
            np.testing.assert_array_equal(x._data[1], y._data[1])
        assert port._data[0].shape == (15 if split else 9, 40, 6)
        assert sorted(set(port._data[1].tolist())) == [0, 1, 2]


@pytest.mark.parametrize("path", ["get_batch", "items"])
def test_modelnet40_cls_batches_two_epochs(trees, path):
    """Train: two shuffled epochs (seed + epoch) with ``drop_last`` and
    the augment draws; test: the padded tail with ``valid``; by
    ``get_batch`` and by the per-item path, equal to the JAX batches."""
    root = str(trees[0])

    def batches(mod, lmod, wrap):
        train = mod.ModelNet40(n_points=24, train=True, data_root=root,
                               seed=5)
        test = mod.ModelNet40(n_points=24, train=False, data_root=root)
        out = []
        for epoch in range(2):
            out += list(lmod.cls_batches(wrap(train), 4, shuffle=True,
                                         seed=5 + epoch, drop_last=True))
        return out + list(lmod.cls_batches(wrap(test), 4,
                                           with_normals=False))

    wrap = _ItemsOnly if path == "items" else (lambda d: d)
    got = batches(modelnet40, loader, wrap)
    _equal_batches(got, batches(jax_modelnet40, jax_loader, wrap))
    assert len(got) == 2 * 3 + 3  # 15 train clouds by 4; 9 test clouds
    assert got[-1]["valid"].tolist() == [True, False, False, False]
    assert "feats" not in got[-1] and got[0]["feats"].shape == (4, 24, 3)


def test_potential_sampler_bit_identical():
    """Three epochs of 5 of 12 items and a refund between them: the same
    picks, in the same order, and the same potentials as the JAX
    sampler's."""
    got, want = sampler.PotentialSampler(12, seed=3), \
        jax_sampler.PotentialSampler(12, seed=3)
    for epoch in range(3):
        a, b = got.sample(5), want.sample(5)
        np.testing.assert_array_equal(a, b)
        if epoch == 1:
            got.refund(a[:2])
            want.refund(b[:2])
        np.testing.assert_array_equal(got.potentials, want.potentials)
    np.testing.assert_array_equal(got.sample(40), want.sample(40))


@pytest.mark.parametrize("rotation", ["none", "vertical", "all"])
def test_kpconv_augment_bit_identical(rotation):
    x = np.random.default_rng(1).standard_normal((33, 3)).astype(np.float32)
    got = sampler.kpconv_augment(x, np.random.default_rng(2), rotation)
    want = jax_sampler.kpconv_augment(x, np.random.default_rng(2), rotation)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _bucket_of(cloud):
    """Two buckets by the cloud's mean height: the augmentation decides."""
    return int(cloud[:, 2].mean() > 0)


@pytest.mark.parametrize("bucketed", [False, True])
def test_kpconv_cls_batches_bit_identical(trees, bucketed, capsys):
    """Two epochs of KPConv's iterator on the tree (permuted, no ModelNet
    augmentation, as the CLI builds it): potential-sampled items, each
    augmented, in batches of 4 (bucketed: by ``_bucket_of``, with the
    bucket given and the left-over clouds refunded and named), the same
    batches and potentials as the JAX iterator's."""
    root = str(trees[0])

    def run(mod, lmod, smod):
        ds = mod.ModelNet40(n_points=24, train=True, data_root=root, seed=2,
                            augment=False, permute=True)
        s = smod.PotentialSampler(len(ds), seed=4)
        rng = np.random.default_rng(6)
        out = []
        for _ in range(2):
            out += list(lmod.kpconv_cls_batches(
                ds, 4, s, rng, epoch_n=10,
                bucket_of=_bucket_of if bucketed else None))
        return out, s.potentials, capsys.readouterr().out

    got, got_pot, got_log = run(modelnet40, loader, sampler)
    want, want_pot, want_log = run(jax_modelnet40, jax_loader, jax_sampler)
    buckets = [b.pop("bucket", None) for b in got]
    assert buckets == [b.pop("bucket", None) for b in want]
    _equal_batches(got, want)
    np.testing.assert_array_equal(got_pot, want_pot)
    assert got_log == want_log
    if bucketed:
        assert set(buckets) <= {0, 1} and None not in buckets
        assert "deferred to next epoch" in got_log
    else:
        assert len(got) == 4 and buckets == [None] * 4


def test_modelnet40_archive_and_errors(tmp_path):
    """The single archive: ``points_{split}`` keys, or ``points`` with a
    ``split`` marker; a missing split and a missing root raise the JAX
    errors."""
    rng = np.random.default_rng(3)
    pts = rng.standard_normal((5, 30, 6)).astype(np.float32)
    lab = np.arange(5, dtype=np.int32)
    np.savez(tmp_path / "both.npz", points_train=pts, labels_train=lab,
             points_test=pts[:2], labels_test=lab[:2])
    np.savez(tmp_path / "marked.npz", points=pts, labels=lab,
             split=np.array("train"))
    for root, train in (("both", True), ("both", False), ("marked", True)):
        kw = dict(n_points=20, train=train, seed=1,
                  data_root=str(tmp_path / root))
        got, want = modelnet40.ModelNet40(**kw), \
            jax_modelnet40.ModelNet40(**kw)
        _equal_items([got[i] for i in range(len(want))],
                     [want[i] for i in range(len(want))])
        idx = np.array([1, 0, 1])
        _equal_items([got.get_batch(idx)], [want.get_batch(idx)])
    for kw in (dict(train=False, data_root=str(tmp_path / "marked")),
               dict(data_root=str(tmp_path / "nothing")),
               dict(data_root=None)):
        with pytest.raises(FileNotFoundError) as got:
            modelnet40.ModelNet40(**kw)
        with pytest.raises(FileNotFoundError) as want:
            jax_modelnet40.ModelNet40(**kw)
        assert str(got.value) == str(want.value)


def test_make_modelnet40_synthetic():
    kw = dict(n_points=32, train=True, synthetic=True, synthetic_size=6,
              seed=1)
    got, want = modelnet40.make_modelnet40(**kw), \
        jax_modelnet40.make_modelnet40(**kw)
    _equal_batches(loader.cls_batches(got, 4, shuffle=True, seed=2),
                   jax_loader.cls_batches(want, 4, shuffle=True, seed=2))


def test_synthetic_tree_reads_in_both_packages(tmp_path):
    """``write_synthetic_tree`` writes the reference's layout: both
    packages read it, to the synthetic clouds rounded to six decimals."""
    root = modelnet40.write_synthetic_tree(tmp_path / "t", 3, 2,
                                           n_points=64, seed=1)
    got = modelnet40.ModelNet40(n_points=64, train=False,
                                data_root=str(root))
    want = jax_modelnet40.ModelNet40(n_points=64, train=False,
                                     data_root=str(tmp_path / "t"))
    np.testing.assert_array_equal(got._data[0], want._data[0])
    np.testing.assert_array_equal(got._data[1], [0, 1])
    src = synthetic.SyntheticModelNet(n_points=64, size=2, seed=1)
    np.testing.assert_allclose(got._data[0][1, :, :3], src[1][0],
                               atol=6e-7)


@pytest.fixture(scope="module")
def shapenet_h5(tmp_path_factory):
    import h5py

    root = tmp_path_factory.mktemp("shapenet")
    rng = np.random.default_rng(1)
    for split, n in [("train0", 6), ("val0", 3), ("test0", 5)]:
        with h5py.File(root / f"ply_data_{split}.h5", "w") as h:
            h["data"] = rng.standard_normal((n, 64, 3)).astype(np.float32)
            h["label"] = rng.integers(3, 6, (n, 1)).astype(np.uint8)
            h["pid"] = rng.integers(0, 50, (n, 64)).astype(np.uint8)
    return root


@pytest.mark.parametrize("choice", [None, "chair"])
def test_shapenet_seg_batches(shapenet_h5, choice):
    """trainval (train and val files joined, shuffled, ``drop_last``, the
    train-time permutation) and test (the padded tail) batches equal to
    the JAX batches, with and without ``class_choice``."""

    def batches(mod, lmod):
        kw = dict(n_points=48, data_root=str(shapenet_h5), seed=2,
                  class_choice=choice)
        train = mod.ShapeNetPart("trainval", **kw)
        test = mod.ShapeNetPart("test", **kw)
        return (list(lmod.seg_batches(train, 2, shuffle=True, seed=3,
                                      drop_last=True))
                + list(lmod.seg_batches(test, 3)))

    got = batches(shapenet, loader)
    _equal_batches(got, batches(jax_shapenet, jax_loader))
    if choice:
        assert all((b["label"] == 4).all() for b in got)
    with pytest.raises(FileNotFoundError):
        shapenet.ShapeNetPart("val", data_root=str(shapenet_h5 / "no"))


def test_make_shapenet_synthetic():
    kw = dict(n_points=32, synthetic=True, synthetic_size=5, seed=1,
              class_choice="mug")
    _equal_batches(
        loader.seg_batches(shapenet.make_shapenet("trainval", **kw), 2),
        jax_loader.seg_batches(jax_shapenet.make_shapenet("trainval", **kw),
                               2))


def test_pool_batches_equal_serial(shapenet_h5, trees):
    """Two forked workers on sets that hold no draw state give the
    serial batches, in order."""
    sets = [
        ("seg", shapenet.ShapeNetPart("test", n_points=32,
                                      data_root=str(shapenet_h5))),
        ("seg", synthetic.SyntheticShapeNetPart(n_points=32, size=7)),
        ("cls", modelnet40.ModelNet40(n_points=16, train=True,
                                      data_root=str(trees[0]),
                                      augment=False, permute=False)),
    ]
    for kind, ds in sets:
        chunks = loader._chunks(len(ds), 3, True, 4, False)
        make = loader._cls_batch_from if kind == "cls" else \
            loader._seg_batch_from
        want = [make(ds, c, 3, True) if kind == "cls" else make(ds, c, 3)
                for c in chunks]
        _equal_batches(pool_batches(ds, chunks, kind, 3, 2, seed=4), want)
    _equal_batches(loader.cls_batches(sets[2][1], 4, workers=2),
                   loader.cls_batches(sets[2][1], 4))


def test_prefetch_raises_and_stops_its_thread():
    def failing():
        yield 1
        raise KeyError("producer")

    it = loader.prefetch(failing())
    assert next(it) == 1
    with pytest.raises(KeyError, match="producer"):
        next(it)
    before = set(threading.enumerate())
    produced = []

    def endless():
        while True:
            produced.append(len(produced))
            yield produced[-1]

    for i, item in enumerate(loader.prefetch(endless(), size=2)):
        if i == 0:
            [worker] = set(threading.enumerate()) - before
        assert item == i
        if i == 3:
            break
    worker.join(timeout=5.0)
    assert not worker.is_alive()
    assert len(produced) <= 4 + 2 + 1  # the buffer and one pending put


def test_confusion_and_balanced_accuracy():
    rng = np.random.default_rng(9)
    true = rng.integers(0, 7, 200)
    pred = np.where(rng.random(200) < 0.6, true, rng.integers(0, 9, 200))
    got = metrics.fast_confusion(true, pred, 9)
    np.testing.assert_array_equal(
        got, jax_metrics.fast_confusion(true, pred, 9))
    assert got.sum() == 200 and got[7:].sum() == 0  # absent true classes
    assert metrics.balanced_accuracy(true, pred, 9) == \
        jax_metrics.balanced_accuracy(true, pred, 9)
    assert metrics.balanced_accuracy(true[:0], pred[:0], 9) == 0.0
    assert metrics.SEG_NUM == jax_metrics.SEG_NUM
    assert metrics.INDEX_START == jax_metrics.INDEX_START
