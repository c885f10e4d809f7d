"""PointConv classification and part segmentation in the PyTorch port
against the JAX models, on the CPU: the weight bridge both ways, eval
logits, the Predictor and the SegPredictor, and two train steps of each.

Weights come from ``random_jax_variables`` and reach the port through
``from_jax_variables``. Full widths; classification at B=2, N=512 (SA1
takes all 512 points as centers; the train steps at B=4) with normals as
features, part segmentation at B=2, N=1024; lr 1e-4. On the CPU both
sides run f32; the JAX package takes its XLA routes there (no Pallas),
the port the plain versions of its kernels behind the same gates (at
N=1024 SA2 takes the fused kNN + gather, the decoders' wide gathers
``GatherNeighbors``).

The JAX ``PointConvPartSeg`` fixes its head's dropout at 0.4, whose mask
the port cannot reproduce, so its train steps compare against
``_PointConvPartSegNoDropout``: the same calls in the same order without
the dropout (flax names submodules by class and order, so the variable
trees are equal, which a test asserts); the port runs
``PointConvPartSeg(dropout=0.0)``. Classification takes
``PointConvDensityCls(dropout=0.0)`` on both sides.
"""

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from pointcloudlib_tpu.models.pointconv import (
    PointConvDensityCls as JaxPointConvCls,
)
from pointcloudlib_tpu.models.pointconv import PointConvInterp as JaxInterp
from pointcloudlib_tpu.models.pointconv import (
    PointConvPartSeg as JaxPointConvPartSeg,
)
from pointcloudlib_tpu.models.pointconv import PointConvSA as JaxSA
from pointcloudlib_tpu.nn.layers import DenseBNAct as JaxDenseBNAct
from pointcloudlib_tpu.nn.layers import reference_linear_init
from pointcloudlib_tpu.train.state import TrainState
from pointcloudlib_tpu.train.state import sgd_momentum as jax_sgd
from pointcloudlib_tpu.train.trainer import (
    make_cls_train_step as jax_cls_step,
)
from pointcloudlib_tpu.train.trainer import (
    make_seg_train_step as jax_seg_step,
)

from pointcloudlib_tpu_torch.inference import (
    Predictor,
    SegPredictor,
    _batches,
    _pad_points,
)
from pointcloudlib_tpu_torch.models import get_cls_model, get_seg_model
from pointcloudlib_tpu_torch.models.pointconv import (
    PointConvDensityCls,
    PointConvPartSeg,
)
from pointcloudlib_tpu_torch.nn.layers import DenseBNAct
from pointcloudlib_tpu_torch.train import (
    make_cls_train_step,
    make_seg_train_step,
    sgd_momentum,
)
from pointcloudlib_tpu_torch.utils.interop import (
    from_jax_variables,
    jax_variable_shapes,
    random_jax_variables,
    to_jax_variables,
)

CLS_B, CLS_N, SEG_B, SEG_N, LR = 2, 512, 2, 1024, 1e-4
# classification trains on 4 clouds: at B=2 the head's and SA3's
# train-mode BatchNorms see 2 rows a channel, and wherever the two differ
# by less than √eps their output turns on rounding (logits 0.17 apart)
STEP_B = 4


class _PointConvPartSegNoDropout(nn.Module):
    """``PointConvPartSeg`` (``models/pointconv.py:189``) without the
    head's dropout."""

    part_num: int = 50

    @nn.compact
    def __call__(self, xyz, cls_label, feats=None, training: bool = False):
        del cls_label, feats
        l1x, l1f = JaxSA(mlp=[32, 32, 64], bandwidth=0.1, n_points=1024,
                         k=32)(xyz, None, training)
        l2x, l2f = JaxSA(mlp=[64, 64, 128], bandwidth=0.2, n_points=256,
                         k=32)(l1x, l1f, training)
        l3x, l3f = JaxSA(mlp=[128, 128, 256], bandwidth=0.4, n_points=64,
                         k=32)(l2x, l2f, training)
        l4x, l4f = JaxSA(mlp=[256, 256, 512], bandwidth=0.8, n_points=36,
                         k=32)(l3x, l3f, training)
        l3f = JaxInterp([512, 512], 0.8)(l3x, l4x, l4f, training)
        l2f = JaxInterp([256, 256], 0.4)(l2x, l3x, l3f, training)
        l1f = JaxInterp([128, 128], 0.2)(l1x, l2x, l2f, training)
        l0f = JaxInterp([128, 128, 128], 0.1)(xyz, l1x, l1f, training)
        h = JaxDenseBNAct(128, use_bias=True)(l0f, training)
        return nn.Dense(self.part_num, use_bias=True,
                        kernel_init=reference_linear_init)(h)


def _clouds(rng, b, n):
    x = rng.standard_normal((b, n, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    return x * rng.uniform(0.6, 1.0, (b, n, 1)).astype(np.float32)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _shapes(module, *args):
    tree = jax.eval_shape(lambda: module.init(jax.random.key(0), *args))
    return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)


def _two_steps(step, jstep, state, model, batch, jbatch):
    """Two steps on each side → ``(port, ref)``, each a list of
    ``(flat variables, metrics)``."""
    port, ref = [], []
    for _ in range(2):
        state, jmet = jstep(state, jbatch, jax.random.key(0))
        ref.append((_flat({"params": state.params,
                           "batch_stats": state.batch_stats}),
                    {k: float(v) for k, v in jmet.items()}))
        met = step(batch)
        port.append((_flat(to_jax_variables(model)),
                     {k: float(v) for k, v in met.items()}))
    return port, ref


def _eval(module):
    """The JAX model's eval-mode forward, compiled (op by op it takes
    several times as long)."""
    return jax.jit(lambda v, *a: module.apply(v, *a, training=False))


def _served(arrays, forward):
    """``forward`` on each batch of 2 that a predictor serves for
    ``arrays`` (the last batch filled by repeating its last cloud), the
    real rows joined."""
    outs = [np.asarray(forward(*chunks))[:real] for chunks, real in
            _batches(arrays, 2)]
    return np.concatenate(outs)


def _state(apply_fn, start):
    return TrainState.create(
        apply_fn=apply_fn,
        params=jax.tree_util.tree_map(jnp.asarray, start["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           start["batch_stats"]),
        tx=jax_sgd(LR))


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The port's CPU work on 2 threads: beside the other workers of a
    parallel test run (``pytest -n 6``), more only contend for the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs():
    """Everything that needs the JAX models, computed once: the variable
    trees' shapes, eval logits, the predictors on both sides and two
    train steps of each model on both sides."""
    rng = np.random.default_rng(0)
    out = {}

    # classification: 3 clouds of 500 points with normals, served at
    # batch 2 (the 512 bucket, a half-empty last batch); the logits of the
    # served batches (B=2, N=512) on both sides
    clouds, normals = _clouds(rng, 3, 500), rng.standard_normal(
        (3, 500, 3)).astype(np.float32)
    model = get_cls_model("pointconv", dropout=0.0)
    start = random_jax_variables(model, seed=0)
    from_jax_variables(model, start)
    jm = JaxPointConvCls(dropout=0.0)
    out["cls_start"] = _flat(start)
    xyz, nrm = _pad_points([clouds[:2], normals[:2]], 500)
    out["cls_shapes"] = (_shapes(jm, jnp.asarray(xyz), jnp.asarray(nrm)),
                         jax_variable_shapes(model))
    model.eval()
    served = _pad_points([clouds, normals], 500)  # to the 512 bucket
    with torch.no_grad():
        got = _served(served, lambda x, f: model(torch.from_numpy(x),
                                                 torch.from_numpy(f)))
    fwd = _eval(jm)
    want = _served(served, lambda x, f: fwd(start, jnp.asarray(x),
                                            jnp.asarray(f)))
    out["cls_logits"] = (got, want)
    pp = Predictor.from_variables("pointconv", start, with_normals=True,
                                  batch_size=2, device="cpu")
    out["cls_probs"] = (pp.predict_proba(clouds, normals),
                        np.asarray(jax.nn.softmax(want, -1)))
    xyz, nrm = _clouds(rng, STEP_B, CLS_N), rng.standard_normal(
        (STEP_B, CLS_N, 3)).astype(np.float32)
    batch = {"xyz": xyz, "feats": nrm, "label": np.array([3, 17, 5, 29])}
    step = make_cls_train_step(model, sgd_momentum(model.parameters(), LR),
                               device="cpu")
    out["cls_port"], out["cls_ref"] = _two_steps(
        step, jax_cls_step(jm), _state(jm.apply, start), model, batch,
        {k: jnp.asarray(v) for k, v in batch.items()})

    # part segmentation: 3 clouds of 1000 points served at batch 2 (the
    # 1024 bucket); the logits of the served batches (B=2, N=1024)
    clouds, labels = _clouds(rng, 3, 1000), np.array([1, 4, 7])
    onehot = np.eye(16, dtype=np.float32)[labels]
    model = get_seg_model("pointconv", dropout=0.0)
    start = random_jax_variables(model, seed=1)
    from_jax_variables(model, start)
    jm, jm0 = JaxPointConvPartSeg(), _PointConvPartSegNoDropout()
    out["seg_start"] = _flat(start)
    [xyz] = _pad_points([clouds[:2]], 1000)
    args = (jnp.asarray(xyz), jnp.asarray(onehot[:2]))
    out["seg_shapes"] = (_shapes(jm, *args), _shapes(jm0, *args),
                         jax_variable_shapes(model))
    model.eval()
    served = _pad_points([clouds], 1000) + [onehot]  # the 1024 bucket
    with torch.no_grad():
        got = _served(served, lambda x, o: model(torch.from_numpy(x),
                                                 torch.from_numpy(o)))
    fwd = _eval(jm)
    want = _served(served, lambda x, o: fwd(start, jnp.asarray(x),
                                            jnp.asarray(o)))
    out["seg_logits"] = (got, want)
    sp = SegPredictor.from_variables("pointconv", start, batch_size=2,
                                     device="cpu")
    out["seg_predictor"] = (sp.predict(clouds, labels),
                            sp.predict_proba(clouds, labels),
                            np.asarray(jax.nn.softmax(want[:, :1000], -1)),
                            sp.with_xyz_feats)
    batch = {"xyz": _clouds(rng, SEG_B, SEG_N), "cls_onehot": onehot[:2],
             "seg": rng.integers(0, 50, (SEG_B, SEG_N)).astype(np.int32)}
    step = make_seg_train_step(model, sgd_momentum(model.parameters(), LR),
                               device="cpu")
    out["seg_port"], out["seg_ref"] = _two_steps(
        step, jax_seg_step(jm0), _state(jm0.apply, start), model, batch,
        {k: jnp.asarray(v) for k, v in batch.items()})
    return out


def test_bridge_layout_is_the_jax_tree(runs):
    """The bridge's layout is the flax tree of both JAX models (and of
    the dropout-free stand-in): ``PointConvSA_i`` with ``DensityNet_0``,
    ``PointMLP_0``, ``WeightNet_0``, ``Dense_0`` and ``BatchNorm_0``."""
    jax_tree, bridge = runs["cls_shapes"]
    assert jax_tree == bridge
    assert sorted(bridge["params"]) == [
        "DenseBNAct_0", "DenseBNAct_1", "Dense_0", "PointConvSA_0",
        "PointConvSA_1", "PointConvSA_2"]
    sa = bridge["params"]["PointConvSA_0"]
    assert sorted(sa) == ["BatchNorm_0", "Dense_0", "DensityNet_0",
                          "PointMLP_0", "WeightNet_0"]
    assert sa["Dense_0"] == {"kernel": (128 * 16, 128), "bias": (128,)}
    assert sa["PointMLP_0"]["DenseBNAct_0"]["Dense_0"] == {"kernel": (6, 64)}
    assert sa["DensityNet_0"]["DenseBNAct_0"]["Dense_0"] == {
        "kernel": (1, 8), "bias": (8,)}
    jax_tree, stand_in, bridge = runs["seg_shapes"]
    assert jax_tree == stand_in == bridge
    assert sorted(bridge["params"]) == [
        "DenseBNAct_0", "Dense_0"] + [f"PointConvInterp_{i}" for i in
                                      range(4)] + [
        f"PointConvSA_{i}" for i in range(4)]
    assert bridge["params"]["PointConvInterp_0"]["PointMLP_0"][
        "DenseBNAct_0"]["Dense_0"] == {"kernel": (515, 512)}


@pytest.mark.parametrize("model", [PointConvDensityCls, PointConvPartSeg])
def test_bridge_round_trip(model):
    m = model()
    variables = random_jax_variables(m, seed=4)
    back = to_jax_variables(from_jax_variables(m, variables))
    flat_a, flat_b = _flat(variables), _flat(back)
    assert flat_a.keys() == flat_b.keys()
    for key, a in flat_a.items():
        np.testing.assert_array_equal(flat_b[key], a)


def test_logits_match_jax(runs):
    """Eval logits of both models on the served batches: f32 on both
    sides; the kNN's d² and the sums run in other orders (1e-4)."""
    for key in ("cls_logits", "seg_logits"):
        got, want = runs[key]
        assert np.abs(want).max() > 0.05  # the logits carry signal
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=key)


def test_predictors_match_jax(runs):
    """The Predictor (normals as features) and the SegPredictor (xyz only)
    on the CPU against the softmax of the JAX model's logits on the same
    served batches (bucket padding, a half-empty last batch); the part
    ids of the caller's points only."""
    got, want = runs["cls_probs"]
    assert got.shape == (3, 40)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    ids, probs, want, with_xyz = runs["seg_predictor"]
    assert ids.shape == (3, 1000) and probs.shape == want.shape
    assert not with_xyz
    np.testing.assert_array_equal(ids, probs.argmax(-1))
    np.testing.assert_allclose(probs, want, rtol=1e-4, atol=1e-5)


# Bounds per step: (loss relative; each running statistic and parameter
# × its largest element; least cosine of an update beyond rounding). The
# kNN's d² and the sums run in other orders on the two sides; the gap
# grows with the step. Measured (both models): step 1 loss 1.1e-6,
# elements 9.7e-5, cosine 0.9994; step 2 loss 3.1e-5, elements 3.1e-3,
# cosine 0.9933.
_STEP_TOL = {1: (1e-5, 1e-3, 0.998), 2: (1e-3, 1e-2, 0.98)}


@pytest.mark.parametrize("n_steps", [1, 2])
@pytest.mark.parametrize("tag", ["cls", "seg"])
def test_train_steps_match_jax(runs, tag, n_steps):
    """Loss, accuracy, every BN running statistic and every parameter
    after one and two SGD steps (momentum 0.9, lr 1e-4) within
    ``_STEP_TOL``, and every update that JAX makes beyond rounding
    pointing the same way in the port. ``pytest -s`` shows the worst."""
    start = runs[f"{tag}_start"]
    got, gmet = runs[f"{tag}_port"][n_steps - 1]
    want, wmet = runs[f"{tag}_ref"][n_steps - 1]
    loss_tol, elem_tol, min_cos = _STEP_TOL[n_steps]
    assert np.isfinite(gmet["loss"])
    assert abs(gmet["loss"] - wmet["loss"]) <= loss_tol * abs(wmet["loss"])
    assert gmet["acc"] == pytest.approx(wmet["acc"], abs=1e-2)
    assert got.keys() == want.keys()
    worst, least = (0.0, ""), (1.0, "")
    for k in want:
        err = np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(),
                                                    1e-6)
        worst = max(worst, (err, k))
        assert err <= elem_tol, (k, err)
        du, dw = (got[k] - start[k]).ravel(), (want[k] - start[k]).ravel()
        if np.linalg.norm(dw) > 1e-4 * max(np.linalg.norm(start[k]), 1.0):
            cos = du @ dw / (np.linalg.norm(du) * np.linalg.norm(dw))
            least = min(least, (cos, k))
            assert cos >= min_cos, (k, cos)
    print(f"{tag} after {n_steps}: worst element {worst}, least update "
          f"cosine {least}")


def test_entry_points_need_a_card_or_the_cpu():
    """Without a card the predictors and the steps raise unless the
    caller passes ``device="cpu"``; PointConv is in both registries and
    its Predictor reads normals only when asked (``with_normals``); every
    Dense layer takes f32 operands."""
    cls, seg = PointConvDensityCls(), PointConvPartSeg()
    if not torch.cuda.is_available():
        for make in (lambda: Predictor(cls, with_normals=True),
                     lambda: SegPredictor(seg),
                     lambda: make_cls_train_step(
                         cls, sgd_momentum(cls.parameters(), LR)),
                     lambda: make_seg_train_step(
                         seg, sgd_momentum(seg.parameters(), LR))):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    p = Predictor.from_variables(
        "pointconv", random_jax_variables(PointConvDensityCls(
            feat_channels=0)), batch_size=1, device="cpu")
    assert not p.with_normals and p.model.sa1.mlp[0].dense.in_features == 3
    assert isinstance(get_seg_model("pointconv"), PointConvPartSeg)
    # every Dense in f32 on every device (models/pointconv.py)
    for model in (cls, seg):
        assert {m.dtype for m in model.modules()
                if isinstance(m, DenseBNAct)} == {torch.float32}
