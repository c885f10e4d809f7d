"""PointNet classification and part segmentation in the PyTorch port
against the JAX models, on the CPU: the weight bridge both ways, eval
logits, the Predictor and the SegPredictor, the eval steps, one and two
train steps of each, and the gradient split of tied maxima.

Weights come from ``random_jax_variables`` and reach the port through
``from_jax_variables``. Full widths; classification at B=2, N=512 (the
train steps at B=4 on clouds whose every point appears twice: each global
max is a tie), part segmentation at B=2, N=1024 (the train steps at
B=4, on synthetic part-segmentation clouds and on random ones); lr 1e-4,
dropout 0
(``PointNet(dropout=0.0)`` on both sides; the part segmentation model has
none). The models run no kernel: on the CPU both sides run their dense
layers in f32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudlib_tpu.models.pointnet import PointNet as JaxPointNet
from pointcloudlib_tpu.models.pointnet import (
    PointNetPartSeg as JaxPointNetPartSeg,
)
from pointcloudlib_tpu.train.state import TrainState
from pointcloudlib_tpu.train.state import sgd_momentum as jax_sgd
from pointcloudlib_tpu.train.trainer import (
    make_cls_train_step as jax_cls_step,
)
from pointcloudlib_tpu.train.trainer import (
    make_seg_train_step as jax_seg_step,
)

from pointcloudlib_tpu_torch.data.synthetic import SyntheticShapeNetPart
from pointcloudlib_tpu_torch.inference import (
    Predictor,
    SegPredictor,
    _batches,
    _pad_points,
)
from pointcloudlib_tpu_torch.models import get_cls_model, get_seg_model
from pointcloudlib_tpu_torch.models.pointnet import PointNet, PointNetPartSeg
from pointcloudlib_tpu_torch.nn.layers import DenseBNAct
from pointcloudlib_tpu_torch.train import (
    make_cls_eval_step,
    make_cls_train_step,
    make_seg_eval_step,
    make_seg_train_step,
    sgd_momentum,
)
from pointcloudlib_tpu_torch.utils.interop import (
    from_jax_variables,
    jax_variable_shapes,
    random_jax_variables,
    to_jax_variables,
)

# The train steps take 4 clouds, part segmentation's of four shapes: the
# train-mode BatchNorms after a global max (the classification head's,
# each STN's PointMLP 512 / 256) see one row a cloud, and where the rows
# of a channel lie within √eps of each other (2 clouds, or clouds drawn
# alike, whose maxima nearly agree) they scale f32 rounding up by as much
# as 1/√eps; two such layers in a row (an STN) compound it. On random
# clouds part segmentation is held to the JAX model's own spread under a
# reordering of its sums (test_random_cloud_train_steps_within_jax_own_spread)
CLS_N, SEG_N, STEP_B, LR = 512, 1024, 4, 1e-4


def _clouds(rng, b, n):
    x = rng.standard_normal((b, n, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    return x * rng.uniform(0.6, 1.0, (b, n, 1)).astype(np.float32)


def _twice(rng, b, n):
    """``b`` clouds of ``n`` points, each of ``n / 2`` points twice."""
    x = _clouds(rng, b, n // 2)
    return np.concatenate([x, x], axis=1)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _shapes(module, *args):
    tree = jax.eval_shape(lambda: module.init(jax.random.key(0), *args))
    return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)


def _eval(module):
    return jax.jit(lambda v, *a: module.apply(v, *a, training=False))


def _served(arrays, forward):
    """``forward`` on each batch of 2 a predictor serves for ``arrays``
    (the last filled by repeating its last cloud), the real rows joined."""
    return np.concatenate([np.asarray(forward(*chunks))[:real]
                           for chunks, real in _batches(arrays, 2)])


def _state(apply_fn, start):
    """The JAX train state at ``start``, made in one program (optax's
    eager init compiles one for each parameter's shape)."""
    tx = jax_sgd(LR)
    return jax.jit(lambda params, stats: TrainState.create(
        apply_fn=apply_fn, params=params, batch_stats=stats, tx=tx))(
        start["params"], start["batch_stats"])


def _jax_steps(jstep, state, batch):
    """Two JAX steps → a list of ``(flat variables, metrics)``."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = []
    for _ in range(2):
        state, jmet = jstep(state, jbatch, jax.random.key(0))
        ref.append((_flat({"params": state.params,
                           "batch_stats": state.batch_stats}),
                    {k: float(v) for k, v in jmet.items()}))
    return ref


def _two_steps(step, jstep, state, model, batch):
    """Two steps on each side → ``(port, ref)``, each a list of ``(flat
    variables, metrics)``."""
    port = []
    for _ in range(2):
        met = step(batch)
        port.append((_flat(to_jax_variables(model)),
                     {k: float(v) for k, v in met.items()}))
    return port, _jax_steps(jstep, state, batch)


def _input_grads(model, variables, xyz):
    """The gradient of Σ logits² with respect to ``xyz`` in one
    train-mode forward of ``model`` (a fresh copy) from the JAX
    ``variables``."""
    from_jax_variables(model, variables)
    x = torch.from_numpy(xyz).requires_grad_(True)
    model.train()
    (model(x) ** 2).sum().backward()
    return x.grad.numpy()


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
    """Everything that needs the JAX models, computed once."""
    rng = np.random.default_rng(0)
    out = {}

    # classification: 3 clouds of 500 points served at batch 2 (the 512
    # bucket: cyclic padding, repeated points)
    clouds = _clouds(rng, 3, 500)
    model = get_cls_model("pointnet", dropout=0.0)
    start = random_jax_variables(model, seed=0)
    from_jax_variables(model, start)
    jm = JaxPointNet(dropout=0.0)
    out["cls_start"] = _flat(start)
    [xyz] = _pad_points([clouds[:2]], 500)
    out["cls_shapes"] = (_shapes(jm, jnp.asarray(xyz)),
                         jax_variable_shapes(model))
    served = _pad_points([clouds], 500)
    model.eval()
    with torch.no_grad():
        got = _served(served, lambda x: model(torch.from_numpy(x)))
    fwd = _eval(jm)
    want = _served(served, lambda x: fwd(start, jnp.asarray(x)))
    out["cls_logits"] = (got, want)
    pp = Predictor.from_variables("pointnet", start, batch_size=2,
                                  device="cpu")
    out["cls_probs"] = (pp.predict_proba(clouds),
                        np.asarray(jax.nn.softmax(want, -1)),
                        pp.with_normals)
    batch = {"xyz": _twice(rng, STEP_B, CLS_N),
             "label": np.array([3, 17, 5, 29])}
    correct, total = make_cls_eval_step(model, device="cpu")(batch)
    want_pred = np.asarray(fwd(start, jnp.asarray(batch["xyz"]))).argmax(-1)
    out["cls_eval_step"] = (int(correct), int(total),
                            int((want_pred == batch["label"]).sum()))
    out["cls_tie_grads"] = _input_grads(
        get_cls_model("pointnet", dropout=0.0), start, batch["xyz"])
    step = make_cls_train_step(model, sgd_momentum(model.parameters(), LR),
                               device="cpu")
    out["cls_port"], out["cls_ref"] = _two_steps(
        step, jax_cls_step(jm), _state(jm.apply, start), model, batch)

    # part segmentation: 3 clouds of 1000 points served at batch 2 (the
    # 1024 bucket)
    clouds, labels = _clouds(rng, 3, 1000), np.array([1, 4, 7])
    onehot = np.eye(16, dtype=np.float32)[labels]
    model = get_seg_model("pointnet")
    start = random_jax_variables(model, seed=1)
    from_jax_variables(model, start)
    jm = JaxPointNetPartSeg()
    out["seg_start"] = _flat(start)
    [xyz] = _pad_points([clouds[:2]], 1000)
    out["seg_shapes"] = (_shapes(jm, jnp.asarray(xyz),
                                 jnp.asarray(onehot[:2])),
                         jax_variable_shapes(model))
    served = _pad_points([clouds], 1000) + [onehot]
    model.eval()
    with torch.no_grad():
        got = _served(served, lambda x, o: model(torch.from_numpy(x),
                                                 torch.from_numpy(o)))
    fwd = _eval(jm)
    want = _served(served, lambda x, o: fwd(start, jnp.asarray(x),
                                            jnp.asarray(o)))
    out["seg_logits"] = (got, want)
    sp = SegPredictor.from_variables("pointnet", start, batch_size=2,
                                     device="cpu")
    out["seg_predictor"] = (sp.predict(clouds, labels),
                            sp.predict_proba(clouds, labels),
                            np.asarray(jax.nn.softmax(want[:, :1000], -1)),
                            sp.with_xyz_feats)
    # four synthetic part-segmentation clouds of four categories
    xyz, labels, seg = SyntheticShapeNetPart(
        n_points=SEG_N, size=STEP_B, seed=3).batch(0, STEP_B)
    onehot = np.eye(16, dtype=np.float32)[labels]
    batch = {"xyz": xyz, "cls_onehot": onehot, "seg": seg.astype(np.int32)}
    out["seg_eval_step"] = (
        make_seg_eval_step(model, device="cpu")(batch).numpy(),
        np.asarray(fwd(start, jnp.asarray(batch["xyz"]),
                       jnp.asarray(onehot))).argmax(-1))
    step = make_seg_train_step(model, sgd_momentum(model.parameters(), LR),
                               device="cpu")
    jstep = jax_seg_step(jm)
    out["seg_port"], out["seg_ref"] = _two_steps(
        step, jstep, _state(jm.apply, start), model, batch)

    # the same on four random clouds, and the JAX model's own spread
    # there: its steps on the same clouds with the points of each
    # permuted (the same arithmetic, its BatchNorm sums in another order)
    batch = {"xyz": _clouds(rng, STEP_B, SEG_N),
             "cls_onehot": np.eye(16, dtype=np.float32)[
                 rng.integers(0, 16, STEP_B)],
             "seg": rng.integers(0, 50, (STEP_B, SEG_N)).astype(np.int32)}
    perm = rng.permutation(SEG_N)
    model = get_seg_model("pointnet")
    from_jax_variables(model, start)
    step = make_seg_train_step(model, sgd_momentum(model.parameters(), LR),
                               device="cpu")
    out["rand_port"], out["rand_ref"] = _two_steps(
        step, jstep, _state(jm.apply, start), model, batch)
    out["rand_perm"] = _jax_steps(jstep, _state(jm.apply, start), dict(
        batch, xyz=batch["xyz"][:, perm], seg=batch["seg"][:, perm]))
    return out


def test_bridge_layout_is_the_jax_tree(runs):
    """The bridge's layout is the flax tree of both JAX models:
    classification ``PointMLP_0/DenseBNAct_{0..4}``, ``DenseBNAct_0``,
    ``Dense_0``; part segmentation ``STN_{0,1}``, ``PointMLP_{0..4}``,
    ``DenseBNAct_0`` (conv5), ``Dense_0``."""
    jax_tree, bridge = runs["cls_shapes"]
    assert jax_tree == bridge
    assert sorted(bridge["params"]) == ["DenseBNAct_0", "Dense_0",
                                        "PointMLP_0"]
    assert sorted(bridge["params"]["PointMLP_0"]) == [
        f"DenseBNAct_{i}" for i in range(5)]
    assert bridge["params"]["Dense_0"] == {"kernel": (512, 40),
                                           "bias": (40,)}
    jax_tree, bridge = runs["seg_shapes"]
    assert jax_tree == bridge
    assert sorted(bridge["params"]) == [
        "DenseBNAct_0", "Dense_0"] + [f"PointMLP_{i}" for i in range(5)] + [
        "STN_0", "STN_1"]
    assert bridge["params"]["STN_1"]["Dense_0"] == {"kernel": (256, 128 * 128),
                                                    "bias": (128 * 128,)}
    assert bridge["params"]["PointMLP_4"]["DenseBNAct_0"]["Dense_0"] == {
        "kernel": (4944, 256)}


@pytest.mark.parametrize("model", [PointNet, PointNetPartSeg])
def test_bridge_round_trip(model):
    m = model()
    variables = random_jax_variables(m, seed=4)
    back = to_jax_variables(from_jax_variables(m, variables))
    flat_a, flat_b = _flat(variables), _flat(back)
    assert flat_a.keys() == flat_b.keys()
    for key, a in flat_a.items():
        np.testing.assert_array_equal(flat_b[key], a)


def test_logits_match_jax(runs):
    """Eval logits of both models on the served batches, f32 on both
    sides, sums in other orders. Measured: 4.2e-7 (classification) and
    1.9e-6 (part segmentation) of max|logit|."""
    for key in ("cls_logits", "seg_logits"):
        got, want = runs[key]
        assert np.abs(want).max() > 0.05  # the logits carry signal
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=key)


def test_predictors_and_eval_steps_match_jax(runs):
    """The Predictor (xyz only) and the SegPredictor against the softmax
    of the JAX logits on the same served batches; the eval steps' counts
    and part ids are the JAX model's."""
    got, want, with_normals = runs["cls_probs"]
    assert got.shape == (3, 40) and not with_normals
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    ids, probs, want, with_xyz = runs["seg_predictor"]
    assert ids.shape == (3, 1000) and probs.shape == want.shape
    assert not with_xyz
    np.testing.assert_array_equal(ids, probs.argmax(-1))
    np.testing.assert_allclose(probs, want, rtol=1e-5, atol=1e-6)
    correct, total, want_correct = runs["cls_eval_step"]
    assert (correct, total) == (want_correct, 4)
    pred, want_pred = runs["seg_eval_step"]
    np.testing.assert_array_equal(pred, want_pred)


def test_tied_maxima_split_the_gradient(runs):
    """On clouds whose every point appears twice, each global max is a
    tie: ``amax`` gives the two copies of a point equal gradients with
    respect to xyz, as ``jnp.max`` splits them (a winner-take-all max
    would give one copy the max's share and the other none). The train
    steps below run on these clouds against the JAX model."""
    got = runs["cls_tie_grads"]
    half = got.shape[1] // 2
    assert np.abs(got).max() > 0
    np.testing.assert_array_equal(got[:, :half], got[:, half:])


# Bounds per step: (loss relative; each running statistic and parameter
# × its largest element; least cosine of an update beyond rounding).
# Sums in other orders, scaled up by the BatchNorms after a global max
# (above) and growing with the step; the CPU's thread count moves them.
# Measured (2 and 8 threads): step 1 loss 9.5e-7, elements 4.1e-5,
# cosine 0.99994; step 2 loss 1.7e-4, elements 2.3e-3, cosine 0.9948
# (part segmentation's STNs; classification 2.8e-6, 8.2e-5, 0.99993).
_STEP_TOL = {1: (1e-5, 2e-4, 0.9995), 2: (1e-3, 1e-2, 0.98)}


@pytest.mark.parametrize("n_steps", [1, 2])
@pytest.mark.parametrize("tag", ["cls", "seg"])
def test_train_steps_match_jax(runs, tag, n_steps):
    """Loss, accuracy, every BN running statistic and every parameter
    after one and two SGD steps (momentum 0.9, lr 1e-4) within
    ``_STEP_TOL``, and every update that JAX makes beyond rounding
    pointing the same way in the port; classification on the clouds of
    tied maxima. ``pytest -s`` shows the worst."""
    start = runs[f"{tag}_start"]
    got, gmet = runs[f"{tag}_port"][n_steps - 1]
    want, wmet = runs[f"{tag}_ref"][n_steps - 1]
    loss_tol, elem_tol, min_cos = _STEP_TOL[n_steps]
    assert np.isfinite(gmet["loss"])
    assert abs(gmet["loss"] - wmet["loss"]) <= loss_tol * abs(wmet["loss"])
    # classification accuracies are multiples of 1/B; a part-segmentation
    # one may move by a point or two of its B·N predictions at a near tie
    assert gmet["acc"] == pytest.approx(wmet["acc"], abs=1e-3)
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


def _spread(start, got, want):
    """``(worst, update, median)`` of ``got`` against ``want``, both after
    the same steps from ``start``: the largest difference of an element
    × its array's largest, the difference of the whole parameter update
    × the update's norm, and the median cosine of the arrays' updates."""
    worst, cos, du, dw = 0.0, [], [], []
    for k in want:
        worst = max(worst, np.abs(got[k] - want[k]).max()
                    / max(np.abs(want[k]).max(), 1e-6))
        u, w = (got[k] - start[k]).ravel(), (want[k] - start[k]).ravel()
        if k.startswith("['params']"):
            du.append(u)
            dw.append(w)
        if np.linalg.norm(w) > 1e-4 * max(np.linalg.norm(start[k]), 1.0):
            cos.append(u @ w / (np.linalg.norm(u) * np.linalg.norm(w)))
    du, dw = np.concatenate(du), np.concatenate(dw)
    return (worst, np.linalg.norm(du - dw) / np.linalg.norm(dw),
            float(np.median(cos)))


# On random clouds the part-segmentation train step is ill-conditioned
# in f32: the BatchNorms after a global max (the STNs' PointMLP 512 /
# 256) see one row a cloud, whose rows nearly agree on clouds drawn
# alike. The JAX model against itself on the same clouds with the points
# permuted moves as far as the port does. Measured (``_spread``, port
# against JAX / JAX permuted against JAX): after step 1 worst element
# 8.8e-4 / 1.3e-3, whole update 0.23 / 0.24, median cosine 1 - 2e-9 /
# 1 - 2e-9; after step 2 5.3e-2 / 6.0e-2, 0.43 / 0.37, 1 - 3.6e-6 /
# 1 - 3.8e-6. The port may come no further from JAX than 4× as far as
# JAX comes from itself.
_OWN_SPREAD, _MEDIAN_COS = 4.0, 0.9995


@pytest.mark.parametrize("n_steps", [1, 2])
def test_random_cloud_train_steps_within_jax_own_spread(runs, n_steps):
    """Part segmentation's train steps on random clouds: the loss of the
    first step (one forward from the same weights) within 1e-5; the worst
    element and the whole update within ``_OWN_SPREAD`` times the JAX
    model's own spread under a permutation of the points; the median
    update cosine at least ``_MEDIAN_COS``. ``pytest -s`` shows them."""
    start = runs["seg_start"]
    got, gmet = runs["rand_port"][n_steps - 1]
    want, wmet = runs["rand_ref"][n_steps - 1]
    port = _spread(start, got, want)
    own = _spread(start, runs["rand_perm"][n_steps - 1][0], want)
    print(f"after {n_steps}: port {port}, JAX permuted {own}")
    assert np.isfinite(gmet["loss"])
    if n_steps == 1:
        assert abs(gmet["loss"] - wmet["loss"]) <= 1e-5 * abs(wmet["loss"])
    assert port[0] <= _OWN_SPREAD * own[0]
    assert port[1] <= _OWN_SPREAD * own[1]
    assert port[2] >= _MEDIAN_COS and own[2] >= _MEDIAN_COS


@pytest.mark.parametrize("name", ["pointnet_partseg", "pointcnn", "dgcnn"])
def test_structurally_cancelled_gradients_are_zero(name):
    """``grad_check.cancelled_by_structure``, the parameters that
    ``chip_smoke.py``'s train phases let a step leave unchanged, names
    only gradients that are 0 but for rounding (at most 1e-4 of the
    largest; measured 1e-12 PointNet part segmentation, 4e-6 PointCNN, 5e-8
    DGCNN): PointNet part segmentation's ``conv5`` BN bias, and not
    DGCNN's, whose LeakyReLU follows its BatchNorm; of a PointCNN
    ``DenseBlock`` the Dense bias only where BatchNorm directly follows,
    not ``x1``'s (activation first), ``x3``'s or the head's (no
    BatchNorm), whose gradients are at least 1e-3 of the largest
    (measured 4.2e-2)."""
    from pointcloudlib_tpu_torch.tools.grad_check import (
        build_model,
        cancelled_by_structure,
        model_grads,
        synthetic_batch,
    )

    model = build_model(name)
    from_jax_variables(model, random_jax_variables(model, seed=0))
    _, grads, _, _ = model_grads(model, name,
                                 synthetic_batch(name, 2, 5, 256))
    cancelled = cancelled_by_structure(model)
    largest = max(g.abs().max().item() for g in grads.values())
    assert cancelled and cancelled <= grads.keys()
    for k in cancelled:
        assert grads[k].abs().max().item() <= 1e-4 * largest, k
    assert ("conv5.bn.bias" in cancelled) == (name == "pointnet_partseg")
    if name == "pointcnn":
        kept = [k for k in grads if k.endswith("dense.bias")
                and k not in cancelled]
        assert {k.split(".")[-3] for k in kept} == {"x1", "x3", "out"}, kept
        for k in kept:
            assert grads[k].abs().max().item() >= 1e-3 * largest, k


def test_entry_points_need_a_card_or_the_cpu():
    """Without a card the predictors and the steps raise unless the
    caller passes ``device="cpu"``; PointNet is in both registries and
    reads xyz alone; every Dense takes f32 operands on every device
    (``models/pointnet.py``)."""
    cls, seg = PointNet(), PointNetPartSeg()
    if not torch.cuda.is_available():
        for make in (lambda: Predictor(cls),
                     lambda: SegPredictor(seg),
                     lambda: make_cls_train_step(
                         cls, sgd_momentum(cls.parameters(), LR)),
                     lambda: make_seg_train_step(
                         seg, sgd_momentum(seg.parameters(), LR))):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    p = Predictor.from_variables("pointnet", random_jax_variables(cls),
                                 batch_size=1, device="cpu")
    assert not p.with_normals
    assert isinstance(get_seg_model("pointnet"), PointNetPartSeg)
    for model in (cls, seg):
        blocks = [m for m in model.modules() if isinstance(m, DenseBNAct)]
        assert blocks and {m.dtype for m in blocks} == {torch.float32}
        assert {p.dtype for p in model.parameters()} == {torch.float32}
