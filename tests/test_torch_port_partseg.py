"""PointNet++ part segmentation in the PyTorch port against the JAX
model, on the CPU: eval logits, the SegPredictor, the weight bridge, two
train steps, the IoU metric and the synthetic set.

The JAX model runs its fused set abstraction in Pallas interpret mode
(``POINTCLOUDLIB_FUSED_SA=1``), so both sides have the fused parameter
layout; its decoders take the XLA route of ``three_nn_interpolate`` off
the TPU. Weights come from ``random_jax_variables`` and reach the port
through ``from_jax_variables``. Full widths, B=8 clouds of N=128 points
with xyz as features (``train_partseg.py:78-79``), lr 1e-4
(``tests/test_torch_port_train_step.py`` says why B=8 and a small
learning rate; at B=4 a FP1 BatchNorm mean drifts 1.2 % from JAX's in
the second step, at B=8 0.8 %). At N=128 SA1's FPS
asks for 512 of 128 points, so its centers repeat and FP1's 3-NN
selection meets exact d² ties among them.

The JAX ``PointNet2PartSeg`` fixes its head's dropout at 0.5, whose mask
the port cannot reproduce, so the train-step comparison uses
``_PartSegNoDropout``: the same calls in the same order without the
dropout. flax names submodules by class and order, so its variable tree
equals ``PointNet2PartSeg``'s, which a test asserts.
"""

from typing import Optional

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from pointcloudlib_tpu.data.synthetic import (
    SyntheticShapeNetPart as JaxShapeNetPart,
)
from pointcloudlib_tpu.inference import SegPredictor as JaxSegPredictor
from pointcloudlib_tpu.models import get_seg_model as jax_seg_model
from pointcloudlib_tpu.nn.layers import (
    DenseBNAct as JaxDenseBNAct,
)
from pointcloudlib_tpu.nn.layers import (
    FeaturePropagation as JaxFeaturePropagation,
)
from pointcloudlib_tpu.nn.layers import (
    SetAbstraction as JaxSetAbstraction,
)
from pointcloudlib_tpu.nn.layers import reference_linear_init
from pointcloudlib_tpu.train.metrics import shape_ious as jax_shape_ious
from pointcloudlib_tpu.train.state import TrainState
from pointcloudlib_tpu.train.state import sgd_momentum as jax_sgd
from pointcloudlib_tpu.train.trainer import (
    make_seg_train_step as jax_seg_step,
)

from pointcloudlib_tpu_torch.data.synthetic import SyntheticShapeNetPart
from pointcloudlib_tpu_torch.inference import SegPredictor
from pointcloudlib_tpu_torch.models import get_seg_model
from pointcloudlib_tpu_torch.train import (
    make_seg_eval_step,
    make_seg_train_step,
    sgd_momentum,
    shape_ious,
)
from pointcloudlib_tpu_torch.utils.interop import (
    from_jax_variables,
    jax_variable_shapes,
    random_jax_variables,
    to_jax_variables,
)

B, N, LR = 8, 128, 1e-4


class _PartSegNoDropout(nn.Module):
    """``PointNet2PartSeg`` (``models/pointnet2.py:77``) without the
    head's dropout."""

    part_num: int = 50

    @nn.compact
    def __call__(self, xyz, cls_label, feats: Optional[jax.Array] = None,
                 training: bool = False):
        b, n, _ = xyz.shape
        l1_xyz, l1_f = JaxSetAbstraction(
            mlp=[64, 64, 128], n_points=512, radius=0.2, n_samples=64,
        )(xyz, feats, training)
        l2_xyz, l2_f = JaxSetAbstraction(
            mlp=[128, 128, 256], n_points=128, radius=0.4, n_samples=64,
        )(l1_xyz, l1_f, training)
        l3_xyz, l3_f = JaxSetAbstraction(mlp=[256, 512, 1024])(
            l2_xyz, l2_f, training)
        l2_f = JaxFeaturePropagation([256, 256])(l2_xyz, l3_xyz, l2_f, l3_f,
                                                 training)
        l1_f = JaxFeaturePropagation([256, 128])(l1_xyz, l2_xyz, l1_f, l2_f,
                                                 training)
        one_hot = jnp.broadcast_to(cls_label[:, None, :].astype(xyz.dtype),
                                   (b, n, cls_label.shape[-1]))
        skip = jnp.concatenate([one_hot, xyz, feats], axis=-1)
        f = JaxFeaturePropagation([128, 128, 128])(xyz, l1_xyz, skip, l1_f,
                                                   training)
        f = JaxDenseBNAct(128, act=None, use_bias=True)(f, training)
        return nn.Dense(self.part_num, kernel_init=reference_linear_init)(f)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    x *= rng.uniform(0.5, 1.0, (B, N, 1)).astype(np.float32)
    labels = (np.arange(B) * 5 % 16).astype(np.int32)
    return {"xyz": x, "feats": x,
            "cls_onehot": np.eye(16, dtype=np.float32)[labels],
            "seg": rng.integers(0, 50, (B, N)).astype(np.int32),
            "labels": labels}


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _shapes(module, batch):
    """The variable tree of ``module`` as shapes, without running it."""
    tree = jax.eval_shape(
        lambda: module.init(jax.random.key(0),
                            jnp.asarray(batch["xyz"][:2]),
                            jnp.asarray(batch["cls_onehot"][:2]),
                            feats=jnp.asarray(batch["feats"][:2])))
    return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)


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
    """Everything that needs the JAX part-segmentation model, computed
    once: the variable trees' shapes, eval logits and SegPredictor ids on
    both sides, and two train steps on both sides."""
    mp = pytest.MonkeyPatch()
    mp.setenv("POINTCLOUDLIB_FUSED_SA", "1")
    try:
        batch = _batch()
        xyz, onehot = batch["xyz"], batch["cls_onehot"]
        model = get_seg_model("pointnet2", dropout=0.0)
        start = random_jax_variables(model, seed=0)
        from_jax_variables(model, start)
        jm, jm0 = jax_seg_model("pointnet2"), _PartSegNoDropout()
        out = {"start": _flat(start),
               "shapes": (_shapes(jm, batch), _shapes(jm0, batch),
                          jax_variable_shapes(model))}

        # eval logits and the eval step on 2 clouds
        with torch.no_grad():
            got = model.eval()(torch.from_numpy(xyz[:2]),
                               torch.from_numpy(onehot[:2]),
                               torch.from_numpy(xyz[:2])).numpy()
        want = np.asarray(jm.apply(start, jnp.asarray(xyz[:2]),
                                   jnp.asarray(onehot[:2]),
                                   feats=jnp.asarray(xyz[:2]),
                                   training=False))
        pred = make_seg_eval_step(model, device="cpu")(
            {k: v[:2] for k, v in batch.items()}).numpy()
        out["logits"] = (got, want, pred)

        # SegPredictor: 3 clouds of N=100 at batch 2
        clouds, labels = xyz[:3, :100], batch["labels"][:3]
        sp = SegPredictor.from_variables("pointnet2", start, batch_size=2,
                                         device="cpu")
        jp = JaxSegPredictor(jm, start, with_xyz_feats=True, batch_size=2)
        out["seg_predictor"] = (sp.predict(clouds, labels),
                                sp.predict_proba(clouds, labels),
                                jp.predict(clouds, labels))

        # two train steps
        step = make_seg_train_step(
            model, sgd_momentum(model.parameters(), LR), device="cpu")
        state = TrainState.create(
            apply_fn=jm0.apply,
            params=jax.tree_util.tree_map(jnp.asarray, start["params"]),
            batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                               start["batch_stats"]),
            tx=jax_sgd(LR))
        jstep = jax_seg_step(jm0)
        train = {k: v for k, v in batch.items() if k != "labels"}
        jbatch = {k: jnp.asarray(v) for k, v in train.items()}
        port, ref = [], []
        for _ in range(2):
            state, jmet = jstep(state, jbatch, jax.random.key(0))
            ref.append((_flat({"params": state.params,
                               "batch_stats": state.batch_stats}),
                        {k: float(v) for k, v in jmet.items()}))
            met = step(train)
            port.append((_flat(to_jax_variables(model)),
                         {k: float(v) for k, v in met.items()}))
        out["port"], out["ref"] = port, ref
        return out
    finally:
        mp.undo()


def test_bridge_layout_is_the_jax_tree(runs):
    """``SetAbstraction_{0,1,2}``, ``FeaturePropagation_{0,1,2}``, a
    top-level ``DenseBNAct_0`` with a Dense bias and ``Dense_0``: the
    bridge's layout, the JAX model's tree and the dropout-free stand-in's
    tree are the same."""
    jax_tree, stand_in, bridge = runs["shapes"]
    assert jax_tree == stand_in
    assert jax_tree == bridge
    assert sorted(bridge["params"]) == [
        "DenseBNAct_0", "Dense_0", "FeaturePropagation_0",
        "FeaturePropagation_1", "FeaturePropagation_2", "SetAbstraction_0",
        "SetAbstraction_1", "SetAbstraction_2"]
    assert bridge["params"]["DenseBNAct_0"]["Dense_0"] == {
        "kernel": (128, 128), "bias": (128,)}
    assert bridge["params"]["FeaturePropagation_2"]["PointMLP_0"][
        "DenseBNAct_0"]["Dense_0"]["kernel"] == (16 + 3 + 3 + 128, 128)


def test_logits_match_jax(runs):
    got, want, pred = runs["logits"]
    assert got.shape == (2, N, 50)
    assert np.abs(want).max() > 0.1  # logits carry signal, not just bias
    # f32 on both sides with bf16 roundings at the same places (q, off,
    # the fused chain); summation orders differ
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(pred, got.argmax(-1))


def test_seg_predictor_matches_jax(runs):
    """3 clouds of N=100 at batch 2: point padding to the 128 bucket and
    a half-empty last batch on both sides; the part ids agree wherever
    the top two probabilities are more than 1e-3 apart."""
    ids, probs, want = runs["seg_predictor"]
    assert ids.shape == want.shape == (3, 100)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(ids, probs.argmax(-1))
    top2 = np.sort(probs, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-3
    np.testing.assert_array_equal(ids[clear], want[clear])
    # random weights spread the probability over 50 parts: many points
    # have no clear winner, and they still agree but for near-ties
    assert (ids == want).mean() >= 0.99


def test_bridge_round_trip():
    model = get_seg_model("pointnet2")
    variables = random_jax_variables(model, seed=4)
    back = to_jax_variables(from_jax_variables(model, variables))
    flat_a, flat_b = _flat(variables), _flat(back)
    # 2 fused layers of 15 leaves, 11 DenseBNAct of 5, the head's Dense
    # bias and Dense_0's kernel and bias
    assert flat_a.keys() == flat_b.keys() and len(flat_a) == 88
    for key, a in flat_a.items():
        np.testing.assert_array_equal(flat_b[key], a)


@pytest.mark.parametrize("n_steps", [1, 2])
def test_loss_and_accuracy(runs, n_steps):
    got, want = runs["port"][n_steps - 1][1], runs["ref"][n_steps - 1][1]
    assert np.isfinite(got["loss"])
    # bf16 roundings inside the fused SA layers on both sides, f32 sums
    # in other orders
    assert got["loss"] == pytest.approx(want["loss"], rel=2e-3)
    # random weights spread the probability over 50 parts, so near-ties
    # flip a few argmaxes: 1 % of the 1,024 points
    assert got["acc"] == pytest.approx(want["acc"], abs=1e-2)


@pytest.mark.parametrize("n_steps", [1, 2])
def test_bn_running_stats(runs, n_steps):
    """Every running mean and variance, the two fused layers' and the
    ``DenseBNAct`` ones (biased variance, momentum 0.9), within 1 % of
    the largest element of each."""
    got, want = runs["port"][n_steps - 1][0], runs["ref"][n_steps - 1][0]
    stats = [k for k in want if k.startswith("['batch_stats']")]
    assert len(stats) == 2 * 6 + (3 + 2 + 2 + 3 + 1) * 2
    for k in stats:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-2 * np.abs(want[k]).max(),
                                   err_msg=k)


# Gradients that are exactly 0: a train-mode BatchNorm removes a constant
# shift. The head's Dense bias feeds its own BatchNorm; SA3's last BN bias
# only shifts the pooled features that FP3's first Dense and BatchNorm
# take (ReLU clips none of them here).
_CANCELLED = (
    "['params']['DenseBNAct_0']['Dense_0']['bias']",
    "['params']['SetAbstraction_2']['PointMLP_0']['DenseBNAct_2']"
    "['BatchNorm_0']['bias']",
)

# Least update cosine and largest norm deviation per layer after one
# step; after two steps (0.85, 0.15) for all, as in the SSG step test.
# Readings on the CPU, least cosine / largest norm deviation after one
# step (two steps): head (DenseBNAct_0, Dense_0) 0.998 / 0.014 (0.999 /
# 0.007); FP3, FP2, FP1 (FeaturePropagation_0, _1, _2) 0.974, 0.982,
# 0.982 / 0.028 (0.979 / 0.029); SA3 0.958 / 0.024 (0.969 / 0.007); SA2
# 0.975 / 0.021 (0.967 / 0.023); SA1 0.962 / 0.114 (0.965 / 0.075). The
# lowest cosines are BN scales whose one-step update is 1e-7 to 1e-6 of
# their norm, a few float32 steps an element.
_ONE_STEP = (("Dense_0", 0.97, 0.10), ("DenseBNAct_0", 0.97, 0.10),
             ("FeaturePropagation_2", 0.95, 0.10),
             ("FeaturePropagation_1", 0.95, 0.10),
             ("FeaturePropagation_0", 0.95, 0.10),
             ("SetAbstraction_2", 0.93, 0.10),
             ("SetAbstraction_1", 0.95, 0.10),
             ("SetAbstraction_0", 0.93, 0.15))


def _negligible(update, start):
    """An update below the float32 resolution of the parameter it moves:
    rounding noise."""
    return np.linalg.norm(update) <= 1e-6 * np.linalg.norm(start)


@pytest.mark.parametrize("n_steps", [1, 2])
def test_params(runs, n_steps):
    """Every parameter within 5e-3 of its largest element, and each
    update (params after the step minus the start) pointing the same way
    as JAX's with a like norm, within the bounds of ``_ONE_STEP`` or,
    after two steps, (0.85, 0.15). The ``_CANCELLED`` parameters must
    not move beyond rounding noise on either side. ``pytest -s`` shows
    each layer's readings."""
    start = runs["start"]
    got, want = runs["port"][n_steps - 1][0], runs["ref"][n_steps - 1][0]
    params = [k for k in want if k.startswith("['params']")]
    assert len(params) == 2 * 9 + (3 + 2 + 2 + 3) * 3 + 4 + 2
    readings = {layer: [] for layer, _, _ in _ONE_STEP}
    for k in params:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=5e-3 * np.abs(want[k]).max(),
                                   err_msg=k)
        du, dw = (got[k] - start[k]).ravel(), (want[k] - start[k]).ravel()
        if k in _CANCELLED:
            assert _negligible(du, start[k]) and _negligible(dw, start[k]), k
            continue
        layer, min_cos, norm_tol = next(b for b in _ONE_STEP
                                        if k.startswith(f"['params']"
                                                        f"['{b[0]}']"))
        if n_steps == 2:
            min_cos, norm_tol = 0.85, 0.15
        cos = du @ dw / (np.linalg.norm(du) * np.linalg.norm(dw))
        ratio = np.linalg.norm(du) / np.linalg.norm(dw)
        readings[layer].append((cos, abs(ratio - 1)))
        assert cos >= min_cos, (k, cos)
        assert abs(ratio - 1) <= norm_tol, (k, ratio)
    for layer, r in readings.items():
        print(f"{layer} after {n_steps}: {len(r)} updates, least cosine "
              f"{min(c for c, _ in r):.4f}, largest norm deviation "
              f"{max(d for _, d in r):.4f}")


def test_updates_moved_every_trained_parameter(runs):
    """The port's first step moved every parameter but those whose
    gradient is exactly 0 (``_CANCELLED``)."""
    start, first = runs["start"], runs["port"][0][0]
    still = [k for k, v in first.items()
             if k.startswith("['params']") and np.array_equal(v, start[k])]
    assert set(still) <= set(_CANCELLED), still


def test_shape_ious_match_jax():
    rng = np.random.default_rng(2)
    labels = np.arange(16)
    seg = rng.integers(0, 50, (16, 64))
    pred = np.where(rng.random((16, 64)) < 0.7, seg,
                    rng.integers(0, 50, (16, 64)))
    pred[3] = 99  # no part of the category predicted: IoU 0 or 1
    np.testing.assert_array_equal(shape_ious(pred, seg, labels),
                                  jax_shape_ious(pred, seg, labels))


@pytest.mark.parametrize("train", [True, False])
def test_synthetic_shapenet_part_matches_jax(train):
    got = SyntheticShapeNetPart(n_points=200, size=18, train=train, seed=3)
    want = JaxShapeNetPart(n_points=200, size=18, train=train, seed=3)
    for i in (0, 5, 17):
        (p, l, s), (jp, jl, js) = got[i], want[i]
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(s, js)
        assert l == jl
    pts, labels, seg = got.batch(0, 4)
    assert pts.shape == (4, 200, 3) and seg.shape == (4, 200)
    assert list(labels) == [0, 1, 2, 3]


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    """Without a card the seg steps and the SegPredictor raise unless the
    caller passes ``device="cpu"``. On the CPU a request of 4,096 points
    is Hilbert-sorted and its probabilities come back in the caller's
    point order: a permuted request gives the permuted probabilities,
    with a stand-in model whose output depends on the point order (a
    running mean), so that a missing sort or un-sort shows."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = get_seg_model("pointnet2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_seg_train_step(model, sgd_momentum(model.parameters(), LR))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_seg_eval_step(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SegPredictor(model)
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((6, 50)).astype(np.float32))

    class OrderDependent(torch.nn.Module):
        def forward(self, xyz, onehot, feats):
            steps = torch.arange(1, xyz.shape[1] + 1)[:, None]
            return torch.cat([feats, xyz.cumsum(1) / steps], -1) @ w

    x = rng.standard_normal((1, 4096, 3)).astype(np.float32)
    perm = rng.permutation(4096)
    pred = SegPredictor(OrderDependent(), with_xyz_feats=True, device="cpu")
    probs = pred.predict_proba(x, np.zeros(1, np.int64))
    assert probs.shape == (1, 4096, 50)
    np.testing.assert_array_equal(
        pred.predict_proba(x[:, perm], np.zeros(1, np.int64)),
        probs[:, perm])
