"""DGCNN part segmentation in the PyTorch port against the JAX model, on
the CPU: the weight bridge, eval logits, the SegPredictor and two train
steps.

The JAX model runs its fused EdgeConvs in Pallas interpret mode
(``POINTCLOUDLIB_FUSED_SA=1``, set inside the fixture): without it
``DGCNNPartSeg`` takes its unfused path, with another parameter tree
(``models/dgcnn.py:288-305``). Weights come from
``random_jax_variables`` and reach the port through
``from_jax_variables``. Full widths, k=8 (the model's k=40 runs on the
card, ``chip_smoke.py``; ``tests/test_torch_port_dgcnn_seg_ops.py``
holds the kernels' plain versions at k=40), B=4 clouds of N=128 points
(the graph built inside the kernels), lr 1e-4.

The JAX ``DGCNNPartSeg`` fixes both decoder dropouts at 0.5, whose masks
the port cannot reproduce, so the train steps compare against
``_DGCNNPartSegNoDropout``: the same calls in the same order without the
dropouts. flax names submodules by class and order, so its variable tree
equals ``DGCNNPartSeg``'s, which a test asserts; the port runs
``DGCNNPartSeg(dropout=0.0)``.
"""

from typing import Optional

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from pointcloudlib_tpu.inference import SegPredictor as JaxSegPredictor
from pointcloudlib_tpu.models.dgcnn import DGCNNPartSeg as JaxDGCNNPartSeg
from pointcloudlib_tpu.models.dgcnn import (
    Fused2EdgeConv as JaxFused2EdgeConv,
)
from pointcloudlib_tpu.models.dgcnn import FusedEdgeConv as JaxFusedEdgeConv
from pointcloudlib_tpu.nn.layers import DenseBNAct as JaxDenseBNAct
from pointcloudlib_tpu.nn.layers import reference_linear_init
from pointcloudlib_tpu.train.state import TrainState
from pointcloudlib_tpu.train.state import sgd_momentum as jax_sgd
from pointcloudlib_tpu.train.trainer import (
    make_seg_train_step as jax_seg_step,
)

from pointcloudlib_tpu_torch.inference import SegPredictor
from pointcloudlib_tpu_torch.models import get_seg_model
from pointcloudlib_tpu_torch.models.dgcnn import DGCNNPartSeg
from pointcloudlib_tpu_torch.train import (
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

B, N, K, LR = 4, 128, 8, 1e-4


def _lrelu(x):
    return nn.leaky_relu(x, negative_slope=0.2)


class _DGCNNPartSegNoDropout(nn.Module):
    """``DGCNNPartSeg`` (``models/dgcnn.py:260``) on its fused path without
    the decoder's dropouts."""

    part_num: int = 50
    k: int = K

    @nn.compact
    def __call__(self, xyz, cls_label, feats: Optional[jax.Array] = None,
                 training: bool = False):
        del feats
        b, n, _ = xyz.shape
        x1 = JaxFused2EdgeConv((64, 64), self.k)(xyz, training)
        x2 = JaxFused2EdgeConv((64, 64), self.k)(x1, training)
        x3 = JaxFusedEdgeConv(64, self.k)(x2, training)
        x = jnp.concatenate([x1, x2, x3], axis=-1)
        x = JaxDenseBNAct(1024, act=_lrelu)(x, training)
        g = jnp.max(x, axis=1)
        lab = JaxDenseBNAct(64, act=_lrelu)(cls_label.astype(xyz.dtype),
                                            training)
        g = jnp.concatenate([g, lab], axis=-1)
        g = jnp.broadcast_to(g[:, None, :], (b, n, g.shape[-1]))
        h = jnp.concatenate([g, x1, x2, x3], axis=-1)
        h = JaxDenseBNAct(256, act=_lrelu)(h, training)
        h = JaxDenseBNAct(256, act=_lrelu)(h, training)
        h = JaxDenseBNAct(128, act=_lrelu)(h, training)
        return nn.Dense(self.part_num, use_bias=False,
                        kernel_init=reference_linear_init)(h)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    x *= rng.uniform(0.5, 1.0, (B, N, 1)).astype(np.float32)
    labels = (np.arange(B) * 5 % 16).astype(np.int32)
    return {"xyz": x, "cls_onehot": np.eye(16, dtype=np.float32)[labels],
            "seg": rng.integers(0, 50, (B, N)).astype(np.int32),
            "labels": labels}


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _shapes(module, batch):
    tree = jax.eval_shape(
        lambda: module.init(jax.random.key(0), jnp.asarray(batch["xyz"][:2]),
                            jnp.asarray(batch["cls_onehot"][:2])))
    return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)


@pytest.fixture(scope="module")
def runs():
    """Everything that needs the JAX model, computed once: the variable
    trees' shapes, eval logits and SegPredictor results on both sides,
    and two train steps on both sides."""
    mp = pytest.MonkeyPatch()
    mp.setenv("POINTCLOUDLIB_FUSED_SA", "1")
    try:
        batch = _batch()
        xyz, onehot = batch["xyz"], batch["cls_onehot"]
        model = get_seg_model("dgcnn", k=K, dropout=0.0)
        start = random_jax_variables(model, seed=0)
        from_jax_variables(model, start)
        jm, jm0 = JaxDGCNNPartSeg(k=K), _DGCNNPartSegNoDropout()
        out = {"start": _flat(start),
               "shapes": (_shapes(jm, batch), _shapes(jm0, batch),
                          jax_variable_shapes(model))}

        # eval logits and the eval step on 2 clouds
        with torch.no_grad():
            got = model.eval()(torch.from_numpy(xyz[:2]),
                               torch.from_numpy(onehot[:2])).numpy()
        want = np.asarray(jm.apply(start, jnp.asarray(xyz[:2]),
                                   jnp.asarray(onehot[:2]), training=False))
        pred = make_seg_eval_step(model, device="cpu")(
            {k: v[:2] for k, v in batch.items()}).numpy()
        out["logits"] = (got, want, pred)

        # SegPredictor: 3 clouds of N=100 at batch 2 (padded to the 128
        # bucket: the graph built inside the kernels)
        clouds, labels = xyz[:3, :100], batch["labels"][:3]
        sp = SegPredictor(model, batch_size=2, device="cpu")
        jp = JaxSegPredictor(jm, start, with_xyz_feats=False, batch_size=2)
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
    """``Fused2EdgeConv_{0,1}``, ``FusedEdgeConv_0``, ``DenseBNAct_{0..4}``
    and a bias-free ``Dense_0``: the bridge's layout, the fused JAX
    model's tree and the dropout-free stand-in's tree are the same."""
    jax_tree, stand_in, bridge = runs["shapes"]
    assert jax_tree == stand_in
    assert jax_tree == bridge
    assert sorted(bridge["params"]) == [
        "DenseBNAct_0", "DenseBNAct_1", "DenseBNAct_2", "DenseBNAct_3",
        "DenseBNAct_4", "Dense_0", "Fused2EdgeConv_0", "Fused2EdgeConv_1",
        "FusedEdgeConv_0"]
    assert bridge["params"]["Fused2EdgeConv_1"] == {
        "w": (128, 64), "w2": (64, 64), "bn1_scale": (64,),
        "bn1_bias": (64,), "bn2_scale": (64,), "bn2_bias": (64,)}
    assert sorted(bridge["batch_stats"]["Fused2EdgeConv_0"]) == [
        "mean1", "mean2", "var1", "var2"]
    assert bridge["params"]["Dense_0"] == {"kernel": (128, 50)}
    assert bridge["params"]["DenseBNAct_1"]["Dense_0"] == {"kernel": (16, 64)}
    assert bridge["params"]["DenseBNAct_2"]["Dense_0"] == {
        "kernel": (1280, 256)}


def test_bridge_round_trip():
    model = get_seg_model("dgcnn")
    variables = random_jax_variables(model, seed=4)
    back = to_jax_variables(from_jax_variables(model, variables))
    flat_a, flat_b = _flat(variables), _flat(back)
    # 2 two-layer EdgeConvs of 10 leaves, one EdgeConv of 5, 5 DenseBNAct
    # of 5 and Dense_0's kernel
    assert flat_a.keys() == flat_b.keys() and len(flat_a) == 51
    for key, a in flat_a.items():
        np.testing.assert_array_equal(flat_b[key], a)
    w2 = variables["params"]["Fused2EdgeConv_0"]["w2"]
    # a kernel's init, U(±1/√fan_in) with fan_in = 64
    assert np.abs(w2).max() <= 1 / 8 and np.abs(w2).max() > 0.1


def test_logits_match_jax(runs):
    """f32 on both sides with bf16 roundings at the same places (q, off,
    y1 before W2); the kNN cross term and the dense layers sum in other
    orders: within 1e-3."""
    got, want, pred = runs["logits"]
    assert got.shape == (2, N, 50)
    assert np.abs(want).max() > 0.1  # logits carry signal, not just bias
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(pred, got.argmax(-1))


def test_seg_predictor_matches_jax(runs):
    """3 clouds of N=100 at batch 2: point padding to the 128 bucket
    (every padded point has a twin: exact kNN and max-pool ties) and a
    half-empty last batch on both sides; the part ids equal wherever the
    top two probabilities are more than 1e-3 apart."""
    ids, probs, want = runs["seg_predictor"]
    assert ids.shape == want.shape == (3, 100)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(ids, probs.argmax(-1))
    top2 = np.sort(probs, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-3
    np.testing.assert_array_equal(ids[clear], want[clear])
    assert (ids == want).mean() >= 0.99


# DGCNN rebuilds its graph from the features at every EdgeConv, so an
# update that differs by rounding moves near-tied neighbours and with them
# the next forward (tests/test_torch_port_dgcnn.py). Bounds per step:
# (loss relative, running statistics × their largest element).
_STEP_TOL = {1: (2e-3, 1e-2), 2: (1e-2, 2.5e-2)}


@pytest.mark.parametrize("n_steps", [1, 2])
def test_loss_and_accuracy(runs, n_steps):
    got, want = runs["port"][n_steps - 1][1], runs["ref"][n_steps - 1][1]
    assert np.isfinite(got["loss"])
    rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    print(f"loss after {n_steps}: relative difference {rel:.2e}")
    assert rel <= _STEP_TOL[n_steps][0]
    # random weights spread the probability over 50 parts, so near-ties
    # may flip a few argmaxes: 1 % of the 512 points
    assert got["acc"] == pytest.approx(want["acc"], abs=1e-2)


@pytest.mark.parametrize("n_steps", [1, 2])
def test_bn_running_stats(runs, n_steps):
    """Every running mean and variance: the two pairs' four each, the
    third EdgeConv's and the five ``DenseBNAct`` ones (biased variance,
    momentum 0.9), within ``_STEP_TOL`` of the largest element of
    each."""
    got, want = runs["port"][n_steps - 1][0], runs["ref"][n_steps - 1][0]
    stats = [k for k in want if k.startswith("['batch_stats']")]
    assert len(stats) == 2 * 4 + 2 + 5 * 2
    worst = max((np.abs(got[k] - want[k]).max() / np.abs(want[k]).max(), k)
                for k in stats)
    print(f"running statistics after {n_steps}: worst {worst}")
    assert worst[0] <= _STEP_TOL[n_steps][1], worst


# The BN bias of conv6 (DenseBNAct_0) shifts every point's conv6 output
# by the same amount, so every cloud's global max moves by it where the
# max is positive (LeakyReLU's slope 1), as here; the max reaches the
# decoder's first Dense as a per-cloud constant, whose train-mode
# BatchNorm removes a shift common to all clouds: the gradient is exactly
# 0, and the parameter must not move beyond rounding noise on either side.
_CANCELLED = ("['params']['DenseBNAct_0']['BatchNorm_0']['bias']",)


def _negligible(update, start):
    """An update below the float32 resolution of the parameter it moves:
    rounding noise."""
    return np.linalg.norm(update) <= 1e-6 * max(np.linalg.norm(start), 1.0)


# Least update cosine and largest norm deviation per group, after one
# step and after two (as tests/test_torch_port_dgcnn.py). An update
# below 1e-6 of its parameter's norm (the BN scales of conv6 and of the
# label embedding move by 1.6e-7 and 2.8e-7 of theirs: a few float32
# steps an element) is rounding-sized, and its cosine reads 0.974 to
# 0.99 from one run to the next (the CPU's reductions): it is held to
# the two-step bounds.
_GROUPS = ("Dense_0", "DenseBNAct_4", "DenseBNAct_3", "DenseBNAct_2",
           "DenseBNAct_1", "DenseBNAct_0", "FusedEdgeConv_0",
           "Fused2EdgeConv_1", "Fused2EdgeConv_0")
_UPDATE_TOL = {1: (0.98, 0.05), 2: (0.90, 0.10)}


@pytest.mark.parametrize("n_steps", [1, 2])
def test_params(runs, n_steps):
    """Every parameter within 5e-3 of its largest element, and each
    update (params after the step minus the start) pointing the same way
    as JAX's with a like norm, within ``_UPDATE_TOL``. ``pytest -s`` shows
    each group's readings."""
    start = runs["start"]
    got, want = runs["port"][n_steps - 1][0], runs["ref"][n_steps - 1][0]
    params = [k for k in want if k.startswith("['params']")]
    assert len(params) == 2 * 6 + 3 + 5 * 3 + 1
    min_cos, norm_tol = _UPDATE_TOL[n_steps]
    readings = {group: [] for group in _GROUPS}
    for k in params:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=5e-3 * np.abs(want[k]).max(),
                                   err_msg=k)
        du, dw = (got[k] - start[k]).ravel(), (want[k] - start[k]).ravel()
        if k in _CANCELLED:
            assert _negligible(du, start[k]) and _negligible(dw, start[k]), k
            continue
        group = next(g for g in _GROUPS
                     if k.startswith(f"['params']['{g}']"))
        cos = du @ dw / (np.linalg.norm(du) * np.linalg.norm(dw))
        ratio = np.linalg.norm(du) / np.linalg.norm(dw)
        readings[group].append((cos, abs(ratio - 1)))
        tiny = np.linalg.norm(dw) < 1e-6 * np.linalg.norm(start[k])
        least, dev = _UPDATE_TOL[2] if tiny else (min_cos, norm_tol)
        assert cos >= least, (k, cos)
        assert abs(ratio - 1) <= dev, (k, ratio)
    for group, r in readings.items():
        print(f"{group} after {n_steps}: {len(r)} updates, least cosine "
              f"{min(c for c, _ in r):.4f}, largest norm deviation "
              f"{max(d for _, d in r):.4f}")


def test_updates_moved_every_trained_parameter(runs):
    """The port's first step moved every parameter but the one whose
    gradient is exactly 0 (``_CANCELLED``)."""
    start, first = runs["start"], runs["port"][0][0]
    still = [k for k, v in first.items()
             if k.startswith("['params']") and np.array_equal(v, start[k])]
    assert set(still) <= set(_CANCELLED), still


def test_entry_points_need_a_card_or_the_cpu():
    """Without a card the steps and the SegPredictor raise unless the
    caller passes ``device="cpu"``; ``"dgcnn"`` is a seg model of the
    registry and reads xyz only."""
    model = DGCNNPartSeg(k=K)
    if not torch.cuda.is_available():
        for make in (lambda: make_seg_train_step(
                         model, sgd_momentum(model.parameters(), LR)),
                     lambda: make_seg_eval_step(model),
                     lambda: SegPredictor(model),
                     lambda: SegPredictor.from_variables(
                         "dgcnn", random_jax_variables(DGCNNPartSeg()))):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    sp = SegPredictor.from_variables(
        "dgcnn", random_jax_variables(DGCNNPartSeg(), seed=1), batch_size=1,
        device="cpu")
    assert not sp.with_xyz_feats and sp.model.edge1.k == 40


def test_seg_predictor_sorts_and_unsorts_at_4096():
    """A 4096-point request is Hilbert-sorted before the model and its
    probabilities return in the caller's point order: a permuted cloud
    gives the same probabilities, permuted. The route at N % 128 ≠ 0
    above 4096 (the standalone kNN and the given-index kernels) keeps
    the request's N."""
    model = get_seg_model("dgcnn", k=K)
    from_jax_variables(model, random_jax_variables(model, seed=2))
    sp = SegPredictor(model, batch_size=1, device="cpu")
    rng = np.random.default_rng(5)
    cloud = rng.standard_normal((1, 4096, 3)).astype(np.float32)
    perm = rng.permutation(4096)
    got = sp.predict_proba(cloud, [3])
    again = sp.predict_proba(cloud[:, perm], [3])
    assert got.shape == (1, 4096, 50)
    np.testing.assert_allclose(again, got[:, perm], rtol=1e-5, atol=1e-6)
    big = np.concatenate([cloud, cloud[:, :4]], axis=1)  # 4100 points
    assert sp.predict(big, [3]).shape == (1, 4100)
