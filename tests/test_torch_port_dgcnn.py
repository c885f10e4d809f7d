"""DGCNN classification in the PyTorch port against the JAX model, on the
CPU: eval logits, the Predictor, the weight bridge and two train steps.

The JAX model runs its fused EdgeConv in Pallas interpret mode
(``POINTCLOUDLIB_FUSED_SA=1``), so both sides have the fused parameter
layout and build the kNN graph inside the kernels (N = 128, a multiple
of 128); weights come from ``random_jax_variables`` and reach the port
through ``from_jax_variables``. Full widths, k=20. The train steps use
B=8 clouds and lr 1e-4 (``tests/test_torch_port_train_step.py`` says
why) with ``DGCNN(dropout=0.0)`` on both sides: the JAX model takes its
dropout rate as a field, so no stand-in is needed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudlib_tpu.inference import Predictor as JaxPredictor
from pointcloudlib_tpu.models.dgcnn import DGCNN as JaxDGCNN
from pointcloudlib_tpu.train.state import TrainState
from pointcloudlib_tpu.train.state import sgd_momentum as jax_sgd
from pointcloudlib_tpu.train.trainer import (
    make_cls_train_step as jax_train_step,
)

from pointcloudlib_tpu_torch.inference import Predictor
from pointcloudlib_tpu_torch.models import get_cls_model
from pointcloudlib_tpu_torch.models.dgcnn import DGCNN, edge_features
from pointcloudlib_tpu_torch.train import (
    make_cls_eval_step,
    make_cls_train_step,
    sgd_momentum,
)
from pointcloudlib_tpu_torch.utils.interop import (
    from_jax_variables,
    jax_variable_shapes,
    random_jax_variables,
    to_jax_variables,
)

B, N, LR = 8, 128, 1e-4


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    x *= rng.uniform(0.5, 1.0, (B, N, 1)).astype(np.float32)
    return {"xyz": x, "label": (np.arange(B) * 5 % 40).astype(np.int32)}


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def runs():
    """Everything that needs the JAX DGCNN, computed once: the variable
    tree's shapes, eval logits and Predictor probabilities on both sides,
    and two train steps on both sides."""
    mp = pytest.MonkeyPatch()
    mp.setenv("POINTCLOUDLIB_FUSED_SA", "1")
    try:
        batch = _batch()
        xyz = batch["xyz"]
        model = get_cls_model("dgcnn", dropout=0.0)
        start = random_jax_variables(model, seed=0)
        from_jax_variables(model, start)
        jm = JaxDGCNN(dropout=0.0)
        shapes = jax.eval_shape(
            lambda: jm.init(jax.random.key(0), jnp.asarray(xyz[:2])))
        out = {"start": _flat(start),
               "shapes": (jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                                 shapes),
                          jax_variable_shapes(model))}

        # eval logits and the eval step on 4 clouds, the Predictor on 3
        # clouds of N=100 (padded to 128 by repeating points: exact ties)
        with torch.no_grad():
            got = model.eval()(torch.from_numpy(xyz[:4])).numpy()
        want = np.asarray(jm.apply(start, jnp.asarray(xyz[:4]),
                                   training=False))
        correct, total = make_cls_eval_step(model, device="cpu")(
            {"xyz": xyz[:4], "label": got.argmax(-1)})
        out["logits"] = (got, want, int(correct), int(total))
        jp = JaxPredictor(jm, start, with_normals=False, batch_size=2)
        pp = Predictor.from_variables("dgcnn", start, batch_size=2,
                                      device="cpu")
        out["probs"] = (pp.predict_proba(xyz[:3, :100]),
                        jp.predict_proba(xyz[:3, :100]), pp.with_normals)

        # two train steps
        step = make_cls_train_step(
            model, sgd_momentum(model.parameters(), LR), device="cpu")
        state = TrainState.create(
            apply_fn=jm.apply,
            params=jax.tree_util.tree_map(jnp.asarray, start["params"]),
            batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                               start["batch_stats"]),
            tx=jax_sgd(LR))
        jstep = jax_train_step(jm)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        port, ref = [], []
        for _ in range(2):
            state, jmet = jstep(state, jbatch, jax.random.key(0))
            ref.append((_flat({"params": state.params,
                               "batch_stats": state.batch_stats}),
                        {k: float(v) for k, v in jmet.items()}))
            met = step(batch)
            port.append((_flat(to_jax_variables(model)),
                         {k: float(v) for k, v in met.items()}))
        out["port"], out["ref"] = port, ref
        return out
    finally:
        mp.undo()


def test_bridge_layout_is_the_jax_tree(runs):
    """``EdgeConv_{0..3}/FusedEdgeConv_0``, ``DenseBNAct_{0,1,2}`` (the
    last with a Dense bias) and ``Dense_0``: the bridge's layout is the
    JAX model's tree."""
    jax_tree, bridge = runs["shapes"]
    assert jax_tree == bridge
    assert sorted(bridge["params"]) == [
        "DenseBNAct_0", "DenseBNAct_1", "DenseBNAct_2", "Dense_0",
        "EdgeConv_0", "EdgeConv_1", "EdgeConv_2", "EdgeConv_3"]
    assert bridge["params"]["EdgeConv_3"]["FusedEdgeConv_0"] == {
        "w": (256, 256), "bn_scale": (256,), "bn_bias": (256,)}
    assert bridge["params"]["DenseBNAct_2"]["Dense_0"] == {
        "kernel": (512, 256), "bias": (256,)}


def test_logits_match_jax(runs):
    got, want, correct, total = runs["logits"]
    assert got.shape == (4, 40)
    assert np.abs(want).max() > 0.1  # logits carry signal, not just bias
    # f32 on both sides with bf16 roundings at the same places (q, off);
    # the kNN cross term and the dense layers sum in other orders
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    assert (correct, total) == (4, 4)


def test_predictor_matches_jax(runs):
    """3 clouds of N=100 at batch 2: point padding to the 128 bucket
    (every padded point has a twin: exact kNN and max-pool ties) and a
    half-empty last batch, on both sides; DGCNN reads xyz only."""
    got, want, with_normals = runs["probs"]
    assert got.shape == (3, 40) and not with_normals
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_bridge_round_trip():
    model = get_cls_model("dgcnn")
    variables = random_jax_variables(model, seed=4)
    back = to_jax_variables(from_jax_variables(model, variables))
    flat_a, flat_b = _flat(variables), _flat(back)
    # 4 fused EdgeConvs of 5 leaves, 3 DenseBNAct of 5 (one more for the
    # bias), Dense_0's kernel and bias
    assert flat_a.keys() == flat_b.keys() and len(flat_a) == 38
    for key, a in flat_a.items():
        np.testing.assert_array_equal(flat_b[key], a)
    w = variables["params"]["EdgeConv_1"]["FusedEdgeConv_0"]["w"]
    # a kernel's init, U(±1/√fan_in) with fan_in = 2·64
    assert np.abs(w).max() <= 1 / np.sqrt(128) and np.abs(w).max() > 0.05


def test_bridge_rejects_bad_trees():
    model = get_cls_model("dgcnn")
    missing = random_jax_variables(model, seed=0)
    del missing["batch_stats"]["EdgeConv_2"]["FusedEdgeConv_0"]["var"]
    with pytest.raises(KeyError, match="missing.*EdgeConv_2/FusedEdgeConv_0"
                                       "/var"):
        from_jax_variables(model, missing)
    extra = random_jax_variables(model, seed=0)
    extra["params"]["EdgeConv_0"]["FusedEdgeConv_0"]["w2"] = np.zeros(
        (64, 64), np.float32)
    with pytest.raises(KeyError, match="extra.*w2"):
        from_jax_variables(model, extra)
    bad = random_jax_variables(model, seed=0)
    bad["params"]["EdgeConv_0"]["FusedEdgeConv_0"]["w"] = np.zeros(
        (3, 64), np.float32)
    with pytest.raises(ValueError, match="w"):
        from_jax_variables(model, bad)


# DGCNN rebuilds its graph from the features at every EdgeConv, so the
# loss is not a smooth function of the weights: an update that differs by
# rounding (the kNN cross term and the dense layers sum in other orders)
# moves near-tied neighbours and with them the next forward. Readings on
# the CPU: the first step's loss agrees to 2e-5 relative, the second's to
# 4.3e-3; the running statistics to 2.1e-4 of their largest element after
# one step and 1.25e-2 (DenseBNAct_2) after two. From the same weights the
# two forwards agree to 2e-4. Bounds per step: (loss, statistics).
_STEP_TOL = {1: (2e-3, 1e-2), 2: (1e-2, 2.5e-2)}


@pytest.mark.parametrize("n_steps", [1, 2])
def test_loss_and_accuracy(runs, n_steps):
    got, want = runs["port"][n_steps - 1][1], runs["ref"][n_steps - 1][1]
    assert np.isfinite(got["loss"])
    rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    print(f"loss after {n_steps}: relative difference {rel:.2e}")
    assert rel <= _STEP_TOL[n_steps][0]
    assert got["acc"] == want["acc"]


@pytest.mark.parametrize("n_steps", [1, 2])
def test_bn_running_stats(runs, n_steps):
    """Every running mean and variance, the four EdgeConvs' and the three
    ``DenseBNAct`` ones (biased variance, momentum 0.9), within
    ``_STEP_TOL`` of the largest element of each."""
    got, want = runs["port"][n_steps - 1][0], runs["ref"][n_steps - 1][0]
    stats = [k for k in want if k.startswith("['batch_stats']")]
    assert len(stats) == 4 * 2 + 3 * 2
    worst = max((np.abs(got[k] - want[k]).max() / np.abs(want[k]).max(), k)
                for k in stats)
    print(f"running statistics after {n_steps}: worst {worst}")
    assert worst[0] <= _STEP_TOL[n_steps][1], worst


# The Dense bias of DenseBNAct_2 feeds a train-mode BatchNorm, which
# removes any constant shift: its gradient is exactly 0.
_CANCELLED = ("['params']['DenseBNAct_2']['Dense_0']['bias']",)

# Least update cosine and largest norm deviation per group after one
# step, and after two. Readings on the CPU after one step: Dense_0 1.0000
# / 0.0000, DenseBNAct_2 0.9969 / 0.0046, DenseBNAct_1 0.9942 / 0.0085,
# DenseBNAct_0 0.9933 / 0.0094, EdgeConv_3 0.9944 / 0.0185, EdgeConv_2
# 0.9936 / 0.0254, EdgeConv_1 0.9940 / 0.0185, EdgeConv_0 0.9924 /
# 0.0192; after two steps the least cosine is 0.9634 (EdgeConv_0) and the
# largest norm deviation 0.0445 (EdgeConv_0), as the second forward moves
# with the first update (see _STEP_TOL).
_GROUPS = ("Dense_0", "DenseBNAct_2", "DenseBNAct_1", "DenseBNAct_0",
           "EdgeConv_3", "EdgeConv_2", "EdgeConv_1", "EdgeConv_0")
_UPDATE_TOL = {1: (0.98, 0.05), 2: (0.90, 0.10)}


def _negligible(update, start):
    """An update below the float32 resolution of the parameter it moves:
    rounding noise."""
    return np.linalg.norm(update) <= 1e-6 * np.linalg.norm(start)


@pytest.mark.parametrize("n_steps", [1, 2])
def test_params(runs, n_steps):
    """Every parameter within 5e-3 of its largest element, and each
    update (params after the step minus the start) pointing the same way
    as JAX's with a like norm, within ``_UPDATE_TOL``. The ``_CANCELLED``
    bias must not move beyond rounding noise on either side. ``pytest -s``
    shows each group's readings."""
    start = runs["start"]
    got, want = runs["port"][n_steps - 1][0], runs["ref"][n_steps - 1][0]
    params = [k for k in want if k.startswith("['params']")]
    assert len(params) == 4 * 3 + 3 * 3 + 1 + 2
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
        assert cos >= min_cos, (k, cos)
        assert abs(ratio - 1) <= norm_tol, (k, ratio)
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


def test_grad_check_leaves_out_only_the_cancelled_bias():
    """``tools/grad_check.grad_agreement``, the card-vs-CPU check, run
    CPU against CPU: it compares every gradient but the Dense bias of
    ``fc2`` (``DenseBNAct_2``), exactly 0, and holds that one below 1e-3
    of the largest."""
    from pointcloudlib_tpu_torch.tools.grad_check import grad_agreement

    batch = _batch(1)
    got = grad_agreement(
        "dgcnn", random_jax_variables(get_cls_model("dgcnn"), seed=0),
        {"xyz": torch.from_numpy(batch["xyz"]),
         "label": torch.from_numpy(batch["label"]).long()},
        torch.device("cpu"))
    assert got["failures"] == [] and got["loss"] == got["loss_cpu"]
    assert sorted(got["not_compared"]) == ["fc2.dense.bias"]
    assert len(got["agree"]) == 24 - 1


def test_fused_layer_matches_the_edge_features_layer():
    """The fused EdgeConv in training against the layer written out on
    the edge features ``concat(x_j − x_i, x_i)`` (``edge_features``) in
    f32: the JAX package's own bound between its fused and unfused layers
    (``tests/test_fused_edge.py::test_forward_and_stats_parity``), the
    fused route rounding x and W to bf16."""
    from pointcloudlib_tpu_torch.models.dgcnn import FusedEdgeConv

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 128, 16)).astype(
        np.float32))
    layer = FusedEdgeConv(16, 32, 20).train()
    with torch.no_grad():
        got = layer(x)
        h = edge_features(x, 20) @ layer.w
    flat = h.reshape(-1, 32)
    mean, var = flat.mean(0), flat.var(0, unbiased=False)
    z = (h - mean) * torch.rsqrt(var + 1e-5)
    want = torch.where(z > 0, z, 0.2 * z).amax(2)
    torch.testing.assert_close(got, want, rtol=0.05, atol=0.05)
    torch.testing.assert_close(layer.mean, 0.1 * mean, rtol=0.03, atol=0.02)
    torch.testing.assert_close(layer.var, 0.9 + 0.1 * var, rtol=0.05,
                               atol=0.02)


def test_entry_points_need_a_card_and_a_multiple_of_128():
    """Without a card the steps and the Predictor raise unless the caller
    passes ``device="cpu"``. An N that is not a multiple of 128 takes the
    standalone kNN and the EdgeConv kernels that take its index, in eval
    and in training (``tests/test_torch_port_knn_route.py`` holds that
    route against JAX)."""
    model = DGCNN()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_cls_train_step(model, sgd_momentum(model.parameters(), LR))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Predictor(model)
    x = torch.from_numpy(_batch(2)["xyz"][:2, :100])
    for training in (False, True):
        logits = model.train(training)(x)
        assert logits.shape == (2, 40) and torch.isfinite(logits).all()
