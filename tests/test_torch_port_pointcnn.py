"""PointCNN classification and part segmentation in the PyTorch port
against the JAX models, on the CPU: the weight bridge both ways, eval
logits, the Predictor and the SegPredictor, the eval steps, one and two
train steps of each, single layers at stride 2 and 3 and on the route
without the fused kNN + gather, and the neighbour lists of every layer.

Weights come from ``random_jax_variables`` and reach the port through
``from_jax_variables``. Full widths; classification at B=2, N=512 (FPS
512 → 384 → 128, every layer on the fused kNN + gather), part
segmentation served at B=1, N=1024 (FPS 1024 → 768 → 384 → 128) and
trained at B=2, N=512 (the second encoder keeps every point), lr 1e-4,
dropout 0 (``PointCNNCls(dropout=0.0)`` on both sides; the part
segmentation model has none). On the CPU both sides run f32; the JAX
package takes ``knn``, ``lax.top_k`` and ``index_points`` there (no
Pallas), the port the plain version of its fused kNN + gather behind the
JAX layer's gate.

XConv reads its neighbours positionally, so one swapped rank changes a
row's output. Both sides form d² by the ``|a|² − 2a·b + |b|²``
expansion, the JAX package's cross term by a matrix product, the port's
channel by channel; both break ties to the lower index. The models are
held on grid clouds (coordinates multiples of 2^-6, distinct points),
where every d² is exact in f32 on both sides and the lists must be
equal; on random clouds each layer's lists are compared row by row, and
a row may differ only where the JAX d² of the swapped ranks are within
1e-6 of the largest d².
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudlib_tpu.models.pointcnn import PointCNNCls as JaxPointCNNCls
from pointcloudlib_tpu.models.pointcnn import (
    PointCNNLayer as JaxPointCNNLayer,
)
from pointcloudlib_tpu.models.pointcnn import (
    PointCNNPartSeg as JaxPointCNNPartSeg,
)
from pointcloudlib_tpu.ops.geometry import knn as jax_knn
from pointcloudlib_tpu.ops.geometry import square_distance as jax_d2
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
from pointcloudlib_tpu_torch.models import pointcnn as port_pointcnn
from pointcloudlib_tpu_torch.models.pointcnn import (
    PointCNNCls,
    PointCNNLayer,
    PointCNNPartSeg,
)
from pointcloudlib_tpu_torch.nn.layers import DenseBNAct
from pointcloudlib_tpu_torch.ops import dispatch, geometry
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

CLS_N, SEG_N, STEP_B, LR = 512, 512, 2, 1e-4


def _grid_clouds(rng, b, n):
    """``b`` clouds of ``n`` distinct points in shells of radius 0.6–1,
    every coordinate a multiple of 2^-6: products and sums of three are
    exact in f32, so both forms of d² are exact."""
    out = []
    for _ in range(b):
        x = rng.standard_normal((4 * n, 3))
        x *= rng.uniform(0.6, 1.0, (4 * n, 1)) / np.linalg.norm(
            x, axis=-1, keepdims=True)
        q = np.round(x * 64.0)
        _, first = np.unique(q, axis=0, return_index=True)
        out.append(q[np.sort(first)[:n]] / 64.0)
    return np.stack(out).astype(np.float32)


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


def _eval(module):
    """The model's eval forward → ``(logits, softmax)``, one program."""
    def forward(v, *a):
        logits = module.apply(v, *a, training=False)
        return logits, jax.nn.softmax(logits, -1)

    return jax.jit(forward)


def _served(arrays, forward, size=2):
    """``forward`` on each batch of ``size`` a predictor serves for
    ``arrays`` (the last filled by repeating its last cloud), the real rows
    of each of its outputs joined."""
    outs = [[np.asarray(o)[:real] for o in forward(*chunks)]
            for chunks, real in _batches(arrays, size)]
    return tuple(np.concatenate(o) for o in zip(*outs))


def _port_served(predict, model):
    """``predict()`` of a predictor over ``model`` → ``(its output, the
    model's logits on each batch it served)``: one forward for both."""
    logits = []
    hook = model.register_forward_hook(lambda m, a, o: logits.append(o))
    try:
        return predict(), logits
    finally:
        hook.remove()


def _state(apply_fn, start):
    """The JAX train state at ``start``: ``TrainState.create``'s fields,
    optax's momentum zeros in the structure its init makes (traced, not
    compiled; eager init compiles a program for each parameter's
    shape)."""
    tx = jax_sgd(LR)
    params = jax.tree_util.tree_map(jnp.asarray, start["params"])
    opt_state = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.zeros(a.shape, a.dtype)),
        jax.eval_shape(tx.init, params))
    return TrainState(step=0, apply_fn=apply_fn, params=params, tx=tx,
                      opt_state=opt_state, batch_stats=jax.tree_util.tree_map(
                          jnp.asarray, start["batch_stats"]))


def _two_steps(step, jstep, state, model, batch):
    """Two steps on each side → ``(port, ref)``, each a list of ``(flat
    variables, metrics)``."""
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
    return port, ref


def _record_knn_gathers(monkeypatch):
    """Keep the ``(query, points, k, stride)`` of every fused kNN +
    gather the port's layers call."""
    calls, orig = [], dispatch.knn_gather

    def rec(query, points, values, k, stride=1):
        calls.append((query.detach().clone(), points.detach().clone(), k,
                      stride))
        return orig(query, points, values, k, stride)

    monkeypatch.setattr(dispatch, "knn_gather", rec)
    return calls


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
    mp = pytest.MonkeyPatch()
    try:
        # classification: 3 grid clouds of 500 points served at batch 2
        # (the 512 bucket: cyclic padding, duplicate points)
        clouds = _grid_clouds(rng, 3, 500)
        model = get_cls_model("pointcnn", dropout=0.0)
        start = random_jax_variables(model, seed=0)
        from_jax_variables(model, start)
        jm = JaxPointCNNCls(dropout=0.0)
        out["cls_start"] = _flat(start)
        [xyz] = _pad_points([clouds[:2]], 500)
        out["cls_shapes"] = (_shapes(jm, jnp.asarray(xyz)),
                             jax_variable_shapes(model))
        served = _pad_points([clouds], 500)
        # the Predictor's forward gives the model's logits too
        pp = Predictor.from_variables("pointcnn", start, batch_size=2,
                                      device="cpu")
        calls = _record_knn_gathers(mp)
        probs, logits = _port_served(lambda: pp.predict_proba(clouds),
                                     pp.model)
        out["cls_calls"] = [(q.shape, p.shape, k, s)
                            for q, p, k, s in calls[:4]]
        mp.undo()
        got = np.concatenate([o.numpy()[:real] for o, (_, real) in
                              zip(logits, _batches(served, 2))])
        fwd = _eval(jm)
        want, want_probs = _served(
            served, lambda x: fwd(start, jnp.asarray(x)))
        out["cls_logits"] = (got, want)
        out["cls_probs"] = (probs, want_probs, pp.with_normals)
        batch = {"xyz": _grid_clouds(rng, STEP_B, CLS_N),
                 "label": np.array([3, 17])}
        correct, total = make_cls_eval_step(model, device="cpu")(batch)
        want_pred = np.asarray(fwd(start, jnp.asarray(batch["xyz"]))[0])
        out["cls_eval_step"] = (int(correct), int(total),
                                int((want_pred.argmax(-1)
                                     == batch["label"]).sum()))
        step = make_cls_train_step(model, sgd_momentum(model.parameters(),
                                                       LR), device="cpu")
        out["cls_port"], out["cls_ref"] = _two_steps(
            step, jax_cls_step(jm), _state(jm.apply, start), model, batch)

        # part segmentation: 1 grid cloud of 1000 points served at batch 1
        # (the 1024 bucket)
        clouds, labels = _grid_clouds(rng, 1, 1000), np.array([4])
        onehot = np.eye(16, dtype=np.float32)[[1, 4]]
        model = get_seg_model("pointcnn")
        start = random_jax_variables(model, seed=1)
        from_jax_variables(model, start)
        jm = JaxPointCNNPartSeg()
        out["seg_start"] = _flat(start)
        [xyz] = _pad_points([clouds], 1000)
        out["seg_shapes"] = (_shapes(jm, jnp.asarray(xyz),
                                     jnp.asarray(onehot)),
                             jax_variable_shapes(model))
        served = _pad_points([clouds], 1000) + [onehot[1:]]
        sp = SegPredictor.from_variables("pointcnn", start, batch_size=1,
                                         device="cpu")
        calls = _record_knn_gathers(mp)
        probs, logits = _port_served(
            lambda: sp.predict_proba(clouds, labels), sp.model)
        out["seg_calls"] = [(q.shape, p.shape, k, s)
                            for q, p, k, s in calls]
        mp.undo()
        got = np.concatenate([o.numpy() for o in logits])
        fwd = _eval(jm)
        want, want_probs = _served(
            served, lambda x, o: fwd(start, jnp.asarray(x), jnp.asarray(o)),
            1)
        out["seg_logits"] = (got, want)
        out["seg_predictor"] = (probs, want_probs[:, :1000],
                                sp.with_xyz_feats)
        # the eval step on the served batch, the train steps on smaller
        # clouds (the port's CPU time goes as B·N)
        out["seg_eval_step"] = (make_seg_eval_step(model, device="cpu")(
            {"xyz": served[0], "cls_onehot": onehot[1:]}
        ).numpy(), want.argmax(-1))
        batch = {"xyz": _grid_clouds(rng, STEP_B, SEG_N),
                 "cls_onehot": onehot,
                 "seg": rng.integers(0, 50, (STEP_B, SEG_N)).astype(np.int32)}
        step = make_seg_train_step(model, sgd_momentum(model.parameters(),
                                                       LR), device="cpu")
        out["seg_port"], out["seg_ref"] = _two_steps(
            step, jax_seg_step(jm), _state(jm.apply, start), model, batch)
    finally:
        mp.undo()
    return out


def test_bridge_layout_is_the_jax_tree(runs):
    """The bridge's layout is the flax tree of both JAX models:
    ``PointCNNLayer_i/{DenseBlock_0, XConv_0/{DenseBlock_0..4, depthwise,
    depthwise_bias, Dense_0, BatchNorm_0}}`` and the head's or the
    decoders' ``DenseBlock_j``."""
    jax_tree, bridge = runs["cls_shapes"]
    assert jax_tree == bridge
    assert sorted(bridge["params"]) == [
        "DenseBlock_0", "DenseBlock_1", "DenseBlock_2"] + [
        f"PointCNNLayer_{i}" for i in range(4)]
    layer = bridge["params"]["PointCNNLayer_0"]
    assert sorted(layer) == ["DenseBlock_0", "XConv_0"]
    xconv = layer["XConv_0"]
    assert sorted(xconv) == ["BatchNorm_0", "DenseBlock_0", "DenseBlock_1",
                             "DenseBlock_2", "DenseBlock_3", "DenseBlock_4",
                             "Dense_0", "depthwise", "depthwise_bias"]
    # c = c_mid + c_out/2 = 12 + 24 channels, K = 8, dm = 48 / 3
    assert xconv["depthwise"] == (36, 8, 16)
    assert xconv["depthwise_bias"] == (36 * 16,)
    assert xconv["Dense_0"] == {"kernel": (576, 48)}
    assert xconv["DenseBlock_2"]["Dense_0"] == {"kernel": (24, 64),
                                                "bias": (64,)}
    assert sorted(xconv["DenseBlock_4"]) == ["Dense_0"]  # no BatchNorm
    assert sorted(bridge["params"]["DenseBlock_2"]) == ["Dense_0"]
    jax_tree, bridge = runs["seg_shapes"]
    assert jax_tree == bridge
    assert sorted(bridge["params"]) == [
        f"DenseBlock_{i}" for i in range(4)] + [
        f"PointCNNLayer_{i}" for i in range(8)]
    # the first encoder: c = 64 + 128, dm = ⌈256 / 3⌉ = 86
    assert bridge["params"]["PointCNNLayer_0"]["XConv_0"]["Dense_0"] == {
        "kernel": (192 * 86, 256)}


@pytest.mark.parametrize("model", [PointCNNCls, PointCNNPartSeg])
def test_bridge_round_trip(model):
    m = model()
    variables = random_jax_variables(m, seed=4)
    back = to_jax_variables(from_jax_variables(m, variables))
    flat_a, flat_b = _flat(variables), _flat(back)
    assert flat_a.keys() == flat_b.keys()
    for key, a in flat_a.items():
        np.testing.assert_array_equal(flat_b[key], a)


def test_layers_take_the_fused_knn_gather(runs):
    """Every layer of both models at these sizes takes the fused kNN +
    gather, with the JAX layers' strides: classification (M, N, k,
    stride) (512, 512, 8, 1), (384, 512, 12, 2), (128, 384, 16, 2),
    (128, 128, 16, 3); part segmentation's encoders and decoders."""
    assert [(q[1], p[1], k, s) for q, p, k, s in runs["cls_calls"]] == [
        (512, 512, 8, 1), (384, 512, 12, 2), (128, 384, 16, 2),
        (128, 128, 16, 3)]
    assert [(q[1], p[1], k, s) for q, p, k, s in runs["seg_calls"]] == [
        (1024, 1024, 8, 1), (768, 1024, 12, 1), (384, 768, 16, 1),
        (128, 384, 16, 1), (128, 128, 16, 1), (384, 128, 16, 1),
        (768, 384, 12, 1), (1024, 768, 8, 1)]


def test_logits_match_jax(runs):
    """Eval logits of both models on the served grid batches: equal
    neighbour lists, f32 on both sides, sums in other orders. Measured:
    1.5e-7 (classification), 9.0e-7 (part segmentation) of max|logit|."""
    for key in ("cls_logits", "seg_logits"):
        got, want = runs[key]
        assert np.abs(want).max() > 0.05  # the logits carry signal
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=key)


def test_predictors_and_eval_steps_match_jax(runs):
    """The Predictor (xyz only: ``with_normals`` is the JAX rule's False)
    and the SegPredictor against the softmax of the JAX logits on the same
    served batches; the eval steps' counts and part ids are the JAX
    model's on the same batch."""
    got, want, with_normals = runs["cls_probs"]
    assert got.shape == (3, 40) and not with_normals
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    probs, want, with_xyz = runs["seg_predictor"]
    assert probs.shape == want.shape == (1, 1000, 50) and not with_xyz
    np.testing.assert_allclose(probs, want, rtol=1e-5, atol=1e-6)
    correct, total, want_correct = runs["cls_eval_step"]
    assert (correct, total) == (want_correct, 2)
    pred, want_pred = runs["seg_eval_step"]
    np.testing.assert_array_equal(pred, want_pred)  # the JAX model's ids


# Bounds per step: (loss relative; each running statistic and parameter
# × its largest element; least cosine of an update beyond rounding).
# Equal neighbour lists; sums in other orders, which the CPU's thread
# count moves. Measured (both models, 2 and 8 threads): step 1 loss
# 1.3e-7, elements 5.2e-6, cosine 0.9999999; step 2 loss 2.3e-7,
# elements 5.9e-5, cosine 0.99999.
_STEP_TOL = {1: (1e-6, 1e-4, 0.9999), 2: (1e-6, 2e-4, 0.9999)}


@pytest.mark.parametrize("n_steps", [1, 2])
@pytest.mark.parametrize("tag", ["cls", "seg"])
def test_train_steps_match_jax(runs, tag, n_steps):
    """Loss, accuracy, every BN running statistic (flax's momentum 0.9)
    and every parameter after one and two SGD steps (momentum 0.9, lr
    1e-4) within ``_STEP_TOL``, and every update that JAX makes beyond
    rounding pointing the same way in the port. ``pytest -s`` shows the
    worst."""
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
    worst, least, moved = (0.0, ""), (1.0, ""), 0
    for k in want:
        err = np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(),
                                                    1e-6)
        worst = max(worst, (err, k))
        assert err <= elem_tol, (k, err)
        du, dw = (got[k] - start[k]).ravel(), (want[k] - start[k]).ravel()
        if np.linalg.norm(dw) > 1e-4 * max(np.linalg.norm(start[k]), 1.0):
            moved += 1
            cos = du @ dw / (np.linalg.norm(du) * np.linalg.norm(dw))
            least = min(least, (cos, k))
            assert cos >= min_cos, (k, cos)
    print(f"{tag} after {n_steps}: worst element {worst}, least update "
          f"cosine {least}, {moved} of {len(want)} moved")


# single layers: (c_in, c_out, k, stride, representatives, N), B=2; the
# models cover stride 3 on the fused route (classification's last layer)
LAYER_CASES = {
    "stride 2, fused": (48, 96, 12, 2, 384, 512),
    "stride 3, N % 128 != 0": (96, 192, 16, 3, 128, 500),
}


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_layer_matches_jax(name, monkeypatch):
    """One ``PointCNNLayer`` in training on a grid cloud: the output and
    every parameter's gradient of ``Σ out·r`` against the JAX layer's,
    and the route: the fused kNN + gather where N % 128 == 0, else
    ``geometry.knn`` and the gathers. Measured: output 1.3e-5 of its
    largest element, gradients 3.8e-5 of the largest of them all (a
    Dense bias in front of a train-mode BatchNorm, 0 but for
    rounding)."""
    c_in, c_out, k, d, p, n = LAYER_CASES[name]
    rng = np.random.default_rng(n + d)
    pts = _grid_clouds(rng, 2, n)
    fts = rng.standard_normal((2, n, c_in)).astype(np.float32)
    layer = PointCNNLayer(c_in, c_out, k=k, d=d, p=p)
    variables = random_jax_variables(layer, seed=d)
    from_jax_variables(layer, variables)
    jl = JaxPointCNNLayer(c_in, c_out, k=k, d=d, p=p)
    assert _shapes(jl, jnp.asarray(pts), jnp.asarray(fts)) == \
        jax_variable_shapes(layer)
    m = n if p < 0 else p
    r = rng.standard_normal((2, m, c_out)).astype(np.float32)

    @jax.jit
    def jgrad(params, stats, pts, fts, r):
        def loss(params):
            (_, o), _ = jl.apply({"params": params, "batch_stats": stats},
                                 pts, fts, training=True,
                                 mutable=["batch_stats"])
            return jnp.sum(o * r), o
        return jax.value_and_grad(loss, has_aux=True)(params)

    (_, want), jgrads = jgrad(
        *(jax.tree_util.tree_map(jnp.asarray, variables[c])
          for c in ("params", "batch_stats")),
        jnp.asarray(pts), jnp.asarray(fts), jnp.asarray(r))
    routes = {"fused": 0, "knn": 0}
    fused, plain_knn = dispatch.knn_gather, geometry.knn

    def count(key, fn):
        def wrapped(*a, **kw):
            routes[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(dispatch, "knn_gather", count("fused", fused))
    monkeypatch.setattr(port_pointcnn.geometry, "knn",
                        count("knn", plain_knn))
    layer.train()
    _, got = layer(torch.from_numpy(pts), torch.from_numpy(fts))
    (got * torch.from_numpy(r)).sum().backward()
    assert routes == ({"fused": 1, "knn": 0} if n % 128 == 0
                      else {"fused": 0, "knn": 1})
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=5e-5 * np.abs(want).max())
    grads = {"['params']" + key: val for key, val in _flat(jgrads).items()}
    port = _flat(_grads_as_jax(layer))
    # every gradient against the largest element of them all: the Dense
    # biases in front of a train-mode BatchNorm are 0 but for rounding
    # residue, which is the worst
    largest = max(np.abs(g).max() for g in grads.values())
    worst = max((np.abs(port[key] - g).max() / largest, key)
                for key, g in grads.items())
    assert worst[0] <= 2e-4, worst
    print(f"{name}: output "
          f"{np.abs(got.detach().numpy() - want).max() / np.abs(want).max()}"
          f", worst gradient {worst}")


def _grads_as_jax(layer):
    """``layer``'s parameter gradients in the bridge's JAX layout."""
    view = copy.deepcopy(layer)
    with torch.no_grad():
        for p, q in zip(layer.parameters(), view.parameters()):
            q.copy_(p.grad)
    return to_jax_variables(view)


def test_neighbour_lists_match_jax_but_for_near_ties(monkeypatch):
    """On random (off-grid) clouds, the k·stride nearest of every layer's
    queries in both models' eval forward, the port's plain order against
    the JAX ``knn``: equal rows but where the JAX d² of the port's and
    the JAX's point at a rank are within 1e-6 of the largest d² (a near
    tie between the two forms of d²). Measured: 3 of the 6,912 rows of
    the twelve calls differ, each at such a tie; at most 1 % may."""
    rng = np.random.default_rng(7)
    calls = _record_knn_gathers(monkeypatch)
    with torch.no_grad():
        for model, args in ((get_cls_model("pointcnn", dropout=0.0),
                             (_clouds(rng, 2, 512),)),
                            (get_seg_model("pointcnn"),
                             (_clouds(rng, 1, 1024), np.eye(16)[[0]]))):
            from_jax_variables(model, random_jax_variables(model, seed=2))
            model.eval()(*(torch.from_numpy(np.asarray(a, np.float32))
                           for a in args))
    assert len(calls) == 12
    # the twelve calls' d² and lists in one JAX program
    jax_lists = jax.jit(
        lambda pairs, kds: [(jax_d2(q, p), jax_knn(q, p, kd)[1])
                            for (q, p), kd in zip(pairs, kds)],
        static_argnums=1)
    lists = jax_lists(
        tuple((jnp.asarray(q.numpy()), jnp.asarray(p.numpy()))
              for q, p, _, _ in calls),
        tuple(k * stride for _, _, k, stride in calls))
    rows = differ = 0
    for (query, points, k, stride), (d2, jidx) in zip(calls, lists):
        _, idx = geometry.knn_plain(query, points, k * stride)
        idx, d2, jidx = idx.numpy(), np.asarray(d2), np.asarray(jidx)
        kept = slice(None, None, stride)
        bad = (idx[..., kept] != jidx[..., kept]).any(-1)
        rows += bad.size
        differ += int(bad.sum())
        gap = np.abs(np.take_along_axis(d2, idx.astype(np.int64), -1)
                     - np.take_along_axis(d2, jidx.astype(np.int64), -1))
        assert (gap[bad] <= 1e-6 * d2.max()).all(), gap[bad].max()
    assert differ < 1e-2 * rows, (differ, rows)
    print(f"{differ} of {rows} rows differ")


def test_entry_points_need_a_card_or_the_cpu():
    """Without a card the predictors and the steps raise unless the
    caller passes ``device="cpu"``; PointCNN is in both registries, its
    Predictor reads the features only when asked (``with_normals``), and
    no layer takes bf16 operands (every Dense is a float32
    ``DenseBlock`` or ``nn.Linear``, none a ``DenseBNAct``)."""
    cls, seg = PointCNNCls(), PointCNNPartSeg()
    if not torch.cuda.is_available():
        for make in (lambda: Predictor(cls),
                     lambda: SegPredictor(seg),
                     lambda: make_cls_train_step(
                         cls, sgd_momentum(cls.parameters(), LR)),
                     lambda: make_seg_train_step(
                         seg, sgd_momentum(seg.parameters(), LR))):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    p = Predictor.from_variables("pointcnn", random_jax_variables(cls),
                                 batch_size=1, device="cpu")
    assert not p.with_normals
    assert p.model.layers[0].lift.dense.in_features == 3
    assert isinstance(get_seg_model("pointcnn"), PointCNNPartSeg)
    for model in (cls, seg):
        assert not any(isinstance(m, DenseBNAct) for m in model.modules())
        assert {p.dtype for p in model.parameters()} == {torch.float32}
