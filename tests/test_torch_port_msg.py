"""PointNet++ MSG classification in the PyTorch port against the JAX
model, on the CPU: eval logits, the Predictor, the weight bridge and two
train steps.

The JAX model runs its fused set abstraction in Pallas interpret mode
(``POINTCLOUDLIB_FUSED_SA=1``), so both sides have the fused parameter
layout; weights come from ``random_jax_variables`` and reach the port
through ``from_jax_variables``. Full widths, B=8 clouds of N=128 points
with normals (``tests/test_torch_port_train_step.py`` says why B=8 and a
small learning rate). At N=128 the two k ≤ 64 scales of each MSG layer
take the kernels with the ball query inside and the k=128 scale the
standalone ball query and the kernels that take its index, as at N=1024.

The JAX ``PointNet2MSG`` builds its head with the default dropout 0.5,
whose mask the port cannot reproduce, so the train-step comparison uses
``_MSGNoDropout``: the same four calls in the same order with
``_ClsHead(dropout=0)``. flax names submodules by class and order, so its
variable tree equals ``PointNet2MSG``'s, which a test asserts.
"""

from typing import Optional

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from pointcloudlib_tpu.inference import Predictor as JaxPredictor
from pointcloudlib_tpu.models import get_cls_model as jax_cls_model
from pointcloudlib_tpu.models.pointnet2 import _ClsHead
from pointcloudlib_tpu.nn.layers import (
    SetAbstraction as JaxSetAbstraction,
)
from pointcloudlib_tpu.nn.layers import (
    SetAbstractionMSG as JaxSetAbstractionMSG,
)
from pointcloudlib_tpu.train.state import TrainState
from pointcloudlib_tpu.train.state import sgd_momentum as jax_sgd
from pointcloudlib_tpu.train.trainer import (
    make_cls_train_step as jax_train_step,
)

from pointcloudlib_tpu_torch.inference import Predictor
from pointcloudlib_tpu_torch.models import get_cls_model
from pointcloudlib_tpu_torch.train import make_cls_train_step, sgd_momentum
from pointcloudlib_tpu_torch.utils.interop import (
    from_jax_variables,
    jax_variable_shapes,
    random_jax_variables,
    to_jax_variables,
)

B, N, LR = 8, 128, 1e-4


class _MSGNoDropout(nn.Module):
    """``PointNet2MSG`` (``models/pointnet2.py:135``) with the head's
    dropout at 0."""

    n_classes: int = 40

    @nn.compact
    def __call__(self, xyz, feats: Optional[jax.Array] = None,
                 training: bool = False):
        xyz, f = JaxSetAbstractionMSG(
            n_points=512, radii=[0.1, 0.2, 0.4], n_samples=[16, 32, 128],
            mlps=[[32, 32, 64], [64, 64, 128], [64, 96, 128]],
        )(xyz, feats, training)
        xyz, f = JaxSetAbstractionMSG(
            n_points=128, radii=[0.2, 0.4, 0.8], n_samples=[32, 64, 128],
            mlps=[[64, 64, 128], [128, 128, 256], [128, 128, 256]],
        )(xyz, f, training)
        xyz, f = JaxSetAbstraction(mlp=[256, 512, 1024])(xyz, f, training)
        return _ClsHead(self.n_classes, dropout=0.0)(f[:, 0], training)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    x *= rng.uniform(0.5, 1.0, (B, N, 1)).astype(np.float32)
    f = rng.standard_normal((B, N, 3)).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    return {"xyz": x, "feats": f,
            "label": (np.arange(B) * 5 % 40).astype(np.int32)}


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _shapes(module, batch):
    """The variable tree of ``module`` as shapes, without running it."""
    tree = jax.eval_shape(
        lambda: module.init(jax.random.key(0), jnp.asarray(batch["xyz"][:2]),
                            jnp.asarray(batch["feats"][:2])))
    return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)


@pytest.fixture(scope="module")
def runs():
    """Everything that needs the JAX MSG model, computed once: the
    variable trees' shapes, eval logits and Predictor probabilities on
    both sides, and two train steps on both sides."""
    mp = pytest.MonkeyPatch()
    mp.setenv("POINTCLOUDLIB_FUSED_SA", "1")
    try:
        batch = _batch()
        xyz, feats = batch["xyz"], batch["feats"]
        model = get_cls_model("pointnet2_msg", dropout=0.0)
        start = random_jax_variables(model, seed=0)
        from_jax_variables(model, start)
        jm, jm0 = jax_cls_model("pointnet2_msg"), _MSGNoDropout()
        out = {"start": _flat(start),
               "shapes": (_shapes(jm, batch), _shapes(jm0, batch),
                          jax_variable_shapes(model))}

        # eval logits on 2 clouds, Predictor on 3 clouds of N=100
        with torch.no_grad():
            got = model.eval()(torch.from_numpy(xyz[:2]),
                               torch.from_numpy(feats[:2])).numpy()
        want = np.asarray(jm.apply(start, jnp.asarray(xyz[:2]),
                                   jnp.asarray(feats[:2]), training=False))
        out["logits"] = (got, want)
        jp = JaxPredictor(jm, start, with_normals=True, batch_size=2)
        pp = Predictor.from_variables("pointnet2_msg", start, batch_size=2,
                                      device="cpu")
        out["probs"] = (pp.predict_proba(xyz[:3, :100], feats[:3, :100]),
                        jp.predict_proba(xyz[:3, :100], feats[:3, :100]))

        # two train steps
        step = make_cls_train_step(
            model, sgd_momentum(model.parameters(), LR), device="cpu")
        state = TrainState.create(
            apply_fn=jm0.apply,
            params=jax.tree_util.tree_map(jnp.asarray, start["params"]),
            batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                               start["batch_stats"]),
            tx=jax_sgd(LR))
        jstep = jax_train_step(jm0)
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
    """``SetAbstractionMSG_{0,1}/FusedSetAbstraction_{0,1,2}``,
    ``SetAbstraction_0``, ``_ClsHead_0``: the bridge's layout, the JAX
    model's tree and the dropout-free stand-in's tree are the same."""
    jax_tree, stand_in, bridge = runs["shapes"]
    assert jax_tree == stand_in
    assert jax_tree == bridge
    assert sorted(bridge["params"]) == ["SetAbstractionMSG_0",
                                        "SetAbstractionMSG_1",
                                        "SetAbstraction_0", "_ClsHead_0"]


def test_logits_match_jax(runs):
    got, want = runs["logits"]
    assert got.shape == (2, 40)
    assert np.abs(want).max() > 0.1  # logits carry signal, not just bias
    # f32 on both sides with bf16 roundings at the same places (q, off,
    # the fused chain); summation orders differ, and a last-bit change
    # can flip one bf16 rounding inside the fused chain
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_predictor_matches_jax(runs):
    """3 clouds of N=100 at batch 2: point padding to the 128 bucket and
    a half-empty last batch, on both sides."""
    got, want = runs["probs"]
    assert got.shape == (3, 40)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_bridge_round_trip():
    model = get_cls_model("pointnet2_msg")
    variables = random_jax_variables(model, seed=4)
    back = to_jax_variables(from_jax_variables(model, variables))
    flat_a, flat_b = _flat(variables), _flat(back)
    assert flat_a.keys() == flat_b.keys() and len(flat_a) == 117
    for key, a in flat_a.items():
        np.testing.assert_array_equal(flat_b[key], a)


@pytest.mark.parametrize("n_steps", [1, 2])
def test_loss_and_accuracy(runs, n_steps):
    got, want = runs["port"][n_steps - 1][1], runs["ref"][n_steps - 1][1]
    assert np.isfinite(got["loss"])
    # bf16 roundings inside the fused SA layers on both sides, f32 sums
    # in other orders
    assert got["loss"] == pytest.approx(want["loss"], rel=2e-3)
    assert got["acc"] == want["acc"]


@pytest.mark.parametrize("n_steps", [1, 2])
def test_bn_running_stats(runs, n_steps):
    """Every running mean and variance, the six fused scales' and the
    ``DenseBNAct`` ones (biased variance, momentum 0.9), within 1 % of
    the largest element of each."""
    got, want = runs["port"][n_steps - 1][0], runs["ref"][n_steps - 1][0]
    stats = [k for k in want if k.startswith("['batch_stats']")]
    assert len(stats) == 6 * 6 + 3 * 2 + 2 * 2
    for k in stats:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-2 * np.abs(want[k]).max(),
                                   err_msg=k)


# BN biases whose gradient is exactly 0: the next train-mode BatchNorm
# removes a constant shift. SA3's last one feeds the head's BatchNorm; at
# N=128 every pooled output of MSG2's k=128 scale is positive, so ReLU
# clips nothing there and its last bias only shifts what SA3 normalizes.
_CANCELLED = (
    "['params']['SetAbstractionMSG_1']['FusedSetAbstraction_2']['bn3_bias']",
    "['params']['SetAbstraction_0']['PointMLP_0']['DenseBNAct_2']"
    "['BatchNorm_0']['bias']",
)

# Least update cosine and largest norm deviation after one step, per
# layer from the head down; after two steps (0.85, 0.15) for all, as in
# the SSG step test. The head meets the SSG test's one-step bounds (0.97,
# 0.10). Below it the updates agree less the further the gradient has
# travelled: readings on the CPU, least cosine after one / two steps:
# head 0.979 / 0.976, SA3 0.965 / 0.956, MSG2 0.943 / 0.941, MSG1 0.924 /
# 0.931; 18 of the 69 compared updates reach 0.97 after one step. The
# port against itself moves as much: with every weight scaled by 1 +
# 1e-6 N(0, 1), its MSG gradients on 8 synthetic clouds at N=128 keep a
# least cosine of 0.956 (seed 5) and 0.934 (seed 6), 19 and 29 of 71
# below 0.97 (python -m pointcloudlib_tpu_torch.tools.grad_check --jitter
# 1e-6 --n-points 128 --seeds 5 6), so 0.97 for every update is out of
# reach of any implementation of MSG at this size.
_ONE_STEP = (("_ClsHead_0", 0.97, 0.10), ("SetAbstraction_0", 0.95, 0.10),
             ("SetAbstractionMSG_1", 0.92, 0.10),
             ("SetAbstractionMSG_0", 0.90, 0.15))


def _negligible(update, start):
    """An update below the float32 resolution of the parameter it moves:
    rounding noise."""
    return np.linalg.norm(update) <= 1e-6 * np.linalg.norm(start)


@pytest.mark.parametrize("n_steps", [1, 2])
def test_params(runs, n_steps):
    """Every parameter within 5e-3 of its largest element, and each
    update (params after the step minus the start) pointing the same way
    as JAX's with a like norm, within the bounds of ``_ONE_STEP`` or,
    after two steps, the SSG step test's (0.85, 0.15). Max-pool ties
    moving between slots make the updates differ at all. The two
    ``_CANCELLED`` biases must not move beyond rounding noise on either
    side. ``pytest -s`` shows each layer's readings."""
    start = runs["start"]
    got, want = runs["port"][n_steps - 1][0], runs["ref"][n_steps - 1][0]
    params = [k for k in want if k.startswith("['params']")]
    assert len(params) == 6 * 9 + 3 * 3 + 2 * 3 + 2
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
                                        if f"['{b[0]}']" in k)
        if n_steps == 2:
            min_cos, norm_tol = 0.85, 0.15
        cos = du @ dw / (np.linalg.norm(du) * np.linalg.norm(dw))
        ratio = np.linalg.norm(du) / np.linalg.norm(dw)
        readings[layer].append((cos, abs(ratio - 1)))
        assert cos >= min_cos, (k, cos)
        assert abs(ratio - 1) <= norm_tol, (k, ratio)
    for layer, r in readings.items():
        print(f"{layer} after {n_steps}: {len(r)} updates, least cosine "
              f"{min(c for c, _ in r):.4f}, "
              f"{sum(c >= 0.97 for c, _ in r)} at 0.97 or more, largest "
              f"norm deviation {max(d for _, d in r):.4f}")


def test_updates_moved_every_trained_parameter(runs):
    """The port's first step moved every parameter but the two whose
    gradient is exactly 0 (``_CANCELLED``)."""
    start, first = runs["start"], runs["port"][0][0]
    still = [k for k, v in first.items()
             if k.startswith("['params']") and np.array_equal(v, start[k])]
    assert set(still) <= set(_CANCELLED), still


def test_msg_runs_where_it_was_refused():
    """``get_cls_model("pointnet2_msg")`` raised until multi-scale
    grouping was ported; a train-mode forward and backward now runs on
    the CPU: finite logits, a gradient on every parameter, the running
    statistics of both routes' scales moved."""
    model = get_cls_model("pointnet2_msg", dropout=0.0)
    from_jax_variables(model, random_jax_variables(model, seed=3))
    model.train()
    bq, idx = model.sa1.scales[0], model.sa2.scales[2]
    before = bq.var1.clone(), idx.mean3.clone()
    batch = _batch(1)
    logits = model(torch.from_numpy(batch["xyz"][:4]),
                   torch.from_numpy(batch["feats"][:4]))
    assert logits.shape == (4, 40) and torch.isfinite(logits).all()
    logits.square().sum().backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
    assert idx.w1.grad.abs().sum() > 0 and bq.w1.grad.abs().sum() > 0
    assert not torch.equal(bq.var1, before[0])
    assert not torch.equal(idx.mean3, before[1])


def test_grad_check_leaves_out_only_cancelled_gradients():
    """``tools/grad_check.grad_agreement``, the card-vs-CPU check, run
    CPU against CPU on the step tests' clouds: it compares every gradient
    but the two that are exactly 0 (``_CANCELLED``), which it finds by
    rule (a norm below 1e-6 of the largest; every pooled output of the
    scale positive), and holds the second below 1e-3 of the largest."""
    from pointcloudlib_tpu_torch.tools.grad_check import grad_agreement

    batch = _batch()
    model = get_cls_model("pointnet2_msg")
    got = grad_agreement(
        "pointnet2_msg", random_jax_variables(model, seed=0),
        {"xyz": torch.from_numpy(batch["xyz"]),
         "feats": torch.from_numpy(batch["feats"]),
         "label": torch.from_numpy(batch["label"]).long()},
        torch.device("cpu"))
    assert got["failures"] == [] and got["loss"] == got["loss_cpu"]
    assert sorted(got["not_compared"]) == ["sa2.scales.2.bn3_bias",
                                           "sa3.mlp.2.bn.bias"]
    assert len(got["agree"]) == 71 - 2
    assert all(cos > 1 - 1e-9 for cos, _ in got["agree"].values())
