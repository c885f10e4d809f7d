"""PointNet++ SSG in the PyTorch port against the JAX model, on the CPU.

The JAX model runs its fused set abstraction in interpret mode
(``POINTCLOUDLIB_FUSED_SA=1``), so both sides have the fused parameter
layout; weights reach the port through ``from_jax_variables``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudlib_tpu.models import get_cls_model as jax_cls_model
from pointcloudlib_tpu.train.state import init_variables

from pointcloudlib_tpu_torch.models import get_cls_model
from pointcloudlib_tpu_torch.utils.interop import (
    from_jax_variables,
    jax_variable_shapes,
    random_jax_variables,
)


def _clouds(seed, b, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    x *= rng.uniform(0.5, 1.0, (b, n, 1)).astype(np.float32)
    nrm = rng.standard_normal((b, n, 3)).astype(np.float32)
    return x, nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)


def test_logits_match_jax(monkeypatch):
    monkeypatch.setenv("POINTCLOUDLIB_FUSED_SA", "1")
    x, nrm = _clouds(0, 2, 128)
    jm = jax_cls_model("pointnet2")
    init = init_variables(jm, jax.random.key(0), jnp.asarray(x),
                          jnp.asarray(nrm))
    model = get_cls_model("pointnet2").eval()
    # the bridge's layout IS the JAX fused model's variable tree
    assert (jax.tree_util.tree_map(np.shape, jax.device_get(init))
            == jax_variable_shapes(model))
    variables = random_jax_variables(model, seed=1)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), jnp.asarray(nrm),
                               training=False))
    from_jax_variables(model, variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(nrm)).numpy()
    assert np.abs(want).max() > 0.1  # logits carry signal, not just bias
    # f32 on both sides with bf16 roundings at the same places (q, off,
    # the fused chain); summation orders differ, and a last-bit change
    # can flip one bf16 rounding inside the fused chain
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_bridge_rejects_bad_trees():
    model = get_cls_model("pointnet2")
    good = random_jax_variables(model, seed=0)
    missing = random_jax_variables(model, seed=0)
    del missing["params"]["_ClsHead_0"]["Dense_0"]["bias"]
    with pytest.raises(KeyError, match="missing.*_ClsHead_0/Dense_0/bias"):
        from_jax_variables(model, missing)
    extra = random_jax_variables(model, seed=0)
    extra["batch_stats"]["SetAbstraction_0"]["FusedSetAbstraction_0"][
        "mean4"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="extra.*mean4"):
        from_jax_variables(model, extra)
    bad = random_jax_variables(model, seed=0)
    bad["params"]["SetAbstraction_1"]["FusedSetAbstraction_0"]["w1"] = (
        np.zeros((128, 128), np.float32))
    with pytest.raises(ValueError, match="w1"):
        from_jax_variables(model, bad)
    from_jax_variables(model, good)
    w = good["params"]["_ClsHead_0"]["DenseBNAct_0"]["Dense_0"]["kernel"]
    np.testing.assert_array_equal(
        model.head.fc1.dense.weight.detach().numpy(), w.T)


def test_fused_training_not_ported():
    """The name is from when training the fused set abstraction raised;
    it now checks that a train-mode forward and backward run on the CPU:
    finite logits, a gradient on every parameter, the running statistics
    of both fused layers moved."""
    model = get_cls_model("pointnet2", dropout=0.0)
    from_jax_variables(model, random_jax_variables(model, seed=3))
    model.train()
    before = model.sa1.fused.var1.clone(), model.sa2.fused.mean3.clone()
    x, nrm = _clouds(1, 4, 128)
    logits = model(torch.from_numpy(x), torch.from_numpy(nrm))
    assert logits.shape == (4, 40) and torch.isfinite(logits).all()
    logits.square().sum().backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
    assert model.sa1.fused.w1.grad.abs().sum() > 0
    assert not torch.equal(model.sa1.fused.var1, before[0])
    assert not torch.equal(model.sa2.fused.mean3, before[1])


def test_only_ported_models():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        get_cls_model("dgcnn")
