"""The port's part-segmentation decoder pieces against the JAX package,
on the CPU: the 3-NN interpolation (``three_interp_plain``, the
``ThreeInterp`` gradient), the row scatter-add (``scatter_rows_plain``),
``knn`` and ``FeaturePropagation``.

Inputs are numpy arrays from a seed, handed to both frameworks. The JAX
kernels run in Pallas interpret mode; the port runs the plain PyTorch
versions its wrappers take for CPU tensors.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudlib_tpu.nn.layers import (
    FeaturePropagation as JaxFeaturePropagation,
)
from pointcloudlib_tpu.ops.geometry import knn as jax_knn
from pointcloudlib_tpu.ops.pallas import gather as jgather
from pointcloudlib_tpu.ops.pallas.neighbors import (
    _three_interp_fwd_call,
    three_interp,
)

from pointcloudlib_tpu_torch import ops
from pointcloudlib_tpu_torch.nn.layers import FeaturePropagation
from pointcloudlib_tpu_torch.ops.kernels import gather as kga
from pointcloudlib_tpu_torch.ops.kernels import three_interp as kti


def _np(t):
    return t.detach().float().numpy()


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _duplicates(rng, b, n_distinct, n, m):
    """Support points with repeats (FPS asking for more centers than a
    cloud has gives them), and queries of which half are support points:
    exact d² ties, at 0 for those queries."""
    base = _normal(rng, b, n_distinct, 3)
    pts = base[:, rng.integers(0, n_distinct, n)]
    q = _normal(rng, b, m, 3)
    half = min(m, n) // 2
    q[:, :half] = pts[:, :half]
    return q, pts


CASES = {  # (B, M, N, C): the decoders' shapes and the coarse levels
    "fp1": (2, 64, 512, 128),
    "fp2": (2, 32, 128, 256),
    "n36": (1, 40, 36, 64),
    "n100": (1, 16, 100, 3),
}


@pytest.mark.parametrize("case", sorted(CASES) + ["duplicates"])
def test_three_interp_plain_matches_pallas(case):
    """``idx`` equal to the JAX kernel's bit for bit (three masked
    argmins, the lower index first on ties); ``out`` and ``w`` within the
    JAX kernel's own bound against the XLA route (rtol 2e-4, atol 5e-5,
    ``tests/test_three_interp.py``): it gathers features through a bf16
    hi/lo split, ~2^-16 relative."""
    rng = np.random.default_rng(sorted(CASES).index(case)
                                if case in CASES else 9)
    if case == "duplicates":
        q, p = _duplicates(rng, 2, 40, 128, 96)
        c = 32
    else:
        b, m, n, c = CASES[case]
        q, p = _normal(rng, b, m, 3), _normal(rng, b, n, 3)
    f = _normal(rng, *p.shape[:2], c)
    out, idx, w = kti.three_interp_plain(torch.from_numpy(q),
                                         torch.from_numpy(p),
                                         torch.from_numpy(f))
    jout, jidx, jw = _three_interp_fwd_call(jnp.asarray(q), jnp.asarray(p),
                                            jnp.asarray(f), True)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(_np(w), np.asarray(jw), rtol=2e-4, atol=5e-5)
    np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=2e-4,
                               atol=5e-5)
    if case == "duplicates":  # ties at d² = 0 were met and ordered
        d2 = ops.square_distance(torch.from_numpy(q), torch.from_numpy(p))
        assert ((d2 == 0).sum(-1) > 1).any()


def test_self_pair_is_a_hard_copy():
    """Queries equal to the support points (FPS subsets on the model's
    path): d² recomputed exactly is 0, so the output copies the support
    features (``tests/test_three_interp.py::test_self_pair_hard_copy``)."""
    rng = np.random.default_rng(7)
    p, f = _normal(rng, 1, 64, 3), _normal(rng, 1, 64, 32)
    out, idx, w = kti.three_interp_plain(torch.from_numpy(p),
                                         torch.from_numpy(p),
                                         torch.from_numpy(f))
    np.testing.assert_allclose(_np(out), f, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(idx[..., 0].numpy(), np.arange(64)[None])
    want = three_interp(jnp.asarray(p), jnp.asarray(p), jnp.asarray(f),
                        True)
    np.testing.assert_allclose(_np(out), np.asarray(want), rtol=2e-4,
                               atol=5e-5)


def test_three_interp_grad_matches_jax_vjp():
    """``ThreeInterp``'s gradient to the features against ``jax.vjp`` of
    the JAX kernel's custom VJP (rtol 2e-4, atol 2e-5, the JAX test's own
    bound); none flows to the queries or the support points."""
    rng = np.random.default_rng(3)
    q, p = _normal(rng, 2, 40, 3), _normal(rng, 2, 56, 3)
    f, co = _normal(rng, 2, 56, 24), _normal(rng, 2, 40, 24)
    tq, tp = (torch.from_numpy(a).requires_grad_() for a in (q, p))
    tf = torch.from_numpy(f).requires_grad_()
    out = ops.three_nn_interpolate(tq, tp, tf)
    (out * torch.from_numpy(co)).sum().backward()
    _, vjp = jax.vjp(lambda ff: three_interp(jnp.asarray(q), jnp.asarray(p),
                                             ff, True), jnp.asarray(f))
    (want,) = vjp(jnp.asarray(co))
    np.testing.assert_allclose(_np(tf.grad), np.asarray(want), rtol=2e-4,
                               atol=2e-5)
    assert tq.grad is None and tp.grad is None


@pytest.mark.parametrize("n,c", [(128, 40), (512, 40), (36, 40), (128, 1)],
                         ids=["128", "512", "36", "128-C1"])
def test_scatter_rows_plain_matches_pallas(n, c):
    """``scatter_rows_plain`` against the JAX ``scatter_rows``: at n=128
    and n=512 its Pallas kernel (interpret mode), at n=36 its XLA
    scatter-add (``n % 128 != 0``); C = 1 is PointConv's density
    gradient, the shape the port's kernel takes by its narrow route.
    Indices at and beyond n add nothing on both sides. The kernel adds g
    through a bf16 hi/lo split, ~2^-17 of each row (``gather.py``
    measures |Δ| up to 1.5e-5 on N(0, 1) data), so atol 5e-5 with rtol
    1e-5 on these sums of a few N(0, 1) rows."""
    rng = np.random.default_rng(n)
    b, m, k = 2, 48, 3
    g = _normal(rng, b, m, k, c)
    idx = rng.integers(0, n + 6, (b, m, k)).astype(np.int32)
    idx[0, 0] = [n, n + 3, 0]
    assert (idx >= n).sum() > 1
    got = ops.scatter_rows(torch.from_numpy(g), torch.from_numpy(idx), n)
    want = jgather.scatter_rows(jnp.asarray(g), jnp.asarray(idx), n, True)
    assert got.shape == (b, n, c) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=5e-5)
    kept = g.reshape(b, -1, c)[idx.reshape(b, -1) < n]
    np.testing.assert_allclose(_np(got).sum((0, 1)), kept.sum(0),
                               rtol=1e-4, atol=1e-4)


def test_scatter_rows_wrapper_is_the_plain_version_on_cpu():
    rng = np.random.default_rng(1)
    g = torch.from_numpy(_normal(rng, 2, 8, 3, 5))
    idx = torch.from_numpy(rng.integers(0, 20, (2, 8, 3)).astype(np.int32))
    assert torch.equal(kga.scatter_rows(g, idx, 16),
                       kga.scatter_rows_plain(g, idx, 16))
    with pytest.raises(ValueError, match="unsupported device"):
        kga.scatter_rows(g.to("meta"), idx.to("meta"), 16)
    with pytest.raises(ValueError, match="unsupported device"):
        kti.three_interp_fwd(*(torch.zeros((1, 4, 3), device="meta"),) * 3)


@pytest.mark.parametrize("k", [3, 8])
def test_knn_matches_jax(k):
    """Ascending d², the lower index first on ties (duplicate points), as
    ``lax.top_k`` orders them; more neighbours than points repeat the
    last."""
    rng = np.random.default_rng(k)
    q, p = _duplicates(rng, 2, 5, 6, 20)
    d2, idx = ops.knn(torch.from_numpy(q), torch.from_numpy(p), k)
    jd2, jidx = jax_knn(jnp.asarray(q), jnp.asarray(p), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(_np(d2), np.asarray(jd2), rtol=1e-6,
                               atol=1e-6)


def _fp_case(n_coarse, seed):
    """Inputs and flax variables of a FeaturePropagation([48, 32]) layer
    with random BN parameters and statistics, and the port's layer
    loaded with them."""
    rng = np.random.default_rng(seed)
    b, n_fine, c_fine, c_coarse = 2, 96, 12, 40
    xf, xc = _normal(rng, b, n_fine, 3), _normal(rng, b, n_coarse, 3)
    xc[:, : min(n_coarse, n_fine) // 2] = xf[:, : min(n_coarse, n_fine) // 2]
    ff, fc = _normal(rng, b, n_fine, c_fine), _normal(rng, b, n_coarse,
                                                      c_coarse)
    dims = [c_fine + c_coarse, 48, 32]
    params, stats = {}, {}
    port = FeaturePropagation(c_fine, c_coarse, dims[1:])
    for i, (cin, cout) in enumerate(zip(dims, dims[1:])):
        kern = rng.uniform(-1, 1, (cin, cout)).astype(np.float32) / np.sqrt(
            cin)
        scale = rng.uniform(0.8, 1.2, cout).astype(np.float32)
        bias, mean = (rng.normal(0, 0.1, cout).astype(np.float32)
                      for _ in range(2))
        var = rng.uniform(0.5, 1.5, cout).astype(np.float32)
        params[f"DenseBNAct_{i}"] = {"Dense_0": {"kernel": kern},
                                     "BatchNorm_0": {"scale": scale,
                                                     "bias": bias}}
        stats[f"DenseBNAct_{i}"] = {"BatchNorm_0": {"mean": mean,
                                                    "var": var}}
        blk = port.mlp[i]
        with torch.no_grad():
            blk.dense.weight.copy_(torch.from_numpy(kern.T))
            blk.bn.weight.copy_(torch.from_numpy(scale))
            blk.bn.bias.copy_(torch.from_numpy(bias))
            blk.bn.running_mean.copy_(torch.from_numpy(mean))
            blk.bn.running_var.copy_(torch.from_numpy(var))
    variables = {"params": {"PointMLP_0": params},
                 "batch_stats": {"PointMLP_0": stats}}
    return (xf, xc, ff, fc), variables, port


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("n_coarse", [1, 32])
def test_feature_propagation_matches_flax(n_coarse, training):
    """Eval and train mode, interpolated (32 coarse points, half of them
    fine points) and broadcast (1): the output within 1e-4 (f32 on both
    sides, sums in other orders); in training the updated running
    statistics within 1e-5."""
    arrays, variables, port = _fp_case(n_coarse, n_coarse)
    jm = JaxFeaturePropagation([48, 32])
    j_in = [jnp.asarray(a) for a in arrays]
    if training:
        want, mut = jm.apply(variables, *j_in, True, mutable=["batch_stats"])
    else:
        want = jm.apply(variables, *j_in, False)
    got = port.train(training)(*[torch.from_numpy(a) for a in arrays])
    assert got.shape == (2, 96, 32)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    if training:
        for i, blk in enumerate(port.mlp):
            bn = mut["batch_stats"]["PointMLP_0"][f"DenseBNAct_{i}"][
                "BatchNorm_0"]
            np.testing.assert_allclose(_np(blk.bn.running_mean), bn["mean"],
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(_np(blk.bn.running_var), bn["var"],
                                       rtol=0, atol=1e-5)
