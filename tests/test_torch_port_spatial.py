"""The port's Hilbert canonicalization and its N ≥ 4096 route against the
JAX package, on the CPU.

* ``hilbert_keys`` and the ``canonicalize`` order bit-identical to JAX's
  at B=4, N=4096, with a degenerate box (every point equal), duplicate
  points and a flat cloud; ``take_rows``/``unsort_rows``.
* The window gate (``window_width``) and the route it sets: at N % 128 ==
  0 and N ≥ 4096 the set abstraction takes the standalone ball query and
  the given-index kernels.
* Those kernels' plain versions against the JAX package's windowed
  kernels (``_k_f1w``, ``_k_p2w``, ``_k_evalw``), which compute what the
  given-index kernels compute: the JAX side runs in interpret mode with
  the window forced on at N=512 (``POINTCLOUDLIB_SA_WINDOW=1``, as
  ``tests/test_spatial.py`` does).
* The four step factories sort where the JAX steps sort, checked with a
  model that records what it is given and depends on the point order.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

import pointcloudlib_tpu.ops.pallas.fused_sa as jfs
from pointcloudlib_tpu.ops.pallas.fused_sa import _window_width
from pointcloudlib_tpu.ops.spatial import canonicalize as jax_canonicalize
from pointcloudlib_tpu.ops.spatial import hilbert_keys as jax_hilbert_keys
from pointcloudlib_tpu.ops.spatial import unsort_rows as jax_unsort_rows

from pointcloudlib_tpu_torch.nn.layers import FusedSetAbstraction
from pointcloudlib_tpu_torch.ops import geometry
from pointcloudlib_tpu_torch.ops.kernels import fused_sa as fs
from pointcloudlib_tpu_torch.ops.kernels import fused_sa_train as ft
from pointcloudlib_tpu_torch.ops.spatial import (
    canonicalize,
    hilbert_keys,
    take_rows,
    unsort_rows,
    window_width,
)
from pointcloudlib_tpu_torch.train import (
    make_cls_eval_step,
    make_cls_train_step,
    make_seg_eval_step,
    make_seg_train_step,
    sgd_momentum,
)
from pointcloudlib_tpu_torch.train.losses import (
    cross_entropy_seg,
    soft_cross_entropy,
)


def _clouds(case, b=4, n=4096, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, 3)).astype(np.float32)
    if case == "degenerate":      # every point equal: hi == lo
        x[:] = x[:, :1]
    elif case == "duplicates":    # each point twice: equal keys
        x[:, n // 2:] = x[:, :n // 2]
    elif case == "flat":          # one axis constant
        x[..., 2] = 0.25
    elif case == "scaled":        # a wide box, small offsets
        x = x * 1e3 + 7.0
    return x


@pytest.mark.parametrize("case", ["random", "degenerate", "duplicates",
                                  "flat", "scaled"])
def test_keys_and_order_bit_identical_to_jax(case):
    x = _clouds(case)
    keys = hilbert_keys(torch.from_numpy(x))
    assert keys.dtype == torch.int32
    np.testing.assert_array_equal(keys.numpy(),
                                  np.asarray(jax_hilbert_keys(jnp.asarray(x))))
    feats = np.random.default_rng(1).standard_normal(x.shape).astype(
        np.float32)
    got = canonicalize(torch.from_numpy(x), torch.from_numpy(feats), None)
    want = jax_canonicalize(jnp.asarray(x), jnp.asarray(feats))
    assert got[2] is None and got[-1].dtype == torch.int32
    np.testing.assert_array_equal(got[-1].numpy(), np.asarray(want[-1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_take_and_unsort_rows_round_trip():
    rng = np.random.default_rng(2)
    order = torch.from_numpy(np.stack([rng.permutation(300)
                                       for _ in range(3)]).astype(np.int32))
    for a in (torch.randn(3, 300, 5), torch.randint(0, 50, (3, 300))):
        sorted_ = take_rows(a, order)
        assert torch.equal(sorted_[1, 7], a[1, int(order[1, 7])])
        assert torch.equal(unsort_rows(sorted_, order), a)
    assert take_rows(None, order) is None


@pytest.mark.parametrize("n", [2048, 4000, 4160, 4096, 8192, 12288])
def test_window_gate_matches_jax(n):
    """None below 4096 and at N % 128 ≠ 0; the JAX width otherwise."""
    assert window_width(n) == _window_width(n)
    assert (window_width(n) is None) == (n % 128 != 0 or n < 4096)


def test_set_abstraction_route_at_4096():
    """SA1 of SSG at N=4096 takes the standalone ball query and the
    given-index kernels; SA2 (source N=512) keeps the ball query inside;
    MSG's k=128 scales take the given-index route at any N."""
    sa = FusedSetAbstraction(3, (64, 64, 128), 512, 0.2, 64)
    assert not sa.fuses_ball_query(4096)
    assert not sa.fuses_ball_query(8192)
    assert sa.fuses_ball_query(2048) and sa.fuses_ball_query(512)
    assert not FusedSetAbstraction(3, (64, 96, 128), 512, 0.4,
                                   128).fuses_ball_query(2048)


# ------------------------------------------- against the windowed kernels


def _line_layer(seed=0, b=2, n=512, m=128, k=16, widths=(16, 16, 32)):
    """A canonicalized cloud along a smooth curve (narrow index windows,
    as ``tests/test_spatial.py`` makes it) and one SA layer's inputs:
    ``q``, ``off``, the ball query's idx, parameters and statistics."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 1, (b, n)), axis=1)
    x = np.stack([t, np.sin(4 * t), np.cos(4 * t)], axis=-1)
    x = (x + rng.normal(0, 0.01, x.shape)).astype(np.float32)
    xyz = canonicalize(torch.from_numpy(x))[0]
    nx = geometry.index_points(xyz, geometry.farthest_point_sample(xyz, m))
    idx, _ = geometry.ball_query(nx, xyz, 0.25, k)
    c1, c2, c3 = widths
    w1 = (rng.standard_normal((3, c1)) * 0.5).astype(np.float32)
    q = (xyz.numpy() @ w1).astype(np.float32)
    off = (nx.numpy() @ w1).astype(np.float32)

    def arr(*s, scale=1.0, base=0.0):
        return (base + rng.standard_normal(s) * scale).astype(np.float32)

    params = (arr(c1, c2, scale=1 / np.sqrt(c1)),
              arr(c2, c3, scale=1 / np.sqrt(c2)),
              arr(c1, scale=0.1, base=1), arr(c1, scale=0.1),
              arr(c2, scale=0.1, base=1), arr(c2, scale=0.1),
              arr(c3, scale=0.1, base=1), arr(c3, scale=0.1))
    stats = tuple(a for c in widths
                  for a in (arr(c, scale=0.05),
                            rng.uniform(0.05, 0.5, c).astype(np.float32)))
    return dict(q=q, off=off, idx=idx.numpy(), params=params, stats=stats,
                co=arr(b, m, c3))


@pytest.fixture
def windowed(monkeypatch):
    """The JAX package with its window forced on, and the names of the
    windowed kernels it traced."""
    monkeypatch.setenv("POINTCLOUDLIB_SA_WINDOW", "1")
    jax.clear_caches()
    traced = []
    for name in ("_k_f1w", "_k_p2w", "_k_evalw"):
        kernel = getattr(jfs, name)

        def spy(*args, _k=kernel, _n=name, **kw):
            traced.append(_n)
            return _k(*args, **kw)

        monkeypatch.setattr(jfs, name, spy)
    yield traced
    jax.clear_caches()


def _tie_robust(got, want, what):
    """The train tests' bound (``tests/test_torch_port_msg_ops.py``): on
    values scaled by ``max|want|``, fewer than 0.5 % of the elements
    beyond 1e-2 + 1e-2·|want| and a mean deviation below 3e-3."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-12)
    d = np.abs(got - want) / scale
    assert (d > 1e-2 + 1e-2 * np.abs(want) / scale).mean() < 5e-3, what
    assert d.mean() < 3e-3, (what, d.mean())


def test_train_plain_matches_windowed_kernels(windowed):
    """``fused_sa_train`` (plain ``sa_f1``, tails, ``sa_bwd_p1`` and
    ``sa_bwd_p2``) against the JAX train path through ``_k_f1w`` and
    ``_k_p2w``: forward, batch statistics and every gradient."""
    assert _window_width(512) == 128
    L = _line_layer(0)

    def jloss(q, off, params):
        out, stats = jfs.fused_sa_train(q, off, jnp.asarray(L["idx"]),
                                        jfs.SAParams(*params), True, None, 1)
        return jnp.sum(out * L["co"]), (out, stats)

    (_, (jout, jstats)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(L["q"]), jnp.asarray(L["off"]),
        tuple(map(jnp.asarray, L["params"])))
    assert {"_k_f1w", "_k_p2w"} <= set(windowed)

    qt = torch.tensor(L["q"], requires_grad=True)
    offt = torch.tensor(L["off"], requires_grad=True)
    pt = fs.SAParams(*[torch.tensor(a, requires_grad=True)
                       for a in L["params"]])
    out, stats = ft.fused_sa_train(qt, offt, torch.from_numpy(L["idx"]), pt)
    grads = torch.autograd.grad((out * torch.from_numpy(L["co"])).sum(),
                                [qt, offt, *pt])
    # the windowed kernels sum in another order than the JAX package's own
    # given-index kernels, and a bf16 rounding of y1 or y2 that moves
    # with it moves a pooled output: on these inputs the JAX package's
    # windowed and unwindowed forwards differ by 0.021 at 0.04 % of the
    # elements (|out| ≤ 5.0), the port and the unwindowed one by 2e-6.
    # So the pooled output takes the tie-robust bound of the gradients.
    _tie_robust(out.detach().numpy(), jout, "out")
    for a, b_ in zip(stats, jstats):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=1e-3,
                                   atol=1e-5)
    for a, b_, name in zip(grads, jax.tree_util.tree_leaves(jg),
                           ["q", "off", *fs.SAParams._fields]):
        _tie_robust(a.numpy(), b_, name)


def test_f1_plain_matches_windowed_kernel(windowed):
    """``sa_f1``'s plain version against ``_call_f1`` through ``_k_f1w``:
    h1 bit-identical (one f32 subtraction and one rounding on both
    sides), the sums within f32 rounding."""
    L = _line_layer(1)
    h1, psum = ft.sa_f1(torch.from_numpy(L["q"]), torch.from_numpy(L["off"]),
                        torch.from_numpy(L["idx"]))
    jh1, jpsum = jfs._call_f1(jnp.asarray(L["q"]), jnp.asarray(L["idx"]),
                              jnp.asarray(L["off"]), True)
    assert windowed == ["_k_f1w"]
    np.testing.assert_array_equal(h1.float().numpy(),
                                  np.asarray(jh1, np.float32))
    np.testing.assert_allclose(psum.numpy(), np.asarray(jpsum[0]),
                               rtol=1e-5, atol=1e-5 * np.abs(jpsum).max())


def test_eval_plain_matches_windowed_kernel(windowed):
    L = _line_layer(2)
    got = fs.fused_sa_eval(
        torch.from_numpy(L["q"]).bfloat16(), torch.from_numpy(L["off"]),
        torch.from_numpy(L["idx"]),
        fs.SAParams(*map(torch.from_numpy, L["params"])),
        fs.SAStats(*map(torch.from_numpy, L["stats"])))
    want = jfs.fused_sa_eval(
        jnp.asarray(L["q"]), jnp.asarray(L["off"]), jnp.asarray(L["idx"]),
        jfs.SAParams(*map(jnp.asarray, L["params"])),
        jfs.SAStats(*map(jnp.asarray, L["stats"])), interpret=True)
    assert "_k_evalw" in windowed
    # test_fused_sa_eval_matches_jax's bound
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-3)


# ------------------------------------------------- the step factories


class _Recorder(nn.Module):
    """An order-dependent stand-in model that keeps what it was given:
    classification logits from the first point, per-point part logits
    from a running sum along the points."""

    def __init__(self, seg: bool):
        super().__init__()
        self.seg = seg
        self.lin = nn.Linear(6, 50 if seg else 40)
        self.seen = None

    def forward(self, xyz, *rest, generator=None):
        feats = rest[-1]
        self.seen = (xyz.clone(), feats.clone())
        both = torch.cat([xyz, feats], dim=-1)
        if self.seg:
            return self.lin(both.cumsum(dim=1) / both.shape[1])
        return self.lin(both[:, 0])


def _step_batch(n=4096, b=2):
    rng = np.random.default_rng(5)
    xyz = rng.standard_normal((b, n, 3)).astype(np.float32)
    return {"xyz": xyz,
            "feats": rng.standard_normal((b, n, 3)).astype(np.float32),
            "label": np.array([3, 7]), "seg": rng.integers(0, 50, (b, n)),
            "cls_onehot": np.eye(16, dtype=np.float32)[[1, 4]]}


def _jax_sorted(batch):
    """The batch as the JAX step sorts it (``_canon_batch``), and the
    order."""
    xyz, feats, seg, order = jax_canonicalize(
        jnp.asarray(batch["xyz"]), jnp.asarray(batch["feats"]),
        jnp.asarray(batch["seg"]))
    return ({"xyz": np.array(xyz), "feats": np.array(feats),
             "seg": np.array(seg)}, order)


def _saw(model, want):
    xyz, feats = model.seen
    np.testing.assert_array_equal(xyz.numpy(), want["xyz"])
    np.testing.assert_array_equal(feats.numpy(), want["feats"])


@pytest.mark.parametrize("factory", ["cls_train", "cls_eval", "seg_train",
                                     "seg_eval"])
def test_factories_sort_as_jax(factory):
    """Each factory hands the model the batch in the JAX step's sorted
    order at N=4096: points and features bit-identical, part labels
    sorted along (the loss agrees with the loss on the sorted batch and
    not with the loss on the given one), the seg eval step's ids back in
    the caller's order. At N=4000 nothing is sorted."""
    batch = _step_batch()
    want, order = _jax_sorted(batch)
    torch.manual_seed(0)
    model = _Recorder(seg=factory.startswith("seg"))

    def outputs(inputs):
        with torch.no_grad():
            xyz = torch.from_numpy(inputs["xyz"])
            feats = torch.from_numpy(inputs["feats"])
            if not model.seg:
                logits = model(xyz, feats)
                return logits, soft_cross_entropy(
                    logits, torch.from_numpy(batch["label"]))
            logits = model(xyz, None, feats)
            return logits, cross_entropy_seg(
                logits, torch.from_numpy(inputs["seg"]).long())

    logits, loss = outputs(want)
    _, loss_given = outputs(batch)
    # the order matters here; the seg step averages by sum / count
    assert abs(float(loss - loss_given)) > 1e-4 * abs(float(loss))
    opt = sgd_momentum(model.parameters(), 0.0)
    if factory == "cls_train":
        got = make_cls_train_step(model, opt, device="cpu")(batch)["loss"]
        torch.testing.assert_close(got, loss, rtol=0, atol=0)
    elif factory == "seg_train":
        got = make_seg_train_step(model, opt, device="cpu")(batch)["loss"]
        torch.testing.assert_close(got, loss, rtol=1e-6, atol=0)
    elif factory == "cls_eval":
        make_cls_eval_step(model, device="cpu")(batch)
    else:
        pred = make_seg_eval_step(model, device="cpu")(batch)
        np.testing.assert_array_equal(
            pred.numpy(), np.asarray(jax_unsort_rows(
                jnp.asarray(logits.argmax(-1).numpy()), order)))
    _saw(model, want)

    short = {k: (v[:, :4000] if k in ("xyz", "feats", "seg") else v)
             for k, v in batch.items()}
    if factory.endswith("eval"):
        step = (make_cls_eval_step if factory == "cls_eval"
                else make_seg_eval_step)(model, device="cpu")
    else:
        step = (make_cls_train_step if factory == "cls_train"
                else make_seg_train_step)(model, opt, device="cpu")
    step(short)
    _saw(model, short)
