"""The port's standalone ball query and the fused set-abstraction passes
that take a given neighbour index, against the JAX package, on the CPU.

Inputs are numpy arrays from a seed, handed to both frameworks. The JAX
kernels run in Pallas interpret mode; the port runs the plain PyTorch
versions its wrappers take for CPU tensors.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pointcloudlib_tpu.ops.pallas.fused_sa as jfs
from pointcloudlib_tpu.ops.pallas.neighbors import ball_query_pallas

from pointcloudlib_tpu_torch import ops
from pointcloudlib_tpu_torch.nn import layers
from pointcloudlib_tpu_torch.ops import geometry
from pointcloudlib_tpu_torch.ops.kernels import ball_query as kbq
from pointcloudlib_tpu_torch.ops.kernels import fused_sa as fs
from pointcloudlib_tpu_torch.ops.kernels import fused_sa_train as ft
from pointcloudlib_tpu_torch.ops.kernels.fused_sa import SAParams, SAStats

# MSG1's k=128 scale has C2 = 96; (16, 16, 32) keeps a second, cheap case
WIDTHS = [(16, 16, 32), (64, 96, 128)]


def _np(t):
    return t.detach().float().numpy()


def _tie_robust(got, want, what):
    """The bound of ``tests/test_torch_port_train_ops.py``: on values
    scaled by ``max|want|``, fewer than 0.5 % of the elements beyond
    1e-2 + 1e-2·|want| and a mean deviation below 3e-3 (a last-bit change
    of h3 can move a max-pool tie share to another slot)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-12)
    d = np.abs(got - want) / scale
    tol = 1e-2 + 1e-2 * np.abs(want) / scale
    assert (d > tol).mean() < 5e-3, (what, (d > tol).mean())
    assert d.mean() < 3e-3, (what, d.mean())


def _sphere(rng, b, n):
    x = rng.standard_normal((b, n, 3)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("n,m,radius,k,cut", [
    (128, 32, 0.4, 128, False),   # k = N: every row shorter than k
    (256, 64, 0.5, 16, True),     # most rows hold more than k hits
    (128, 16, 0.05, 8, False),    # most rows hold only the center itself
    (100, 24, 0.9, 16, True),     # N not a multiple of 32
])
def test_ball_query_matches_pallas(n, m, radius, k, cut):
    rng = np.random.default_rng(n + k)
    pts = _sphere(rng, 2, n)
    centers = pts[:, :m].copy()
    centers[0, 3] = 9.0  # an empty row: cnt 0, every slot at point 0
    got_i, got_c = ops.ball_query(torch.from_numpy(centers),
                                  torch.from_numpy(pts), radius, k)
    want_i, want_c = ball_query_pallas(jnp.asarray(centers),
                                       jnp.asarray(pts), radius, k,
                                       interpret=True)
    want_i, want_c = np.asarray(want_i), np.asarray(want_c)
    assert got_i.dtype == torch.int32 and got_c.dtype == torch.int32
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    assert got_c[0, 3] == 0 and (got_i[0, 3] == 0).all()
    assert (want_c < k).any()  # short rows are there
    assert (want_c > k).any() == cut  # and rows cut at k where meant


def _layer(seed, widths, b=2, n=128, m=32, k=128, radius=0.4):
    """A k=128 layer's inputs: clouds on the unit sphere (about 5 of 128
    points fall in a ball, so most slots repeat slot 0), one empty row,
    q and off from a random W1, SA parameters and running statistics."""
    rng = np.random.default_rng(seed)
    c1, c2, c3 = widths
    pts = _sphere(rng, b, n)
    nx = pts[:, :m].copy()
    nx[0, 0] = 50.0
    w1 = (rng.standard_normal((3, c1)) * 0.5).astype(np.float32)
    q = (pts @ w1 + rng.normal(0, 0.1, (b, n, c1))).astype(np.float32)
    off = (nx @ w1).astype(np.float32)

    def arr(*s, scale=1.0, base=0.0):
        return (base + rng.standard_normal(s) * scale).astype(np.float32)

    params = (arr(c1, c2, scale=1 / np.sqrt(c1)),
              arr(c2, c3, scale=1 / np.sqrt(c2)),
              arr(c1, scale=0.1, base=1), arr(c1, scale=0.1),
              arr(c2, scale=0.1, base=1), arr(c2, scale=0.1),
              arr(c3, scale=0.1, base=1), arr(c3, scale=0.1))
    stats = tuple(
        a for c in widths
        for a in (arr(c, scale=0.05),
                  rng.uniform(0.05, 0.5, c).astype(np.float32)))
    idx, cnt = geometry.ball_query(torch.from_numpy(nx),
                                   torch.from_numpy(pts), radius, k)
    assert int(cnt[0, 0]) == 0 and int(cnt.max()) < k
    return dict(q=q, off=off, idx=idx.numpy(), cnt=cnt.numpy(),
                params=params, stats=stats, co=arr(b, m, c3), n=n)


# the last case's radius holds only the center itself: every slot past 0
# is a replica of slot 0, which the card's kernel stores as a copy
@pytest.mark.parametrize("widths,radius", [(w, 0.4) for w in WIDTHS]
                         + [(WIDTHS[0], 1e-4)],
                         ids=["widths0", "widths1", "replicas"])
def test_sa_f1_matches_jax(widths, radius):
    L = _layer(0, widths, radius=radius)
    if radius < 1e-3:
        assert int((L["cnt"] == 1).sum()) == L["cnt"].size - 1
    h1, psum = ft.sa_f1(torch.from_numpy(L["q"]), torch.from_numpy(L["off"]),
                        torch.from_numpy(L["idx"]))
    jh1, jpsum = jfs._call_f1(jnp.asarray(L["q"]), jnp.asarray(L["idx"]),
                              jnp.asarray(L["off"]), True)
    assert h1.dtype == torch.bfloat16
    # one f32 subtraction and one rounding on both sides: bit-identical
    np.testing.assert_array_equal(_np(h1), np.asarray(jh1, np.float32))
    # sums of 8192 rows in another order
    np.testing.assert_allclose(_np(psum), np.asarray(jpsum[0]), rtol=1e-5,
                               atol=1e-5 * np.abs(jpsum).max())


def _patterned(seed, widths, k, cnt):
    """Eval inputs at B=2, M=32, N=128 whose ``cnt`` is given: center i
    holds ``cnt[i]`` hits, its first ``max(min(cnt, k), 1)`` slots
    distinct points, every later slot a repeat of slot 0, as the ball
    query leaves them (a row with cnt 0 is all point 0). The eval kernel
    pads each center's live slots to a multiple of 8 with such repeats, so
    these counts (0, every residue mod 8, above k) are what it rests on."""
    L = _layer(seed, widths)
    rng = np.random.default_rng(seed)
    b, m, n = 2, 32, L["n"]
    cnt = np.asarray(cnt, np.int32).reshape(b, m)
    idx = np.zeros((b, m, k), np.int32)
    for i in range(b):
        for j in range(m):
            live = max(min(int(cnt[i, j]), k), 1)
            first = rng.choice(n, live, replace=False) if cnt[i, j] else [0]
            idx[i, j, :live] = first
            idx[i, j, live:] = first[0]
    return {**L, "idx": idx, "cnt": cnt}


# (C1, C2, C3) = (32, 32, 64), cnt patterns of the eval kernel's padding:
# zeros, every residue mod 8, counts above k (every slot runs on the JAX
# side too) or all below it (the JAX kernel caps its slots)
EVAL_PATTERNS = {
    "pad-k16": (16, [0, 1, 2, 3, 4, 5, 6, 7, 9, 10, 11, 12, 13, 14, 15, 16,
                     17, 23, 40, 0] * 3 + [8, 1, 31, 2]),
    "pad-k64": (64, [0, 1, 2, 3, 4, 5, 6, 7, 9, 18, 27, 36, 45, 54, 63, 33,
                     41, 0, 12, 25] * 3 + [8, 57, 14, 22]),
}


@pytest.mark.parametrize("widths,with_cnt", [
    pytest.param(w, c, id=f"widths{i}-{c}")
    for i, w in enumerate(WIDTHS) for c in (False, True)
] + [pytest.param((32, 32, 64), name, id=name) for name in EVAL_PATTERNS])
def test_fused_sa_eval_matches_jax(widths, with_cnt):
    if with_cnt in EVAL_PATTERNS:
        k, cnt = EVAL_PATTERNS[with_cnt]
        L = _patterned(5, widths, k, cnt)
        assert {int(c) % 8 for c in L["cnt"].flat if 0 < c < k} >= set(
            range(1, 8)) and (L["cnt"] == 0).any()
        assert ((L["cnt"] > k).any() if k == 16
                else int(L["cnt"].max()) < k)
    else:
        L = _layer(1, widths)
    cnt_t = torch.from_numpy(L["cnt"]) if with_cnt else None
    got = fs.fused_sa_eval(
        torch.from_numpy(L["q"]).bfloat16(), torch.from_numpy(L["off"]),
        torch.from_numpy(L["idx"]),
        SAParams(*map(torch.from_numpy, L["params"])),
        SAStats(*map(torch.from_numpy, L["stats"])), cnt=cnt_t)
    want = jfs.fused_sa_eval(
        jnp.asarray(L["q"]), jnp.asarray(L["off"]), jnp.asarray(L["idx"]),
        jfs.SAParams(*map(jnp.asarray, L["params"])),
        jfs.SAStats(*map(jnp.asarray, L["stats"])), interpret=True,
        cnt=jnp.asarray(L["cnt"]) if with_cnt else None)
    assert got.shape == (2, 32, widths[2])
    # the same bf16 roundings; f32 products summed in another order can
    # move one bf16 rounding of y1 or y2
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-3,
                               atol=1e-3)


def test_fused_sa_train_matches_jax():
    """Forward, batch statistics and every gradient (dq, doff, dW2, dW3,
    dγ/dβ of the three layers) at k=128 with widths (64, 96, 128), the
    ball query's cnt passed on both sides."""
    L = _layer(2, (64, 96, 128))
    co = L["co"]

    def jloss(q, off, params):
        out, stats = jfs.fused_sa_train(
            q, off, jnp.asarray(L["idx"]), jfs.SAParams(*params), True,
            None, 1, jnp.asarray(L["cnt"]))
        return jnp.sum(out * co), (out, stats)

    (_, (jout, jstats)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(L["q"]), jnp.asarray(L["off"]),
        tuple(map(jnp.asarray, L["params"])))

    qt = torch.tensor(L["q"], requires_grad=True)
    offt = torch.tensor(L["off"], requires_grad=True)
    pt = SAParams(*[torch.tensor(a, requires_grad=True)
                    for a in L["params"]])
    idx = torch.from_numpy(L["idx"])
    out, stats = ft.fused_sa_train(qt, offt, idx, pt,
                                   cnt=torch.from_numpy(L["cnt"]))
    grads = torch.autograd.grad((out * torch.from_numpy(co)).sum(),
                                [qt, offt, *pt])
    assert grads[0].dtype == torch.float32  # q rounds inside: dq is f32
    # forward: the same roundings, BN sums in another order, amplified
    # through three 1/σ normalisations (as test_fused_sa.py:420)
    np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=5e-3,
                               atol=5e-3)
    for a, b_ in zip(stats, jstats):
        np.testing.assert_allclose(_np(a), np.asarray(b_), rtol=1e-3,
                                   atol=1e-5)
    for a, b_, name in zip(grads, jax.tree_util.tree_leaves(jg),
                           ["q", "off", *SAParams._fields]):
        _tie_robust(_np(a), b_, name)


def test_idx_backward_matches_autograd_of_reference():
    """The composed plain passes of the idx route (f1, tails, p1,
    ``_combine_p1``, p2, the dq and doff assembly) against torch autograd
    of ``fused_sa_idx_reference_plain`` at k=128: the hand-written
    backward's bf16 contraction operands are the only difference, so each
    gradient is within 3 % of its largest element."""
    L = _layer(3, (16, 16, 32))
    args = [torch.tensor(a, requires_grad=True)
            for a in (L["q"], L["off"], *L["params"])]
    idx, co = torch.from_numpy(L["idx"]), torch.from_numpy(L["co"])
    out, stats = ft.fused_sa_train(args[0], args[1], idx,
                                   SAParams(*args[2:]))
    ref, rstats = ft.fused_sa_idx_reference_plain(args[0], args[1], idx,
                                                  SAParams(*args[2:]))
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-5, atol=1e-5)
    for a, b_ in zip(stats, rstats):
        np.testing.assert_allclose(_np(a), _np(b_), rtol=1e-5, atol=1e-6)
    got = torch.autograd.grad((out * co).sum(), args)
    want = torch.autograd.grad((ref * co).sum(), args)
    for a, b_ in zip(got, want):
        scale = max(b_.abs().max().item(), 1e-4)
        np.testing.assert_allclose(_np(a), _np(b_), rtol=0.03,
                                   atol=0.03 * scale)


def test_two_routes_agree_after_pass_one():
    """From the ball query's own index, ``fused_sa_train`` and
    ``fused_sa_eval`` give what the routes with the ball query inside
    give: bit for bit on the CPU, where both run the same plain code."""
    rng = np.random.default_rng(4)
    pts = torch.from_numpy(_sphere(rng, 2, 128))
    nx = pts[:, :32].clone()
    L = _layer(4, (16, 16, 32))
    q, off = torch.from_numpy(L["q"]), torch.from_numpy(L["off"])
    p = SAParams(*map(torch.from_numpy, L["params"]))
    s = SAStats(*map(torch.from_numpy, L["stats"]))
    idx, cnt = geometry.ball_query(nx, pts, 0.4, 16)
    out_a, stats_a = ft.fused_sa_bq_train(nx, pts, q, off, p, 0.4, 16)
    out_b, stats_b = ft.fused_sa_train(q, off, idx, p, cnt=cnt)
    assert torch.equal(out_a, out_b)
    assert all(torch.equal(a, b_) for a, b_ in zip(stats_a, stats_b))
    ev_a = fs.fused_sa_bq_eval(nx, pts, q.bfloat16(), off, p, s, 0.4, 16)
    ev_b = fs.fused_sa_eval(q.bfloat16(), off, idx, p, s, cnt=cnt)
    assert torch.equal(ev_a, ev_b)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("n,k,fused", [(128, 64, True), (128, 128, False),
                                       (100, 16, False)])
def test_layer_routing_follows_jax(monkeypatch, n, k, fused, training):
    """``FusedSetAbstraction`` takes the kernels with the ball query
    inside iff no index is given, N % 128 == 0 and k ≤ 64
    (``nn/layers.py:278``); else it calls the ball query and the idx
    route. A given ``nidx`` always takes the idx route, without a ball
    query."""
    calls = []
    for name in ("ball_query", "fused_sa_bq_eval", "fused_sa_eval",
                 "fused_sa_bq_train", "fused_sa_train"):
        real = getattr(layers, name)
        monkeypatch.setattr(
            layers, name,
            lambda *a, _real=real, _name=name, **kw: (
                calls.append(_name), _real(*a, **kw))[1])
    rng = np.random.default_rng(n + k)
    xyz = torch.from_numpy(_sphere(rng, 2, n))
    feats = torch.from_numpy(_sphere(rng, 2, n))
    sa = layers.FusedSetAbstraction(3, (16, 16, 32), 32, 0.5, k)
    sa.train(training)
    new_xyz, out = sa(xyz, feats)
    assert out.shape == (2, 32, 32) and torch.isfinite(out).all()
    tail = "train" if training else "eval"
    want = ([f"fused_sa_bq_{tail}"] if fused
            else ["ball_query", f"fused_sa_{tail}"])
    assert calls == want
    calls.clear()
    nidx, _ = geometry.ball_query(new_xyz, xyz, 0.5, k)
    _, out2 = sa(xyz, feats, new_xyz=new_xyz, nidx=nidx)
    assert calls == [f"fused_sa_{tail}"]
    if not training:  # training moved the running statistics in between
        torch.testing.assert_close(out2, out)


def test_msg_layer_shares_one_fps(monkeypatch):
    calls = []
    real = layers.fps
    monkeypatch.setattr(layers, "fps", lambda *a, **kw: (
        calls.append(a[1]), real(*a, **kw))[1])
    msg = layers.SetAbstractionMSG(3, 16, [0.3, 0.6], [8, 128],
                                   [[16, 16, 32], [16, 16, 32]]).eval()
    rng = np.random.default_rng(0)
    xyz = torch.from_numpy(_sphere(rng, 2, 128))
    with torch.no_grad():
        new_xyz, out = msg(xyz, torch.from_numpy(_sphere(rng, 2, 128)))
    assert calls == [16]
    assert new_xyz.shape == (2, 16, 3) and out.shape == (2, 16, 64)
    with pytest.raises(NotImplementedError, match="unfused"):
        layers.SetAbstractionMSG(3, 16, [0.3], [8], [[16, 32]])


def test_wrappers_reject_other_devices():
    meta = torch.zeros((1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kbq.ball_query(meta[..., :3], meta[..., :3], 0.2, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        ft.sa_f1(meta.bfloat16(), meta, None)
    with pytest.raises(ValueError, match="unsupported device"):
        fs.fused_sa_eval(meta.bfloat16(), meta, None, None, None)
