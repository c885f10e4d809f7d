"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``; without a card every test skips (the ``card``
fixture decides at run time, so every test worker collects the same
tests). On a machine with an NVIDIA GPU, from the repository root:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -m cuda -q

(``--noconftest``: ``tests/conftest.py`` sets up JAX, which a GPU
machine serving the port need not have.)
"""

import numpy as np
import pytest
import torch

from pointcloudlib_tpu_torch.inference import Predictor
from pointcloudlib_tpu_torch.models import get_cls_model
from pointcloudlib_tpu_torch.ops.kernels import ball_query as kbq
from pointcloudlib_tpu_torch.ops.kernels import fps as kfps
from pointcloudlib_tpu_torch.ops.kernels import fused_sa as kfs
from pointcloudlib_tpu_torch.utils.interop import random_jax_variables

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


def _sphere(rng, b, n, dev):
    x = rng.standard_normal((b, n, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("b,n,m,skip,n_near", [
    (4, 1024, 512, True, 0),
    (3, 512, 128, True, 0),
    (2, 1024, 1024, True, 0),      # m = N
    (2, 100, 37, True, 0),         # N below one warp multiple
    (2, 1000, 700, True, 500),     # m > eligible points
    (2, 1000, 300, False, 500),    # near-origin points, no skip
    (1, 4096, 256, True, 100),
])
def test_fps_bit_identical(card, b, n, m, skip, n_near):
    rng = np.random.default_rng(n + m)
    x = _sphere(rng, b, n, card)
    x[:, n - n_near:] *= 1e-3
    before = kfps.fps.launches
    got = kfps.fps(x, m, skip)
    torch.cuda.synchronize()
    assert kfps.fps.launches == before + 1
    assert torch.equal(got, kfps.fps_plain(x, m, skip))


def _sa(rng, dev, c1, c2, c3):
    def u(*s):
        return torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32)
                                / np.sqrt(s[0])).to(dev)

    def pos(c):
        return torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(
            np.float32)).to(dev)

    def small(c):
        return torch.from_numpy(rng.normal(0, 0.1, c).astype(
            np.float32)).to(dev)

    params = kfs.SAParams(u(c1, c2), u(c2, c3), pos(c1), small(c1), pos(c2),
                          small(c2), pos(c3), small(c3))
    stats = kfs.SAStats(small(c1), pos(c1) * 0.1, small(c2), pos(c2) * 0.1,
                        small(c3), pos(c3) * 0.1)
    return params, stats


@pytest.mark.parametrize("widths,b,n,m,radius,k", [
    ((64, 64, 128), 4, 1024, 512, 0.2, 64),
    ((128, 128, 256), 4, 512, 128, 0.4, 64),
    ((64, 64, 128), 2, 300, 70, 0.3, 16),   # ragged tile, N % 32 != 0
])
def test_bq_eval_matches_plain(card, widths, b, n, m, radius, k):
    rng = np.random.default_rng(sum(widths) + n)
    c1, c2, c3 = widths
    pts = _sphere(rng, b, n, card)
    nx = pts[:, :m].clone()
    nx[0, 0] = 50.0                         # an empty row
    q = (pts @ torch.from_numpy(rng.standard_normal((3, c1)).astype(
        np.float32)).to(card)).bfloat16()
    off = torch.from_numpy(rng.normal(0, 0.3, (b, m, c1)).astype(
        np.float32)).to(card)
    params, stats = _sa(rng, card, c1, c2, c3)
    before = kfs.fused_sa_bq_eval.launches
    got = kfs.fused_sa_bq_eval(nx, pts, q, off, params, stats, radius, k)
    torch.cuda.synchronize()
    assert kfs.fused_sa_bq_eval.launches == before + 1
    want = kfs.fused_sa_bq_eval_plain(nx, pts, q, off, params, stats,
                                      radius, k)
    # the same bf16 roundings; the kernel's f32 dot products sum in
    # another order than the plain matmul, which can move one bf16
    # rounding of y1/y2 by one unit
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)


def test_bq_eval_rejects_what_it_cannot_run(card):
    pts = torch.zeros((1, 64, 3), device=card)
    params, stats = _sa(np.random.default_rng(0), card, 16, 16, 32)
    q = torch.zeros((1, 64, 16), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel instance"):
        kfs.fused_sa_bq_eval(pts, pts, q, q.float(), params, stats, 0.2, 8)
    params, stats = _sa(np.random.default_rng(0), card, 64, 64, 128)
    with pytest.raises(TypeError, match="bfloat16"):
        kfs.fused_sa_bq_eval(pts, pts, torch.zeros((1, 64, 64), device=card),
                             torch.zeros((1, 64, 64), device=card), params,
                             stats, 0.2, 8)


@pytest.mark.parametrize("model", ["pointnet2", "pointnet2_msg"])
@pytest.mark.parametrize("n", [100, 2000])
def test_predictor_card_matches_cpu(card, n, model):
    """Smallest and largest served buckets (128: SA1 samples more
    centers than points; 2048) through the serving kernels on the card
    (SSG: FPS and the ball-query eval kernel; MSG: those, the ball query
    and the eval kernel that takes its index), against the plain path on
    the CPU; the card's dense layers use bf16 operands, the CPU's f32."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    nrm = rng.standard_normal((3, n, 3)).astype(np.float32)
    variables = random_jax_variables(get_cls_model(model), seed=n)
    got = Predictor.from_variables(model, variables, batch_size=2,
                                   device=card).predict_proba(x, nrm)
    want = Predictor.from_variables(model, variables, batch_size=2,
                                    device="cpu").predict_proba(x, nrm)
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)


# ------------------------------- ball query and the kernels that take idx


@pytest.mark.parametrize("b,n,m,radius,k", [
    (4, 1024, 512, 0.4, 128),     # MSG1's k=128 scale: most rows short
    (4, 512, 128, 0.8, 128),      # MSG2's: cnt above and below k
    (2, 1000, 70, 0.3, 16),       # N % 32 != 0, ragged center tile
    (2, 128, 33, 0.4, 128),       # k = N: every row short
    (2, 300, 64, 2.5, 8),         # every point a hit: cnt = N > k
    (1, 37, 5, 0.5, 64),          # N just above one warp, k > N
])
def test_ball_query_bit_identical(card, b, n, m, radius, k):
    rng = np.random.default_rng(n + k)
    pts = _sphere(rng, b, n, card)
    nx = pts[:, :m].clone()
    nx[0, 0] = 50.0                         # an empty row
    before = kbq.ball_query.launches
    idx, cnt = kbq.ball_query(nx, pts, radius, k)
    torch.cuda.synchronize()
    assert kbq.ball_query.launches == before + 1
    want_idx, want_cnt = kbq.ball_query_plain(nx, pts, radius, k)
    assert int(cnt[0, 0]) == 0 and (idx[0, 0] == 0).all()
    assert idx.dtype == torch.int32 and cnt.dtype == torch.int32
    assert torch.equal(cnt, want_cnt)
    assert torch.equal(idx, want_idx)


IDX_SHAPES = {  # widths, B, N, M, radius, k
    "msg1_k128": ((64, 96, 128), 4, 1024, 512, 0.4, 128),
    "msg2_k128": ((128, 128, 256), 4, 512, 128, 0.8, 128),
    "c32_k16": ((32, 32, 64), 2, 300, 70, 0.3, 16),   # ragged center tile
}


def _idx_layer(card, name):
    widths, b, n, m, radius, k = IDX_SHAPES[name]
    c1, c2, c3 = widths
    rng = np.random.default_rng(sum(widths) + k)
    pts = _sphere(rng, b, n, card)
    nx = pts[:, :m].clone()
    nx[0, 0] = 50.0
    q = pts @ torch.from_numpy(rng.standard_normal((3, c1)).astype(
        np.float32)).to(card)
    off = torch.from_numpy(rng.normal(0, 0.3, (b, m, c1)).astype(
        np.float32)).to(card)
    idx, cnt = kbq.ball_query_plain(nx, pts, radius, k)
    params, stats = _sa(rng, card, c1, c2, c3)
    return q, off, idx, cnt, params, stats


@pytest.mark.parametrize("name", sorted(IDX_SHAPES))
def test_sa_f1_matches_plain(card, name):
    from pointcloudlib_tpu_torch.ops.kernels import fused_sa_train as ft

    q, off, idx, _, _, _ = _idx_layer(card, name)
    before = ft.sa_f1.launches
    h1, psum = ft.sa_f1(q.bfloat16(), off, idx)
    torch.cuda.synchronize()
    assert ft.sa_f1.launches == before + 1
    want_h1, want_psum = ft.sa_f1_plain(q.bfloat16(), off, idx)
    # one f32 subtraction and one rounding on both sides
    assert torch.equal(h1.view(torch.int16), want_h1.view(torch.int16))
    _close_sums(psum, want_psum, "psum1")


@pytest.mark.parametrize("with_cnt", [True, False])
@pytest.mark.parametrize("name", sorted(IDX_SHAPES))
def test_sa_eval_idx_matches_plain(card, name, with_cnt):
    q, off, idx, cnt, params, stats = _idx_layer(card, name)
    q = q.bfloat16()
    before = kfs.fused_sa_eval.launches
    got = kfs.fused_sa_eval(q, off, idx, params, stats,
                            cnt=cnt if with_cnt else None)
    torch.cuda.synchronize()
    assert kfs.fused_sa_eval.launches == before + 1
    want = kfs.fused_sa_eval_plain(q, off, idx, params, stats)
    # the ball-query eval kernel's bound: one bf16 rounding may move
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)


def test_fused_sa_train_idx_matches_bq_route(card):
    """The two routes share everything after pass 1: from the same
    neighbours, the forward, the batch statistics and every gradient of
    ``fused_sa_train`` agree with ``fused_sa_bq_train``. Not bit for bit,
    and not the same from run to run: the BN sums are added by atomics in
    another order on every launch, a last-bit change of a folded BN row
    moves a bf16 rounding of y1 here and there, and that can move a
    max-pool winner, which reroutes one center's gradient to another
    point (128 of dq's 38,400 elements at this shape). Of 15 runs on an
    H100, 12 agreed to a cosine of 1 − 4e-7 or better and 3 read a cosine
    of 0.99961 and a norm 0.35 % off at worst (``bn1_bias``). Each
    gradient is held to a cosine of 0.995 and a norm within 2 %, which a
    wrong wiring of the gradients would miss by far."""
    from pointcloudlib_tpu_torch.ops.kernels import fused_sa_train as ft

    L = _train_layer(card, "sa1_k16")
    p = L["p"]
    co = torch.randn(L["dout"].shape, device=card,
                     generator=torch.Generator(device=card).manual_seed(0))

    def run(fn, front):
        q = L["q"].clone().requires_grad_()
        off = L["off"].clone().requires_grad_()
        ps = kfs.SAParams(*[t.clone().requires_grad_() for t in p])
        out, stats = fn(*front(q, off), ps)
        grads = torch.autograd.grad((out * co).sum(), [q, off, *ps])
        return out, stats, grads

    out_a, stats_a, g_a = run(
        lambda *a: ft.fused_sa_bq_train(*a, L["radius"], L["k"]),
        lambda q, off: (L["nx"], L["pts"], q, off))
    out_b, stats_b, g_b = run(
        ft.fused_sa_train, lambda q, off: (q, off, L["idx"]))
    torch.testing.assert_close(out_b, out_a, rtol=1e-2, atol=1e-2)
    for a, b_ in zip(stats_a, stats_b):
        torch.testing.assert_close(b_, a, rtol=1e-3, atol=1e-5)
    readings = {}
    for a, b_, what in zip(g_a, g_b, ["q", "off", *kfs.SAParams._fields]):
        a, b_ = a.double().ravel(), b_.double().ravel()
        readings[what] = (float(a @ b_ / (a.norm() * b_.norm())),
                          float(b_.norm() / a.norm()))
    print("idx route against bq route, (cosine, norm ratio):", readings)
    for what, (cos, ratio) in readings.items():
        assert cos >= 0.995 and abs(ratio - 1) <= 0.02, (what, cos, ratio)


# ------------------------------------------------ train slice kernels

TRAIN_SHAPES = {  # widths, B, N, M, radius, k
    "sa1": ((64, 64, 128), 4, 1024, 512, 0.2, 64),
    "sa2": ((128, 128, 256), 4, 512, 128, 0.4, 64),
    "sa1_k16": ((64, 64, 128), 2, 300, 96, 0.3, 16),  # N % 32 != 0
    # PointNet++ MSG's other widths and k: one row a thread at C1 = 32,
    # 12 channel groups at C2 = 96, and k = 128, where a center spans two
    # 64-row tiles and most of its slots are replicas of slot 0
    "msg1_k16": ((32, 32, 64), 4, 1024, 512, 0.1, 16),
    "msg1_k128": ((64, 96, 128), 2, 1024, 512, 0.4, 128),
    "msg2_k128": ((128, 128, 256), 4, 512, 128, 0.8, 128),
}


def _train_layer(card, name, seed=0):
    """Kernel inputs at a train shape, made with the plain versions on
    the card: clouds on the unit sphere, an empty ball-query row, the
    bf16 h1, folded BN rows from its statistics, an output gradient."""
    from pointcloudlib_tpu_torch.ops.kernels import fused_sa_train as ft

    widths, b, n, m, radius, k = TRAIN_SHAPES[name]
    c1, c2, c3 = widths
    rng = np.random.default_rng(seed)
    pts = _sphere(rng, b, n, card)
    nx = pts[:, :m].clone()
    nx[0, 0] = 50.0
    w1 = torch.from_numpy(rng.standard_normal((3, c1)).astype(
        np.float32)).to(card)
    q = pts @ w1
    off = nx @ w1
    params = kfs.SAParams(*[t.float() for t in _sa(rng, card, c1, c2,
                                                  c3)[0]])
    idx, h1, cnt, psum = ft.bq_f1_plain(nx, pts, q.bfloat16(), off, radius,
                                        k)
    r = float(b * m * k)
    st1 = kfs._stack_stats(*ft._moments(psum, r), params.g1, params.b1)
    st2 = kfs._stack_stats(*ft._moments(ft.sa_tail_plain(
        2, h1, st1, None, None, params.w2, params.w3), r), params.g2,
        params.b2)
    st3 = kfs._stack_stats(*ft._moments(ft.sa_tail_plain(
        3, h1, st1, st2, None, params.w2, params.w3), r), params.g3,
        params.b3)
    dout = torch.from_numpy(rng.standard_normal((b, m, c3)).astype(
        np.float32)).to(card)
    return dict(ft=ft, nx=nx, pts=pts, q=q, off=off, p=params, idx=idx,
                h1=h1, cnt=cnt, psum=psum, st=(st1, st2, st3), dout=dout,
                radius=radius, k=k, n=n, r=r)


def _tie_robust(got, want, what):
    """Scaled by max|want|: fewer than 0.5 % of the elements beyond
    1e-2 + 1e-2·|want| and a mean deviation below 3e-3 — a last-bit
    change of h3 may move a max-pool tie share between slots
    (``tests/test_fused_sa.py:435-444``)."""
    got = got.double().cpu().numpy()
    want = want.double().cpu().numpy()
    scale = max(np.abs(want).max(), 1e-12)
    d = np.abs(got - want) / scale
    tol = 1e-2 + 1e-2 * np.abs(want) / scale
    assert (d > tol).mean() < 5e-3, (what, (d > tol).mean())
    assert d.mean() < 3e-3, (what, d.mean())


def _close_sums(got, want, what):
    """f32 sums over up to 2M rows in another order (atomics): 1e-3 of
    the largest element."""
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-3 * want.abs().max().item(),
                               msg=what)


@pytest.mark.parametrize("name", sorted(TRAIN_SHAPES))
def test_bq_f1_matches_plain(card, name):
    L = _train_layer(card, name)
    ft = L["ft"]
    before = ft.bq_f1.launches
    idx, h1, cnt, psum = ft.bq_f1(L["nx"], L["pts"], L["q"].bfloat16(),
                                  L["off"], L["radius"], L["k"])
    torch.cuda.synchronize()
    assert ft.bq_f1.launches == before + 1
    assert int(cnt[0, 0]) == 0
    assert torch.equal(idx, L["idx"]) and torch.equal(cnt, L["cnt"])
    assert torch.equal(h1.view(torch.int16), L["h1"].view(torch.int16))
    _close_sums(psum, L["psum"], "psum1")


@pytest.mark.parametrize("stage", [2, 3, 4])
@pytest.mark.parametrize("name", sorted(TRAIN_SHAPES))
def test_tail_matches_plain(card, name, stage):
    L = _train_layer(card, name, seed=1)
    ft, p, (st1, st2, st3) = L["ft"], L["p"], L["st"]
    before = ft.sa_tail.launches
    got = ft.sa_tail(stage, L["h1"], st1, st2, st3, p.w2, p.w3)
    torch.cuda.synchronize()
    assert ft.sa_tail.launches == before + 1
    want = ft.sa_tail_plain(stage, L["h1"], st1, st2, st3, p.w2, p.w3)
    if stage == 4:  # the eval kernel's bound: one bf16 rounding may move
        torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)
    else:
        _close_sums(got, want, f"stage {stage}")


@pytest.mark.parametrize("name", sorted(TRAIN_SHAPES))
def test_bwd_p1_matches_plain(card, name):
    L = _train_layer(card, name, seed=2)
    ft, p, (st1, st2, st3) = L["ft"], L["p"], L["st"]
    before = ft.sa_bwd_p1.launches
    got = ft.sa_bwd_p1(L["h1"], L["dout"], st1, st2, st3, p.w2, p.w3)
    torch.cuda.synchronize()
    assert ft.sa_bwd_p1.launches == before + 1
    want = ft.sa_bwd_p1_plain(L["h1"], L["dout"], st1, st2, st3, p.w2,
                              p.w3)
    for a, b_, what in zip(got, want, ("ps3", "vecs", "mats")):
        _tie_robust(a, b_, what)


@pytest.mark.parametrize("name", sorted(TRAIN_SHAPES))
def test_bwd_p2_matches_plain(card, name):
    L = _train_layer(card, name, seed=3)
    ft, p, (st1, st2, st3) = L["ft"], L["p"], L["st"]
    ps3, vecs, mats = ft.sa_bwd_p1_plain(L["h1"], L["dout"], st1, st2, st3,
                                         p.w2, p.w3)
    _, s2 = ft._combine_p1(ps3, vecs, mats, st3, p.w3, L["r"])
    args = (L["h1"], L["dout"], L["idx"], st1, st2, st3, p.w2, p.w3,
            ps3 / L["r"], s2 / L["r"], L["n"])
    before = ft.sa_bwd_p2.launches
    got = ft.sa_bwd_p2(*args)
    torch.cuda.synchronize()
    assert ft.sa_bwd_p2.launches == before + 1
    want = ft.sa_bwd_p2_plain(*args)
    c1 = L["h1"].shape[-1]
    assert torch.equal(got[2][..., 2 * c1], want[2][..., 2 * c1])  # counts
    for a, b_, what in zip(got, want, ("dw2", "ps1", "scat", "d1", "d2")):
        _tie_robust(a, b_, what)


def test_train_kernels_reject_what_they_cannot_run(card):
    from pointcloudlib_tpu_torch.ops.kernels import fused_sa_train as ft

    params, _ = _sa(np.random.default_rng(0), card, 64, 64, 128)
    h1 = torch.zeros((1, 8, 24, 64), device=card, dtype=torch.bfloat16)
    st = torch.zeros((4, 64), device=card)
    with pytest.raises(ValueError, match="k in"):
        ft.sa_tail(2, h1, st, None, None, params.w2, params.w3)
    params, _ = _sa(np.random.default_rng(0), card, 16, 16, 32)
    with pytest.raises(ValueError, match="no kernel instance"):
        ft.sa_tail(2, torch.zeros((1, 8, 8, 16), device=card,
                                  dtype=torch.bfloat16),
                   st[:, :16], None, None, params.w2, params.w3)


@pytest.mark.parametrize("model_name", ["pointnet2", "pointnet2_msg"])
def test_train_step_card_matches_cpu(card, model_name):
    """One train-mode forward and backward of PointNet++ SSG and MSG on 8
    clouds at N=1024, on the card (the kernels, bf16 dense operands) and
    on the CPU (the plain versions, f32 dense layers), from the same
    weights with dropout 0: the loss within 1e-2 relative, each
    parameter's gradient at cosine ≥ 0.85 with a norm within 15 % (SSG)
    or 25 % (MSG); ``tools/grad_check.py`` holds the bounds, says why
    they differ and which gradients are exactly 0 and not compared. On
    these sphere-shell clouds every pooled output of MSG's two k=128
    scales is positive, so their last BN biases are such gradients;
    nothing else may go uncompared but SA3's last BN bias. ``pytest -s``
    shows the readings."""
    from pointcloudlib_tpu_torch.tools.grad_check import grad_agreement

    rng = np.random.default_rng(11)
    x = rng.standard_normal((8, 1024, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    nrm = rng.standard_normal((8, 1024, 3)).astype(np.float32)
    batch = {"xyz": torch.from_numpy(x), "feats": torch.from_numpy(nrm),
             "label": torch.from_numpy(rng.integers(0, 40, 8))}
    variables = random_jax_variables(get_cls_model(model_name), seed=5)
    got = grad_agreement(model_name, variables, batch, card)
    agree = got["agree"]
    print(model_name, "card against CPU: least cosine",
          min(agree.items(), key=lambda kv: kv[1][0]),
          "largest norm deviation",
          max(agree.items(), key=lambda kv: abs(kv[1][1] - 1)),
          "not compared", got["not_compared"])
    assert not got["failures"], got["failures"]
    allowed = {"sa3.mlp.2.bn.bias"}
    if model_name == "pointnet2_msg":
        allowed |= {"sa1.scales.2.bn3_bias", "sa2.scales.2.bn3_bias"}
    assert set(got["not_compared"]) <= allowed, got["not_compared"]
