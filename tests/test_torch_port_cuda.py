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
from pointcloudlib_tpu_torch.utils.interop import (
    from_jax_variables,
    random_jax_variables,
)

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
    (2, 2048, 512, True, 0),
    (2, 4096, 512, True, 0),
    (1, 16384, 64, True, 0),       # the largest cloud the kernel stages
    (200, 512, 128, True, 0),      # more clouds than the card has SMs
    (2, 1024, 512, True, -1),      # duplicated points: exact d2 ties
    (2, 64, 36, False, 0),         # one warp a cloud
])
def test_fps_bit_identical(card, b, n, m, skip, n_near):
    rng = np.random.default_rng(n + m)
    x = _sphere(rng, b, n, card)
    if n_near < 0:  # every point four times, on a coarse grid
        x = torch.round(x[:, : n // 4].repeat(1, 4, 1) * 4.0) / 4.0
        n_near = 0
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


# Every eval width triple at k = 16, 32, 64 and 128 (B=4, N=512, M=70:
# not a multiple of any center tile): on the unit sphere a ball of radius
# sqrt(k / 128) holds k of the 512 points on average, so rows cut at k
# (cnt > k) sit beside short rows of every length mod 8, which the
# kernels pad to whole 8-row groups with replicas of slot 0.
EVAL_SWEEP = [(w, 4, 512, 70, float(np.sqrt(k / 128)), k)
              for w in kfs.EVAL_WIDTHS for k in (16, 32, 64, 128)]


def _check_sweep_counts(cnt, k):
    """A sweep case holds an empty row, rows cut at k and short rows of
    every residue 1-7 mod 8."""
    cnt = cnt.cpu()
    short = cnt[(cnt > 0) & (cnt < k)]
    assert int(cnt[0, 0]) == 0 and bool((cnt > k).any())
    assert set((short % 8).tolist()) >= set(range(1, 8))


@pytest.mark.parametrize("widths,b,n,m,radius,k", [
    ((64, 64, 128), 4, 1024, 512, 0.2, 64),
    ((128, 128, 256), 4, 512, 128, 0.4, 64),
    ((64, 64, 128), 2, 300, 70, 0.3, 16),   # ragged tile, N % 32 != 0
] + EVAL_SWEEP)
def test_bq_eval_matches_plain(card, widths, b, n, m, radius, k):
    rng = np.random.default_rng(sum(widths) + n)
    c1, c2, c3 = widths
    pts = _sphere(rng, b, n, card)
    nx = pts[:, :m].clone()
    nx[0, 0] = 50.0                         # an empty row
    if (widths, b, n, m, radius, k) in EVAL_SWEEP:
        _check_sweep_counts(kbq.ball_query_plain(nx, pts, radius, k)[1], k)
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


BQ_CASES = {  # B, N, M, radius, k, cloud
    "msg1_k128": (4, 1024, 512, 0.4, 128, "sphere"),  # most rows short
    "msg2_k128": (4, 512, 128, 0.8, 128, "sphere"),   # cnt above and below k
    "n1000_k16": (2, 1000, 70, 0.3, 16, "sphere"),    # N % 32 != 0
    "k_eq_n": (2, 128, 33, 0.4, 128, "sphere"),       # every row short
    "every_point": (2, 300, 64, 2.5, 8, "sphere"),    # cnt = N > k
    "n37_k64": (1, 37, 5, 0.5, 64, "sphere"),         # N just above a warp
    # SSG's SA1 at N=4096 on a Hilbert-sorted cloud, the cull route's
    "ssg4096_sorted": (4, 4096, 512, 0.2, 64, "sorted"),
    "r_pm_1ulp": (2, 4096, 128, 0.2, 64, "ulp"),      # points at r ± 1 ulp
    "translated_1e3": (2, 4096, 256, 0.2, 64, "translated"),  # d² cancels
    "duplicates": (2, 4096, 256, 0.2, 64, "duplicates"),  # each point 4 times
    "hollow_boxes": (2, 4096, 64, 0.2, 64, "hollow"),  # a box holds the
}                                                      # center, no hit


def _bq_inputs(card, name):
    """``(centers, points, radius, k)`` of :data:`BQ_CASES` ``name``,
    the first center far from every point (an empty row)."""
    from pointcloudlib_tpu_torch.ops import spatial

    b, n, m, radius, k, cloud = BQ_CASES[name]
    rng = np.random.default_rng(n + k + (cloud != "sphere") * len(name))
    pts = _sphere(rng, b, n, card)
    if cloud == "sorted":
        pts = spatial.canonicalize(pts)[0]
    if cloud == "duplicates":
        pts = pts[:, :n // 4].repeat(1, 4, 1)
    nx = pts[:, rng.permutation(n)[:m]] if cloud != "sphere" else pts[:, :m]
    nx = nx.clone()
    if cloud in ("ulp", "hollow"):
        # chunks of 32 points around the first 32 centers: at r and one
        # f32 unit inside or outside it, or at the corners of a cube of
        # half side 0.15 (|corner| = 0.26 > r: the box holds its center,
        # no point is a hit)
        own = nx[:, :32].repeat_interleave(32, dim=1)
        if cloud == "ulp":
            d = torch.nn.functional.normalize(torch.from_numpy(
                rng.standard_normal((b, 1024, 3)).astype(np.float32)), dim=-1)
            near = (own.cpu() + radius * d).numpy()
            step = np.where(rng.random(near.shape) < 0.5, np.inf, -np.inf)
            near = np.nextafter(near, step.astype(np.float32))
        else:
            corners = torch.tensor([[x, y, z] for x in (-1, 1)
                                    for y in (-1, 1) for z in (-1, 1)],
                                   dtype=torch.float32).repeat(128, 1)
            near = (own.cpu() + 0.15 * corners).numpy()
        pts = pts.clone()
        pts[:, :1024] = torch.from_numpy(near).to(card)
    if cloud == "translated":
        pts, nx = pts + 1e3, nx + 1e3
    nx[0, 0] = 1e4                          # an empty row
    return nx.contiguous(), pts.contiguous(), radius, k


@pytest.mark.parametrize("name", sorted(BQ_CASES))
def test_ball_query_bit_identical(card, name, monkeypatch):
    """idx and cnt bit-identical to the plain version on every route
    (scan, cull), each forced in turn through ``ball_query_route``; one
    launch a call."""
    nx, pts, radius, k = _bq_inputs(card, name)
    want_idx, want_cnt = kbq.ball_query_plain(nx, pts, radius, k)
    assert int(want_cnt[0, 0]) == 0 and (want_cnt > 0).any()
    if name == "hollow_boxes":  # the box of chunk i holds center i
        lo, hi = kbq.chunk_boxes(pts)
        c = nx[:, 1:32]
        assert ((lo[:, 1:32] <= c) & (c <= hi[:, 1:32])).all()
    for route in kbq.ROUTES:
        monkeypatch.setattr(kbq, "ball_query_route", lambda n, r=route: r)
        before = kbq.ball_query.launches
        idx, cnt = kbq.ball_query(nx, pts, radius, k)
        torch.cuda.synchronize()
        assert kbq.ball_query.launches == before + 1
        assert int(cnt[0, 0]) == 0 and (idx[0, 0] == 0).all()
        assert idx.dtype == torch.int32 and cnt.dtype == torch.int32
        assert torch.equal(cnt, want_cnt), kbq.ROUTES[route]
        assert torch.equal(idx, want_idx), kbq.ROUTES[route]


IDX_SHAPES = {  # widths, B, N, M, radius, k
    "msg1_k128": ((64, 96, 128), 4, 1024, 512, 0.4, 128),
    "msg2_k128": ((128, 128, 256), 4, 512, 128, 0.8, 128),
    "c32_k16": ((32, 32, 64), 2, 300, 70, 0.3, 16),   # ragged center tile
    # SSG's SA1 at N=4096, where the JAX package runs its windowed
    # kernels (_k_f1w, _k_evalw) and the port these
    "ssg4096_k64": ((64, 64, 128), 4, 4096, 512, 0.2, 64),
}


# the sweep of test_bq_eval_matches_plain, by the given index
IDX_SWEEP = {f"sweep_{'-'.join(map(str, case[0]))}_k{case[-1]}": case
             for case in EVAL_SWEEP}


def _idx_layer(card, name):
    widths, b, n, m, radius, k = {**IDX_SHAPES, **IDX_SWEEP}[name]
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


def _repeats(idx, kind):
    """A k=128 index whose every slot repeats slot 0 (``all_equal``), or
    random indices with slot 0's also in the middle and at the end of
    each row (``slot0_repeats``): the kernel stores the rows whose index
    equals slot 0's as copies of slot 0's row."""
    if kind == "all_equal":
        return idx[..., :1].expand(idx.shape).contiguous()
    g = torch.Generator(device=idx.device).manual_seed(5)
    out = torch.randint(0, 1024, idx.shape, generator=g, device=idx.device,
                        dtype=torch.int32)
    out[..., idx.shape[-1] // 2] = out[..., 0]
    out[..., -1] = out[..., 0]
    return out


@pytest.mark.parametrize("name", sorted(IDX_SHAPES) + sorted(IDX_SWEEP)
                         + ["all_equal", "slot0_repeats"])
def test_sa_f1_matches_plain(card, name):
    from pointcloudlib_tpu_torch.ops.kernels import fused_sa_train as ft

    if name in ("all_equal", "slot0_repeats"):
        q, off, idx, _, _, _ = _idx_layer(card, "msg1_k128")  # N = 1024
        idx = _repeats(idx, name)
    else:
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
@pytest.mark.parametrize("name", sorted(IDX_SHAPES) + sorted(IDX_SWEEP))
def test_sa_eval_idx_matches_plain(card, name, with_cnt):
    q, off, idx, cnt, params, stats = _idx_layer(card, name)
    if name in IDX_SWEEP:
        _check_sweep_counts(cnt, idx.shape[-1])
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
# SSG's SA1 at N=4096: p2 where the JAX package runs _k_p2w
WINDOW_SHAPES = {"ssg4096_sa1": ((64, 64, 128), 4, 4096, 512, 0.2, 64)}
# the backward passes' edge cases, each center its own cloud point (no
# empty row): a radius that holds only the center (cnt = 1, every other
# slot a replica of slot 0, all k slots tied at every channel), one that
# holds every point (cnt >= k, no replica), and clouds on a coarse grid
# (many duplicate points: exact max ties between distinct slots)
BWD_CASES = {
    "all_replicas": ((64, 64, 128), 2, 512, 128, 1e-4, 64),
    "all_replicas_k128": ((128, 128, 256), 2, 512, 64, 1e-4, 128),
    "all_replicas_k8": ((64, 96, 128), 2, 512, 128, 1e-4, 8),
    "no_replicas": ((64, 96, 128), 2, 512, 128, 10.0, 32),
    "grid_ties": ((32, 32, 64), 2, 512, 256, 0.6, 16),
    # eight centers a tile at the widest widths; a center over four tiles
    "k8_wide": ((128, 128, 256), 2, 512, 64, 0.2, 8),
    "k256": ((64, 64, 128), 2, 1024, 32, 0.6, 256),
}


def _train_layer(card, name, seed=0):
    """Kernel inputs at a train shape, made with the plain versions on
    the card: clouds on the unit sphere, an empty ball-query row, the
    bf16 h1, folded BN rows from its statistics, an output gradient."""
    from pointcloudlib_tpu_torch.ops.kernels import fused_sa_train as ft

    widths, b, n, m, radius, k = {**TRAIN_SHAPES, **WINDOW_SHAPES,
                                   **BWD_CASES, **TAIL_SWEEP,
                                   **F1_CASES}[name]
    c1, c2, c3 = widths
    rng = np.random.default_rng(seed)
    pts = _sphere(rng, b, n, card)
    if name == "grid_ties":
        pts = torch.round(pts * 2.0) / 2.0
    nx = pts[:, :m].clone()
    if name not in BWD_CASES:
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


# pass 1's grid: PS SA2's small grid (2,048 centers), and an M (prime)
# that no block's share of centers divides (the last block of a cloud
# holds fewer centers than the others)
F1_CASES = {
    "ps_sa2_grid": ((128, 128, 256), 16, 512, 128, 0.4, 64),
    "ragged_m": ((64, 64, 128), 3, 1024, 331, 0.2, 64),
}


@pytest.mark.parametrize("name", sorted(TRAIN_SHAPES) + sorted(BWD_CASES)
                         + sorted(F1_CASES))
def test_bq_f1_matches_plain(card, name):
    L = _train_layer(card, name)
    _check_case(L, name)
    ft = L["ft"]
    before = ft.bq_f1.launches
    idx, h1, cnt, psum = ft.bq_f1(L["nx"], L["pts"], L["q"].bfloat16(),
                                  L["off"], L["radius"], L["k"])
    torch.cuda.synchronize()
    assert ft.bq_f1.launches == before + 1
    if name not in BWD_CASES:
        assert int(cnt[0, 0]) == 0
    assert torch.equal(idx, L["idx"]) and torch.equal(cnt, L["cnt"])
    assert torch.equal(h1.view(torch.int16), L["h1"].view(torch.int16))
    _close_sums(psum, L["psum"], "psum1")


def _check_case(L, name):
    """The property a backward edge case is named for holds."""
    cnt, k = L["cnt"], L["k"]
    if name.startswith("all_replicas"):
        assert bool((cnt == 1).all())
    elif name == "no_replicas":
        assert bool((cnt >= k).all())
    elif name == "grid_ties":
        assert int(torch.unique(L["pts"][0], dim=0).shape[0]) < 128


# every width triple at k = 16, 32, 64 and 128 (each with an empty row;
# at k = 128 a center spans two 64-row tiles)
TAIL_SWEEP = {f"sweep_{'-'.join(map(str, w))}_k{k}":
              (w, 2, 512, 64, float(np.sqrt(k / 128)), k)
              for w in kfs.EVAL_WIDTHS for k in (16, 32, 64, 128)}
BWD_NAMES = sorted(TRAIN_SHAPES) + sorted(WINDOW_SHAPES) + sorted(BWD_CASES)


def _tail_check(L, stage, st3):
    ft, p, (st1, st2, _) = L["ft"], L["p"], L["st"]
    before = ft.sa_tail.launches
    got = ft.sa_tail(stage, L["h1"], st1, st2, st3, p.w2, p.w3)
    torch.cuda.synchronize()
    assert ft.sa_tail.launches == before + 1
    want = ft.sa_tail_plain(stage, L["h1"], st1, st2, st3, p.w2, p.w3)
    if stage == 4:  # the eval kernel's bound: one bf16 rounding may move
        torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)
    else:
        _close_sums(got, want, f"stage {stage}")
    return got


@pytest.mark.parametrize("stage", [2, 3, 4])
@pytest.mark.parametrize("name", BWD_NAMES + sorted(TAIL_SWEEP))
def test_tail_matches_plain(card, name, stage):
    L = _train_layer(card, name, seed=1)
    _check_case(L, name)
    _tail_check(L, stage, L["st"][2])


@pytest.mark.parametrize("name", ["sa1", "msg2_k128", "k8_wide"])
def test_tail_pools_a_dead_channel_to_zero(card, name):
    """A channel whose BN3 shift puts every row's z3 below 0 pools to
    exactly 0 (the max's identity is the ReLU's floor)."""
    L = _train_layer(card, name, seed=4)
    st3 = L["st"][2].clone()
    st3[1, 5] = -1e6
    got = _tail_check(L, 4, st3)
    assert bool((got[..., 5] == 0).all())
    assert bool((got[..., 4] > 0).any())


@pytest.mark.parametrize("name", BWD_NAMES)
def test_bwd_p1_matches_plain(card, name):
    L = _train_layer(card, name, seed=2)
    _check_case(L, name)
    ft, p, (st1, st2, st3) = L["ft"], L["p"], L["st"]
    before = ft.sa_bwd_p1.launches
    got = ft.sa_bwd_p1(L["h1"], L["dout"], st1, st2, st3, p.w2, p.w3)
    torch.cuda.synchronize()
    assert ft.sa_bwd_p1.launches == before + 1
    want = ft.sa_bwd_p1_plain(L["h1"], L["dout"], st1, st2, st3, p.w2,
                              p.w3)
    for a, b_, what in zip(got, want, ("ps3", "vecs", "mats")):
        _tie_robust(a, b_, what)


@pytest.mark.parametrize("name", BWD_NAMES)
def test_bwd_p2_matches_plain(card, name):
    L = _train_layer(card, name, seed=3)
    _check_case(L, name)
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


# --------------------------------------- part-segmentation decoder kernels

THREE_INTERP_SHAPES = {  # B, M (queries), N (support), C
    "fp2": (16, 512, 128, 256),    # PointNet++ part segmentation, B=16
    "fp1": (16, 2048, 512, 128),
    "n36": (1, 40, 36, 64),        # PointConv decoders' coarse levels
    "n100": (2, 16, 100, 3),
    # PointConv part segmentation's four decoders, B=16
    "pc_seg_n36": (16, 64, 36, 512),
    "pc_seg_n64": (16, 256, 64, 512),
    "pc_seg_n256": (16, 1024, 256, 256),
    "pc_seg_n1024": (16, 2048, 1024, 128),
    "n101": (3, 77, 101, 24),      # N and M no multiple of any lane group
    "n3": (2, 50, 3, 16),          # the fewest support points it takes
    "c6": (2, 300, 70, 6),         # C % 4 != 0: one channel a unit
}


def _three_interp_inputs(card, name):
    """Support points picked by FPS from a cloud four times as dense, as
    on the model's path (so no two lie within a hair of each other), and
    queries of which the first ones are support points."""
    b, m, n, c = THREE_INTERP_SHAPES[name]
    rng = np.random.default_rng(m + n + c)
    cloud = _sphere(rng, b, 4 * n, card)
    pts = cloud[torch.arange(b, device=card)[:, None],
                kfps.fps_plain(cloud, n).long()]
    q = _sphere(rng, b, m, card) * 0.9
    q[:, : min(m, n) // 2] = pts[:, : min(m, n) // 2]  # self-pairs
    f = torch.from_numpy(rng.standard_normal((b, n, c)).astype(
        np.float32)).to(card)
    return q, pts, f


@pytest.mark.parametrize("name", sorted(THREE_INTERP_SHAPES))
def test_three_interp_matches_plain(card, name):
    """idx bit-identical; w and out within 1e-6 of the largest plain
    element (the same round-to-nearest operations in the same order);
    queries equal to support points get a hard copy of its features."""
    from pointcloudlib_tpu_torch.ops.kernels import three_interp as kti

    q, pts, f = _three_interp_inputs(card, name)
    before = kti.three_interp_fwd.launches
    out, idx, w = kti.three_interp_fwd(q, pts, f)
    torch.cuda.synchronize()
    assert kti.three_interp_fwd.launches == before + 1
    pout, pidx, pw = kti.three_interp_plain(q, pts, f)
    assert torch.equal(idx, pidx)
    for got, want in ((w, pw), (out, pout)):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-6 * want.abs().max().item())
    half = min(q.shape[1], pts.shape[1]) // 2
    torch.testing.assert_close(out[:, :half], f[:, :half], rtol=0,
                               atol=1e-4 * f.abs().max().item())


def test_three_interp_duplicate_support(card):
    """Duplicate support points give exact d² ties, at 0 for queries on
    them: the lower index comes first, as in three masked argmins."""
    from pointcloudlib_tpu_torch.ops.kernels import three_interp as kti

    rng = np.random.default_rng(5)
    base = _sphere(rng, 2, 64, card)
    dup = base[:, torch.from_numpy(rng.integers(0, 64, 128)).to(card)]
    f = torch.from_numpy(rng.standard_normal((2, 128, 32)).astype(
        np.float32)).to(card)
    for q in (dup, _sphere(rng, 2, 256, card)):
        out, idx, w = kti.three_interp_fwd(q, dup, f)
        pout, pidx, pw = kti.three_interp_plain(q, dup, f)
        torch.cuda.synchronize()
        assert torch.equal(idx, pidx)
        torch.testing.assert_close(out, pout, rtol=0,
                                   atol=1e-6 * pout.abs().max().item())


@pytest.mark.parametrize("group", [2, 4, 8, 16, 32])
def test_three_interp_every_group_bit_identical(card, group, monkeypatch):
    """Each lane group the kernel is compiled for, forced by replacing
    ``interp_group``, gives the plain version's idx bit for bit, and w
    and out within 1e-6·max|plain|: at two decoder shapes, at N = 3, on
    support points that repeat three times in a row, so that tied copies
    sit in neighbouring lanes' strides (queries on them tie at d² = 0,
    the others at their own d²) and the merge across lanes must keep the
    lower index first; on a grid of points moved by 1e3, whose expanded
    d² cancels to a few units of its last place (exact ties)."""
    from pointcloudlib_tpu_torch.ops.kernels import three_interp as kti

    monkeypatch.setattr(kti, "interp_group", lambda b, m: group)
    rng = np.random.default_rng(group)
    base = _sphere(rng, 2, 40, card)
    dup = base.repeat_interleave(3, dim=1)               # 120 points
    axis = torch.arange(6, dtype=torch.float32, device=card) * 0.25
    grid = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"),
                       -1).reshape(1, -1, 3).expand(2, -1, -1) + 1e3
    near = grid[:, ::2] + torch.from_numpy(rng.uniform(
        -0.2, 0.2, (2, 108, 3)).astype(np.float32)).to(card)
    cases = [(_sphere(rng, 2, 200, card), dup), (dup, dup),
             (near, grid.contiguous()), (grid[:, ::3].contiguous(),
                                         grid.contiguous())]
    for name in ("pc_seg_n64", "n3"):
        q, pts, _ = _three_interp_inputs(card, name)
        cases.append((q, pts))
    for q, pts in cases:
        b, n = pts.shape[:2]
        f = torch.from_numpy(rng.standard_normal((b, n, 20)).astype(
            np.float32)).to(card)
        out, idx, w = kti.three_interp_fwd(q, pts, f)
        pout, pidx, pw = kti.three_interp_plain(q, pts, f)
        torch.cuda.synchronize()
        assert torch.equal(idx, pidx), (group, n)
        for got, want in ((w, pw), (out, pout)):
            torch.testing.assert_close(got, want, rtol=0,
                                       atol=1e-6 * want.abs().max().item())


def test_three_interp_rejects_what_it_cannot_run(card):
    from pointcloudlib_tpu_torch.ops.kernels import three_interp as kti

    q = torch.zeros((1, 4, 3), device=card)
    with pytest.raises(ValueError, match="N <="):
        kti.three_interp_fwd(q, torch.zeros((1, 2, 3), device=card),
                             torch.zeros((1, 2, 8), device=card))
    n = kti.MAX_POINTS + 1
    with pytest.raises(ValueError, match="N <="):
        kti.three_interp_fwd(q, torch.zeros((1, n, 3), device=card),
                             torch.zeros((1, n, 8), device=card))


SCATTER_SHAPES = {  # B, M, K, C, n
    "fp1_bwd": (16, 2048, 3, 128, 512),
    "fp2_bwd": (16, 512, 3, 256, 128),
    "n36": (1, 40, 3, 64, 36),
    "n100": (2, 16, 3, 3, 100),
    # PointConv classification's backward: SA1's density (C = 1) and SA2
    "pc_cls_c1": (32, 512, 32, 1, 1024),
    "pc_cls_c132": (32, 256, 32, 132, 512),
    # C = 1 where most rows of out get no index, and a batch whose
    # indices are all sentinels: on the narrow route out starts
    # unwritten, so those rows must still read exactly 0
    "c1_sparse": (4, 64, 4, 1, 4096),
    "c1_sentinel_batch": (3, 100, 8, 1, 512),
    # out[b] just at and just above gather.SCATTER_NARROW_BYTES, and a
    # small out[b] of 16-byte rows (the wide route)
    "cutoff_narrow": (2, 256, 4, 3, 1365),
    "cutoff_wide": (2, 256, 4, 3, 1366),
    "c4_small": (2, 256, 4, 4, 64),
}
SCATTER_ROUTES = {"pc_cls_c1": "narrow", "c1_sparse": "narrow",
                  "c1_sentinel_batch": "narrow", "n100": "narrow",
                  "cutoff_narrow": "narrow", "cutoff_wide": "wide",
                  "c4_small": "wide", "pc_cls_c132": "wide",
                  "fp1_bwd": "wide"}


@pytest.mark.parametrize("name", sorted(SCATTER_SHAPES))
def test_scatter_rows_matches_plain(card, name):
    """Within 1e-5 of the largest plain element: f32 atomics add a
    target's rows in another order; indices at or beyond n add nothing,
    and rows of out that no index reaches are exactly 0 on either
    route."""
    from pointcloudlib_tpu_torch.ops.kernels import gather as kga

    b, m, k, c, n = SCATTER_SHAPES[name]
    rng = np.random.default_rng(b + m + n)
    g = torch.from_numpy(rng.standard_normal((b, m, k, c)).astype(
        np.float32)).to(card)
    idx = torch.from_numpy(rng.integers(0, n + 8, (b, m, k)).astype(
        np.int32)).to(card)
    idx[0, 0, 0] = n
    if name == "c1_sentinel_batch":
        idx[-1] = n + 1
    assert kga.scatter_route(n, c) == SCATTER_ROUTES.get(name, "wide")
    before = kga.scatter_rows.launches
    got = kga.scatter_rows(g, idx, n)
    torch.cuda.synchronize()
    assert kga.scatter_rows.launches == before + 1
    want = kga.scatter_rows_plain(g, idx, n)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())
    hit = torch.zeros((b, n + 9), dtype=torch.bool, device=card)
    hit.scatter_(1, idx.reshape(b, -1).long(), True)
    if name == "c1_sparse":
        assert (~hit[:, :n]).float().mean() > 0.5
    if name == "c1_sentinel_batch":
        assert not hit[-1, :n].any()
    assert not got[~hit[:, :n]].any()


def test_partseg_train_step_card_matches_cpu(card):
    """One train-mode forward and backward of PointNet++ part
    segmentation on 8 synthetic clouds at N=2048 (xyz as features), on
    the card and on the CPU from the same weights with dropout 0, under
    ``tools/grad_check.py``'s bounds (cosine ≥ 0.85, norm within 15 %).
    Not compared, as exactly 0: the head's Dense bias (its own
    train-mode BatchNorm removes the shift), SA3's last BN bias, and a
    fused scale's last BN bias where every pooled output is positive."""
    from pointcloudlib_tpu_torch.tools.grad_check import (
        build_model,
        grad_agreement,
        synthetic_batch,
    )

    SEG = "pointnet2_partseg"

    variables = random_jax_variables(build_model(SEG), seed=5)
    got = grad_agreement(SEG, variables, synthetic_batch(SEG, 8, 11, 2048),
                         card)
    agree = got["agree"]
    print(SEG, "card against CPU: least cosine",
          min(agree.items(), key=lambda kv: kv[1][0]),
          "largest norm deviation",
          max(agree.items(), key=lambda kv: abs(kv[1][1] - 1)),
          "not compared", got["not_compared"])
    assert not got["failures"], got["failures"]
    assert "head.dense.bias" in got["not_compared"]
    allowed = {"head.dense.bias", "sa3.mlp.2.bn.bias", "sa1.fused.bn3_bias",
               "sa2.fused.bn3_bias"}
    assert set(got["not_compared"]) <= allowed, got["not_compared"]


# ------------------------------------------------ DGCNN EdgeConv kernels

EDGE_SHAPES = {  # B, N, k, C_in, C: DGCNN's four EdgeConvs, and edge cases
    "ec1": (4, 1024, 20, 3, 64),
    "ec2": (4, 1024, 20, 64, 64),
    "ec3": (4, 1024, 20, 64, 128),
    "ec4": (4, 1024, 20, 128, 256),
    "n65": (2, 65, 20, 64, 64),          # one past the 64-point tile
    "ec1_duplicates": (4, 1024, 20, 3, 64),
    "k8_n128": (2, 128, 8, 16, 32),
    # part segmentation's pass-1 shapes (the select route at N = 2,048,
    # with the FMA pass at C_in = 64) and its edge cases
    "seg_pair1": (4, 2048, 40, 3, 64),
    "seg_pair2": (4, 2048, 40, 64, 64),
    "seg_duplicates": (4, 2048, 40, 3, 64),
    "seg_translated_1e3": (4, 2048, 40, 64, 64),  # the expanded d² cancels
    "seg_all_equal": (2, 2048, 40, 64, 64),       # every d² ties: the index
}
# the kernels that take a given index only: part seg's width 256 at
# k = 40, k > N (the kNN repeats its last index) and a width on edge_f1's
# rows route
F1_SHAPES = {
    "f1_c256_k40": (4, 1000, 40, 128, 256),
    "f1_k_over_n": (2, 30, 40, 16, 64),
    "f1_c4": (2, 256, 20, 3, 4),
}
# the eval kernel from a given index only: BN scales of both signs and
# zero, and a list length that is not a multiple of 4
EVAL_IDX_SHAPES = {
    "eval_signed_scales": (4, 1000, 20, 64, 128),
    "eval_k33": (2, 500, 33, 64, 64),
}
# the served launches of the eval kernel with the kNN inside at their
# batch sizes: DGCNN's EC2 and EC4 (B=32, N=1024), part seg's EC3
EVAL_SERVE_SHAPES = {
    "serve_ec2": (32, 1024, 20, 64, 64),
    "serve_ec4": (32, 1024, 20, 128, 256),
    "serve_seg_ec3": (16, 2048, 40, 64, 64),
}


# edge_bwd at its main-path shapes (DGCNN's EC1–EC4, B=32, N=1024, k=20;
# part seg's EC3, B=16, N=2048, k=40; the kNN route's N=1,000) and edge
# cases: duplicate points (max-pool ties), a hub target every center
# lists, C = 4 and a single cloud
BWD_SHAPES = {
    "bwd_ec1": (32, 1024, 20, 3, 64),
    "bwd_ec2": (32, 1024, 20, 64, 64),
    "bwd_ec3": (32, 1024, 20, 64, 128),
    "bwd_ec4": (32, 1024, 20, 128, 256),
    "bwd_seg_ec3": (16, 2048, 40, 64, 64),
    "bwd_n1000": (32, 1000, 20, 64, 64),
    "bwd_duplicates": (4, 1024, 20, 3, 64),
    "bwd_hub": (4, 1024, 20, 64, 128),
    "bwd_c4": (2, 256, 20, 3, 4),
    "bwd_one_cloud": (1, 1024, 20, 64, 64),
}


def _edge_inputs(card, name, seed=0):
    """``x``, ``q`` (bf16), ``off``, the folded BN rows of random running
    statistics and an output gradient; the duplicates cases repeat the
    first half of each cloud (exact kNN ties at d² = 0, exact max-pool
    ties), the translated case moves the clouds by 1e3, the all-equal
    case makes every point of a cloud its first and the signed-scales
    case makes every third BN scale negative and every seventh 0."""
    from pointcloudlib_tpu_torch.ops.kernels import fused_edge as kfe

    b, n, k, cin, c = {**EDGE_SHAPES, **F1_SHAPES, **EVAL_SERVE_SHAPES,
                       **BWD_SHAPES, **EVAL_IDX_SHAPES}[name]
    rng = np.random.default_rng(seed + n + cin + c)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(card)

    x = t(b, n, cin)
    if "duplicates" in name:
        x[:, n // 2:] = x[:, : n // 2]
    if "translated" in name:
        x += 1e3
    if "all_equal" in name:
        x[:] = x[:, :1]
    wa, wb = t(cin, c, scale=cin ** -0.5), t(cin, c, scale=cin ** -0.5)
    q = (x.bfloat16().float() @ wa.bfloat16().float()).bfloat16()
    off = x.bfloat16().float() @ (wa - wb).bfloat16().float()
    st = kfs._stack_stats(t(c, scale=0.1), t(c).abs() + 0.5,
                          t(c, scale=0.2) + 1.0, t(c, scale=0.1))
    if "signed_scales" in name:
        st[0, ::3] = -st[0, ::3]
        st[0, ::7] = 0.0
    return kfe, dict(x=x, q=q, off=off, st=st, k=k, dout=t(b, n, c))


@pytest.mark.parametrize("name", sorted(EDGE_SHAPES))
def test_edge_knn_eval_matches_plain(card, name):
    """The same neighbours (d² formed without FMA, channel by channel) and
    the plain version's rounded operations: within 1e-5 of the largest
    plain element (bit-identical in practice)."""
    kfe, a = _edge_inputs(card, name)
    args = (a["x"], a["q"], a["off"], a["st"], a["k"])
    before = kfe.edge_knn_eval.launches
    got = kfe.edge_knn_eval(*args)
    torch.cuda.synchronize()
    assert kfe.edge_knn_eval.launches == before + 1
    want = kfe.edge_knn_eval_plain(*args)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("name", sorted(EDGE_SHAPES))
def test_edge_knn_f1_and_out_match_plain(card, name):
    """Pass 1: idx and the bf16 h bit-identical, Σ/Σ² within 1e-3 of the
    largest (f32 atomics in another order); pass 2 within 1e-5."""
    kfe, a = _edge_inputs(card, name, seed=1)
    f1 = (a["x"], a["q"], a["off"], a["k"])
    before = kfe.edge_knn_f1.launches, kfe.edge_out.launches
    idx, h, psum = kfe.edge_knn_f1(*f1)
    out = kfe.edge_out(h, a["st"])
    torch.cuda.synchronize()
    assert (kfe.edge_knn_f1.launches, kfe.edge_out.launches) == (
        before[0] + 1, before[1] + 1)
    widx, wh, wpsum = kfe.edge_knn_f1_plain(*f1)
    assert torch.equal(idx, widx)
    assert torch.equal(h.view(torch.int16), wh.view(torch.int16))
    _close_sums(psum, wpsum, "psum")
    want = kfe.edge_out_plain(wh, a["st"])
    torch.testing.assert_close(out, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())
    if "duplicates" in name:  # a point and its twin, both at d² = 0
        n = idx.shape[1]
        pts = torch.arange(n, device=card)
        assert torch.equal(idx[:, :, 0].long(), (pts % (n // 2)).expand(
            idx.shape[0], -1))
        assert torch.equal(idx[:, :, 1].long(), (pts % (n // 2) + n // 2
                                                 ).expand(idx.shape[0], -1))


@pytest.mark.parametrize("name", sorted(EDGE_SHAPES))
def test_edge_knn_f1_every_route_bit_identical(card, name, monkeypatch):
    """Every route of pass 1's launcher (the block route and each select
    instance: list length, width) that takes these shapes, each forced in
    turn through ``knn.edge_f1_route``: idx and h bit-identical to the
    plain version's, Σ/Σ² within 1e-3 of the largest."""
    from pointcloudlib_tpu_torch.ops.kernels import knn as kknn

    kfe, a = _edge_inputs(card, name, seed=4)
    f1 = (a["x"], a["q"], a["off"], a["k"])
    b, n, cin = a["x"].shape
    c = a["q"].shape[-1]
    widx, wh, wpsum = kfe.edge_knn_f1_plain(*f1)
    routes = [r for r in kknn.EDGE_ROUTES
              if kknn.edge_f1_route_fits(r, n, cin, c, a["k"])]
    assert routes and (c != 64 or len(routes) >= 2), routes
    for route in routes:
        monkeypatch.setattr(kknn, "edge_f1_route", lambda *_, r=route: r)
        idx, h, psum = kfe.edge_knn_f1(*f1)
        torch.cuda.synchronize()
        what = kknn.edge_route_name(route)
        assert torch.equal(idx, widx), what
        assert torch.equal(h.view(torch.int16), wh.view(torch.int16)), what
        _close_sums(psum, wpsum, what)


@pytest.mark.parametrize("name", sorted({**EDGE_SHAPES,
                                         **EVAL_SERVE_SHAPES}))
def test_edge_knn_eval_every_route_bit_identical(card, name, monkeypatch):
    """Every route of the eval kernel's launcher (the block route and
    each select instance) that takes these shapes, each forced in turn
    through ``knn.edge_eval_route``: out bit-identical to the plain
    version's, one launch a call. The served shapes take the select
    route, the small grids (B=4) the block route."""
    from pointcloudlib_tpu_torch.ops.kernels import knn as kknn

    kfe, a = _edge_inputs(card, name, seed=5)
    args = (a["x"], a["q"], a["off"], a["st"], a["k"])
    b, n, cin = a["x"].shape
    c = a["q"].shape[-1]
    route = kknn.edge_eval_route(b, n, cin, c, a["k"])
    assert (route != 0) == (name.startswith("serve") or n >= 2048), route
    want = kfe.edge_knn_eval_plain(*args)
    routes = [r for r in kknn.EDGE_ROUTES
              if kknn.edge_eval_route_fits(r, n, cin, c, a["k"])]
    assert routes and (c != 64 or a["k"] < 9 or len(routes) >= 2), routes
    for r in routes:
        monkeypatch.setattr(kknn, "edge_eval_route", lambda *_, r=r, **__: r)
        before = kfe.edge_knn_eval.launches
        got = kfe.edge_knn_eval(*args)
        torch.cuda.synchronize()
        assert kfe.edge_knn_eval.launches == before + 1
        assert torch.equal(got, want), kknn.edge_route_name(r, 1)


@pytest.mark.parametrize("name", sorted(EDGE_SHAPES))
def test_edge_bwd_matches_plain(card, name):
    """The backward's sums and scatter within 1e-3 of the largest element
    (f32 atomics in another order), the scatter's count column exact, and
    the assembled dq, doff, dγ, dβ within 1e-3."""
    kfe, a = _edge_inputs(card, name, seed=2)
    idx, h, _ = kfe.edge_knn_f1_plain(a["x"], a["q"], a["off"], a["k"])
    args = (h, a["dout"], idx, a["st"], 0.2, h.shape[1])
    before = kfe.edge_bwd.launches
    got = kfe.edge_bwd(*args)
    torch.cuda.synchronize()
    assert kfe.edge_bwd.launches == before + 1
    want = kfe.edge_bwd_plain(*args)
    c = h.shape[-1]
    assert torch.equal(got[1][..., 2 * c], want[1][..., 2 * c])
    for g, w, what in zip(got, want, ("ps", "scat", "d1", "d2")):
        _close_sums(g, w, what)
    for g, w, what in zip(kfe.assemble_grads(*got, a["st"], a["k"]),
                          kfe.assemble_grads(*want, a["st"], a["k"]),
                          ("dq", "doff", "dgamma", "dbeta")):
        _close_sums(g, w, what)


@pytest.mark.parametrize("name", sorted(BWD_SHAPES))
def test_edge_bwd_path_shapes_match_plain(card, name):
    """The backward at its path shapes and edge cases, one launch a call:
    the count column exact in two calls, the sums and scatter and the
    assembled dq, doff, dγ, dβ within 1e-3 of each one's largest element
    (the dz half reduced only where a channel quad is not all 0)."""
    kfe, a = _edge_inputs(card, name, seed=6)
    idx, h, _ = kfe.edge_knn_f1_plain(a["x"], a["q"], a["off"], a["k"])
    if "hub" in name:
        idx[:, :, 0] = 5  # every center lists point 5
    n, c = h.shape[1], h.shape[-1]
    args = (h, a["dout"], idx, a["st"], 0.2, n)
    before = kfe.edge_bwd.launches
    got = kfe.edge_bwd(*args)
    again = kfe.edge_bwd(*args)
    torch.cuda.synchronize()
    assert kfe.edge_bwd.launches == before + 2
    want = kfe.edge_bwd_plain(*args)
    assert torch.equal(got[1][..., 2 * c], want[1][..., 2 * c])
    assert torch.equal(again[1][..., 2 * c], want[1][..., 2 * c])
    for g, w, what in zip(got, want, ("ps", "scat", "d1", "d2")):
        _close_sums(g, w, what)
    for g, w, what in zip(kfe.assemble_grads(*got, a["st"], a["k"]),
                          kfe.assemble_grads(*want, a["st"], a["k"]),
                          ("dq", "doff", "dgamma", "dbeta")):
        _close_sums(g, w, what)


def test_edge_kernels_reject_what_they_cannot_run(card):
    kfe, a = _edge_inputs(card, "k8_n128")
    with pytest.raises(ValueError, match="k <= min"):
        kfe.edge_knn_eval(a["x"], a["q"], a["off"], a["st"], 65)
    with pytest.raises(ValueError, match="width C=6"):
        kfe.edge_knn_f1(a["x"], a["q"][..., :6], a["off"][..., :6], 8)
    with pytest.raises(ValueError, match="bfloat16"):
        kfe.edge_knn_f1(a["x"], a["q"].float(), a["off"], 8)
    with pytest.raises(ValueError, match="shared memory"):
        kfe.edge_knn_eval(torch.zeros((1, 128, 1024), device=card),
                          a["q"][:1], a["off"][:1], a["st"], 8)


@pytest.mark.parametrize("n", [128, 1024])
def test_dgcnn_predictor_card_matches_cpu(card, n):
    """DGCNN served on the card (the eval kernel, bf16 dense operands)
    and on the CPU (plain versions, f32 dense layers) from the same
    weights: probabilities within 5e-3."""
    variables = random_jax_variables(get_cls_model("dgcnn"), seed=3)
    rng = np.random.default_rng(n)
    x = rng.standard_normal((6, n, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    from pointcloudlib_tpu_torch.ops.kernels import fused_edge as kfe

    before = kfe.edge_knn_eval.launches
    got = Predictor.from_variables("dgcnn", variables,
                                   batch_size=4).predict_proba(x)
    assert kfe.edge_knn_eval.launches == before + 2 * 4
    want = Predictor.from_variables("dgcnn", variables, batch_size=4,
                                    device="cpu").predict_proba(x)
    assert np.abs(got - want).max() <= 5e-3, np.abs(got - want).max()


def test_dgcnn_train_step_card_matches_cpu(card):
    """One train-mode forward and backward of DGCNN on 8 synthetic clouds
    at N=1024, on the card and on the CPU from the same weights with
    dropout 0, under ``tools/grad_check.py``'s bounds. Not compared, as
    exactly 0: ``fc2``'s Dense bias (its own train-mode BatchNorm removes
    the shift)."""
    from pointcloudlib_tpu_torch.tools.grad_check import (
        grad_agreement,
        synthetic_batch,
    )

    variables = random_jax_variables(get_cls_model("dgcnn"), seed=5)
    got = grad_agreement("dgcnn", variables,
                         synthetic_batch("dgcnn", 8, 11, 1024), card)
    agree = got["agree"]
    print("dgcnn card against CPU: least cosine",
          min(agree.items(), key=lambda kv: kv[1][0]),
          "largest norm deviation",
          max(agree.items(), key=lambda kv: abs(kv[1][1] - 1)),
          "not compared", got["not_compared"])
    assert not got["failures"], got["failures"]
    assert set(got["not_compared"]) == {"fc2.dense.bias"}, got["not_compared"]


# ------------------------------------------- N = 4096: sorting and SSG


def test_hilbert_keys_card_matches_cpu(card):
    """Keys and sort order on the card bit-identical to the CPU's (true
    divisions and separate f32 operations on both), at N=4096 with
    duplicate points and a flat cloud."""
    from pointcloudlib_tpu_torch.ops import spatial

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((4, 4096, 3)).astype(
        np.float32))
    x[1, 2048:] = x[1, :2048]
    x[2, :, 2] = 0.5
    for a in (x, x * 37.0 + 5.0):
        assert torch.equal(spatial.hilbert_keys(a.to(card)).cpu(),
                           spatial.hilbert_keys(a))
        assert torch.equal(spatial.canonicalize(a.to(card))[-1].cpu(),
                           spatial.canonicalize(a)[-1])


def test_ssg_predictor_4096_card_matches_cpu(card):
    """PointNet++ SSG served at the 4096 bucket (3 clouds of 3,000 points:
    padding, then sorting): per batch FPS 2, the ball query and the eval
    kernel that takes its idx at SA1, the ball-query eval kernel at SA2;
    probabilities within 5e-3 of the CPU's."""
    from pointcloudlib_tpu_torch.ops.kernels import fused_sa_train as ft

    rng = np.random.default_rng(30)
    x = rng.standard_normal((3, 3000, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    nrm = rng.standard_normal((3, 3000, 3)).astype(np.float32)
    variables = random_jax_variables(get_cls_model("pointnet2"), seed=6)
    counted = (kfps.fps, kbq.ball_query, kfs.fused_sa_eval,
               kfs.fused_sa_bq_eval, ft.sa_f1)
    before = [f.launches for f in counted]
    got = Predictor.from_variables("pointnet2", variables, batch_size=2,
                                   device=card).predict_proba(x, nrm)
    assert [f.launches - b for f, b in zip(counted, before)] == [
        4, 2, 2, 2, 0]
    want = Predictor.from_variables("pointnet2", variables, batch_size=2,
                                    device="cpu").predict_proba(x, nrm)
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)


def test_ssg_train_step_4096_card_matches_cpu(card):
    """One train-mode forward and backward of PointNet++ SSG on 8 clouds
    at N=4096 (SA1 from the ball query's idx), card against CPU under
    ``tools/grad_check.py``'s bounds. (On 4 clouds the head's train-mode
    BatchNorm makes the comparison ill-conditioned: on the CPU, bf16
    dense operands against f32 move head gradients to cosine 0.58 at
    N=1024.)"""
    from pointcloudlib_tpu_torch.tools.grad_check import (
        grad_agreement,
        synthetic_batch,
    )

    variables = random_jax_variables(get_cls_model("pointnet2"), seed=5)
    got = grad_agreement("pointnet2", variables,
                         synthetic_batch("pointnet2", 8, 12, 4096), card)
    agree = got["agree"]
    print("SSG N=4096 card against CPU: least cosine",
          min(agree.items(), key=lambda kv: kv[1][0]),
          "largest norm deviation",
          max(agree.items(), key=lambda kv: abs(kv[1][1] - 1)),
          "not compared", got["not_compared"])
    assert not got["failures"], got["failures"]
    assert set(got["not_compared"]) <= {"sa3.mlp.2.bn.bias"}


# --------------------------------------- N % 128 != 0: DGCNN's kNN route

KNN_SHAPES = {  # B, M (queries), N, C, k
    "ec1_n1000": (4, 1000, 1000, 3, 20),
    "ec2_n1000": (4, 1000, 1000, 64, 20),
    "ec4_n1000": (4, 1000, 1000, 128, 20),
    "ec1_n10000": (2, 10000, 10000, 3, 20),
    "ec4_n10000": (1, 10000, 10000, 128, 20),
    "k_eq_n": (2, 20, 20, 64, 20),
    "m_ne_n": (2, 77, 65, 3, 40),       # a query cloud of its own
    "n16384_c128": (1, 16384, 16384, 128, 8),
    "ec1_duplicates": (4, 1000, 1000, 3, 20),
    "ec2_n10000": (1, 10000, 10000, 64, 20),
    "dseg_k40_c64": (2, 1000, 1000, 64, 40),  # part seg's kNN route
    "pointconv_m512_n1024": (4, 512, 1024, 3, 32),
    "all_equal": (2, 2000, 2000, 64, 20),     # every d² ties: the index
    "translated_1e3": (2, 2000, 2000, 64, 20),  # the expanded form cancels
    "m257_n129_c64": (2, 257, 129, 64, 20),   # one past the 64-point tile
    "m257_n129_c128": (2, 257, 129, 128, 20),  # and the 128 / 256-query
    # blocks; C = 160: the 256-query select instance does not fit, the
    # 128-query one with the fast pass does
    "c160_n2048": (2, 2048, 2048, 160, 16),
}


def _knn_inputs(card, name):
    b, m, n, c, k = KNN_SHAPES[name]
    rng = np.random.default_rng(m + n + c)
    p = torch.from_numpy(rng.standard_normal((b, n, c)).astype(
        np.float32)).to(card)
    if "duplicates" in name:
        p[:, n // 2:] = p[:, : n // 2]
    if name == "all_equal":
        p[:] = p[:, :1]
    if name == "translated_1e3":
        p += 1e3
    q = p if m == n else torch.from_numpy(rng.standard_normal(
        (b, m, c)).astype(np.float32)).to(card)
    return q, p, k


@pytest.mark.parametrize("name", sorted(KNN_SHAPES))
def test_knn_bit_identical(card, name):
    """idx and d² equal to the plain version's (d² without FMA, channel
    by channel, ties to the lower index)."""
    from pointcloudlib_tpu_torch.ops.kernels import knn as kknn

    q, p, k = _knn_inputs(card, name)
    before = kknn.knn.launches
    d2, idx = kknn.knn(q, p, k)
    torch.cuda.synchronize()
    assert kknn.knn.launches == before + 1
    wd2, widx = kknn.knn_plain(q, p, k)
    assert idx.dtype == torch.int32 and torch.equal(idx, widx)
    assert torch.equal(d2, wd2)
    if name == "c160_n2048":
        b, m, c = q.shape
        route = kknn.knn_route(b, m, p.shape[1], c, k)
        assert kknn.SELECT[route] == (4, 3, True)
    if "duplicates" in name:  # a point and its twin, both at d² = 0
        n = idx.shape[1]
        pts = torch.arange(n, device=card) % (n // 2)
        assert torch.equal(idx[:, :, 0].long(), pts.expand(idx.shape[0], -1))
        assert torch.equal(idx[:, :, 1].long(),
                           (pts + n // 2).expand(idx.shape[0], -1))


@pytest.mark.parametrize("name", sorted(KNN_SHAPES))
def test_knn_every_route_bit_identical(card, name, monkeypatch):
    """Every route the launcher has (the block route and each select
    instance, with and without the FMA pass) that takes these shapes,
    each forced in turn through ``knn_route``: idx and d² equal to the
    plain version's."""
    from pointcloudlib_tpu_torch.ops.kernels import knn as kknn
    from pointcloudlib_tpu_torch.ops.kernels.fused_sa import _SMEM_LIMIT

    q, p, k = _knn_inputs(card, name)
    c = q.shape[2]
    k = min(k, p.shape[1])
    wd2, widx = kknn.knn_plain(q, p, k)
    routes = [0] if kknn.block_smem(c, k) <= _SMEM_LIMIT else []
    routes += [r for r, (qpt, stages, fast) in kknn.SELECT.items()
               if kknn.select_smem(qpt, stages, c) <= _SMEM_LIMIT
               and not (fast and c % 4)
               and not (qpt == 8 and k > kknn._SEL_MAX_K8)]
    assert len(routes) >= 2
    for route in routes:
        monkeypatch.setattr(kknn, "knn_route", lambda *_, r=route: r)
        d2, idx = kknn.knn(q, p, k)
        torch.cuda.synchronize()
        assert torch.equal(idx, widx), kknn.route_name(route)
        assert torch.equal(d2, wd2), kknn.route_name(route)


@pytest.mark.parametrize("b,m,n,c,k", [
    (16, 256, 256, 3, 41),    # KPConv's layer 2 at 4,096 points
    (16, 64, 256, 3, 41),     # its pools into layer 3
    (16, 312, 312, 3, 42),    # layer 2 at 5,000 points
    (2, 80, 80, 3, 76),       # the deformable radius's calibrated limit
    (2, 300, 1000, 3, 256),
    (2, 77, 500, 64, 76),     # C ≠ 3: the key row from global memory
    (3, 5, 1000, 3, 300),     # more neighbours than a block's 256 threads
    (2, 333, 333, 3, 41),     # M not a multiple of the block's warps
])
def test_knn_rank_route_bit_identical(card, b, m, n, c, k):
    """Lists longer than 40 take the rank route: idx and d² equal to
    ``knn_plain``'s, on clouds with duplicated points (exact ties) and
    supports masked at 1e9 as KPConv's pyramid masks them."""
    from pointcloudlib_tpu_torch.ops.kernels import knn as kknn

    rng = np.random.default_rng(n + k + c)
    p = torch.from_numpy(rng.standard_normal((b, n, c)).astype(
        np.float32)).to(card)
    p[:, n // 2:n // 2 + 10] = p[:, :10]
    p[:, -5:] = 1e9
    q = p[:, :m].contiguous()
    assert kknn.knn_route(b, m, n, c, k) == kknn.RANK_ROUTE
    before = kknn.knn.launches_by_route[kknn.RANK_ROUTE]
    d2, idx = kknn.knn(q, p, k)
    torch.cuda.synchronize()
    assert kknn.knn.launches_by_route[kknn.RANK_ROUTE] == before + 1
    wd2, widx = kknn.knn_plain(q, p, k)
    assert torch.equal(idx, widx) and torch.equal(d2, wd2)


def test_knn_rejects_what_it_cannot_run(card):
    from pointcloudlib_tpu_torch.ops.kernels import knn as kknn

    x = torch.zeros((1, 64, 3), device=card)
    big = torch.zeros((1, 60000, 3), device=card)
    with pytest.raises(ValueError, match="rank route"):
        kknn.knn(big[:, :4], big, 41)
    with pytest.raises(ValueError, match="shared memory"):
        kknn.knn(torch.zeros((1, 64, 500), device=card),
                 torch.zeros((1, 64, 500), device=card), 8)
    with pytest.raises(ValueError, match="float32"):
        kknn.knn(x.double(), x.double(), 8)
    d2, idx = kknn.knn(x[:, :5], x[:, :5], 8)  # k > N: the last repeats
    assert idx.shape == (1, 5, 8) and torch.equal(idx[..., 5:],
                                                  idx[..., 4:5].expand(
                                                      1, 5, 3))


@pytest.mark.parametrize("name", sorted({**EDGE_SHAPES, **F1_SHAPES}))
def test_edge_f1_eval_out_match_plain(card, name):
    """The EdgeConv kernels that take a given index (the kNN's): pass 1's
    bf16 h bit-identical and Σ/Σ² within 1e-3 of the largest; eval
    bit-identical (``torch.equal``); where k ≤ N, the kernel with the kNN
    inside gives the same eval output."""
    kfe, a = _edge_inputs(card, name, seed=3)
    from pointcloudlib_tpu_torch.ops.kernels import knn as kknn

    idx = kknn.knn(a["x"], a["x"], a["k"])[1]
    before = kfe.edge_f1.launches, kfe.edge_eval.launches
    h, psum = kfe.edge_f1(a["q"], a["off"], idx)
    got = kfe.edge_eval(a["q"], a["off"], idx, a["st"])
    torch.cuda.synchronize()
    assert (kfe.edge_f1.launches, kfe.edge_eval.launches) == (
        before[0] + 1, before[1] + 1)
    wh, wpsum = kfe.edge_f1_plain(a["q"], a["off"], idx)
    assert torch.equal(h.view(torch.int16), wh.view(torch.int16))
    _close_sums(psum, wpsum, "psum")
    want = kfe.edge_eval_plain(a["q"], a["off"], idx, a["st"])
    assert torch.equal(got, want)
    if a["k"] <= a["x"].shape[1]:
        # the kNN-inside kernels give the same from the same neighbours
        torch.testing.assert_close(got, kfe.edge_knn_eval(
            a["x"], a["q"], a["off"], a["st"], a["k"]), rtol=0,
            atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("name", ["ec1", "ec4", "seg_pair1", "f1_c256_k40",
                                  "f1_k_over_n"])
def test_edge_f1_every_route_bit_identical(card, name, monkeypatch):
    """``edge_f1`` on each route that takes the width, forced by
    replacing ``edge_f1_route``: h bit-identical to the plain version,
    Σ/Σ² within 1e-3 of the largest, one launch a call."""
    kfe, a = _edge_inputs(card, name, seed=4)
    from pointcloudlib_tpu_torch.ops.kernels import knn as kknn

    idx = kknn.knn(a["x"], a["x"], a["k"])[1]
    wh, wpsum = kfe.edge_f1_plain(a["q"], a["off"], idx)
    c = a["q"].shape[-1]
    routes = [r for r in kfe.EDGE_F1_ROUTES if kfe.edge_f1_route_fits(r, c)]
    assert routes == [0, 1]
    for route in routes:
        monkeypatch.setattr(kfe, "edge_f1_route", lambda c, r=route: r)
        before = kfe.edge_f1.launches
        h, psum = kfe.edge_f1(a["q"], a["off"], idx)
        torch.cuda.synchronize()
        assert kfe.edge_f1.launches == before + 1
        assert torch.equal(h.view(torch.int16), wh.view(torch.int16)), route
        _close_sums(psum, wpsum, f"psum, route {route}")


@pytest.mark.parametrize("name", ["ec1", "ec3", "ec4", "n65", "seg_pair2",
                                  "f1_c256_k40", "f1_k_over_n", "k8_n128",
                                  "eval_signed_scales", "eval_k33"])
def test_edge_eval_every_route_bit_identical(card, name, monkeypatch):
    """``edge_eval`` on each route that takes the width (rows everywhere,
    center at C = 64, 128 and 256), forced by replacing
    ``edge_eval_route``: out ``torch.equal`` to the plain version, one
    launch a call. The cases: DGCNN's widths, N one past a 64-row block,
    k = 40 at C = 64 and 256, k > N (the kNN repeats its last index in a
    row), C = 32 (rows only), BN scales of both signs and 0, k = 33."""
    kfe, a = _edge_inputs(card, name, seed=5)
    from pointcloudlib_tpu_torch.ops.kernels import knn as kknn

    idx = kknn.knn(a["x"], a["x"], a["k"])[1]
    args = (a["q"], a["off"], idx, a["st"])
    want = kfe.edge_eval_plain(*args)
    c = a["q"].shape[-1]
    routes = [r for r in kfe.EDGE_EVAL_ROUTES
              if kfe.edge_eval_route_fits(r, c)]
    assert routes == ([0] if c == 32 else [0, 1])
    for route in routes:
        monkeypatch.setattr(kfe, "edge_eval_route", lambda c, r=route: r)
        before = kfe.edge_eval.launches
        got = kfe.edge_eval(*args)
        torch.cuda.synchronize()
        assert kfe.edge_eval.launches == before + 1
        assert torch.equal(got, want), kfe.EDGE_EVAL_ROUTES[route]


def test_given_index_edge_kernels_reject_what_they_cannot_run(card,
                                                              monkeypatch):
    """Widths and index types the kernels do not take raise; ``edge_eval``
    raises one past each route's own shared-memory limit, naming the
    route, and runs at the limit."""
    from pointcloudlib_tpu_torch.ops.kernels.fused_sa import _SMEM_LIMIT

    kfe, a = _edge_inputs(card, "k8_n128")
    idx = torch.zeros((2, 128, 8), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="width C=6"):
        kfe.edge_f1(a["q"][..., :6], a["off"][..., :6], idx)
    with pytest.raises(ValueError, match="int32"):
        kfe.edge_eval(a["q"], a["off"], idx.long(), a["st"])
    kfe, a = _edge_inputs(card, "n65")  # C = 64: both routes take it
    q, off = a["q"][:1, :16], a["off"][:1, :16]
    smem = kfe._lib("edge_eval").edge_eval_smem
    for route, name in kfe.EDGE_EVAL_ROUTES.items():
        monkeypatch.setattr(kfe, "edge_eval_route", lambda c, r=route: r)
        limit = max(k for k in range(1, 10000)
                    if smem(64, k, route) <= _SMEM_LIMIT)
        idx = torch.randint(0, 16, (1, 16, limit + 1), dtype=torch.int32,
                            device=card)
        with pytest.raises(ValueError, match=f"shared memory on the {name} "
                                             f"route"):
            kfe.edge_eval(q, off, idx, a["st"])
        idx = idx[..., :limit].contiguous()
        assert torch.equal(kfe.edge_eval(q, off, idx, a["st"]),
                           kfe.edge_eval_plain(q, off, idx, a["st"])), name


@pytest.mark.parametrize("n", [100, 1000])
def test_dgcnn_knn_route_card_matches_cpu(card, n):
    """DGCNN in eval mode at N % 128 ≠ 0 on the card (4 launches of the
    kNN and of ``edge_eval``, none of the kNN-inside kernels) and on the
    CPU: probabilities within 5e-3. (The Predictor pads these N to a
    bucket of a multiple of 128; it takes this route above 4096.)"""
    from pointcloudlib_tpu_torch.ops.kernels import fused_edge as kfe
    from pointcloudlib_tpu_torch.ops.kernels import knn as kknn

    variables = random_jax_variables(get_cls_model("dgcnn"), seed=3)
    rng = np.random.default_rng(n)
    x = rng.standard_normal((6, n, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    counted = (kknn.knn, kfe.edge_eval, kfe.edge_knn_eval)
    probs = []
    for dev in (card, torch.device("cpu")):
        model = get_cls_model("dgcnn")
        from_jax_variables(model, variables)
        model = model.to(dev).eval()
        before = [f.launches for f in counted]
        with torch.no_grad():
            probs.append(torch.softmax(model(torch.from_numpy(x).to(dev)),
                                       -1).cpu().numpy())
        if dev == card:
            assert [f.launches - b for f, b in zip(counted, before)] == [
                4, 4, 0]
    assert np.abs(probs[0] - probs[1]).max() <= 5e-3


def test_dgcnn_predictor_above_4096_card_matches_cpu(card):
    """2 clouds of 4,200 points keep N (no padding, no sort) and take the
    kNN and ``edge_eval`` on the card: 4 launches each; probabilities
    within 5e-3 of the CPU's."""
    from pointcloudlib_tpu_torch.ops.kernels import fused_edge as kfe
    from pointcloudlib_tpu_torch.ops.kernels import knn as kknn

    variables = random_jax_variables(get_cls_model("dgcnn"), seed=4)
    rng = np.random.default_rng(4200)
    x = rng.standard_normal((2, 4200, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    before = kknn.knn.launches, kfe.edge_eval.launches
    got = Predictor.from_variables("dgcnn", variables,
                                   batch_size=2).predict_proba(x)
    assert (kknn.knn.launches, kfe.edge_eval.launches) == (
        before[0] + 4, before[1] + 4)
    want = Predictor.from_variables("dgcnn", variables, batch_size=2,
                                    device="cpu").predict_proba(x)
    assert np.abs(got - want).max() <= 5e-3, np.abs(got - want).max()


def test_dgcnn_knn_route_train_step_card_matches_cpu(card):
    """One train-mode forward and backward of DGCNN on 8 synthetic clouds
    at N=1000 (the kNN, ``edge_f1``, ``edge_out``, ``edge_bwd``), card
    against CPU under ``tools/grad_check.py``'s bounds."""
    from pointcloudlib_tpu_torch.tools.grad_check import (
        grad_agreement,
        synthetic_batch,
    )

    variables = random_jax_variables(get_cls_model("dgcnn"), seed=5)
    got = grad_agreement("dgcnn", variables,
                         synthetic_batch("dgcnn", 8, 11, 1000), card)
    agree = got["agree"]
    print("dgcnn N=1000 card against CPU: least cosine",
          min(agree.items(), key=lambda kv: kv[1][0]),
          "largest norm deviation",
          max(agree.items(), key=lambda kv: abs(kv[1][1] - 1)))
    assert not got["failures"], got["failures"]
    assert set(got["not_compared"]) == {"fc2.dense.bias"}, got["not_compared"]


# ----------------------------- DGCNN part segmentation: two-layer EdgeConv

EDGE2_SHAPES = {  # B, N, k, C_in: the two pairs at k=40, and edge cases
    "pair1": (4, 2048, 40, 3),
    "pair2": (4, 2048, 40, 64),
    "pair1_duplicates": (4, 1024, 40, 3),
    "n1000": (2, 1000, 40, 64),          # the given-index route's N
    "n65": (2, 65, 20, 64),              # one past the 64-point tile
    "k8_n128": (2, 128, 8, 3),
    "duplicates_n2048": (2, 2048, 40, 3),  # max-pool ties across tiles
    "n100_b3": (3, 100, 20, 64),         # 300 centers: a part tile
    "kink_band": (2, 2048, 40, 64),      # many z2 within 2^-13 of 0
}
# the eval kernel with the kNN inside: part seg's served pair 2 (B=16), a
# cloud of duplicated points at N = 2,048 (ties at the k-th slot), and
# BN2 scales of 1e3
EVAL2_SHAPES = {
    "serve_pair2": (16, 2048, 40, 64),
    "serve_duplicates": (4, 2048, 40, 64),
    "bn2_large": (2, 2048, 40, 64),
}
# the forward tails: part seg's train shape (pair 2, B=16: 512 tiles, more
# than any resident grid), its kNN route's N at B=16, fewer centers than
# one tile of 64, and BN2 scales below 0 in every other channel (out takes
# h2's min there); with EVAL2_SHAPES' BN2 scales of 1e3
TAIL2_SHAPES = {
    "train_pair2": (16, 2048, 40, 64),
    "n1000_b16": (16, 1000, 40, 64),
    "n40_b1": (1, 40, 20, 64),
    "bn2_negative": (2, 1000, 40, 64),
}


# edge2_eval from the kNN's index: both pairs on part seg's kNN route
# (B=16, N=1,000), and with TAIL2_SHAPES' fewer centers than one tile and
# BN2 scales below 0, lists whose every other entry repeats the one
# before it
EVAL2_IDX_SHAPES = {
    "pair1_n1000": (16, 1000, 40, 3),
    "repeated_n1000": (2, 1000, 40, 64),
}


def _edge2_inputs(card, name, seed=0):
    """The two-layer kernels' inputs at C1 = C2 = 64: ``x``, ``q``
    (bf16), ``off``, W2, the plain pass 1's neighbour index and bf16
    checkpoint ``h1``, the folded BN rows of h1's and h2's own batch
    moments (random γ, β) and an output gradient. The duplicates case
    repeats the first half of each cloud (exact kNN and max-pool
    ties); the kink-band case scales every other channel of layer 2 by
    1e-4 with no shift, so that most of its z2 lie within 2^-13 of 0,
    the band where the backward passes take h2 from the plain product's
    sum."""
    from pointcloudlib_tpu_torch.ops.kernels import fused_edge as kfe
    from pointcloudlib_tpu_torch.ops.kernels.fused_sa_train import _moments

    b, n, k, cin = {**EDGE2_SHAPES, **EVAL2_SHAPES, **TAIL2_SHAPES,
                    **EVAL2_IDX_SHAPES}[name]
    rng = np.random.default_rng(seed + n + cin + k)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(card)

    x = t(b, n, cin)
    if "duplicates" in name:
        x[:, n // 2:] = x[:, : n // 2]
    wa, wb = t(cin, 64, scale=cin ** -0.5), t(cin, 64, scale=cin ** -0.5)
    q = (x.bfloat16().float() @ wa.bfloat16().float()).bfloat16()
    off = x.bfloat16().float() @ (wa - wb).bfloat16().float()
    w2 = t(64, 64, scale=1 / 8)
    idx, h1, psum = kfe.edge_knn_f1_plain(x, q, off, k)
    r = float(b * n * k)
    st1 = kfs._stack_stats(*_moments(psum, r), t(64, scale=0.2) + 1.0,
                           t(64, scale=0.1))
    g2, b2 = t(64, scale=0.2) + 1.0, t(64, scale=0.1)
    if name == "kink_band":  # z2 = (h2 − mean)·1e-4/σ, every other channel
        g2[::2], b2[::2] = 1e-4, 0.0
    if name == "bn2_large":
        g2 = g2 * 1e3
    if name == "bn2_negative":
        g2[1::2] = -g2[1::2]
    st2 = kfs._stack_stats(*_moments(kfe.edge2_stats2_plain(h1, st1, w2),
                                     r), g2, b2)
    return kfe, dict(x=x, q=q, off=off, w2=w2, idx=idx, h1=h1, st1=st1,
                     st2=st2, k=k, r=r, dout=t(b, n, 64))


@pytest.mark.parametrize("name", sorted(EDGE2_SHAPES))
def test_edge2_eval_kernels_match_plain(card, name):
    """``edge2_knn_eval`` (the kNN inside) and ``edge2_eval`` (the plain
    kNN's index given): the same neighbours and a bit-identical y1, then
    h2 summed in another order: within 1e-5 of the largest plain
    element."""
    kfe, a = _edge2_inputs(card, name)
    st = (a["st1"], a["st2"], a["w2"])
    before = kfe.edge2_knn_eval.launches, kfe.edge2_eval.launches
    got = kfe.edge2_knn_eval(a["x"], a["q"], a["off"], *st, a["k"])
    got_idx = kfe.edge2_eval(a["q"], a["off"], a["idx"], *st)
    torch.cuda.synchronize()
    assert (kfe.edge2_knn_eval.launches, kfe.edge2_eval.launches) == (
        before[0] + 1, before[1] + 1)
    want = kfe.edge2_knn_eval_plain(a["x"], a["q"], a["off"], *st, a["k"])
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())
    torch.testing.assert_close(got_idx, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("name", sorted({**EDGE2_SHAPES, **EVAL2_SHAPES}))
def test_edge2_knn_eval_every_route_matches_plain(card, name, monkeypatch):
    """Every route of ``edge2_knn_eval``'s launcher that takes these
    shapes, each forced in turn through ``knn.edge_eval_route``: within
    1e-5 of the largest plain element (the same lists and y1, h2 summed
    by the tensor cores on the select route), one launch a call. Part
    seg's shapes take the select route, N ≤ 1,024 the block route."""
    from pointcloudlib_tpu_torch.ops.kernels import knn as kknn

    kfe, a = _edge2_inputs(card, name, seed=3)
    args = (a["x"], a["q"], a["off"], a["st1"], a["st2"], a["w2"], a["k"])
    b, n, cin = a["x"].shape
    route = kknn.edge_eval_route(b, n, cin, 64, a["k"], layers=2)
    assert (route != 0) == (n >= 2048), route
    want = kfe.edge2_knn_eval_plain(*args)
    routes = [r for r in kknn.EDGE_ROUTES
              if kknn.edge_eval_route_fits(r, n, cin, 64, a["k"], 2)]
    assert routes and (a["k"] < 9 or len(routes) >= 2), routes
    for r in routes:
        monkeypatch.setattr(kknn, "edge_eval_route", lambda *_, r=r, **__: r)
        before = kfe.edge2_knn_eval.launches
        got = kfe.edge2_knn_eval(*args)
        torch.cuda.synchronize()
        assert kfe.edge2_knn_eval.launches == before + 1
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * want.abs().max().item(),
                                   msg=kknn.edge_route_name(r, 2))


@pytest.mark.parametrize("name", sorted({**EDGE2_SHAPES, **TAIL2_SHAPES})
                         + ["bn2_large"])
def test_edge2_tail_matches_plain(card, name):
    """``edge2_stats2``: Σ/Σ² within 1e-3 of the largest (f32 atomics in
    another order); ``edge2_out`` within 1e-5 of the largest plain
    element (h2 summed by the tensor cores)."""
    kfe, a = _edge2_inputs(card, name, seed=1)
    before = kfe.edge2_stats2.launches, kfe.edge2_out.launches
    ps = kfe.edge2_stats2(a["h1"], a["st1"], a["w2"])
    out = kfe.edge2_out(a["h1"], a["st1"], a["st2"], a["w2"])
    torch.cuda.synchronize()
    assert (kfe.edge2_stats2.launches, kfe.edge2_out.launches) == (
        before[0] + 1, before[1] + 1)
    _close_sums(ps, kfe.edge2_stats2_plain(a["h1"], a["st1"], a["w2"]),
                "stats2")
    want = kfe.edge2_out_plain(a["h1"], a["st1"], a["st2"], a["w2"])
    torch.testing.assert_close(out, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("name", sorted(EDGE2_SHAPES))
def test_edge2_bwd_matches_plain(card, name):
    """``edge2_p1``: ps2, vecs and mats within 1e-3 of the largest;
    ``edge2_p2`` from the plain pass 1's sums (``_combine_p1``): dq and
    doff tie-robust (a last-bit change of h2 may move a max-pool tie
    share)."""
    from pointcloudlib_tpu_torch.ops.kernels.fused_sa_train import (
        _combine_p1,
    )

    kfe, a = _edge2_inputs(card, name, seed=2)
    p1 = (a["h1"], a["dout"], a["st1"], a["st2"], a["w2"])
    before = kfe.edge2_p1.launches, kfe.edge2_p2.launches
    got = kfe.edge2_p1(*p1)
    want = kfe.edge2_p1_plain(*p1)
    for g, w, what in zip(got, want, ("ps2", "vecs", "mats")):
        _close_sums(g, w, what)
    ps2, vecs, mats = want
    _, s1 = _combine_p1(ps2, vecs, mats, a["st2"], a["w2"], a["r"])
    p2 = (a["h1"], a["dout"], a["idx"], a["st1"], a["st2"], a["w2"],
          ps2 / a["r"], s1 / a["r"], 0.2, a["h1"].shape[1])
    got = kfe.edge2_p2(*p2)
    torch.cuda.synchronize()
    assert (kfe.edge2_p1.launches, kfe.edge2_p2.launches) == (
        before[0] + 1, before[1] + 1)
    for g, w, what in zip(got, kfe.edge2_p2_plain(*p2), ("dq", "doff")):
        _tie_robust(g, w, what)


@pytest.mark.parametrize("name", ["pair1_n1000", "n1000_b16", "n40_b1",
                                  "bn2_negative", "repeated_n1000"])
def test_edge2_eval_idx_shapes_match_plain(card, name):
    """``edge2_eval`` on the kNN route's pairs and edge cases, one launch
    a call: within 1e-5 of the largest plain element (a bit-identical y1,
    h2 summed in another order on the tensor cores)."""
    kfe, a = _edge2_inputs(card, name, seed=7)
    idx = a["idx"]
    if "repeated" in name:
        idx[..., 1::2] = idx[..., ::2]
    args = (a["q"], a["off"], idx, a["st1"], a["st2"], a["w2"])
    before = kfe.edge2_eval.launches
    got = kfe.edge2_eval(*args)
    torch.cuda.synchronize()
    assert kfe.edge2_eval.launches == before + 1
    want = kfe.edge2_eval_plain(*args)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


def test_edge2_kernels_reject_what_they_cannot_run(card):
    kfe, a = _edge2_inputs(card, "k8_n128")
    st = (a["st1"], a["st2"], a["w2"])
    with pytest.raises(ValueError, match="k <= min"):
        kfe.edge2_knn_eval(a["x"], a["q"], a["off"], *st, 41)
    with pytest.raises(ValueError, match="no kernel instance"):
        kfe.edge2_out(a["h1"][..., :32].contiguous(), a["st1"][:, :32],
                      a["st2"][:, :32], a["w2"][:32, :32])
    with pytest.raises(ValueError, match="bfloat16"):
        kfe.edge2_eval(a["q"].float(), a["off"], a["idx"], *st)


def _partseg_clouds(n, clouds=4, seed=0):
    from pointcloudlib_tpu_torch.data.synthetic import SyntheticShapeNetPart

    xyz, labels, _ = SyntheticShapeNetPart(n_points=n, size=clouds,
                                           seed=seed).batch(0, clouds)
    return xyz, labels


@pytest.mark.parametrize("n,counts", [
    (2048, {"edge2_knn_eval": 2, "edge_knn_eval": 1}),
    (1000, {"knn": 3, "edge2_eval": 2, "edge_eval": 1})])
def test_dgcnn_partseg_eval_card_matches_cpu(card, n, counts):
    """DGCNN part segmentation in eval mode on 4 clouds, on the card and on
    the CPU from the same weights: N=2048 builds the graph inside the
    kernels, N=1000 takes the standalone kNN and the given-index kernels,
    with exactly these launches; probabilities within 5e-3."""
    from pointcloudlib_tpu_torch.models import get_seg_model
    from pointcloudlib_tpu_torch.ops.kernels import fused_edge as kfe
    from pointcloudlib_tpu_torch.ops.kernels import knn as kknn

    counted = {"edge2_knn_eval": kfe.edge2_knn_eval,
               "edge2_eval": kfe.edge2_eval, "edge_knn_eval":
               kfe.edge_knn_eval, "edge_eval": kfe.edge_eval,
               "knn": kknn.knn}
    variables = random_jax_variables(get_seg_model("dgcnn"), seed=3)
    xyz, labels = _partseg_clouds(n)
    onehot = np.eye(16, dtype=np.float32)[labels]
    probs = []
    for dev in (card, torch.device("cpu")):
        model = get_seg_model("dgcnn")
        from_jax_variables(model, variables)
        model = model.to(dev).eval()
        before = {k: f.launches for k, f in counted.items()}
        with torch.no_grad():
            probs.append(torch.softmax(model(
                torch.from_numpy(xyz).to(dev),
                torch.from_numpy(onehot).to(dev)), -1).cpu().numpy())
        if dev == card:
            assert {k: f.launches - before[k] for k, f in counted.items()
                    } == {k: counts.get(k, 0) for k in counted}
    assert np.abs(probs[0] - probs[1]).max() <= 5e-3


@pytest.mark.parametrize("n", [2048, 1000])
def test_dgcnn_partseg_train_step_card_matches_cpu(card, n):
    """One train-mode forward and backward of DGCNN part segmentation on
    8 synthetic ShapeNet-part clouds, on the card and on the CPU from the
    same weights with dropout 0, under ``tools/grad_check.py``'s bounds:
    the kernels with the graph inside at N=2048, the standalone kNN and
    the given-index kernels at N=1000. Not compared where exactly 0:
    conv6's BN bias when every global max is positive."""
    from pointcloudlib_tpu_torch.models import get_seg_model
    from pointcloudlib_tpu_torch.tools.grad_check import (
        grad_agreement,
        synthetic_batch,
    )

    variables = random_jax_variables(get_seg_model("dgcnn"), seed=5)
    got = grad_agreement("dgcnn_partseg", variables,
                         synthetic_batch("dgcnn_partseg", 8, 11, n), card)
    agree = got["agree"]
    print(f"dgcnn_partseg N={n} card against CPU: least cosine",
          min(agree.items(), key=lambda kv: kv[1][0]),
          "largest norm deviation",
          max(agree.items(), key=lambda kv: abs(kv[1][1] - 1)),
          "not compared", got["not_compared"])
    assert not got["failures"], got["failures"]
    assert set(got["not_compared"]) <= {"conv6.bn.bias"}, got["not_compared"]


# ------------------------------------------- PointConv: gather, kNN+gather

GATHER_SHAPES = {  # B, N, C, idx shape after B
    "cls SA1 xyz+normals": (32, 1024, 6, (512, 32)),
    "cls SA1 density": (32, 1024, 1, (512, 32)),
    "seg decoder n=256": (16, 256, 512, (256, 16)),
    "seg decoder n=1024": (16, 1024, 256, (1024, 16)),
    "seg decoder n=2048": (16, 2048, 128, (2048, 16)),
    "2-D idx": (4, 300, 8, (77,)),
    "M=13, C=5": (3, 128, 5, (13, 7)),
    "C=2": (4, 700, 2, (96, 9)),
    "C=3": (4, 1024, 3, (128, 16)),
    "C=7, rows·C % 4 != 0": (3, 500, 7, (33, 5)),
    # a cloud too large to stage in shared memory (96 KB), and rows wider
    # than a warp's assembly buffer
    "C=6, N=4000 unstaged": (2, 4000, 6, (256, 8)),
    "C=37": (2, 200, 37, (40, 3)),
}


def _gather_inputs(card, name):
    """Random rows and indices, a few of them sentinels (N, N + 5, -1)."""
    b, n, c, rows = GATHER_SHAPES[name]
    rng = np.random.default_rng(n + c)
    pts = torch.from_numpy(rng.standard_normal((b, n, c)).astype(
        np.float32)).to(card)
    idx = rng.integers(0, n, (b, *rows)).astype(np.int32)
    flat = idx.reshape(-1)
    flat[:: max(1, flat.size // 7)] = n
    flat[1] = n + 5
    flat[2] = -1
    return pts, torch.from_numpy(idx).to(card)


@pytest.mark.parametrize("name", sorted(GATHER_SHAPES))
def test_gather_neighbors_bit_identical(card, name):
    """The row gather is an exact copy: bit-identical to the plain
    ``torch.gather``, zero rows at the sentinels; one launch."""
    from pointcloudlib_tpu_torch.ops.kernels import gather as kga

    pts, idx = _gather_inputs(card, name)
    before = kga.gather_neighbors.launches
    got = kga.gather_neighbors(pts, idx)
    torch.cuda.synchronize()
    assert kga.gather_neighbors.launches == before + 1
    want = kga.gather_neighbors_plain(pts, idx)
    assert got.shape == want.shape == (*idx.shape, pts.shape[-1])
    assert torch.equal(got, want)
    bad = (idx < 0) | (idx >= pts.shape[1])
    assert bad.any() and not got[bad].any()


@pytest.mark.parametrize("name", ["seg decoder n=1024", "2-D idx"])
def test_gather_neighbors_gradient(card, name):
    """``GatherNeighbors``' backward (the scatter-add kernel) against the
    gradient of the plain gather on the card, within 1e-5·max|plain|
    (f32 atomics in another order); sentinel rows add nothing."""
    from pointcloudlib_tpu_torch.ops.kernels import gather as kga

    pts, idx = _gather_inputs(card, name)
    g = torch.randn((*idx.shape, pts.shape[-1]), device=card,
                    generator=torch.Generator(device=card).manual_seed(0))
    grads = []
    for fn in (kga.GatherNeighbors.apply, kga.gather_neighbors_plain):
        p = pts.clone().requires_grad_(True)
        fn(p, idx).backward(g)
        grads.append(p.grad)
    err = (grads[0] - grads[1]).abs().max().item()
    assert err <= 1e-5 * grads[1].abs().max().item()


KNN_GATHER_SHAPES = {  # B, M, N, Cv, k, stride
    "cls SA2": (32, 128, 512, 132, 64, 1),
    "seg SA2": (16, 256, 1024, 68, 32, 1),
    "seg SA3": (16, 64, 256, 132, 32, 1),
    "k*stride = N": (2, 10, 64, 20, 32, 2),
    "stride 2, M=13, Cv=7": (3, 13, 256, 7, 16, 2),
    "N=4096": (2, 64, 4096, 16, 32, 1),
    "duplicate points": (2, 40, 256, 16, 48, 1),
    "cls SA2 duplicate points": (32, 128, 512, 132, 64, 1),
    "C=6, M=12": (2, 12, 256, 16, 24, 1),  # d² from global memory
}


def _knn_gather_inputs(card, name):
    b, m, n, cv, k, stride = KNN_GATHER_SHAPES[name]
    rng = np.random.default_rng(n + cv)
    c = 6 if name.startswith("C=6") else 3
    pts = rng.standard_normal((b, n, c)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    if "duplicate points" in name:  # every point four times: exact ties
        pts[:, n // 4:] = np.tile(pts[:, :n // 4], (1, 3, 1))
    query = pts[:, rng.permutation(n)[:m]].copy()
    vals = rng.standard_normal((b, n, cv)).astype(np.float32)
    vals[..., :3] = pts[..., :3]
    return (torch.from_numpy(query).to(card), torch.from_numpy(pts).to(card),
            torch.from_numpy(vals).to(card), k, stride)


@pytest.mark.parametrize("name", sorted(KNN_GATHER_SHAPES))
def test_knn_gather_bit_identical(card, name, monkeypatch):
    """idx and grouped bit-identical to ``knn_gather_plain`` (d² in the
    plain order, ties to the lower index, exact copies) on every route
    (rounds, select), each forced in turn through ``knn_gather_route``;
    one launch a call."""
    from pointcloudlib_tpu_torch.ops.kernels import knn_gather as kkg

    query, pts, vals, k, stride = _knn_gather_inputs(card, name)
    pidx, pgrouped = kkg.knn_gather_plain(query, pts, vals, k, stride)
    assert kkg.knn_gather_route(pts.shape[1], k, stride) == 1
    for route in kkg.ROUTES:
        monkeypatch.setattr(kkg, "knn_gather_route", lambda *_, r=route: r)
        before = kkg.knn_gather.launches
        idx, grouped = kkg.knn_gather(query, pts, vals, k, stride)
        torch.cuda.synchronize()
        assert kkg.knn_gather.launches == before + 1
        assert torch.equal(idx, pidx), kkg.ROUTES[route]
        assert torch.equal(grouped, pgrouped), kkg.ROUTES[route]


def test_knn_gather_gradient(card):
    """``KnnGather``'s backward (the scatter-add kernel) against the
    gradient of the plain version on the card within 1e-5·max|plain|;
    no gradient to the query or the points."""
    from pointcloudlib_tpu_torch.ops.kernels import knn_gather as kkg

    query, pts, vals, k, stride = _knn_gather_inputs(card, "seg SA2")
    g = torch.randn((*query.shape[:2], k, vals.shape[-1]), device=card,
                    generator=torch.Generator(device=card).manual_seed(0))
    grads = []
    for fn in (kkg.KnnGather.apply,
               lambda q, p, v, kk, s: kkg.knn_gather_plain(q, p, v, kk, s)):
        v = vals.clone().requires_grad_(True)
        q = query.clone().requires_grad_(True)
        fn(q, pts, v, k, stride)[1].backward(g)
        grads.append(v.grad)
        if fn is kkg.KnnGather.apply:
            assert q.grad is None
    err = (grads[0] - grads[1]).abs().max().item()
    assert err <= 1e-5 * grads[1].abs().max().item()


def test_pointconv_kernels_reject_what_they_cannot_run(card):
    from pointcloudlib_tpu_torch.ops.kernels import gather as kga
    from pointcloudlib_tpu_torch.ops.kernels import knn_gather as kkg

    pts = torch.zeros((1, 64, 3), device=card)
    idx = torch.zeros((1, 8, 4), device=card, dtype=torch.int32)
    with pytest.raises(TypeError, match="float32"):
        kga.gather_neighbors(pts.double(), idx)
    with pytest.raises(ValueError, match="idx"):
        kga.gather_neighbors(pts, idx[0])
    with pytest.raises(ValueError, match="k·stride <= N"):
        kkg.knn_gather(pts[:, :8], pts, pts, 33, 2)
    big = torch.zeros((1, kkg.MAX_POINTS + 1, 3), device=card)
    with pytest.raises(ValueError, match="above the kernel"):
        kkg.knn_gather(big[:, :8], big, big, 4)


@pytest.mark.parametrize("name,n,clouds,counts", [
    ("pointconv", 1024, 32, {"fps": 2, "knn": 1, "gather_neighbors": 2,
                             "knn_gather": 1}),
    ("pointconv_partseg", 2048, 4, {"fps": 4, "knn": 6,
                                    "gather_neighbors": 3, "knn_gather": 2,
                                    "three_interp": 4})])
def test_pointconv_eval_card_matches_cpu(card, name, n, clouds, counts):
    """PointConv classification (normals as features, 32 clouds: below
    that SA1's gathers fall under the cost gate) and part segmentation (4
    clouds) in eval mode on the card, with exactly these launches, and 4
    of the clouds on the CPU from the same weights: probabilities within
    5e-3 (eval mode treats each cloud on its own)."""
    from pointcloudlib_tpu_torch.ops.kernels import gather as kga
    from pointcloudlib_tpu_torch.ops.kernels import knn as kknn
    from pointcloudlib_tpu_torch.ops.kernels import knn_gather as kkg
    from pointcloudlib_tpu_torch.ops.kernels import three_interp as kti
    from pointcloudlib_tpu_torch.tools.grad_check import (
        SEG,
        build_model,
        synthetic_batch,
    )

    counted = {"fps": kfps.fps, "knn": kknn.knn,
               "gather_neighbors": kga.gather_neighbors,
               "knn_gather": kkg.knn_gather,
               "three_interp": kti.three_interp_fwd,
               "scatter_rows": kga.scatter_rows}
    variables = random_jax_variables(build_model(name), seed=3)
    batch = synthetic_batch(name, clouds, 7, n)
    probs = []
    for dev, rows in ((card, clouds), (torch.device("cpu"), 4)):
        model = build_model(name)
        from_jax_variables(model, variables)
        model = model.to(dev).eval()
        before = {k: f.launches for k, f in counted.items()}
        x = batch["xyz"][:rows].to(dev)
        with torch.no_grad():
            logits = (model(x, batch["cls_onehot"][:rows].to(dev))
                      if name in SEG
                      else model(x, batch["feats"][:rows].to(dev)))
        probs.append(torch.softmax(logits, -1)[:4].cpu().numpy())
        if dev == card:
            assert {k: f.launches - before[k] for k, f in counted.items()
                    } == {k: counts.get(k, 0) for k in counted}
    assert np.isfinite(probs[0]).all()
    assert np.abs(probs[0] - probs[1]).max() <= 5e-3


@pytest.mark.parametrize("name,n", [("pointconv", 1024),
                                    ("pointconv_partseg", 2048)])
def test_pointconv_train_step_card_matches_cpu(card, name, n):
    """One train-mode forward and backward of PointConv classification
    and part segmentation on 8 synthetic clouds, on the card and on the
    CPU from the same weights with dropout 0, under
    ``tools/grad_check.py``'s bounds; the Dense biases in front of a
    train-mode BatchNorm are exactly 0, not compared, and the first Dense
    weight of each DensityNet, a cancellation's residue, is held to the
    cosine bound alone."""
    from pointcloudlib_tpu_torch.tools.grad_check import (
        build_model,
        grad_agreement,
        synthetic_batch,
    )

    variables = random_jax_variables(build_model(name), seed=5)
    got = grad_agreement(name, variables, synthetic_batch(name, 8, 11, n),
                         card)
    agree = got["agree"]
    print(f"{name} card against CPU: least cosine",
          min(agree.items(), key=lambda kv: kv[1][0]),
          "largest norm deviation",
          max(agree.items(), key=lambda kv: abs(kv[1][1] - 1)),
          "not compared", got["not_compared"],
          "cosine only", got["cosine_only"])
    assert not got["failures"], got["failures"]
    assert all(k.endswith("dense.bias") for k in got["not_compared"]), \
        got["not_compared"]
    assert got["cosine_only"] and all(
        k.endswith("density_net.0.dense.weight")
        for k in got["cosine_only"]), got["cosine_only"]


# The fused kNN + gather at PointCNN's twelve launches: B, M (queries), N,
# Cv, k, stride; classification L1–L4 (B=32, N=1024), part segmentation's
# encoders E1–E4 and decoders D4–D1 (B=16, N=2048). A decoder's queries are
# the finer level's points, more than the coarse cloud it reads.
PCNN_KNN_GATHER_SHAPES = {
    "cls L1": (32, 1024, 1024, 27, 8, 1),
    "cls L2": (32, 384, 1024, 51, 12, 2),
    "cls L3": (32, 128, 384, 99, 16, 2),
    "cls L4": (32, 128, 128, 195, 16, 3),
    "seg E1": (16, 2048, 2048, 131, 8, 1),
    "seg E2": (16, 768, 2048, 131, 12, 1),
    "seg E3": (16, 384, 768, 259, 16, 1),
    "seg E4": (16, 128, 384, 515, 16, 1),
    "seg D4": (16, 128, 128, 515, 16, 1),
    "seg D3": (16, 384, 128, 259, 16, 1),
    "seg D2": (16, 768, 384, 131, 12, 1),
    "seg D1": (16, 2048, 768, 28, 8, 1),
}


def _pcnn_knn_gather_inputs(card, name):
    """Unit-sphere points, the queries a subset of them (or, for a
    decoder, all of them and more), values ``[xyz ‖ features]``."""
    b, m, n, cv, k, stride = PCNN_KNN_GATHER_SHAPES[name]
    rng = np.random.default_rng(m + n + cv)
    x = rng.standard_normal((b, max(m, n), 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    pts = x[:, :n]
    query = x[:, :m] if m > n else pts[:, rng.permutation(n)[:m]]
    vals = rng.standard_normal((b, n, cv)).astype(np.float32)
    vals[..., :3] = pts
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(card)
                 for a in (query, pts, vals)) + (k, stride)


@pytest.mark.parametrize("name", sorted(PCNN_KNN_GATHER_SHAPES))
def test_knn_gather_pointcnn_shapes_bit_identical(card, name):
    """At each PointCNN launch the wrapper takes the select route ((k −
    1)·stride + 1 ≤ 46 ranks) and its idx and values are bit-identical to
    ``knn_gather_plain``; one launch a call."""
    from pointcloudlib_tpu_torch.ops.kernels import knn_gather as kkg

    query, pts, vals, k, stride = _pcnn_knn_gather_inputs(card, name)
    assert kkg.ROUTES[kkg.knn_gather_route(pts.shape[1], k, stride)] == \
        "select"
    before = kkg.knn_gather.launches
    idx, grouped = kkg.knn_gather(query, pts, vals, k, stride)
    torch.cuda.synchronize()
    assert kkg.knn_gather.launches == before + 1
    pidx, pgrouped = kkg.knn_gather_plain(query, pts, vals, k, stride)
    assert torch.equal(idx, pidx)
    assert torch.equal(grouped, pgrouped)


@pytest.mark.parametrize("name", sorted(PCNN_KNN_GATHER_SHAPES))
def test_scatter_rows_pointcnn_backward_shapes(card, name):
    """The scatter-add of ``KnnGather``'s backward at each PointCNN
    launch: the grouped gradient ``[B, M, k, Cv]`` into ``[B, N, Cv]`` at
    the kernel's own idx, on the wide route (out[b] above 16 KB), within
    1e-5 of the largest plain element."""
    from pointcloudlib_tpu_torch.ops.kernels import gather as kga
    from pointcloudlib_tpu_torch.ops.kernels import knn_gather as kkg

    query, pts, vals, k, stride = _pcnn_knn_gather_inputs(card, name)
    b, n, cv = vals.shape
    idx, _ = kkg.knn_gather(query, pts, vals, k, stride)
    g = torch.randn((*idx.shape, cv), device=card,
                    generator=torch.Generator(device=card).manual_seed(n))
    assert kga.scatter_route(n, cv) == "wide"
    before = kga.scatter_rows.launches
    got = kga.scatter_rows(g, idx, n)
    torch.cuda.synchronize()
    assert kga.scatter_rows.launches == before + 1
    want = kga.scatter_rows_plain(g, idx, n)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("name,batch,counts", [
    ("pointnet", 64, {}),
    ("pointnet_partseg", 16, {}),
    ("pointcnn", 32, {"fps": 2, "knn_gather": 4}),
    ("pointcnn_partseg", 16, {"fps": 3, "knn_gather": 8})])
def test_pointnet_pointcnn_served_batch_card_matches_cpu(card, name, batch,
                                                         counts):
    """One served batch of PointNet and PointCNN classification (N=1024,
    xyz only) and part segmentation (N=2048) on the card through the
    Predictor and the SegPredictor, with exactly these launches (none for
    PointNet), and 2 of the clouds on the CPU from the same weights:
    probabilities within 5e-3."""
    from pointcloudlib_tpu_torch.inference import SegPredictor
    from pointcloudlib_tpu_torch.ops.kernels import gather as kga
    from pointcloudlib_tpu_torch.ops.kernels import knn as kknn
    from pointcloudlib_tpu_torch.ops.kernels import knn_gather as kkg
    from pointcloudlib_tpu_torch.ops.kernels import three_interp as kti
    from pointcloudlib_tpu_torch.tools.grad_check import (
        SEG,
        build_model,
        synthetic_batch,
    )

    counted = {"fps": kfps.fps, "ball_query": kbq.ball_query,
               "fused_sa_bq_eval": kfs.fused_sa_bq_eval, "knn": kknn.knn,
               "gather_neighbors": kga.gather_neighbors,
               "knn_gather": kkg.knn_gather,
               "three_interp": kti.three_interp_fwd,
               "scatter_rows": kga.scatter_rows}
    variables = random_jax_variables(build_model(name), seed=3)
    n = 2048 if name in SEG else 1024
    data = synthetic_batch(name, batch, 7, n)
    xyz = data["xyz"].numpy()
    probs = []
    for dev, rows in ((card, batch), ("cpu", 2)):
        if name in SEG:
            pred = SegPredictor.from_variables(SEG[name], variables,
                                               batch_size=rows, device=dev)
            serve = lambda: pred.predict_proba(  # noqa: E731
                xyz[:rows], data["cls_onehot"].numpy()[:rows].argmax(-1))
        else:
            pred = Predictor.from_variables(name, variables,
                                            batch_size=rows, device=dev)
            serve = lambda: pred.predict_proba(xyz[:rows])  # noqa: E731
        before = {k: f.launches for k, f in counted.items()}
        probs.append(serve()[:2])
        if dev == card:
            assert {k: f.launches - before[k] for k, f in counted.items()
                    } == {k: counts.get(k, 0) for k in counted}
    assert np.isfinite(probs[0]).all()
    assert np.abs(probs[0] - probs[1]).max() <= 5e-3


@pytest.mark.parametrize("name", ["pointnet", "pointnet_partseg", "pointcnn",
                                  "pointcnn_partseg"])
def test_pointnet_pointcnn_train_step_card_matches_cpu(card, name):
    """One train-mode forward and backward of PointNet and PointCNN
    classification and part segmentation on 8 synthetic clouds, on the
    card and on the CPU from the same weights with dropout 0, under
    ``tools/grad_check.py``'s bounds."""
    from pointcloudlib_tpu_torch.tools.grad_check import (
        SEG,
        build_model,
        grad_agreement,
        synthetic_batch,
    )

    variables = random_jax_variables(build_model(name), seed=5)
    got = grad_agreement(name, variables, synthetic_batch(
        name, 8, 11, 2048 if name in SEG else 1024), card)
    agree = got["agree"]
    print(f"{name} card against CPU: least cosine",
          min(agree.items(), key=lambda kv: kv[1][0]),
          "largest norm deviation",
          max(agree.items(), key=lambda kv: abs(kv[1][1] - 1)))
    assert not got["failures"], got["failures"]


def test_train_cls_cli_epoch_and_served_checkpoint(card, tmp_path):
    """One epoch of ``train_cls --model pointnet2`` on synthetic clouds at
    B=32, N=1024 (2 steps, then the 64 test clouds in 2 batches): per
    step exactly 2 launches of FPS, the ball-query pass 1, p1 and p2 and 6
    of the tail, per eval batch 2 of FPS and the ball-query eval; then
    ``Predictor.from_checkpoint`` serves the epoch's checkpoint on the
    card with the eval's launches and the epoch's test OA."""
    from pointcloudlib_tpu_torch.cli import train_cls
    from pointcloudlib_tpu_torch.data import SyntheticModelNet
    from pointcloudlib_tpu_torch.ops.kernels import fused_sa_train as kft

    counted = {"fps": kfps.fps, "ball_query": kbq.ball_query,
               "fused_sa_bq_eval": kfs.fused_sa_bq_eval,
               "fused_sa_eval": kfs.fused_sa_eval, "bq_f1": kft.bq_f1,
               "sa_f1": kft.sa_f1, "sa_tail": kft.sa_tail,
               "sa_bwd_p1": kft.sa_bwd_p1, "sa_bwd_p2": kft.sa_bwd_p2}
    step = {"fps": 2, "bq_f1": 2, "sa_tail": 6, "sa_bwd_p1": 2,
            "sa_bwd_p2": 2}
    serve = {"fps": 2, "fused_sa_bq_eval": 2}

    def launches(fn):
        before = {k: f.launches for k, f in counted.items()}
        out = fn()
        torch.cuda.synchronize()
        return out, {k: f.launches - before[k] for k, f in counted.items()}

    run, got = launches(lambda: train_cls.main([
        "--model", "pointnet2", "--synthetic", "--synthetic-size", "64",
        "--batch_size", "32", "--num_points", "1024", "--epochs", "1",
        "--steps-per-epoch", "2", "--checkpoint-dir", str(tmp_path)]))
    assert got == {k: 2 * step.get(k, 0) + 2 * serve.get(k, 0)
                   for k in counted}
    assert run["steps"] == 2 and np.isfinite(run["last_loss"])
    clouds, normals, labels = SyntheticModelNet(n_points=1024, size=64,
                                                seed=0).batch(0, 64)
    pred = Predictor.from_checkpoint(tmp_path / "pointnet2", "pointnet2",
                                     which="current")
    probs, got = launches(lambda: pred.predict_proba(clouds, normals))
    assert got == {k: 2 * serve.get(k, 0) for k in counted}
    oa = 100.0 * int((probs.argmax(-1) == labels).sum()) / 64
    assert oa == run["test_oa"][0]


# ------------------------------------------------------------------ KPConv

# per served batch and per train step at bench.py's calibration of its 16
# surface clouds (caps 896, 640, 256, 80, 24): the kNN over the supports of
# layers 0-2 (self-neighbours and pools), the row gather of layers 0-2,
# its backward the scatter-add
KP_SERVE = {"knn": 6, "gather_neighbors": 11}
# served KPConv's logits against the CPU's, of the CPU's largest logit
KP_LOGIT_RTOL = 1e-4
KP_STEP = {**KP_SERVE, "scatter_rows": 11}


def _kp_bench(name, dev):
    """``(model at bench.py's calibration with seeded weights, on dev,
    eval mode; the 16 clouds it is calibrated on)``."""
    from pointcloudlib_tpu_torch.data import SyntheticModelNet
    from pointcloudlib_tpu_torch.models.kpconv.calibrate import (
        bench_calibration,
    )

    xyz = SyntheticModelNet(n_points=1024, size=16, train=True,
                            seed=0).batch(0, 16)[0]
    arch = get_cls_model(name).cfg.architecture
    cal = bench_calibration(xyz, arch, device=dev)
    model = get_cls_model(name, caps=cal.caps,
                          neighborhood_limits=cal.neighborhood_limits)
    from_jax_variables(model, random_jax_variables(model, seed=0))
    return model.to(dev).eval(), xyz


def _kp_counted():
    from pointcloudlib_tpu_torch.ops.kernels import gather as kga
    from pointcloudlib_tpu_torch.ops.kernels import knn as kknn

    return {"knn": kknn.knn, "gather_neighbors": kga.gather_neighbors,
            "scatter_rows": kga.scatter_rows}


def _kp_launches(fn):
    counted = _kp_counted()
    before = {k: f.launches for k, f in counted.items()}
    out = fn()
    torch.cuda.synchronize()
    return out, {k: f.launches - before[k] for k, f in counted.items()}


@pytest.mark.parametrize("case", ["self0", "pool0", "self1", "pool1",
                                  "self2", "pool2", "few_valid",
                                  "none_valid", "k_eq_n"])
def test_kpconv_knn_bit_identical_with_far_rows(card, case):
    """The kNN kernel at KPConv's six launches (bench.py's calibration;
    masked supports at 1e9, invalid queries at the origin) and at edge
    cases: a cloud of fewer valid supports than k, a cloud of none, and
    k = N: d² and idx bit-identical to ``knn_plain``."""
    from pointcloudlib_tpu_torch.models.kpconv import pyramid as kpyr
    from pointcloudlib_tpu_torch.ops.kernels import knn as kknn

    model, xyz = _kp_bench("kpconv", card)
    with torch.no_grad():
        p = model.kpcnn.pyramid(torch.from_numpy(xyz).to(card))
    ks = model.cfg.neighborhood_limits
    if case[:-1] in ("self", "pool"):
        layer = int(case[-1])
        q = p.points[layer + (case[:-1] == "pool")]
        s, sm, k = p.points[layer], p.masks[layer], ks[layer]
        assert s.shape[1] >= kpyr.KNN_MIN_SUPPORTS and (~sm).any()
    else:
        s, sm = p.points[0].clone(), p.masks[0].clone()
        q, k = s[:, ::3], 15
        if case == "few_valid":
            sm[1, 10:] = False
        elif case == "none_valid":
            sm[1] = False
        else:
            s, sm, q, k = s[:, :40], sm[:, :40], s[:, :40], 40
    far = kpyr._far_supports(s, sm)
    got, launches = _kp_launches(lambda: kknn.knn(q, far, k))
    want = kknn.knn_plain(q, far, k)
    assert launches["knn"] == 1
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_kpconv_gather_and_scatter_match_plain(card, monkeypatch):
    """The row gather at its 11 launches of a served KPConv batch and the
    scatter-add at the 11 of a train step's backward (arguments recorded
    from the model at bench.py's calibration): the gather bit-identical,
    the scatter-add within 1e-5 of the largest element."""
    from pointcloudlib_tpu_torch.ops.kernels import gather as kga

    model, xyz = _kp_bench("kpconv", card)
    calls = {"gather_neighbors": [], "scatter_rows": []}
    for name in calls:
        orig = getattr(kga, name)

        def rec(*args, _orig=orig, _name=name):
            calls[_name].append(tuple(a.detach().clone() if torch.is_tensor(a)
                                      else a for a in args))
            return _orig(*args)

        rec.launches = 0  # the original counts under its module name
        monkeypatch.setattr(kga, name, rec)
    x = torch.from_numpy(xyz).to(card)
    with torch.no_grad():
        model(x)
    assert len(calls["gather_neighbors"]) == 11
    assert not calls["scatter_rows"]
    model.train()
    model(x).sum().backward()
    monkeypatch.undo()
    assert len(calls["scatter_rows"]) == 11
    for points, idx in calls["gather_neighbors"]:
        assert torch.equal(kga.gather_neighbors(points, idx),
                           kga.gather_neighbors_plain(points, idx))
    for g, idx, n in calls["scatter_rows"]:
        got = kga.scatter_rows(g, idx, n)
        want = kga.scatter_rows_plain(g, idx, n)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("name", ["kpconv", "kpconv_deform"])
def test_kpconv_serving_and_step_card_matches_cpu(card, name):
    """KPConv at full width and bench.py's calibration: a served batch of
    16 clouds launches exactly :data:`KP_SERVE`, a train step (SGD, lr
    0.1) exactly :data:`KP_STEP`; the card's probabilities within 5e-3
    of the CPU's on 2 clouds; one forward and backward on 8 clouds under
    ``tools/grad_check.py``'s bounds."""
    from pointcloudlib_tpu_torch.tools.grad_check import (
        grad_agreement,
        synthetic_batch,
    )
    from pointcloudlib_tpu_torch.train import (
        make_cls_train_step,
        sgd_momentum,
    )

    model, xyz = _kp_bench(name, card)
    pred = Predictor(model, batch_size=16, device=card)
    probs, launches = _kp_launches(lambda: pred.predict_proba(xyz))
    assert launches == {**{k: 0 for k in KP_STEP}, **KP_SERVE}
    cpu_model, _ = _kp_bench(name, "cpu")
    ref = Predictor(cpu_model, batch_size=2, device="cpu").predict_proba(
        xyz[:2])
    assert np.isfinite(probs).all()
    assert np.abs(probs[:2] - ref).max() <= 5e-3
    step = make_cls_train_step(model, sgd_momentum(model.parameters(), 0.1),
                               device=card)
    batch = {"xyz": xyz, "label": np.arange(16) % 40}
    out, launches = _kp_launches(lambda: step(batch))
    assert launches == KP_STEP
    assert np.isfinite(out["loss"].item())
    variables = random_jax_variables(get_cls_model(name), seed=5)
    got = grad_agreement(name, variables, synthetic_batch(name, 8, 11, 1024),
                         card)
    assert not got["failures"], got["failures"]


@pytest.mark.parametrize("n_points", [4096, 5000])
def test_kpconv_served_large_clouds_card_matches_cpu(card, n_points):
    """``Predictor`` of KPConv at its uncalibrated shapes (as
    ``from_checkpoint`` builds it) on clouds of 4,096 and 5,000 points:
    layer 2 holds 256 / 312 supports, so its radius search and pools
    launch the kNN's rank route (k = 41) twice a batch beside four
    launches of the other routes; the probabilities within 5e-3 of the
    CPU's, and the logits under them (the random weights saturate the
    softmax) within :data:`KP_LOGIT_RTOL` of the CPU's largest."""
    from pointcloudlib_tpu_torch.data import SyntheticModelNet
    from pointcloudlib_tpu_torch.ops.kernels import knn as kknn

    xyz = SyntheticModelNet(n_points=n_points, size=2, train=False,
                            seed=3).batch(0, 2)[0]
    variables = random_jax_variables(get_cls_model("kpconv"), seed=0)
    logits = {}
    preds = {}
    for dev in (card, "cpu"):
        pred = Predictor.from_variables("kpconv", variables, batch_size=2,
                                        device=dev)
        pred.model.register_forward_hook(
            lambda _m, _i, out, dev=str(dev): logits.setdefault(
                dev, out.detach().cpu()))
        preds[str(dev)] = pred
    rank0 = kknn.knn.launches_by_route[kknn.RANK_ROUTE]
    probs, launches = _kp_launches(
        lambda: preds[str(card)].predict_proba(xyz))
    assert launches["knn"] == 6
    assert kknn.knn.launches_by_route[kknn.RANK_ROUTE] - rank0 == 2
    ref = preds["cpu"].predict_proba(xyz)
    assert np.isfinite(probs).all()
    assert np.abs(probs - ref).max() <= 5e-3
    want = logits["cpu"]
    assert torch.isfinite(logits[str(card)]).all()
    assert ((logits[str(card)] - want).abs().max()
            <= KP_LOGIT_RTOL * want.abs().max())


def _world1_runs(card, name, group):
    """Three steps of model ``name`` (B=16, N=1024; normals for PointNet++)
    from the same weights and dropout generator: without a group, again
    without one, and with ``group``: each run's loss, gradients by name
    and state; then the names of the gradients that ``grad_check`` does
    not compare on this batch (cancelled, fragile)."""
    from pointcloudlib_tpu_torch.tools.grad_check import (
        build_model,
        model_grads,
        synthetic_batch,
    )
    from pointcloudlib_tpu_torch.train import (
        make_cls_train_step,
        sgd_momentum,
    )

    batch = synthetic_batch(name, 16, 2, 1024)
    variables = random_jax_variables(get_cls_model(name), seed=0)
    runs = []
    for g in (None, None, group):
        model = get_cls_model(name)
        from_jax_variables(model, variables)
        step = make_cls_train_step(
            model, sgd_momentum(model.parameters(), 0.05),
            device=card if g is None else None, group=g)
        met = step(batch, torch.Generator(device=card).manual_seed(0))
        torch.cuda.synchronize()
        runs.append({"loss": met["loss"].cpu(),
                     "grads": {k: p.grad.cpu() for k, p in
                               model.named_parameters()
                               if p.grad is not None},
                     "state": {k: v.cpu()
                               for k, v in model.state_dict().items()}})
    model = from_jax_variables(build_model(name, dropout=0.0), variables)
    _, _, cancelled, fragile = model_grads(model.to(card), name, batch)
    return runs, cancelled, fragile


def _same(a, b):
    return torch.equal(a["loss"], b["loss"]) and all(
        a[part].keys() == b[part].keys()
        and all(torch.equal(a[part][k], b[part][k]) for k in a[part])
        for part in ("grads", "state"))


def test_world_1_nccl_step_bit_identical(card, tmp_path):
    """The data-parallel step over a one-process NCCL group against the
    step without a group, from the same weights and dropout generator.
    At a world of 1 the group's step shards nothing, sums nothing over
    ranks and keeps sync-BN local, so the two run the same arithmetic:
    PointNet's (no kernel, bit-reproducible run to run) loss, every
    gradient and every state tensor are bit-identical. PointNet++ SSG's
    kernels sum Σ/Σ² by atomics in no fixed order: where two runs without
    a group are bit-identical the group's run must be too, else its loss
    and every gradient are held to the step without a group under
    ``tools/grad_check.py``'s bounds (loss within 1e-2 relative, each
    gradient's cosine ≥ 0.85 and norm within 15 %), as a second run
    without a group is."""
    import torch.distributed as dist

    from pointcloudlib_tpu_torch.parallel import init_group
    from pointcloudlib_tpu_torch.tools.grad_check import compare_grads

    group = init_group(0, 1, f"file://{tmp_path}/store", device=card)
    try:
        runs = {name: _world1_runs(card, name, group)
                for name in ("pointnet", "pointnet2")}
    finally:
        dist.destroy_process_group()
    (plain, again, world1), _, _ = runs["pointnet"]
    assert _same(plain, again)
    assert _same(plain, world1)
    (plain, again, world1), cancelled, fragile = runs["pointnet2"]
    if _same(plain, again):
        assert _same(plain, world1)
    want = (float(plain["loss"]),
            {k: g.double() for k, g in plain["grads"].items()},
            cancelled, fragile)
    for run in (again, world1):
        check = compare_grads("pointnet2", (float(run["loss"]), {
            k: g.double() for k, g in run["grads"].items()}), want)
        assert not check["failures"], check["failures"]


def test_kpconv_pyramid_bit_identical_twice_and_to_cpu(card):
    """Two pyramid builds of the deformable model on the card (sorts,
    the voxel sums, the kNN) are bit-identical, and equal to the CPU's."""
    model, xyz = _kp_bench("kpconv_deform", card)
    x = torch.from_numpy(xyz)
    with torch.no_grad():
        builds = [model.kpcnn.pyramid(x.to(card)) for _ in range(2)]
        cpu = model.to("cpu").kpcnn.pyramid(x)

    def tensors(p):
        return [t for f in p for t in (f if isinstance(f, list) else [f])]

    for a, b, c in zip(*map(tensors, (*builds, cpu))):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)
