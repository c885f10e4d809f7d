"""The port's train-mode fused set abstraction, BatchNorm, losses,
schedules and optimizer against the JAX package, on the CPU.

Inputs are numpy arrays from a seed, handed to both frameworks. The JAX
kernels run in Pallas interpret mode; the port runs the plain PyTorch
versions its wrappers take for CPU tensors.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import pointcloudlib_tpu.ops.pallas.fused_sa as jfs
from pointcloudlib_tpu.nn.layers import DenseBNAct as JaxDenseBNAct
from pointcloudlib_tpu.train import losses as jlosses
from pointcloudlib_tpu.train import schedules as jsched

from pointcloudlib_tpu_torch.models import get_cls_model
from pointcloudlib_tpu_torch.nn.layers import DenseBNAct
from pointcloudlib_tpu_torch.ops.kernels import fused_sa_train as ft
from pointcloudlib_tpu_torch.ops.kernels.fused_sa import (
    SAParams,
    _stack_stats,
)
from pointcloudlib_tpu_torch.train import (
    accuracy,
    cosine_with_warmup,
    cross_entropy_seg,
    reference_flat_lr,
    sgd_momentum,
    soft_cross_entropy,
    step_decay,
)
from pointcloudlib_tpu_torch.utils.interop import (
    from_jax_variables,
    random_jax_variables,
    to_jax_variables,
)

# 2·C1 = 128 takes _k_p2's split-count layout, 2·C1 = 32 the ones column
WIDTHS = [(16, 16, 32), (64, 64, 128)]


def _np(t):
    return t.detach().float().numpy()


def _jbf(t):
    """A port bf16 tensor as a JAX bf16 array (exact)."""
    return jnp.asarray(_np(t)).astype(jnp.bfloat16)


def _tie_robust(got, want, what):
    """The bound of ``tests/test_fused_sa.py:435-444`` on values scaled
    by ``max|want|``: a last-bit change of h3 can flip a max-pool tie and
    move one gradient share to another slot, so fewer than 0.5 % of the
    elements may lie beyond 1e-2 + 1e-2·|want| and the mean deviation
    must stay below 3e-3."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-12)
    d = np.abs(got - want) / scale
    tol = 1e-2 + 1e-2 * np.abs(want) / scale
    assert (d > tol).mean() < 5e-3, (what, (d > tol).mean())
    assert d.mean() < 3e-3, (what, d.mean())


def _layer(seed, widths, b=2, n=128, m=32, k=16, radius=0.4):
    """A layer's kernel inputs: clouds on the unit sphere, one empty
    ball-query row, q and off from a random W1, SA parameters, the bf16
    h1 of forward pass 1 and the folded BN rows of its statistics."""
    rng = np.random.default_rng(seed)
    c1, c2, c3 = widths
    pts = rng.standard_normal((b, n, 3)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    nx = pts[:, :m].copy()
    nx[0, 0] = 50.0  # no neighbour: cnt == 0, every slot at point 0
    w1 = (rng.standard_normal((3, c1)) * 0.5).astype(np.float32)
    q = (pts @ w1 + rng.normal(0, 0.1, (b, n, c1))).astype(np.float32)
    off = (nx @ w1).astype(np.float32)

    def t(*s, scale=1.0, base=0.0):
        return torch.tensor(base + rng.standard_normal(s) * scale,
                            dtype=torch.float32)

    p = SAParams(t(c1, c2, scale=1 / np.sqrt(c1)),
                 t(c2, c3, scale=1 / np.sqrt(c2)), t(c1, scale=0.1, base=1),
                 t(c1, scale=0.1), t(c2, scale=0.1, base=1), t(c2, scale=0.1),
                 t(c3, scale=0.1, base=1), t(c3, scale=0.1))
    nx_t, pts_t = torch.from_numpy(nx), torch.from_numpy(pts)
    q_t, off_t = torch.from_numpy(q), torch.from_numpy(off)
    idx, h1, cnt, psum = ft.bq_f1_plain(nx_t, pts_t, q_t, off_t, radius, k)
    r = float(b * m * k)
    st1 = _stack_stats(*ft._moments(psum, r), p.g1, p.b1)
    st2 = _stack_stats(*ft._moments(
        ft.sa_tail_plain(2, h1, st1, None, None, p.w2, p.w3), r), p.g2, p.b2)
    st3 = _stack_stats(*ft._moments(
        ft.sa_tail_plain(3, h1, st1, st2, None, p.w2, p.w3), r), p.g3, p.b3)
    dout = t(b, m, c3)
    return dict(nx=nx_t, pts=pts_t, q=q_t, off=off_t, p=p, idx=idx, h1=h1,
                cnt=cnt, psum=psum, st=(st1, st2, st3), dout=dout,
                radius=radius, k=k, n=n, r=r)


# the last case's radius holds only the center itself: every slot past 0
# is a replica of slot 0, which the card's kernel stores as a copy
@pytest.mark.parametrize("widths,radius", [(w, 0.4) for w in WIDTHS]
                         + [(WIDTHS[0], 1e-4)],
                         ids=["widths0", "widths1", "replicas"])
def test_bq_f1_matches_jax(widths, radius):
    L = _layer(0, widths, radius=radius)
    idx, h, cnt, psum = jfs._call_bqf1(
        jnp.asarray(_np(L["nx"])), jnp.asarray(_np(L["pts"])),
        jnp.asarray(_np(L["q"])), jnp.asarray(_np(L["off"])), L["radius"],
        L["k"], True)
    assert int(L["cnt"][0, 0]) == 0  # the empty row is there
    if radius < 1e-3:
        assert int((L["cnt"] == 1).sum()) == L["cnt"].numel() - 1
    np.testing.assert_array_equal(L["idx"].numpy(), np.asarray(idx))
    np.testing.assert_array_equal(L["cnt"].numpy(), np.asarray(cnt))
    # one f32 subtraction and one rounding on both sides: bit-identical
    # once JAX's slot-major [b, k, m, c1] is transposed to [b, m, k, c1]
    np.testing.assert_array_equal(
        _np(L["h1"]), np.asarray(jnp.swapaxes(h, 1, 2), np.float32))
    # sums of ~1000 rows in another order
    np.testing.assert_allclose(_np(L["psum"]), np.asarray(psum[0]),
                               rtol=1e-5, atol=1e-5 * np.abs(psum).max())


def _jst(st):
    return jnp.asarray(_np(st))[None]


@pytest.mark.parametrize("stage", [2, 3, 4])
@pytest.mark.parametrize("widths", WIDTHS)
def test_tail_matches_jax(widths, stage):
    L = _layer(1, widths)
    p, (st1, st2, st3) = L["p"], L["st"]
    got = ft.sa_tail_plain(stage, L["h1"], st1, st2, st3, p.w2, p.w3)
    h1 = _jbf(L["h1"])
    w2, w3 = jnp.asarray(_np(p.w2)), jnp.asarray(_np(p.w3))
    if stage == 2:
        want = jfs._call_stats2(h1, _jst(st1), w2, True)[0]
    elif stage == 3:
        want = jfs._call_stats3(h1, _jst(st1), _jst(st2), w2, w3, True)[0]
    else:
        want = jfs._call_out(h1, _jst(st1), _jst(st2), _jst(st3), w2, w3,
                             True)
    want = np.asarray(want)
    # the same bf16 roundings; f32 products summed in another order
    np.testing.assert_allclose(_np(got), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("widths", WIDTHS)
def test_bwd_p1_matches_jax(widths):
    L = _layer(2, widths)
    p, (st1, st2, st3) = L["p"], L["st"]
    ps3, vecs, mats = ft.sa_bwd_p1_plain(L["h1"], L["dout"], st1, st2, st3,
                                         p.w2, p.w3)
    jps3, jvecs, jmats = jfs._call_p1(
        _jbf(L["h1"]), jnp.asarray(_np(L["dout"])), _jst(st1), _jst(st2),
        _jst(st3), jnp.asarray(_np(p.w2)), jnp.asarray(_np(p.w3)), True)
    _tie_robust(_np(ps3), jps3[0], "ps3")
    _tie_robust(_np(vecs), jvecs[0, 0], "vecs")
    _tie_robust(_np(mats), jmats[0], "mats")


@pytest.mark.parametrize("widths", WIDTHS)
def test_bwd_p2_matches_jax(widths):
    L = _layer(3, widths)
    p, (st1, st2, st3) = L["p"], L["st"]
    c1 = widths[0]
    ps3, vecs, mats = ft.sa_bwd_p1_plain(L["h1"], L["dout"], st1, st2, st3,
                                         p.w2, p.w3)
    _, s2 = ft._combine_p1(ps3, vecs, mats, st3, p.w3, L["r"])
    us3, us2 = ps3 / L["r"], s2 / L["r"]
    got = ft.sa_bwd_p2_plain(L["h1"], L["dout"], L["idx"], st1, st2, st3,
                             p.w2, p.w3, us3, us2, L["n"])
    want = jfs._call_p2(
        _jbf(L["h1"]), jnp.asarray(_np(L["dout"])), jnp.asarray(L["idx"]),
        _jst(st1), _jst(st2), _jst(st3), jnp.asarray(_np(p.w2)),
        jnp.asarray(_np(p.w3)), jnp.asarray(_np(us3))[None],
        jnp.asarray(_np(us2))[None], L["n"], True)
    dw2, ps1, scat, d1, d2 = got
    jdw2, jps1, jscat, jd1, jd2 = want
    _tie_robust(_np(dw2), jdw2, "dw2")
    _tie_robust(_np(ps1), jps1[0], "ps1")
    # JAX pads the count column to 8 lanes; the first 2·C1+1 columns
    # carry the same meaning, the count column exact
    assert scat.shape == (2, L["n"], 2 * c1 + 1)
    np.testing.assert_array_equal(_np(scat[..., 2 * c1]),
                                  np.asarray(jscat[..., 2 * c1]))
    _tie_robust(_np(scat), np.asarray(jscat)[..., :2 * c1 + 1], "scat")
    _tie_robust(_np(d1), jd1, "d1")
    _tie_robust(_np(d2), jd2, "d2")


def _bq_case():
    """The shapes and data of ``tests/test_fused_sa.py:378``
    (``test_bq_fused_matches_separate``) with an empty row."""
    from pointcloudlib_tpu.ops.geometry import (
        farthest_point_sample,
        index_points,
    )

    rng = np.random.default_rng(9)
    b, n, m, k = 2, 256, 64, 16
    c1, c2, c3 = 16, 16, 32
    xyz = rng.standard_normal((b, n, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    nx = np.asarray(index_points(jnp.asarray(xyz), farthest_point_sample(
        jnp.asarray(xyz), m)))
    nx = nx.copy()
    nx[0, 0] = 50.0
    w1 = (rng.standard_normal((3, c1)) * 0.3).astype(np.float32)
    q = np.asarray(jnp.dot(jnp.asarray(xyz).astype(jnp.bfloat16),
                           jnp.asarray(w1).astype(jnp.bfloat16),
                           preferred_element_type=jnp.float32))
    off = np.asarray(jnp.dot(jnp.asarray(nx).astype(jnp.bfloat16),
                             jnp.asarray(w1).astype(jnp.bfloat16),
                             preferred_element_type=jnp.float32))
    w2 = (rng.standard_normal((c1, c2)) * 0.3).astype(np.float32)
    w3 = (rng.standard_normal((c2, c3)) * 0.3).astype(np.float32)
    g = [(1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
         for c in (c1, c2, c3)]
    bb = [(0.1 * rng.standard_normal(c)).astype(np.float32)
          for c in (c1, c2, c3)]
    params = (w2, w3, g[0], bb[0], g[1], bb[1], g[2], bb[2])
    co = rng.standard_normal((b, m, c3)).astype(np.float32)
    return nx, xyz, q, off, params, 0.4, k, co


def test_function_matches_jax_fused_sa_bq_train():
    nx, xyz, q, off, params, radius, k, co = _bq_case()

    def jloss(q, off, params):
        out, stats = jfs.fused_sa_bq_train(
            jnp.asarray(nx), jnp.asarray(xyz), q, off, jfs.SAParams(*params),
            radius, k, True, None, 1)
        return jnp.sum(out * co), (out, stats)

    (_, (jout, jstats)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(off), tuple(map(jnp.asarray, params)))

    qt = torch.tensor(q, requires_grad=True)
    offt = torch.tensor(off, requires_grad=True)
    pt = SAParams(*[torch.tensor(a, requires_grad=True) for a in params])
    out, stats = ft.fused_sa_bq_train(torch.from_numpy(nx),
                                      torch.from_numpy(xyz), qt, offt, pt,
                                      radius, k)
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


def test_plain_backward_matches_autograd_of_reference():
    """The composed plain passes (f1, tails, p1, _combine_p1, p2, the dq
    and doff assembly) against torch autograd of
    ``fused_sa_reference_plain``: the hand-written backward's bf16
    contraction operands are the only difference, so each gradient is
    within 3 % of its largest element (``test_fused_sa.py:124``)."""
    nx, xyz, q, off, params, radius, k, co = _bq_case()
    args = [torch.tensor(a, requires_grad=True) for a in (q, off, *params)]
    nx_t, xyz_t, co_t = map(torch.from_numpy, (nx, xyz, co))
    out, stats = ft.fused_sa_bq_train(nx_t, xyz_t, args[0], args[1],
                                      SAParams(*args[2:]), radius, k)
    ref, rstats = ft.fused_sa_reference_plain(nx_t, xyz_t, args[0], args[1],
                                              SAParams(*args[2:]), radius, k)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-5, atol=1e-5)
    for a, b_ in zip(stats, rstats):
        np.testing.assert_allclose(_np(a), _np(b_), rtol=1e-5, atol=1e-6)
    got = torch.autograd.grad((out * co_t).sum(), args)
    want = torch.autograd.grad((ref * co_t).sum(), args)
    for a, b_ in zip(got, want):
        scale = max(b_.abs().max().item(), 1e-4)
        np.testing.assert_allclose(_np(a), _np(b_), rtol=0.03,
                                   atol=0.03 * scale)


def test_wrappers_reject_other_devices():
    t = torch.zeros((1, 8, 8, 16), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        ft.sa_tail(2, t, None, None, None, None, None)


@pytest.mark.parametrize("rows", [64, 7])
def test_dense_bn_act_running_stats_match_flax(rows):
    """A train-mode forward leaves flax's running statistics: momentum
    0.9 on the biased batch variance (torch's BatchNorm1d would update
    with the unbiased one, off by rows/(rows−1))."""
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((rows, 24)).astype(np.float32) * 2 + 0.5
    jm = JaxDenseBNAct(16)
    v = jm.init(jax.random.key(0), jnp.asarray(x), True)
    bs = {"BatchNorm_0": {
        "mean": jnp.asarray(rng.normal(0, 0.1, 16), jnp.float32),
        "var": jnp.asarray(rng.uniform(0.5, 1.5, 16), jnp.float32)}}
    y, mut = jm.apply({"params": v["params"], "batch_stats": bs},
                      jnp.asarray(x), True, mutable=["batch_stats"])
    m = DenseBNAct(24, 16).train()
    with torch.no_grad():
        m.dense.weight.copy_(torch.tensor(
            np.asarray(v["params"]["Dense_0"]["kernel"]).T))
        m.bn.running_mean.copy_(torch.tensor(np.asarray(
            bs["BatchNorm_0"]["mean"])))
        m.bn.running_var.copy_(torch.tensor(np.asarray(
            bs["BatchNorm_0"]["var"])))
    got = m(torch.from_numpy(x))
    want = mut["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(_np(m.bn.running_mean), want["mean"],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(m.bn.running_var), want["var"],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(got), np.asarray(y), atol=1e-4)


def test_bridge_round_trip():
    model = get_cls_model("pointnet2")
    variables = random_jax_variables(model, seed=4)
    back = to_jax_variables(from_jax_variables(model, variables))
    flat_a = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(flat_b[path], a)


@pytest.mark.parametrize("smoothing", [True, False])
def test_soft_cross_entropy_matches_jax(smoothing):
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((16, 40)).astype(np.float32) * 3
    labels = rng.integers(0, 40, 16).astype(np.int32)
    want = jlosses.soft_cross_entropy(jnp.asarray(logits),
                                      jnp.asarray(labels), smoothing)
    got = soft_cross_entropy(torch.from_numpy(logits),
                             torch.from_numpy(labels), smoothing)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_seg_loss_and_accuracy_match_jax():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((2, 50, 7)).astype(np.float32)
    seg = rng.integers(0, 7, (2, 50)).astype(np.int32)
    np.testing.assert_allclose(
        cross_entropy_seg(torch.from_numpy(logits),
                          torch.from_numpy(seg)).item(),
        float(jlosses.cross_entropy_seg(jnp.asarray(logits),
                                        jnp.asarray(seg))), rtol=1e-6)
    np.testing.assert_allclose(
        _np(cross_entropy_seg(torch.from_numpy(logits),
                              torch.from_numpy(seg), reduce=False)),
        np.asarray(jlosses.cross_entropy_seg(jnp.asarray(logits),
                                             jnp.asarray(seg), False)),
        rtol=1e-6, atol=1e-6)
    cls_logits, cls_labels = logits[:, 0], seg[:, 0]
    assert accuracy(torch.from_numpy(cls_logits),
                    torch.from_numpy(cls_labels)).item() == float(
        jlosses.accuracy(jnp.asarray(cls_logits), jnp.asarray(cls_labels)))


def test_schedules_match_jax():
    steps = [0, 1, 233, 234, 235, 2000, 10 ** 6]
    for jfn, fn in (
            (jsched.step_decay(0.02, decay_step=234),
             step_decay(0.02, decay_step=234)),
            (jsched.cosine_with_warmup(0.1, 50, 1000),
             cosine_with_warmup(0.1, 50, 1000))):
        for s in steps + [25, 50, 51, 999, 1000]:
            # optax evaluates in float32, the port in float64
            np.testing.assert_allclose(fn(s), float(jfn(s)), rtol=1e-5,
                                       atol=1e-9)
    for n, bsz, drop in ((9840, 64, False), (14007, 32, True),
                         (14990, 32, False), (30000, 16, False)):
        assert reference_flat_lr(0.02, n, bsz, drop) == pytest.approx(
            jsched.reference_flat_lr(0.02, n, bsz, drop), rel=1e-12)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-4])
def test_sgd_momentum_matches_optax(weight_decay):
    from pointcloudlib_tpu.train.state import sgd_momentum as jsgd

    rng = np.random.default_rng(7)
    p0 = rng.standard_normal((5, 3)).astype(np.float32)
    grads = [rng.standard_normal((5, 3)).astype(np.float32)
             for _ in range(3)]
    tx = jsgd(0.05, momentum=0.9, weight_decay=weight_decay)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = sgd_momentum([w], 0.05, momentum=0.9, weight_decay=weight_decay)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        w.grad = torch.from_numpy(g.copy())
        opt.step()
        np.testing.assert_allclose(_np(w), np.asarray(jp), rtol=1e-6,
                                   atol=1e-7)

