"""DGCNN's route at N % 128 ≠ 0 in the port against the JAX package, on
the CPU: the standalone kNN, the EdgeConv kernels that take its index
(``edge_f1``, ``edge_eval``; the ported ``edge_out`` and ``edge_bwd``
follow), the model on that route, and buckets above 4096.

Inputs are numpy arrays from a seed, handed to both frameworks. The JAX
kernels run in Pallas interpret mode; the port runs the plain PyTorch
versions its wrappers take for CPU tensors. The JAX ``knn_pallas`` forms
its cross term with an f32 matrix product, the port channel by channel,
so a near-equal k-th neighbour can flip between the two: those lists are
compared row by row, as ``tests/test_fused_edge.py`` does.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudlib_tpu.models.dgcnn import DGCNN as JaxDGCNN
from pointcloudlib_tpu.ops.geometry import knn as jax_knn
from pointcloudlib_tpu.ops.pallas.fused_edge import EdgeStats as JaxStats
from pointcloudlib_tpu.ops.pallas.fused_edge import (
    _call_ef1,
    fused_edge_conv as jax_conv,
    fused_edge_eval as jax_edge_eval,
)
from pointcloudlib_tpu.ops.pallas.fused_sa import _stack_stats as jax_stack
from pointcloudlib_tpu.ops.pallas.neighbors import knn_pallas
from pointcloudlib_tpu.train.state import TrainState
from pointcloudlib_tpu.train.state import sgd_momentum as jax_sgd
from pointcloudlib_tpu.train.trainer import (
    make_cls_train_step as jax_train_step,
)

from pointcloudlib_tpu_torch import ops
from pointcloudlib_tpu_torch.inference import Predictor
from pointcloudlib_tpu_torch.models import get_cls_model
from pointcloudlib_tpu_torch.ops.kernels import fused_edge as kfe
from pointcloudlib_tpu_torch.ops.kernels import knn as kknn
from pointcloudlib_tpu_torch.ops.kernels.fused_sa import _stack_stats
from pointcloudlib_tpu_torch.train import make_cls_train_step, sgd_momentum
from pointcloudlib_tpu_torch.utils.interop import (
    from_jax_variables,
    random_jax_variables,
    to_jax_variables,
)

SLOPE = 0.2


def _t(a):
    return torch.from_numpy(np.array(a))


def _mostly_close(a, b, rtol=1e-5, atol=1e-5, frac=1e-2, max_abs=0.05):
    """Within ``rtol``/``atol`` on all but ``frac`` of the elements, the
    rest within ``max_abs`` (``tests/test_torch_port_dgcnn_ops.py``)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    bad = ~np.isclose(a, b, rtol=rtol, atol=atol)
    assert bad.mean() <= frac, (bad.mean(), frac)
    if bad.any():
        assert np.abs(a - b)[bad].max() <= max_abs


def _cloud(rng, b, n, c, duplicates=False):
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    if duplicates:  # the second half repeats the first: ties at d² = 0
        x[:, n - n // 2:] = x[:, : n // 2]
    return x


# --------------------------------------------------------------- kNN


@pytest.mark.parametrize("b,m,n,c,k,dup", [
    (2, 20, 20, 3, 20, False),    # k = N
    (2, 37, 50, 3, 8, True),      # duplicate points, M ≠ N
    (1, 16, 12, 3, 15, False),    # k > N: the last neighbour repeats
    (2, 100, 100, 3, 20, True),
    (2, 64, 150, 3, 40, True),    # k = 40 (the longest list), M ≠ N
])
def test_knn_matches_jax(b, m, n, c, k, dup):
    """The port's ``knn`` (its plain version on the CPU) against the JAX
    ``knn`` off the TPU (``square_distance`` and ``lax.top_k``): idx
    bit-identical at C=3, ties to the lower index, d² within f32
    rounding."""
    rng = np.random.default_rng(n + k)
    p = _cloud(rng, b, n, c, dup)
    q = p[:, :m] if m <= n else _cloud(rng, b, m, c)
    d2, idx = ops.knn(_t(q), _t(p), k)
    jd2, jidx = jax_knn(jnp.asarray(q), jnp.asarray(p), k)
    assert idx.dtype == torch.int32 and idx.shape == (b, m, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=1e-6,
                               atol=1e-6)
    if dup and m <= n - n // 2:   # each query's twin follows at d² = 0
        i = idx.numpy()
        assert (i[..., 0] == np.arange(m)).all()
        assert (i[..., 1] == np.arange(m) + n - n // 2).all()


@pytest.mark.parametrize("c,dup", [(3, True), (64, False), (128, False)])
def test_knn_matches_pallas_row_by_row(c, dup):
    """Against ``knn_pallas`` (``_knn_kernel``) in interpret mode at
    DGCNN's widths, N % 128 ≠ 0: at least 99 % of the neighbour lists
    equal (``pytest -s`` prints the count), d² within f32 rounding of the
    cross term."""
    rng = np.random.default_rng(c)
    x = _cloud(rng, 2, 200, c, dup)
    d2, idx = kknn.knn(_t(x), _t(x), 20)
    jd2, jidx = knn_pallas(jnp.asarray(x), jnp.asarray(x), 20,
                           interpret=True)
    same = (idx.numpy() == np.asarray(jidx)).all(-1)
    print(f"C={c}: {int(same.sum())} of {same.size} neighbour lists equal")
    assert same.mean() >= 0.99
    scale = float(np.abs(np.asarray(jd2)).max())
    _mostly_close(d2.numpy(), jd2, rtol=1e-4, atol=1e-5 * scale,
                  max_abs=1e-3 * scale)


def test_knn_wrapper_takes_the_plain_version_on_the_cpu():
    x = _t(_cloud(np.random.default_rng(0), 1, 30, 3))
    before = kknn.knn.launches
    d2, idx = kknn.knn(x, x, 8)
    assert kknn.knn.launches == before
    want = kknn.knn_plain(x, x, 8)
    assert torch.equal(idx, want[1]) and torch.equal(d2, want[0])


@pytest.mark.parametrize("b,m,n,c,k,want", [
    # k <= 40: the routes of before the rank route, unchanged
    (32, 1000, 1000, 3, 20, "select 128x3"),
    (32, 1000, 1000, 64, 20, "select 128x3"),
    (1, 10000, 10000, 128, 20, "select 256x2 fast"),
    (16, 2048, 2048, 64, 40, "select 128x3 fast"),
    (16, 1000, 1000, 64, 40, "block"),
    (2, 1024, 1024, 3, 32, "block"),
    (16, 1024, 1024, 3, 35, "block"),   # KPConv's layer 1 at 4,096 points
    (16, 256, 256, 3, 40, "block"),
    # above 40: the rank route, whatever the shapes
    (16, 256, 256, 3, 41, "rank"),      # KPConv's layer 2 at 4,096 points
    (16, 64, 256, 3, 41, "rank"),       # and its pools into layer 3
    (16, 312, 312, 3, 42, "rank"),
    (16, 80, 80, 3, 76, "rank"),        # the deformable radius's limit
    (2, 1000, 1000, 3, 300, "rank"),
    (2, 1000, 1000, 64, 300, "rank"),
])
def test_knn_route_choice(b, m, n, c, k, want):
    """``knn_route``: lists of at most ``MAX_K`` keep their routes, and
    longer ones take the rank route, which fits any of these shapes."""
    assert kknn.route_name(kknn.knn_route(b, m, n, c, k)) == want
    if want == "rank":
        assert k > kknn.MAX_K
        assert kknn.rank_warp_bytes(n, k) <= 227 * 1024


def test_knn_rank_route_size_limit():
    """The rank route's warp holds N keys and k + 64 list words: 57,900
    points fit at k = 41, 57,901 do not; the wrapper names the limit."""
    assert kknn.rank_warp_bytes(57900, 41) <= 227 * 1024
    assert kknn.rank_warp_bytes(57901, 41) > 227 * 1024


def test_radius_neighbors_asks_for_41_at_4096_points(monkeypatch):
    """Served KPConv at the uncalibrated shapes of a 4,096-point bucket
    (``Predictor``'s): layer 2 holds 256 supports, so its radius search
    and its pools take ``geometry.knn`` (the kernel on the card) with
    k = 41, above the block and select routes' 40: the case the rank
    route is for."""
    from pointcloudlib_tpu_torch.models.kpconv import pyramid as kpyr
    from pointcloudlib_tpu_torch.ops import geometry

    calls = []
    plain = geometry.knn_plain

    def spy(query, points, k):
        calls.append((points.shape[1], query.shape[1], k))
        return plain(query, points, k)

    monkeypatch.setattr(geometry, "knn", spy)
    model = get_cls_model("kpconv")
    rng = np.random.default_rng(4)
    xyz = rng.standard_normal((1, 4096, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    pyr = model.kpcnn.pyramid(_t(xyz))
    assert pyr.points[2].shape[1] == kpyr.KNN_MIN_SUPPORTS == 256
    assert (256, 256, 41) in calls and (256, 64, 41) in calls
    assert all(n >= kpyr.KNN_MIN_SUPPORTS for n, _, _ in calls)
    assert kknn.knn_route(1, 256, 256, 3, 41) == kknn.RANK_ROUTE


# ---------------------------- the routes of the kernels with the kNN inside


@pytest.mark.parametrize("layers,b,n,cin,c,k,want", [
    # DGCNN's four served EdgeConvs and part segmentation's EC3 and pairs
    (1, 32, 1024, 3, 64, 20, "select 128x3 k<=24 C=64"),
    (1, 32, 1024, 64, 64, 20, "select 128x3 k<=24 C=64"),
    (1, 32, 1024, 64, 128, 20, "select 128x3 k<=24 C=128"),
    (1, 32, 1024, 128, 256, 20, "select 256x2 k<=24 C=256"),
    (1, 16, 2048, 64, 64, 40, "select 128x3 k<=40 C=64"),
    (2, 16, 2048, 3, 64, 40, "select 128x3 k<=40 C=64"),
    (2, 16, 2048, 64, 64, 40, "select 128x3 k<=40 C=64"),
    # small grids, other widths and list lengths: the block route
    (1, 4, 1024, 3, 64, 20, "block"),       # 32 blocks of 128 queries
    (2, 4, 1024, 3, 64, 40, "block"),
    (2, 16, 1000, 64, 64, 40, "block"),     # part seg's kNN-route size
    (1, 32, 1024, 3, 32, 20, "block"),      # no instance at C = 32
    (1, 32, 1024, 3, 64, 8, "block"),       # none for lists of 8
    (1, 32, 4096, 512, 64, 20, "block"),    # the walk's tiles do not fit
])
def test_edge_eval_routes(layers, b, n, cin, c, k, want):
    """The route of ``edge_knn_eval`` (one layer) and ``edge2_knn_eval``
    (two), a function of the shapes alone (``knn.edge_eval_route``, pass
    1's rule and instances): the served paths take the select instance
    of their list length and width, small grids and the shapes no
    instance takes the block route."""
    route = kknn.edge_eval_route(b, n, cin, c, k, layers=layers)
    assert kknn.edge_route_name(route, layers) == want
    if route:
        assert kknn.edge_eval_route_fits(route, n, cin, c, k, layers)


@pytest.mark.parametrize("layers", [1, 2])
def test_edge_eval_instances_fit_a_block(layers):
    """Every select instance's shared memory, as the wrapper reckons it
    (the walk's tiles, then the lists and, with two layers, W2 and two y1
    tiles), fits one block's 227 KB at the input widths of the paths, and
    a list longer than the instance's or another width does not fit it.
    The two-layer kernel reuses the walk's tiles: two blocks an SM at C_in
    = 64."""
    for route, (entries, c) in kknn.EDGE_SELECT.items():
        if layers == 2 and c != 64:
            assert not kknn.edge_eval_route_fits(route, 2048, 64, c, 20, 2)
            continue
        for cin in (3, 64, 128):
            smem = kknn.edge_eval_smem(route, cin, c, 8 * entries, layers)
            assert smem <= 227 * 1024, (route, cin, smem)
            assert kknn.edge_eval_route_fits(route, 2048, cin, c,
                                             8 * entries, layers)
        assert not kknn.edge_eval_route_fits(route, 2048, 64, c,
                                             8 * entries + 1, layers)
        assert not kknn.edge_eval_route_fits(route, 2048, 64, 2 * c,
                                             8 * entries, layers)
    if layers == 2:
        assert kknn.edge_eval_smem(4, 64, 64, 40, 2) == 88320
        assert 2 * kknn.edge_eval_smem(4, 3, 64, 40, 2) <= 227 * 1024


# ------------------------------------------ EdgeConv from a given index


def _edge_inputs(seed, b=2, n=100, k=20, cin=16, c=32):
    """``x``, ``q`` and ``off`` as the model forms them (bf16 operands),
    the JAX kNN's idx, BN parameters and running statistics."""
    rng = np.random.default_rng(seed)
    x = _cloud(rng, b, n, cin)
    wa = rng.standard_normal((cin, c)).astype(np.float32) * 0.3
    wb = rng.standard_normal((cin, c)).astype(np.float32) * 0.3
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    q = np.asarray(jnp.dot(xb, jnp.asarray(wa).astype(jnp.bfloat16),
                           preferred_element_type=jnp.float32))
    off = np.asarray(jnp.dot(xb, jnp.asarray(wa - wb).astype(jnp.bfloat16),
                             preferred_element_type=jnp.float32))
    _, idx = jax_knn(jnp.asarray(x), jnp.asarray(x), k)
    return dict(q=q, off=off, idx=np.asarray(idx),
                gamma=rng.uniform(0.5, 1.5, c).astype(np.float32),
                beta=(rng.standard_normal(c) * 0.1).astype(np.float32),
                mean=(rng.standard_normal(c) * 0.1).astype(np.float32),
                var=rng.uniform(0.5, 2.0, c).astype(np.float32))


def test_edge_f1_plain_matches_pallas():
    """``edge_f1``'s plain version against ``_call_ef1`` (``_ke_f1``) on
    the same idx: h bit-identical (one f32 subtraction, one rounding),
    the BN sums within f32 rounding."""
    a = _edge_inputs(0)
    h, psum = kfe.edge_f1(_t(a["q"]).bfloat16(), _t(a["off"]), _t(a["idx"]))
    jh, jpsum = _call_ef1(jnp.asarray(a["q"]), jnp.asarray(a["idx"]),
                          jnp.asarray(a["off"]), True)
    assert h.dtype == torch.bfloat16 and h.shape == (2, 100, 20, 32)
    np.testing.assert_array_equal(h.float().numpy(),
                                  np.asarray(jh.astype(jnp.float32)))
    np.testing.assert_allclose(psum.numpy(), np.asarray(jpsum)[0],
                               rtol=1e-5,
                               atol=1e-5 * float(np.abs(jpsum).max()))


def test_edge_eval_plain_matches_pallas():
    """``fused_edge_eval`` (plain ``edge_eval``) against the JAX
    ``fused_edge_eval`` (``_ke_eval``) on the same idx."""
    a = _edge_inputs(1)
    got = kfe.fused_edge_eval(
        _t(a["q"]), _t(a["off"]), _t(a["idx"]), _t(a["gamma"]),
        _t(a["beta"]), kfe.EdgeStats(_t(a["mean"]), _t(a["var"])), SLOPE)
    want = jax_edge_eval(
        jnp.asarray(a["q"]), jnp.asarray(a["off"]), jnp.asarray(a["idx"]),
        jnp.asarray(a["gamma"]), jnp.asarray(a["beta"]),
        JaxStats(jnp.asarray(a["mean"]), jnp.asarray(a["var"])), SLOPE,
        True)
    assert got.shape == (2, 100, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)



@pytest.mark.parametrize("c,want", [(64, "center"), (128, "center"),
                                    (256, "center"), (4, "rows"),
                                    (32, "rows"), (512, "rows")])
def test_edge_eval_route(c, want):
    """``edge_eval``'s route, a function of the width alone: the center
    route at DGCNN's widths, where it is compiled, the rows route at
    every other; the rows route fits every width."""
    assert kfe.EDGE_EVAL_ROUTES[kfe.edge_eval_route(c)] == want
    assert kfe.edge_eval_route_fits(0, c)
    assert kfe.edge_eval_route_fits(1, c) == (want == "center")


def _extreme_first(q, off, idx, st, slope):
    """The center route's order (``csrc/edge_eval.cuh``
    ``eval_center_extreme``): per channel the max of the gathered bf16 Q
    rows where the BN scale is not negative, the min where it is, then
    the subtraction, BN and LeakyReLU once a center."""
    rows = ops.geometry.index_points(q.float(), idx)  # bf16 values, exact
    ext = torch.where(st[0] < 0, rows.amin(dim=2), rows.amax(dim=2))
    return kfe._leaky(kfe._z(ext - off, st), slope)


@pytest.mark.parametrize("k", [7, 40])
@pytest.mark.parametrize("ties", [False, True])
def test_edge_eval_extreme_first_equals_plain(k, ties):
    """The extreme of the rows taken first, then BN and LeakyReLU (each
    rounded step is monotone in the gathered value, so the max of g over
    the rows is g of the max, or of the min where the scale is negative):
    ``torch.equal`` to ``edge_eval_plain`` (which counts -0 and +0 as
    equal) with positive, negative and zero BN scales, repeated
    neighbours in a row and Q values that tie."""
    rng = np.random.default_rng(100 + k + ties)
    b, m, n, c = 2, 60, 50, 32
    q = rng.standard_normal((b, n, c)).astype(np.float32)
    if ties:  # few distinct values: ties across rows, and rows equal to off
        q = np.round(q * 2) / 2
    off = rng.standard_normal((b, m, c)).astype(np.float32)
    if ties:
        off = np.round(off * 2) / 2
    idx = rng.integers(0, n, (b, m, k)).astype(np.int32)
    idx[:, :, 1::3] = idx[:, :, :1]  # slot 0 repeated in the row
    sc = rng.standard_normal(c).astype(np.float32)
    sc[::5] = 0.0
    sc[1::5] = -np.abs(sc[1::5])
    st = np.stack([sc, rng.standard_normal(c).astype(np.float32) * 0.1,
                   np.ones(c, np.float32), np.zeros(c, np.float32)])
    if ties:
        st[1, ::2] = 0.0  # bias 0: results of 0 from both signs of zero
    args = (_t(q).bfloat16(), _t(off), _t(idx), _t(st), SLOPE)
    want = kfe.edge_eval_plain(*args)
    assert (st[0] < 0).any() and (st[0] == 0).any() and (st[0] > 0).any()
    assert torch.equal(_extreme_first(*args), want)

def test_train_vjp_matches_jax():
    """``FusedEdgeTrain`` (plain ``edge_f1``, ``edge_out``, ``edge_bwd``
    and the dq/doff assembly) against ``jax.vjp`` of ``fused_edge_conv``
    on the same idx: output and statistics within 1e-5, the four
    gradients within 2e-4 of their largest element."""
    a = _edge_inputs(2)
    co = np.random.default_rng(9).standard_normal(
        a["q"].shape).astype(np.float32)

    def run(q, off, gamma, beta):
        return jax_conv(q, off, jnp.asarray(a["idx"]), gamma, beta, SLOPE,
                        True, None, 1)

    (jout, jstats), vjp = jax.vjp(run, *(jnp.asarray(a[n]) for n in
                                         ("q", "off", "gamma", "beta")))
    jgrads = vjp((jnp.asarray(co), JaxStats(jnp.zeros_like(jstats.mean),
                                            jnp.zeros_like(jstats.var))))
    leaves = [_t(a[n]).requires_grad_() for n in ("q", "off", "gamma",
                                                  "beta")]
    out, stats = kfe.fused_edge_conv(leaves[0], leaves[1], _t(a["idx"]),
                                     leaves[2], leaves[3], SLOPE)
    grads = torch.autograd.grad((out * _t(co)).sum(), leaves)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    for got, want in ((stats.mean, jstats.mean), (stats.var, jstats.var)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    assert not stats.mean.requires_grad
    for g, jg, what in zip(grads, jgrads, ("dq", "doff", "dgamma", "dbeta")):
        scale = float(np.abs(np.asarray(jg)).max())
        assert scale > 0, what
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=2e-4,
                                   atol=2e-4 * scale, err_msg=what)


def test_given_index_wrappers_take_the_plain_version_on_the_cpu():
    a = _edge_inputs(3)
    q, off, idx = _t(a["q"]).bfloat16(), _t(a["off"]), _t(a["idx"])
    st = _stack_stats(*map(_t, (a["mean"], a["var"], a["gamma"],
                                a["beta"])))
    before = (kfe.edge_f1.launches, kfe.edge_eval.launches)
    out = kfe.edge_eval(q, off, idx, st, SLOPE)
    torch.testing.assert_close(out, kfe.edge_eval_plain(q, off, idx, st,
                                                        SLOPE),
                               rtol=0, atol=0)
    h, _ = kfe.edge_f1(q, off, idx)
    assert torch.equal(h, kfe.edge_f1_plain(q, off, idx)[0])
    assert before == (kfe.edge_f1.launches, kfe.edge_eval.launches)
    # the folded rows of the two packages agree
    np.testing.assert_allclose(
        st.numpy(), np.asarray(jax_stack(*map(jnp.asarray, (
            a["mean"], a["var"], a["gamma"], a["beta"]))))[0], rtol=1e-6)


# ----------------------------------------------- DGCNN on this route

B, N, LR = 4, 100, 1e-4


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def dgcnn_runs():
    """DGCNN at B=4, N=100 (k=20, full widths, ``dropout=0``) on both
    sides: eval logits, and one train step at lr 1e-4."""
    mp = pytest.MonkeyPatch()
    mp.setenv("POINTCLOUDLIB_FUSED_SA", "1")
    try:
        rng = np.random.default_rng(11)
        x = _cloud(rng, B, N, 3)
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        batch = {"xyz": x, "label": (np.arange(B) * 7 % 40).astype(np.int32)}
        model = get_cls_model("dgcnn", dropout=0.0)
        start = random_jax_variables(model, seed=1)
        from_jax_variables(model, start)
        jm = JaxDGCNN(dropout=0.0)
        with torch.no_grad():
            got = model.eval()(_t(x)).numpy()
        want = np.asarray(jm.apply(start, jnp.asarray(x), training=False))
        out = {"start": _flat(start), "logits": (got, want)}

        before = (kknn.knn.launches, kfe.edge_f1.launches)
        step = make_cls_train_step(
            model, sgd_momentum(model.parameters(), LR), device="cpu")
        met = {k: float(v) for k, v in step(batch).items()}
        state = TrainState.create(
            apply_fn=jm.apply,
            params=jax.tree_util.tree_map(jnp.asarray, start["params"]),
            batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                               start["batch_stats"]),
            tx=jax_sgd(LR))
        state, jmet = jax_train_step(jm)(
            state, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.key(0))
        out["step"] = (_flat(to_jax_variables(model)), met,
                       _flat({"params": state.params,
                              "batch_stats": state.batch_stats}),
                       {k: float(v) for k, v in jmet.items()})
        out["launches"] = before == (kknn.knn.launches,
                                     kfe.edge_f1.launches)
        return out
    finally:
        mp.undo()


def test_dgcnn_logits_match_jax(dgcnn_runs):
    """Eval through ``knn`` and ``edge_eval`` on both sides: the bound of
    ``test_torch_port_dgcnn.py::test_logits_match_jax``."""
    got, want = dgcnn_runs["logits"]
    assert got.shape == (B, 40) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_dgcnn_train_step_matches_jax(dgcnn_runs):
    """One step through ``knn``, ``edge_f1``, ``edge_out`` and
    ``edge_bwd``: the loss within 2e-3 relative, the accuracy equal,
    every parameter within 5e-3 of its largest element and each update
    at cosine ≥ 0.98 with JAX's (``test_torch_port_dgcnn.py``'s first-
    step bounds; the Dense bias before a train-mode BatchNorm gets an
    exactly-0 gradient and is left out). No kernel was launched."""
    got, met, want, jmet = dgcnn_runs["step"]
    start = dgcnn_runs["start"]
    assert dgcnn_runs["launches"]
    assert abs(met["loss"] - jmet["loss"]) <= 2e-3 * abs(jmet["loss"])
    assert met["acc"] == jmet["acc"]
    cancelled = "['params']['DenseBNAct_2']['Dense_0']['bias']"
    for key in (k for k in want if k.startswith("['params']")):
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=5e-3 * np.abs(want[key]).max(),
                                   err_msg=key)
        if key == cancelled:
            continue
        du = (got[key] - start[key]).ravel()
        dw = (want[key] - start[key]).ravel()
        cos = du @ dw / (np.linalg.norm(du) * np.linalg.norm(dw))
        assert cos >= 0.98, (key, cos)


def test_predictor_serves_bucket_n_above_4096():
    """A request of 4,200 points keeps N (bucket n, no padding, no sort:
    4200 % 128 ≠ 0) and gives the probabilities of the model applied to
    the cloud directly."""
    from pointcloudlib_tpu_torch.inference import _bucket

    assert _bucket(4200) == 4200
    variables = random_jax_variables(get_cls_model("pointnet2"), seed=3)
    pp = Predictor.from_variables("pointnet2", variables, batch_size=1,
                                  device="cpu")
    rng = np.random.default_rng(4)
    x = _cloud(rng, 1, 4200, 3)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    nrm = _cloud(rng, 1, 4200, 3)
    got = pp.predict_proba(x, nrm)
    with torch.no_grad():
        want = torch.softmax(pp.model(_t(x), _t(nrm)), dim=-1).numpy()
    np.testing.assert_array_equal(got, want)
