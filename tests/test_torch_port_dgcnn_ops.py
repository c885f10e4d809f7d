"""The port's fused DGCNN EdgeConv pieces against the JAX package, on the
CPU: the plain versions of the four kernels (``edge_knn_eval_plain``,
``edge_knn_f1_plain``, ``edge_out_plain``, ``edge_bwd_plain``) against
the JAX private calls that reach the same Pallas kernels
(``_fused_edge_eval_knn_jit``, ``_call_eknn_f1``, ``_call_eout``), and
``FusedEdgeKnnTrain``'s gradients against ``jax.vjp`` of
``fused_edge_conv_knn``.

Inputs are numpy arrays from a seed, handed to both frameworks; the JAX
kernels run in Pallas interpret mode. The JAX kernels form the kNN
cross term with an f32 matrix product, the port channel by channel, so
a near-equal k-th neighbour can flip between the two: the JAX package's
own test accepts that (``_mostly_close``, ``tests/test_fused_edge.py``),
and so do these, with the neighbour lists compared row by row.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudlib_tpu.ops.pallas.fused_edge import EdgeStats as JaxStats
from pointcloudlib_tpu.ops.pallas.fused_edge import (
    _call_eknn_f1,
    _call_eout,
    _fused_edge_eval_knn_jit,
    fused_edge_conv_knn as jax_conv_knn,
)
from pointcloudlib_tpu.ops.pallas.fused_sa import _stack_stats as jax_stack

from pointcloudlib_tpu_torch.ops.kernels import fused_edge as kfe
from pointcloudlib_tpu_torch.ops.kernels import knn as kknn
from pointcloudlib_tpu_torch.ops.kernels.fused_sa import _stack_stats
from pointcloudlib_tpu_torch.ops.kernels.fused_sa_train import (
    _bf,
    _moments,
    _xhat,
    _z,
)

SLOPE = 0.2

CASES = {  # B, N, k, Cin, C
    "k8_xyz": (2, 128, 8, 3, 32),
    "k20_c16": (2, 128, 20, 16, 32),
    "k20_xyz_duplicates": (2, 128, 20, 3, 32),
    # the JAX kNN kernels take two query tiles here (test_fused_edge.py's
    # multi-tile regression shape), so their BN sums span grid steps
    "multitile_n512": (2, 512, 8, 16, 256),
    # part segmentation's k (its pass 1 at N = 2,048 is the select
    # route's k = 40 instance on the card)
    "partseg_k40_xyz": (2, 128, 40, 3, 64),
}


def _mostly_close(a, b, rtol=1e-5, atol=1e-5, frac=1e-2, max_abs=0.05):
    """Within ``rtol``/``atol`` on all but ``frac`` of the elements, the
    rest within ``max_abs`` (a flipped k-th neighbour moves one row; a
    wrong sum or index moves nearly every element by far more)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    bad = ~np.isclose(a, b, rtol=rtol, atol=atol)
    assert bad.mean() <= frac, (bad.mean(), frac)
    if bad.any():
        assert np.abs(a - b)[bad].max() <= max_abs


def _inputs(case, seed=0):
    """``x``, ``q``, ``off`` (f32, from bf16 operands as the model forms
    them), BN ``gamma``/``beta`` and running ``mean``/``var``, all numpy.
    The duplicates case repeats the first half of every cloud, so each
    point has a twin at d² = 0: exact kNN ties and exact max-pool ties."""
    b, n, k, cin, c = CASES[case]
    rng = np.random.default_rng(seed + sorted(CASES).index(case))
    x = rng.standard_normal((b, n, cin)).astype(np.float32)
    if "duplicates" in case:
        x[:, n // 2:] = x[:, : n // 2]
    wa = rng.standard_normal((cin, c)).astype(np.float32) * 0.3
    wb = rng.standard_normal((cin, c)).astype(np.float32) * 0.3
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    q = np.asarray(jnp.dot(xb, jnp.asarray(wa).astype(jnp.bfloat16),
                           preferred_element_type=jnp.float32))
    off = np.asarray(jnp.dot(xb, jnp.asarray(wa - wb).astype(jnp.bfloat16),
                             preferred_element_type=jnp.float32))
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = (rng.standard_normal(c) * 0.1).astype(np.float32)
    mean = (rng.standard_normal(c) * 0.1).astype(np.float32)
    var = rng.uniform(0.5, 2.0, c).astype(np.float32)
    return dict(x=x, q=q, off=off, gamma=gamma, beta=beta, mean=mean,
                var=var, k=k)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rows_equal(got, want):
    """``(rows whose neighbour list is equal, rows)``."""
    eq = (np.asarray(got) == np.asarray(want)).all(-1)
    return int(eq.sum()), eq.size


@pytest.mark.parametrize("case", sorted(CASES))
def test_knn_eval_plain_matches_pallas(case):
    a = _inputs(case)
    want = _fused_edge_eval_knn_jit(
        jnp.asarray(a["x"]), jnp.asarray(a["q"]), jnp.asarray(a["off"]),
        jnp.asarray(a["gamma"]), jnp.asarray(a["beta"]),
        JaxStats(jnp.asarray(a["mean"]), jnp.asarray(a["var"])),
        k=a["k"], slope=SLOPE, interpret=True)
    got = kfe.fused_edge_eval_knn(
        _t(a["x"]), _t(a["q"]), _t(a["off"]), _t(a["gamma"]),
        _t(a["beta"]), kfe.EdgeStats(_t(a["mean"]), _t(a["var"])), a["k"],
        SLOPE)
    assert got.shape == want.shape and got.dtype == torch.float32
    _mostly_close(got.numpy(), want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_knn_f1_plain_matches_pallas(case):
    """idx equal on at least 99 % of the rows (``pytest -s`` prints the
    count), the bf16 h and the BN sums as ``_mostly_close`` allows; where
    every row agrees, h is bit-identical."""
    a = _inputs(case, seed=1)
    idx, h, psum = kfe.edge_knn_f1_plain(
        _t(a["x"]), _t(a["q"]).bfloat16(), _t(a["off"]), a["k"])
    jidx, jh, jpsum = _call_eknn_f1(jnp.asarray(a["x"]), jnp.asarray(a["q"]),
                                    jnp.asarray(a["off"]), a["k"], True)
    same, rows = _rows_equal(idx.numpy(), jidx)
    print(f"{case}: {same} of {rows} neighbour lists equal")
    assert idx.dtype == torch.int32 and h.dtype == torch.bfloat16
    assert same >= 0.99 * rows
    hf = h.float().numpy()
    jhf = np.asarray(jh.astype(jnp.float32))
    if same == rows:
        np.testing.assert_array_equal(hf, jhf)
    _mostly_close(hf, jhf)
    _mostly_close(psum.numpy(), np.asarray(jpsum)[0], rtol=1e-5,
                  atol=1e-5 * float(np.abs(jpsum).max()))
    if "duplicates" in case:  # a point and its twin both sit at d² = 0
        i = idx.numpy()
        n = i.shape[1]
        pts = np.arange(n)
        assert (i[:, :, 0] == pts % (n // 2)).all()
        assert (i[:, :, 1] == pts % (n // 2) + n // 2).all()


@pytest.mark.parametrize("ties", [False, True])
def test_out_plain_matches_pallas(ties):
    """``edge_out_plain`` against ``_call_eout`` on a random checkpoint;
    with ``ties`` every center's slots come in equal pairs."""
    rng = np.random.default_rng(4)
    b, n, k, c = 2, 128, 20, 64
    h = rng.standard_normal((b, n, k, c)).astype(np.float32)
    if ties:
        h[:, :, k // 2:] = h[:, :, : k // 2]
    hb = jnp.asarray(h).astype(jnp.bfloat16)
    mean = rng.standard_normal(c).astype(np.float32) * 0.1
    var = rng.uniform(0.5, 2.0, c).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.standard_normal(c).astype(np.float32) * 0.1
    st = _stack_stats(*map(_t, (mean, var, gamma, beta)))
    want = _call_eout(hb, jax_stack(*map(jnp.asarray, (mean, var, gamma,
                                                       beta))), SLOPE, True)
    got = kfe.edge_out_plain(_t(np.asarray(hb.astype(jnp.float32))
                                ).bfloat16(), st, SLOPE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_vjp_matches_jax(case):
    """``FusedEdgeKnnTrain`` (the plain versions of f1, out and the
    backward, with the dq/doff assembly) against ``jax.vjp`` of
    ``fused_edge_conv_knn``: the output and batch statistics within 1e-5,
    ``dq``, ``doff``, ``dγ`` and ``dβ`` within 2e-4, on all but 1 % of
    the elements (``_mostly_close``). No gradient reaches ``x``."""
    a = _inputs(case, seed=2)
    k = a["k"]
    co = np.random.default_rng(9).standard_normal(
        a["q"].shape).astype(np.float32)

    def run(q, off, gamma, beta):
        return jax_conv_knn(jnp.asarray(a["x"]), q, off, gamma, beta, k,
                            SLOPE, True, None, 1)

    (jout, jstats), vjp = jax.vjp(run, *(jnp.asarray(a[n]) for n in
                                         ("q", "off", "gamma", "beta")))
    jgrads = vjp((jnp.asarray(co), JaxStats(jnp.zeros_like(jstats.mean),
                                            jnp.zeros_like(jstats.var))))

    x = _t(a["x"]).requires_grad_()
    leaves = [_t(a[n]).requires_grad_() for n in ("q", "off", "gamma",
                                                  "beta")]
    out, stats = kfe.fused_edge_conv_knn(x, *leaves, k, SLOPE)
    grads = torch.autograd.grad((out * _t(co)).sum(), leaves,
                                retain_graph=True)
    _mostly_close(out.detach().numpy(), jout)
    _mostly_close(stats.mean.numpy(), jstats.mean)
    _mostly_close(stats.var.numpy(), jstats.var)
    assert not stats.mean.requires_grad and not stats.var.requires_grad
    for g, jg, what in zip(grads, jgrads, ("dq", "doff", "dgamma", "dbeta")):
        scale = float(np.abs(np.asarray(jg)).max())
        assert scale > 0, what
        _mostly_close(g.numpy(), jg, rtol=2e-4, atol=2e-4 * scale)
    # the graph carries no gradient: x's comes through q and off only
    assert torch.autograd.grad(out.sum(), x, allow_unused=True)[0] is None


def test_backward_splits_max_pool_ties_evenly():
    """A center whose k slots are all equal gives each slot ``dout / k``
    (``jnp.max``'s gradient), scaled by the slope where z ≤ 0; the
    scatter's count column counts each slot once."""
    b, n, k, c = 1, 4, 4, 2
    h = torch.zeros((b, n, k, c)).bfloat16()
    h[..., 1] = 1.0
    st = torch.tensor([[1.0, 1.0], [-0.5, 0.0], [1.0, 1.0], [0.0, 0.0]])
    dout = torch.ones((b, n, c))
    idx = torch.arange(n * k, dtype=torch.int32).reshape(b, n, k) % n
    ps, scat, d1, d2 = kfe.edge_bwd_plain(h, dout, idx, st, SLOPE, n)
    # channel 0: z = -0.5 (slope side), channel 1: z = 1
    torch.testing.assert_close(d1[0, 0], torch.tensor([SLOPE, 1.0]))
    torch.testing.assert_close(ps[0], torch.tensor([n * SLOPE, n * 1.0]))
    assert torch.equal(scat[0, :, 2 * c], torch.full((n,), float(k)))
    torch.testing.assert_close(d2[0, 0], torch.tensor([0.0, 4.0]))


def test_edge_knn_f1_routes():
    """Pass 1's route, a function of the shapes alone (``knn.edge_f1_route``):
    the select instance of the list length and width at DGCNN's and its
    part segmentation's train shapes, the block route for small grids,
    widths and list lengths no select instance takes, and shared memory
    a block cannot hold."""
    r = kknn.edge_f1_route
    name = kknn.edge_route_name
    assert [name(r(32, 1024, cin, c, 20)) for cin, c in (
        (3, 64), (64, 64), (64, 128), (128, 256))] == [
        "select 128x3 k<=24 C=64", "select 128x3 k<=24 C=64",
        "select 128x3 k<=24 C=128", "select 128x3 k<=24 C=256"]
    assert [name(r(16, 2048, cin, 64, 40)) for cin in (3, 64)] == [
        "select 128x3 k<=40 C=64"] * 2
    assert name(r(4, 2048, 6, 64, 40)) == "select 128x3 k<=40 C=64"
    assert r(4, 1024, 3, 64, 20) == 0       # 32 blocks of 128 queries
    assert r(16, 1000, 64, 64, 40) == 0     # part seg's kNN-route size
    assert r(32, 1024, 3, 32, 20) == 0      # no select instance at C = 32
    assert r(32, 1024, 3, 64, 24) == 1      # 3 entries a lane, as k = 20
    assert r(32, 1024, 3, 64, 8) == 0       # no instance for lists of 8
    assert r(32, 4096, 512, 64, 20) == 0    # the walk's tiles do not fit
    assert kknn.edge_f1_route_fits(4, 2048, 64, 64, 20)  # a longer list
    assert not kknn.edge_f1_route_fits(1, 2048, 64, 64, 40)  # k > 24
    assert not kknn.edge_f1_route_fits(2, 2048, 64, 64, 20)  # C = 128's
    assert not kknn.edge_f1_route_fits(0, 64, 64, 64, 65)


def test_wrappers_take_the_plain_version_on_the_cpu():
    """A CPU tensor goes to the plain version and counts no launch."""
    a = _inputs("k8_xyz")
    before = (kfe.edge_knn_eval.launches, kfe.edge_knn_f1.launches,
              kfe.edge_out.launches, kfe.edge_bwd.launches)
    st = _stack_stats(*map(_t, (a["mean"], a["var"], a["gamma"],
                                a["beta"])))
    x, q, off = _t(a["x"]), _t(a["q"]).bfloat16(), _t(a["off"])
    out = kfe.edge_knn_eval(x, q, off, st, a["k"], SLOPE)
    torch.testing.assert_close(out, kfe.edge_knn_eval_plain(
        x, q, off, st, a["k"], SLOPE), rtol=0, atol=0)
    idx, h, _ = kfe.edge_knn_f1(x, q, off, a["k"])
    kfe.edge_bwd(h, kfe.edge_out(h, st, SLOPE), idx, st, SLOPE, x.shape[1])
    assert before == (kfe.edge_knn_eval.launches, kfe.edge_knn_f1.launches,
                      kfe.edge_out.launches, kfe.edge_bwd.launches)



def _bwd_sparse_dz(h, dout, idx, st, slope, n):
    """``edge_bwd_plain``'s result as the kernel forms it: ps, d1 and d2
    from the walks, scat's dz half reduced from the rows and channel
    quads whose dz is not all 0 only, its x̂ half and count over every
    edge."""
    b, m, k, c = h.shape
    hf = h.float()
    dz = kfe._maxpool_dz(_z(hf, st), dout, slope)
    xh = _xhat(hf, st)
    ps = torch.stack([dz.sum((0, 1, 2)), (dz * xh).sum((0, 1, 2))])
    quads = dz.reshape(b, m * k, c // 4, 4)
    bb, e, u = (quads != 0).any(-1).nonzero(as_tuple=True)
    rows = idx.reshape(b, m * k).long()[bb, e]
    at = (((bb * n + rows) * (c // 4) + u)[:, None] * 4
          + torch.arange(4)).reshape(-1)
    dzh = torch.zeros(b * n * c).scatter_add_(
        0, at, _bf(quads)[bb, e, u].reshape(-1)).reshape(b, n, c)
    tgt = idx.reshape(b, m * k).long()
    xhh = torch.zeros((b, n, c)).scatter_add_(
        1, tgt[..., None].expand(-1, -1, c), _bf(xh).reshape(b, m * k, c))
    deg = torch.zeros((b, n)).scatter_add_(1, tgt, torch.ones(tgt.shape))
    scat = torch.cat([dzh, xhh, deg[..., None]], dim=-1)
    return ps, scat, dz.sum(2), xh.sum(2)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_sparse_dz_matches_plain(case):
    """The kernel's sparse dz scatter (``_bwd_sparse_dz``) against
    ``edge_bwd_plain``: ps, d1, d2, the dz half and the count bit for bit
    (the dz quads left out add only zeros), the x̂ half within f32
    rounding of its largest element (another order of the same sums)."""
    a = _inputs(case, seed=3)
    x, q, off = _t(a["x"]), _t(a["q"]).bfloat16(), _t(a["off"])
    idx, h, psum = kfe.edge_knn_f1_plain(x, q, off, a["k"])
    b, n, k, c = h.shape
    st = _stack_stats(*_moments(psum, float(b * n * k)),
                      _t(a["gamma"]), _t(a["beta"]))
    dout = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (b, n, c)).astype(np.float32))
    got = _bwd_sparse_dz(h, dout, idx, st, SLOPE, n)
    want = kfe.edge_bwd_plain(h, dout, idx, st, SLOPE, n)
    for g, w in zip(got[:1] + got[2:], want[:1] + want[2:]):
        assert torch.equal(g, w)
    assert torch.equal(got[1][..., :c], want[1][..., :c])
    assert torch.equal(got[1][..., 2 * c], want[1][..., 2 * c])
    torch.testing.assert_close(
        got[1][..., c:2 * c], want[1][..., c:2 * c], rtol=0,
        atol=1e-6 * want[1][..., c:2 * c].abs().max().item())
