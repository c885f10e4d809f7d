"""The port's two-layer EdgeConv pieces (DGCNN part segmentation's
``Fused2EdgeConv``) against the JAX package, on the CPU: the plain
versions of the six kernels against the Pallas kernels they replace
(``_ke2_stats2``, ``_ke2_out``, ``_ke2_p1``, ``_ke2_p2``, ``_ke2_eval``,
``_ke2_knn_eval``), and ``fused_edge2_conv`` / ``fused_edge2_conv_knn``
(forward, statistics and gradients) against ``jax.vjp`` of the JAX
functions and of ``_edge2_reference``, the rounding-identical jnp
replica of ``tests/test_fused_edge.py``.

Inputs are numpy arrays from a seed, handed to both frameworks; the
Pallas kernels run in interpret mode, called as the JAX package's
custom VJP calls them (``fused_edge.py:733-868``). Widths are the
model's (C1 = C2 = 64); B=2 with N=128 (the graph built inside) or
N=100 (a given index), k=8, and k=40 once. Tolerances are stated at
each test: where the two sides take the same roundings, within f32
summation order; where a bf16 rounding of y1 or dh2 may land on the
other side of a tie between the two frameworks, on all but 1 % of the
elements (``_mostly_close``).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from pointcloudlib_tpu.ops.pallas.fused_edge import Edge2Stats as JaxStats2
from pointcloudlib_tpu.ops.pallas.fused_edge import (
    _fused_edge2_eval_knn_jit,
    _ke2_out,
    _ke2_p1,
    _ke2_p2,
    _ke2_stats2,
)
from pointcloudlib_tpu.ops.pallas.fused_edge import (
    fused_edge2_conv as jax_conv2,
)
from pointcloudlib_tpu.ops.pallas.fused_edge import (
    fused_edge2_conv_knn as jax_conv2_knn,
)
from pointcloudlib_tpu.ops.pallas.fused_edge import (
    fused_edge2_eval as jax_eval2,
)
from pointcloudlib_tpu.ops.pallas.fused_sa import (
    _divisor_tile,
    _flat,
    _gchunk,
    _m_tile,
    _ps_spec,
    _st_spec,
    _w_spec,
)
from pointcloudlib_tpu.ops.pallas.fused_sa import _stack_stats as jax_stack
from test_fused_edge import _edge2_reference

from pointcloudlib_tpu_torch.ops.kernels import fused_edge as kfe
from pointcloudlib_tpu_torch.ops.kernels.fused_sa_train import _moments

SLOPE = 0.2
C1 = C2 = 64
# B, M (= N), k; "ties": every center's slots come in equal pairs
CASES = {"k8": (2, 128, 8), "k8_ties": (2, 128, 8), "k8_n100": (2, 100, 8),
         "k40": (2, 128, 40)}


def _mostly_close(a, b, rtol=1e-5, atol=1e-5, frac=1e-2, max_abs=0.05):
    """Within ``rtol``/``atol`` on all but ``frac`` of the elements, the
    rest within ``max_abs``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    bad = ~np.isclose(a, b, rtol=rtol, atol=atol)
    assert bad.mean() <= frac, (bad.mean(), frac)
    if bad.any():
        assert np.abs(a - b)[bad].max() <= max_abs


def _close(got, want, rel):
    """Every element within ``rel`` of the largest |want|."""
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rel * scale)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bn(rng, c, mean=0.0, var=1.0):
    """(mean, var, gamma, beta) about the given moments."""
    return ((mean + 0.1 * rng.standard_normal(c)).astype(np.float32),
            (var * rng.uniform(0.7, 1.4, c)).astype(np.float32),
            rng.uniform(0.5, 1.5, c).astype(np.float32),
            (0.1 * rng.standard_normal(c)).astype(np.float32))


def _kernel_inputs(case, seed=0):
    """The six kernels' inputs as numpy: a bf16-exact checkpoint ``h1``,
    the folded rows ``st1``/``st2`` [4, C] (st2 about h2's own moments),
    W2, dout, a neighbour index into ``n = M`` points, the pre-divided
    sums ``us2``/``us1``, and the gather operands ``q`` (bf16-exact),
    ``off`` and ``x`` (xyz) for the eval kernels."""
    b, m, k = CASES[case]
    rng = np.random.default_rng(seed + sorted(CASES).index(case))
    h1 = rng.standard_normal((b, m, k, C1)).astype(np.float32)
    if "ties" in case:
        h1[:, :, k // 2:] = h1[:, :, : k // 2]
    h1 = np.asarray(jnp.asarray(h1).astype(jnp.bfloat16).astype(jnp.float32))
    w2 = rng.uniform(-1 / 8, 1 / 8, (C1, C2)).astype(np.float32)
    st1 = np.asarray(jax_stack(*map(jnp.asarray, _bn(rng, C1))))[0]
    h2 = kfe._chain2(_t(h1), _t(st1), _t(st1), _t(w2), SLOPE)[2]
    st2 = np.asarray(jax_stack(*map(jnp.asarray, _bn(
        rng, C2, float(h2.mean()), float(h2.var())))))[0]
    x = rng.standard_normal((b, m, 3)).astype(np.float32)
    q = (x @ rng.uniform(-0.6, 0.6, (3, C1))).astype(np.float32)
    q = np.asarray(jnp.asarray(q).astype(jnp.bfloat16).astype(jnp.float32))
    return dict(
        h1=h1, st1=st1, st2=st2, w2=w2,
        dout=rng.standard_normal((b, m, C2)).astype(np.float32),
        idx=rng.integers(0, m, (b, m, k)).astype(np.int32),
        us2=(0.05 * rng.standard_normal((2, C2))).astype(np.float32),
        us1=(0.05 * rng.standard_normal((2, C1))).astype(np.float32),
        x=x, q=q,
        off=(x @ rng.uniform(-0.3, 0.3, (3, C1))).astype(np.float32), k=k)


def _jax_kernels(a):
    """The four train kernels and the two eval kernels of the JAX
    package on the inputs of :func:`_kernel_inputs`, as its forward and
    backward rules call them."""
    h1 = jnp.asarray(a["h1"]).astype(jnp.bfloat16)
    b, m, k, c1 = h1.shape
    st1, st2 = jnp.asarray(a["st1"])[None], jnp.asarray(a["st2"])[None]
    w2 = jnp.asarray(a["w2"]).astype(jnp.bfloat16)
    dout = jnp.asarray(a["dout"])
    mt = _m_tile(m, k, bf16_widths=c1)
    cm = _divisor_tile(mt, max(1, 1024 // k))
    grid = (b * (m // mt),)
    h1_spec = _flat(m, mt, (k, c1))
    call = functools.partial(pl.pallas_call, grid=grid, interpret=True)
    out = {
        "stats2": call(
            functools.partial(_ke2_stats2, cm=cm, slope=SLOPE),
            in_specs=[h1_spec, _st_spec(c1), _w_spec(w2)],
            out_specs=_ps_spec(C2),
            out_shape=jax.ShapeDtypeStruct((1, 2, C2), jnp.float32),
        )(h1, st1, w2)[0],
        "out": call(
            functools.partial(_ke2_out, cm=cm, slope=SLOPE),
            in_specs=[h1_spec, _st_spec(c1), _st_spec(C2), _w_spec(w2)],
            out_specs=_flat(m, mt, (C2,)),
            out_shape=jax.ShapeDtypeStruct((b, m, C2), jnp.float32),
        )(h1, st1, st2, w2),
    }
    mt = _m_tile(m, k, bf16_widths=c1, f32_widths=C2 // k + 1)
    cm = _divisor_tile(mt, max(1, 1024 // k))
    ps2, vecs, mats = pl.pallas_call(
        functools.partial(_ke2_p1, cm=cm, slope=SLOPE),
        grid=(b * (m // mt),),
        in_specs=[_flat(m, mt, (k, c1)), _flat(m, mt, (C2,)), _st_spec(c1),
                  _st_spec(C2), _w_spec(w2)],
        out_specs=[_ps_spec(C2),
                   pl.BlockSpec((1, 1, 3 * c1), lambda *_: (0, 0, 0)),
                   pl.BlockSpec((1, 3 * c1, 2 * C2), lambda *_: (0, 0, 0))],
        out_shape=[jax.ShapeDtypeStruct((1, 2, C2), jnp.float32),
                   jax.ShapeDtypeStruct((1, 1, 3 * c1), jnp.float32),
                   jax.ShapeDtypeStruct((1, 3 * c1, 2 * C2), jnp.float32)],
        interpret=True,
    )(h1, dout, st1, st2, w2)
    out["p1"] = (ps2[0], vecs[0, 0], mats[0])
    n = m
    mt = _m_tile(m, k, bf16_widths=c1, f32_widths=C2 // k + 1,
                 fixed_bytes=8 * n * c1)
    cmg = _gchunk(mt, k, n)
    out["p2"] = pl.pallas_call(
        functools.partial(_ke2_p2, cm=cmg, slope=SLOPE),
        grid=(b, m // mt),
        in_specs=[
            pl.BlockSpec((1, mt, k, c1), lambda i, j: (i, j, 0, 0)),
            pl.BlockSpec((1, mt, C2), lambda i, j: (i, j, 0)),
            pl.BlockSpec((1, mt, k), lambda i, j: (i, j, 0)),
            _st_spec(c1), _st_spec(C2), _w_spec(w2),
            pl.BlockSpec((C2, c1), lambda i, j: (0, 0)),
            _ps_spec(C2), _ps_spec(c1),
        ],
        out_specs=[pl.BlockSpec((1, n, c1), lambda i, j: (i, 0, 0)),
                   pl.BlockSpec((1, mt, c1), lambda i, j: (i, j, 0))],
        out_shape=[jax.ShapeDtypeStruct((b, n, c1), jnp.float32),
                   jax.ShapeDtypeStruct((b, m, c1), jnp.float32)],
        interpret=True,
    )(h1, dout, jnp.asarray(a["idx"]), st1, st2, w2,
      jnp.swapaxes(jnp.asarray(a["w2"]), 0, 1).astype(jnp.bfloat16),
      jnp.asarray(a["us2"])[None], jnp.asarray(a["us1"])[None])

    # the eval kernels from running statistics that fold to st1 and st2:
    # γ = sc/rs, β = bi + μ·sc with rs = rsqrt(var + eps)
    def stats(st):
        sc, bi, rs, mrs = (jnp.asarray(r) for r in st)
        mu = mrs / rs
        var = 1.0 / (rs * rs) - 1e-5
        return mu, var, sc / rs, bi + mu * sc

    (m1, v1, g1, b1), (m2, v2, g2, b2) = stats(a["st1"]), stats(a["st2"])
    run = JaxStats2(m1, v1, m2, v2)
    q, off = jnp.asarray(a["q"]), jnp.asarray(a["off"])
    out["eval"] = jax_eval2(q, off, jnp.asarray(a["idx"]), jnp.asarray(
        a["w2"]), g1, b1, g2, b2, run, SLOPE, True)
    out["folded"] = (np.asarray(jax_stack(m1, v1, g1, b1))[0],
                     np.asarray(jax_stack(m2, v2, g2, b2))[0])
    if m % 128 == 0:
        out["knn_eval"] = _fused_edge2_eval_knn_jit(
            jnp.asarray(a["x"]), q, off, jnp.asarray(a["w2"]), g1, b1, g2,
            b2, run, k=k, slope=SLOPE, interpret=True)
    return out


@pytest.fixture(scope="module")
def kernels():
    """Every case's inputs and the JAX kernels' results, computed once."""
    out = {}
    for case in CASES:
        a = _kernel_inputs(case)
        out[case] = (a, _jax_kernels(a))
    return out


def _port(a, *names):
    return [_t(a[n]) for n in names]


@pytest.mark.parametrize("case", sorted(CASES))
def test_stats2_plain_matches_pallas(kernels, case):
    """[Σh2, Σh2²] within 1e-5 of its largest element: the same bf16
    operands, f32 sums in another order."""
    a, want = kernels[case]
    h1, st1, w2 = _port(a, "h1", "st1", "w2")
    got = kfe.edge2_stats2_plain(h1.bfloat16(), st1, w2, SLOPE)
    assert got.shape == (2, C2)
    _close(got.numpy(), want["stats2"], 1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_out_plain_matches_pallas(kernels, case):
    """The pooled output within 1e-5 (relative and absolute) on all but
    1 % of the elements."""
    a, want = kernels[case]
    h1, st1, st2, w2 = _port(a, "h1", "st1", "st2", "w2")
    got = kfe.edge2_out_plain(h1.bfloat16(), st1, st2, w2, SLOPE)
    _mostly_close(got.numpy(), want["out"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_p1_plain_matches_pallas(kernels, case):
    """``ps2`` and ``vecs`` within 1e-5 of their largest element,
    ``mats`` (bf16 operands on both sides, f32 sums) within 1e-4 of its
    largest element. Where every slot has a twin, ``ps2`` too is held
    within 1e-4 only: there the interpreted JAX kernel's Σdz2·x̂2 lies
    1.5e-3 (3e-5 of the largest element) from the float64 sum of the
    same terms, the plain version's 6e-6."""
    a, want = kernels[case]
    h1, dout, st1, st2, w2 = _port(a, "h1", "dout", "st1", "st2", "w2")
    ps2, vecs, mats = kfe.edge2_p1_plain(h1.bfloat16(), dout, st1, st2, w2,
                                         SLOPE)
    assert ps2.shape == (2, C2) and vecs.shape == (3 * C1,)
    assert mats.shape == (3 * C1, 2 * C2)
    rel_ps2 = 1e-4 if "ties" in case else 1e-5
    for got, w, rel in zip((ps2, vecs, mats), want["p1"], (rel_ps2, 1e-5,
                                                          1e-4)):
        _close(got.numpy(), w, rel)


@pytest.mark.parametrize("case", sorted(CASES))
def test_p2_plain_matches_pallas(kernels, case):
    """``dq`` and ``doff`` within 1e-4 of their largest element: the TPU
    kernel scatters dh1 as a hi and a lo bf16 part (the lo part keeps 8
    of the 16 bits the hi part drops), the port adds it in f32."""
    a, want = kernels[case]
    h1, dout, idx, st1, st2, w2, us2, us1 = _port(
        a, "h1", "dout", "idx", "st1", "st2", "w2", "us2", "us1")
    n = h1.shape[1]
    dq, doff = kfe.edge2_p2_plain(h1.bfloat16(), dout, idx, st1, st2, w2,
                                  us2, us1, SLOPE, n)
    assert dq.shape == (h1.shape[0], n, C1) and doff.shape == dq.shape
    _close(dq.numpy(), want["p2"][0], 1e-4)
    _close(doff.numpy(), want["p2"][1], 1e-4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_plain_matches_pallas(kernels, case):
    """``edge2_eval_plain`` against ``fused_edge2_eval``: the gather of
    bf16 q by a given index, then the chain; within 1e-5 on all but 1 %
    of the elements. The running statistics fold to the same rows on
    both sides."""
    a, want = kernels[case]
    st1, st2 = (_t(s) for s in want["folded"])
    q, off, idx, w2 = _port(a, "q", "off", "idx", "w2")
    got = kfe.edge2_eval_plain(q.bfloat16(), off, idx, st1, st2, w2, SLOPE)
    _mostly_close(got.numpy(), want["eval"])


@pytest.mark.parametrize("case", ["k40", "k8"])
def test_knn_eval_plain_matches_pallas(kernels, case):
    """``edge2_knn_eval_plain`` against ``_fused_edge2_eval_knn_jit``. The
    JAX kernel forms the kNN cross term with an f32 matrix product, the
    port channel by channel, so a near-equal k-th neighbour may flip
    (``tests/test_torch_port_dgcnn_ops.py``): all but 1 % of the
    elements within 1e-5."""
    a, want = kernels[case]
    st1, st2 = (_t(s) for s in want["folded"])
    x, q, off, w2 = _port(a, "x", "q", "off", "w2")
    got = kfe.edge2_knn_eval_plain(x, q.bfloat16(), off, st1, st2, w2,
                                   a["k"], SLOPE)
    assert got.shape == (x.shape[0], x.shape[1], C2)
    _mostly_close(got.numpy(), want["knn_eval"])


# ------------------------------------------------------- the VJP

VJP_CASES = {  # B, N, k, C_in; the graph inside where N % 128 == 0
    "idx_n100": (2, 100, 8, 3), "knn_n128": (2, 128, 8, 3),
    "knn_n128_k40": (2, 128, 40, 3), "idx_n100_c64": (2, 100, 8, 64)}
_LEAVES = ("q", "off", "w2", "g1", "b1", "g2", "b2")


def _layer_inputs(case, seed=3):
    b, n, k, cin = VJP_CASES[case]
    rng = np.random.default_rng(seed + sorted(VJP_CASES).index(case))
    x = rng.standard_normal((b, n, cin)).astype(np.float32)
    wa = rng.uniform(-0.5, 0.5, (cin, C1)).astype(np.float32)
    wb = rng.uniform(-0.5, 0.5, (cin, C1)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    q = np.asarray(jnp.dot(xb, jnp.asarray(wa).astype(jnp.bfloat16),
                           preferred_element_type=jnp.float32))
    off = np.asarray(jnp.dot(xb, jnp.asarray(wa - wb).astype(jnp.bfloat16),
                             preferred_element_type=jnp.float32))
    _, _, g1, b1 = _bn(rng, C1)
    _, _, g2, b2 = _bn(rng, C2)
    return dict(
        x=x, q=q, off=off, g1=g1, b1=b1, g2=g2, b2=b2, k=k,
        w2=rng.uniform(-1 / 8, 1 / 8, (C1, C2)).astype(np.float32),
        idx=rng.integers(0, n, (b, n, k)).astype(np.int32),
        co=rng.standard_normal((b, n, C2)).astype(np.float32))


@pytest.fixture(scope="module")
def vjps():
    """Per case: the inputs, JAX's (out, stats, grads) of the fused
    function, and of ``_edge2_reference`` on the given-index cases."""
    out = {}
    for case in VJP_CASES:
        a = _layer_inputs(case)
        k = a["k"]
        knn = case.startswith("knn")

        def run(q, off, w2, g1, b1, g2, b2, a=a, k=k, knn=knn):
            if knn:
                return jax_conv2_knn(jnp.asarray(a["x"]), q, off, w2, g1, b1,
                                     g2, b2, k, SLOPE, True, None, 1)
            return jax_conv2(q, off, jnp.asarray(a["idx"]), w2, g1, b1, g2,
                             b2, SLOPE, True)

        args = [jnp.asarray(a[n]) for n in _LEAVES]
        (o, st), vjp = jax.vjp(run, *args)
        zeros = JaxStats2(*(jnp.zeros_like(s) for s in st))
        res = {"jax": (o, st, vjp((jnp.asarray(a["co"]), zeros)))}
        if not knn:
            def ref(*leaves, a=a):
                return _edge2_reference(leaves[0], leaves[1],
                                        jnp.asarray(a["idx"]), *leaves[2:],
                                        slope=SLOPE)
            (o, (s1, s2)), vjp = jax.vjp(ref, *args)
            zeros = tuple(tuple(jnp.zeros_like(v) for v in s)
                          for s in (s1, s2))
            res["reference"] = (o, JaxStats2(*s1, *s2),
                                vjp((jnp.asarray(a["co"]), zeros)))
        out[case] = (a, res)
    return out


def _port_vjp(a, knn):
    leaves = [_t(a[n]).requires_grad_() for n in _LEAVES]
    if knn:
        x = _t(a["x"]).requires_grad_()
        out, stats = kfe.fused_edge2_conv_knn(x, *leaves, a["k"], SLOPE)
    else:
        out, stats = kfe.fused_edge2_conv(leaves[0], leaves[1],
                                          _t(a["idx"]), *leaves[2:], SLOPE)
    grads = torch.autograd.grad((out * _t(a["co"])).sum(), leaves,
                                retain_graph=True)
    assert not any(s.requires_grad for s in stats)
    if knn:  # the graph carries no gradient: x's comes through q and off
        assert torch.autograd.grad(out.sum(), x, allow_unused=True)[0] \
            is None
    return out.detach(), stats, grads


@pytest.mark.parametrize("case", sorted(VJP_CASES))
def test_vjp_matches_jax(vjps, case):
    """``fused_edge2_conv`` (given idx) or ``fused_edge2_conv_knn`` (the
    plain versions of f1, stats2, out, p1 and p2 with ``_combine_p1``)
    against ``jax.vjp`` of the JAX function: the output and the four
    batch statistics within 1e-5, and dq, doff, dW2, dγ1, dβ1, dγ2, dβ2
    within 2e-4 of each gradient's largest element, on all but 1 % of the
    elements (``_mostly_close``)."""
    a, res = vjps[case]
    out, stats, grads = _port_vjp(a, case.startswith("knn"))
    jout, jstats, jgrads = res["jax"]
    _mostly_close(out.numpy(), jout)
    for s, js in zip(stats, jstats):
        _mostly_close(s.numpy(), js)
    for g, jg, what in zip(grads, jgrads, _LEAVES):
        scale = float(np.abs(np.asarray(jg)).max())
        assert scale > 0, what
        _mostly_close(g.numpy(), jg, rtol=2e-4, atol=2e-4 * scale)


@pytest.mark.parametrize("case", ["idx_n100", "idx_n100_c64"])
def test_vjp_matches_the_jnp_replica(vjps, case):
    """The same against JAX autodiff of ``_edge2_reference``, which
    normalizes as ``γ·(h − μ)·rsqrt(σ² + ε) + β`` instead of through the
    folded rows, so that some bf16 roundings of y1 and dh2 land one step
    apart: the output within 1e-4 on all but 1 % of the elements, the
    statistics within 1e-4, and each gradient within the bound that
    ``tests/test_fused_edge.py::test_edge2_vjp_matches_jax_ad_of_replica``
    holds the JAX kernels to (4e-2 relative and 4e-2 of its largest
    element)."""
    a, res = vjps[case]
    out, stats, grads = _port_vjp(a, False)
    rout, rstats, rgrads = res["reference"]
    _mostly_close(out.numpy(), rout, rtol=1e-4, atol=1e-4)
    for s, rs in zip(stats, rstats):
        np.testing.assert_allclose(s.numpy(), rs, rtol=1e-4, atol=1e-5)
    for g, rg, what in zip(grads, rgrads, _LEAVES):
        scale = max(float(np.abs(np.asarray(rg)).max()), 1e-4)
        np.testing.assert_allclose(g.numpy(), rg, rtol=0.04,
                                   atol=0.04 * scale, err_msg=what)


def test_moments_match_the_batch_statistics(vjps):
    """The forward's statistics are the moments of the first pass's and
    ``edge2_stats2``'s sums over all B·N·k edges (biased variance)."""
    a, _ = vjps["idx_n100"]
    q, off, idx, w2 = _port(a, "q", "off", "idx", "w2")
    g1, b1 = _port(a, "g1", "b1")
    h1, psum = kfe.edge_f1_plain(q.bfloat16(), off, idx)
    r = float(h1.shape[0] * h1.shape[1] * h1.shape[2])
    m1, v1 = _moments(psum, r)
    st1 = kfe._stack_stats(m1, v1, g1, b1)
    m2, v2 = _moments(kfe.edge2_stats2_plain(h1, st1, w2, SLOPE), r)
    stats = kfe.fused_edge2_conv(q, off, idx, w2, g1, b1, *_port(
        a, "g2", "b2"), SLOPE)[1]
    for got, want in zip(stats, (m1, v1, m2, v2)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_backward_splits_max_pool_ties_evenly():
    """A center whose k slots are equal gives each ``dout / k``, times the
    slope where z2 ≤ 0: ``ps2[0]`` (Σdz2) counts each center's gradient
    once, whatever k."""
    b, m, k = 1, 3, 4
    h1 = torch.ones((b, m, k, C1)).bfloat16()
    st1 = torch.stack([torch.ones(C1), torch.zeros(C1), torch.ones(C1),
                       torch.zeros(C1)])
    w2 = torch.full((C1, C2), 1 / C1)
    w2[:, ::2] *= -1.0  # even channels: z2 < 0
    st2 = torch.stack([torch.ones(C2), torch.zeros(C2), torch.ones(C2),
                       torch.zeros(C2)])
    dout = torch.ones((b, m, C2))
    ps2, _, _ = kfe.edge2_p1_plain(h1, dout, st1, st2, w2, SLOPE)
    want = torch.where(torch.arange(C2) % 2 == 0, SLOPE, 1.0) * m
    torch.testing.assert_close(ps2[0], want)
    idx = torch.zeros((b, m, k), dtype=torch.int32)
    zero = torch.zeros((2, C2)), torch.zeros((2, C1))
    dq, doff = kfe.edge2_p2_plain(h1, dout, idx, st1, st2, w2, *zero, SLOPE,
                                  m)
    torch.testing.assert_close(dq[0, 0], -doff.sum((0, 1)))
    assert (dq[0, 1:] == 0).all()


def test_wrappers_take_the_plain_version_on_the_cpu():
    """A CPU tensor goes to the plain version and counts no launch; no
    kernel is built."""
    a = _kernel_inputs("k8")
    counted = (kfe.edge2_stats2, kfe.edge2_out, kfe.edge2_p1, kfe.edge2_p2,
               kfe.edge2_eval, kfe.edge2_knn_eval)
    before = [fn.launches for fn in counted]
    h1, dout, idx, st1, st2, w2, us2, us1, x, q, off = _port(
        a, "h1", "dout", "idx", "st1", "st2", "w2", "us2", "us1", "x", "q",
        "off")
    h1, q = h1.bfloat16(), q.bfloat16()
    pairs = (
        (kfe.edge2_stats2(h1, st1, w2), kfe.edge2_stats2_plain(h1, st1, w2)),
        (kfe.edge2_out(h1, st1, st2, w2),
         kfe.edge2_out_plain(h1, st1, st2, w2)),
        (kfe.edge2_eval(q, off, idx, st1, st2, w2),
         kfe.edge2_eval_plain(q, off, idx, st1, st2, w2)),
        (kfe.edge2_knn_eval(x, q, off, st1, st2, w2, 8),
         kfe.edge2_knn_eval_plain(x, q, off, st1, st2, w2, 8)),
        (kfe.edge2_p1(h1, dout, st1, st2, w2)[2],
         kfe.edge2_p1_plain(h1, dout, st1, st2, w2)[2]),
        (kfe.edge2_p2(h1, dout, idx, st1, st2, w2, us2, us1, SLOPE, 128)[0],
         kfe.edge2_p2_plain(h1, dout, idx, st1, st2, w2, us2, us1, SLOPE,
                            128)[0]))
    for got, want in pairs:
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert before == [fn.launches for fn in counted]


def test_tail_instances_fit_their_blocks_an_sm():
    """The forward tails' shared memory, as ``edge2_tail_smem`` mirrors
    ``csrc/edge2_tail.cu``'s layout, fits the blocks an SM the kernel is
    built for: each block within one block's 227 KB, and the blocks
    together, each with the 1 KB the card reserves, within the SM's 228
    KB."""
    for c1, c2 in kfe.EDGE2_WIDTHS:
        smem = kfe.edge2_tail_smem(c1, c2)
        assert smem <= 227 * 1024, (c1, c2, smem)
        assert kfe.TAIL2_BLOCKS * (smem + 1024) <= 228 * 1024, (c1, c2, smem)
    assert kfe.edge2_tail_smem(64, 64) == 54784


@pytest.mark.parametrize("k", [1, 8, 20, 40])
def test_eval_instances_fit_their_blocks_an_sm(k):
    """``edge2_eval``'s shared memory, as ``edge2_eval_smem`` mirrors
    ``csrc/edge2_eval.cu``'s layout (the lists of a block's centers, W2,
    two y1 tiles), fits the blocks an SM the kernel is built for at every
    list length the kNN gives (k ≤ 40), as the tails' do."""
    for c1, c2 in kfe.EDGE2_WIDTHS:
        smem = kfe.edge2_eval_smem(c1, c2, k)
        assert smem <= 227 * 1024, (c1, c2, k, smem)
        assert kfe.EVAL2_BLOCKS * (smem + 1024) <= 228 * 1024, (c1, c2, k)
    assert kfe.edge2_eval_smem(64, 64, 40) == 34816
    assert kfe.edge2_eval_smem(64, 64, 1) == 256 + 8192 + 16384
