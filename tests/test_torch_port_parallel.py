"""The port's data parallelism (``pointcloudlib_tpu_torch/parallel``) on
the CPU: two gloo ranks, spawned once for the module, run every case on
their halves of each batch, and each case is held against one process on
the whole batch, and the fused functions also against the JAX functions
under ``shard_map`` on a 2-device mesh.

Cases: ``BatchNorm`` (forward, backward, running statistics),
KPConv's ``MaskedBatchNorm`` with uneven masks, the plain
``fused_sa_train`` and both EdgeConv functions (outputs, statistics, dq,
doff and every parameter gradient), SSG (at a test's widths) and DGCNN
classification steps, DGCNN and PointNet part-segmentation steps with
uneven ``valid`` masks and a rigid KPConv step (loss, accuracy, every
reduced gradient, the updated parameters and BN statistics).

Tolerances. Outputs, statistics, losses and updated parameters: rtol
1e-5, atol 1e-6, as ``tests/test_fused_sa_dp.py`` holds them; the two
sides sum the same rows in another order (a rank's partial sums, then
the all-reduce), so they differ by roundings only. Gradients: that
file's bound, 2e-4 of each gradient's largest element
(``tests/test_fused_sa_dp.py:83-86``): the fused layers round y1 and y2
to bf16, and a last-bit change of a statistic can move one such rounding
(2^-8 relative). The steps of the models with those layers are held to
one process's own spread over orders of its clouds, a bound that planted
faults must fail (``test_rounding_train_step_within_its_own_spread``).
Against JAX, the single-device parity tests' bounds
(``tests/test_torch_port_train_ops.py:261-267`` for the set abstraction,
``tests/test_torch_port_dgcnn_seg_ops.py:403-419`` for the two-layer
EdgeConv).

The worker below runs in spawned processes, which import this module:
JAX is imported inside the tests that need it, never at the top."""

import numpy as np
import pytest
import torch

import pointcloudlib_tpu_torch.train.trainer as trainer
from pointcloudlib_tpu_torch.models import get_cls_model, get_seg_model
from pointcloudlib_tpu_torch.models.kpconv.model import (
    KPCNN,
    KPConvConfig,
    MaskedBatchNorm,
)
from pointcloudlib_tpu_torch.nn.layers import BatchNorm, SetAbstraction
from pointcloudlib_tpu_torch.ops.kernels import fused_edge as kfe
from pointcloudlib_tpu_torch.ops.kernels import fused_sa_train as kft
from pointcloudlib_tpu_torch.ops.kernels.fused_sa import SAParams
from pointcloudlib_tpu_torch.parallel import (
    rank_seed,
    shard_batch,
    start_ranks,
    sync_batchnorm,
)
from pointcloudlib_tpu_torch.train import (
    make_cls_eval_step,
    make_cls_train_step,
    make_seg_eval_step,
    make_seg_train_step,
    sgd_momentum,
)

WORLD = 2
LR = 0.05
# the fused functions' shapes (B split over the ranks)
B, N, M, K = 4, 32, 8, 16
C1, C2, C3 = 16, 16, 32
EK = 8             # EdgeConv neighbours
F1, F2 = 16, 32    # two-layer EdgeConv widths
SLOPE = 0.2


def _inputs():
    """Every case's inputs, from one seed, as numpy arrays."""
    rng = np.random.default_rng(0)

    def n(*shape, s=1.0, loc=0.0):
        return (loc + s * rng.standard_normal(shape)).astype(np.float32)

    a = {
        "bn_x": n(16, 8, loc=0.5), "bn_co": n(16, 8),
        "bn_w": n(8, s=0.1, loc=1.0), "bn_b": n(8, s=0.1),
        "mbn_x": n(4, 10, 8, loc=-0.3), "mbn_co": n(4, 10, 8),
        "mbn_w": n(8, s=0.1, loc=1.0), "mbn_b": n(8, s=0.1),
        "sa_q": n(B, N, C1), "sa_off": n(B, M, C1, s=0.1),
        "sa_idx": rng.integers(0, N, (B, M, K)).astype(np.int32),
        "sa_params": [n(C1, C2, s=0.3), n(C2, C3, s=0.3),
                      n(C1, s=0.1, loc=1), n(C1, s=0.1),
                      n(C2, s=0.1, loc=1), n(C2, s=0.1),
                      n(C3, s=0.1, loc=1), n(C3, s=0.1)],
        "sa_co": n(B, M, C3),
        "e_q": n(B, N, F1), "e_off": n(B, N, F1, s=0.1),
        "e_idx": rng.integers(0, N, (B, N, EK)).astype(np.int32),
        "e_g1": n(F1, s=0.1, loc=1), "e_b1": n(F1, s=0.1),
        "e_g2": n(F2, s=0.1, loc=1), "e_b2": n(F2, s=0.1),
        "e_w2": n(F1, F2, s=0.3),
        "e_co1": n(B, N, F1), "e_co2": n(B, N, F2),
    }
    # masks: rank 0's rows mostly valid, rank 1's few
    mask = np.zeros((4, 10), bool)
    mask[0, :9] = mask[1, :7] = mask[2, :3] = mask[3, :1] = True
    a["mbn_mask"] = mask
    # 8 clouds: on 4, the heads' BatchNorms (one row a cloud) leave the
    # gradients ill-conditioned (tools/grad_check.py)
    cl = rng.standard_normal((8, 128, 3)).astype(np.float32)
    cl /= np.linalg.norm(cl, axis=-1, keepdims=True)
    a["cls_batch"] = {"xyz": cl, "feats": cl.copy(),
                      "label": np.array([3, 7, 1, 7, 0, 5, 5, 2], np.int32)}
    cl = cl[:4]
    a["seg_batch"] = {
        "xyz": cl, "cls_onehot": np.eye(16, dtype=np.float32)[[0, 4, 4, 9]],
        "seg": rng.integers(0, 50, (4, 128)).astype(np.int64),
        "valid": np.array([True, True, True, False])}
    kc = rng.uniform(-1, 1, (2, 256, 3)).astype(np.float32)
    a["kp_batch"] = {"xyz": kc, "label": np.array([1, 2], np.int32)}
    return a


def _part(x, group):
    """This rank's rows of a whole-batch array (all of it without a
    group)."""
    if group is None:
        return x
    per = x.shape[0] // group.world
    return x[group.rank * per:(group.rank + 1) * per]


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def _np(t):
    return t.detach().numpy().copy()


def _bn_case(a, group):
    bn = BatchNorm(8)
    with torch.no_grad():
        bn.weight.copy_(_t(a["bn_w"]))
        bn.bias.copy_(_t(a["bn_b"]))
    bn.group = group
    x = _t(_part(a["bn_x"], group), grad=True)
    out = bn.train()(x)
    (out * _t(_part(a["bn_co"], group))).sum().backward()
    return {"out": _np(out), "dx": _np(x.grad), "dw": _np(bn.weight.grad),
            "db": _np(bn.bias.grad), "mean": _np(bn.running_mean),
            "var": _np(bn.running_var)}


def _mbn_case(a, group):
    bn = MaskedBatchNorm(8)
    with torch.no_grad():
        bn.weight.copy_(_t(a["mbn_w"]))
        bn.bias.copy_(_t(a["mbn_b"]))
    bn.group = group
    x = _t(_part(a["mbn_x"], group), grad=True)
    out = bn.train()(x, _t(_part(a["mbn_mask"], group)))
    (out * _t(_part(a["mbn_co"], group))).sum().backward()
    return {"out": _np(out), "dx": _np(x.grad), "dw": _np(bn.weight.grad),
            "db": _np(bn.bias.grad), "mean": _np(bn.running_mean),
            "var": _np(bn.running_var)}


def _sa_case(a, group):
    q = _t(_part(a["sa_q"], group), grad=True)
    off = _t(_part(a["sa_off"], group), grad=True)
    params = SAParams(*[_t(p, grad=True) for p in a["sa_params"]])
    out, stats = kft.fused_sa_train(q, off, _t(_part(a["sa_idx"], group)),
                                    params, group=group)
    (out * _t(_part(a["sa_co"], group))).sum().backward()
    return {"out": _np(out), "stats": [_np(s) for s in stats],
            "dq": _np(q.grad), "doff": _np(off.grad),
            "dparams": [_np(p.grad) for p in params]}


def _edge_case(a, group):
    q = _t(_part(a["e_q"], group), grad=True)
    off = _t(_part(a["e_off"], group), grad=True)
    g, bb = _t(a["e_g1"], grad=True), _t(a["e_b1"], grad=True)
    out, stats = kfe.fused_edge_conv(q, off, _t(_part(a["e_idx"], group)),
                                     g, bb, SLOPE, group=group)
    (out * _t(_part(a["e_co1"], group))).sum().backward()
    return {"out": _np(out), "stats": [_np(s) for s in stats],
            "dq": _np(q.grad), "doff": _np(off.grad),
            "dparams": [_np(g.grad), _np(bb.grad)]}


def _edge2_case(a, group):
    q = _t(_part(a["e_q"], group), grad=True)
    off = _t(_part(a["e_off"], group), grad=True)
    params = [_t(a[k], grad=True)
              for k in ("e_w2", "e_g1", "e_b1", "e_g2", "e_b2")]
    out, stats = kfe.fused_edge2_conv(q, off, _t(_part(a["e_idx"], group)),
                                      *params, SLOPE, group=group)
    (out * _t(_part(a["e_co2"], group))).sum().backward()
    return {"out": _np(out), "stats": [_np(s) for s in stats],
            "dq": _np(q.grad), "doff": _np(off.grad),
            "dparams": [_np(p.grad) for p in params]}


class _KP(torch.nn.Module):
    """A short rigid KPCNN behind the classification interface."""

    def __init__(self):
        super().__init__()
        self.kpcnn = KPCNN(KPConvConfig(
            num_classes=4, first_subsampling_dl=0.08, first_features_dim=16,
            architecture=("simple", "resnetb", "resnetb_strided", "resnetb",
                          "global_average"),
            neighborhood_limits=(16, 24)))

    @property
    def aux(self):
        return self.kpcnn.aux

    def forward(self, xyz, feats=None, generator=None):
        return self.kpcnn(xyz)


def _model(name):
    torch.manual_seed(0)
    if name == "ssg":
        # SSG's class, forward and head at a test's widths and centers:
        # SA1 takes the ball-query kernels (N=128), SA2 those given idx
        m = get_cls_model("pointnet2", n_classes=8, dropout=0.0)
        m.sa1 = SetAbstraction(3, [16, 16, 32], n_points=64, radius=0.3,
                               n_samples=16)
        m.sa2 = SetAbstraction(32, [32, 32, 64], n_points=16, radius=0.6,
                               n_samples=16)
        m.sa3 = SetAbstraction(64, [64, 128, 1024])
        return m
    if name == "dgcnn":
        return get_cls_model("dgcnn", n_classes=8, dropout=0.0)
    if name == "dgcnn_seg":
        return get_seg_model("dgcnn", dropout=0.0)
    if name == "pointnet_seg":
        return get_seg_model("pointnet")
    return _KP()


# the models with bf16-rounding fused layers (module docstring)
ROUNDING_STEPS = ("ssg", "dgcnn", "dgcnn_seg")
EXACT_STEPS = ("pointnet_seg", "kp")
# the clouds' orders of the spread runs: the same math, the batch
# statistics summed in other orders
ORDERS = {"seg": ([1, 0, 3, 2], [3, 2, 1, 0], [2, 3, 0, 1]),
          "cls": ([1, 0, 3, 2, 5, 4, 7, 6], [7, 6, 5, 4, 3, 2, 1, 0],
                  [4, 5, 6, 7, 0, 1, 2, 3])}
# faults planted in the ranks' steps, which the rounding steps' bound
# must reject: BatchNorm on each rank's own rows, and the gradients
# averaged where they should be summed or summed where averaged
FAULTS = ("local_bn", "grad_scale")


def _step_case(a, group, name, order=None, fault=None):
    """One SGD step; the batch is the global one (a group's step keeps
    its rows). ``order`` permutes the batch's clouds, and the eval
    step's predictions are put back in the caller's order. ``fault``
    plants one of :data:`FAULTS` and skips the eval step."""
    model = _model(name)
    opt = sgd_momentum(model.parameters(), LR, momentum=0.0)
    seg = name.endswith("_seg")
    factory = make_seg_train_step if seg else make_cls_train_step
    batch = a["seg_batch" if seg else "kp_batch" if name == "kp" else
              "cls_batch"]
    if order is not None:
        batch = {k: v[order] for k, v in batch.items()}
    step = factory(model, opt, device="cpu", group=group)
    reduce = trainer.reduce_gradients
    if fault == "local_bn":
        sync_batchnorm(model, None)
    elif fault == "grad_scale":
        trainer.reduce_gradients = (
            lambda params, g, average: reduce(params, g, not average))
    try:
        met = step(batch)
    finally:
        trainer.reduce_gradients = reduce
    out = {"metrics": {k: _np(v) for k, v in met.items()},
           "grads": {k: _np(p.grad) for k, p in model.named_parameters()
                     if p.grad is not None},
           "state": {k: _np(v) for k, v in model.state_dict().items()}}
    if fault is not None:
        return out
    evaluate = (make_seg_eval_step if seg else make_cls_eval_step)(
        model, device="cpu", group=group)(batch)
    if seg and order is not None:
        evaluate = evaluate[np.argsort(order)]
    out["eval"] = [_np(torch.as_tensor(v)) for v in
                   (evaluate if isinstance(evaluate, tuple)
                    else (evaluate,))]
    return out


def _run_cases(group):
    a = _inputs()
    out = {"bn": _bn_case(a, group), "mbn": _mbn_case(a, group),
           "sa": _sa_case(a, group), "edge": _edge_case(a, group),
           "edge2": _edge2_case(a, group)}
    for name in ROUNDING_STEPS + EXACT_STEPS:
        out[name] = _step_case(a, group, name)
    if group is None:
        out["spread"] = {
            name: [_step_case(a, None, name, order) for order in
                   ORDERS["seg" if name.endswith("_seg") else "cls"]]
            for name in ROUNDING_STEPS}
    else:
        out["faults"] = {(name, fault): _step_case(a, group, name,
                                                   fault=fault)
                         for name in ROUNDING_STEPS for fault in FAULTS}
        out["rows"] = {k: _np(v) for k, v in shard_batch(
            group, a["cls_batch"]).items()}
    return out


@pytest.fixture(scope="module")
def runs():
    """``(ranks, whole)``: every case on each of two gloo ranks (spawned
    processes, ``parallel.start_ranks``) and in this process on the
    whole batch, meanwhile."""
    ranks = start_ranks(_run_cases, WORLD, device="cpu", threads=1)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        whole = _run_cases(None)
    finally:
        torch.set_num_threads(threads)
    return ranks.results(), whole


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def _out_close(got, want):
    """A fused layer's output: rtol 1e-5, atol 1e-6 on all but 1 % of the
    elements, the rest within 2^-7 of ``max|want|`` (a bf16 rounding of
    y1 or y2 moved by a last-bit change of a statistic)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bad = ~np.isclose(got, want, rtol=1e-5, atol=1e-6)
    assert bad.mean() <= 1e-2, bad.mean()
    if bad.any():
        assert np.abs(got - want)[bad].max() <= 2 ** -7 * np.abs(want).max()


def _grad_close(got, want):
    """``tests/test_fused_sa_dp.py``'s gradient bound."""
    scale = max(float(np.abs(want).max()), 1e-4)
    _close(got, want, rtol=2e-4, atol=2e-4 * scale)


def _rows(ranks, case, key):
    return np.concatenate([r[case][key] for r in ranks])


@pytest.mark.parametrize("case", ["bn", "mbn"])
def test_batchnorm_syncs(runs, case):
    """The normalized rows, dx, the summed weight and bias gradients and
    the running statistics of every rank equal one process's."""
    ranks, whole = runs
    w = whole[case]
    _close(_rows(ranks, case, "out"), w["out"])
    _grad_close(_rows(ranks, case, "dx"), w["dx"])
    for k in ("dw", "db"):
        _grad_close(sum(r[case][k] for r in ranks), w[k])
    for r in ranks:
        _close(r[case]["mean"], w["mean"])
        _close(r[case]["var"], w["var"])


@pytest.mark.parametrize("case", ["sa", "edge", "edge2"])
def test_fused_functions_sync(runs, case):
    """Outputs and dq, doff by rows; every rank's statistics the global
    ones; the ranks' parameter gradients (partials) sum to one
    process's."""
    ranks, whole = runs
    w = whole[case]
    _out_close(_rows(ranks, case, "out"), w["out"])
    for r in ranks:
        for s, ws in zip(r[case]["stats"], w["stats"]):
            _close(s, ws)
    _grad_close(_rows(ranks, case, "dq"), w["dq"])
    _grad_close(_rows(ranks, case, "doff"), w["doff"])
    for i, wg in enumerate(w["dparams"]):
        _grad_close(sum(r[case]["dparams"][i] for r in ranks), wg)


def _step_vectors(run, skip):
    """A step case's metrics, reduced gradients (but those named in
    ``skip``) and stepped floating-point state, each as one vector."""
    def flat(d, drop=()):
        return np.concatenate([np.ravel(v).astype(np.float64)
                               for k, v in sorted(d.items())
                               if k not in drop
                               and np.issubdtype(v.dtype, np.floating)])
    return {"metrics": flat(run["metrics"]),
            "grads": flat(run["grads"], skip),
            "state": flat(run["state"])}


@pytest.mark.parametrize("case", EXACT_STEPS)
def test_train_step_matches_one_process(runs, case):
    """The steps whose layers all run in float32 (PointNet part
    segmentation with uneven ``valid``, rank 1 holding one valid cloud
    and rank 0 two; the rigid KPConv): loss and accuracy (the
    segmentation step's over the global valid points), the reduced
    gradients and the stepped parameters and BN statistics of every rank
    equal one process's on the whole batch; the eval step's counts (or
    gathered predictions) too."""
    ranks, whole = runs
    w = whole[case]
    for r in ranks:
        for k, v in w["metrics"].items():
            _close(r[case]["metrics"][k], v)
        assert r[case]["grads"].keys() == w["grads"].keys()
        for k, g in w["grads"].items():
            _grad_close(r[case]["grads"][k], g)
        for k, v in w["state"].items():
            _close(r[case]["state"][k], v)
        for got, want in zip(r[case]["eval"], w["eval"]):
            np.testing.assert_array_equal(got, want)


def _spread_bounds(whole, case, skip):
    """``(want, bound)``: one process's step vectors of ``case`` and, for
    each, 2× the largest deviation of the same step over the clouds'
    orders of :data:`ORDERS`, plus 1e-5 of its norm."""
    want = _step_vectors(whole[case], skip)
    spreads = [_step_vectors(s, skip) for s in whole["spread"][case]]
    return want, {kind: 2 * max(np.linalg.norm(s[kind] - w)
                                for s in spreads) + 1e-5 * np.linalg.norm(w)
                  for kind, w in want.items()}


def _deviations(run, want, skip):
    got = _step_vectors(run, skip)
    return {kind: np.linalg.norm(got[kind] - w) for kind, w in want.items()}


@pytest.mark.parametrize("case", ROUNDING_STEPS)
def test_rounding_train_step_within_its_own_spread(runs, case):
    """SSG and DGCNN classification and DGCNN part segmentation (uneven
    ``valid``), whose fused layers round activations to bf16 (y1, y2,
    the next layer's q) and split max-pool gradients among ties: a
    last-bit change of a batch statistic moves some of those roundings,
    and one process on the whole batch already moves by up to 13 % of a
    gradient's norm (DGCNN part segmentation; SSG 3 %, DGCNN 0.3 %) when
    only its clouds' order changes (the same sums in another order). So
    the ranks' deviation from one process is held, as one vector each of
    the metrics, the reduced gradients and the stepped parameters and BN
    statistics, to 2× the largest such deviation over three orders plus
    1e-5 of its norm; ``test_rounding_bound_rejects_planted_faults``
    shows that this bound rejects a wrong step. The gradients that the
    layers make 0 in exact arithmetic
    (``tools/grad_check.cancelled_by_structure``) are pure rounding and
    left out. The eval step's predictions differ in no larger a share
    than 2× the largest share of the order runs'."""
    from pointcloudlib_tpu_torch.tools.grad_check import (
        cancelled_by_structure,
    )

    ranks, whole = runs
    skip = cancelled_by_structure(_model(case))
    want, bound = _spread_bounds(whole, case, skip)
    for r in ranks:
        for kind, dev in _deviations(r[case], want, skip).items():
            assert dev <= bound[kind], (kind, dev, bound[kind])
        for i, w in enumerate(whole[case]["eval"]):
            share = max((s["eval"][i] != w).mean()
                        for s in whole["spread"][case])
            assert (r[case]["eval"][i] != w).mean() <= 2 * share, "eval"


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("case", ROUNDING_STEPS)
def test_rounding_bound_rejects_planted_faults(runs, case, fault):
    """The bound of ``test_rounding_train_step_within_its_own_spread``
    tells a wrong data-parallel step from a right one: each rank's step
    with a planted fault, BatchNorm statistics over its own rows only
    (``local_bn``) or the gradients averaged where the step sums them
    and summed where it averages them (``grad_scale``), leaves it in the
    metrics, the gradients or the stepped state."""
    from pointcloudlib_tpu_torch.tools.grad_check import (
        cancelled_by_structure,
    )

    ranks, whole = runs
    skip = cancelled_by_structure(_model(case))
    want, bound = _spread_bounds(whole, case, skip)
    for r in ranks:
        devs = _deviations(r["faults"][(case, fault)], want, skip)
        assert any(devs[k] > bound[k] for k in devs), (devs, bound)


def test_shard_batch_keeps_each_ranks_rows(runs):
    ranks, _ = runs
    a = _inputs()["cls_batch"]
    for k, v in a.items():
        np.testing.assert_array_equal(
            np.concatenate([r["rows"][k] for r in ranks]), v)


def test_rank_seed_keeps_rank_0():
    assert rank_seed(7, 0) == 7
    assert len({rank_seed(7, r) for r in range(8)}) == 8


def _tie_robust(got, want, what):
    """``tests/test_torch_port_train_ops.py``'s bound: fewer than 0.5 %
    of the elements beyond 1e-2 + 1e-2·|want| of ``max|want|``, the
    mean deviation below 3e-3 of it (a flipped max-pool tie moves one
    gradient share to another slot)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-12)
    d = np.abs(got - want) / scale
    tol = 1e-2 + 1e-2 * np.abs(want) / scale
    assert (d > tol).mean() < 5e-3, (what, (d > tol).mean())
    assert d.mean() < 3e-3, (what, d.mean())


def _mostly_close(a, b, rtol=1e-5, atol=1e-5, frac=1e-2, max_abs=0.05):
    """``tests/test_torch_port_dgcnn_seg_ops.py``'s bound: within
    ``rtol``/``atol`` on all but ``frac`` of the elements, the rest
    within ``max_abs``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    bad = ~np.isclose(a, b, rtol=rtol, atol=atol)
    assert bad.mean() <= frac, (bad.mean(), frac)
    if bad.any():
        assert np.abs(a - b)[bad].max() <= max_abs


def _jax_sharded(fn, n_in):
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    mesh = jax.make_mesh((WORLD,), ("data",),
                         devices=jax.devices()[:WORLD])
    return shard_map(fn, mesh=mesh,
                     in_specs=(*[P("data")] * n_in, P()),
                     out_specs=(P("data"), P()), check_vma=False)


def test_fused_sa_matches_jax_shard_map(runs):
    """The 2-rank port ``fused_sa_train`` against the JAX function under
    ``shard_map`` (interpret mode, ``axis_name``, ``world=2``) on a
    2-device sub-mesh, at the bounds of
    ``test_function_matches_jax_fused_sa_bq_train``."""
    import jax
    import jax.numpy as jnp
    from pointcloudlib_tpu.ops.pallas import fused_sa as jfs

    ranks, _ = runs
    a = _inputs()
    fn = _jax_sharded(
        lambda q, off, idx, p: jfs.fused_sa_train(q, off, idx, p, True,
                                                  "data", WORLD), 3)
    idx = jnp.asarray(a["sa_idx"])
    co = jnp.asarray(a["sa_co"])

    def loss(q, off, params):
        out, stats = fn(q, off, idx, jfs.SAParams(*params))
        return jnp.sum(out * co), (out, stats)

    (_, (jout, jstats)), jg = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(a["sa_q"]), jnp.asarray(a["sa_off"]),
        tuple(map(jnp.asarray, a["sa_params"])))
    np.testing.assert_allclose(_rows(ranks, "sa", "out"), np.asarray(jout),
                               rtol=5e-3, atol=5e-3)
    for s, js in zip(ranks[0]["sa"]["stats"], jstats):
        np.testing.assert_allclose(s, np.asarray(js), rtol=1e-3, atol=1e-5)
    jq, joff, jp = jg
    _tie_robust(_rows(ranks, "sa", "dq"), jq, "dq")
    _tie_robust(_rows(ranks, "sa", "doff"), joff, "doff")
    for i, name in enumerate(SAParams._fields):
        _tie_robust(sum(r["sa"]["dparams"][i] for r in ranks), jp[i], name)


def test_fused_edge2_matches_jax_shard_map(runs):
    """The 2-rank two-layer EdgeConv against ``fused_edge2_conv`` under
    ``shard_map`` on a 2-device sub-mesh, at the bounds of
    ``test_torch_port_dgcnn_seg_ops.py::test_vjp_matches_jax``."""
    import jax
    import jax.numpy as jnp
    from pointcloudlib_tpu.ops.pallas import fused_edge as jfe

    ranks, _ = runs
    a = _inputs()
    fn = _jax_sharded(
        lambda q, off, idx, p: jfe.fused_edge2_conv(
            q, off, idx, *p, SLOPE, True, "data", WORLD), 3)
    idx = jnp.asarray(a["e_idx"])
    co = jnp.asarray(a["e_co2"])
    names = ("e_w2", "e_g1", "e_b1", "e_g2", "e_b2")

    def loss(q, off, params):
        out, stats = fn(q, off, idx, params)
        return jnp.sum(out * co), (out, stats)

    (_, (jout, jstats)), jg = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(a["e_q"]), jnp.asarray(a["e_off"]),
        tuple(jnp.asarray(a[k]) for k in names))
    _mostly_close(_rows(ranks, "edge2", "out"), np.asarray(jout))
    for s, js in zip(ranks[0]["edge2"]["stats"], jstats):
        _mostly_close(s, np.asarray(js))
    jq, joff, jp = jg
    got = [_rows(ranks, "edge2", "dq"), _rows(ranks, "edge2", "doff"),
           *[sum(r["edge2"]["dparams"][i] for r in ranks)
             for i in range(len(names))]]
    for g, want in zip(got, [jq, joff, *jp]):
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        _mostly_close(g, want, rtol=2e-4, atol=2e-4 * scale)
