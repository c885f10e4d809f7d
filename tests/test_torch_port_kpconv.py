"""KPConv classification in the PyTorch port against the JAX package, on
the CPU: the kernel points, the ply format, the pyramid's pieces (voxel
keys, occupancy, subsampling, radius neighbours), each block, the block
stack and head on the JAX package's own pyramid, the whole KPCNN from
clouds, the train step, calibration, the weight bridge and
``grad_check.cancelled_by_structure``.

Small sizes: clouds of N=256 points (``SyntheticModelNet``, B=2; the
pyramid pieces add a masked cloud and an all-invalid one), a short
architecture of the JAX layer types (simple, resnetb, a strided resnetb,
resnetb — rigid, and with the last two deformable; the unary block type
in a third, forward only), ``first_features_dim`` 16, a grid of 0.08;
the KPConv operator alone with the other influences and aggregation,
and deformable without modulation. Weights come from ``random_jax_variables``. Each JAX
program is built once per module (``jax.jit``, module-scoped fixtures);
the port's CPU work runs on 2 threads.

Tolerances (both sides float32): the KPCNN's logits and every block's
output within 1e-4 of the largest element; gradients within 1e-3 of the
largest element of each; BN running statistics within 1e-5; the
deformable regulariser within 1e-5 relative; barycentres within 2^-20
(the JAX package adds a voxel's points in float32 in order, the port
rounds their exact sum once). Counts, masks and voxel keys are exact.

Radius neighbours: both sides form d² by the ``|q|² − 2q·p + |p|²``
expansion, the JAX package's cross term by a matrix product, the port's
channel by channel, so a support whose d² is within a rounding of r² or
of the k-th neighbour's can fall the other way. Lists are compared row
by row; a row may differ only where every support in one list and not
the other, or out of order, has a float64 d² within :data:`TIE` of r² or
of a neighbour it swapped with. A pool's query, a voxel's barycentre,
is often equidistant from its voxel's points, so pool rows differ in
the order of such pairs (the pyramid test states the share).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudlib_tpu.models.kpconv import calibrate as jax_cal
from pointcloudlib_tpu.models.kpconv import kernel_points as jax_kp
from pointcloudlib_tpu.models.kpconv import pyramid as jax_pyr
from pointcloudlib_tpu.models.kpconv.adapter import KPConvCls as JaxKPConvCls
from pointcloudlib_tpu.models.kpconv.adapter import (
    KPConvDeformCls as JaxKPConvDeformCls,
)
from pointcloudlib_tpu.models.kpconv.model import KPCNN as JaxKPCNN
from pointcloudlib_tpu.models.kpconv.model import KPConvOp as JaxKPConvOp
from pointcloudlib_tpu.models.kpconv.model import KPConvConfig as JaxConfig
from pointcloudlib_tpu.models.kpconv.model import (
    ResnetBottleneckBlock as JaxResnet,
)
from pointcloudlib_tpu.models.kpconv.model import SimpleBlock as JaxSimple
from pointcloudlib_tpu.models.kpconv.model import (
    sum_overflow,
    sum_reg_losses,
)
from pointcloudlib_tpu.train.losses import soft_cross_entropy as jax_sce
from pointcloudlib_tpu.utils import ply as jax_ply

from pointcloudlib_tpu_torch.data import SyntheticModelNet
from pointcloudlib_tpu_torch.models import get_cls_model
from pointcloudlib_tpu_torch.models.kpconv import calibrate as cal
from pointcloudlib_tpu_torch.models.kpconv import kernel_points as kp
from pointcloudlib_tpu_torch.models.kpconv import pyramid as pyr
from pointcloudlib_tpu_torch.models.kpconv.model import (
    KPCNN,
    KPConvConfig,
    KPConvOp,
    ResnetBottleneckBlock,
    SimpleBlock,
)
from pointcloudlib_tpu_torch.tools.grad_check import (
    FLOOR,
    cancelled_by_structure,
)
from pointcloudlib_tpu_torch.train import (
    make_cls_train_step,
    sgd_momentum,
    soft_cross_entropy,
)
from pointcloudlib_tpu_torch.utils import ply
from pointcloudlib_tpu_torch.utils.interop import (
    _entries,
    from_jax_variables,
    jax_variable_shapes,
    random_jax_variables,
    to_jax_variables,
)

B, N, DL = 2, 256, 0.08
TIE = 1e-5  # float64 d² from r² or a swapped neighbour's: a near tie
ARCHS = {
    "rigid": ("simple", "resnetb", "resnetb_strided", "resnetb",
              "global_average"),
    "deformable": ("simple", "resnetb", "resnetb_deformable_strided",
                   "resnetb_deformable", "global_average"),
    # the unary block type, forward only (a LeakyReLU kink can flip a
    # gradient element between two float32 runs)
    "unary": ("simple", "resnetb_strided", "unary", "global_average"),
}
LIMITS = (16, 24)
LR = 0.05


def _cfg_kw(arch):
    return dict(architecture=ARCHS[arch], first_subsampling_dl=DL,
                first_features_dim=16, neighborhood_limits=LIMITS)


_NETS = {}  # architecture -> _build_net's, for this module's tests


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The port's CPU work on 2 threads beside the other test workers;
    the JAX results are dropped after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
    _NETS.clear()


def _clouds(seed=3, n=N, b=B):
    xyz, _, labels = SyntheticModelNet(n_points=n, size=b, train=True,
                                       seed=seed).batch(0, b)
    return xyz.astype(np.float32), labels


def _masked_clouds():
    """Three clouds and masks: one whole, one with a third of its rows
    invalid (moved far off, so a mask that leaked would show), one all
    invalid."""
    xyz, _ = _clouds(seed=4, b=3)
    mask = np.ones((3, N), bool)
    mask[1, ::3] = False
    mask[2] = False
    xyz[1, ::3] = 50.0
    return xyz, mask


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to_torch(p):
    """A JAX ``Pyramid`` as the port's, of torch tensors."""
    def t(a):
        return torch.from_numpy(np.array(a))
    return pyr.Pyramid(*[[t(a) for a in field] for field in p[:6]],
                       None if p.overflow is None else t(p.overflow))


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, (*prefix, k)))
        else:
            out[(*prefix, k)] = np.asarray(v)
    return out


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"{what}: {err} of the largest element > {tol}"


# ------------------------------------------------------------ kernel points


def test_kernel_points_bit_identical(tmp_path, monkeypatch):
    """The disposition and the scaled, rotated, noised kernel points are
    bit-identical to the JAX generator's, each side with its cache
    redirected to a directory of its own; the port's cached ply reads
    back to the same points, and the JAX reader reads it."""
    monkeypatch.setattr(jax_kp, "_CACHE_DIR", tmp_path / "jax")
    monkeypatch.setattr(kp, "_CACHE_DIR", tmp_path / "port")
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = jax_kp.kernel_dispositions(15)
    got = kp.kernel_dispositions(15)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    cached = tmp_path / "port" / "k_015_center_3D.ply"
    assert cached.exists()
    assert np.array_equal(kp.kernel_dispositions(15), want)
    d = jax_ply.read_ply(cached)
    assert np.array_equal(np.stack([d["x"], d["y"], d["z"]], 1), want)
    for radius, seed in ((0.2, 0), (0.4, 0), (0.8, 3)):
        assert np.array_equal(
            kp.load_kernels.__wrapped__(radius, 15, seed=seed),
            jax_kp.load_kernels.__wrapped__(radius, 15, seed=seed))


@pytest.mark.parametrize("binary", [True, False])
def test_ply_round_trip_across_packages(tmp_path, binary):
    """The port's ply writer and reader against the JAX package's:
    float32, float64, int32 and uint8 columns, xyz and normals split into
    their named columns, each side reading the other's file."""
    rng = np.random.default_rng(0)
    fields = {"xyz": rng.standard_normal((7, 3)).astype(np.float32),
              "normals": rng.standard_normal((7, 3)),
              "label": rng.integers(0, 9, 7).astype(np.int32),
              "flag": rng.integers(0, 2, 7).astype(np.uint8)}
    ply.write_ply(tmp_path / "a.ply", fields, binary=binary)
    jax_ply.write_ply(tmp_path / "b.ply", fields, binary=binary)
    assert (tmp_path / "a.ply").read_bytes() == \
        (tmp_path / "b.ply").read_bytes()
    for reader in (ply.read_ply, jax_ply.read_ply):
        got = reader(tmp_path / "a.ply")
        want = jax_ply.read_ply(tmp_path / "b.ply")
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------- pyramid pieces


@pytest.fixture(scope="module")
def masked():
    return _masked_clouds()


@pytest.mark.parametrize("dl", [DL, 0.25])
def test_voxel_keys_and_occupancy_exact(masked, dl):
    xyz, mask = masked
    want = np.asarray(jax.vmap(lambda x, m: jax_pyr._voxel_keys(x, m, dl))(
        xyz, mask))
    got = pyr.voxel_keys(torch.from_numpy(xyz), torch.from_numpy(mask), dl)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    occ = pyr.occupancy(torch.from_numpy(xyz), torch.from_numpy(mask), dl)
    np.testing.assert_array_equal(
        occ.numpy(), np.asarray(jax_pyr.occupancy(xyz, mask, dl)))
    assert int(occ[2]) == 0
    # the host count of calibration's buckets, on the whole cloud
    assert cal.occupancy_np(xyz[0], dl) == int(occ[0]) == \
        jax_cal.occupancy_np(xyz[0], dl)


@pytest.mark.parametrize("n_max", [48, 256])
def test_grid_subsample_matches_jax(masked, n_max):
    """Masks and the truncated-voxel counts exact, barycentres within
    2^-20 (absolute; the clouds lie in the unit ball); at 48 slots the
    first two clouds lose voxels and count them."""
    xyz, mask = masked
    want = _np(jax_pyr.grid_subsample_counted(xyz, mask, 0.1, n_max))
    got = pyr.grid_subsample_counted(torch.from_numpy(xyz),
                                     torch.from_numpy(mask), 0.1, n_max)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    assert np.abs(got[0].numpy() - want[0]).max() <= 2.0 ** -20
    assert not got[1][2].any() and int(got[2][2]) == 0
    if n_max == 48:
        assert (got[2][:2] > 0).all()


def _d2_64(q, s):
    return ((q[:, None, :].astype(np.float64)
             - s[None, :, :].astype(np.float64)) ** 2).sum(-1)


def _tie_rows(got_idx, got_mask, want_idx, want_mask, query, support,
              radius):
    """Rows of a batch's neighbour lists that differ, each checked to be
    a near tie (module docstring); returns their count."""
    differ = 0
    r2 = radius * radius
    for b in range(got_idx.shape[0]):
        d2 = _d2_64(query[b], support[b])
        for m in range(got_idx.shape[1]):
            g = got_idx[b, m][got_mask[b, m]]
            w = want_idx[b, m][want_mask[b, m]]
            if np.array_equal(g, w):
                continue
            differ += 1
            for j in set(g.tolist()) ^ set(w.tolist()):
                kth = max(d2[m, g].max(initial=0), d2[m, w].max(initial=0))
                assert min(abs(d2[m, j] - r2), abs(d2[m, j] - kth)) <= TIE, (
                    f"cloud {b} query {m}: support {j} is no near tie")
            common = [j for j in g if j in set(w.tolist())]
            order = [j for j in w if j in set(g.tolist())]
            for a, c in zip(common, order):
                assert a == c or abs(d2[m, a] - d2[m, c]) <= TIE
    return differ


@pytest.mark.parametrize("radius,k,n_support", [
    (0.2, 16, N), (0.45, 40, N), (0.3, 300, N), (0.5, 24, 40)])
def test_radius_neighbors_match_jax(masked, radius, k, n_support):
    """Masked supports, a cloud of no valid point, k above the support
    count (slots past N invalid, index 0 under the mask's sentinel N) and
    a small support layer: masks exact, lists row by row."""
    xyz, mask = masked
    q, qm = xyz[:, ::2], mask[:, ::2]
    s, sm = xyz[:, :n_support], mask[:, :n_support]
    want = _np(jax_pyr.radius_neighbors(q, qm, s, sm, radius, k))
    got = pyr.radius_neighbors(*map(torch.from_numpy, (q, qm, s, sm)),
                               radius, k)
    assert got[0].dtype == torch.int32 and got[0].shape == (3, N // 2, k)
    np.testing.assert_array_equal(got[1].numpy().sum(-1), want[1].sum(-1))
    assert not got[1][2].any()
    assert (got[0].numpy()[~got[1].numpy()] == n_support).all()
    assert _tie_rows(got[0].numpy(), got[1].numpy(), want[0], want[1], q, s,
                     radius) == 0


def test_neighbor_counts_match_jax(masked):
    xyz, mask = masked
    want = np.asarray(jax_pyr.neighbor_counts(xyz, mask, xyz, mask, 0.3))
    got = pyr.neighbor_counts(*map(torch.from_numpy, (xyz, mask, xyz, mask)),
                              0.3)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ the models


class _Cls(torch.nn.Module):
    """A KPCNN behind the registry's ``(xyz, feats, generator)`` call, for
    the train step."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    @property
    def aux(self):
        return self.net.aux

    def forward(self, xyz, feats=None, generator=None):
        return self.net(xyz)


def _jax_train_program(jm):
    def loss(params, stats, xyz, label):
        logits, mut = jm.apply({"params": params, "batch_stats": stats}, xyz,
                               training=True,
                               mutable=["batch_stats", "intermediates"])
        reg = sum_reg_losses(mut["intermediates"])
        total = jax_sce(logits, label) + reg
        return total, (logits, mut["batch_stats"], reg,
                       sum_overflow(mut["intermediates"]))

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def _net(arch):
    if arch not in _NETS:
        _NETS[arch] = _build_net(arch)
    return _NETS[arch]


@pytest.fixture(scope="module", params=["rigid", "deformable"])
def net(request):
    return _net(request.param)


def _build_net(arch):
    """The port's KPCNN and the JAX one with the same random weights, the
    JAX pyramid of the clouds, and one JAX program of each: the
    train-mode loss (label-smoothed CE plus the regulariser) with its
    gradients (for the ``unary`` architecture the train-mode logits
    alone), the eval logits."""
    port = KPCNN(KPConvConfig(**_cfg_kw(arch)))
    variables = random_jax_variables(port, seed=1)
    from_jax_variables(port, variables)
    jm = JaxKPCNN(JaxConfig(**_cfg_kw(arch)))
    xyz, labels = _clouds()
    c = jm.cfg
    jpyr = _np(jax.jit(lambda x: jax_pyr.build_pyramid(
        x, jnp.ones(x.shape[:2], bool), c.first_subsampling_dl,
        c.conv_radius, c.deform_radius, c.architecture,
        c.neighborhood_limits))(xyz))
    eval_logits = jax.jit(lambda v, x: jm.apply(v, x, training=False))(
        variables, xyz)
    if arch == "unary":
        logits = jax.jit(lambda v, x: jm.apply(
            v, x, training=True, mutable=["batch_stats"])[0])(variables, xyz)
        return dict(arch=arch, variables=variables, xyz=xyz,
                    logits=np.asarray(logits),
                    eval_logits=np.asarray(eval_logits))
    (loss, (logits, stats, reg, overflow)), grads = _jax_train_program(jm)(
        variables["params"], variables["batch_stats"], xyz, labels)
    return dict(arch=arch, port=port, variables=variables, xyz=xyz,
                labels=labels, jpyr=jpyr, loss=float(loss),
                logits=np.asarray(logits), stats=_np(stats),
                reg=float(reg), overflow=float(overflow), grads=_np(grads),
                eval_logits=np.asarray(eval_logits))


def _fresh(net):
    """The port's KPCNN with the fixture's weights, unused."""
    port = KPCNN(KPConvConfig(**_cfg_kw(net["arch"])))
    return from_jax_variables(port, net["variables"])


def _check_grads(port, grads):
    want = _flat(grads)
    for key, (t, transposed) in _entries(port).items():
        if key[0] != "params":
            continue
        g = t.grad.numpy()
        _close(g.T if transposed else g, want[key[1:]], 1e-3, "/".join(key))


def _check_stats(port, stats):
    want = _flat(stats)
    for key, (t, _) in _entries(port).items():
        if key[0] == "batch_stats":
            np.testing.assert_allclose(t.numpy(), want[key[1:]], rtol=0,
                                       atol=1e-5, err_msg="/".join(key))


def test_stack_on_jax_pyramid_matches_jax(net):
    """The blocks and head on the JAX package's own pyramid, in train
    mode: logits, the regulariser, every gradient and every BN running
    statistic against JAX."""
    port = _fresh(net)
    p = _to_torch(net["jpyr"])
    port.train()
    logits = port.forward_pyramid(p)
    reg = port.aux["reg_loss"]
    if net["arch"] == "rigid":
        assert reg is None and net["reg"] == 0.0
        reg = torch.zeros(())
    else:
        assert abs(reg.item() - net["reg"]) <= 1e-5 * abs(net["reg"])
        assert net["reg"] > 0
    _close(logits.detach(), net["logits"], 1e-4, "logits")
    loss = soft_cross_entropy(logits, torch.from_numpy(net["labels"])) + reg
    assert abs(loss.item() - net["loss"]) <= 1e-5 * abs(net["loss"])
    loss.backward()
    _check_grads(port, net["grads"])
    _check_stats(port, net["stats"])


def test_pyramid_from_clouds_matches_jax(net):
    """The port's pyramid of the clouds: masks and overflow exact, points
    within 2^-20, neighbour and pool lists row by row. Pools differ in
    rows where the query, a voxel's barycentre, is equidistant from two
    of its voxel's points in exact arithmetic: the two sides round the
    tie apart and list the pair in the other order (14 of 128 pool rows
    of these clouds; no self-neighbour row)."""
    c = net["port"].cfg
    got = _fresh(net).pyramid(torch.from_numpy(net["xyz"]))
    want = net["jpyr"]
    for g, w in zip(got.points, want.points):
        assert np.abs(g.numpy() - w).max() <= 2.0 ** -20
    for field in (1, 3, 5):
        for g, w in zip(got[field], want[field]):
            np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(got.overflow.numpy(), want.overflow)
    radius = c.first_subsampling_dl * c.conv_radius
    differ = []
    for field, layer, q in ((2, 0, 0), (2, 1, 1), (4, 0, 1)):
        r = radius * 2 ** layer
        if "deformable" in c.architecture[2 if field == 4 else 3]:
            r *= c.deform_radius / c.conv_radius
        differ.append(_tie_rows(
            got[field][layer].numpy(), got[field + 1][layer].numpy(),
            want[field][layer], want[field + 1][layer],
            got.points[q].numpy(), got.points[layer].numpy(), r))
    assert differ[:2] == [0, 0] and differ[2] <= 0.15 * got[4][0].shape[1] * B
    assert len(got.points) == 2 and c.caps is None


def test_kpcnn_from_clouds_matches_jax(net):
    """The whole KPCNN from clouds, its pyramid checked by the test
    above: eval logits, then the train-mode loss, gradients and
    statistics."""
    port = _fresh(net).eval()
    with torch.no_grad():
        logits = port(torch.from_numpy(net["xyz"]))
    _close(logits, net["eval_logits"], 1e-4, "eval logits")
    assert port.aux["voxel_overflow"].item() == net["overflow"]
    port.train()
    logits = port(torch.from_numpy(net["xyz"]))
    _close(logits.detach(), net["logits"], 1e-4, "train logits")
    loss = soft_cross_entropy(logits, torch.from_numpy(net["labels"]))
    if port.aux["reg_loss"] is not None:
        loss = loss + port.aux["reg_loss"]
    loss.backward()
    _check_grads(port, net["grads"])
    _check_stats(port, net["stats"])


def test_train_step_matches_jax(net):
    """``make_cls_train_step`` with SGD: its loss is the JAX loss (the
    regulariser included), ``voxel_overflow`` among its metrics, and the
    parameters after the step are the JAX ones less lr times the JAX
    gradients."""
    port = _fresh(net)
    model = _Cls(port)
    before = {k: t.detach().clone() for k, (t, _) in _entries(port).items()
              if k[0] == "params"}
    step = make_cls_train_step(model, sgd_momentum(model.parameters(), LR),
                               device="cpu")
    out = step({"xyz": net["xyz"], "label": net["labels"]})
    assert abs(out["loss"].item() - net["loss"]) <= 1e-5 * abs(net["loss"])
    assert out["voxel_overflow"].item() == net["overflow"]
    grads = _flat(net["grads"])
    for key, (t, transposed) in _entries(port).items():
        if key[0] != "params":
            continue
        g = grads[key[1:]]
        want = before[key].numpy() - LR * (g.T if transposed else g)
        moved = np.abs(want - before[key].numpy()).max()
        np.testing.assert_allclose(t.detach().numpy(), want, rtol=0,
                                   atol=1e-3 * moved + 1e-6,
                                   err_msg="/".join(key))


@pytest.mark.parametrize("arch,index", [
    ("rigid", 0), ("rigid", 1), ("rigid", 2), ("rigid", 3),
    ("deformable", 2), ("deformable", 3)])
def test_block_matches_jax(arch, index):
    """Each block on its own (the two architectures share their first
    two), on the JAX pyramid, in train mode, from a seeded input: its output, the gradients of its parameters and input
    (of Σ out·w, plus the regulariser for a deformable block), its BN
    statistics and the regulariser against the flax block."""
    net = _net(arch)
    port_net = _fresh(net)
    blk = port_net.blocks[index]
    layer = port_net.layers[index]
    cfg = JaxConfig(**_cfg_kw(net["arch"]))
    r = cfg.first_subsampling_dl * cfg.conv_radius * 2 ** layer
    extent = r * cfg.kp_extent / cfg.conv_radius
    kind = cfg.architecture[index]
    strided, deform = "strided" in kind, "deformable" in kind
    out_dim = cfg.first_features_dim * 2 ** layer
    if isinstance(blk, SimpleBlock):
        jb, name = JaxSimple(out_dim, r, extent, cfg, strided, deform), \
            "SimpleBlock_0"
        in_dim = cfg.in_features_dim
    else:
        assert isinstance(blk, ResnetBottleneckBlock)
        in_dim = (blk.unary1.dense.in_features if blk.unary1 is not None
                  else blk.conv.weights.shape[1])
        jb = JaxResnet(in_dim, out_dim, r, extent, cfg, strided, deform)
        name = f"ResnetBottleneckBlock_{index - 1}"
    v = {col: net["variables"][col][name] for col in ("params",
                                                      "batch_stats")}
    jp = net["jpyr"]
    rng = np.random.default_rng(index)
    x = rng.standard_normal((B, jp.points[layer].shape[1], in_dim)
                            ).astype(np.float32)
    m = jp.points[layer + 1 if strided else layer].shape[1]
    w = rng.standard_normal((B, m, blk.bn.bias.shape[0] if isinstance(
        blk, SimpleBlock) else out_dim)).astype(np.float32)

    def loss(params, x):
        out, mut = jb.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, x,
                            net["jpyr"], layer, True,
                            mutable=["batch_stats", "intermediates"])
        reg = sum_reg_losses(mut.get("intermediates", {}))
        return jnp.sum(out * w) + reg, (out, mut["batch_stats"], reg)

    (_, (jout, jstats, jreg)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(v["params"], x)

    port_net.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    out, reg = blk(xt, _to_torch(jp), layer)
    _close(out.detach(), jout, 1e-4, "block output")
    total = (out * torch.from_numpy(w)).sum()
    if deform:
        assert abs(reg.item() - float(jreg)) <= 1e-5 * abs(float(jreg))
        total = total + reg
    else:
        assert reg is None
    total.backward()
    _close(xt.grad, gx, 1e-3, "input gradient")
    prefix = f"blocks.{index}."
    named = dict(port_net.named_parameters())
    want = {("params", name, *k): g for k, g in _flat(_np(gp)).items()}
    stats = {("batch_stats", name, *k): s
             for k, s in _flat(_np(jstats)).items()}
    checked = 0
    for key, (t, transposed) in _entries(port_net).items():
        if key in want:
            g = t.grad.numpy()
            _close(g.T if transposed else g, want[key], 1e-3, "/".join(key))
            checked += 1
        elif key in stats:
            np.testing.assert_allclose(t.numpy(), stats[key], rtol=0,
                                       atol=1e-5, err_msg="/".join(key))
    assert checked == len(want) == sum(
        1 for k in named if k.startswith(prefix))


@pytest.mark.parametrize("influence,aggregation,deformable", [
    ("constant", "sum", False), ("gaussian", "sum", False),
    ("linear", "closest", False), ("gaussian", "closest", False),
    ("linear", "sum", True)])
def test_kpconv_op_options_match_jax(influence, aggregation, deformable):
    """The KPConv operator with the influences and aggregation the
    configuration offers besides linear / sum, and deformable without
    modulation (its regulariser too), on the JAX pyramid's layer 0,
    against the flax operator: outputs within 1e-4 of the largest."""
    jp = _net("rigid")["jpyr"]
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((B, jp.points[0].shape[1], 8)).astype(
        np.float32)
    args = (jp.points[0], jp.points[0], feats, jp.neighbors[0],
            jp.neighbor_masks[0])
    op = KPConvOp(8, 12, 0.2, 0.096, 15, influence, aggregation, deformable)
    variables = {"weights": rng.uniform(-0.3, 0.3, (15, 8, 12))}
    if deformable:
        variables["offset_conv"] = {
            "weights": rng.uniform(-0.3, 0.3, (15, 8, 45))}
        variables["offset_bias"] = rng.normal(0, 0.05, 45)
    variables = jax.tree_util.tree_map(lambda a: a.astype(np.float32),
                                       variables)
    with torch.no_grad():
        op.weights.copy_(torch.from_numpy(variables["weights"]))
        if deformable:
            op.offset_conv.weights.copy_(torch.from_numpy(
                variables["offset_conv"]["weights"]))
            op.offset_bias.copy_(torch.from_numpy(variables["offset_bias"]))
        out, reg = op(*[torch.from_numpy(np.array(a)) for a in args])
    jop = JaxKPConvOp(12, 0.2, 0.096, 15, influence, aggregation,
                      deformable, modulated=False)
    jout, mut = jax.jit(lambda v: jop.apply({"params": v}, *args,
                                            mutable=["intermediates"]))(
        variables)
    _close(out, jout, 1e-4, f"{influence}/{aggregation}")
    if deformable:
        jreg = float(sum_reg_losses(mut["intermediates"]))
        assert abs(reg.item() - jreg) <= 1e-5 * abs(jreg)
    else:
        assert reg is None


def test_unary_block_architecture_matches_jax():
    """An architecture with a ``unary`` block (flax numbers it before the
    head's two): eval and train-mode logits against JAX."""
    net = _net("unary")
    port = _fresh(net)
    x = torch.from_numpy(net["xyz"])
    with torch.no_grad():
        _close(port.eval()(x), net["eval_logits"], 1e-4, "eval logits")
        _close(port.train()(x), net["logits"], 1e-4, "train logits")
    assert ("params", "UnaryBlock_2", "Dense_0", "kernel") in _entries(port)


def test_cancelled_by_structure_names_no_kpconv_gradient(net):
    """No KPConv parameter's gradient is 0 by its layers' structure (its
    Dense layers have no bias; no bias meets a train-mode BatchNorm
    right after it): ``cancelled_by_structure`` names none, and every
    gradient of the JAX model on these clouds is above ``FLOOR`` of the
    largest."""
    for name in ("kpconv", "kpconv_deform"):
        assert cancelled_by_structure(get_cls_model(name)) == set()
    assert cancelled_by_structure(net["port"]) == set()
    norms = {k: float(np.linalg.norm(g))
             for k, g in _flat(net["grads"]).items()}
    largest = max(norms.values())
    assert min(norms.values()) > FLOOR * largest, min(norms.items(),
                                                      key=lambda kv: kv[1])


# ------------------------------------------------ calibration and bridge


def _same_calibration(got, want):
    assert (got.caps, got.neighborhood_limits, got.max_occupancy) == \
        (want.caps, want.neighborhood_limits, want.max_occupancy)
    assert got.mean_neighbors == pytest.approx(want.mean_neighbors,
                                               rel=1e-6)


def test_calibration_matches_jax():
    """Caps (truncation-free, margin 1.15), neighbour limits, occupancies
    and mean counts against the JAX ``calibrate_pyramid`` on 8 clouds."""
    xyz, _ = _clouds(seed=7, b=8)
    arch = ARCHS["deformable"]
    _same_calibration(
        cal.calibrate_pyramid(xyz, DL, 2.5, 6.0, arch, device="cpu"),
        jax_cal.calibrate_pyramid(xyz, DL, 2.5, 6.0, arch))


def test_bucketed_calibration_matches_jax():
    """Two occupancy buckets with quantile caps (0.9, margin 1.0) against
    the JAX ``calibrate_buckets``: the bounds, each bucket's shapes, the
    merge and the routing of each cloud."""
    xyz, _ = _clouds(seed=7, b=8)
    kw = dict(n_buckets=2, cap_quantile=0.9, margin=1.0)
    gb = cal.calibrate_buckets(xyz, DL, 2.5, 6.0, ARCHS["deformable"],
                               device="cpu", **kw)
    wb = jax_cal.calibrate_buckets(xyz, DL, 2.5, 6.0, ARCHS["deformable"],
                                   **kw)
    assert gb.bounds == wb.bounds and gb.describe() == wb.describe()
    for g, w in zip(gb.buckets + (gb.merged(),), wb.buckets + (wb.merged(),)):
        _same_calibration(g, w)
    assert [gb.bucket_of(c) for c in xyz] == [wb.bucket_of(c) for c in xyz]


@pytest.mark.parametrize("name,jax_cls", [
    ("kpconv", JaxKPConvCls), ("kpconv_deform", JaxKPConvDeformCls)])
def test_bridge_layout_and_round_trip(name, jax_cls):
    """Full width: the bridge's tree is the JAX model's (names and
    shapes, ``offset_conv`` and ``offset_bias`` in the deformable one),
    the KPConv weights draw from U(±√(6/(P·C))), and a tree loaded and
    read back is the same tree."""
    model = get_cls_model(name)
    tree = jax.eval_shape(lambda: jax_cls().init(
        jax.random.key(0), jnp.zeros((1, 128, 3)), None, training=False))
    assert jax_variable_shapes(model) == jax.tree_util.tree_map(
        lambda a: tuple(a.shape), tree)
    variables = random_jax_variables(model, seed=2)
    kernel = variables["params"]["KPCNN_0"]["ResnetBottleneckBlock_0"][
        "KPConvOp_0"]["weights"]
    bound = np.sqrt(6.0 / (15 * 16))
    assert np.abs(kernel).max() <= bound and np.abs(kernel).max() > \
        0.9 * bound
    back = to_jax_variables(from_jax_variables(model, variables))
    flat_back, flat_want = _flat(back), _flat(variables)
    assert flat_back.keys() == flat_want.keys()
    for k in flat_want:
        np.testing.assert_array_equal(flat_back[k], flat_want[k])
    offsets = [k for k in flat_want if "offset_bias" in k
               or "offset_conv" in k]
    assert len(offsets) == (0 if name == "kpconv" else 10)
