"""The neighbour kernels' routes, on the CPU: the order key of the fused
kNN + gather's select route, the ball query's cull test (its PyTorch
mirror ``chunk_far``, the kernel's arithmetic in float32 in the same
order) and the standalone kNN's choice of select instance. The kernels
themselves run on the card (``tests/test_torch_port_cuda.py``)."""

import numpy as np
import pytest
import torch

from pointcloudlib_tpu_torch.ops import geometry
from pointcloudlib_tpu_torch.ops.kernels import ball_query as kbq
from pointcloudlib_tpu_torch.ops.kernels import knn as kknn
from pointcloudlib_tpu_torch.ops.kernels import knn_gather as kkg


def test_order_key_orders_as_d2_then_index():
    """Ascending ``order_key`` is the plain version's order, a stable sort
    of d²: −0 with +0, equal d² by index, the largest finite values,
    subnormals."""
    rng = np.random.default_rng(0)
    special = np.array([0.0, -0.0, 0.0, 1e-45, 1e-40, 1.17549435e-38,
                        3.4028235e38, 3.4028233e38, 1.0, 1.0, 1.0, 2.0,
                        np.nextafter(np.float32(1.0), np.float32(2.0)),
                        np.nextafter(np.float32(1.0), np.float32(0.0))],
                       dtype=np.float32)
    rows = [np.concatenate([special, rng.random(50, dtype=np.float32) * 4]),
            np.repeat(rng.random(16, dtype=np.float32), 4),  # exact ties
            rng.permutation(special)]
    for row in rows:
        d2 = torch.from_numpy(row)[None]
        got = torch.argsort(kkg.order_key(d2), dim=-1)
        want = torch.sort(d2, dim=-1, stable=True).indices
        assert torch.equal(got, want)
    assert kkg.order_key(torch.tensor([-0.0, 0.0]))[0] >> 32 == 0


def test_knn_gather_route_rule():
    """The select route at PointConv's three launches and at every rank
    count it holds; rounds above 256 ranks and for the largest rows."""
    for n, k, stride in ((512, 64, 1), (1024, 32, 1), (256, 32, 1),
                         (1024, 86, 3)):
        assert kkg.knn_gather_route(n, k, stride) == 1
    assert kkg.knn_gather_route(1024, 65, 4) == 0     # 257 ranks
    assert kkg.knn_gather_route(kkg.MAX_POINTS, 8, 1) == 0


def _cull_case(name):
    """``(centers, points, radius)`` of one adversarial cloud."""
    rng = np.random.default_rng(len(name))
    r = 0.2
    pts = rng.standard_normal((2, 1024, 3)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    centers = pts[:, rng.permutation(1024)[:64]].copy()
    if name == "sorted":  # consecutive points near each other
        order = np.argsort(np.arctan2(pts[..., 1], pts[..., 0]) * 8
                           + pts[..., 2], axis=-1)
        pts = np.take_along_axis(pts, order[..., None], 1)
    if name == "translated 1e3":  # d² cancels: the margin decides
        pts += 1e3
        centers += 1e3
    if name in ("sphere of radius r", "r ± 1 ulp"):
        # each point of a chunk at distance r from its chunk's center,
        # or one f32 unit inside or outside of it
        dirs = rng.standard_normal((2, 1024, 3)).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        owner = np.repeat(centers[:, :32], 32, axis=1)
        pts = (owner + np.float32(r) * dirs).astype(np.float32)
        if name == "r ± 1 ulp":
            step = np.where(rng.random(pts.shape) < 0.5, np.inf, -np.inf)
            pts = np.nextafter(pts, step.astype(np.float32))
    if name == "one-point boxes":  # every chunk a single point 32 times
        pts = np.repeat(pts[:, ::32], 32, axis=1)
        step = np.float32(r) * np.array([0.999, 1.001], np.float32)
        centers[:, :32] = pts[:, ::32].copy()
        centers[:, :32, 0] += np.repeat(step, 16)  # just in, just out
    return torch.from_numpy(centers), torch.from_numpy(pts), r


@pytest.mark.parametrize("name", ["random", "sorted", "translated 1e3",
                                  "sphere of radius r", "r ± 1 ulp",
                                  "one-point boxes"])
def test_cull_never_skips_a_chunk_with_a_hit(name):
    """``chunk_far`` rules out no chunk that holds a hit of the plain
    ball query (the same sq_dist in float32, strict d² < r²)."""
    centers, pts, r = _cull_case(name)
    far = kbq.chunk_far(centers, pts, r)
    hit = geometry.square_distance(centers, pts) < r * r
    b, m, n = hit.shape
    hits = hit.view(b, m, n // kbq.CHUNK, kbq.CHUNK).any(-1)
    assert hits.any()
    assert not (far & hits).any()
    if name in ("random", "sorted", "sphere of radius r"):
        assert far.any()  # the test can skip


def test_cull_margin_covers_sq_dist_rounding():
    """Far from the origin the margin exceeds sq_dist's rounding, and the
    boxes it keeps hold every hit even where d² is mostly rounding; a
    cloud of N % 32 != 0 pads its last chunk with its last point."""
    centers, pts, r = _cull_case("translated 1e3")
    pts = pts[:, :1000]
    lo, hi = kbq.chunk_boxes(pts)
    assert lo.shape == (2, 32, 3) and torch.equal(hi[:, -1], pts[:, 992:]
                                                  .amax(1))
    far = kbq.chunk_far(centers, pts, r)
    hit = geometry.square_distance(centers, pts) < r * r
    padded = torch.cat([hit, hit[..., -1:].expand(-1, -1, 24)], -1)
    assert not (far & padded.view(2, 64, 32, 32).any(-1)).any()
    exact = ((centers[:, :, None].double() - pts[:, None].double()) ** 2
             ).sum(-1)
    assert (hit != (exact < r * r)).any()  # rounding does decide hits here
    assert kbq.pairs_tested(centers, pts, r) <= 2 * 64 * 1000


def test_knn_route_takes_the_128_query_instance_above_148_channels():
    """Where the 256-query select instance does not fit (C 149–180 at
    C % 4 == 0, k ≤ 24, N ≥ 2,048), the 128-query one with the fast
    pass, not the block route."""
    for c in (128, 148):
        assert kknn.SELECT[kknn.knn_route(16, 2048, 2048, c, 16)] == (
            8, 2, True)
    for c in (152, 160, 180):
        route = kknn.knn_route(16, 2048, 2048, c, 16)
        assert kknn.SELECT[route] == (4, 3, True)
        assert kknn.select_smem(4, 3, c) <= kknn._SMEM_LIMIT
    assert kknn.knn_route(16, 2048, 2048, 184, 16) == 0
