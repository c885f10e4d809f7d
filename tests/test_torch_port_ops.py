"""The PyTorch port's ops against the JAX package, on the CPU.

Inputs are numpy arrays from a seed, handed to both frameworks. Index
outputs (FPS, ball query) must be bit-identical; the fused SA eval is
compared within a stated tolerance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pointcloudlib_tpu.ops.pallas.fused_sa as jfs
from pointcloudlib_tpu.ops import geometry as jgeo
from pointcloudlib_tpu.ops.pallas.fps import fps_pallas

from pointcloudlib_tpu_torch.ops import dispatch, geometry
from pointcloudlib_tpu_torch.ops.kernels import fps as kfps
from pointcloudlib_tpu_torch.ops.kernels import fused_sa as kfs


def _cloud(rng, b, n):
    return rng.standard_normal((b, n, 3)).astype(np.float32)


def _near_origin(rng, b, n, n_far):
    """``n_far`` real points, the rest within |p|² ≤ 1e-3 of the origin
    (padding the FPS skip must never pick)."""
    x = _cloud(rng, b, n) * 1e-3
    x[:, :n_far] = _cloud(rng, b, n_far) + 2.0
    return x


FPS_CASES = {
    "plain": (lambda r: _cloud(r, 3, 256), 64, True),
    "n100": (lambda r: _cloud(r, 2, 100), 37, True),
    "no_skip": (lambda r: _cloud(r, 2, 128), 48, False),
    "near_origin": (lambda r: _near_origin(r, 2, 128, 80), 32, True),
    # more samples than eligible points: every later score is 0 or -1
    "m_gt_eligible": (lambda r: _near_origin(r, 2, 64, 10), 24, True),
    "m_eq_n": (lambda r: _cloud(r, 2, 64), 64, True),
    # every point four times on a coarse grid: exact d² ties, where the
    # lowest index must win
    "duplicates": (lambda r: np.tile(np.round(_cloud(r, 2, 16) * 2) / 2,
                                     (1, 4, 1)), 24, True),
}


@pytest.mark.parametrize("case", sorted(FPS_CASES))
def test_fps_bit_identical_to_jax(case):
    make, m, skip = FPS_CASES[case]
    x = make(np.random.default_rng(len(case)))
    got = dispatch.fps(torch.from_numpy(x), m, skip_near_origin=skip).numpy()
    want = np.asarray(jgeo.farthest_point_sample(jnp.asarray(x), m,
                                                 skip_near_origin=skip))
    pallas = np.asarray(fps_pallas(jnp.asarray(x), m, skip_near_origin=skip,
                                   interpret=True))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("radius,k", [(0.2, 16), (0.4, 32), (0.8, 8),
                                      (0.3, 80)])
def test_ball_query_bit_identical_to_jax(radius, k):
    rng = np.random.default_rng(int(radius * 10) + k)
    pts = _cloud(rng, 2, 64)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    centers = pts[:, :24].copy()
    centers[0, 3] = 9.0  # an empty row
    got_i, got_c = geometry.ball_query(torch.from_numpy(centers),
                                       torch.from_numpy(pts), radius, k)
    want_i, want_c = jgeo.ball_query(jnp.asarray(centers), jnp.asarray(pts),
                                     radius, k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert got_c[0, 3] == 0 and (got_i[0, 3] == 0).all()


def test_grouping_matches_jax():
    rng = np.random.default_rng(3)
    pts, feats = _cloud(rng, 2, 40), _cloud(rng, 2, 40)
    centers = pts[:, :8]
    idx = rng.integers(0, 40, (2, 8, 5)).astype(np.int32)
    t = torch.from_numpy
    d2 = geometry.square_distance(t(centers), t(pts)).numpy()
    # expansion form in another summation order: f32 rounding only
    np.testing.assert_allclose(
        d2, np.asarray(jgeo.square_distance(jnp.asarray(centers),
                                            jnp.asarray(pts))),
        rtol=1e-5, atol=1e-5)
    for use_xyz, f in ((True, feats), (True, None), (False, feats)):
        got = geometry.group_points(t(pts), None if f is None else t(f),
                                    t(centers), t(idx), use_xyz).numpy()
        want = jgeo.group_points(jnp.asarray(pts),
                                 None if f is None else jnp.asarray(f),
                                 jnp.asarray(centers), jnp.asarray(idx),
                                 use_xyz)
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(
        geometry.group_all(t(pts), t(feats)).numpy(),
        np.asarray(jgeo.group_all(jnp.asarray(pts), jnp.asarray(feats))))


def _bq_eval_inputs():
    """tests/test_fused_sa.py's bq-eval case: b=2, n=256, m=64, k=16,
    widths 16/16/32, one far center (an empty row), non-trivial BN."""
    rng = np.random.default_rng(9)
    b, n, m, k = 2, 256, 64, 16
    c1, c2, c3 = 16, 16, 32
    xyz = _cloud(rng, b, n)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    fidx = jgeo.farthest_point_sample(jnp.asarray(xyz), m)
    new_xyz = np.array(jgeo.index_points(jnp.asarray(xyz), fidx))
    new_xyz[0, 0] = 50.0
    w1 = (rng.standard_normal((3, c1)) * 0.3).astype(np.float32)

    def bf16_dot(a):
        return np.array(jnp.dot(jnp.asarray(a).astype(jnp.bfloat16),
                                  jnp.asarray(w1).astype(jnp.bfloat16),
                                  preferred_element_type=jnp.float32))

    params = {
        "w2": rng.standard_normal((c1, c2)) * 0.3,
        "w3": rng.standard_normal((c2, c3)) * 0.3,
        "g1": rng.uniform(0.5, 1.5, c1), "b1": rng.normal(0, 0.1, c1),
        "g2": rng.uniform(0.5, 1.5, c2), "b2": rng.normal(0, 0.1, c2),
        "g3": rng.uniform(0.5, 1.5, c3), "b3": rng.normal(0, 0.1, c3),
    }
    stats = [rng.normal(0, 0.1, c1), rng.uniform(0.5, 1.5, c1),
             rng.normal(0, 0.1, c2), rng.uniform(0.5, 1.5, c2),
             rng.normal(0, 0.1, c3), rng.uniform(0.5, 1.5, c3)]
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (new_xyz, xyz, bf16_dot(xyz), bf16_dot(new_xyz),
            {kk: f32(v) for kk, v in params.items()},
            [f32(s) for s in stats], 0.4, k)


def test_bq_eval_plain_matches_jax_interpret():
    new_xyz, xyz, q, off, params, stats, radius, k = _bq_eval_inputs()
    want = jfs.fused_sa_bq_eval(
        jnp.asarray(new_xyz), jnp.asarray(xyz), jnp.asarray(q),
        jnp.asarray(off), jfs.SAParams(**params),
        jfs.SAStats(*stats), radius, k, interpret=True)
    t = torch.from_numpy
    before = kfs.fused_sa_bq_eval.launches
    got = kfs.fused_sa_bq_eval(
        t(new_xyz), t(xyz), t(q).bfloat16(), t(off),
        kfs.SAParams(**{kk: t(v) for kk, v in params.items()}),
        kfs.SAStats(*map(t, stats)), radius, k)
    assert kfs.fused_sa_bq_eval.launches == before  # CPU: plain version
    # the same bf16 roundings at the same places; f32 sums in another
    # order (matmul vs the kernel's per-slot dots) move the last bits
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-3, atol=1e-3)


def test_wrappers_refuse_other_devices():
    x = torch.zeros((1, 8, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kfps.fps(x, 4)
    q = torch.zeros((1, 8, 64), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        kfs.fused_sa_bq_eval(x, x, q, q, None, None, 0.2, 8)


def test_resolve_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dispatch.resolve_device()
    assert dispatch.resolve_device("cpu") == torch.device("cpu")
