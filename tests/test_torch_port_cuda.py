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


@pytest.mark.parametrize("n", [100, 2000])
def test_predictor_card_matches_cpu(card, n):
    """Smallest and largest served buckets (128: SA1 samples more
    centers than points; 2048) through both kernels on the card, against
    the plain path on the CPU; the card's dense layers use bf16
    operands, the CPU's f32."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    nrm = rng.standard_normal((3, n, 3)).astype(np.float32)
    variables = random_jax_variables(get_cls_model("pointnet2"), seed=n)
    got = Predictor.from_variables("pointnet2", variables, batch_size=2,
                                   device=card).predict_proba(x, nrm)
    want = Predictor.from_variables("pointnet2", variables, batch_size=2,
                                    device="cpu").predict_proba(x, nrm)
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)
