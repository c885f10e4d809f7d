"""The PyTorch port's Predictor against the JAX Predictor, on the CPU,
plus the port's import guard and its refusal to fall back to the CPU."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pointcloudlib_tpu.inference import Predictor as JaxPredictor
from pointcloudlib_tpu.models import get_cls_model as jax_cls_model

from pointcloudlib_tpu_torch.inference import Predictor, _bucket
from pointcloudlib_tpu_torch.models import get_cls_model
from pointcloudlib_tpu_torch.utils.interop import random_jax_variables

ROOT = Path(__file__).resolve().parents[1]


def _request(seed, b, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    nrm = rng.standard_normal((b, n, 3)).astype(np.float32)
    return x, nrm


def test_predictor_matches_jax(monkeypatch):
    """5 clouds of N=100 at batch 4: point padding to the 128 bucket and
    a half-empty last batch, on both sides."""
    monkeypatch.setenv("POINTCLOUDLIB_FUSED_SA", "1")
    variables = random_jax_variables(get_cls_model("pointnet2"), seed=2)
    clouds, normals = _request(0, 5, 100)
    jp = JaxPredictor(jax_cls_model("pointnet2"), variables,
                      with_normals=True, batch_size=4)
    want = jp.predict_proba(clouds, normals)
    pp = Predictor.from_variables("pointnet2", variables, batch_size=4,
                                  device="cpu")
    got = pp.predict_proba(clouds, normals)
    assert got.shape == (5, 40)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    # the model's f32 logit tolerance (test_torch_port_pointnet2), after
    # a softmax that only shrinks absolute differences
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(pp.predict(clouds, normals),
                                  want.argmax(-1))


def test_predictor_requests():
    assert [_bucket(n) for n in (100, 128, 129, 5000)] == [128, 128, 256,
                                                           5000]
    pp = Predictor(get_cls_model("pointnet2"), with_normals=True,
                   batch_size=2, device="cpu")
    clouds, normals = _request(1, 1, 100)
    with pytest.raises(ValueError, match="normals"):
        pp.predict_proba(clouds)
    big, big_n = _request(1, 1, 3000)
    with pytest.raises(NotImplementedError, match="4096"):
        pp.predict_proba(big, big_n)


def test_no_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(get_cls_model("pointnet2"), with_normals=True)


GUARD = """
import importlib, pkgutil, sys
import pointcloudlib_tpu_torch as pkg
for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(mod.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "pointcloudlib_tpu")
             or m.startswith(("jax.", "flax.", "pointcloudlib_tpu.")))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    """The port and chip_smoke.py import nothing of JAX, flax or the JAX
    package (``pointcloudlib_tpu_torch`` shares the JAX package's name
    as a prefix, hence the exact-name and dotted-prefix tests)."""
    res = subprocess.run([sys.executable, "-c", GUARD], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
