"""Where the serving time goes: the port's Predictor under torch.profiler.

    python -m pointcloudlib_tpu_torch.tools.profile_serving [--out DIR]

Serves PointNet++ SSG (full width, seeded random weights, normals as
features) at B=64, N=1024 on 256 synthetic surface clouds after a
warm-up request, and prints one JSON line with:

* ``wall_ms_per_batch`` — host clock per served batch of 64 without the
  profiler (median of 5 requests of 256 clouds), and with it;
* ``device_busy_ms_per_batch`` and ``device_busy_share`` — the union of
  the device's kernel and copy intervals over the profiled window, per
  batch and as a share of that window's wall time;
* ``stages`` — device milliseconds per batch by kernel-name group
  (the two ported kernels, dense matmuls, BatchNorm, copies, …).

The Chrome trace goes to ``DIR/serving_trace.json`` (default
``build/profile``). Needs a CUDA device; exits non-zero without one or
when the profiler records no device time.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from pointcloudlib_tpu_torch.data.synthetic import SyntheticModelNet
from pointcloudlib_tpu_torch.inference import Predictor
from pointcloudlib_tpu_torch.models import get_cls_model
from pointcloudlib_tpu_torch.utils.interop import random_jax_variables

BATCH, N_POINTS, N_CLOUDS = 64, 1024, 256

# kernel-name pattern -> stage, first match wins
STAGES = (
    (r"fps_kernel", "fps kernel"),
    (r"bq_eval_kernel", "fused_sa_bq_eval kernel"),
    (r"bq_f1_kernel", "bq_f1 kernel"),
    (r"tail_kernel", "sa_tail kernel"),
    (r"p1_rows_kernel|p1_mats_kernel", "sa_bwd_p1 kernel"),
    (r"p2_kernel", "sa_bwd_p2 kernel"),
    (r"multi_tensor|foreach|sgd", "optimizer"),
    (r"Memcpy HtoD|memcpy.*HtoD", "copy host->device"),
    (r"Memcpy DtoH|memcpy.*DtoH", "copy device->host"),
    (r"gemm|gemv|cutlass|xmma|cublas|sm90_|ampere_", "dense matmuls"),
    (r"batch_norm|bn_fw", "batchnorm"),
    (r"softmax", "softmax"),
    (r"reduce_kernel", "reductions (max-pool, sums)"),
    (r"gather|index", "gathers"),
    (r"[Cc]at", "concatenation"),
)


def _stage(name: str) -> str:
    for pat, stage in STAGES:
        if re.search(pat, name):
            return stage
    return "other elementwise"


def _union_us(intervals) -> float:
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(
        Path(__file__).resolve().parents[2] / "build" / "profile"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_serving: needs a CUDA device")
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()

    variables = random_jax_variables(get_cls_model("pointnet2"), seed=0)
    pred = Predictor.from_variables("pointnet2", variables,
                                    batch_size=BATCH)
    clouds, normals, _ = SyntheticModelNet(
        n_points=N_POINTS, size=N_CLOUDS, seed=0).batch(0, N_CLOUDS)
    pred.predict_proba(clouds, normals)  # warm-up: kernels built, caches
    batches = N_CLOUDS // BATCH

    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        pred.predict_proba(clouds, normals)
        walls.append((time.perf_counter() - t0) * 1e3 / batches)

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict_proba(clouds, normals)
        window_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        sys.exit("profile_serving: the profiler recorded no device time")
    stages: dict = {}
    for e in dev:
        st = _stage(e.name)
        stages[st] = stages.get(st, 0.0) + e.time_range.elapsed_us()
    busy_us = _union_us((e.time_range.start, e.time_range.end) for e in dev)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "serving_trace.json"))
    print(json.dumps({
        "card": power, "batch": BATCH, "n_points": N_POINTS,
        "batches": batches,
        "wall_ms_per_batch": float(np.median(walls)),
        "wall_ms_per_batch_runs": walls,
        "profiled_wall_ms_per_batch": window_us / 1e3 / batches,
        "device_busy_ms_per_batch": busy_us / 1e3 / batches,
        "device_busy_share": busy_us / window_us,
        "stages": {k: v / 1e3 / batches for k, v in
                   sorted(stages.items(), key=lambda kv: -kv[1])},
        "kernel_names": sorted({e.name[:80] for e in dev}),
    }), flush=True)


if __name__ == "__main__":
    main()
