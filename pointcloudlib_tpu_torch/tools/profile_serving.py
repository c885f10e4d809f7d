"""Where the serving time goes: the port's Predictor under torch.profiler.

    python -m pointcloudlib_tpu_torch.tools.profile_serving \
        [--model pointnet2|pointnet2_msg] [--out DIR]

Serves PointNet++ SSG at B=64 or MSG at B=32 (full width, seeded random
weights, normals as features), N=1024, on 256 synthetic surface clouds
after a warm-up request, and prints one JSON line with:

* ``wall_ms_per_batch`` — host clock per served batch without the
  profiler (median of 5 requests of 256 clouds), and with it;
* ``device_busy_ms_per_batch`` and ``device_busy_share`` — the union of
  the device's kernel and copy intervals over the profiled window, per
  batch and as a share of that window's wall time;
* ``stages`` — device milliseconds per batch by kernel-name group
  (the ported kernels, dense matmuls, BatchNorm, copies, …).

The Chrome trace goes to ``DIR/serving_trace_MODEL.json`` (default
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

N_POINTS, N_CLOUDS = 1024, 256
BATCH = {"pointnet2": 64, "pointnet2_msg": 32}  # the JAX package's rows

# kernel-name pattern -> stage, first match wins
STAGES = (
    (r"fps_kernel", "fps kernel"),
    (r"ball_query_kernel", "ball_query kernel"),
    (r"bq_eval_kernel", "fused_sa_bq_eval kernel"),
    (r"eval_kernel", "fused_sa_eval kernel"),
    (r"bq_f1_kernel", "bq_f1 kernel"),
    (r"f1_kernel", "sa_f1 kernel"),
    (r"tail_kernel", "sa_tail kernel"),
    (r"p1_rows_kernel|p1_mats_kernel", "sa_bwd_p1 kernel"),
    (r"p2_kernel", "sa_bwd_p2 kernel"),
    (r"multi_tensor|foreach|sgd", "optimizer"),
    (r"Memcpy HtoD|memcpy.*HtoD", "copy host->device"),
    (r"Memcpy DtoH|memcpy.*DtoH", "copy device->host"),
    (r"gemm|gemv|cutlass|xmma|cublas|nvjet|sm90_|ampere_", "dense matmuls"),
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
    ap.add_argument("--model", default="pointnet2", choices=sorted(BATCH))
    args = ap.parse_args(argv)
    batch = BATCH[args.model]
    if not torch.cuda.is_available():
        sys.exit("profile_serving: needs a CUDA device")
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()

    variables = random_jax_variables(get_cls_model(args.model), seed=0)
    pred = Predictor.from_variables(args.model, variables, batch_size=batch)
    clouds, normals, _ = SyntheticModelNet(
        n_points=N_POINTS, size=N_CLOUDS, seed=0).batch(0, N_CLOUDS)
    pred.predict_proba(clouds, normals)  # warm-up: kernels built, caches
    batches = N_CLOUDS // batch

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
    prof.export_chrome_trace(str(out / f"serving_trace_{args.model}.json"))
    print(json.dumps({
        "model": args.model, "card": power, "batch": batch,
        "n_points": N_POINTS,
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
