"""Where the serving time goes: the port's Predictor under torch.profiler.

    python -m pointcloudlib_tpu_torch.tools.profile_serving \
        [--model pointnet|pointnet2|pointnet2_msg|dgcnn|pointconv|pointcnn|
                 kpconv|kpconv_deform|pointnet_partseg|pointnet2_partseg|
                 dgcnn_partseg|pointconv_partseg|pointcnn_partseg] \
        [--n-points N] [--out DIR]

Serves PointNet++ SSG at B=64, MSG and PointConv at B=32 (``Predictor``,
normals as features, N=1024, 256 synthetic surface clouds), PointNet at
B=64 or DGCNN and PointCNN at B=32 (the same clouds, xyz only), KPConv
rigid or deformable at B=16 (xyz only; the pyramid calibrated on the
request's first 16 clouds as ``bench.py:129-155`` does), or part
segmentation at B=16 (``SegPredictor.predict``, N=2048, 64
ShapeNet-part-shaped synthetic clouds; PointNet++ with xyz as features,
DGCNN at k=40, PointNet, PointConv and PointCNN on xyz alone), the
JAX package's bench rows (``bench.py:334-355``), full width with seeded random
weights, after a warm-up request. ``--n-points`` serves clouds of N
points instead (4096: the sorted route of the given-index kernels; above
4096 and not a multiple of 128, e.g. 10000: DGCNN's standalone kNN).
Prints one JSON line with:

* ``wall_ms_per_batch`` — host clock per served batch without the
  profiler (median of 5 requests), and with it; ``clouds_per_s``, the
  batch over the first;
* ``peak_memory_gb`` — ``torch.cuda.max_memory_allocated`` over the 5
  unprofiled requests;
* ``device_busy_ms_per_batch`` and ``device_busy_share`` — the union of
  the device's kernel and copy intervals over the profiled window, per
  batch and as a share of that window's wall time;
* ``device_ops_per_batch`` — the kernels and copies the host issued per
  batch (each costs it a launch);
* ``stages`` — device milliseconds per batch by kernel-name group
  (the ported kernels, dense matmuls, BatchNorm, copies, …).

The Chrome trace goes to ``DIR/serving_trace_MODEL_nN.json`` (default
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

from pointcloudlib_tpu_torch.data.synthetic import (
    SyntheticModelNet,
    SyntheticShapeNetPart,
)
from pointcloudlib_tpu_torch.inference import Predictor, SegPredictor
from pointcloudlib_tpu_torch.tools.grad_check import (
    NORMALS,
    SEG,
    build_model,
    model_kwargs,
)
from pointcloudlib_tpu_torch.utils.interop import (
    from_jax_variables,
    random_jax_variables,
)

# the JAX package's rows: batch, points, clouds a request
BATCH = {"pointnet": 64, "pointnet2": 64, "pointnet2_msg": 32, "dgcnn": 32,
         "pointconv": 32, "pointcnn": 32, "kpconv": 16, "kpconv_deform": 16,
         **{name: 16 for name in SEG}}
N_POINTS = {**{name: 1024 for name in BATCH}, **{name: 2048 for name in SEG}}
N_CLOUDS = {**{name: 256 for name in BATCH}, **{name: 64 for name in SEG}}

# kernel-name pattern -> stage, first match wins
STAGES = (
    (r"gather_rows_kernel", "gather_neighbors kernel"),
    (r"knn_gather_(select_|rounds_)?kernel", "knn_gather kernel"),
    (r"edge2_knn_eval_(select_)?kernel", "edge2_knn_eval kernel"),
    (r"edge2_eval_kernel", "edge2_eval kernel"),
    (r"edge2_tail_kernel<64, 64, false>", "edge2_stats2 kernel"),
    (r"edge2_tail_kernel<64, 64, true>", "edge2_out kernel"),
    (r"edge2_p1_kernel|edge2_p1_rows_kernel|p1_mats_kernel<192, 128>",
     "edge2_p1 kernel"),
    (r"edge2_p2_kernel", "edge2_p2 kernel"),
    (r"edge_knn_eval_(select_)?kernel", "edge_knn_eval kernel"),
    (r"edge_knn_f1_kernel|edge_knn_f1_select_kernel", "edge_knn_f1 kernel"),
    (r"edge_out_kernel", "edge_out kernel"),
    (r"edge_bwd_kernel", "edge_bwd kernel"),
    (r"edge_eval_kernel|edge_eval_center_kernel", "edge_eval kernel"),
    (r"edge_f1_kernel|edge_f1_center_kernel", "edge_f1 kernel"),
    # |p|^2 before the select route of knn and of the EdgeConv kernels
    # with the kNN inside
    (r"knn_norms_kernel", "knn norms kernel"),
    (r"knn_kernel|knn_select_kernel", "knn kernel"),
    (r"fps_kernel", "fps kernel"),
    (r"three_interp_kernel", "three_interp kernel"),
    (r"scatter_rows_kernel", "scatter_rows kernel"),
    (r"ball_query_kernel", "ball_query kernel"),
    (r"bq_eval_kernel", "fused_sa_bq_eval kernel"),
    (r"eval_kernel", "fused_sa_eval kernel"),
    (r"bq_f1_kernel", "bq_f1 kernel"),
    (r"f1_kernel", "sa_f1 kernel"),
    (r"sums2_kernel", "sa_tail stage 2 kernel"),
    (r"chain_kernel", "sa_tail stages 3, 4 kernel"),
    (r"p1_rows_kernel|p1_mats_kernel", "sa_bwd_p1 kernel"),
    (r"p2_kernel", "sa_bwd_p2 kernel"),
    # KPConv's pyramid: the voxel keys' sort, the voxel sums' running
    # sums and the slots' bounds
    (r"[Rr]adix[Ss]ort|sort_kernel|bitonic", "sort"),
    (r"[Ss]can|cumsum", "scans (voxel sums)"),
    (r"searchsorted", "searchsorted"),
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
    ap.add_argument("--n-points", type=int, default=None,
                    help="points a cloud (default: the model's row)")
    args = ap.parse_args(argv)
    batch = BATCH[args.model]
    if not torch.cuda.is_available():
        sys.exit("profile_serving: needs a CUDA device")
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()

    n_points = args.n_points or N_POINTS[args.model]
    n_clouds = N_CLOUDS[args.model]
    variables = random_jax_variables(build_model(args.model), seed=0)
    if args.model in SEG:
        pred = SegPredictor.from_variables(SEG[args.model], variables,
                                           batch_size=batch)
        clouds, labels, _ = SyntheticShapeNetPart(
            n_points=n_points, size=n_clouds, seed=0).batch(0, n_clouds)

        def request():
            pred.predict(clouds, labels)
    else:
        clouds, normals, _ = SyntheticModelNet(
            n_points=n_points, size=n_clouds, seed=0).batch(0, n_clouds)
        model = build_model(args.model, feat_channels=3 if args.model in
                            NORMALS else 0,
                            **model_kwargs(args.model, clouds[:batch]))
        pred = Predictor(from_jax_variables(model, variables),
                         with_normals=args.model in NORMALS,
                         batch_size=batch)

        def request():
            pred.predict_proba(clouds, normals)
    request()  # warm-up: kernels built, caches
    batches = n_clouds // batch

    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        request()
        walls.append((time.perf_counter() - t0) * 1e3 / batches)

    peak = torch.cuda.max_memory_allocated()
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        request()
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
    prof.export_chrome_trace(
        str(out / f"serving_trace_{args.model}_n{n_points}.json"))
    print(json.dumps({
        "model": args.model, "card": power, "batch": batch,
        "n_points": n_points,
        "batches": batches,
        "wall_ms_per_batch": float(np.median(walls)),
        "wall_ms_per_batch_runs": walls,
        "clouds_per_s": batch * 1e3 / float(np.median(walls)),
        "peak_memory_gb": peak / 1e9,
        "profiled_wall_ms_per_batch": window_us / 1e3 / batches,
        "device_busy_ms_per_batch": busy_us / 1e3 / batches,
        "device_busy_share": busy_us / window_us,
        "device_ops_per_batch": len(dev) / batches,
        "stages": {k: v / 1e3 / batches for k, v in
                   sorted(stages.items(), key=lambda kv: -kv[1])},
        "kernel_names": sorted({e.name[:80] for e in dev}),
    }), flush=True)


if __name__ == "__main__":
    main()
