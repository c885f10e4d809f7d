"""Where the train step's time goes: ``make_cls_train_step`` or
``make_seg_train_step`` under torch.profiler.

    python -m pointcloudlib_tpu_torch.tools.profile_train \
        [--model pointnet|pointnet2|pointnet2_msg|dgcnn|pointconv|pointcnn|
                 kpconv|kpconv_deform|pointnet_partseg|pointnet2_partseg|
                 dgcnn_partseg|pointconv_partseg|pointcnn_partseg] \
        [--n-points N] [--batch B] [--out DIR]

Trains PointNet++ SSG at B=64 or MSG at B=32 (normals as features,
N=1024, labelled synthetic surface clouds, SGD with momentum 0.9 and lr
0.02), PointNet at B=64 or DGCNN and PointCNN at B=32 (the same clouds,
xyz only, lr 0.1, ``bench.py:168``), PointConv at B=32 (normals as
features, lr 0.1), KPConv rigid or deformable at B=16 (xyz only, the
pyramid calibrated on the batch as ``bench.py:129-155`` does; rigid at
lr 0.1, deformable by the CLI's KPConv recipe, ``kpconv_optimizer``,
with the offsets at 0.1 × and the gradients clipped to 100: at lr 0.1
its seeded weights diverge), or part segmentation at B=16 (N=2048,
ShapeNet-part-shaped synthetic clouds, lr 0.01, ``bench.py:233``;
PointNet++ with xyz as features, DGCNN at k=40, PointNet, PointConv and
PointCNN on xyz alone), full width with
seeded random weights and the models' dropout (0.5; PointConv 0.4; none
in PointNet's and PointCNN's part segmentation), on
one batch, after 3 warm-up
steps; ``--n-points`` trains on clouds of N points instead (4096: the
sorted route of the given-index kernels; 1000: DGCNN's standalone kNN),
``--batch`` at B clouds a step.
Prints one JSON line with:

* ``wall_ms_per_step`` — host clock per step, ending in a synchronize,
  without the profiler (median of 10 steps), and with it;
* ``device_busy_ms_per_step`` and ``device_busy_share`` — the union of
  the device's kernel and copy intervals over 5 profiled steps, per step
  and as a share of that window's wall time;
* ``device_ops_per_step`` — the kernels and copies the host issued per
  step (each costs it a launch);
* ``stages`` — device milliseconds per step by kernel-name group (the
  ported kernels, dense matmuls, BatchNorm, optimizer, …);
* ``peak_device_bytes`` — ``torch.cuda.max_memory_allocated`` over the
  timed steps.

The Chrome trace goes to ``DIR/train_trace_MODEL_nN.json`` (default
``build/profile``). Needs a CUDA device; exits non-zero without one or
when the profiler records no device time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from pointcloudlib_tpu_torch.tools.grad_check import (
    SEG,
    build_model,
    model_kwargs,
    synthetic_batch,
)
from pointcloudlib_tpu_torch.tools.profile_serving import (
    BATCH,
    N_POINTS,
    _stage,
    _union_us,
)
from pointcloudlib_tpu_torch.train import (
    KPCONV_CLIP_NORM,
    kpconv_optimizer,
    make_cls_train_step,
    make_seg_train_step,
    sgd_momentum,
)
from pointcloudlib_tpu_torch.utils.interop import (
    from_jax_variables,
    random_jax_variables,
)

LR = {"pointnet": 0.1, "pointnet2": 0.02, "pointnet2_msg": 0.02,
      "dgcnn": 0.1, "pointconv": 0.1, "pointcnn": 0.1, "kpconv": 0.1,
      **{name: 0.01 for name in SEG}}
WARMUP, TIMED, PROFILED = 3, 10, 5


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(
        Path(__file__).resolve().parents[2] / "build" / "profile"))
    ap.add_argument("--model", default="pointnet2", choices=sorted(BATCH))
    ap.add_argument("--n-points", type=int, default=None,
                    help="points a cloud (default: the model's row)")
    ap.add_argument("--batch", type=int, default=None,
                    help="clouds a step (default: the model's row)")
    args = ap.parse_args(argv)
    bsz = args.batch or BATCH[args.model]
    n_points = args.n_points or N_POINTS[args.model]
    if not torch.cuda.is_available():
        sys.exit("profile_train: needs a CUDA device")
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()

    cpu_batch = synthetic_batch(args.model, bsz, 5, n_points)
    model = build_model(args.model,
                        **model_kwargs(args.model, cpu_batch["xyz"]))
    from_jax_variables(model, random_jax_variables(model, seed=0))
    make = make_seg_train_step if args.model in SEG else make_cls_train_step
    if args.model == "kpconv_deform":
        opt, set_lr = kpconv_optimizer(model, 9840 // bsz, 0.1)
        set_lr(0)
        step = make(model, opt, clip_norm=KPCONV_CLIP_NORM)
    else:
        step = make(model, sgd_momentum(model.parameters(), LR[args.model]))
    dev = torch.device("cuda")
    batch = {k: v.to(dev) for k, v in cpu_batch.items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(WARMUP):
        step(batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    walls = []
    for _ in range(TIMED):
        t0 = time.perf_counter()
        step(batch, gen)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

    peak = torch.cuda.max_memory_allocated()

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED):
            step(batch, gen)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        sys.exit("profile_train: the profiler recorded no device time")
    stages: dict = {}
    for e in events:
        st = _stage(e.name)
        stages[st] = stages.get(st, 0.0) + e.time_range.elapsed_us()
    busy_us = _union_us((e.time_range.start, e.time_range.end)
                        for e in events)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(
        str(out / f"train_trace_{args.model}_n{n_points}.json"))
    print(json.dumps({
        "model": args.model, "card": power, "batch": bsz,
        "n_points": n_points, "steps": PROFILED,
        "peak_device_bytes": peak,
        "wall_ms_per_step": float(np.median(walls)),
        "wall_ms_per_step_runs": walls,
        "samples_per_s": bsz * 1e3 / float(np.median(walls)),
        "profiled_wall_ms_per_step": window_us / 1e3 / PROFILED,
        "device_busy_ms_per_step": busy_us / 1e3 / PROFILED,
        "device_busy_share": busy_us / window_us,
        "device_ops_per_step": len(events) / PROFILED,
        "stages": {k: v / 1e3 / PROFILED for k, v in
                   sorted(stages.items(), key=lambda kv: -kv[1])},
        "kernel_names": sorted({e.name[:80] for e in events}),
    }), flush=True)


if __name__ == "__main__":
    main()
