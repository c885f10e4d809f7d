"""PointConv's and PointNet's Dense precision on the card: what each
choice costs in device time, and how far each leaves the train step's
gradients from the CPU's.

    python -m pointcloudlib_tpu_torch.tools.dense_precision \
        [--model pointconv pointconv_partseg pointnet pointnet_partseg] \
        [--seeds 5 6] [--clouds 8]

The JAX package's ``DenseBNAct`` takes bf16 operands with f32 sums on its
accelerator; the port's PointConv and PointNet take f32 in every Dense
layer (``models/pointconv.py``, ``models/pointnet.py``). This tool builds
each model at its bench row (full width, seeded random weights) and sets
the ``dtype`` of its ``DenseBNAct`` layers to each precision of
:data:`PRECISIONS` that it has the layers of, in turn:

* ``bf16``: every layer by the package rule (bf16 operands on the card);
* ``density_f32``: the DensityNets in f32, the rest bf16 (PointConv);
* ``density_weight_f32``: the DensityNets and the WeightNets in f32
  (PointConv);
* ``f32``: every layer in f32 (the model as built).

For each model and precision it prints one JSON line with

* ``grads``: for each seed, one train-mode forward and backward of
  ``--clouds`` synthetic clouds with dropout 0 on the card against the
  CPU's (``grad_check.compare_grads``, under its bounds): the least and
  the median cosine, the norm ratio farthest from 1 and the failures;
* ``serve_*`` and ``step_*``: a served batch (the eval forward) and a
  train step (``make_*_train_step``, the model's dropout, ``profile_train``'s
  lr) at ``profile_serving``'s batch and N: ``device_ms``, the union of
  the device's kernel intervals per run over 5 profiled runs;
  ``dense_ms``, the dense matmuls' kernel time in it; ``wall_ms``, the
  host clock per run, ending in a synchronize (median of 10). The
  precisions are timed in order and then in reverse order, within one
  process; each list holds the two readings.

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from pointcloudlib_tpu_torch.nn.layers import DenseBNAct
from pointcloudlib_tpu_torch.tools.grad_check import (
    SEG,
    build_model,
    compare_grads,
    model_grads,
    synthetic_batch,
)
from pointcloudlib_tpu_torch.tools.profile_serving import (
    BATCH,
    N_POINTS,
    _stage,
    _union_us,
)
from pointcloudlib_tpu_torch.tools.profile_train import LR
from pointcloudlib_tpu_torch.train import (
    make_cls_train_step,
    make_seg_train_step,
    sgd_momentum,
)
from pointcloudlib_tpu_torch.utils.interop import (
    from_jax_variables,
    random_jax_variables,
)

# precision -> the sub-nets whose DenseBNAct layers take f32 (None: all)
PRECISIONS = {"bf16": (), "density_f32": ("density_net",),
              "density_weight_f32": ("density_net", "weight_net"),
              "f32": None}
WALL, PROFILED = 10, 5
MODELS = ("pointconv", "pointconv_partseg", "pointnet", "pointnet_partseg")


def set_precision(model: torch.nn.Module, precision: str) -> torch.nn.Module:
    """Give every ``DenseBNAct`` of ``model`` f32 operands or the package
    rule (``dtype=None``), as :data:`PRECISIONS` says; returns ``model``."""
    f32 = PRECISIONS[precision]
    for name, m in model.named_modules():
        if isinstance(m, DenseBNAct):
            m.dtype = (torch.float32 if f32 is None
                       or set(name.split(".")) & set(f32) else None)
    return model


def precisions(model: torch.nn.Module) -> List[str]:
    """The precisions of :data:`PRECISIONS` that ``model`` has the layers
    of: a mixed one only where it has the sub-nets the precision names."""
    parts = {part for name, _ in model.named_modules()
             for part in name.split(".")}
    return [p for p, f32 in PRECISIONS.items() if not f32 or set(f32) & parts]


def _timed(run: Callable[[], None]) -> Dict[str, float]:
    """Wall, device and dense-matmul ms per call of ``run``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        run()
    torch.cuda.synchronize()
    walls = []
    for _ in range(WALL):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            run()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        sys.exit("dense_precision: the profiler recorded no device time")
    busy = _union_us((e.time_range.start, e.time_range.end) for e in events)
    dense = sum(e.time_range.elapsed_us() for e in events
                if _stage(e.name) == "dense matmuls")
    return {"wall_ms": float(np.median(walls)),
            "device_ms": busy / 1e3 / PROFILED,
            "dense_ms": dense / 1e3 / PROFILED}


def measure(name: str, seeds: Sequence[int], clouds: int) -> List[dict]:
    """One record per precision of model ``name`` (module docstring)."""
    dev = torch.device("cuda")
    variables = random_jax_variables(build_model(name), seed=0)
    base = build_model(name, dropout=0.0)
    from_jax_variables(base, variables)
    n_points = N_POINTS[name]
    recs = {p: {"model": name, "precision": p, "grads": []}
            for p in precisions(base)}
    for seed in seeds:
        batch = synthetic_batch(name, clouds, seed, n_points)
        cpu = model_grads(copy.deepcopy(base), name, batch)
        for p, rec in recs.items():
            got = compare_grads(name, model_grads(set_precision(
                copy.deepcopy(base), p).to(dev), name, batch), cpu)
            cos = sorted((c, k) for k, (c, _) in got["agree"].items())
            rec["grads"].append({
                "seed": seed, "clouds": clouds, "loss": got["loss"],
                "loss_cpu": got["loss_cpu"], "least_cos": cos[0],
                "median_cos": cos[len(cos) // 2][0],
                "worst_norm_ratio": max(
                    ((r, k) for k, (_, r) in got["agree"].items()),
                    key=lambda rk: abs(rk[0] - 1)),
                "cosine_only": got["cosine_only"],
                "n_failures": len(got["failures"]),
                "failures": got["failures"][:8]})

    model = build_model(name)
    from_jax_variables(model, variables)
    batch = {k: v.to(dev) for k, v in synthetic_batch(
        name, BATCH[name], 5, n_points).items()}
    args = ((batch["xyz"], batch["cls_onehot"]) if name in SEG
            else (batch["xyz"], batch.get("feats")))
    make = make_seg_train_step if name in SEG else make_cls_train_step
    runs = {}
    for p in recs:
        m = set_precision(copy.deepcopy(model), p).to(dev)
        step = make(m, sgd_momentum(m.parameters(), LR[name]))
        gen = torch.Generator(device=dev).manual_seed(0)
        runs[p] = (m, step, gen)

    def serve(m):
        def run():
            m.eval()
            with torch.no_grad():
                m(*args)
        return run

    order = list(recs)
    for p in order + order[::-1]:
        m, step, gen = runs[p]
        for tag, t in (("serve", _timed(serve(m))),
                       ("step", _timed(lambda: step(batch, gen)))):
            for k, v in t.items():
                recs[p].setdefault(f"{tag}_{k}", []).append(v)
    return list(recs.values())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", nargs="+",
                    default=["pointconv", "pointconv_partseg"],
                    choices=MODELS)
    ap.add_argument("--seeds", type=int, nargs="+", default=[5, 6])
    ap.add_argument("--clouds", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("dense_precision: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    for name in args.model:
        for rec in measure(name, args.seeds, args.clouds):
            print(json.dumps({"card": card, "batch": BATCH[name],
                              "n_points": N_POINTS[name], **rec}),
                  flush=True)


if __name__ == "__main__":
    main()
