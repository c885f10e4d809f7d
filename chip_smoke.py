#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line; any failure exits non-zero at once:

1. device — the card's name, the device count and ``nvidia-smi``'s name
   and power limit;
2. build — both kernels compiled from ``pointcloudlib_tpu_torch/csrc``
   (one ``nvcc`` per source, started together), with seconds and the
   ``-Xptxas -v`` registers and shared memory of each kernel;
3. kernels — each kernel against its plain PyTorch version on the card,
   at the serving shapes (FPS 1024→512 and 512→128, fused ball-query SA
   eval at SA1 and SA2, B=64) and at edge cases (near-origin points,
   m = N, N not a multiple of 32, an empty ball-query row): FPS must be
   bit-identical, the SA eval within |Δ| ≤ 1e-2 + 1e-2·|plain| (the
   same bf16 roundings, f32 sums in another order); kernel and plain
   times from CUDA events;
4. serving — PointNet++ SSG at full width with seeded random weights in
   the JAX fused layout, loaded through ``from_jax_variables``, serving
   256 synthetic surface clouds with normals at N=1024 through
   ``Predictor(batch_size=64)`` three times, plus one request at N=1000
   (bucket padding). Every launch count is zeroed just before and read
   just after; each kernel must launch twice per served batch. The
   probabilities must be finite rows summing to 1, and 8 clouds must
   agree with the same Predictor on the CPU within 5e-3 (the card runs
   the dense layers with bf16 operands, the CPU in f32).

The line before the ``nvidia-smi`` line is ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the package beside it, the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from pointcloudlib_tpu_torch.data.synthetic import SyntheticModelNet
from pointcloudlib_tpu_torch.inference import Predictor
from pointcloudlib_tpu_torch.models import get_cls_model
from pointcloudlib_tpu_torch.ops import geometry
from pointcloudlib_tpu_torch.ops.kernels import _build
from pointcloudlib_tpu_torch.ops.kernels import fps as kfps
from pointcloudlib_tpu_torch.ops.kernels import fused_sa as kfs
from pointcloudlib_tpu_torch.utils.interop import (
    from_jax_variables,
    random_jax_variables,
)

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
F32_FLOP_S = 67e12

DEV = torch.device("cuda")
BATCH, N_POINTS, N_CLOUDS, REPEATS = 64, 1024, 256, 3
BQ_ATOL = BQ_RTOL = 1e-2
PROB_ATOL = 5e-3
FPS_SRC = "pointcloudlib_tpu_torch/csrc/fps.cu"
BQ_SRC = "pointcloudlib_tpu_torch/csrc/fused_sa_bq_eval.cu"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(tag: str, obj) -> None:
    print(f"{tag}: {json.dumps(obj)}", flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call from CUDA events after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops_bf16: float, flops_f32: float, nbytes: float):
    """(bound_ms, ops_ms, bytes_ms): the larger of operations over peak
    and bytes over the memory rate."""
    ops_ms = 1e3 * (flops_bf16 / BF16_FLOP_S + flops_f32 / F32_FLOP_S)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_S
    return max(ops_ms, bytes_ms), ops_ms, bytes_ms


# ------------------------------------------------------------- phases


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    emit("device", {"name": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(), "nvidia_smi": line,
                    "torch": torch.__version__, "cuda": torch.version.cuda})
    return line


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.build(["fps", "fused_sa_bq_eval"])
    secs = time.perf_counter() - t0
    ptxas = {}
    for name in ("fps", "fused_sa_bq_eval"):
        entries, fn = [], None
        for ln in _build.ptxas_log(name).splitlines():
            m = re.search(r"entry function '([^']+)'", ln)
            if m:
                fn = m.group(1)
            m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", ln)
            if m and fn:
                entries.append({"fn": fn, "regs": int(m.group(1)),
                                "static_smem": int(m.group(2))})
            if "spill" in ln and fn and not re.search(r"\b0 bytes spill", ln):
                entries.append({"fn": fn, "spill": ln.strip()})
        ptxas[name] = entries
    emit("build", {"seconds": round(secs, 3), "ptxas": ptxas})


def _sa_inputs(model, xyz, nrm):
    """Kernel inputs of SA1 and SA2 on the main path's data."""
    sa1, sa2 = model.sa1.fused, model.sa2.fused
    with torch.no_grad():
        nx1, q1, off1 = sa1.prepare(xyz, nrm)
        f1 = kfs.fused_sa_bq_eval(nx1, xyz, q1, off1, sa1.sa_params(),
                                  sa1.sa_stats(), sa1.radius, sa1.n_samples)
        nx2, q2, off2 = sa2.prepare(nx1, f1)
    return [("SA1", sa1, (nx1, xyz, q1, off1)),
            ("SA2", sa2, (nx2, nx1, q2, off2))]


def _fps_case(name, xyz, m, skip, timed):
    got = kfps.fps(xyz, m, skip)
    want = kfps.fps_plain(xyz, m, skip)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = (got != want).sum().item()
        fail(f"fps {name}: {bad} indices differ from the plain version")
    rec = {"case": name, "shape": list(xyz.shape), "m": m, "skip": skip,
           "bit_identical": True}
    if timed:
        b, n, _ = xyz.shape
        rec["ms"] = time_ms(lambda: kfps.fps(xyz, m, skip), 20)
        rec["plain_ms"] = time_ms(lambda: kfps.fps_plain(xyz, m, skip), 3, 1)
        # per point and iteration: 3 sub, 3 mul, 2 add, 1 min, 1 compare
        rec["bound_ms"], rec["ops_ms"], rec["bytes_ms"] = bound(
            0.0, 10.0 * b * n * (m - 1), 12.0 * b * n + 4.0 * b * m)
    emit("kernel fps", rec)
    return rec


def _bq_case(name, sa, args, timed):
    nx, pts, q, off = args
    p, s = sa.sa_params(), sa.sa_stats()
    r, k = sa.radius, sa.n_samples
    with torch.no_grad():
        got = kfs.fused_sa_bq_eval(nx, pts, q, off, p, s, r, k)
        want = kfs.fused_sa_bq_eval_plain(nx, pts, q, off, p, s, r, k)
        torch.cuda.synchronize()
        err = (got - want).abs()
        ok = bool((err <= BQ_ATOL + BQ_RTOL * want.abs()).all())
        if not ok or not torch.isfinite(got).all():
            fail(f"fused_sa_bq_eval {name}: max |err| {err.max().item()} "
                 f"beyond {BQ_ATOL} + {BQ_RTOL}·|plain|")
        _, cnt = geometry.ball_query(nx, pts, r, k)
    b, m, _ = nx.shape
    n = pts.shape[1]
    c1, c2, c3 = q.shape[-1], p.w2.shape[1], p.w3.shape[1]
    live = torch.clamp(cnt, 1, k).sum().item()
    rec = {"case": name, "B": b, "N": n, "M": m, "k": k,
           "widths": [c1, c2, c3], "max_abs_err": err.max().item(),
           "max_rel_err": (err / want.abs().clamp_min(1e-3)).max().item(),
           "cnt_mean": cnt.float().mean().item(), "cnt_max": cnt.max().item(),
           "empty_rows": int((cnt == 0).sum().item()),
           "live_slots": int(live)}
    if timed:
        with torch.no_grad():
            rec["ms"] = time_ms(
                lambda: kfs.fused_sa_bq_eval(nx, pts, q, off, p, s, r, k), 20)
            rec["plain_ms"] = time_ms(
                lambda: kfs.fused_sa_bq_eval_plain(nx, pts, q, off, p, s, r,
                                                   k), 3, 1)
        # scan length per center: up to its k-th hit (the kernel stops
        # there), the whole cloud when it has fewer
        d2 = geometry.square_distance(nx, pts)
        rank = torch.cumsum((d2 < r * r).int(), dim=-1)
        scanned = torch.where(cnt >= k, (rank < k).sum(-1) + 1,
                              torch.full_like(cnt, n)).sum().item()
        rec["bound_ms"], rec["ops_ms"], rec["bytes_ms"] = bound(
            2.0 * live * (c1 * c2 + c2 * c3), 10.0 * scanned,
            12.0 * b * (n + m) + 2.0 * b * n * c1 + 4.0 * b * m * c1
            + 2.0 * (c1 * c2 + c2 * c3) + 4.0 * b * m * c3)
    emit("kernel fused_sa_bq_eval", rec)
    return rec


def phase_kernels(model, xyz, nrm):
    g = torch.Generator().manual_seed(1)
    sa = _sa_inputs(model, xyz, nrm)
    nx1 = sa[0][2][0]
    fps_recs = [_fps_case("SA1 1024->512", xyz, 512, True, True),
                _fps_case("SA2 512->128", nx1, 128, True, True)]
    near = xyz.clone()
    near[:, torch.randperm(N_POINTS, generator=g)[:300].to(DEV)] *= 1e-3
    _fps_case("near-origin 1024->512", near, 512, True, False)
    _fps_case("m=N 1024->1024", xyz[:4], N_POINTS, True, False)
    _fps_case("no skip 1024->512", near[:8], 512, False, False)
    # N=1000: not a multiple of 32; 600 > 500 eligible points
    odd = xyz[:4, :1000].clone()
    odd[:, 500:] *= 1e-3
    _fps_case("N=1000 m>eligible", odd, 600, True, False)

    bq_recs = []
    for name, mod, args in sa:
        bq_recs.append(_bq_case(f"{name} serving", mod, args, True))
        nx = args[0].clone()
        nx[0, 0] = 50.0  # a center with no neighbour: cnt == 0
        rec = _bq_case(f"{name} empty row", mod, (nx,) + args[1:], False)
        if rec["empty_rows"] < 1:
            fail(f"{name} empty-row case produced no empty row")
    return fps_recs, bq_recs


def phase_serving(variables, data, power, bq_recs):
    clouds, normals = data
    pred = Predictor.from_variables("pointnet2", variables,
                                    batch_size=BATCH)
    pred.predict_proba(clouds[:BATCH], normals[:BATCH])  # warm-up
    odd = SyntheticModelNet(n_points=1000, size=8, seed=3).batch(0, 8)

    torch.cuda.synchronize()
    kfps.fps.launches = 0
    kfs.fused_sa_bq_eval.launches = 0
    secs, outs = [], []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        outs.append(pred.predict_proba(clouds, normals))
        secs.append(time.perf_counter() - t0)
    odd_probs = pred.predict_proba(odd[0], odd[1])
    launches = {"fps": kfps.fps.launches,
                "fused_sa_bq_eval": kfs.fused_sa_bq_eval.launches}

    batches = REPEATS * (N_CLOUDS // BATCH) + 1
    for name, count in launches.items():
        if count != 2 * batches:
            fail(f"{name} launched {count} times for {batches} served "
                 f"batches; expected {2 * batches}")
    probs = outs[0]
    for p, shape in ((probs, (N_CLOUDS, 40)), (odd_probs, (8, 40))):
        if p.shape != shape or not np.isfinite(p).all():
            fail(f"probabilities not finite of shape {shape}: {p.shape}")
        if np.abs(p.sum(-1) - 1.0).max() > 1e-4:
            fail("probability rows do not sum to 1")
    if any(not np.array_equal(o, probs) for o in outs[1:]):
        fail("repeated requests gave different probabilities")

    cpu = Predictor.from_variables("pointnet2", variables, batch_size=8,
                                   device="cpu")
    ref = cpu.predict_proba(clouds[:8], normals[:8])
    diff = float(np.abs(ref - probs[:8]).max())
    if diff > PROB_ATOL:
        fail(f"card vs CPU probabilities differ by {diff} > {PROB_ATOL}")
    rates = [N_CLOUDS / s for s in secs]
    emit("serving", {
        "clouds_per_s": rates, "median_clouds_per_s": float(np.median(rates)),
        "batch": BATCH, "n_points": N_POINTS, "clouds": N_CLOUDS,
        "card": power, "launches": launches, "served_batches": batches,
        "max_abs_prob_diff_vs_cpu": diff,
        "ball_query_cnt": {r["case"].split()[0]: {
            "mean": r["cnt_mean"], "max": r["cnt_max"]} for r in bq_recs},
        "argmax_agree_vs_cpu": int((ref.argmax(-1)
                                    == probs[:8].argmax(-1)).sum())})
    return launches


def _kernel_entry(name, source, replaces, launches, recs, err):
    ops = sum(r["ops_ms"] for r in recs)
    byt = sum(r["bytes_ms"] for r in recs)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err,
            "ms": sum(r["ms"] for r in recs),
            "plain_ms": sum(r["plain_ms"] for r in recs),
            "bound_ms": sum(r["bound_ms"] for r in recs),
            "bound_by": "operations" if ops >= byt else "bytes",
            "library_ms": None}


def main() -> None:
    power = phase_device()
    phase_build()

    model = get_cls_model("pointnet2")
    variables = random_jax_variables(model, seed=0)
    clouds, normals, _ = SyntheticModelNet(
        n_points=N_POINTS, size=N_CLOUDS, seed=0).batch(0, N_CLOUDS)
    from_jax_variables(model, variables)
    model = model.to(DEV).eval()
    xyz = torch.from_numpy(clouds[:BATCH]).to(DEV)
    nrm = torch.from_numpy(normals[:BATCH]).to(DEV)
    fps_recs, bq_recs = phase_kernels(model, xyz, nrm)

    launches = phase_serving(variables, (clouds, normals), power, bq_recs)

    kernels = [
        _kernel_entry("fps", FPS_SRC,
                      "pointcloudlib_tpu/ops/pallas/fps.py:39",
                      launches["fps"], fps_recs, 0),
        _kernel_entry("fused_sa_bq_eval", BQ_SRC,
                      "pointcloudlib_tpu/ops/pallas/fused_sa.py:1269",
                      launches["fused_sa_bq_eval"], bq_recs,
                      max(r["max_abs_err"] for r in bq_recs)),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(power, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
