#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line or more; any failure exits non-zero at
once:

1. device — the card's name, the device count and ``nvidia-smi``'s name
   and power limit;
2. build — the nine kernel sources of ``pointcloudlib_tpu_torch/csrc``
   compiled (one ``nvcc`` per source, started together), with seconds and
   the ``-Xptxas -v`` registers, shared memory and spills of each kernel;
3. kernels — the SSG serving kernels against their plain PyTorch versions
   on the card, at the serving shapes (FPS 1024→512 and 512→128, fused
   ball-query SA eval at SA1 and SA2, B=64) and at edge cases
   (near-origin points, m = N, N not a multiple of 32, an empty
   ball-query row): FPS must be bit-identical, the SA eval within
   |Δ| ≤ 1e-2 + 1e-2·|plain| (the same bf16 roundings, f32 sums in
   another order); kernel and plain times from CUDA events;
4. train kernels — the train-mode fused SA kernels against their plain
   versions at the SA1 and SA2 train shapes of the SSG path (B=64, from
   the model's own inputs) and with an empty ball-query row: f1's idx,
   cnt and h1 bit-identical, every Σ/Σ² within 1e-3 of its largest
   element (f32 atomics in another order), the pooled output within
   1e-2 + 1e-2·|plain|, the backward passes tie-robust (fewer than 0.5 %
   of elements beyond 1e-2 + 1e-2·|plain|, mean deviation below 3e-3,
   both scaled by max|plain|: a last-bit change can move a max-pool tie
   share); kernel and plain times;
5. MSG kernels — every kernel of the PointNet++ MSG path at the six
   scales' shapes (B=32, N=1024 into MSG1, its 512 centers into MSG2, from
   the model's own inputs) against its plain version under the same
   bounds: the standalone ball query bit-identical at both k=128 scales
   and at edge cases (an empty row, rows shorter than k, rows cut at k,
   N not a multiple of 32); the pass-1 kernel that takes a given idx (h1
   bit-identical) and the eval kernel that takes one (with and without
   cnt) at both k=128 scales; the ball-query eval and pass-1 kernels at
   the four k ≤ 64 scales; the tails, p1 and p2 at all six, plus MSG1's
   k=128 scale with an empty row (a center spans two 64-row tiles there);
6. serving — PointNet++ SSG at full width with seeded random weights in
   the JAX fused layout, loaded through ``from_jax_variables``, serving
   256 synthetic surface clouds with normals at N=1024 through
   ``Predictor(batch_size=64)`` three times, plus one request at N=1000
   (bucket padding). Every launch count is zeroed just before and read
   just after; FPS and the ball-query eval kernel must each launch twice
   per served batch and no other kernel at all. The probabilities must
   be finite rows summing to 1, and 8 clouds must agree with the same
   Predictor on the CPU within 5e-3 (the card runs the dense layers with
   bf16 operands, the CPU in f32). Then the same for PointNet++ MSG
   through ``Predictor(batch_size=32)``: per served batch exactly 2
   launches of FPS, 4 of the ball-query eval kernel, 2 of the ball query
   and 2 of the eval kernel that takes its idx;
7. train — SSG: the same weights and SGD with momentum 0.9 at the
   reference's flat lr through ``make_cls_train_step`` on 64 labelled
   synthetic clouds at N=1024: 2 warm-up steps, then 10 timed steps
   (samples/s on the host clock, with the card's name and power limit),
   counts zeroed just before the timed steps: per step exactly 2
   launches of FPS, f1, p1 and p2, 6 of the tail, none of any other
   kernel. Every loss finite, parameters and running statistics moved.
   Then one forward and backward on 8 clouds on the card and on the CPU
   from the same weights with dropout 0: the loss within 1e-2 relative,
   and each parameter's gradient against the CPU's within the fixed
   cosine and norm-ratio bounds of ``tools/grad_check.py`` (which says
   which gradients are exactly 0 and not compared). MSG: the same at B=32:
   per step exactly 2 launches of FPS, 4 of the ball-query f1, 2 of the
   ball query, 2 of the f1 that takes its idx, 18 of the tail, 6 of p1
   and of p2, none of an eval kernel; peak device memory reported.

The line before the ``nvidia-smi`` line is ``{"kernels": [...]}``, one
entry per TPU kernel replaced (eleven; the three forward tails share one
source and one wrapper, counted per stage); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
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
from pointcloudlib_tpu_torch.ops.kernels import ball_query as kbq
from pointcloudlib_tpu_torch.ops.kernels import fps as kfps
from pointcloudlib_tpu_torch.ops.kernels import fused_sa as kfs
from pointcloudlib_tpu_torch.ops.kernels import fused_sa_train as kft
from pointcloudlib_tpu_torch.tools.grad_check import (
    GRAD_COS,
    GRAD_NORM,
    LOSS_RTOL,
    grad_agreement,
)
from pointcloudlib_tpu_torch.train import (
    make_cls_train_step,
    reference_flat_lr,
    sgd_momentum,
)
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
MSG_BATCH = 32                 # the JAX package's MSG classification row
BQ_ATOL = BQ_RTOL = 1e-2
PROB_ATOL = 5e-3
SUM_TOL = 1e-3                 # Σ/Σ² of the train kernels, × max|plain|
TRAIN_STEPS, WARMUP_STEPS, CHECK_CLOUDS = 10, 2, 8
CSRC = "pointcloudlib_tpu_torch/csrc/"
SOURCES = ("fps", "ball_query", "fused_sa_bq_eval",
           "fused_sa_eval") + kft.SOURCES
PALLAS = "pointcloudlib_tpu/ops/pallas/"
FUSED_SA = PALLAS + "fused_sa.py"


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
    _build.build(SOURCES)
    secs = time.perf_counter() - t0
    ptxas = {}
    for name in SOURCES:
        entries, fn = [], None
        for ln in _build.ptxas_log(name).splitlines():
            m = re.search(r"entry function '([^']+)'", ln)
            if m:
                fn = m.group(1)
            m = re.search(r"Used (\d+) registers", ln)
            if m and fn:
                smem = re.search(r"(\d+) bytes smem", ln)
                entries.append({"fn": fn, "regs": int(m.group(1)),
                                "static_smem": int(smem.group(1)) if smem
                                else 0})
            if "spill" in ln and fn and not re.search(r"\b0 bytes spill", ln):
                entries.append({"fn": fn, "spill": ln.strip()})
        ptxas[name] = entries
    emit("build", {"seconds": round(secs, 3), "ptxas": ptxas})


def _sa_inputs(model, xyz, nrm):
    """Kernel inputs of SA1 and SA2 on the main path's data."""
    sa1, sa2 = model.sa1.fused, model.sa2.fused
    with torch.no_grad():
        nx1, q1, off1 = sa1.prepare(xyz, nrm)
        q1 = q1.bfloat16()
        f1 = kfs.fused_sa_bq_eval(nx1, xyz, q1, off1, sa1.sa_params(),
                                  sa1.sa_stats(), sa1.radius, sa1.n_samples)
        nx2, q2, off2 = sa2.prepare(nx1, f1)
    return [("SA1", sa1, (nx1, xyz, q1, off1)),
            ("SA2", sa2, (nx2, nx1, q2.bfloat16(), off2))]


def _fps_case(name, xyz, m, skip, timed):
    got = kfps.fps(xyz, m, skip)
    want = kfps.fps_plain(xyz, m, skip)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = (got != want).sum().item()
        fail(f"fps {name}: {bad} indices differ from the plain version")
    rec = {"case": name, "shape": list(xyz.shape), "m": m, "skip": skip,
           "bit_identical": True, "max_abs_err": 0.0}
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
           "max_abs_plain": want.abs().max().item(),
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


COUNTED = {"fps": kfps.fps, "ball_query": kbq.ball_query,
           "fused_sa_bq_eval": kfs.fused_sa_bq_eval,
           "fused_sa_eval": kfs.fused_sa_eval, "bq_f1": kft.bq_f1,
           "sa_f1": kft.sa_f1, "sa_tail": kft.sa_tail,
           "sa_bwd_p1": kft.sa_bwd_p1, "sa_bwd_p2": kft.sa_bwd_p2}
# launches per served batch and per train step; a kernel not named: none
SSG_SERVE = {"fps": 2, "fused_sa_bq_eval": 2}
MSG_SERVE = {"fps": 2, "fused_sa_bq_eval": 4, "ball_query": 2,
             "fused_sa_eval": 2}
SSG_STEP = {"fps": 2, "bq_f1": 2, "sa_tail": 6, "sa_bwd_p1": 2,
            "sa_bwd_p2": 2}
MSG_STEP = {"fps": 2, "bq_f1": 4, "ball_query": 2, "sa_f1": 2,
            "sa_tail": 18, "sa_bwd_p1": 6, "sa_bwd_p2": 6}


def _zero_counts() -> None:
    for fn in COUNTED.values():
        fn.launches = 0
    for stage in kft.sa_tail.launches_by_stage:
        kft.sa_tail.launches_by_stage[stage] = 0


def _read_counts(what: str, per_unit: dict, units: int) -> dict:
    """The launch counts since :func:`_zero_counts`, with the tail's per
    stage; fails unless each kernel launched exactly ``per_unit`` times
    for each of the ``units`` batches or steps."""
    launches = {name: fn.launches for name, fn in COUNTED.items()}
    for name, count in launches.items():
        want = per_unit.get(name, 0) * units
        if count != want:
            fail(f"{what}: {name} launched {count} times in {units} "
                 f"batches or steps; expected {want}")
    by_stage = dict(kft.sa_tail.launches_by_stage)
    if any(3 * c != launches["sa_tail"] for c in by_stage.values()):
        fail(f"{what}: tail stages launched unevenly: {by_stage}")
    launches.update({f"sa_tail_{st}": c for st, c in by_stage.items()})
    return launches


def phase_serving(name, variables, data, power, batch, per_batch, extra):
    clouds, normals = data
    pred = Predictor.from_variables(name, variables, batch_size=batch)
    pred.predict_proba(clouds[:batch], normals[:batch])  # warm-up
    odd = SyntheticModelNet(n_points=1000, size=8, seed=3).batch(0, 8)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    secs, outs = [], []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        outs.append(pred.predict_proba(clouds, normals))
        secs.append(time.perf_counter() - t0)
    odd_probs = pred.predict_proba(odd[0], odd[1])
    batches = REPEATS * (N_CLOUDS // batch) + 1
    launches = _read_counts(f"{name} serving", per_batch, batches)
    peak = torch.cuda.max_memory_allocated()

    probs = outs[0]
    for p, shape in ((probs, (N_CLOUDS, 40)), (odd_probs, (8, 40))):
        if p.shape != shape or not np.isfinite(p).all():
            fail(f"probabilities not finite of shape {shape}: {p.shape}")
        if np.abs(p.sum(-1) - 1.0).max() > 1e-4:
            fail("probability rows do not sum to 1")
    if any(not np.array_equal(o, probs) for o in outs[1:]):
        fail("repeated requests gave different probabilities")

    cpu = Predictor.from_variables(name, variables, batch_size=8,
                                   device="cpu")
    ref = cpu.predict_proba(clouds[:8], normals[:8])
    diff = float(np.abs(ref - probs[:8]).max())
    if diff > PROB_ATOL:
        fail(f"{name}: card vs CPU probabilities differ by {diff} > "
             f"{PROB_ATOL}")
    rates = [N_CLOUDS / s for s in secs]
    emit(f"serving {name}", {
        "clouds_per_s": rates, "median_clouds_per_s": float(np.median(rates)),
        "batch": batch, "n_points": N_POINTS, "clouds": N_CLOUDS,
        "card": power, "launches": launches, "served_batches": batches,
        "peak_device_bytes": peak, "max_abs_prob_diff_vs_cpu": diff,
        "argmax_agree_vs_cpu": int((ref.argmax(-1)
                                    == probs[:8].argmax(-1)).sum()),
        **extra})
    return launches


# ------------------------------------------------------ train kernels


def _check_sums(what, got, want):
    """``(max |Δ|, max |plain|)``; fails beyond SUM_TOL·max|plain|."""
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if not torch.isfinite(got).all() or not err <= SUM_TOL * scale:
        fail(f"{what}: |Δ| {err} beyond {SUM_TOL}·max|plain|")
    return err, scale


def _check_tie_robust(what, got, want) -> float:
    got, want = got.double(), want.double()
    scale = max(want.abs().max().item(), 1e-12)
    d = (got - want).abs() / scale
    beyond = (d > 1e-2 + 1e-2 * want.abs() / scale).double().mean().item()
    if not torch.isfinite(got).all() or beyond >= 5e-3 or d.mean() >= 3e-3:
        fail(f"{what}: {beyond:.4%} of elements beyond 1e-2 + 1e-2·|plain|,"
             f" mean scaled deviation {d.mean().item():.2e}")
    return (got - want).abs().max().item(), scale


def _errs(checks) -> dict:
    """The record fields of several ``(max |Δ|, max |plain|)`` checks."""
    return {"max_abs_err": max(e for e, _ in checks),
            "max_err_over_max_plain": max(e / max(s, 1e-30)
                                          for e, s in checks)}


def _train_inputs(sa, nx, pts, q, off, g):
    """One layer's train-kernel inputs, made with the plain versions: the
    bf16 h1, the folded BN rows of its batch statistics, an output
    gradient and the pass-1 sums pass 2 takes."""
    p, radius, k = sa.sa_params(), sa.radius, sa.n_samples
    q = q.bfloat16()
    idx, h1, cnt, psum = kft.bq_f1_plain(nx, pts, q, off, radius, k)
    b, m = nx.shape[:2]
    r = float(b * m * k)
    st1 = kfs._stack_stats(*kft._moments(psum, r), p.g1, p.b1)
    st2 = kfs._stack_stats(*kft._moments(kft.sa_tail_plain(
        2, h1, st1, None, None, p.w2, p.w3), r), p.g2, p.b2)
    st3 = kfs._stack_stats(*kft._moments(kft.sa_tail_plain(
        3, h1, st1, st2, None, p.w2, p.w3), r), p.g3, p.b3)
    dout = torch.randn((b, m, p.w3.shape[1]), generator=g, device=DEV)
    ps3, vecs, mats = kft.sa_bwd_p1_plain(h1, dout, st1, st2, st3, p.w2,
                                          p.w3)
    _, s2 = kft._combine_p1(ps3, vecs, mats, st3, p.w3, r)
    return dict(nx=nx, pts=pts, q=q, off=off, p=p, radius=radius, k=k,
                idx=idx, h1=h1, cnt=cnt, psum=psum, st=(st1, st2, st3),
                dout=dout, us=(ps3 / r, s2 / r))


def _train_layers(model, xyz, nrm):
    """SA1's and SA2's train-kernel inputs on the main path's data: SA2
    takes SA1's train-mode output, as in a train step."""
    g = torch.Generator(device=DEV).manual_seed(2)
    sa1, sa2 = model.sa1.fused, model.sa2.fused
    with torch.no_grad():
        nx1, q1, off1 = sa1.prepare(xyz, nrm)
        out1, _ = kft.fused_sa_bq_train(nx1, xyz, q1, off1, sa1.sa_params(),
                                        sa1.radius, sa1.n_samples)
        nx2, q2, off2 = sa2.prepare(nx1, out1)
        l1 = _train_inputs(sa1, nx1, xyz, q1, off1, g)
        l2 = _train_inputs(sa2, nx2, nx1, q2, off2, g)
        nx = l2["nx"].clone()
        nx[0, 0] = 50.0  # a center with no neighbour: cnt == 0
        l2e = _train_inputs(sa2, nx, nx1, q2, off2, g)
    return [("SA1", l1), ("SA2", l2), ("SA2 empty row", l2e)]


def _train_case(name, L, timed, route="bq"):
    """Each train kernel on one layer's inputs against its plain version:
    forward pass 1 by the layer's route (``"bq"``: the ball query inside;
    ``"idx"``: the pass that takes the ball query's idx), then the tails,
    p1 and p2. With ``timed``, kernel and plain times and the bounds.
    Returns ``{kernel: [records]}``."""
    p, (st1, st2, st3), k = L["p"], L["st"], L["k"]
    b, m, _, c1 = L["h1"].shape
    c2, c3 = p.w2.shape[1], p.w3.shape[1]
    n = L["pts"].shape[1]
    rows = b * m * k
    chain = 2.0 * rows * (c1 * c2 + c2 * c3)
    w_bytes = 2.0 * (c1 * c2 + c2 * c3)
    out = {}
    shape = {"B": b, "N": n, "M": m, "k": k, "widths": [c1, c2, c3]}

    def record(kernel, rec, fn, plain, flops_bf16, flops_f32, nbytes):
        if timed:
            rec["ms"] = time_ms(fn, 10)
            rec["plain_ms"] = time_ms(plain, 2, 1)
            rec["bound_ms"], rec["ops_ms"], rec["bytes_ms"] = bound(
                flops_bf16, flops_f32, nbytes)
        emit(f"kernel {kernel}", rec)
        out.setdefault(kernel, []).append(rec)

    with torch.no_grad():
        if route == "bq":
            f1_args = (L["nx"], L["pts"], L["q"], L["off"], L["radius"], k)
            idx, h1, cnt, psum = kft.bq_f1(*f1_args)
            torch.cuda.synchronize()
            if not (torch.equal(idx, L["idx"])
                    and torch.equal(cnt, L["cnt"])):
                fail(f"bq_f1 {name}: idx or cnt differ from the plain "
                     f"version")
        else:
            f1_args = (L["q"], L["off"], L["idx"])
            h1, psum = kft.sa_f1(*f1_args)
            cnt = L["cnt"]
            torch.cuda.synchronize()
        f1 = "bq_f1" if route == "bq" else "sa_f1"
        if not torch.equal(h1.view(torch.int16), L["h1"].view(torch.int16)):
            fail(f"{f1} {name}: h1 not bit-identical to the plain version")
        rec = {"case": name, **shape, "h1_bit_identical": True,
               **_errs([_check_sums(f"{f1} {name}", psum, L["psum"])]),
               "cnt_mean": cnt.float().mean().item(),
               "cnt_max": cnt.max().item(),
               "empty_rows": int((cnt == 0).sum().item())}
        # each input read once (q, off, and by route the clouds or idx),
        # h1 written once; h1 and its two sums 4 operations an element
        io = (2.0 * b * n * c1 + 4.0 * b * m * c1 + 2.0 * rows * c1
              + 4.0 * rows + 8.0 * c1)
        if route == "bq":
            rec["idx_cnt_bit_identical"] = True
            # full scan: ~10 f32 operations per (center, point)
            record("bq_f1", rec, lambda: kft.bq_f1(*f1_args),
                   lambda: kft.bq_f1_plain(*f1_args), 0.0,
                   10.0 * b * m * n + 4.0 * rows * c1,
                   io + 12.0 * b * (n + m) + 4.0 * b * m)
        else:
            record("sa_f1", rec, lambda: kft.sa_f1(*f1_args),
                   lambda: kft.sa_f1_plain(*f1_args), 0.0, 4.0 * rows * c1,
                   io)

        for stage in (2, 3, 4):
            args = (stage, L["h1"], st1, st2, st3, p.w2, p.w3)
            got = kft.sa_tail(*args)
            want = kft.sa_tail_plain(*args)
            torch.cuda.synchronize()
            if stage == 4:
                err = (got - want).abs()
                if (not torch.isfinite(got).all()
                        or not (err <= BQ_ATOL + BQ_RTOL * want.abs()).all()):
                    fail(f"sa_tail {name} out: max |Δ| {err.max().item()}")
                err = (err.max().item(), want.abs().max().item())
                out_bytes = 4.0 * b * m * c3
            else:
                err = _check_sums(f"sa_tail {name} stage {stage}", got, want)
                out_bytes = 8.0 * (c2 if stage == 2 else c3)
            flops = 2.0 * rows * c1 * c2 if stage == 2 else chain
            record(f"sa_tail_{stage}", {"case": f"{name} stage {stage}",
                                        **shape, **_errs([err])},
                   lambda: kft.sa_tail(*args),
                   lambda: kft.sa_tail_plain(*args), flops,
                   3.0 * rows * (c1 + c2 + (c3 if stage > 2 else 0)),
                   2.0 * rows * c1 + w_bytes + out_bytes)

        p1_args = (L["h1"], L["dout"], st1, st2, st3, p.w2, p.w3)
        got = kft.sa_bwd_p1(*p1_args)
        want = kft.sa_bwd_p1_plain(*p1_args)
        torch.cuda.synchronize()
        errs = [_check_tie_robust(f"sa_bwd_p1 {name} {w}", a, b_)
                for a, b_, w in zip(got, want, ("ps3", "vecs", "mats"))]
        record("sa_bwd_p1", {"case": name, **shape, **_errs(errs)},
               lambda: kft.sa_bwd_p1(*p1_args),
               lambda: kft.sa_bwd_p1_plain(*p1_args),
               chain + 2.0 * rows * (3 * c2) * (2 * c3),
               10.0 * rows * (c1 + c2 + c3),
               2.0 * rows * c1 + 4.0 * b * m * c3 + w_bytes
               + 4.0 * (2 * c3 + 3 * c2 + 6 * c2 * c3))

        p2_args = (L["h1"], L["dout"], L["idx"], st1, st2, st3, p.w2, p.w3,
                   *L["us"], n)
        got = kft.sa_bwd_p2(*p2_args)
        want = kft.sa_bwd_p2_plain(*p2_args)
        torch.cuda.synchronize()
        if not torch.equal(got[2][..., 2 * c1], want[2][..., 2 * c1]):
            fail(f"sa_bwd_p2 {name}: scatter counts differ")
        errs = [_check_tie_robust(f"sa_bwd_p2 {name} {w}", a, b_)
                for a, b_, w in zip(got, want,
                                    ("dw2", "ps1", "scat", "d1", "d2"))]
        record("sa_bwd_p2", {"case": name, **shape, **_errs(errs)},
               lambda: kft.sa_bwd_p2(*p2_args),
               lambda: kft.sa_bwd_p2_plain(*p2_args),
               chain + 2.0 * rows * (c3 * c2 + 2 * c1 * c2),
               12.0 * rows * (c1 + c2 + c3),
               2.0 * rows * c1 + 4.0 * b * m * c3 + 4.0 * rows + w_bytes
               + 4.0 * b * n * (2 * c1 + 1) + 8.0 * b * m * c1
               + 4.0 * (c1 * c2 + 2 * c1))
    return out


def phase_train_kernels(model, xyz, nrm):
    recs = {}
    for name, L in _train_layers(model, xyz, nrm):
        for kernel, rs in _train_case(name, L, timed="empty" not in name
                                      ).items():
            recs.setdefault(kernel, []).extend(rs)
    for rs in recs.values():
        rs[:] = [r for r in rs if "empty" not in r["case"]] + [
            r for r in rs if "empty" in r["case"]]
    return recs


# -------------------------------------------------------- MSG kernels


def _msg_scales(model, xyz, nrm):
    """``(name, layer, new_xyz, pts, q, off)`` of the six MSG scales on
    the main path's data; MSG2 takes MSG1's train-mode output, as in a
    train step."""
    def stage(tag, msg, pts, feats):
        nx = geometry.index_points(pts, kfps.fps(pts, msg.n_points))
        scales, outs = [], []
        for j, sa in enumerate(msg.scales):
            _, q, off = sa.prepare(pts, feats, nx)
            scales.append((f"{tag}/{j}", sa, nx, pts, q, off))
            if sa.fuses_ball_query(pts.shape[1]):
                out, _ = kft.fused_sa_bq_train(nx, pts, q, off,
                                               sa.sa_params(), sa.radius,
                                               sa.n_samples)
            else:
                idx, _ = kbq.ball_query(nx, pts, sa.radius, sa.n_samples)
                out, _ = kft.fused_sa_train(q, off, idx, sa.sa_params())
            outs.append(out)
        return scales, nx, torch.cat(outs, dim=-1)

    with torch.no_grad():
        s1, nx1, f1 = stage("MSG1", model.sa1, xyz, nrm)
        s2, _, _ = stage("MSG2", model.sa2, nx1, f1)
    return s1 + s2


def _ball_query_case(name, nx, pts, radius, k, timed, want=()):
    """The ball-query kernel against the plain version: idx and cnt
    bit-identical. ``want`` names row kinds the case must contain."""
    idx, cnt = kbq.ball_query(nx, pts, radius, k)
    widx, wcnt = kbq.ball_query_plain(nx, pts, radius, k)
    torch.cuda.synchronize()
    if not (torch.equal(idx, widx) and torch.equal(cnt, wcnt)):
        fail(f"ball_query {name}: {(idx != widx).sum().item()} indices and "
             f"{(cnt != wcnt).sum().item()} counts differ from the plain "
             f"version")
    b, m, _ = nx.shape
    n = pts.shape[1]
    kinds = {"empty": int((cnt == 0).sum()), "short": int((cnt < k).sum()),
             "cut": int((cnt > k).sum())}
    for kind in want:
        if kinds[kind] < 1:
            fail(f"ball_query {name}: the case holds no {kind} row")
    rec = {"case": name, "B": b, "N": n, "M": m, "k": k, "radius": radius,
           "bit_identical": True, "max_abs_err": 0.0,
           "cnt_mean": cnt.float().mean().item(), "cnt_max": cnt.max().item(),
           "rows": kinds}
    if timed:
        rec["ms"] = time_ms(lambda: kbq.ball_query(nx, pts, radius, k), 20)
        rec["plain_ms"] = time_ms(
            lambda: kbq.ball_query_plain(nx, pts, radius, k), 3, 1)
        # every (center, point) pair is tested: cnt counts all hits
        rec["bound_ms"], rec["ops_ms"], rec["bytes_ms"] = bound(
            0.0, 10.0 * b * m * n, 12.0 * b * (m + n) + 4.0 * b * m * (k + 1))
    emit("kernel ball_query", rec)
    return rec


def _eval_idx_case(name, sa, q, off, idx, cnt, timed):
    """The eval kernel that takes a given idx against its plain version,
    with the ball query's cnt (the main path) and without."""
    p, s = sa.sa_params(), sa.sa_stats()
    with torch.no_grad():
        want = kfs.fused_sa_eval_plain(q, off, idx, p, s)
        errs = []
        for c in (cnt, None):
            got = kfs.fused_sa_eval(q, off, idx, p, s, cnt=c)
            torch.cuda.synchronize()
            err = (got - want).abs()
            if (not torch.isfinite(got).all()
                    or not (err <= BQ_ATOL + BQ_RTOL * want.abs()).all()):
                fail(f"fused_sa_eval {name} (cnt "
                     f"{'given' if c is not None else 'absent'}): max |err| "
                     f"{err.max().item()} beyond {BQ_ATOL} + "
                     f"{BQ_RTOL}·|plain|")
            errs.append(err.max().item())
    b, m, k = idx.shape
    n, c1 = q.shape[1:]
    c2, c3 = p.w2.shape[1], p.w3.shape[1]
    live = torch.clamp(cnt, 1, k).sum().item()
    rec = {"case": name, "B": b, "N": n, "M": m, "k": k,
           "widths": [c1, c2, c3], "max_abs_err": max(errs),
           "max_abs_err_without_cnt": errs[1],
           "max_abs_plain": want.abs().max().item(),
           "cnt_mean": cnt.float().mean().item(),
           "empty_rows": int((cnt == 0).sum().item()),
           "live_slots": int(live)}
    if timed:
        with torch.no_grad():
            rec["ms"] = time_ms(
                lambda: kfs.fused_sa_eval(q, off, idx, p, s, cnt=cnt), 20)
            rec["ms_without_cnt"] = time_ms(
                lambda: kfs.fused_sa_eval(q, off, idx, p, s), 10)
            rec["plain_ms"] = time_ms(
                lambda: kfs.fused_sa_eval_plain(q, off, idx, p, s), 3, 1)
        # the products over the live slots (what cnt leaves to do)
        rec["bound_ms"], rec["ops_ms"], rec["bytes_ms"] = bound(
            2.0 * live * (c1 * c2 + c2 * c3), 0.0,
            2.0 * b * n * c1 + 4.0 * b * m * c1 + 4.0 * b * m * (k + 1)
            + 2.0 * (c1 * c2 + c2 * c3) + 4.0 * b * m * c3)
    emit("kernel fused_sa_eval", rec)
    return rec


def phase_msg_kernels(model, xyz, nrm):
    """``{kernel: [records]}`` of every kernel on the MSG path at the six
    scales' shapes, timed, plus the edge cases, untimed."""
    g = torch.Generator(device=DEV).manual_seed(4)
    recs = {}

    def add(kernel, rec):
        recs.setdefault(kernel, []).append(rec)

    def empty_row(nx):
        nx = nx.clone()
        nx[0, 0] = 50.0  # a center with no neighbour: cnt == 0
        return nx

    for name, sa, nx, pts, q, off in _msg_scales(model, xyz, nrm):
        r, k = sa.radius, sa.n_samples
        route = "bq" if sa.fuses_ball_query(pts.shape[1]) else "idx"
        qb = q.bfloat16()
        if route == "bq":
            add("fused_sa_bq_eval",
                _bq_case(f"{name} serving", sa, (nx, pts, qb, off), True))
        else:
            add("ball_query", _ball_query_case(name, nx, pts, r, k, True,
                                               want=("short",)))
            _ball_query_case(f"{name} empty row", empty_row(nx), pts, r, k,
                             False, want=("empty",))
            idx, cnt = kbq.ball_query_plain(nx, pts, r, k)
            add("fused_sa_eval",
                _eval_idx_case(name, sa, qb, off, idx, cnt, True))
            idx, cnt = kbq.ball_query_plain(empty_row(nx), pts, r, k)
            _eval_idx_case(f"{name} empty row", sa, qb, off, idx, cnt, False)
        with torch.no_grad():
            cases = [(name, nx, True)]
            if name == "MSG1/2":  # a center spans two 64-row tiles here
                cases.append((f"{name} empty row", empty_row(nx), False))
            for case, centers, timed in cases:
                L = _train_inputs(sa, centers, pts, q, off, g)
                if "empty" in case and int((L["cnt"] == 0).sum()) < 1:
                    fail(f"{case}: the case holds no empty row")
                for kernel, rs in _train_case(case, L, timed, route).items():
                    recs.setdefault(kernel, []).extend(rs)
                del L
    # N not a multiple of 32 with rows cut at k, and every point a hit
    odd = xyz[:4, :1000].contiguous()
    _ball_query_case("N=1000 k=16", odd[:, :70], odd, 0.2, 16, False,
                     want=("cut", "short"))
    _ball_query_case("every point a hit", odd[:, :64], odd, 4.0, 8, False,
                     want=("cut",))
    _ball_query_case("k > N", odd[:, :33, :], odd[:, :100].contiguous(), 0.3,
                     128, False, want=("short",))
    return recs


# -------------------------------------------------------------- train


def phase_train(name, variables, power, batch_size, per_step):
    clouds, normals, labels = SyntheticModelNet(
        n_points=N_POINTS, size=batch_size, seed=5).batch(0, batch_size)
    batch = {"xyz": torch.from_numpy(clouds).to(DEV),
             "feats": torch.from_numpy(normals).to(DEV),
             "label": torch.from_numpy(labels).long().to(DEV)}
    model = get_cls_model(name)
    from_jax_variables(model, variables)
    # ModelNet40's training set
    lr = reference_flat_lr(0.02, 9840, batch_size)
    step = make_cls_train_step(model, sgd_momentum(model.parameters(), lr))
    gen = torch.Generator(device=DEV).manual_seed(0)
    losses = [step(batch, gen)["loss"] for _ in range(WARMUP_STEPS)]
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        losses.append(step(batch, gen)["loss"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _read_counts(f"{name} train", per_step, TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()

    losses = [x.item() for x in losses]
    if not all(np.isfinite(losses)):
        fail(f"train losses not finite: {losses}")
    after = model.state_dict()
    still = [k for k, v in before.items() if v.dtype.is_floating_point
             and torch.equal(v, after[k])]
    # SA3's last BN bias gets no gradient: the head's BN cancels a shift
    if [k for k in still if k != "sa3.mlp.2.bn.bias"]:
        fail(f"train steps left these unchanged: {still}")

    check = grad_agreement(name, variables,
                           {k: v[:CHECK_CLOUDS] for k, v in batch.items()},
                           DEV)
    agree = check["agree"]
    emit(f"train {name}", {
        "samples_per_s": batch_size * TRAIN_STEPS / secs,
        "step_ms": 1e3 * secs / TRAIN_STEPS, "batch": batch_size,
        "n_points": N_POINTS, "steps": TRAIN_STEPS, "lr": lr, "card": power,
        "launches": launches, "peak_device_bytes": peak, "losses": losses,
        "check_clouds": CHECK_CLOUDS, "loss_card": check["loss"],
        "loss_cpu": check["loss_cpu"],
        "worst_grad_cos": min(agree.items(), key=lambda kv: kv[1][0]),
        "worst_grad_norm_ratio": max(agree.items(),
                                     key=lambda kv: abs(kv[1][1] - 1)),
        "grads_not_compared": check["not_compared"],
        "grad_cos_and_norm_ratio": agree})
    if check["failures"]:
        fail(f"{name}: card vs CPU on {CHECK_CLOUDS} clouds (loss within "
             f"{LOSS_RTOL}, cosine at least {GRAD_COS}, norm within "
             f"{GRAD_NORM[name]}): {check['failures']}")
    return launches


# TPU kernel replaced: (entry name, source, file:line, key of its records
# and of its launch count)
KERNELS = (
    ("fps", "fps.cu", PALLAS + "fps.py:39", "fps"),
    ("ball_query", "ball_query.cu", PALLAS + "neighbors.py:104",
     "ball_query"),
    ("fused_sa_bq_eval", "fused_sa_bq_eval.cu", FUSED_SA + ":1269",
     "fused_sa_bq_eval"),
    ("fused_sa_eval", "fused_sa_eval.cu", FUSED_SA + ":667",
     "fused_sa_eval"),
    ("bq_f1", "fused_sa_bq_f1.cu", FUSED_SA + ":1131", "bq_f1"),
    ("sa_f1", "fused_sa_f1.cu", FUSED_SA + ":455", "sa_f1"),
    ("sa_tail_stats2", "fused_sa_tail.cu", FUSED_SA + ":566", "sa_tail_2"),
    ("sa_tail_stats3", "fused_sa_tail.cu", FUSED_SA + ":603", "sa_tail_3"),
    ("sa_tail_out", "fused_sa_tail.cu", FUSED_SA + ":635", "sa_tail_4"),
    ("sa_bwd_p1", "fused_sa_bwd_p1.cu", FUSED_SA + ":752", "sa_bwd_p1"),
    ("sa_bwd_p2", "fused_sa_bwd_p2.cu", FUSED_SA + ":824", "sa_bwd_p2"),
)


def _kernel_entry(name, source, replaces, recs, paths):
    """One entry of the ``kernels`` line: launches summed over the main
    paths (each also given by path), times and bounds summed over the
    timed cases, the largest error over all cases."""
    timed = [r for r in recs if "ms" in r]
    ops = sum(r["ops_ms"] for r in timed)
    byt = sum(r["bytes_ms"] for r in timed)
    return {"name": name, "route": "cuda", "source": CSRC + source,
            "replaces": replaces, "launches": sum(paths.values()),
            "launches_by_path": paths,
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": sum(r["ms"] for r in timed),
            "plain_ms": sum(r["plain_ms"] for r in timed),
            "bound_ms": sum(r["bound_ms"] for r in timed),
            "bound_by": "operations" if ops >= byt else "bytes",
            "library_ms": None, "timed_cases": [r["case"] for r in timed]}


def _model_on_card(name, variables):
    model = get_cls_model(name)
    from_jax_variables(model, variables)
    return model.to(DEV).eval()


def main() -> None:
    power = phase_device()
    phase_build()

    ssg_vars = random_jax_variables(get_cls_model("pointnet2"), seed=0)
    msg_vars = random_jax_variables(get_cls_model("pointnet2_msg"), seed=0)
    clouds, normals, _ = SyntheticModelNet(
        n_points=N_POINTS, size=N_CLOUDS, seed=0).batch(0, N_CLOUDS)
    xyz = torch.from_numpy(clouds[:BATCH]).to(DEV)
    nrm = torch.from_numpy(normals[:BATCH]).to(DEV)

    model = _model_on_card("pointnet2", ssg_vars)
    fps_recs, bq_recs = phase_kernels(model, xyz, nrm)
    recs = phase_train_kernels(model, xyz, nrm)
    recs["fps"] = fps_recs
    recs["fused_sa_bq_eval"] = bq_recs
    del model
    msg_recs = phase_msg_kernels(_model_on_card("pointnet2_msg", msg_vars),
                                 xyz[:MSG_BATCH], nrm[:MSG_BATCH])
    for kernel, rs in msg_recs.items():
        recs.setdefault(kernel, []).extend(rs)
    torch.cuda.empty_cache()

    cnt = {"ball_query_cnt": {r["case"].split()[0]: {
        "mean": r["cnt_mean"], "max": r["cnt_max"]} for r in bq_recs}}
    paths = {
        "ssg_serving": phase_serving("pointnet2", ssg_vars,
                                     (clouds, normals), power, BATCH,
                                     SSG_SERVE, cnt),
        "msg_serving": phase_serving("pointnet2_msg", msg_vars,
                                     (clouds, normals), power, MSG_BATCH,
                                     MSG_SERVE, {}),
        "ssg_train": phase_train("pointnet2", ssg_vars, power, BATCH,
                                 SSG_STEP),
        "msg_train": phase_train("pointnet2_msg", msg_vars, power,
                                 MSG_BATCH, MSG_STEP),
    }

    kernels = []
    for name, source, replaces, key in KERNELS:
        entry = _kernel_entry(name, source, replaces, recs[key],
                              {p: c[key] for p, c in paths.items()})
        if entry["launches"] < 1 or not entry["timed_cases"]:
            fail(f"{name}: never launched on a main path, or never timed")
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(power, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
