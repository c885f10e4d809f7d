#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line or more; any failure exits non-zero at
once:

1. device — the card's name, the device count and ``nvidia-smi``'s name
   and power limit;
2. build — the six kernels compiled from ``pointcloudlib_tpu_torch/csrc``
   (one ``nvcc`` per source, started together), with seconds and the
   ``-Xptxas -v`` registers, shared memory and spills of each kernel;
3. kernels — the serving kernels against their plain PyTorch versions on
   the card, at the serving shapes (FPS 1024→512 and 512→128, fused
   ball-query SA eval at SA1 and SA2, B=64) and at edge cases
   (near-origin points, m = N, N not a multiple of 32, an empty
   ball-query row): FPS must be bit-identical, the SA eval within
   |Δ| ≤ 1e-2 + 1e-2·|plain| (the same bf16 roundings, f32 sums in
   another order); kernel and plain times from CUDA events;
4. train kernels — the four train-mode fused SA kernels against their
   plain versions at the SA1 and SA2 train shapes of the main path (B=64,
   from the model's own inputs) and with an empty ball-query row:
   f1's idx, cnt and h1 bit-identical, every Σ/Σ² within 1e-3 of its
   largest element (f32 atomics in another order), the pooled output
   within 1e-2 + 1e-2·|plain|, the backward passes tie-robust (fewer than
   0.5 % of elements beyond 1e-2 + 1e-2·|plain|, mean deviation below
   3e-3, both scaled by max|plain|: a last-bit change can move a
   max-pool tie share); kernel and plain times;
5. serving — PointNet++ SSG at full width with seeded random weights in
   the JAX fused layout, loaded through ``from_jax_variables``, serving
   256 synthetic surface clouds with normals at N=1024 through
   ``Predictor(batch_size=64)`` three times, plus one request at N=1000
   (bucket padding). Every launch count is zeroed just before and read
   just after; each serving kernel must launch twice per served batch.
   The probabilities must be finite rows summing to 1, and 8 clouds must
   agree with the same Predictor on the CPU within 5e-3 (the card runs
   the dense layers with bf16 operands, the CPU in f32);
6. train — the same weights and SGD with momentum 0.9 at the reference's
   flat lr through ``make_cls_train_step`` on 64 labelled synthetic
   clouds at N=1024: 2 warm-up steps, then 10 timed steps (samples/s on
   the host clock, with the card's name and power limit), counts zeroed
   just before the timed steps: per step exactly 2 launches of FPS, f1,
   p1 and p2, 6 of the tail, none of the eval kernel. Every loss finite,
   parameters and running statistics moved. Then one forward and
   backward on 8 clouds on the card and on the CPU from the same weights
   with dropout 0: the loss within 1e-2 relative, and each parameter's
   gradient against the CPU's within the cosine and norm-ratio bounds
   ``GRAD_COS``/``GRAD_NORM``.

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
from pointcloudlib_tpu_torch.ops.kernels import fused_sa_train as kft
from pointcloudlib_tpu_torch.train import (
    make_cls_train_step,
    reference_flat_lr,
    sgd_momentum,
    soft_cross_entropy,
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
BQ_ATOL = BQ_RTOL = 1e-2
PROB_ATOL = 5e-3
SUM_TOL = 1e-3                 # Σ/Σ² of the train kernels, × max|plain|
TRAIN_STEPS, WARMUP_STEPS, CHECK_CLOUDS = 10, 2, 8
# card vs CPU gradients: each parameter's cosine ≥ GRAD_COS and norm
# ratio within GRAD_NORM of 1. A last-bit difference (bf16 dense operands
# on the card, f32 sums in other orders) can move a max-pool's winner and
# reroute that point's gradient; measured on an H100 over four calls:
# cosine ≥ 0.947, norm ratios within 8.3 %
LOSS_RTOL, GRAD_COS, GRAD_NORM = 1e-2, 0.85, 0.15
CSRC = "pointcloudlib_tpu_torch/csrc/"
SOURCES = ("fps", "fused_sa_bq_eval") + kft.SOURCES
FUSED_SA = "pointcloudlib_tpu/ops/pallas/fused_sa.py"
FPS_PALLAS = "pointcloudlib_tpu/ops/pallas/fps.py:39"


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


def _train_case(name, L, timed):
    """Each train kernel on one layer's inputs against its plain version;
    with ``timed``, kernel and plain times and the bounds. Returns
    ``{kernel: [records]}``."""
    p, (st1, st2, st3), k = L["p"], L["st"], L["k"]
    b, m, _, c1 = L["h1"].shape
    c2, c3 = p.w2.shape[1], p.w3.shape[1]
    n = L["pts"].shape[1]
    rows = b * m * k
    chain = 2.0 * rows * (c1 * c2 + c2 * c3)
    w_bytes = 2.0 * (c1 * c2 + c2 * c3)
    out = {}

    def record(kernel, rec, fn, plain, flops_bf16, flops_f32, nbytes):
        if timed:
            rec["ms"] = time_ms(fn, 10)
            rec["plain_ms"] = time_ms(plain, 2, 1)
            rec["bound_ms"], rec["ops_ms"], rec["bytes_ms"] = bound(
                flops_bf16, flops_f32, nbytes)
        emit(f"kernel {kernel}", rec)
        out.setdefault(kernel, []).append(rec)

    with torch.no_grad():
        f1_args = (L["nx"], L["pts"], L["q"], L["off"], L["radius"], k)
        idx, h1, cnt, psum = kft.bq_f1(*f1_args)
        torch.cuda.synchronize()
        if not (torch.equal(idx, L["idx"]) and torch.equal(cnt, L["cnt"])):
            fail(f"bq_f1 {name}: idx or cnt differ from the plain version")
        if not torch.equal(h1.view(torch.int16), L["h1"].view(torch.int16)):
            fail(f"bq_f1 {name}: h1 not bit-identical to the plain version")
        rec = {"case": name, "B": b, "N": n, "M": m, "k": k,
               "widths": [c1, c2, c3], "idx_cnt_h1_bit_identical": True,
               **_errs([_check_sums(f"bq_f1 {name}", psum, L["psum"])]),
               "cnt_mean": cnt.float().mean().item(),
               "cnt_max": cnt.max().item(),
               "empty_rows": int((cnt == 0).sum().item())}
        # full scan: ~10 f32 operations per (center, point); h1 and its
        # two sums 4 per element
        record("bq_f1", rec, lambda: kft.bq_f1(*f1_args),
               lambda: kft.bq_f1_plain(*f1_args), 0.0,
               10.0 * b * m * n + 4.0 * rows * c1,
               12.0 * b * (n + m) + 2.0 * b * n * c1 + 4.0 * b * m * c1
               + 2.0 * rows * c1 + 4.0 * rows + 4.0 * b * m + 8.0 * c1)

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
            record("sa_tail", {"case": f"{name} stage {stage}",
                               **_errs([err])},
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
        record("sa_bwd_p1", {"case": name, **_errs(errs)},
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
        record("sa_bwd_p2", {"case": name, **_errs(errs)},
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


# -------------------------------------------------------------- train

COUNTED = {"fps": kfps.fps, "fused_sa_bq_eval": kfs.fused_sa_bq_eval,
           "bq_f1": kft.bq_f1, "sa_tail": kft.sa_tail,
           "sa_bwd_p1": kft.sa_bwd_p1, "sa_bwd_p2": kft.sa_bwd_p2}
PER_STEP = {"fps": 2, "fused_sa_bq_eval": 0, "bq_f1": 2, "sa_tail": 6,
            "sa_bwd_p1": 2, "sa_bwd_p2": 2}


def _grads(variables, batch, dev):
    """Loss and per-parameter gradients of one train-mode forward and
    backward on ``dev`` with dropout 0."""
    model = get_cls_model("pointnet2", dropout=0.0)
    from_jax_variables(model, variables)
    model = model.to(dev).train()
    logits = model(batch["xyz"].to(dev), batch["feats"].to(dev))
    loss = soft_cross_entropy(logits, batch["label"].to(dev))
    loss.backward()
    return loss.item(), {k: p.grad.double().cpu() for k, p in
                         model.named_parameters()}


def _grad_agreement(variables, batch):
    """``(card loss, CPU loss, {param: (cosine, norm ratio)})`` of one
    train-mode forward and backward on the card and on the CPU."""
    loss_card, card = _grads(variables, batch, DEV)
    loss_cpu, grads_cpu = _grads(variables, batch, torch.device("cpu"))
    # SA3's last BN bias has no gradient (the head's BN cancels a
    # constant shift): skip gradients that are rounding noise
    floor = 1e-6 * max(float(g.norm()) for g in grads_cpu.values())
    agree = {}
    for k, g in grads_cpu.items():
        gc = card[k]
        if g.norm() > floor:
            agree[k] = (float(gc.ravel() @ g.ravel() / (gc.norm() * g.norm())),
                        float(gc.norm() / g.norm()))
    return loss_card, loss_cpu, agree


def phase_train(variables, power):
    clouds, normals, labels = SyntheticModelNet(
        n_points=N_POINTS, size=BATCH, seed=5).batch(0, BATCH)
    batch = {"xyz": torch.from_numpy(clouds).to(DEV),
             "feats": torch.from_numpy(normals).to(DEV),
             "label": torch.from_numpy(labels).long().to(DEV)}
    model = get_cls_model("pointnet2")
    from_jax_variables(model, variables)
    lr = reference_flat_lr(0.02, 9840, BATCH)  # ModelNet40's training set
    step = make_cls_train_step(model, sgd_momentum(model.parameters(), lr))
    gen = torch.Generator(device=DEV).manual_seed(0)
    losses = [step(batch, gen)["loss"] for _ in range(WARMUP_STEPS)]
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}

    torch.cuda.synchronize()
    for fn in COUNTED.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        losses.append(step(batch, gen)["loss"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in COUNTED.items()}

    for name, per in PER_STEP.items():
        if launches[name] != per * TRAIN_STEPS:
            fail(f"{name} launched {launches[name]} times in {TRAIN_STEPS} "
                 f"train steps; expected {per * TRAIN_STEPS}")
    losses = [x.item() for x in losses]
    if not all(np.isfinite(losses)):
        fail(f"train losses not finite: {losses}")
    after = model.state_dict()
    still = [k for k, v in before.items() if v.dtype.is_floating_point
             and torch.equal(v, after[k])]
    # SA3's last BN bias gets no gradient: the head's BN cancels a shift
    if [k for k in still if k != "sa3.mlp.2.bn.bias"]:
        fail(f"train steps left these unchanged: {still}")

    check = {k: v[:CHECK_CLOUDS] for k, v in batch.items()}
    loss_card, loss_cpu, agree = _grad_agreement(variables, check)
    worst_cos = min(agree.items(), key=lambda kv: kv[1][0])
    worst_norm = max(agree.items(), key=lambda kv: abs(kv[1][1] - 1))
    emit("train", {
        "samples_per_s": BATCH * TRAIN_STEPS / secs,
        "step_ms": 1e3 * secs / TRAIN_STEPS, "batch": BATCH,
        "n_points": N_POINTS, "steps": TRAIN_STEPS, "lr": lr, "card": power,
        "launches": launches, "losses": losses,
        "check_clouds": CHECK_CLOUDS, "loss_card": loss_card,
        "loss_cpu": loss_cpu, "worst_grad_cos": worst_cos,
        "worst_grad_norm_ratio": worst_norm,
        "grad_cos_and_norm_ratio": agree})
    if abs(loss_card - loss_cpu) > LOSS_RTOL * abs(loss_cpu):
        fail(f"card vs CPU loss {loss_card} vs {loss_cpu}")
    for k, (cos, ratio) in agree.items():
        if cos < GRAD_COS or abs(ratio - 1) > GRAD_NORM:
            fail(f"card vs CPU gradient of {k}: cosine {cos}, norm ratio "
                 f"{ratio}")
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
    train_recs = phase_train_kernels(model, xyz, nrm)

    launches = phase_serving(variables, (clouds, normals), power, bq_recs)
    train_launches = phase_train(variables, power)

    kernels = [
        _kernel_entry("fps", CSRC + "fps.cu", FPS_PALLAS,
                      launches["fps"], fps_recs, 0),
        _kernel_entry("fused_sa_bq_eval", CSRC + "fused_sa_bq_eval.cu",
                      f"{FUSED_SA}:1269", launches["fused_sa_bq_eval"],
                      bq_recs, max(r["max_abs_err"] for r in bq_recs)),
    ]
    for name, source, line in (
            ("bq_f1", "fused_sa_bq_f1.cu", 1131),
            ("sa_tail", "fused_sa_tail.cu", "566,603,635"),
            ("sa_bwd_p1", "fused_sa_bwd_p1.cu", 752),
            ("sa_bwd_p2", "fused_sa_bwd_p2.cu", 824)):
        recs = train_recs[name]
        kernels.append(_kernel_entry(
            name, CSRC + source, f"{FUSED_SA}:{line}",
            train_launches[name], [r for r in recs if "ms" in r],
            max(r["max_abs_err"] for r in recs)))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(power, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
