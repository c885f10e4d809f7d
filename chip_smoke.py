#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line or more; any failure exits non-zero at
once:

1. device — the card's name, the device count and ``nvidia-smi``'s name
   and power limit;
2. build — the twenty-five kernel sources of ``pointcloudlib_tpu_torch/csrc``
   compiled (one ``nvcc`` per source, started together), with seconds and
   the ``-Xptxas -v`` registers, shared memory and spills of each kernel;
3. kernels — the SSG serving kernels against their plain PyTorch versions
   on the card, at the serving shapes (FPS 1024→512 and 512→128, fused
   ball-query SA eval at SA1 and SA2, B=64) and at edge cases
   (near-origin points, m = N, N not a multiple of 32, duplicated
   points, an empty ball-query row): FPS must be bit-identical, the SA
   eval within |Δ| ≤ 1e-2 + 1e-2·|plain| (the same bf16 roundings, f32
   sums in another order); kernel and plain times from CUDA events, the SA eval
   kernel's a device time from CUDA graphs (the event loop's launch rate
   and, as ``cuda_core_graph_ms``, the device time of the CUDA-core
   kernel it replaced, from ``CUDA_CORE_EVAL_MS``, beside it; the same
   for the eval kernel that takes an idx in phases 5 and 14);
4. train kernels — the train-mode fused SA kernels against their plain
   versions at the SA1 and SA2 train shapes of the SSG path (B=64, from
   the model's own inputs) and with an empty ball-query row: f1's idx,
   cnt and h1 bit-identical, every Σ/Σ² within 1e-3 of its largest
   element (f32 atomics in another order), the pooled output within
   1e-2 + 1e-2·|plain|, the backward passes tie-robust (fewer than 0.5 %
   of elements beyond 1e-2 + 1e-2·|plain|, mean deviation below 3e-3,
   both scaled by max|plain|: a last-bit change can move a max-pool tie
   share); kernel and plain times (pass 1, the tails, ``sa_bwd_p1`` and
   ``sa_bwd_p2``: device times from CUDA graphs; beside p1's and p2's the
   device times of the CUDA-core versions they replaced at the same case
   as ``cuda_core_graph_ms``, from ``CUDA_CORE_BWD_MS``);
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
   and of p2, none of an eval kernel; peak device memory reported;
8. part-segmentation kernels — PointNet++ part segmentation at full width
   (B=16, N=2048, xyz as features, 16 ShapeNet-part-shaped synthetic
   clouds, seeded random weights): FPS 2048→512 and 512→128, the
   ball-query eval, pass-1, tail, p1 and p2 kernels at SA1 and SA2 under
   the bounds above; the 3-NN interpolation at FP2 and FP1 (idx
   bit-identical, w and out within 1e-6·max|plain|) and the row
   scatter-add at both backward shapes (within 1e-5·max|plain|; f32
   atomics in another order), with ``index_add_`` timed beside it
   (device times from CUDA graphs; the event loop's launch rate kept
   beside them); edge
   cases: supports of 36 and 100 points, duplicate support points,
   queries equal to support points (a hard copy of the feature) and
   scatter indices at or beyond n (dropped);
9. part-segmentation serving — ``SegPredictor(batch_size=16)`` on 64
   clouds, three requests: per served batch exactly 2 launches of FPS, 2
   of the ball-query eval kernel and 2 of the 3-NN interpolation, none of
   any other kernel; then 2 clouds on the card and on the CPU:
   probabilities within 5e-3 and part ids equal wherever the top two
   probabilities differ by more than 1e-2;
10. part-segmentation train — ``make_seg_train_step`` at B=16 with SGD
   (momentum 0.9, lr 0.01): 2 warm-up and 10 timed steps, per step
   exactly 2 launches of FPS, f1, p1, p2, the 3-NN interpolation and the
   scatter-add, 6 of the tail; losses finite, parameters and running
   statistics moved, peak memory; then the card-vs-CPU loss and gradient
   check on 8 clouds;
11. DGCNN kernels — DGCNN classification at full width (B=32, N=1024,
   k=20, xyz only, seeded random weights): each of its four EdgeConvs'
   inputs, from a served batch and from a train step, into the four
   fused EdgeConv kernels against their plain versions: the kNN inside
   ``edge_knn_eval`` and ``edge_knn_f1`` bit-identical (f1's idx and
   bf16 h), ``edge_knn_eval`` and ``edge_out`` within 1e-5·max|plain|,
   f1's Σ/Σ² and ``edge_bwd``'s sums, scatter and assembled dq, doff, dγ,
   dβ within 1e-3·max|plain| (f32 atomics in another order), its scatter
   counts exact; ``torch.topk`` of the same d² timed as a yardstick of
   the selection alone; edge cases: duplicate points (exact kNN and
   max-pool ties) and N = 65, one past the 64-point candidate tile
   (``edge_knn_f1`` and ``edge_knn_eval`` take their select route at the
   layers' shapes and their block route at the edge cases' small grids,
   ``knn.edge_f1_route``, ``knn.edge_eval_route``; the eval kernel's
   lines name the route);
12. DGCNN serving — ``Predictor(batch_size=32)`` as in phase 6: exactly
   4 launches of ``edge_knn_eval`` per served batch;
13. DGCNN train — ``make_cls_train_step`` at B=32 with SGD (momentum 0.9,
   lr 0.1 flat, ``bench.py:168``) as in phase 7: per step exactly 4
   launches of ``edge_knn_f1``, ``edge_out`` and ``edge_bwd``; then the
   card-vs-CPU loss and gradient check on 8 clouds;
14. N=4096 kernels — PointNet++ SSG at B=32, N=4096 with normals
   (``bench.py:336-337``), the batch Hilbert-sorted as the step sorts it:
   the keys and order on the card bit-identical to the CPU's (also on
   clouds of 3,000 points padded to 4096); FPS, the ball query, the
   given-index pass 1, eval kernel and p2 at SA1 (which stand for the
   JAX package's windowed ``_k_f1w``, ``_k_evalw``, ``_k_p2w``), the
   tails and p1 at SA1, SA2's kernels with the ball query inside, under
   the bounds above;
15. kNN-route kernels — DGCNN's four EdgeConvs at N % 128 ≠ 0 (serving
   B=32, N=10,000; training B=32, N=1,000): ``knn`` idx and d²
   bit-identical to the plain version (``torch.cdist`` + ``torch.topk``
   timed as the library's yardstick, two calls; each record names the
   route the wrapper took, ``knn.knn_route``), ``edge_eval`` within
   1e-5·max|plain| (its plain version taken 8 clouds at a time),
   ``edge_f1``'s h bit-identical, ``edge_out`` and ``edge_bwd`` as in
   phase 11; edge cases: duplicate points, k = N, a query cloud of its
   own, N=16,384 at C=128;
16. main paths at N=4096 and N % 128 ≠ 0 — ``Predictor(batch_size=32)``
   serving SSG on 96 clouds of 4096 points and 32 of 3,000, per batch
   exactly 2 launches of FPS and 1 of the ball query, the eval kernel
   that takes its idx and the ball-query eval kernel; SSG's train step at
   B=32, N=4096: per step 2 of FPS, 1 of the ball query, ``sa_f1`` and
   ``bq_f1``, 6 of the tail, 2 of p1 and p2; DGCNN serving 64 clouds of
   10,000 points: 4 of ``knn`` and ``edge_eval`` a batch; DGCNN's train
   step at N=1,000: 4 of ``knn``, ``edge_f1``, ``edge_out`` and
   ``edge_bwd`` a step; card against CPU as in phases 6 and 7;
17. DGCNN part-segmentation kernels — DGCNN part segmentation at full
   width (B=16, N=2048, k=40, xyz only, 16 synthetic ShapeNet-part clouds,
   seeded random weights): both two-layer EdgeConv pairs' inputs (C_in 3
   and 64), from a served batch and from a train step, into the six
   two-layer kernels and pass 1 against their plain versions:
   ``edge2_knn_eval`` (its route named: the select route and the chain
   on the tensor cores at N=2048) and ``edge2_out`` within
   1e-5·max|plain| (the neighbour lists and y1 are bit-identical, h2
   sums in another order),
   pass 1's idx and h bit-identical, ``edge2_stats2``'s Σ/Σ² and
   ``edge2_p1``'s ps2, vecs and mats within 1e-3·max|plain| (its timed
   records with a device time by CUDA graphs), ``edge2_p2``'s
   dq and doff tie-robust; EC3's four EdgeConv kernels at k=40 as in phase
   11; edge cases: duplicate points, a small grid (``edge2_knn_eval``'s
   block route), and the route at N % 128 ≠ 0 (N=1,000: the kNN,
   ``edge2_eval`` timed, ``edge_f1`` and the train kernels);
18. DGCNN part-segmentation serving — ``SegPredictor(batch_size=16)`` on
   64 clouds at N=2048, three requests: per served batch exactly 2
   launches of ``edge2_knn_eval`` and 1 of ``edge_knn_eval``; 4 clouds on
   the card against the CPU (probabilities within 5e-3, ids equal where
   the top two differ by more than 1e-2); then, untimed, 2 clouds of
   5,000 points (kept N, the kNN route): exactly 3 launches of ``knn``, 2
   of ``edge2_eval`` and 1 of ``edge_eval``, card against CPU;
19. DGCNN part-segmentation train — ``make_seg_train_step`` at B=16,
   N=2048 with SGD (momentum 0.9, lr 0.01): 2 warm-up and 10 timed steps,
   per step exactly 3 launches of ``edge_knn_f1``, 2 of ``edge2_stats2``,
   ``edge2_out``, ``edge2_p1`` and ``edge2_p2``, 1 of ``edge_out`` and
   ``edge_bwd``; the card-vs-CPU gradient check on 8 clouds; then B=4 at
   N=1,000 (the kNN, ``edge_f1`` and the same train kernels), with its
   launch counts;
20. N=4096 checks, untimed — MSG, PointNet++ and DGCNN part segmentation
   (Hilbert-sorted, ids back in the caller's point order) and DGCNN (kNN
   inside the kernels) on 2 clouds: exact launch counts, probabilities
   within 5e-3 of the CPU's;
21. PointConv kernels — the row gather and the fused kNN + gather at the
   shapes of PointConv classification (B=32, N=1024, normals: SA1's two
   gathers, SA2's k=64 kNN + gather) and part segmentation (B=16, N=2048:
   SA2's and SA3's kNN + gather, the three decoders' gathers), their
   inputs recorded from the models' own eval forward with seeded weights,
   against their plain versions: idx and values bit-identical;
   ``torch.gather`` and ``torch.cdist`` + ``torch.topk`` +
   ``torch.gather`` timed as the library's yardsticks; kernel, plain and
   library times are device times, from CUDA graphs of repeated calls
   (the kernels are shorter than a launch's host cost; the event loop's
   launch rate is kept beside them); edge cases:
   sentinel indices, a 2-D idx, M = 13, C = 1, 4 and 5 (gather),
   duplicate points, k·stride = N, stride 2 and N = 4096 (kNN + gather);
   then FPS, ``knn`` and the 3-NN interpolation at the shapes of both
   models' eval forward and the row scatter-add at those of their
   backward (arguments recorded from the models), each against its plain
   version as in phases 3, 8 and 15, with device times (CUDA graphs)
   beside the event loop's; every row-gather and scatter-add record
   (phase 8's too) names the route its wrapper took (``narrow`` or
   ``wide``: ``gather.gather_route``, ``gather.scatter_route``) and its
   share of the bytes bound;
22. PointConv classification serving — ``Predictor(batch_size=32,
   with_normals=True)`` as in phase 6: per served batch exactly 2
   launches of FPS and of the row gather, 1 of ``knn`` and of the fused
   kNN + gather;
23. PointConv classification train — ``make_cls_train_step`` at B=32
   with SGD (momentum 0.9, lr 0.1 flat, ``bench.py:168``) and dropout 0.4
   as in phase 7: per step the serving launches and 2 of the scatter-add;
   the card-vs-CPU loss and gradient check on 8 clouds;
24. PointConv part segmentation — ``SegPredictor(batch_size=16)`` on 64
   clouds at N=2048 as in phase 9 (per batch 4 launches of FPS, 6 of
   ``knn``, 2 of the fused kNN + gather, 3 of the row gather, 4 of the
   3-NN interpolation; 2 clouds against the CPU) and
   ``make_seg_train_step`` at B=16, lr 0.01, as in phase 10 (per step
   those and 9 scatter-adds).

The line before the ``nvidia-smi`` line is ``{"kernels": [...]}``, one
entry per TPU kernel replaced (thirty-one; the three forward tails
share one source and one wrapper, counted per stage; the given-index
``sa_f1``, ``fused_sa_eval`` and ``sa_bwd_p2`` have a second entry each
for the windowed function they stand for at N ≥ 4096, with the N=4096
cases and the launches of the N=4096 paths; ``edge_knn_eval``'s entry
adds the ``torch.topk`` yardstick); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.

Beside ``main``, functions that time one kernel family at every shape of
the main paths, for old-against-new runs from two checkouts' roots
(``python3 -c 'import chip_smoke; chip_smoke.knn_times()'``):
``bwd_times``, ``tail_times``, ``f1_times``, ``rows_times``,
``fps_times``, ``eval_times``, ``knn_times`` (the kNN, with its route,
the library's ``torch.cdist`` + ``torch.topk`` and the plain order's
floor), ``edge2_times`` (the two-layer pass 1 at DGCNN part
segmentation's pairs and on its kNN route, with the memory one call
allocates), ``edgef1_times`` (pass 1 with the kNN inside and the other
DGCNN kernels) and ``edgeeval_times`` (the two eval kernels with the kNN
inside at their seven served launches, with their routes).
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from pointcloudlib_tpu_torch.data.synthetic import (
    SyntheticModelNet,
    SyntheticShapeNetPart,
)
from pointcloudlib_tpu_torch.inference import Predictor, SegPredictor
from pointcloudlib_tpu_torch.models import get_cls_model
from pointcloudlib_tpu_torch.models.dgcnn import Fused2EdgeConv
from pointcloudlib_tpu_torch.ops import geometry, spatial
from pointcloudlib_tpu_torch.ops.kernels import _build
from pointcloudlib_tpu_torch.ops.kernels import ball_query as kbq
from pointcloudlib_tpu_torch.ops.kernels import fps as kfps
from pointcloudlib_tpu_torch.ops.kernels import fused_edge as kfe
from pointcloudlib_tpu_torch.ops.kernels import fused_sa as kfs
from pointcloudlib_tpu_torch.ops.kernels import fused_sa_train as kft
from pointcloudlib_tpu_torch.ops.kernels import gather as kga
from pointcloudlib_tpu_torch.ops.kernels import knn as kknn
from pointcloudlib_tpu_torch.ops.kernels import knn_gather as kkg
from pointcloudlib_tpu_torch.ops.kernels import three_interp as kti
from pointcloudlib_tpu_torch.tools.grad_check import (
    GRAD_COS,
    GRAD_NORM,
    LOSS_RTOL,
    NORMALS,
    SEG,
    build_model,
    grad_agreement,
    synthetic_batch,
)
from pointcloudlib_tpu_torch.train import (
    make_cls_train_step,
    make_seg_train_step,
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
SEG_BATCH, SEG_POINTS, SEG_CLOUDS = 16, 2048, 64  # bench.py:201-243
SEG_LR = 0.01                                      # bench.py:233
TI_TOL, SCATTER_TOL = 1e-6, 1e-5                   # × max|plain|
DGCNN_BATCH, DGCNN_LR = 32, 0.1    # bench.py:341 (xyz only), bench.py:168
EDGE_TOL = 1e-5                    # edge_knn_eval and edge_out, × max|plain|
BIG_POINTS, BIG_BATCH = 4096, 32   # bench.py:336-337, SSG with normals
BIG_CLOUDS, BIG_SHORT = 128, 3000  # 96 clouds at 4096, 32 padded up to it
ODD_SERVE_POINTS, ODD_SERVE_CLOUDS = 10000, 64  # ModelNet40's resampling
ODD_TRAIN_POINTS = 1000            # N % 128 != 0: the standalone kNN
PLAIN_CLOUDS = 8                   # clouds a plain call takes at N=10,000
PN2_SEG, DSEG = "pointnet2_partseg", "dgcnn_partseg"  # grad_check's names
DSEG_CHECK = 4                     # DGCNN part-seg clouds served on the CPU too
DSEG_ODD_POINTS, DSEG_ODD_CLOUDS = 5000, 2  # above 4096, N % 128 != 0
DSEG_ODD_TRAIN, DSEG_ODD_BATCH = 1000, 4    # the kNN route in training
SLOPE = 0.2                        # LeakyReLU of the DGCNN models
PC_BATCH, PC_LR = 32, 0.1          # bench.py:344-345 (normals), bench.py:168
PC_SEG = "pointconv_partseg"       # grad_check's name; B=16, N=2048, lr 0.01
# The CUDA-core sa_bwd_p1 / sa_bwd_p2 that the tensor-core kernels
# replaced, at this script's train cases: device ms a call by graph_ms on
# an NVIDIA H100 80GB HBM3 at 700 W, from bwd_times() run on the checkout
# before the redesign (PERF.md §5)
CUDA_CORE_BWD_MS = {
    "sa_bwd_p1": {"SA1": 9.176, "SA2": 8.336, "MSG1/0": 0.553,
                  "MSG1/1": 2.394, "MSG1/2": 19.515, "MSG2/0": 0.7,
                  "MSG2/1": 4.237, "MSG2/2": 10.071, "partseg SA1": 2.394,
                  "partseg SA2": 2.179, "SSG4096 SA1": 4.654,
                  "SSG4096 SA2": 4.237},
    "sa_bwd_p2": {"SA1": 9.291, "SA2": 5.76, "MSG1/0": 0.695,
                  "MSG1/1": 2.29, "MSG1/2": 15.656, "MSG2/0": 0.634,
                  "MSG2/1": 2.969, "MSG2/2": 7.53, "partseg SA1": 2.385,
                  "partseg SA2": 1.58, "SSG4096 SA1": 4.601,
                  "SSG4096 SA2": 2.972},
}
# The CUDA-core fused_sa_bq_eval / fused_sa_eval that the tensor-core
# kernels replaced, at this script's eval cases: device ms a call by
# graph_ms on an NVIDIA H100 80GB HBM3 at 700 W, from eval_times() run on
# the checkout before the redesign (PERF.md §5); fused_sa_eval's with the
# ball query's cnt and without it
CUDA_CORE_EVAL_MS = {
    "fused_sa_bq_eval": {"SA1": 1.369, "SA2": 1.588, "MSG1/0": 0.146,
                         "MSG1/1": 0.547, "MSG2/0": 0.19, "MSG2/1": 0.896,
                         "partseg SA1": 0.597, "partseg SA2": 0.477,
                         "SSG4096 SA2": 0.899},
    "fused_sa_eval": {"MSG1/2": (2.634, 2.947), "MSG2/2": (1.772, 1.771),
                      "SSG4096 SA1": (1.117, 1.118)},
}
PC_CHECK = 2                       # PointConv part-seg clouds on the CPU too
CSRC = "pointcloudlib_tpu_torch/csrc/"
SOURCES = ("fps", "ball_query", "fused_sa_bq_eval", "fused_sa_eval",
           "three_interp", "scatter_rows", "knn", "gather_rows",
           "knn_gather") + kft.SOURCES + kfe.SOURCES
PALLAS = "pointcloudlib_tpu/ops/pallas/"
FUSED_SA = PALLAS + "fused_sa.py"
FUSED_EDGE = PALLAS + "fused_edge.py"


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


def graph_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call of ``fn``: ``iters`` calls
    captured in one CUDA graph, the graph replayed and timed by CUDA
    events, so that the host's cost of a launch (the wrapper's checks,
    ``ctypes``) stays out of a short kernel's reading. A wrapper's launch
    count moves during the capture only."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / (3 * iters)


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
        rec["device_ms"] = graph_ms(lambda: kfps.fps(xyz, m, skip), 10)
        rec["plain_ms"] = time_ms(lambda: kfps.fps_plain(xyz, m, skip), 3, 1)
        # per point and iteration: 3 sub, 3 mul, 2 add, 1 min, 1 compare
        rec["bound_ms"], rec["ops_ms"], rec["bytes_ms"] = bound(
            0.0, 10.0 * b * n * (m - 1), 12.0 * b * n + 4.0 * b * m)
    emit("kernel fps", rec)
    return rec


def _bq_eval_bound(nx, pts, q, p, radius, k, cnt):
    """``(bound_ms, ops_ms, bytes_ms)`` of ``fused_sa_bq_eval``: the two
    products over the live slots in bf16, the ball query's ~10 f32
    operations a tested pair (a center's scan stops at its k-th hit, a
    short one reads the whole cloud), each input read and the output
    written once."""
    b, m, _ = nx.shape
    n = pts.shape[1]
    c1, c2, c3 = q.shape[-1], p.w2.shape[1], p.w3.shape[1]
    live = torch.clamp(cnt, 1, k).sum().item()
    d2 = geometry.square_distance(nx, pts)
    rank = torch.cumsum((d2 < radius * radius).int(), dim=-1)
    scanned = torch.where(cnt >= k, (rank < k).sum(-1) + 1,
                          torch.full_like(cnt, n)).sum().item()
    return bound(2.0 * live * (c1 * c2 + c2 * c3), 10.0 * scanned,
                 12.0 * b * (n + m) + 2.0 * b * n * c1 + 4.0 * b * m * c1
                 + 2.0 * (c1 * c2 + c2 * c3) + 4.0 * b * m * c3)


def _eval_bound(q, idx, p, cnt):
    """``(bound_ms, ops_ms, bytes_ms)`` of ``fused_sa_eval``: the products
    over the live slots (what cnt leaves to do; every slot without it),
    each input read and the output written once."""
    b, m, k = idx.shape
    n, c1 = q.shape[1:]
    c2, c3 = p.w2.shape[1], p.w3.shape[1]
    live = (b * m * k if cnt is None
            else torch.clamp(cnt, 1, k).sum().item())
    return bound(2.0 * live * (c1 * c2 + c2 * c3), 0.0,
                 2.0 * b * n * c1 + 4.0 * b * m * c1
                 + 4.0 * b * m * (k + (cnt is not None))
                 + 2.0 * (c1 * c2 + c2 * c3) + 4.0 * b * m * c3)


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
    if timed:  # device times; the event loop reads the launch rate
        with torch.no_grad():
            call = lambda: kfs.fused_sa_bq_eval(nx, pts, q, off, p, s, r, k)
            rec["ms"] = graph_ms(call, 5)
            rec["cuda_core_graph_ms"] = CUDA_CORE_EVAL_MS[
                "fused_sa_bq_eval"].get(name.replace(" serving", ""))
            rec["launch_rate_ms"] = time_ms(call, 20)
            rec["plain_ms"] = time_ms(
                lambda: kfs.fused_sa_bq_eval_plain(nx, pts, q, off, p, s, r,
                                                   k), 3, 1)
        rec["bound_ms"], rec["ops_ms"], rec["bytes_ms"] = _bq_eval_bound(
            nx, pts, q, p, r, k, cnt)
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
    # every point four times on a coarse grid: exact d² ties
    dup = torch.round(xyz[:8, :N_POINTS // 4].repeat(1, 4, 1) * 4.0) / 4.0
    _fps_case("duplicates 1024->512", dup, 512, True, False)

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
           "sa_bwd_p1": kft.sa_bwd_p1, "sa_bwd_p2": kft.sa_bwd_p2,
           "three_interp": kti.three_interp_fwd,
           "scatter_rows": kga.scatter_rows,
           "edge_knn_eval": kfe.edge_knn_eval, "edge_knn_f1": kfe.edge_knn_f1,
           "edge_out": kfe.edge_out, "edge_bwd": kfe.edge_bwd,
           "knn": kknn.knn, "edge_f1": kfe.edge_f1, "edge_eval": kfe.edge_eval,
           "edge2_stats2": kfe.edge2_stats2, "edge2_out": kfe.edge2_out,
           "edge2_p1": kfe.edge2_p1, "edge2_p2": kfe.edge2_p2,
           "edge2_eval": kfe.edge2_eval, "edge2_knn_eval": kfe.edge2_knn_eval,
           "gather_neighbors": kga.gather_neighbors,
           "knn_gather": kkg.knn_gather}
# launches per served batch and per train step; a kernel not named: none
SSG_SERVE = {"fps": 2, "fused_sa_bq_eval": 2}
MSG_SERVE = {"fps": 2, "fused_sa_bq_eval": 4, "ball_query": 2,
             "fused_sa_eval": 2}
SSG_STEP = {"fps": 2, "bq_f1": 2, "sa_tail": 6, "sa_bwd_p1": 2,
            "sa_bwd_p2": 2}
MSG_STEP = {"fps": 2, "bq_f1": 4, "ball_query": 2, "sa_f1": 2,
            "sa_tail": 18, "sa_bwd_p1": 6, "sa_bwd_p2": 6}
SEG_SERVE = {"fps": 2, "fused_sa_bq_eval": 2, "three_interp": 2}
SEG_STEP = {**SSG_STEP, "three_interp": 2, "scatter_rows": 2}
DGCNN_SERVE = {"edge_knn_eval": 4}
DGCNN_STEP = {"edge_knn_f1": 4, "edge_out": 4, "edge_bwd": 4}
# N=4096: SA1 takes the standalone ball query and the given-index kernels
BIG_SERVE = {"fps": 2, "ball_query": 1, "fused_sa_eval": 1,
             "fused_sa_bq_eval": 1}
BIG_STEP = {"fps": 2, "ball_query": 1, "sa_f1": 1, "bq_f1": 1, "sa_tail": 6,
            "sa_bwd_p1": 2, "sa_bwd_p2": 2}
# N % 128 != 0: DGCNN's standalone kNN and the given-index EdgeConv
ODD_SERVE = {"knn": 4, "edge_eval": 4}
ODD_STEP = {"knn": 4, "edge_f1": 4, "edge_out": 4, "edge_bwd": 4}
# DGCNN part segmentation: two pairs of two-layer EdgeConvs, then one
# EdgeConv; at N % 128 != 0 the standalone kNN and the given-index kernels
DSEG_SERVE = {"edge2_knn_eval": 2, "edge_knn_eval": 1}
DSEG_STEP = {"edge_knn_f1": 3, "edge2_stats2": 2, "edge2_out": 2,
             "edge2_p1": 2, "edge2_p2": 2, "edge_out": 1, "edge_bwd": 1}
DSEG_ODD_SERVE = {"knn": 3, "edge2_eval": 2, "edge_eval": 1}
DSEG_ODD_STEP = {"knn": 3, "edge_f1": 3, "edge2_stats2": 2, "edge2_out": 2,
                 "edge2_p1": 2, "edge2_p2": 2, "edge_out": 1, "edge_bwd": 1}
# PointConv: SA1 by kNN and two row gathers ([xyz ‖ normals], density), SA2
# by the fused kNN + gather; training adds the scatter-add of the density
# gather and of SA2's values. Part segmentation: SA1 and SA4 by kNN (cv 4,
# N=64), SA2 and SA3 fused, four decoders (3-NN, kNN, the row gather of
# the upsampled features at N = 256, 1024, 2048); its step's scatter-adds:
# 2 fused gathers, 3 row gathers, 4 interpolations.
PC_SERVE = {"fps": 2, "knn": 1, "gather_neighbors": 2, "knn_gather": 1}
PC_STEP = {**PC_SERVE, "scatter_rows": 2}
PCSEG_SERVE = {"fps": 4, "knn": 6, "knn_gather": 2, "gather_neighbors": 3,
               "three_interp": 4}
PCSEG_STEP = {**PCSEG_SERVE, "scatter_rows": 9}


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
    pred = Predictor.from_variables(name, variables, batch_size=batch,
                                    with_normals=name in NORMALS)
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
                                   with_normals=name in NORMALS,
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


def _check_sums(what, got, want, tol=SUM_TOL):
    """``(max |Δ|, max |plain|)``; fails beyond ``tol``·max|plain|."""
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if not torch.isfinite(got).all() or not err <= tol * scale:
        fail(f"{what}: |Δ| {err} beyond {tol}·max|plain| ({scale})")
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
                dout=dout, us=(ps3 / r, s2 / r),
                route="bq" if sa.fuses_ball_query(pts.shape[1]) else "idx")


def _train_layers(model, xyz, nrm, tag=""):
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
    return [(f"{tag}SA1", l1), (f"{tag}SA2", l2),
            (f"{tag}SA2 empty row", l2e)]


def _f1_work(L):
    """``(f32 operations, bytes)`` of forward pass 1 on one layer's
    inputs: each input read once (q, off, and by route the clouds or
    idx), h1 (and on the ball-query route idx and cnt) written once; h1
    and its two sums 4 operations an element, the full scan ~10 f32
    operations per (center, point)."""
    b, m, k, c1 = L["h1"].shape
    n, rows = L["pts"].shape[1], b * m * k
    io = (2.0 * b * n * c1 + 4.0 * b * m * c1 + 2.0 * rows * c1
          + 4.0 * rows + 8.0 * c1)
    if L["route"] == "bq":
        return (10.0 * b * m * n + 4.0 * rows * c1,
                io + 12.0 * b * (n + m) + 4.0 * b * m)
    return 4.0 * rows * c1, io


def _train_case(name, L, timed):
    """Each train kernel on one layer's inputs against its plain version:
    forward pass 1 by the layer's route (``L["route"]``: ``"bq"``, the
    ball query inside; ``"idx"``, the pass that takes the ball query's
    idx), then the tails, p1 and p2. With ``timed``, kernel and plain
    times and the bounds. Returns ``{kernel: [records]}``."""
    p, (st1, st2, st3), k = L["p"], L["st"], L["k"]
    route = L["route"]
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
            if kernel in CUDA_CORE_BWD_MS:  # device times, beside the old
                rec["ms"] = graph_ms(fn, 5)
                rec["cuda_core_graph_ms"] = CUDA_CORE_BWD_MS[kernel].get(
                    rec["case"])
            elif kernel.startswith("sa_tail") or kernel in ("bq_f1", "sa_f1"):
                rec["ms"] = graph_ms(fn, 5)  # device times
            else:
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
        if route == "bq":
            rec["idx_cnt_bit_identical"] = True
            record("bq_f1", rec, lambda: kft.bq_f1(*f1_args),
                   lambda: kft.bq_f1_plain(*f1_args), 0.0, *_f1_work(L))
        else:
            record("sa_f1", rec, lambda: kft.sa_f1(*f1_args),
                   lambda: kft.sa_f1_plain(*f1_args), 0.0, *_f1_work(L))

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


def phase_train_kernels(model, xyz, nrm, tag=""):
    recs = {}
    for name, L in _train_layers(model, xyz, nrm, tag):
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
    if timed:  # device times; the event loop reads the launch rate
        with torch.no_grad():
            call = lambda: kfs.fused_sa_eval(q, off, idx, p, s, cnt=cnt)
            rec["ms"] = graph_ms(call, 5)
            rec["ms_without_cnt"] = graph_ms(
                lambda: kfs.fused_sa_eval(q, off, idx, p, s), 5)
            old = CUDA_CORE_EVAL_MS["fused_sa_eval"].get(name)
            rec["cuda_core_graph_ms"] = old and old[0]
            rec["cuda_core_graph_ms_without_cnt"] = old and old[1]
            rec["launch_rate_ms"] = time_ms(call, 20)
            rec["plain_ms"] = time_ms(
                lambda: kfs.fused_sa_eval_plain(q, off, idx, p, s), 3, 1)
        rec["bound_ms"], rec["ops_ms"], rec["bytes_ms"] = _eval_bound(
            q, idx, p, cnt)
    emit("kernel fused_sa_eval", rec)
    return rec


def phase_msg_kernels(model, xyz, nrm):
    """``{kernel: [records]}`` of every kernel on the MSG path at the six
    scales' shapes and of FPS at its two, timed, plus the edge cases,
    untimed."""
    g = torch.Generator(device=DEV).manual_seed(4)
    recs = {}

    def add(kernel, rec):
        recs.setdefault(kernel, []).append(rec)

    def empty_row(nx):
        nx = nx.clone()
        nx[0, 0] = 50.0  # a center with no neighbour: cnt == 0
        return nx

    scales = _msg_scales(model, xyz, nrm)
    add("fps", _fps_case("MSG1 1024->512", xyz, model.sa1.n_points, True,
                         True))
    add("fps", _fps_case("MSG2 512->128", scales[0][2], model.sa2.n_points,
                         True, True))
    for name, sa, nx, pts, q, off in scales:
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
                for kernel, rs in _train_case(case, L, timed).items():
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


def _update_rounds_away(p, opt):
    """Whether the last SGD step's update of ``p``, lr·|momentum buffer|
    (no weight decay), stays below half an f32 unit of every element's
    value (the smaller unit of the two on either side of it), so that
    the step leaves ``p`` exactly where it was."""
    buf = opt.state.get(p, {}).get("momentum_buffer")
    if buf is None:
        return False
    a = p.detach().abs()
    unit = torch.minimum(torch.nextafter(a, torch.full_like(a, np.inf)) - a,
                         a - torch.nextafter(a, torch.zeros_like(a)))
    lr = opt.param_groups[0]["lr"]
    return bool((lr * buf.abs() < 0.5 * unit).all())


def _update_report(key, p, opt):
    """One unchanged state entry: its largest |gradient| and last
    update lr·|momentum buffer| beside half an f32 unit of its value."""
    if p is None:
        return f"{key} (a buffer)"
    buf = opt.state.get(p, {}).get("momentum_buffer")
    grad = "none" if p.grad is None else f"{p.grad.abs().max().item():.3e}"
    step = ("none" if buf is None else
            f"{opt.param_groups[0]['lr'] * buf.abs().max().item():.3e}")
    a = p.detach().abs()
    half = 0.5 * (torch.nextafter(a, torch.full_like(a, np.inf)) - a)
    return (f"{key} (max |grad| {grad}, max update {step}, change 0, half "
            f"an f32 unit of its values {half.min().item():.3e}–"
            f"{half.max().item():.3e})")


def phase_train(name, variables, power, batch_size, per_step,
                n_points=None, grad_check=True):
    """``name`` trains at ``batch_size``: a classification model on
    ModelNet40-shaped clouds at N=1024 (or ``n_points``) with the
    reference's flat lr, or a part-segmentation model (:data:`SEG`) on
    ShapeNet-part-shaped clouds at N=2048 with lr 0.01; with
    ``grad_check`` the card-vs-CPU gradient check follows."""
    tag = name if n_points is None else f"{name} N={n_points}"
    if n_points is None:
        n_points = SEG_POINTS if name in SEG else N_POINTS
    batch = {k: v.to(DEV) for k, v in synthetic_batch(
        name, batch_size, 5, n_points).items()}
    model = build_model(name)
    from_jax_variables(model, variables)
    if name in SEG:
        lr, make = SEG_LR, make_seg_train_step
    elif name in ("dgcnn", "pointconv"):
        lr = DGCNN_LR if name == "dgcnn" else PC_LR
        make = make_cls_train_step
    else:  # ModelNet40's training set
        lr, make = reference_flat_lr(0.02, 9840, batch_size), \
            make_cls_train_step
    opt = sgd_momentum(model.parameters(), lr)
    step = make(model, opt)
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
    launches = _read_counts(f"{tag} train", per_step, TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()

    losses = [x.item() for x in losses]
    if not all(np.isfinite(losses)):
        fail(f"train losses not finite: {losses}")
    after = model.state_dict()
    still = [k for k, v in before.items() if v.dtype.is_floating_point
             and torch.equal(v, after[k])]
    # gradients that are exactly 0 (a train-mode BN removes the shift)
    # may leave a parameter where it was: SA3's last BN bias, the Dense
    # bias in front of a BatchNorm (a DenseBNAct's: the part-segmentation
    # head, DGCNN's fc2, PointConv's; a PointConv layer's output Dense)
    # and DGCNN part segmentation's conv6 BN bias; so may a parameter
    # whose last update rounds away in every element
    params = dict(model.named_parameters())
    stuck = [k for k in still
             if k not in ("sa3.mlp.2.bn.bias", "conv6.bn.bias")
             and not k.endswith("dense.bias")
             and not (k in params and _update_rounds_away(params[k], opt))]
    if stuck:
        fail("train steps left these unchanged: " + "; ".join(
            _update_report(k, params.get(k), opt) for k in stuck))
    rec = {"samples_per_s": batch_size * TRAIN_STEPS / secs,
           "step_ms": 1e3 * secs / TRAIN_STEPS, "batch": batch_size,
           "n_points": n_points, "steps": TRAIN_STEPS, "lr": lr,
           "card": power, "launches": launches, "peak_device_bytes": peak,
           "losses": losses, "unchanged": still}
    if not grad_check:
        emit(f"train {tag}", rec)
        return launches

    check = grad_agreement(name, variables,
                           {k: v[:CHECK_CLOUDS] for k, v in batch.items()},
                           DEV)
    agree = check["agree"]
    emit(f"train {tag}", {
        **rec, "check_clouds": CHECK_CLOUDS, "loss_card": check["loss"],
        "loss_cpu": check["loss_cpu"],
        "worst_grad_cos": min(agree.items(), key=lambda kv: kv[1][0]),
        "worst_grad_norm_ratio": max(agree.items(),
                                     key=lambda kv: abs(kv[1][1] - 1)),
        "grads_not_compared": check["not_compared"],
        "grads_cosine_only": check["cosine_only"],
        "grad_cos_and_norm_ratio": agree})
    if check["failures"]:
        fail(f"{name}: card vs CPU on {CHECK_CLOUDS} clouds (loss within "
             f"{LOSS_RTOL}, cosine at least {GRAD_COS}, norm within "
             f"{GRAD_NORM[name]}): {check['failures']}")
    return launches


# ------------------------------------------------- part segmentation


def _seg_data(n_clouds):
    """``(xyz [n, 2048, 3], labels [n], one-hot [n, 16])`` of the
    synthetic ShapeNet-part set, seed 0."""
    xyz, labels, _ = SyntheticShapeNetPart(
        n_points=SEG_POINTS, size=n_clouds, seed=0).batch(0, n_clouds)
    return xyz, labels, np.eye(16, dtype=np.float32)[labels]


def _three_interp_case(name, query, points, feats, timed, self_pairs=0):
    """The 3-NN interpolation kernel against its plain version: idx
    bit-identical, w and out within TI_TOL·max|plain|. ``self_pairs``:
    how many queries at least must equal a support point; each such row
    must then be a hard copy of that point's features (the support holds
    no duplicates)."""
    out, idx, w = kti.three_interp_fwd(query, points, feats)
    pout, pidx, pw = kti.three_interp_plain(query, points, feats)
    torch.cuda.synchronize()
    if not torch.equal(idx, pidx):
        fail(f"three_interp {name}: {(idx != pidx).sum().item()} indices "
             f"differ from the plain version")
    errs = [_check_sums(f"three_interp {name} {what}", a, b_, TI_TOL)
            for a, b_, what in ((w, pw, "w"), (out, pout, "out"))]
    match = (query[:, :, None, :] == points[:, None, :, :]).all(-1)
    exact = match.any(-1)
    if int(exact.sum()) < self_pairs:
        fail(f"three_interp {name}: {int(exact.sum())} self-pairs, expected "
             f"at least {self_pairs}")
    if self_pairs:
        copy = geometry.index_points(feats, match.int().argmax(-1))
        dev = (out - copy).abs()[exact].max().item()
        if not dev <= 1e-4 * feats.abs().max().item():
            fail(f"three_interp {name}: a self-pair is no hard copy "
                 f"(|Δ| {dev})")
    b, m, _ = query.shape
    n, c = feats.shape[1:]
    rec = {"case": name, "B": b, "M": m, "N": n, "C": c,
           "idx_bit_identical": True, "self_pairs": int(exact.sum()),
           **_errs(errs)}
    if timed:
        rec["ms"] = time_ms(lambda: kti.three_interp_fwd(query, points,
                                                         feats), 20)
        rec["device_ms"] = graph_ms(
            lambda: kti.three_interp_fwd(query, points, feats), 20)
        rec["plain_ms"] = time_ms(
            lambda: kti.three_interp_plain(query, points, feats), 3, 1)
        # ~10 f32 operations a (query, point) pair, 5 an output element
        rec["bound_ms"], rec["ops_ms"], rec["bytes_ms"] = bound(
            0.0, 10.0 * b * m * n + 5.0 * b * m * c,
            12.0 * b * (m + n) + 4.0 * b * n * c + 4.0 * b * m * c
            + 24.0 * b * m)
    emit("kernel three_interp", rec)
    return rec, (idx, w)


def _route(name, *args) -> str:
    """The route ``gather.<name>`` gives, or ``"parent"`` for a package
    from before the routes (``rows_times`` run against a parent
    checkout)."""
    fn = getattr(kga, name, None)
    return fn(*args) if fn else "parent"


def _scatter_case(name, g, idx, n, timed):
    """The row scatter-add kernel against its plain version within
    SCATTER_TOL·max|plain|, with ``index_add_`` timed beside it."""
    got = kga.scatter_rows(g, idx, n)
    want = kga.scatter_rows_plain(g, idx, n)
    torch.cuda.synchronize()
    err = _check_sums(f"scatter_rows {name}", got, want, SCATTER_TOL)
    b, c = g.shape[0], g.shape[-1]
    rows = idx[0].numel()
    dropped = int(((idx < 0) | (idx >= n)).sum())
    rec = {"case": name, "B": b, "rows": rows, "n": n, "C": c,
           "route": _route("scatter_route", n, c), "dropped_rows": dropped,
           **_errs([err])}
    if timed:  # device times; the event loop reads the launch rate
        rec["ms"] = graph_ms(lambda: kga.scatter_rows(g, idx, n), 20)
        rec["launch_rate_ms"] = time_ms(lambda: kga.scatter_rows(g, idx, n),
                                        20)
        rec["plain_ms"] = time_ms(
            lambda: kga.scatter_rows_plain(g, idx, n), 5, 1)
        keep = ((idx >= 0) & (idx < n)).reshape(b, -1)
        target = (idx.reshape(b, -1).long()
                  + n * torch.arange(b, device=DEV)[:, None])[keep]
        g2 = g.reshape(b, -1, c)[keep]
        acc = torch.zeros((b * n, c), device=DEV)
        # zeroing the output inside the timed call, as the kernel's
        # wrapper does
        rec["library_ms"] = graph_ms(
            lambda: acc.zero_().index_add_(0, target, g2), 20)
        # one f32 add an element of g
        rec["bound_ms"], rec["ops_ms"], rec["bytes_ms"] = bound(
            0.0, 1.0 * b * rows * c,
            4.0 * b * rows * c + 4.0 * b * rows + 4.0 * b * n * c)
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    emit("kernel scatter_rows", rec)
    return rec


def phase_seg_kernels(model, xyz):
    """``{kernel: [records]}`` of every kernel on the part-segmentation
    path at its shapes (B=16, N=2048, xyz as features), timed, and the
    edge cases of the two decoder kernels, untimed."""
    recs = {}
    sa = _sa_inputs(model, xyz, xyz)
    nx1 = sa[0][2][0]
    recs["fps"] = [_fps_case("partseg SA1 2048->512", xyz, 512, True, True),
                   _fps_case("partseg SA2 512->128", nx1, 128, True, True)]
    recs["fused_sa_bq_eval"] = [
        _bq_case(f"partseg {name} serving", mod, args, True)
        for name, mod, args in sa]
    for kernel, rs in phase_train_kernels(model, xyz, xyz,
                                          "partseg ").items():
        recs.setdefault(kernel, []).extend(rs)

    with torch.no_grad():  # the decoders' inputs in eval mode
        l1_xyz, l1_f = model.sa1(xyz, xyz)
        l2_xyz, l2_f = model.sa2(l1_xyz, l1_f)
        l3_xyz, l3_f = model.sa3(l2_xyz, l2_f)
        l2_f = model.fp3(l2_xyz, l3_xyz, l2_f, l3_f)
        l1_up = model.fp2(l1_xyz, l2_xyz, l1_f, l2_f)
    g = torch.Generator(device=DEV).manual_seed(6)
    ti, sc = [], []
    # FPS picks its centers among the queries: FP2's 128 support points
    # are all among its 512 queries, FP1's 512 among its 2048
    for name, q, p, f in (("FP2", l1_xyz, l2_xyz, l2_f),
                          ("FP1", xyz, l1_xyz, l1_up)):
        rec, (idx, w) = _three_interp_case(
            f"partseg {name}", q, p, f, True,
            self_pairs=p.shape[0] * p.shape[1])
        ti.append(rec)
        dout = torch.randn(f.shape[:1] + q.shape[1:2] + f.shape[2:],
                           generator=g, device=DEV)
        dg = (w[..., None] * dout[:, :, None, :]).contiguous()
        sc.append(_scatter_case(f"partseg {name} backward", dg, idx,
                                p.shape[1], True))

    # edge cases: supports of 36 and 100 points (the PointConv decoders'
    # coarse levels), duplicate support points, queries equal to the
    # support, scatter indices at and beyond n
    rng = np.random.default_rng(7)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(DEV)

    for n, (b, m, c) in ((36, (1, 40, 64)), (100, (2, 16, 3))):
        p = t(b, n, 3)
        _three_interp_case(f"N={n}", t(b, m, 3), p, t(b, n, c), False)
        _three_interp_case(f"N={n} queries = support", p, p, t(b, n, c),
                           False, self_pairs=b * n)
        idx = torch.from_numpy(rng.integers(0, n + 8, (b, m, 3)).astype(
            np.int32)).to(DEV)
        idx[0, 0, 0] = n
        rec = _scatter_case(f"n={n} indices at and beyond n",
                            t(b, m, 3, c), idx, n, False)
        if rec["dropped_rows"] < 1:
            fail(f"scatter_rows n={n}: the case drops no row")
    base = t(2, 64, 3)
    dup = base[:, torch.from_numpy(rng.integers(0, 64, 128)).to(DEV)]
    _three_interp_case("duplicate support points", t(2, 256, 3), dup,
                       t(2, 128, 32), False)
    # exact ties at d² = 0: the lower index first
    _three_interp_case("duplicate support points, queries = support", dup,
                       dup, t(2, 128, 32), False)
    recs["three_interp"], recs["scatter_rows"] = ti, sc
    return recs


def phase_seg_serving(name, variables, power, per_batch, check):
    """``SegPredictor(batch_size=16)`` for part-segmentation model
    ``name`` (:data:`SEG`) on 64 clouds, three requests: exactly
    ``per_batch`` launches a served batch, the same ids each time; then
    ``check`` clouds on the card and on the CPU: probabilities within
    5e-3 and part ids equal wherever the top two probabilities differ by
    more than 1e-2."""
    clouds, labels, _ = _seg_data(SEG_CLOUDS)
    pred = SegPredictor.from_variables(SEG[name], variables,
                                       batch_size=SEG_BATCH)
    pred.predict(clouds[:SEG_BATCH], labels[:SEG_BATCH])  # warm-up

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    secs, outs = [], []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        outs.append(pred.predict(clouds, labels))
        secs.append(time.perf_counter() - t0)
    batches = REPEATS * (SEG_CLOUDS // SEG_BATCH)
    launches = _read_counts(f"{name} serving", per_batch, batches)
    peak = torch.cuda.max_memory_allocated()

    ids = outs[0]
    if ids.shape != (SEG_CLOUDS, SEG_POINTS) or ids.min() < 0 \
            or ids.max() >= 50:
        fail(f"part ids of shape {ids.shape} in [{ids.min()}, {ids.max()}]")
    if any(not np.array_equal(o, ids) for o in outs[1:]):
        fail("repeated requests gave different part ids")
    probs = pred.predict_proba(clouds[:check], labels[:check])
    if not np.array_equal(probs.argmax(-1), ids[:check]):
        fail(f"{name}: predict and predict_proba disagree")
    rec = _seg_against_cpu(name, variables, clouds[:check], labels[:check],
                           probs)
    rates = [SEG_CLOUDS / x for x in secs]
    emit(f"serving {name}", {
        "clouds_per_s": rates, "median_clouds_per_s": float(np.median(rates)),
        "batch": SEG_BATCH, "n_points": SEG_POINTS, "clouds": SEG_CLOUDS,
        "card": power, "launches": launches, "served_batches": batches,
        "peak_device_bytes": peak, **rec})
    return launches


def _seg_against_cpu(name, variables, clouds, labels, probs):
    """Fails unless ``probs`` (from the card) are finite rows summing to 1
    within 5e-3 of the CPU SegPredictor's for the same clouds, with the
    same part ids wherever the CPU's top two differ by more than 1e-2."""
    rows = (len(clouds), clouds.shape[1], 50)
    if (probs.shape != rows or not np.isfinite(probs).all()
            or np.abs(probs.sum(-1) - 1.0).max() > 1e-4):
        fail(f"{name}: probabilities not finite rows summing to 1 of shape "
             f"{rows}: {probs.shape}")
    cpu = SegPredictor.from_variables(SEG[name], variables,
                                      batch_size=len(clouds), device="cpu")
    ref = cpu.predict_proba(clouds, labels)
    diff = float(np.abs(ref - probs).max())
    if diff > PROB_ATOL:
        fail(f"{name} N={clouds.shape[1]}: card vs CPU probabilities differ "
             f"by {diff} > {PROB_ATOL}")
    top2 = np.sort(ref, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-2
    if not np.array_equal(ref.argmax(-1)[clear], probs.argmax(-1)[clear]):
        fail(f"{name} N={clouds.shape[1]}: card and CPU part ids differ "
             f"where the top two probabilities are more than 1e-2 apart")
    return {"check_clouds": len(clouds), "max_abs_prob_diff_vs_cpu": diff,
            "ids_agree_vs_cpu": float((ref.argmax(-1)
                                       == probs.argmax(-1)).mean()),
            "clear_points": int(clear.sum())}


# ------------------------------------------------------------- DGCNN


def _edge_inputs(model, xyz):
    """``(name, layer, x_serving, x_train)`` of the four EdgeConvs on the
    main path's data: each layer's input in a served batch (the eval
    chain, running statistics) and in a train step (batch statistics)."""
    out, xe, xt = [], xyz, xyz
    with torch.no_grad():
        for i, ec in enumerate(model.edge):
            f = ec.fused
            out.append((f"EC{i + 1}", f, xe, xt))
            q, off = f.prepare(xe)
            xe = kfe.fused_edge_eval_knn(xe, q, off, f.bn_scale, f.bn_bias,
                                         kfe.EdgeStats(f.mean, f.var), f.k)
            q, off = f.prepare(xt)
            xt, _ = kfe.fused_edge_conv_knn(xt, q, off, f.bn_scale,
                                            f.bn_bias, f.k)
    return out


def _edge_case(name, f, xe, xt, g, timed):
    """The four EdgeConv kernels of one layer against their plain
    versions: ``edge_knn_eval`` on the serving input, ``edge_knn_f1``,
    ``edge_out`` and ``edge_bwd`` on the train input, each from the plain
    version's results of the pass before. Returns ``{kernel: record}``."""
    k = f.k
    b, n, cin = xt.shape
    c = f.bn_scale.shape[0]
    shape = {"B": b, "N": n, "k": k, "C_in": cin, "C": c}
    pairs = float(b * n * n)
    knn_ops = pairs * (2 * cin + 3)       # d² of every (query, point) pair
    edges = float(b * n * k * c)
    recs = {}

    def record(kernel, rec, fn, plain, flops_f32, nbytes):
        if timed:
            rec["ms"] = time_ms(fn, 10)
            rec["plain_ms"] = time_ms(plain, 2, 1)
            rec["bound_ms"], rec["ops_ms"], rec["bytes_ms"] = bound(
                0.0, flops_f32, nbytes)
        emit(f"kernel {kernel}", rec)
        recs[kernel] = rec

    with torch.no_grad():
        q, off = f.prepare(xe)
        qb = q.bfloat16()
        st = kfs._stack_stats(f.mean, f.var, f.bn_scale, f.bn_bias)
        ev = (xe, qb, off, st, k)
        err = _check_sums(f"edge_knn_eval {name}", kfe.edge_knn_eval(*ev),
                          kfe.edge_knn_eval_plain(*ev), EDGE_TOL)
        rec = {"case": name, **shape, "route": _edge_route_label(
            kknn, "edge_eval_route", b, n, cin, c, k, layers=1),
               **_errs([err])}
        if timed:  # the selection alone, by the library, on the same d²
            d2 = geometry.square_distance(xe, xe)
            rec["topk_selection_yardstick_ms"] = time_ms(
                lambda: torch.topk(d2, k, dim=-1, largest=False), 10)
            del d2
        # gather, BN, LeakyReLU and max: ~5 operations an edge element
        record("edge_knn_eval", rec, lambda: kfe.edge_knn_eval(*ev),
               lambda: kfe.edge_knn_eval_plain(*ev), knn_ops + 5.0 * edges,
               4.0 * b * n * cin + 2.0 * b * n * c + 8.0 * b * n * c
               + 16.0 * c)

        q, off = f.prepare(xt)
        qb = q.bfloat16()
        f1 = (xt, qb, off, k)
        idx, h, psum = kfe.edge_knn_f1(*f1)
        widx, wh, wpsum = kfe.edge_knn_f1_plain(*f1)
        torch.cuda.synchronize()
        if not torch.equal(idx, widx):
            fail(f"edge_knn_f1 {name}: {(idx != widx).sum().item()} "
                 f"neighbour indices differ from the plain version")
        if not torch.equal(h.view(torch.int16), wh.view(torch.int16)):
            fail(f"edge_knn_f1 {name}: h not bit-identical to the plain "
                 f"version")
        rec = {"case": name, **shape, "idx_h_bit_identical": True,
               **_errs([_check_sums(f"edge_knn_f1 {name}", psum, wpsum)])}
        del idx, h
        # h, its sum and its square: 4 operations an edge element
        record("edge_knn_f1", rec, lambda: kfe.edge_knn_f1(*f1),
               lambda: kfe.edge_knn_f1_plain(*f1), knn_ops + 4.0 * edges,
               4.0 * b * n * cin + 6.0 * b * n * c + 4.0 * b * n * k
               + 2.0 * edges + 8.0 * c)

        _edge_tail_cases(name, f, wh, wpsum, widx, g, shape, record)
    return recs


def _edge_tail_cases(name, f, wh, wpsum, widx, g, shape, record):
    """``edge_out`` and ``edge_bwd`` against their plain versions, from
    pass 1's plain ``h``, sums and neighbour index (either route's)."""
    b, n, k, c = wh.shape
    edges = float(b * n * k * c)
    with torch.no_grad():
        r = float(b * n * k)
        st = kfs._stack_stats(*kft._moments(wpsum, r), f.bn_scale, f.bn_bias)
        err = _check_sums(f"edge_out {name}", kfe.edge_out(wh, st),
                          kfe.edge_out_plain(wh, st), EDGE_TOL)
        record("edge_out", {"case": name, **shape, **_errs([err])},
               lambda: kfe.edge_out(wh, st),
               lambda: kfe.edge_out_plain(wh, st), 5.0 * edges,
               2.0 * edges + 4.0 * b * n * c + 16.0 * c)

        dout = torch.randn((b, n, c), generator=g, device=DEV)
        bw = (wh, dout, widx, st, 0.2, n)
        got, want = kfe.edge_bwd(*bw), kfe.edge_bwd_plain(*bw)
        torch.cuda.synchronize()
        if not torch.equal(got[1][..., 2 * c], want[1][..., 2 * c]):
            fail(f"edge_bwd {name}: scatter counts differ")
        errs = [_check_sums(f"edge_bwd {name} {w}", a, b_)
                for a, b_, w in zip(got, want, ("ps", "scat", "d1", "d2"))]
        errs += [_check_sums(f"edge_bwd {name} {w}", a, b_) for a, b_, w in
                 zip(kfe.assemble_grads(*got, st, k),
                     kfe.assemble_grads(*want, st, k),
                     ("dq", "doff", "dgamma", "dbeta"))]
        # the row pass (BN, LeakyReLU, tie count, dz, x̂, the sums): ~15
        # operations an edge element; scat written once
        record("edge_bwd", {"case": name, **shape, **_errs(errs)},
               lambda: kfe.edge_bwd(*bw), lambda: kfe.edge_bwd_plain(*bw),
               15.0 * edges,
               2.0 * edges + 4.0 * b * n * c + 4.0 * b * n * k + 16.0 * c
               + 8.0 * c + 4.0 * b * n * (2 * c + 1) + 8.0 * b * n * c)


def phase_dgcnn_kernels(model, xyz):
    """``{kernel: [records]}`` of the four EdgeConv kernels at the four
    layers' shapes of the DGCNN path (B=32, N=1024, k=20), timed, and at
    edge cases, untimed: duplicate points (exact kNN ties at d² = 0 and
    exact max-pool ties) and N one past the candidate tile (65)."""
    g = torch.Generator(device=DEV).manual_seed(8)
    recs = {}
    for name, f, xe, xt in _edge_inputs(model, xyz):
        for kernel, rec in _edge_case(name, f, xe, xt, g, True).items():
            recs.setdefault(kernel, []).append(rec)
    dup = xyz[:4].clone()
    dup[:, N_POINTS // 2:] = dup[:, :N_POINTS // 2]
    _edge_case("EC1 duplicate points", model.edge[0].fused, dup, dup, g,
               False)
    x64 = torch.randn((2, 65, 64), generator=g, device=DEV)
    _edge_case("EC2 N=65", model.edge[1].fused, x64, x64, g, False)
    x64[:, 40:] = x64[:, :25]
    _edge_case("EC2 N=65 duplicate points", model.edge[1].fused, x64, x64, g,
               False)
    return recs


# ------------------------------------------------------------ N = 4096


def _big_layers(model, xyz, nrm):
    """SA1's and SA2's train-kernel inputs of PointNet++ SSG at N=4096 on
    the main path's data, sorted as the train step sorts it: SA1 from the
    ball query's idx, SA2 (source N=512) with the ball query inside,
    taking SA1's train-mode output."""
    g = torch.Generator(device=DEV).manual_seed(9)
    sa1, sa2 = model.sa1.fused, model.sa2.fused
    with torch.no_grad():
        xyz, nrm, _ = spatial.canonicalize(xyz, nrm)
        nx1, q1, off1 = sa1.prepare(xyz, nrm)
        idx, _ = kbq.ball_query_plain(nx1, xyz, sa1.radius, sa1.n_samples)
        out1, _ = kft.fused_sa_train(q1, off1, idx, sa1.sa_params())
        nx2, q2, off2 = sa2.prepare(nx1, out1)
        l1 = _train_inputs(sa1, nx1, xyz, q1, off1, g)
        l2 = _train_inputs(sa2, nx2, nx1, q2, off2, g)
    return xyz, l1, l2


def _keys_case(name, xyz):
    """The Hilbert keys and sort order of ``xyz`` on the card bit-identical
    to the CPU's."""
    keys = spatial.hilbert_keys(xyz)
    order = spatial.canonicalize(xyz)[-1]
    if not (torch.equal(keys.cpu(), spatial.hilbert_keys(xyz.cpu()))
            and torch.equal(order.cpu(), spatial.canonicalize(xyz.cpu())[-1])):
        fail(f"{name}: Hilbert keys or order differ between card and CPU")
    return {"case": name, "shape": list(xyz.shape),
            "keys_and_order_bit_identical_to_cpu": True}


def phase_big_kernels(model, xyz, nrm, short):
    """``{kernel: [records]}`` of every kernel on PointNet++ SSG's path at
    N=4096 (B=32, normals), timed: FPS 4096→512 and 512→128, the
    standalone ball query at SA1, the given-index pass 1, eval kernel and
    p2 at SA1 (under the keys of the windowed TPU functions they stand
    for, ``*_4096``), the tails and p1 at SA1, SA2's kernels with the ball
    query inside; and the Hilbert keys on the card against the CPU's, on
    the batch and on clouds of ``short`` points padded to 4096."""
    recs = {}

    def add(key, rs):
        recs.setdefault(key, []).extend(rs)

    sa1, sa2 = model.sa1.fused, model.sa2.fused
    keys = [_keys_case("N=4096", xyz),
            _keys_case(f"N={BIG_SHORT} padded to 4096", short)]
    emit("hilbert keys", keys)
    xyz, l1, l2 = _big_layers(model, xyz, nrm)
    nx1 = l1["nx"]
    add("fps", [_fps_case("SSG4096 SA1 4096->512", xyz, 512, True, True),
                _fps_case("SSG4096 SA2 512->128", nx1, 128, True, True)])
    add("ball_query", [_ball_query_case("SSG4096 SA1", nx1, xyz, sa1.radius,
                                        sa1.n_samples, True,
                                        want=("short",))])
    idx, cnt = kbq.ball_query_plain(nx1, xyz, sa1.radius, sa1.n_samples)
    add("fused_sa_eval_4096", [_eval_idx_case(
        "SSG4096 SA1", sa1, l1["q"], l1["off"], idx, cnt, True)])
    window = {"sa_f1": "sa_f1_4096", "sa_bwd_p2": "sa_bwd_p2_4096"}
    for key, rs in _train_case("SSG4096 SA1", l1, True).items():
        add(window.get(key, key), rs)
    for key, rs in _train_case("SSG4096 SA2", l2, True).items():
        add(key, rs)
    with torch.no_grad():  # SA2's serving input: SA1 in eval mode
        out1 = kfs.fused_sa_eval(l1["q"], l1["off"], idx, sa1.sa_params(),
                                 sa1.sa_stats(), cnt=cnt)
        nx2, q2, off2 = sa2.prepare(nx1, out1)
    add("fused_sa_bq_eval", [_bq_case("SSG4096 SA2 serving", sa2,
                                      (nx2, nx1, q2.bfloat16(), off2),
                                      True)])
    return recs


def _check_probs(what, probs, rows):
    if (probs.shape != (rows, 40) or not np.isfinite(probs).all()
            or np.abs(probs.sum(-1) - 1.0).max() > 1e-4):
        fail(f"{what}: probabilities not finite rows of shape ({rows}, 40) "
             f"summing to 1: {probs.shape}")


def phase_large_serving(tag, name, variables, requests, power, per_batch,
                        check):
    """``Predictor(batch_size=32)`` for model ``name`` on ``requests``
    (``(clouds, normals or None)``, one N each) :data:`REPEATS` times:
    exactly ``per_batch`` launches a served batch, finite probabilities,
    repeated requests equal, and ``check`` clouds of each request on the
    card against the CPU within 5e-3."""
    pred = Predictor.from_variables(name, variables, batch_size=BIG_BATCH)
    pred.predict_proba(*(a if a is None else a[:BIG_BATCH]
                         for a in requests[0]))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    secs, outs = [], []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        outs.append([pred.predict_proba(c, nr) for c, nr in requests])
        secs.append(time.perf_counter() - t0)
    batches = REPEATS * sum(-(-len(c) // BIG_BATCH) for c, _ in requests)
    launches = _read_counts(f"{tag} serving", per_batch, batches)
    peak = torch.cuda.max_memory_allocated()

    for (c, _), p in zip(requests, outs[0]):
        _check_probs(tag, p, len(c))
    if any(not all(np.array_equal(a, b) for a, b in zip(o, outs[0]))
           for o in outs[1:]):
        fail(f"{tag}: repeated requests gave different probabilities")
    cpu = Predictor.from_variables(name, variables, batch_size=check,
                                   device="cpu")
    diff, agree = 0.0, 0
    for (c, nr), p in zip(requests, outs[0]):
        ref = cpu.predict_proba(c[:check], None if nr is None else nr[:check])
        diff = max(diff, float(np.abs(ref - p[:check]).max()))
        agree += int((ref.argmax(-1) == p[:check].argmax(-1)).sum())
    if diff > PROB_ATOL:
        fail(f"{tag}: card vs CPU probabilities differ by {diff} > "
             f"{PROB_ATOL}")
    clouds = sum(len(c) for c, _ in requests)
    rates = [clouds / x for x in secs]
    emit(f"serving {tag}", {
        "clouds_per_s": rates, "median_clouds_per_s": float(np.median(rates)),
        "batch": BIG_BATCH, "requests": [list(c.shape) for c, _ in requests],
        "card": power, "launches": launches, "served_batches": batches,
        "peak_device_bytes": peak, "check_clouds": check * len(requests),
        "max_abs_prob_diff_vs_cpu": diff, "argmax_agree_vs_cpu": agree})
    return launches


def phase_big_checks(msg_vars, seg_vars, dg_vars, dseg_vars):
    """Untimed, at N=4096 on 2 clouds: PointNet++ MSG (every MSG1 scale
    from the ball query's idx), PointNet++ and DGCNN part segmentation
    (Hilbert-sorted, their ids back in the caller's point order) and DGCNN
    (the kNN built inside the kernels), each with exact launch counts and
    card against CPU within 5e-3."""
    clouds, normals, _ = SyntheticModelNet(
        n_points=BIG_POINTS, size=2, seed=7).batch(0, 2)
    out = {}
    for name, variables, per in (
            ("pointnet2_msg", msg_vars, {"fps": 2, "ball_query": 4,
                                         "fused_sa_eval": 4,
                                         "fused_sa_bq_eval": 2}),
            ("dgcnn", dg_vars, {"edge_knn_eval": 4})):
        probs = []
        for dev in ("cuda", "cpu"):
            pred = Predictor.from_variables(name, variables, batch_size=2,
                                            device=dev)
            _zero_counts()
            probs.append(pred.predict_proba(clouds, normals))
            if dev == "cuda":
                out[name] = {"launches": _read_counts(
                    f"{name} N=4096", per, 1)}
        _check_probs(f"{name} N=4096", probs[0], 2)
        out[name]["max_abs_prob_diff_vs_cpu"] = diff = float(
            np.abs(probs[0] - probs[1]).max())
        if diff > PROB_ATOL:
            fail(f"{name} N=4096: card vs CPU probabilities differ by {diff}")

    xyz, labels, _ = SyntheticShapeNetPart(
        n_points=BIG_POINTS, size=2, seed=7).batch(0, 2)
    for name, variables, per in (
            (PN2_SEG, seg_vars, {"fps": 2, "ball_query": 1,
                                 "fused_sa_eval": 1, "fused_sa_bq_eval": 1,
                                 "three_interp": 2}),
            (DSEG, dseg_vars, DSEG_SERVE)):
        pred = SegPredictor.from_variables(SEG[name], variables,
                                           batch_size=2)
        _zero_counts()
        probs = pred.predict_proba(xyz, labels)
        out[name] = {"launches": _read_counts(f"{name} N=4096", per, 1),
                     **_seg_against_cpu(name, variables, xyz, labels, probs)}
    emit("checks N=4096", out)


# ------------------------------------------------------ N % 128 != 0


def _odd_inputs(model, x_serve, x_train):
    """``(name, layer, x_serving, x_train)`` of DGCNN's four EdgeConvs on
    the route of N % 128 ≠ 0: the standalone kNN, then the eval chain
    (running statistics) on ``x_serve`` and the train chain (batch
    statistics) on ``x_train``."""
    out, xe, xt = [], x_serve, x_train
    with torch.no_grad():
        for i, ec in enumerate(model.edge):
            f = ec.fused
            out.append((f"EC{i + 1}", f, xe, xt))
            q, off = f.prepare(xe)
            idx = kknn.knn(xe, xe, f.k)[1]
            xe = kfe.fused_edge_eval(q, off, idx, f.bn_scale, f.bn_bias,
                                     kfe.EdgeStats(f.mean, f.var))
            q, off = f.prepare(xt)
            idx = kknn.knn(xt, xt, f.k)[1]
            xt, _ = kfe.fused_edge_conv(q, off, idx, f.bn_scale, f.bn_bias)
    return out


def _per_clouds(fn, *args):
    """``fn`` on :data:`PLAIN_CLOUDS` clouds at a time (its 3-D
    arguments split on the batch axis), outputs joined on it: a plain
    version at N=10,000 within the card's memory (its ``[B, N, k, C]``
    f32 edges are 6.5 GB at B=32)."""
    b = args[0].shape[0]
    return torch.cat([fn(*(a[s:s + PLAIN_CLOUDS] if torch.is_tensor(a)
                           and a.dim() == 3 else a for a in args))
                      for s in range(0, b, PLAIN_CLOUDS)])


def _knn_route_name(b, m, n, c, k) -> str:
    """The route the kNN wrapper takes at these shapes (``knn_route``;
    "block" in a checkout before the routes)."""
    route = getattr(kknn, "knn_route", None)
    return ("block" if route is None
            else kknn.route_name(route(b, m, n, c, k)))


def _knn_case(name, query, points, k, timed):
    """The kNN kernel against its plain version: idx and d² bit-identical;
    with ``timed``, ``torch.cdist`` + ``torch.topk`` (two calls) timed as
    the library's yardstick."""
    d2, idx = kknn.knn(query, points, k)
    wd2, widx = kknn.knn_plain(query, points, k)
    torch.cuda.synchronize()
    if not (torch.equal(idx, widx) and torch.equal(d2, wd2)):
        fail(f"knn {name}: {(idx != widx).sum().item()} indices and "
             f"{(d2 != wd2).sum().item()} distances differ from the plain "
             f"version")
    b, m, c = query.shape
    n = points.shape[1]
    rec = {"case": name, "B": b, "M": m, "N": n, "C": c, "k": k,
           "route": _knn_route_name(b, m, n, c, k),
           "idx_d2_bit_identical": True, "max_abs_err": 0.0}
    if timed:
        rec["ms"] = time_ms(lambda: kknn.knn(query, points, k), 5)
        rec["device_ms"] = graph_ms(lambda: kknn.knn(query, points, k), 5)
        rec["plain_ms"] = time_ms(lambda: kknn.knn_plain(query, points, k),
                                  1, 1)
        rec["library_ms"] = time_ms(lambda: torch.topk(
            torch.cdist(query, points), k, dim=-1, largest=False), 3, 1)
        # d² of every (query, point) pair: 2·C + 3 f32 operations
        rec["bound_ms"], rec["ops_ms"], rec["bytes_ms"] = bound(
            0.0, b * m * n * (2.0 * c + 3.0),
            4.0 * b * (m + n) * c + 8.0 * b * m * k)
    emit("kernel knn", rec)
    return rec


def _edge_idx_case(name, f, xe, xt, g, timed):
    """DGCNN's route at N % 128 ≠ 0 at one layer: the kNN kernel on the
    serving and the train input, ``edge_eval`` on the serving input (at
    N=10,000, its plain version taken :data:`PLAIN_CLOUDS` clouds at a
    time), ``edge_f1`` (h bit-identical), ``edge_out`` and ``edge_bwd``
    on the train input. Returns ``{kernel: [records]}``."""
    k = f.k
    c = f.bn_scale.shape[0]
    recs = {}

    def record(kernel, rec, fn, plain, flops_f32, nbytes):
        if timed:
            rec["ms"] = time_ms(fn, 10)
            rec["plain_ms"] = time_ms(plain, 2, 1)
            rec["bound_ms"], rec["ops_ms"], rec["bytes_ms"] = bound(
                0.0, flops_f32, nbytes)
        emit(f"kernel {kernel}", rec)
        recs.setdefault(kernel, []).append(rec)

    with torch.no_grad():
        for x in (xe, xt):
            recs.setdefault("knn", []).append(_knn_case(
                f"{name} N={x.shape[1]}", x, x, k, timed))
        b, n, cin = xe.shape
        edges = float(b * n * k * c)
        q, off = f.prepare(xe)
        qb = q.bfloat16()
        idx = kknn.knn(xe, xe, k)[1]
        st = kfs._stack_stats(f.mean, f.var, f.bn_scale, f.bn_bias)
        ev = (qb, off, idx, st)
        err = _check_sums(f"edge_eval {name}", kfe.edge_eval(*ev),
                          _per_clouds(kfe.edge_eval_plain, *ev), EDGE_TOL)
        # gather, BN, LeakyReLU and max: ~5 operations an edge element
        record("edge_eval", {"case": f"{name} N={n}", "B": b, "N": n, "k": k,
                             "C": c, **_errs([err])},
               lambda: kfe.edge_eval(*ev),
               lambda: _per_clouds(kfe.edge_eval_plain, *ev), 5.0 * edges,
               2.0 * b * n * c + 4.0 * b * n * k + 8.0 * b * n * c
               + 16.0 * c)

        b, n, cin = xt.shape
        edges = float(b * n * k * c)
        shape = {"B": b, "N": n, "k": k, "C_in": cin, "C": c}
        q, off = f.prepare(xt)
        f1 = (q.bfloat16(), off, kknn.knn(xt, xt, k)[1])
        h, psum = kfe.edge_f1(*f1)
        wh, wpsum = kfe.edge_f1_plain(*f1)
        torch.cuda.synchronize()
        if not torch.equal(h.view(torch.int16), wh.view(torch.int16)):
            fail(f"edge_f1 {name}: h not bit-identical to the plain version")
        rec = {"case": f"{name} N={n}", **shape, "h_bit_identical": True,
               **_errs([_check_sums(f"edge_f1 {name}", psum, wpsum)])}
        del h
        # h, its sum and its square: 4 operations an edge element
        record("edge_f1", rec, lambda: kfe.edge_f1(*f1),
               lambda: kfe.edge_f1_plain(*f1), 4.0 * edges,
               6.0 * b * n * c + 4.0 * b * n * k + 2.0 * edges + 8.0 * c)
        _edge_tail_cases(f"{name} N={n}", f, wh, wpsum, f1[2], g,
                         shape, record)
    return recs


def phase_odd_kernels(model, x_serve, x_train):
    """``{kernel: [records]}`` of the kernels of DGCNN's route at N % 128
    ≠ 0 at the four layers' shapes (serving B=32, N=10,000; training
    B=32, N=1,000; k=20), timed, and edge cases, untimed: duplicate points
    (exact kNN and max-pool ties), k = N, a query cloud other than the
    points, N one past the 64-point tile and N=16,384 at C=128."""
    g = torch.Generator(device=DEV).manual_seed(10)
    recs = {}
    for name, f, xe, xt in _odd_inputs(model, x_serve, x_train):
        for kernel, rs in _edge_idx_case(name, f, xe, xt, g, True).items():
            recs.setdefault(kernel, []).extend(rs)
    dup = x_train[:4].clone()
    dup[:, ODD_TRAIN_POINTS // 2:] = dup[:, :ODD_TRAIN_POINTS // 2]
    _edge_idx_case("EC1 duplicate points", model.edge[0].fused, dup, dup, g,
                   False)
    x = torch.randn((2, 20, 64), generator=g, device=DEV)
    _knn_case("k = N = 20", x, x, 20, False)
    x[:, 10:] = x[:, :10]
    _knn_case("k = N = 20, duplicate points", x, x, 20, False)
    x = torch.randn((2, 65, 3), generator=g, device=DEV)
    _knn_case("N=65, 77 queries", torch.randn((2, 77, 3), generator=g,
                                              device=DEV), x, 40, False)
    x = torch.randn((1, 16384, 128), generator=g, device=DEV)
    _knn_case("N=16384 C=128", x, x, 20, False)
    return recs


# ------------------------------------------- DGCNN part segmentation


def _pair_params(layer):
    return (layer.w2, layer.bn1_scale, layer.bn1_bias, layer.bn2_scale,
            layer.bn2_bias)


def _dseg_layers(model, xyz):
    """``(name, layer, x_serving, x_train)`` of DGCNN part segmentation's
    three EdgeConvs (the two pairs, then EC3) on the main path's data:
    each layer's input in a served batch (the eval chain, running
    statistics) and in a train step (batch statistics), on the route the
    model takes at this N."""
    out, xe, xt = [], xyz, xyz
    with torch.no_grad():
        for name, layer in (("pair1", model.edge1), ("pair2", model.edge2),
                            ("EC3", model.edge3)):
            out.append((name, layer, xe, xt))
            if not isinstance(layer, Fused2EdgeConv):
                break
            xe = layer(xe)  # the model is in eval mode
            q, off = layer.prepare(xt)
            if xt.shape[1] % 128:
                xt = kfe.fused_edge2_conv(q, off, kknn.knn(xt, xt, layer.k)[1],
                                          *_pair_params(layer))[0]
            else:
                xt = kfe.fused_edge2_conv_knn(xt, q, off, *_pair_params(layer),
                                              layer.k)[0]
    return out


def _edge2_case(name, layer, xe, xt, g, timed):
    """The kernels of one two-layer EdgeConv against their plain versions,
    on the route the model takes at this N: ``edge2_knn_eval`` on the
    serving input, or at N % 128 ≠ 0 the kNN kernel's index into
    ``edge2_eval``; pass 1 on the train input (``edge_knn_f1`` or
    ``edge_f1``: idx and h bit-identical), then ``edge2_stats2``,
    ``edge2_out``, ``edge2_p1`` and ``edge2_p2`` from pass 1's plain
    results. Bounds: the eval kernels and ``edge2_out`` within
    1e-5·max|plain| (y1 is bit-identical, h2 sums in another order), every
    Σ, ``ps2``, ``vecs`` and ``mats`` within 1e-3·max|plain|, ``dq`` and
    ``doff`` tie-robust. Returns ``{kernel: [records]}``."""
    k = layer.k
    c1, c2 = layer.w2.shape
    w2 = layer.w2
    recs = {}

    def record(kernel, rec, fn, plain, ops_bf16, ops_f32, nbytes):
        if timed:
            rec["ms"] = time_ms(fn, 10)
            rec["plain_ms"] = time_ms(plain, 2, 1)
            rec["bound_ms"], rec["ops_ms"], rec["bytes_ms"] = bound(
                ops_bf16, ops_f32, nbytes)
        emit(f"kernel {kernel}", rec)
        recs.setdefault(kernel, []).append(rec)

    wbytes = 2.0 * c1 * c2 + 32.0 * (c1 + c2)  # W2 (bf16), the folded rows
    with torch.no_grad():
        b, n, cin = xe.shape
        e = float(b * n * k)
        # the chain: gather, BN1, LeakyReLU (4 an element of y1), the
        # product (bf16 operands), BN2, LeakyReLU and the max (4 an
        # element of y2)
        prod, elem = 2.0 * c1 * c2 * e, (4.0 * c1 + 4.0 * c2) * e
        io = 6.0 * b * n * c1 + 4.0 * b * n * c2 + wbytes
        q, off = layer.prepare(xe)
        st1, st2 = kfe._folded2(*_pair_params(layer)[1:], layer.stats())
        rec = {"case": f"{name} N={n}", "B": b, "N": n, "k": k, "C_in": cin,
               "C1": c1, "C2": c2}
        if n % 128:
            ev = (q.bfloat16(), off, kknn.knn(xe, xe, k)[1], st1, st2, w2)
            kernel, fn, plain = ("edge2_eval", kfe.edge2_eval,
                                 kfe.edge2_eval_plain)
            io += 4.0 * e
        else:
            ev = (xe, q.bfloat16(), off, st1, st2, w2, k)
            kernel, fn, plain = ("edge2_knn_eval", kfe.edge2_knn_eval,
                                 kfe.edge2_knn_eval_plain)
            elem += float(b * n * n) * (2 * cin + 3)  # d² of every pair
            io += 4.0 * b * n * cin
            rec["route"] = _edge_route_label(kknn, "edge_eval_route", b, n,
                                             cin, c2, k, layers=2)
        err = _check_sums(f"{kernel} {name}", fn(*ev), plain(*ev), EDGE_TOL)
        record(kernel, {**rec, **_errs([err])}, lambda: fn(*ev),
               lambda: plain(*ev), prod, elem, io)

        b, n, cin = xt.shape
        e = float(b * n * k)
        shape = {"B": b, "N": n, "k": k, "C_in": cin, "C1": c1, "C2": c2}
        q, off = layer.prepare(xt)
        qb = q.bfloat16()
        if n % 128:
            f1 = (qb, off, kknn.knn(xt, xt, k)[1])
            h, psum = kfe.edge_f1(*f1)
            (wh, wpsum), widx = kfe.edge_f1_plain(*f1), f1[2]
            kernel, fn, plain, ops = ("edge_f1", kfe.edge_f1,
                                      kfe.edge_f1_plain, 0.0)
            same_idx = True
        else:
            f1 = (xt, qb, off, k)
            idx, h, psum = kfe.edge_knn_f1(*f1)
            widx, wh, wpsum = kfe.edge_knn_f1_plain(*f1)
            kernel, fn, plain = ("edge_knn_f1", kfe.edge_knn_f1,
                                 kfe.edge_knn_f1_plain)
            ops = float(b * n * n) * (2 * cin + 3)
            same_idx = torch.equal(idx, widx)
        torch.cuda.synchronize()
        if not same_idx or not torch.equal(h.view(torch.int16),
                                           wh.view(torch.int16)):
            fail(f"{kernel} {name}: idx or h not bit-identical to the plain "
                 f"version")
        del h
        # h, its sum and its square: 4 operations an edge element
        record(kernel, {"case": f"{name} N={n}", **shape,
                        "idx_h_bit_identical": True,
                        **_errs([_check_sums(f"{kernel} {name}", psum,
                                             wpsum)])},
               lambda: fn(*f1), lambda: plain(*f1), 0.0,
               ops + 4.0 * e * c1,
               (4.0 * b * n * cin if ops else 0.0) + 6.0 * b * n * c1
               + 4.0 * e + 2.0 * e * c1 + 8.0 * c1)
        _edge2_train_cases(f"{name} N={n}", layer, wh, wpsum, widx, g, shape,
                           record, timed)
    return recs


def _edge2_train_cases(case, layer, h1, psum, idx, g, shape, record, timed):
    """``edge2_stats2``, ``edge2_out``, ``edge2_p1`` and ``edge2_p2``
    against their plain versions from pass 1's plain ``h1``, sums and
    neighbour index, each from the plain results of the pass before;
    with ``timed``, ``edge2_p1``'s record gains its device time
    (``graph_ms``) beside the event loop's."""
    b, m, k, c1 = h1.shape
    c2 = layer.w2.shape[1]
    w2 = layer.w2
    r = e = float(b * m * k)
    hb = 2.0 * e * c1 + 2.0 * c1 * c2 + 32.0 * (c1 + c2)  # h1, W2, rows
    prod = 2.0 * c1 * c2 * e
    st1 = kfs._stack_stats(*kft._moments(psum, r), layer.bn1_scale,
                           layer.bn1_bias)
    a = (h1, st1, w2)
    want = kfe.edge2_stats2_plain(*a)
    err = _check_sums(f"edge2_stats2 {case}", kfe.edge2_stats2(*a), want)
    # BN1, LeakyReLU (3 an element of y1); the sum and square of h2
    record("edge2_stats2", {"case": case, **shape, **_errs([err])},
           lambda: kfe.edge2_stats2(*a), lambda: kfe.edge2_stats2_plain(*a),
           prod, (3.0 * c1 + 3.0 * c2) * e, hb + 8.0 * c2)
    st2 = kfs._stack_stats(*kft._moments(want, r), layer.bn2_scale,
                           layer.bn2_bias)
    a = (h1, st1, st2, w2)
    err = _check_sums(f"edge2_out {case}", kfe.edge2_out(*a),
                      kfe.edge2_out_plain(*a), EDGE_TOL)
    # BN2, LeakyReLU and the max: 4 an element of y2
    record("edge2_out", {"case": case, **shape, **_errs([err])},
           lambda: kfe.edge2_out(*a), lambda: kfe.edge2_out_plain(*a), prod,
           (3.0 * c1 + 4.0 * c2) * e, hb + 4.0 * b * m * c2)

    dout = torch.randn((b, m, c2), generator=g, device=DEV)
    a = (h1, dout, st1, st2, w2)
    got, want = kfe.edge2_p1(*a), kfe.edge2_p1_plain(*a)
    errs = [_check_sums(f"edge2_p1 {case} {w}", x, y)
            for x, y, w in zip(got, want, ("ps2", "vecs", "mats"))]
    # the chain, the tie split, dz2, x̂2, [y1‖m1‖m1·x̂1] and their sums:
    # ~8 an element of y1 and ~12 of y2; the mats product (bf16)
    rec = {"case": case, **shape, "route": "wgmma, one kernel",
           **_errs(errs)}
    if timed:
        rec["device_ms"] = graph_ms(lambda: kfe.edge2_p1(*a), 5)
    record("edge2_p1", rec,
           lambda: kfe.edge2_p1(*a), lambda: kfe.edge2_p1_plain(*a),
           prod + 2.0 * e * (3 * c1) * (2 * c2), (8.0 * c1 + 12.0 * c2) * e,
           hb + 4.0 * b * m * c2 + 4.0 * (2 * c2 + 3 * c1 + 6 * c1 * c2))
    ps2, vecs, mats = want
    _, s1 = kft._combine_p1(ps2, vecs, mats, st2, w2, r)
    a = (h1, dout, idx, st1, st2, w2, ps2 / r, s1 / r, SLOPE, m)
    got, want = kfe.edge2_p2(*a), kfe.edge2_p2_plain(*a)
    errs = [_check_tie_robust(f"edge2_p2 {case} {w}", x, y)
            for x, y, w in zip(got, want, ("dq", "doff"))]
    # the chain and dz2 as in p1, dh2, the product dh2·W2ᵀ (bf16), dh1,
    # doff's sums and dq's scatter: ~9 an element of y1, ~12 of y2
    record("edge2_p2", {"case": case, **shape, **_errs(errs)},
           lambda: kfe.edge2_p2(*a), lambda: kfe.edge2_p2_plain(*a),
           2.0 * prod, (9.0 * c1 + 12.0 * c2) * e,
           hb + 4.0 * b * m * c2 + 4.0 * e + 8.0 * b * m * c1
           + 16.0 * (c1 + c2))


def phase_dseg_kernels(model, xyz, x_odd):
    """``{kernel: [records]}`` of DGCNN part segmentation's kernels at its
    shapes (B=16, N=2048, k=40, xyz only): the two pairs' two-layer
    kernels and pass 1, and EC3's four EdgeConv kernels
    (:func:`_edge_case`), timed; the route at N % 128 ≠ 0 (N=1,000,
    B=16: the kNN, ``edge2_eval``, ``edge_f1`` and the train kernels),
    ``edge2_eval`` timed; duplicate points (exact kNN and max-pool ties)
    and a small grid (2 clouds of 1,024 points: ``edge2_knn_eval``'s
    block route), untimed."""
    g = torch.Generator(device=DEV).manual_seed(11)
    recs = {}

    def add(found):
        for kernel, rs in found.items():
            recs.setdefault(kernel, []).extend(rs)

    for name, layer, xe, xt in _dseg_layers(model, xyz):
        if isinstance(layer, Fused2EdgeConv):
            add(_edge2_case(f"partseg {name}", layer, xe, xt, g, True))
        else:
            add({kernel: [rec] for kernel, rec in _edge_case(
                f"partseg {name} k={layer.k}", layer, xe, xt, g,
                True).items()})
    dup = xyz[:4].clone()
    dup[:, SEG_POINTS // 2:] = dup[:, :SEG_POINTS // 2]
    _edge2_case("pair1 duplicate points", model.edge1, dup, dup, g, False)
    small = xyz[:2, :SEG_POINTS // 2].contiguous()  # the block route
    _edge2_case("pair1 small grid", model.edge1, small, small, g, False)
    for name, layer, xe, xt in _dseg_layers(model, x_odd)[:2]:
        found = _edge2_case(f"partseg {name}", layer, xe, xt, g,
                            name == "pair2")
        recs.setdefault("edge2_eval", []).extend(found["edge2_eval"])
    return recs


def phase_seg_request(tag, name, variables, clouds, labels, per_batch):
    """One untimed request of ``clouds`` to ``SegPredictor(batch_size=16)``
    for model ``name``: exactly ``per_batch`` launches for its one served
    batch, and the card against the CPU (:func:`_seg_against_cpu`)."""
    pred = SegPredictor.from_variables(SEG[name], variables,
                                       batch_size=SEG_BATCH)
    _zero_counts()
    probs = pred.predict_proba(clouds, labels)
    launches = _read_counts(tag, per_batch, 1)
    rec = _seg_against_cpu(name, variables, clouds, labels, probs)
    return launches, {"launches": launches, "n_points": clouds.shape[1],
                      **rec}


# --------------------------------------------------------- PointConv


def _gather_case(name, points, idx, timed):
    """The row-gather kernel against its plain version: bit-identical,
    zero rows at out-of-range indices; with ``timed``, ``torch.gather``
    timed as the library's yardstick."""
    got = kga.gather_neighbors(points, idx)
    want = kga.gather_neighbors_plain(points, idx)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        fail(f"gather_neighbors {name}: differs from the plain version")
    b, n, c = points.shape
    rows = idx[0].numel()
    sentinels = int(((idx < 0) | (idx >= n)).sum())
    rec = {"case": name, "B": b, "N": n, "C": c, "idx": list(idx.shape),
           "route": _route("gather_route", points.contiguous()),
           "sentinel_rows": sentinels, "bit_identical": True,
           "max_abs_err": 0.0}
    if timed:  # device times: these kernels are shorter than a launch
        rec["ms"] = graph_ms(lambda: kga.gather_neighbors(points, idx), 20)
        rec["launch_rate_ms"] = time_ms(
            lambda: kga.gather_neighbors(points, idx), 20)
        rec["plain_ms"] = graph_ms(
            lambda: kga.gather_neighbors_plain(points, idx), 10)
        flat = idx.reshape(b, -1, 1).long().expand(-1, -1, c)
        rec["library_ms"] = graph_ms(lambda: torch.gather(points, 1, flat),
                                     20)
        # a copy: the index and the source cloud read once, the rows written
        rec["bound_ms"], rec["ops_ms"], rec["bytes_ms"] = bound(
            0.0, 0.0, 4.0 * b * rows + 4.0 * b * n * c + 4.0 * b * rows * c)
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    emit("kernel gather_neighbors", rec)
    return rec


def _knn_gather_case(name, query, points, values, k, stride, timed):
    """The fused kNN + gather kernel against its plain version: idx and
    grouped bit-identical; with ``timed``, ``torch.cdist`` + ``torch.topk``
    + ``torch.gather`` (three calls) timed as the library's yardstick."""
    idx, grouped = kkg.knn_gather(query, points, values, k, stride)
    widx, wgrouped = kkg.knn_gather_plain(query, points, values, k, stride)
    torch.cuda.synchronize()
    if not (torch.equal(idx, widx) and torch.equal(grouped, wgrouped)):
        fail(f"knn_gather {name}: {(idx != widx).sum().item()} indices and "
             f"{(grouped != wgrouped).sum().item()} values differ from the "
             f"plain version")
    b, m, c = query.shape
    n, cv = values.shape[1:]
    rec = {"case": name, "B": b, "M": m, "N": n, "C": c, "Cv": cv, "k": k,
           "stride": stride, "bit_identical": True, "max_abs_err": 0.0}
    if timed:  # device times, as the row gather's
        rec["ms"] = graph_ms(
            lambda: kkg.knn_gather(query, points, values, k, stride), 10)
        rec["launch_rate_ms"] = time_ms(
            lambda: kkg.knn_gather(query, points, values, k, stride), 10)
        rec["plain_ms"] = graph_ms(lambda: kkg.knn_gather_plain(
            query, points, values, k, stride), 3)

        def library():
            _, i = torch.topk(torch.cdist(query, points), k * stride, dim=-1,
                              largest=False)
            return torch.gather(values, 1, i[..., ::stride].reshape(
                b, -1, 1).expand(-1, -1, cv))

        rec["library_ms"] = graph_ms(library, 5)
        # d² of every (query, point) pair at 2·C + 3 f32 operations; the
        # values read once, idx and grouped written once
        rec["bound_ms"], rec["ops_ms"], rec["bytes_ms"] = bound(
            0.0, b * m * n * (2.0 * c + 3.0),
            4.0 * b * n * cv + 4.0 * b * m * k + 4.0 * b * m * k * cv)
    emit("kernel knn_gather", rec)
    return rec


def _record_calls(module, name, calls):
    """Replace ``module.name`` by a recorder that keeps each call's
    arguments (tensors cloned) in ``calls`` and then runs the original;
    returns the original, for :func:`setattr` back. The original counts
    its launches under its module name, the recorder's meanwhile."""
    orig = getattr(module, name)

    def rec(*args):
        calls.append(tuple(a.detach().clone() if torch.is_tensor(a) else a
                           for a in args))
        return orig(*args)

    rec.launches = 0
    setattr(module, name, rec)
    return orig


def _pointconv_calls(model, *inputs):
    """``(gathers, knn_gathers)``: the arguments of every row gather and
    fused kNN + gather of one eval forward of ``model`` on ``inputs``."""
    gathers, fused = [], []
    orig = (_record_calls(kga, "gather_neighbors", gathers),
            _record_calls(kkg, "knn_gather", fused))
    try:
        with torch.no_grad():
            model(*inputs)
    finally:
        kga.gather_neighbors, kkg.knn_gather = orig
    return gathers, fused


def _pointconv_path_calls(model, *inputs):
    """``{kernel: [args]}`` of FPS, the kNN and the 3-NN interpolation in
    one eval forward of ``model``, and of the row scatter-add in one
    train-mode forward and backward (the gathers' gradients)."""
    from pointcloudlib_tpu_torch.ops import dispatch

    calls = {"fps": [], "knn": [], "three_interp": [], "scatter_rows": []}
    spots = ((dispatch._fps_kernel, "fps", "fps"), (kknn, "knn", "knn"),
             (kti, "three_interp_fwd", "three_interp"),
             (kga, "scatter_rows", "scatter_rows"),
             (kkg, "scatter_rows", "scatter_rows"),
             (kti, "scatter_rows", "scatter_rows"))
    orig = [_record_calls(mod, name, calls[key]) for mod, name, key in spots]
    try:
        with torch.no_grad():
            model(*inputs)
        forward = {key: len(args) for key, args in calls.items()}
        model.train()
        out = model(*inputs)
        (out[0] if isinstance(out, tuple) else out).float().sum().backward()
        for key, args in calls.items():  # the eval forward's, the backward's
            if key == "scatter_rows":
                del args[:forward[key]]
            else:
                del args[forward[key]:]
    finally:
        for (mod, name, _), fn in zip(spots, orig):
            setattr(mod, name, fn)
        model.zero_grad(set_to_none=True)
        model.eval()
    return calls


def phase_pointconv_path(cls_model, seg_model, xyz, nrm, seg_xyz):
    """``{kernel: [records]}`` of FPS, ``knn``, ``three_interp`` and
    ``scatter_rows`` at the PointConv paths' own shapes (arguments
    recorded from the models' forward and backward), checked and timed."""
    recs = {}
    onehot = torch.zeros((seg_xyz.shape[0], 16), device=DEV)
    for tag, model, inputs in (("pointconv cls", cls_model, (xyz, nrm)),
                               ("pointconv seg", seg_model,
                                (seg_xyz, onehot))):
        calls = _pointconv_path_calls(model, *inputs)
        for x, m, skip in calls["fps"]:
            recs.setdefault("fps", []).append(_fps_case(
                f"{tag} {x.shape[1]}->{m}", x, m, skip, True))
        for query, points, k in calls["knn"]:
            recs.setdefault("knn", []).append(_knn_case(
                f"{tag} M={query.shape[1]} N={points.shape[1]} k={k}",
                query, points, k, True))
        for query, points, feats in calls["three_interp"]:
            recs.setdefault("three_interp", []).append(_three_interp_case(
                f"{tag} M={query.shape[1]} N={points.shape[1]} "
                f"C={feats.shape[2]}", query, points, feats, True)[0])
        for g, idx, n in calls["scatter_rows"]:
            recs.setdefault("scatter_rows", []).append(_scatter_case(
                f"{tag} backward rows={idx[0].numel()} n={n} "
                f"C={g.shape[-1]}", g, idx, n, True))
    return recs


def phase_pointconv_kernels(cls_model, seg_model, xyz, nrm, seg_xyz):
    """``{kernel: [records]}`` of the two PointConv kernels at the shapes
    of the main paths, their inputs taken from the models' own forward
    (classification at B=32, N=1024 with normals; part segmentation at
    B=16, N=2048), timed; and edge cases, untimed: sentinel indices and a
    2-D idx, M not a multiple of 8, C = 1 and C = 5 (gather); duplicate
    points, k·stride = N, stride 2 and N = 4096 (kNN + gather)."""
    recs = {"gather_neighbors": [], "knn_gather": []}
    onehot = torch.zeros((seg_xyz.shape[0], 16), device=DEV)
    for tag, model, inputs in (("cls", cls_model, (xyz, nrm)),
                               ("seg", seg_model, (seg_xyz, onehot))):
        gathers, fused = _pointconv_calls(model, *inputs)
        for points, idx in gathers:
            recs["gather_neighbors"].append(_gather_case(
                f"{tag} N={points.shape[1]} C={points.shape[2]}", points,
                idx, True))
        for query, points, values, k, stride in fused:
            recs["knn_gather"].append(_knn_gather_case(
                f"{tag} M={query.shape[1]} N={points.shape[1]} "
                f"Cv={values.shape[2]} k={k}", query, points, values, k,
                stride, True))
    got = {k: len(v) for k, v in recs.items()}
    if got != {"gather_neighbors": 5, "knn_gather": 3}:
        fail(f"PointConv kernels: the forwards made {got} calls, expected "
             f"5 row gathers and 3 fused kNN + gathers")

    g = torch.Generator(device=DEV).manual_seed(13)

    def randn(*shape):
        return torch.randn(shape, device=DEV, generator=g)

    pts = randn(4, 300, 5)
    idx = torch.randint(0, 300, (4, 13, 7), device=DEV, generator=g,
                        dtype=torch.int32)
    idx[:, 0, :3] = torch.tensor([300, 305, -1], device=DEV)
    for case, p, i in (("sentinels, M=13, C=5", pts, idx),
                       ("2-D idx, C=1", pts[..., :1], idx[:, :, 0]),
                       ("C=4 float4 rows", pts[..., :4], idx)):
        rec = _gather_case(case, p.contiguous(), i, False)
        if case.startswith("sentinels") and rec["sentinel_rows"] < 12:
            fail("gather_neighbors: the sentinel case has no sentinels")
    x = torch.nn.functional.normalize(randn(2, 4096, 3), dim=-1)
    dup = x[:, :256].repeat(1, 4, 1)  # every point 4 times: exact ties
    for case, q, p, cv, k, stride in (
            ("duplicate points", dup[:, :40], dup, 16, 48, 1),
            ("k·stride = N, stride 2", dup[:, :10, :], dup[:, :64], 20, 32,
             2),
            ("stride 2, M=13, Cv=7", x[:, :13], x[:, :256], 7, 16, 2),
            ("N=4096", x[:, :64], x, 16, 32, 1)):
        vals = torch.cat([p, randn(p.shape[0], p.shape[1], cv - 3)], -1)
        _knn_gather_case(case, q.contiguous(), p.contiguous(), vals, k,
                         stride, False)
    return recs


# TPU kernel replaced: (entry name, source, file:line, key of its records
# and of its launch count[, key of its launch count, prefix of the paths
# counted]). The JAX package's windowed functions run only at N ≥ 4096;
# the port's given-index kernels stand for them there, so their entries
# take the N=4096 cases and the launches of the N=4096 paths.
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
    ("three_interp", "three_interp.cu", PALLAS + "neighbors.py:448",
     "three_interp"),
    ("scatter_rows", "scatter_rows.cu", PALLAS + "gather.py:57",
     "scatter_rows"),
    ("edge_knn_eval", "edge_knn_eval.cu", FUSED_EDGE + ":246",
     "edge_knn_eval"),
    ("edge_knn_f1", "edge_knn_f1.cu", FUSED_EDGE + ":188", "edge_knn_f1"),
    ("edge_out", "edge_out.cu", FUSED_EDGE + ":96", "edge_out"),
    ("edge_bwd", "edge_bwd.cu", FUSED_EDGE + ":133", "edge_bwd"),
    ("knn", "knn.cu", PALLAS + "neighbors.py:155", "knn"),
    ("edge_f1", "edge_f1.cu", FUSED_EDGE + ":72", "edge_f1"),
    ("edge_eval", "edge_eval.cu", FUSED_EDGE + ":111", "edge_eval"),
    ("edge2_stats2", "edge2_tail.cu", FUSED_EDGE + ":574", "edge2_stats2"),
    ("edge2_out", "edge2_tail.cu", FUSED_EDGE + ":595", "edge2_out"),
    ("edge2_p1", "edge2_bwd_p1.cu", FUSED_EDGE + ":615", "edge2_p1"),
    ("edge2_p2", "edge2_bwd_p2.cu", FUSED_EDGE + ":669", "edge2_p2"),
    ("edge2_eval", "edge2_eval.cu", FUSED_EDGE + ":902", "edge2_eval"),
    ("edge2_knn_eval", "edge2_knn_eval.cu", FUSED_EDGE + ":995",
     "edge2_knn_eval"),
    ("gather_neighbors", "gather_rows.cu", PALLAS + "gather.py:39",
     "gather_neighbors"),
    ("knn_gather", "knn_gather.cu", PALLAS + "neighbors.py:306",
     "knn_gather"),
    ("sa_f1 for _k_f1w", "fused_sa_f1.cu", FUSED_SA + ":525", "sa_f1_4096",
     "sa_f1", "ssg4096"),
    ("fused_sa_eval for _k_evalw", "fused_sa_eval.cu", FUSED_SA + ":702",
     "fused_sa_eval_4096", "fused_sa_eval", "ssg4096"),
    ("sa_bwd_p2 for _k_p2w", "fused_sa_bwd_p2.cu", FUSED_SA + ":964",
     "sa_bwd_p2_4096", "sa_bwd_p2", "ssg4096"),
)


def _kernel_entry(name, source, replaces, recs, paths):
    """One entry of the ``kernels`` line: launches summed over the main
    paths (each also given by path), times and bounds summed over the
    timed cases, the largest error over all cases."""
    timed = [r for r in recs if "ms" in r]
    ops = sum(r["ops_ms"] for r in timed)
    byt = sum(r["bytes_ms"] for r in timed)
    library = ([r.get("library_ms") for r in timed]
               if all("library_ms" in r for r in timed) else None)
    extra = {}
    if all("topk_selection_yardstick_ms" in r for r in timed):
        extra["topk_selection_yardstick_ms"] = sum(
            r["topk_selection_yardstick_ms"] for r in timed)
    return {"name": name, "route": "cuda", "source": CSRC + source,
            "replaces": replaces, "launches": sum(paths.values()),
            "launches_by_path": paths,
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": sum(r["ms"] for r in timed),
            "plain_ms": sum(r["plain_ms"] for r in timed),
            "bound_ms": sum(r["bound_ms"] for r in timed),
            "bound_by": "operations" if ops >= byt else "bytes",
            "library_ms": None if library is None else sum(library),
            **extra, "timed_cases": [r["case"] for r in timed]}


def _kernel_ms(fn, calls: int = 3) -> dict:
    """Device milliseconds a call of each CUDA kernel ``fn`` launches
    (torch.profiler over ``calls`` calls)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = evt.cuda_time_total
        if us > 0 and "_kernel" in evt.key:
            name = evt.key.split("<")[0].split("(")[0].replace("void ", "")
            out[name] = out.get(name, 0.0) + us / 1e3 / calls
    return out


def _bwd_layers():
    """``(name, L)`` of every PointNet++ train layer of the main paths, as
    ``main`` makes and names them: SSG SA1 / SA2 (B=64), MSG's six scales
    (B=32), part segmentation's SA1 / SA2 (B=16, N=2048) and SSG at
    N=4096 (B=32)."""
    ssg_vars = random_jax_variables(get_cls_model("pointnet2"), seed=0)
    clouds, normals, _ = SyntheticModelNet(
        n_points=N_POINTS, size=N_CLOUDS, seed=0).batch(0, N_CLOUDS)
    xyz = torch.from_numpy(clouds[:BATCH]).to(DEV)
    nrm = torch.from_numpy(normals[:BATCH]).to(DEV)
    ssg = _model_on_card("pointnet2", ssg_vars)
    yield from _train_layers(ssg, xyz, nrm)[:2]
    msg = _model_on_card("pointnet2_msg", random_jax_variables(
        get_cls_model("pointnet2_msg"), seed=0))
    g = torch.Generator(device=DEV).manual_seed(4)
    for name, sa, nx, pts, q, off in _msg_scales(msg, xyz[:MSG_BATCH],
                                                 nrm[:MSG_BATCH]):
        with torch.no_grad():
            yield name, _train_inputs(sa, nx, pts, q, off, g)
    del msg
    seg = _model_on_card(PN2_SEG, random_jax_variables(
        build_model(PN2_SEG), seed=0))
    seg_xyz = torch.from_numpy(_seg_data(SEG_BATCH)[0]).to(DEV)
    yield from _train_layers(seg, seg_xyz, seg_xyz, "partseg ")[:2]
    del seg
    big, big_n, _ = SyntheticModelNet(
        n_points=BIG_POINTS, size=BIG_CLOUDS - BIG_BATCH, seed=0).batch(
        0, BIG_CLOUDS - BIG_BATCH)
    _, l1, l2 = _big_layers(ssg, torch.from_numpy(big[:BIG_BATCH]).to(DEV),
                            torch.from_numpy(big_n[:BIG_BATCH]).to(DEV))
    yield "SSG4096 SA1", l1
    yield "SSG4096 SA2", l2


def bwd_times() -> None:
    """Device milliseconds a call of ``sa_bwd_p1`` and ``sa_bwd_p2`` at
    every PointNet++ train shape (``graph_ms``), split by the CUDA kernels
    each launches, and each one's largest deviation from its plain
    version over max|plain| (not tie-robust: a near-tie of the max-pool
    can move p2's to a few 1e-2; ``phase_train_kernels`` holds the
    gates): after the device line, one JSON line a case.
    It times the kernels of the package beside this file, so a copy of
    the file in another checkout's root times that checkout's:

        python3 -c 'import chip_smoke; chip_smoke.bwd_times()'
    """
    phase_device()
    _build.build(("fused_sa_bwd_p1", "fused_sa_bwd_p2"))

    def dev(got, want):
        return max(((a.double() - b.double()).abs().max()
                    / b.double().abs().max().clamp_min(1e-30)).item()
                   for a, b in zip(got, want))

    for name, L in _bwd_layers():
        p, (st1, st2, st3) = L["p"], L["st"]
        n = L["pts"].shape[1]
        p1 = (L["h1"], L["dout"], st1, st2, st3, p.w2, p.w3)
        p2 = (L["h1"], L["dout"], L["idx"], st1, st2, st3, p.w2, p.w3,
              *L["us"], n)
        b, m, k, c1 = L["h1"].shape
        with torch.no_grad():
            emit("bwd", {
                "case": name, "B": b, "N": n, "M": m, "k": k,
                "widths": [c1, p.w2.shape[1], p.w3.shape[1]],
                "p1_ms": graph_ms(lambda: kft.sa_bwd_p1(*p1), 5),
                "p2_ms": graph_ms(lambda: kft.sa_bwd_p2(*p2), 5),
                "p1_kernels_ms": _kernel_ms(lambda: kft.sa_bwd_p1(*p1)),
                "p2_kernels_ms": _kernel_ms(lambda: kft.sa_bwd_p2(*p2)),
                "p1_max_dev": dev(kft.sa_bwd_p1(*p1),
                                  kft.sa_bwd_p1_plain(*p1)),
                "p2_max_dev": dev(kft.sa_bwd_p2(*p2),
                                  kft.sa_bwd_p2_plain(*p2))})
        del L
        torch.cuda.empty_cache()


def tail_times() -> None:
    """Device milliseconds a call of ``sa_tail`` stages 2, 3 and 4 at
    every PointNet++ train shape (``graph_ms``), and each one's largest
    deviation from its plain version over max|plain|
    (``phase_train_kernels`` holds the gates): after the device line, one
    JSON line a case. Like ``bwd_times``, it times the kernels of the
    package beside this file:

        python3 -c 'import chip_smoke; chip_smoke.tail_times()'
    """
    phase_device()
    _build.build(("fused_sa_tail",))
    for name, L in _bwd_layers():
        p, (st1, st2, st3) = L["p"], L["st"]
        b, m, k, c1 = L["h1"].shape
        rec = {"case": name, "B": b, "N": L["pts"].shape[1], "M": m,
               "k": k, "widths": [c1, p.w2.shape[1], p.w3.shape[1]]}
        with torch.no_grad():
            for stage in (2, 3, 4):
                args = (stage, L["h1"], st1, st2, st3, p.w2, p.w3)
                rec[f"stage{stage}_ms"] = graph_ms(
                    lambda: kft.sa_tail(*args), 5)
                got, want = kft.sa_tail(*args), kft.sa_tail_plain(*args)
                rec[f"stage{stage}_max_dev"] = (
                    (got.double() - want.double()).abs().max()
                    / want.double().abs().max().clamp_min(1e-30)).item()
        emit("tail", rec)
        del L
        torch.cuda.empty_cache()


def f1_times() -> None:
    """Device milliseconds a call of forward pass 1 at every PointNet++
    train shape (``_bwd_layers``), by the layer's route: ``bq_f1`` (the
    ball query inside) or ``sa_f1`` (the ball query's idx given), by
    ``graph_ms`` (and the CUDA kernels it launches by ``torch.profiler``,
    ``kernels_ms``); whether h1 (and idx, cnt) are bit-identical to the
    plain version's, psum's deviation over max|plain| (reported, not
    held: ``phase_train_kernels`` and the card tests hold them), the
    bound and its share, and the host's µs to enqueue one call
    (``host_us``: the median of three loops of 50 calls without a
    synchronize). After the device line, one JSON line a case.
    Like ``bwd_times``, it times the kernels of the package beside this
    file:

        python3 -c 'import chip_smoke; chip_smoke.f1_times()'
    """
    phase_device()
    _build.build(("fused_sa_bq_f1", "fused_sa_f1"))
    for name, L in _bwd_layers():
        b, m, k, c1 = L["h1"].shape
        with torch.no_grad():
            if L["route"] == "bq":
                args = (L["nx"], L["pts"], L["q"], L["off"], L["radius"], k)
                call = lambda: kft.bq_f1(*args)
                idx, h1, cnt, psum = call()
                same = (torch.equal(idx, L["idx"])
                        and torch.equal(cnt, L["cnt"]))
            else:
                args = (L["q"], L["off"], L["idx"])
                call = lambda: kft.sa_f1(*args)
                h1, psum = call()
                same = True
            same = same and torch.equal(h1.view(torch.int16),
                                        L["h1"].view(torch.int16))
            dev = ((psum.double() - L["psum"].double()).abs().max()
                   / L["psum"].double().abs().max()).item()
            ms = graph_ms(call, 5)
            kernels = _kernel_ms(call)
            host = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(50):
                    call()
                host.append((time.perf_counter() - t0) / 50 * 1e6)
            torch.cuda.synchronize()
        bound_ms, _, bytes_ms = bound(0.0, *_f1_work(L))
        emit("f1", {"case": name, "kernel": ("bq_f1" if L["route"] == "bq"
                                             else "sa_f1"),
                    "B": b, "N": L["pts"].shape[1], "M": m, "k": k, "C1": c1,
                    "cnt_mean": L["cnt"].float().mean().item(), "ms": ms,
                    "kernels_ms": kernels, "host_us": float(np.median(host)),
                    "bit_identical": same, "psum_max_dev": dev,
                    "bound_ms": bound_ms, "bytes_ms": bytes_ms,
                    "share_of_bound": bound_ms / ms})
        del L
        torch.cuda.empty_cache()


def rows_times() -> None:
    """The row scatter-add and the row gather at every shape of the main
    paths, inputs recorded from the models' own forward and backward
    (``_pointconv_path_calls``, ``_pointconv_calls``): the scatters of
    PointNet++ part segmentation's (FP2, FP1), PointConv classification's
    and PointConv part segmentation's train steps and the gathers of the
    PointConv forwards; after the device line, one ``kernel scatter_rows``
    or ``kernel gather_neighbors`` line a call, as ``main`` prints them:
    the route, device ms by CUDA graphs (the wrapper's allocation and any
    memset included), the library call's, the bound and its share, and
    the check against the plain version (held: a failure exits). Like
    ``bwd_times``, it times the kernels of the package beside this file:

        python3 -c 'import chip_smoke; chip_smoke.rows_times()'
    """
    phase_device()
    _build.build(SOURCES)
    clouds, normals, _ = SyntheticModelNet(
        n_points=N_POINTS, size=PC_BATCH, seed=0).batch(0, PC_BATCH)
    xyz, nrm = torch.from_numpy(clouds).to(DEV), torch.from_numpy(
        normals).to(DEV)
    seg_xyz = torch.from_numpy(_seg_data(SEG_BATCH)[0]).to(DEV)
    onehot = torch.zeros((SEG_BATCH, 16), device=DEV)
    for tag, name, inputs in (
            ("partseg", PN2_SEG, (seg_xyz, onehot, seg_xyz)),  # xyz as feats
            ("pointconv cls", "pointconv", (xyz, nrm)),
            ("pointconv seg", PC_SEG, (seg_xyz, onehot))):
        model = _model_on_card(name, random_jax_variables(
            build_model(name), seed=0))
        for g, idx, n in _pointconv_path_calls(model,
                                               *inputs)["scatter_rows"]:
            _scatter_case(f"{tag} backward rows={idx[0].numel()} n={n} "
                          f"C={g.shape[-1]}", g, idx, n, True)
        if name != PN2_SEG:
            for points, idx in _pointconv_calls(model, *inputs)[0]:
                _gather_case(f"{tag} N={points.shape[1]} "
                             f"C={points.shape[2]}", points, idx, True)
        del model
        torch.cuda.empty_cache()


def _knn_path_inputs():
    """``(case, query, points, k)`` of the kNN calls of the main paths:
    DGCNN's four EdgeConvs on the route of N % 128 ≠ 0 (serving, 32
    clouds of 10,000 points; training, 32 of 1,000: ``_odd_inputs``),
    PointConv classification's and part segmentation's (recorded from
    the models' eval forward) and DGCNN part segmentation's kNN route (16
    clouds of 1,000 points, k=40, its three layers: ``_dseg_layers``)."""
    dg = _model_on_card("dgcnn", random_jax_variables(
        get_cls_model("dgcnn"), seed=0))
    odd = SyntheticModelNet(n_points=ODD_SERVE_POINTS, size=DGCNN_BATCH,
                            seed=0).batch(0, DGCNN_BATCH)[0]
    odd_train = synthetic_batch("dgcnn", DGCNN_BATCH, 5,
                                ODD_TRAIN_POINTS)["xyz"].to(DEV)
    layers = _odd_inputs(dg, torch.from_numpy(odd).to(DEV), odd_train)
    del dg
    for j in (0, 1):  # serving, then training
        for name, f, *xs in layers:
            x = xs[j]
            yield f"DGCNN {name} N={x.shape[1]}", x, x, f.k
    del layers
    clouds, normals, _ = SyntheticModelNet(
        n_points=N_POINTS, size=PC_BATCH, seed=0).batch(0, PC_BATCH)
    seg_xyz = torch.from_numpy(_seg_data(SEG_BATCH)[0]).to(DEV)
    for tag, name, inputs in (
            ("PointConv cls", "pointconv", (torch.from_numpy(clouds).to(DEV),
                                            torch.from_numpy(normals).to(DEV))),
            ("PointConv seg", PC_SEG, (seg_xyz, torch.zeros(
                (SEG_BATCH, 16), device=DEV)))):
        model = _model_on_card(name, random_jax_variables(
            build_model(name), seed=0))
        for q, p, k in _pointconv_path_calls(model, *inputs)["knn"]:
            yield f"{tag} M={q.shape[1]} N={p.shape[1]} k={k}", q, p, k
        del model
    dseg = _model_on_card(DSEG, random_jax_variables(build_model(DSEG),
                                                     seed=0))
    x_odd = SyntheticShapeNetPart(n_points=DSEG_ODD_TRAIN, size=SEG_BATCH,
                                  seed=3).batch(0, SEG_BATCH)[0]
    for name, layer, xe, _ in _dseg_layers(dseg, torch.from_numpy(
            x_odd).to(DEV)):
        yield f"DGCNN-seg {name} N={xe.shape[1]}", xe, xe, layer.k


def knn_times() -> None:
    """The kNN at every shape of the main paths (``_knn_path_inputs``):
    after the device line, one ``knn:`` line a call with its route, device
    ms by CUDA graphs (events over three calls above 2·10⁵ point
    channels a cloud, where a graph of repeats would hold gigabytes), the
    library's ``torch.cdist`` + ``torch.topk`` timed the same way, the
    bound (operations at the FMA peak, or bytes) and the plain order's
    floor (twice the operations bound: one instruction an operation) with
    the kernel's share of each, and idx and d² against the plain version
    (bit for bit; two clouds at N ≥ 5,000). Like ``bwd_times``, it times
    the kernels of the package beside this file:

        python3 -c 'import chip_smoke; chip_smoke.knn_times()'
    """
    phase_device()
    _build.build(SOURCES)
    for case, q, p, k in _knn_path_inputs():
        b, m, c = q.shape
        n = p.shape[1]
        big = n * c > 200000

        def timed(fn):
            return time_ms(fn, 3, 1) if big else graph_ms(fn, 10)

        nb = 2 if n >= 5000 else b
        d2, idx = kknn.knn(q[:nb], p[:nb], k)
        wd2, widx = kknn.knn_plain(q[:nb], p[:nb], k)
        same = bool(torch.equal(idx, widx) and torch.equal(d2, wd2))
        del d2, idx, wd2, widx
        ms = timed(lambda: kknn.knn(q, p, k))
        lib = timed(lambda: torch.topk(torch.cdist(q, p), k, dim=-1,
                                       largest=False))
        bound_ms, ops_ms, bytes_ms = bound(
            0.0, b * m * n * (2.0 * c + 3.0),
            4.0 * b * (m + n) * c + 8.0 * b * m * k)
        emit("knn", {"case": case, "B": b, "M": m, "N": n, "C": c, "k": k,
                     "route": _knn_route_name(b, m, n, c, k), "device_ms": ms,
                     "library_ms": lib, "bound_ms": bound_ms,
                     "bound_by": "operations" if ops_ms >= bytes_ms
                     else "bytes", "share_of_bound": bound_ms / ms,
                     "plain_order_floor_ms": 2.0 * ops_ms,
                     "share_of_floor": 2.0 * ops_ms / ms,
                     "bit_identical": same, "checked_clouds": nb})
        if not same:
            fail(f"knn {case}: not bit-identical to the plain version")
        torch.cuda.empty_cache()


def edge2_times() -> None:
    """``edge2_p1`` and ``edge2_p2`` at DGCNN part segmentation's two
    pairs (B=16, N=2048, k=40) and on its kNN route (16 clouds of 1,000
    points), inputs built as ``phase_dseg_kernels`` builds them (pass 1's
    plain h1 and neighbour lists from the model's own train chain, BN
    rows of its batch moments, a seeded output gradient; pass 2's sums
    from the plain pass 1): after the device line, one ``edge2_p1:`` and
    one ``edge2_p2:`` line a case with device ms by CUDA graphs (the
    wrapper's allocations and memsets included), the CUDA kernels' split
    (torch.profiler), the memory one call allocates above its inputs, the
    bound and its share, and the deviation from the plain version: ps2,
    vecs and mats over max|plain| (held to 1e-3), dq and doff tie-robust.
    Like ``bwd_times``, it times the package beside this file:

        python3 -c 'import chip_smoke; chip_smoke.edge2_times()'
    """
    phase_device()
    _build.build(SOURCES)
    dseg = _model_on_card(DSEG, random_jax_variables(build_model(DSEG),
                                                     seed=0))
    x_odd = SyntheticShapeNetPart(n_points=DSEG_ODD_TRAIN, size=SEG_BATCH,
                                  seed=3).batch(0, SEG_BATCH)[0]
    g = torch.Generator(device=DEV).manual_seed(11)
    for x in (torch.from_numpy(_seg_data(SEG_BATCH)[0]).to(DEV),
              torch.from_numpy(x_odd).to(DEV)):
        for name, layer, _, xt in _dseg_layers(dseg, x)[:2]:
            b, n, _ = xt.shape
            k, (c1, c2) = layer.k, layer.w2.shape
            with torch.no_grad():
                q, off = layer.prepare(xt)
                qb = q.bfloat16()
                if n % 128:
                    idx = kknn.knn(xt, xt, k)[1]
                    h1, psum = kfe.edge_f1_plain(qb, off, idx)
                else:
                    idx, h1, psum = kfe.edge_knn_f1_plain(xt, qb, off, k)
                r = float(b * n * k)
                st1 = kfs._stack_stats(*kft._moments(psum, r),
                                       layer.bn1_scale, layer.bn1_bias)
                st2 = kfs._stack_stats(*kft._moments(
                    kfe.edge2_stats2_plain(h1, st1, layer.w2), r),
                    layer.bn2_scale, layer.bn2_bias)
                a = (h1, torch.randn((b, n, c2), generator=g, device=DEV),
                     st1, st2, layer.w2)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                got = kfe.edge2_p1(*a)
                torch.cuda.synchronize()
                call_bytes = torch.cuda.max_memory_allocated() - base
                want = kfe.edge2_p1_plain(*a)
                dev = max(((u - w).abs().max() / w.abs().max()).item()
                          for u, w in zip(got, want))
                del got, want
                ms = graph_ms(lambda: kfe.edge2_p1(*a), 5)
                kernels = _kernel_ms(lambda: kfe.edge2_p1(*a))
            e = r
            bound_ms, ops_ms, bytes_ms = bound(
                2.0 * c1 * c2 * e + 2.0 * e * (3 * c1) * (2 * c2),
                (8.0 * c1 + 12.0 * c2) * e,
                2.0 * e * c1 + 2.0 * c1 * c2 + 32.0 * (c1 + c2)
                + 4.0 * b * n * c2 + 4.0 * (2 * c2 + 3 * c1 + 6 * c1 * c2))
            emit("edge2_p1", {
                "case": f"{name} N={n}", "B": b, "N": n, "k": k, "C1": c1,
                "C2": c2, "device_ms": ms, "kernels_ms": kernels,
                "call_bytes": call_bytes, "bound_ms": bound_ms,
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "share_of_bound": bound_ms / ms, "max_dev": dev})
            if dev > SUM_TOL:
                fail(f"edge2_p1 {name} N={n}: {dev} of max|plain| off")
            with torch.no_grad():
                ps2, vecs, mats = kfe.edge2_p1_plain(*a)
                _, s1 = kft._combine_p1(ps2, vecs, mats, st2, layer.w2, r)
                a = (h1, a[1], idx, st1, st2, layer.w2, ps2 / r, s1 / r, SLOPE,
                     n)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                got = kfe.edge2_p2(*a)
                torch.cuda.synchronize()
                call_bytes = torch.cuda.max_memory_allocated() - base
                errs = [_check_tie_robust(f"edge2_p2 {name} N={n} {w}", u, v)
                        for u, v, w in zip(got, kfe.edge2_p2_plain(*a),
                                           ("dq", "doff"))]
                del got
                ms = graph_ms(lambda: kfe.edge2_p2(*a), 5)
                kernels = _kernel_ms(lambda: kfe.edge2_p2(*a))
            # as _edge2_train_cases counts it: the products h2 and dy1, the
            # elementwise work, h1 and dout read, dq and doff written
            bound_ms, ops_ms, bytes_ms = bound(
                4.0 * c1 * c2 * e, (9.0 * c1 + 12.0 * c2) * e,
                2.0 * e * c1 + 2.0 * c1 * c2 + 32.0 * (c1 + c2)
                + 4.0 * b * n * c2 + 4.0 * e + 8.0 * b * n * c1
                + 16.0 * (c1 + c2))
            emit("edge2_p2", {
                "case": f"{name} N={n}", "B": b, "N": n, "k": k, "C1": c1,
                "C2": c2, "device_ms": ms, "kernels_ms": kernels,
                "call_bytes": call_bytes, "bound_ms": bound_ms,
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "share_of_bound": bound_ms / ms, **_errs(errs)})
            del a, h1
            torch.cuda.empty_cache()


def _edge_f1_bound(b, n, cin, c, k):
    """``bound()`` of ``edge_knn_f1``: the selection's d² of every pair
    and h's sum and square (4 an edge element, f32); x, q and off read,
    idx, h and psum written."""
    e = float(b * n * k)
    return bound(0.0, float(b * n * n) * (2 * cin + 3) + 4.0 * e * c,
                 4.0 * b * n * cin + 6.0 * b * n * c + 4.0 * e + 2.0 * e * c
                 + 8.0 * c)


def _edge_route_label(knn, fn, *shape, layers=0) -> str:
    """The name of the route ``knn.<fn>`` gives these shapes: pass 1's
    (``layers`` 0) or an eval kernel's (1, 2). A checkout from before the
    routes has the block route only, and one from before the eval routes
    names the routes of pass 1 alone."""
    if not hasattr(knn, fn):
        return "block"
    if not layers:
        name = getattr(knn, "edge_route_name", None) or knn.edge_f1_route_name
        return name(getattr(knn, fn)(*shape))
    return knn.edge_route_name(getattr(knn, fn)(*shape, layers=layers),
                               layers)


def _dgcnn_train_layers():
    """``(case, layer, x_serving, x_train)`` of every kNN-inside EdgeConv
    of the main paths, on ``main``'s data: DGCNN's four (B=32, N=1024,
    k=20; ``_edge_inputs``) and its part segmentation's two pairs and
    EC3 (B=16, N=2048, k=40; ``_dseg_layers``)."""
    clouds = SyntheticModelNet(n_points=N_POINTS, size=DGCNN_BATCH,
                               seed=0).batch(0, DGCNN_BATCH)[0]
    dg = _model_on_card("dgcnn", random_jax_variables(
        get_cls_model("dgcnn"), seed=0))
    for name, f, xe, xt in _edge_inputs(dg, torch.from_numpy(clouds).to(DEV)):
        yield f"DGCNN {name}", f, xe, xt
    del dg
    dseg = _model_on_card(DSEG, random_jax_variables(build_model(DSEG),
                                                     seed=0))
    seg_xyz = torch.from_numpy(_seg_data(SEG_BATCH)[0]).to(DEV)
    for name, layer, xe, xt in _dseg_layers(dseg, seg_xyz):
        yield f"DGCNN-seg {name}", layer, xe, xt


def _dgcnn_kernel_calls(case, layer, xe, wh, wpsum, widx, g):
    """``(kernel, call)`` of the other kernels of one kNN-inside layer, on
    the inputs ``phase_dgcnn_kernels`` and ``phase_dseg_kernels`` give
    them: the eval kernel on the serving input, the train kernels from
    pass 1's plain results."""
    b, n, k, c = wh.shape
    r = float(b * n * k)
    q, off = layer.prepare(xe)
    if isinstance(layer, Fused2EdgeConv):
        st1, st2 = kfe._folded2(*_pair_params(layer)[1:], layer.stats())
        ev = (xe, q.bfloat16(), off, st1, st2, layer.w2, layer.k)
        st1 = kfs._stack_stats(*kft._moments(wpsum, r), layer.bn1_scale,
                               layer.bn1_bias)
        st2 = kfs._stack_stats(*kft._moments(kfe.edge2_stats2_plain(
            wh, st1, layer.w2), r), layer.bn2_scale, layer.bn2_bias)
        return [("edge2_knn_eval", lambda: kfe.edge2_knn_eval(*ev)),
                ("edge2_stats2", lambda: kfe.edge2_stats2(wh, st1, layer.w2)),
                ("edge2_out", lambda: kfe.edge2_out(wh, st1, st2, layer.w2))]
    st = kfs._stack_stats(layer.mean, layer.var, layer.bn_scale,
                          layer.bn_bias)
    ev = (xe, q.bfloat16(), off, st, layer.k)
    st = kfs._stack_stats(*kft._moments(wpsum, r), layer.bn_scale,
                          layer.bn_bias)
    bw = (wh, torch.randn((b, n, c), generator=g, device=DEV), widx, st,
          SLOPE, n)
    return [("edge_knn_eval", lambda: kfe.edge_knn_eval(*ev)),
            ("edge_out", lambda: kfe.edge_out(wh, st)),
            ("edge_bwd", lambda: kfe.edge_bwd(*bw))]


def edgef1_times() -> None:
    """``edge_knn_f1`` at its seven launches of the main paths (DGCNN's
    four EdgeConvs, B=32, N=1024, k=20; its part segmentation's pairs and
    EC3, B=16, N=2048, k=40; inputs from the models' own train chains,
    ``_dgcnn_train_layers``): after the device line, one ``edge_knn_f1:``
    line a launch with its route, device ms by CUDA graphs (the wrapper's
    allocations, memset and norms launch included), the bound (the
    selection's operations at the f32 peak, or bytes) and its share, idx
    and h against the plain version (bit for bit) and psum's deviation
    (held to 1e-3·max|plain|). Then one ``dgcnn_kernel:`` line a call of
    the other DGCNN kernels at the same layers, by the same device timing
    (``edge_knn_eval``, ``edge_out`` and ``edge_bwd``; ``edge2_knn_eval``,
    ``edge2_stats2`` and ``edge2_out`` of the pairs), and of
    ``edge2_eval`` at pair 1 on the kNN route (16 clouds of 1,000
    points). Like ``bwd_times``, it times the package beside this file:

        python3 -c 'import chip_smoke; chip_smoke.edgef1_times()'
    """
    phase_device()
    _build.build(SOURCES)
    g = torch.Generator(device=DEV).manual_seed(8)
    for case, layer, xe, xt in _dgcnn_train_layers():
        k = layer.k
        b, n, cin = xt.shape
        with torch.no_grad():
            q, off = layer.prepare(xt)
            f1 = (xt, q.bfloat16(), off, k)
            idx, h, psum = kfe.edge_knn_f1(*f1)
            widx, wh, wpsum = kfe.edge_knn_f1_plain(*f1)
            same = bool(torch.equal(idx, widx) and torch.equal(
                h.view(torch.int16), wh.view(torch.int16)))
            err = _check_sums(f"edge_knn_f1 {case}", psum, wpsum)
            c = h.shape[-1]
            del idx, h
            ms = graph_ms(lambda: kfe.edge_knn_f1(*f1), 10)
            bound_ms, ops_ms, bytes_ms = _edge_f1_bound(b, n, cin, c, k)
            route = _edge_route_label(kknn, "edge_f1_route", b, n, cin, c, k)
            emit("edge_knn_f1", {
                "case": case, "B": b, "N": n, "k": k, "C_in": cin, "C": c,
                "route": route, "device_ms": ms,
                "bound_ms": bound_ms,
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "share_of_bound": bound_ms / ms, "bit_identical": same,
                **_errs([err])})
            if not same:
                fail(f"edge_knn_f1 {case}: idx or h not bit-identical to "
                     f"the plain version")
            for kernel, call in _dgcnn_kernel_calls(case, layer, xe, wh,
                                                    wpsum, widx, g):
                emit("dgcnn_kernel", {"kernel": kernel, "case": case,
                                      "device_ms": graph_ms(call, 10)})
            del wh, widx
            torch.cuda.empty_cache()
    dseg = _model_on_card(DSEG, random_jax_variables(build_model(DSEG),
                                                     seed=0))
    x_odd = SyntheticShapeNetPart(n_points=DSEG_ODD_TRAIN, size=SEG_BATCH,
                                  seed=3).batch(0, SEG_BATCH)[0]
    _, layer, xe, _ = _dseg_layers(dseg, torch.from_numpy(x_odd).to(DEV))[0]
    with torch.no_grad():
        q, off = layer.prepare(xe)
        st1, st2 = kfe._folded2(*_pair_params(layer)[1:], layer.stats())
        ev = (q.bfloat16(), off, kknn.knn(xe, xe, layer.k)[1], st1, st2,
              layer.w2)
        emit("dgcnn_kernel", {"kernel": "edge2_eval",
                              "case": f"DGCNN-seg pair1 N={xe.shape[1]}",
                              "device_ms": graph_ms(
                                  lambda: kfe.edge2_eval(*ev), 10)})


def _edge_eval_bound(layers, b, n, cin, c1, c2, k):
    """``bound()`` of ``edge_knn_eval`` (``layers`` 1) or
    ``edge2_knn_eval`` (2): the selection's d² of every pair (f32); the
    gather, BN, LeakyReLU and max at 5 operations an edge element, or the
    chain's product (bf16) and 4 operations an element of y1 and of y2;
    x, q, off (and W2 and both layers' rows) read and out written."""
    e = float(b * n * k)
    f32 = float(b * n * n) * (2 * cin + 3)
    if layers == 1:
        return bound(0.0, f32 + 5.0 * e * c1, 4.0 * b * n * cin
                     + 10.0 * b * n * c1 + 16.0 * c1)
    return bound(2.0 * c1 * c2 * e, f32 + (4.0 * c1 + 4.0 * c2) * e,
                 4.0 * b * n * cin + 6.0 * b * n * c1 + 4.0 * b * n * c2
                 + 2.0 * c1 * c2 + 32.0 * (c1 + c2))


def edgeeval_times() -> None:
    """``edge_knn_eval`` and ``edge2_knn_eval`` at their seven launches of
    the served paths (DGCNN's four EdgeConvs, B=32, N=1024, k=20; its
    part segmentation's pairs and EC3, B=16, N=2048, k=40; each layer's
    input from the models' serving chains, ``_dgcnn_train_layers``):
    after the device line, one ``edge_eval:`` line a launch with its route
    (``block`` in a checkout from before the routes), device ms by CUDA
    graphs (the wrapper's allocations and the select route's norms launch
    included), the bound and its share, and the deviation from the plain
    version over max|plain| (``edge_knn_eval`` held bit for bit,
    ``edge2_knn_eval`` to 1e-5). Like ``edgef1_times``, it times the
    package beside this file; for old against new, copy this file into
    the other checkout's root and run it there too:

        python3 -c 'import chip_smoke; chip_smoke.edgeeval_times()'
    """
    phase_device()
    _build.build(SOURCES)
    for case, layer, xe, _ in _dgcnn_train_layers():
        b, n, cin = xe.shape
        k = layer.k
        with torch.no_grad():
            q, off = layer.prepare(xe)
            if isinstance(layer, Fused2EdgeConv):
                c1, c2 = layer.w2.shape
                st1, st2 = kfe._folded2(*_pair_params(layer)[1:],
                                        layer.stats())
                args = (xe, q.bfloat16(), off, st1, st2, layer.w2, k)
                layers, fn, plain = (2, kfe.edge2_knn_eval,
                                     kfe.edge2_knn_eval_plain)
            else:
                c1 = c2 = layer.bn_scale.shape[0]
                st = kfs._stack_stats(layer.mean, layer.var, layer.bn_scale,
                                      layer.bn_bias)
                args = (xe, q.bfloat16(), off, st, k)
                layers, fn, plain = (1, kfe.edge_knn_eval,
                                     kfe.edge_knn_eval_plain)
            got, want = fn(*args), plain(*args)
            same = bool(torch.equal(got, want))
            err = _check_sums(f"{fn.__name__} {case}", got, want, EDGE_TOL)
            if layers == 1 and not same:
                fail(f"edge_knn_eval {case}: out not bit-identical to the "
                     f"plain version")
            del got, want
            ms = graph_ms(lambda: fn(*args), 10)
            bound_ms, ops_ms, bytes_ms = _edge_eval_bound(layers, b, n, cin,
                                                          c1, c2, k)
            emit("edge_eval", {
                "kernel": fn.__name__, "case": case, "B": b, "N": n, "k": k,
                "C_in": cin, "C1": c1, "C2": c2,
                "route": _edge_route_label(kknn, "edge_eval_route", b, n,
                                           cin, c2, k, layers=layers),
                "device_ms": ms, "bound_ms": bound_ms,
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "share_of_bound": bound_ms / ms, "bit_identical": same,
                **_errs([err])})
            torch.cuda.empty_cache()


# Every FPS launch of the ported paths: (case, clouds, batch, n_samples of
# each launch in turn, skip_near_origin); a launch after the first takes
# the previous one's centers, as the models' layers do.
FPS_PATHS = (
    ("SSG", "modelnet", BATCH, (512, 128), True),
    ("MSG", "modelnet", MSG_BATCH, (512, 128), True),
    ("partseg", "shapenet", SEG_BATCH, (512, 128), True),
    ("SSG4096", "modelnet4096", BIG_BATCH, (512, 128), True),
    ("pointconv", "modelnet", PC_BATCH, (512, 128), False),
    ("pointconv partseg", "shapenet", SEG_BATCH, (1024, 256, 64, 36), False),
)


def fps_times() -> None:
    """Device milliseconds a call of ``fps`` at every FPS launch of the
    ported paths (``FPS_PATHS``; ``graph_ms``), nanoseconds a pick (the
    m - 1 dependent argmax steps after the seed), the operations bound
    and whether the indices equal the plain version's (reported, not
    held: ``phase_kernels`` and the card tests hold them): after the
    device line, one JSON line a launch. Like ``bwd_times``, it times the
    kernel of the package beside this file:

        python3 -c 'import chip_smoke; chip_smoke.fps_times()'
    """
    phase_device()
    _build.build(("fps",))
    clouds = {
        "modelnet": lambda b: SyntheticModelNet(
            n_points=N_POINTS, size=b, seed=0).batch(0, b)[0],
        "modelnet4096": lambda b: SyntheticModelNet(
            n_points=BIG_POINTS, size=b, seed=0).batch(0, b)[0],
        "shapenet": lambda b: _seg_data(b)[0],
    }
    for case, data, b, samples, skip in FPS_PATHS:
        xyz = torch.from_numpy(clouds[data](b)).to(DEV)
        for m in samples:
            n = xyz.shape[1]
            with torch.no_grad():
                idx = kfps.fps(xyz, m, skip)
                same = torch.equal(idx, kfps.fps_plain(xyz, m, skip))
                ms = graph_ms(lambda: kfps.fps(xyz, m, skip), 10)
            bound_ms = bound(0.0, 10.0 * b * n * (m - 1),
                             12.0 * b * n + 4.0 * b * m)[0]
            emit("fps", {"case": f"{case} {n}->{m}", "B": b, "N": n, "M": m,
                         "skip": skip, "ms": ms,
                         "ns_a_pick": ms * 1e6 / max(m - 1, 1),
                         "bound_ms": bound_ms, "bit_identical": same})
            xyz = geometry.index_points(xyz, idx)
        torch.cuda.empty_cache()


def _eval_layers():
    """``(name, layer, args)`` of every eval-kernel call on the PointNet++
    serving paths, inputs from the models' own forward: SSG SA1 / SA2
    (B=64), MSG's six scales (B=32; MSG2 from MSG1's train-mode output,
    as ``_msg_scales`` makes them), part segmentation's SA1 / SA2 (B=16,
    N=2048) and SSG at N=4096 (B=32, Hilbert-sorted as a request is: SA1
    by the given index, SA2 with the ball query inside). ``args`` are
    ``(new_xyz, pts, q, off)`` for ``fused_sa_bq_eval`` and ``(q, off,
    idx, cnt)`` for ``fused_sa_eval``; q in bf16."""
    ssg_vars = random_jax_variables(get_cls_model("pointnet2"), seed=0)
    clouds, normals, _ = SyntheticModelNet(
        n_points=N_POINTS, size=N_CLOUDS, seed=0).batch(0, N_CLOUDS)
    xyz = torch.from_numpy(clouds[:BATCH]).to(DEV)
    nrm = torch.from_numpy(normals[:BATCH]).to(DEV)
    ssg = _model_on_card("pointnet2", ssg_vars)
    for name, sa, args in _sa_inputs(ssg, xyz, nrm):
        yield name, sa, args
    msg = _model_on_card("pointnet2_msg", random_jax_variables(
        get_cls_model("pointnet2_msg"), seed=0))
    for name, sa, nx, pts, q, off in _msg_scales(msg, xyz[:MSG_BATCH],
                                                 nrm[:MSG_BATCH]):
        if sa.fuses_ball_query(pts.shape[1]):
            yield name, sa, (nx, pts, q.bfloat16(), off)
        else:
            idx, cnt = kbq.ball_query_plain(nx, pts, sa.radius, sa.n_samples)
            yield name, sa, (q.bfloat16(), off, idx, cnt)
    del msg
    seg = _model_on_card(PN2_SEG, random_jax_variables(
        build_model(PN2_SEG), seed=0))
    seg_xyz = torch.from_numpy(_seg_data(SEG_BATCH)[0]).to(DEV)
    for name, sa, args in _sa_inputs(seg, seg_xyz, seg_xyz):
        yield f"partseg {name}", sa, args
    del seg
    big, big_n, _ = SyntheticModelNet(
        n_points=BIG_POINTS, size=BIG_CLOUDS - BIG_BATCH, seed=0).batch(
        0, BIG_CLOUDS - BIG_BATCH)
    sa1, sa2 = ssg.sa1.fused, ssg.sa2.fused
    with torch.no_grad():
        xyz, nrm, _ = spatial.canonicalize(
            torch.from_numpy(big[:BIG_BATCH]).to(DEV),
            torch.from_numpy(big_n[:BIG_BATCH]).to(DEV))
        nx1, q1, off1 = sa1.prepare(xyz, nrm)
        idx, cnt = kbq.ball_query_plain(nx1, xyz, sa1.radius, sa1.n_samples)
        q1 = q1.bfloat16()
        yield "SSG4096 SA1", sa1, (q1, off1, idx, cnt)
        out1 = kfs.fused_sa_eval(q1, off1, idx, sa1.sa_params(),
                                 sa1.sa_stats(), cnt=cnt)
        nx2, q2, off2 = sa2.prepare(nx1, out1)
    yield "SSG4096 SA2", sa2, (nx2, nx1, q2.bfloat16(), off2)


def eval_times() -> None:
    """Device milliseconds a call of ``fused_sa_bq_eval`` and
    ``fused_sa_eval`` (with the ball query's cnt and without) at every
    eval shape of the PointNet++ serving paths (``_eval_layers``): the
    wrapper's call by ``graph_ms`` (the kernel and the folding of its BN
    rows) and the kernel alone by ``torch.profiler``; each one's largest
    deviation from its plain version over max|plain|, the live slots and
    the bound. After the device line, one JSON line a case. Like
    ``bwd_times``, it times the kernels of the package beside this file:

        python3 -c 'import chip_smoke; chip_smoke.eval_times()'
    """
    phase_device()
    _build.build(("fused_sa_bq_eval", "fused_sa_eval"))

    def dev(got, want):
        return ((got.double() - want.double()).abs().max()
                / want.double().abs().max().clamp_min(1e-30)).item()

    for name, sa, args in _eval_layers():
        p, s = sa.sa_params(), sa.sa_stats()
        c1, c2, c3 = p.w2.shape[0], p.w2.shape[1], p.w3.shape[1]
        with torch.no_grad():
            if args[0].dtype == torch.float32:  # the ball query inside
                nx, pts, q, off = args
                r, k = sa.radius, sa.n_samples
                calls = {"": lambda: kfs.fused_sa_bq_eval(
                    nx, pts, q, off, p, s, r, k)}
                want = kfs.fused_sa_bq_eval_plain(nx, pts, q, off, p, s, r,
                                                  k)
                _, cnt = geometry.ball_query(nx, pts, r, k)
                kernel, shape = "fused_sa_bq_eval", (nx.shape[0],
                                                     pts.shape[1],
                                                     nx.shape[1])
                bounds = {"": _bq_eval_bound(nx, pts, q, p, r, k, cnt)[0]}
            else:
                q, off, idx, cnt = args
                k = idx.shape[-1]
                calls = {"": lambda: kfs.fused_sa_eval(q, off, idx, p, s,
                                                       cnt=cnt),
                         "_without_cnt": lambda: kfs.fused_sa_eval(
                             q, off, idx, p, s)}
                want = kfs.fused_sa_eval_plain(q, off, idx, p, s)
                kernel, shape = "fused_sa_eval", (q.shape[0], q.shape[1],
                                                  idx.shape[1])
                bounds = {"": _eval_bound(q, idx, p, cnt)[0],
                          "_without_cnt": _eval_bound(q, idx, p, None)[0]}
            rec = {"case": name, "kernel": kernel,
                   "B": shape[0], "N": shape[1], "M": shape[2], "k": k,
                   "widths": [c1, c2, c3],
                   "live_slots": int(torch.clamp(cnt, 1, k).sum().item()),
                   "cnt_mean": cnt.float().mean().item()}
            for tag, call in calls.items():
                rec[f"ms{tag}"] = graph_ms(call, 5)
                rec[f"kernel_ms{tag}"] = sum(_kernel_ms(call).values())
                rec[f"max_dev{tag}"] = dev(call(), want)
                rec[f"bound_ms{tag}"] = bounds[tag]
        emit("eval", rec)
        torch.cuda.empty_cache()


def _model_on_card(name, variables):
    model = build_model(name)
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
    seg_vars = random_jax_variables(build_model(PN2_SEG), seed=0)
    seg_xyz = torch.from_numpy(_seg_data(SEG_BATCH)[0]).to(DEV)
    seg_recs = phase_seg_kernels(_model_on_card(PN2_SEG, seg_vars), seg_xyz)
    for kernel, rs in seg_recs.items():
        recs.setdefault(kernel, []).extend(rs)
    dseg_vars = random_jax_variables(build_model(DSEG), seed=0)
    x_odd = SyntheticShapeNetPart(n_points=DSEG_ODD_TRAIN, size=SEG_BATCH,
                                  seed=3).batch(0, SEG_BATCH)[0]
    for kernel, rs in phase_dseg_kernels(
            _model_on_card(DSEG, dseg_vars), seg_xyz,
            torch.from_numpy(x_odd).to(DEV)).items():
        recs.setdefault(kernel, []).extend(rs)
    torch.cuda.empty_cache()
    dg_vars = random_jax_variables(get_cls_model("dgcnn"), seed=0)
    dg_model = _model_on_card("dgcnn", dg_vars)
    recs.update(phase_dgcnn_kernels(dg_model, xyz[:DGCNN_BATCH]))
    big, big_n, _ = SyntheticModelNet(
        n_points=BIG_POINTS, size=BIG_CLOUDS - BIG_BATCH, seed=0).batch(
        0, BIG_CLOUDS - BIG_BATCH)
    short, short_n, _ = SyntheticModelNet(
        n_points=BIG_SHORT, size=BIG_BATCH, seed=1).batch(0, BIG_BATCH)
    short_pad = torch.from_numpy(np.concatenate(
        [short, short[:, np.arange(BIG_POINTS - BIG_SHORT) % BIG_SHORT]],
        axis=1)).to(DEV)
    for kernel, rs in phase_big_kernels(
            _model_on_card("pointnet2", ssg_vars),
            torch.from_numpy(big[:BIG_BATCH]).to(DEV),
            torch.from_numpy(big_n[:BIG_BATCH]).to(DEV), short_pad).items():
        recs.setdefault(kernel, []).extend(rs)
    odd_clouds = SyntheticModelNet(
        n_points=ODD_SERVE_POINTS, size=ODD_SERVE_CLOUDS, seed=0).batch(
        0, ODD_SERVE_CLOUDS)[0]
    odd_train = synthetic_batch("dgcnn", DGCNN_BATCH, 5,
                                ODD_TRAIN_POINTS)["xyz"].to(DEV)
    for kernel, rs in phase_odd_kernels(
            dg_model, torch.from_numpy(odd_clouds[:DGCNN_BATCH]).to(DEV),
            odd_train).items():
        recs.setdefault(kernel, []).extend(rs)
    del dg_model
    pc_vars = random_jax_variables(get_cls_model("pointconv"), seed=0)
    pcseg_vars = random_jax_variables(build_model(PC_SEG), seed=0)
    pc_models = (_model_on_card("pointconv", pc_vars),
                 _model_on_card(PC_SEG, pcseg_vars))
    recs.update(phase_pointconv_kernels(*pc_models, xyz[:PC_BATCH],
                                        nrm[:PC_BATCH], seg_xyz))
    for kernel, rs in phase_pointconv_path(*pc_models, xyz[:PC_BATCH],
                                           nrm[:PC_BATCH], seg_xyz).items():
        recs.setdefault(kernel, []).extend(rs)
    del pc_models
    torch.cuda.empty_cache()

    cnt = {"ball_query_cnt": {r["case"].replace(" serving", ""): {
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
        "partseg_serving": phase_seg_serving(PN2_SEG, seg_vars, power,
                                             SEG_SERVE, 2),
        "partseg_train": phase_train(PN2_SEG, seg_vars, power, SEG_BATCH,
                                     SEG_STEP),
        "dgcnn_serving": phase_serving("dgcnn", dg_vars, (clouds, normals),
                                       power, DGCNN_BATCH, DGCNN_SERVE, {}),
        "dgcnn_train": phase_train("dgcnn", dg_vars, power, DGCNN_BATCH,
                                   DGCNN_STEP),
        "ssg4096_serving": phase_large_serving(
            "pointnet2 N=4096", "pointnet2", ssg_vars,
            [(big, big_n), (short, short_n)], power, BIG_SERVE, 2),
        "ssg4096_train": phase_train("pointnet2", ssg_vars, power,
                                     BIG_BATCH, BIG_STEP, BIG_POINTS),
        "dgcnn10k_serving": phase_large_serving(
            "dgcnn N=10000", "dgcnn", dg_vars, [(odd_clouds, None)], power,
            ODD_SERVE, 2),
        "dgcnn1000_train": phase_train("dgcnn", dg_vars, power, DGCNN_BATCH,
                                       ODD_STEP, ODD_TRAIN_POINTS),
    }
    odd, odd_labels, _ = SyntheticShapeNetPart(
        n_points=DSEG_ODD_POINTS, size=DSEG_ODD_CLOUDS, seed=5).batch(
        0, DSEG_ODD_CLOUDS)
    paths["dgcnn_partseg_serving"] = phase_seg_serving(
        DSEG, dseg_vars, power, DSEG_SERVE, DSEG_CHECK)
    paths["dgcnn_partseg5000_serving"], rec = phase_seg_request(
        f"{DSEG} N={DSEG_ODD_POINTS}", DSEG, dseg_vars, odd, odd_labels,
        DSEG_ODD_SERVE)
    emit(f"serving {DSEG} N={DSEG_ODD_POINTS}", rec)
    paths["dgcnn_partseg_train"] = phase_train(DSEG, dseg_vars, power,
                                               SEG_BATCH, DSEG_STEP)
    paths["dgcnn_partseg1000_train"] = phase_train(
        DSEG, dseg_vars, power, DSEG_ODD_BATCH, DSEG_ODD_STEP,
        DSEG_ODD_TRAIN, grad_check=False)
    phase_big_checks(msg_vars, seg_vars, dg_vars, dseg_vars)
    paths["pointconv_serving"] = phase_serving(
        "pointconv", pc_vars, (clouds, normals), power, PC_BATCH, PC_SERVE,
        {})
    paths["pointconv_train"] = phase_train("pointconv", pc_vars, power,
                                           PC_BATCH, PC_STEP)
    paths["pointconv_partseg_serving"] = phase_seg_serving(
        PC_SEG, pcseg_vars, power, PCSEG_SERVE, PC_CHECK)
    paths["pointconv_partseg_train"] = phase_train(
        PC_SEG, pcseg_vars, power, SEG_BATCH, PCSEG_STEP)

    kernels = []
    for name, source, replaces, key, *counted in KERNELS:
        count, prefix = counted if counted else (key, "")
        entry = _kernel_entry(name, source, replaces, recs[key],
                              {p: c[count] for p, c in paths.items()
                               if p.startswith(prefix)})
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
