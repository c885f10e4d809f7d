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
   bit-identical, w and out within 1e-6·max|plain|; each record names
   the lanes a query its wrapper took, ``three_interp.interp_group``)
   and the row
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
   counts exact (``edge_bwd`` and ``edge2_eval`` timed on the device by
   CUDA graphs, the event loop's rate beside it); ``torch.topk`` of the same d² timed as a yardstick of
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
   the bounds above (the ball query on its cull route there, MSG's on its
   scan route, ``ball_query.ball_query_route``; the cull's record gives
   the pairs it tests and the bytes as its bound);
15. kNN-route kernels — DGCNN's four EdgeConvs at N % 128 ≠ 0 (serving
   B=32, N=10,000; training B=32, N=1,000): ``knn`` idx and d²
   bit-identical to the plain version (``torch.cdist`` + ``torch.topk``
   timed as the library's yardstick, two calls; each record names the
   route the wrapper took, ``knn.knn_route``), ``edge_eval``
   bit-identical (``torch.equal``; its plain version taken 8 clouds at a
   time; each record names its route, ``fused_edge.edge_eval_route``,
   and has a device time by CUDA graphs),
   ``edge_f1``'s h bit-identical (each record names its route,
   ``fused_edge.edge_f1_route``), ``edge_out`` and ``edge_bwd`` as in
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
   ``edge2_eval`` timed at both pairs, ``edge_f1`` and the train
   kernels);
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
   those and 9 scatter-adds);
25. PointCNN kernels — the fused kNN + gather at its twelve launches
   (classification at B=32, N=1024, xyz only: (M, N, k, stride) (1024,
   1024, 8, 1), (384, 1024, 12, 2), (128, 384, 16, 2), (128, 128, 16, 3);
   part segmentation at B=16, N=2048: four encoders and four decoders),
   FPS at its five (1024→384→128; 2048→768→384→128) and the scatter-add
   at the twelve of the backward, their arguments recorded from the
   models' eval forward and train-mode backward with seeded weights,
   against their plain versions as in phase 21 (idx and values
   bit-identical, each record naming the route the wrapper took), device
   times from CUDA graphs beside the library's yardsticks;
26. PointNet — ``Predictor(batch_size=64)`` on 256 clouds at N=1024,
   ``make_cls_train_step`` at B=64 (lr 0.1 flat, ``bench.py:168``),
   ``SegPredictor(batch_size=16)`` on 64 clouds at N=2048 and
   ``make_seg_train_step`` at B=16 (lr 0.01), as in phases 6, 7, 9 and 10:
   no kernel launches at all (dense layers, BatchNorm and max), card
   against CPU, the gradient check;
27. PointCNN classification — ``Predictor(batch_size=32)`` (xyz only) and
   ``make_cls_train_step`` at B=32 (lr 0.1 flat): per served batch exactly
   2 launches of FPS and 4 of the fused kNN + gather, per step those and
   4 of the scatter-add;
28. PointCNN part segmentation — ``SegPredictor(batch_size=16)`` and
   ``make_seg_train_step`` at B=16 (lr 0.01): per served batch exactly 3
   launches of FPS and 8 of the fused kNN + gather, per step those and 8
   of the scatter-add; card against CPU on 2 clouds, the gradient check
   on 8;
29. the training CLIs — through ``main(argv)`` on the card: a ModelNet40
   text tree of 64 train and 32 test synthetic clouds (2,048 points × 6
   columns) written to a temporary directory, then ``train_cls --model
   pointnet2`` at B=32, N=1024 on it for 2 epochs of 2 steps: per step
   exactly the SSG step's launches of phase 7, per eval batch 2 of FPS
   and of the ball-query eval kernel; ``--eval`` prints the last epoch's
   OA exactly, as do ``--eval --confusion`` and
   ``Predictor.from_checkpoint(which="current")`` on the test clouds
   (whose probabilities on 8 clouds are within 5e-3 of a CPU Predictor's
   from the same file); ``--eval --votes 2`` runs; ``--resume --epochs 3``
   starts at epoch 2 with the best OA carried; one step on the card and
   one with ``--device cpu`` from the same seed, both without dropout (the
   two generators draw other masks), give first losses within 1e-2
   relative; then ``train_partseg --model dgcnn`` at B=16, N=2048 on 32
   synthetic clouds (per step the DGCNN part-seg step's launches of
   phase 19, per eval batch its served batch's), and one more epoch with
   ``--num-workers 2`` (a fork pool after CUDA is initialised); and
   ``train_cls --model kpconv`` at B=16 with ``--kp-buckets 2`` for 2
   epochs of at most 2 steps (each bucket's steps at its calibrated
   shapes), ``--eval --votes 2`` (``evaluate_voting_kpconv``) and
   ``Predictor.from_checkpoint("kpconv")`` (the uncalibrated shapes, as
   the JAX package's), card against CPU on 8 clouds, each run's launches
   exact as the shapes and the gates give them (the runs' summaries name
   the calibration and the steps of each bucket). Each CLI's runs count
   for the kernels line as a path of their own;
30. KPConv, rigid and deformable — full width (15 blocks, 64 → 1024
   features, 15 kernel points, the 1024-wide head) with seeded weights in
   the JAX layout, the pyramid calibrated as ``bench.py:129-155`` does on
   its 16 surface clouds at N=1024 (0.9 occupancy quantile, margin 1.0;
   each variant's own architecture), on the card and on the CPU
   (equal): the launch counts the shapes and gates give (per served
   batch 6 of ``knn`` and 11 of the row gather, per step those and 11 of
   the scatter-add) must be those expected; two pyramid builds on the
   card bit-identical and equal to the CPU's; ``knn`` at its six
   launches (masked supports at 1e9) bit-identical, the row gather at its
   11 and the scatter-add at its 11 (arguments recorded from the model)
   against their plain versions as in phase 21, device times by CUDA
   graphs with bound and library yardstick, summed into a ``kernel
   column`` line; then ``Predictor(batch_size=16)`` as phase 6 (three
   requests of 256 clouds, one at N=1000, exact launches a batch, 8
   clouds against the CPU within 5e-3) and ``make_cls_train_step`` at
   B=16 as phase 7 with the gradient check: the rigid model at lr 0.1,
   momentum 0.9 (``bench.py:168``), the deformable one by the CLI's
   KPConv recipe (clip 100, momentum 0.98, lr 1e-2, offsets at 0.1 ×;
   ``bench.py``'s step diverges from its seeded weights); for the
   deformable model first its regulariser (finite, positive, and the
   first step's loss the cross entropy plus it);
31. KPConv on large clouds — ``Predictor.from_variables("kpconv")`` at
   its uncalibrated shapes (as ``from_checkpoint`` builds it) serving
   batches of 16 clouds of 4,096 and of 5,000 points: after a warm-up,
   three timed runs of 50 batches, exact launches over them (the kNN six
   times a batch, two of them on its rank route: layer 2 holds 256 / 312
   supports and asks for k = 41), each run's rate and the rate over all,
   finite rows, 2 clouds within 5e-3 of the CPU's probabilities and
   within 1e-4 of the CPU's largest logit (the random weights saturate
   the softmax); then the rank route at those two launches (self and
   pools, recorded from the pyramid) and at k = 76 and 42 on the same
   layer, bit for bit against ``knn_plain``, timed (device ms by CUDA
   graphs, plain, ``torch.cdist`` + ``torch.topk``, bound);
32. data parallelism (``parallel/``, the step factories' ``group=``): a
   world of 1 over NCCL, PointNet at B=64 bit-identical to its step
   without a group and PointNet++ SSG at B=64 (N=1024, normals)
   bit-identical where two steps without a group are, else, as such a
   second step, under ``tools/grad_check.py``'s bounds (its kernels'
   atomic sums are not bit-reproducible run to run), both timed against
   the step without a group; then two processes on the one card over
   gloo (CUDA tensors) against one process on the whole batch, SSG at
   B=64 (32 a rank) and one DGCNN part-segmentation step at B=16
   (N=2048): the ranks' gradients equal to each other and within
   ``tools/grad_check.py``'s bounds, the loss within 1e-4 relative and
   every BN statistic within 1e-4 (where one process's own spread over
   three orders of the clouds is larger, 2× that spread, named in the
   line); two faults planted in the ranks' steps (BatchNorm on each
   rank's rows only; the gradients' mean and sum swapped) must fail that
   check; the phase's seconds.

The line before the ``nvidia-smi`` line is ``{"kernels": [...]}``, one
entry per TPU kernel replaced (thirty-one; the three forward tails
share one source and one wrapper, counted per stage; the given-index
``sa_f1``, ``fused_sa_eval`` and ``sa_bwd_p2`` have a second entry each
for the windowed function they stand for at N ≥ 4096, with the N=4096
cases and the launches of the N=4096 paths; ``edge_knn_eval``'s entry
adds the ``torch.topk`` yardstick; the kNN's rank route, which takes
the lists of more than 40 that ``knn_pallas`` takes too, has an entry
of its own, with phase 31's cases and launches; an entry whose records
name routes or lane groups lists them as ``kernel_routes``); the last
line is
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
DGCNN kernels), ``edgeeval_times`` (the two eval kernels with the kNN
inside at their seven served launches, with their routes) and
``edgebwd_times`` (the EdgeConv backward at its ten launches of the main
paths, and ``edge2_eval`` at both pairs on part segmentation's kNN
route), ``interp_times`` (the 3-NN interpolation at its six launches
and ``edge_f1`` at its seven, with the lane group or route, bound and
the instance's registers) and ``neighbor_times`` (the fused kNN + gather
at its fifteen launches and the ball query at its three, with the route,
bound and the pairs the ball query's cull route tests).
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import pointcloudlib_tpu_torch.train.trainer as trainer
from pointcloudlib_tpu_torch.data.synthetic import (
    SyntheticModelNet,
    SyntheticShapeNetPart,
)
from pointcloudlib_tpu_torch.inference import Predictor, SegPredictor
from pointcloudlib_tpu_torch.models import get_cls_model
from pointcloudlib_tpu_torch.models.dgcnn import DGCNNPartSeg, Fused2EdgeConv
from pointcloudlib_tpu_torch.models.kpconv.calibrate import bench_calibration
from pointcloudlib_tpu_torch.models.kpconv.pyramid import (
    KNN_MIN_SUPPORTS,
    _far_supports,
    layer_blocks,
    pyramid_shapes,
)
from pointcloudlib_tpu_torch.models.pointnet2 import (
    PointNet2MSG,
    PointNet2PartSeg,
    PointNet2SSG,
)
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
from pointcloudlib_tpu_torch.parallel import (
    init_group,
    rank_seed,
    run_ranks,
    sync_batchnorm,
)
from pointcloudlib_tpu_torch.tools.grad_check import (
    GRAD_COS,
    GRAD_NORM,
    LOSS_RTOL,
    NORMALS,
    SEG,
    build_model,
    cancelled_by_structure,
    compare_grads,
    grad_agreement,
    model_grads,
    synthetic_batch,
)
from pointcloudlib_tpu_torch.train import (
    KPCONV_CLIP_NORM,
    kpconv_optimizer,
    make_cls_train_step,
    make_seg_train_step,
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
MSG_BATCH = 32                 # the JAX package's MSG classification row
BQ_ATOL = BQ_RTOL = 1e-2
PROB_ATOL = 5e-3
SUM_TOL = 1e-3                 # Σ/Σ² of the train kernels, × max|plain|
TRAIN_STEPS, WARMUP_STEPS, CHECK_CLOUDS = 10, 2, 8
# untimed steps that look again at a parameter the timed steps left
# where it was: one that any of them moves did take its updates
RECHECK_STEPS = 3
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
PN_BATCH, PCNN_BATCH = 64, 32      # bench.py:334-335, 342-343 (xyz only)
CLS_LR = 0.1                       # bench.py:168, PointNet and PointCNN
PN_SEG, PCNN_SEG = "pointnet_partseg", "pointcnn_partseg"  # grad_check's
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
SEG_CHECK = 2                      # PointNet / PointCNN part-seg clouds, too
KP_BATCH = 16                      # bench.py:346-347 (xyz only)
KP_NAMES = ("kpconv", "kpconv_deform")
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


def _ptxas(name: str) -> list:
    """Registers, static shared memory and spills of each kernel of
    ``csrc/<name>.cu``, from its ``-Xptxas -v`` report."""
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
    return entries


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.build(SOURCES)
    secs = time.perf_counter() - t0
    emit("build", {"seconds": round(secs, 3),
                   "ptxas": {name: _ptxas(name) for name in SOURCES}})


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
# PointNet: dense layers, BatchNorm and max only. PointCNN: FPS where a
# layer keeps fewer points, every layer's dilated kNN and gather of [xyz ‖
# features] by the fused kNN + gather, its backward the scatter-add
PN_SERVE = PN_STEP = {}
PCNN_SERVE = {"fps": 2, "knn_gather": 4}
PCNN_STEP = {**PCNN_SERVE, "scatter_rows": 4}
PCNNSEG_SERVE = {"fps": 3, "knn_gather": 8}
PCNNSEG_STEP = {**PCNNSEG_SERVE, "scatter_rows": 8}
# KPConv at bench.py's calibration of its 16 clouds (caps 896, 640, 256,
# 80, 24): the kNN over the supports of layers 0-2 (self-neighbours and
# pools), the row gather of layers 0-2 (the first block's is narrow: 4
# channels), the scatter-add of each of those in the backward
KP_SERVE = {"knn": 6, "gather_neighbors": 11}
KP_STEP = {**KP_SERVE, "scatter_rows": 11}


def _zero_counts() -> None:
    for fn in COUNTED.values():
        fn.launches = 0
    for stage in kft.sa_tail.launches_by_stage:
        kft.sa_tail.launches_by_stage[stage] = 0
    for route in kknn.knn.launches_by_route:
        kknn.knn.launches_by_route[route] = 0


def _read_counts(what: str, per_unit: dict, units: int) -> dict:
    """The launch counts since :func:`_zero_counts`, with the tail's per
    stage; fails unless each kernel launched exactly ``per_unit`` times
    for each of the ``units`` batches or steps."""
    return _read_totals(f"{what} ({units} batches or steps)",
                        {name: c * units for name, c in per_unit.items()})


def _read_totals(what: str, want: dict) -> dict:
    """As :func:`_read_counts`, against ``want`` launches in all; the
    kNN's launches on its rank route (lists longer than 40) are also
    counted on their own, as ``knn_rank``."""
    launches = {name: fn.launches for name, fn in COUNTED.items()}
    launches["knn_rank"] = kknn.knn.launches_by_route[kknn.RANK_ROUTE]
    for name, count in launches.items():
        if count != want.get(name, 0):
            fail(f"{what}: {name} launched {count} times; expected "
                 f"{want.get(name, 0)}")
    by_stage = dict(kft.sa_tail.launches_by_stage)
    if any(3 * c != launches["sa_tail"] for c in by_stage.values()):
        fail(f"{what}: tail stages launched unevenly: {by_stage}")
    launches.update({f"sa_tail_{st}": c for st, c in by_stage.items()})
    return launches


def _predictor(name, variables, batch, build=None, device=None):
    """A Predictor of model ``name`` with ``variables``: built by the
    registry's defaults, or by ``build()`` (KPConv's calibrated shapes)
    with the weights loaded."""
    if build is None:
        return Predictor.from_variables(name, variables, batch_size=batch,
                                        with_normals=name in NORMALS,
                                        device=device)
    model = from_jax_variables(build(), variables)
    return Predictor(model, with_normals=name in NORMALS, batch_size=batch,
                     device=device)


def phase_serving(name, variables, data, power, batch, per_batch, extra,
                  build=None):
    clouds, normals = data
    pred = _predictor(name, variables, batch, build)
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

    cpu = _predictor(name, variables, 8, build, device="cpu")
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


# DGCNN kernels whose records also time the device by CUDA graphs
# (graph_ms), beside the event loop's ms
DEVICE_TIMED = ("edge_bwd", "edge2_eval", "edge_f1", "edge_out", "edge_eval")


def _kernel_time(kernel, rec, fn) -> None:
    """A timed DGCNN record's ``ms`` by the event loop and, for
    ``DEVICE_TIMED``, its ``device_ms``."""
    rec["ms"] = time_ms(fn, 10)
    if kernel in DEVICE_TIMED:
        rec["device_ms"] = graph_ms(fn, 10)


def _check_sums(what, got, want, tol=SUM_TOL):
    """``(max |Δ|, max |plain|)``; fails beyond ``tol``·max|plain|."""
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if not torch.isfinite(got).all() or not err <= tol * scale:
        fail(f"{what}: |Δ| {err} beyond {tol}·max|plain| ({scale})")
    return err, scale


def _check_equal(what, got, want):
    """``(0.0, max |plain|)``; fails unless ``torch.equal`` (which counts
    -0 and +0 as equal)."""
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"{what}: {(got != want).sum().item()} elements differ from the "
             f"plain version (max |Δ| {(got - want).abs().max().item()})")
    return 0.0, want.abs().max().item()


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
    route = kbq.ball_query_route(n)
    rec = {"case": name, "B": b, "N": n, "M": m, "k": k, "radius": radius,
           "route": kbq.ROUTES[route], "bit_identical": True,
           "max_abs_err": 0.0, "cnt_mean": cnt.float().mean().item(),
           "cnt_max": cnt.max().item(), "rows": kinds}
    if timed:
        rec["ms"] = time_ms(lambda: kbq.ball_query(nx, pts, radius, k), 20)
        rec["device_ms"] = graph_ms(
            lambda: kbq.ball_query(nx, pts, radius, k), 20)
        rec["plain_ms"] = time_ms(
            lambda: kbq.ball_query_plain(nx, pts, radius, k), 3, 1)
        rec.update(_ball_query_bound(nx, pts, radius, k))
    emit("kernel ball_query", rec)
    return rec


def _ball_query_bound(nx, pts, radius, k) -> dict:
    """The ball query's bound: on the scan route every (center, point)
    pair at ~10 f32 operations (cnt counts all hits) beside the bytes; on
    the cull route the bytes alone, since the pairs it tests (given as
    ``pairs_tested``) depend on the data and are no floor."""
    b, m, _ = nx.shape
    n = pts.shape[1]
    out = {"pairs": b * m * n}
    ops = 10.0 * b * m * n
    route = getattr(kbq, "ball_query_route", None)  # none before the cull
    if route and route(n) == 1:
        out["pairs_tested"] = kbq.pairs_tested(nx, pts, radius)
        ops = 0.0
    out["bound_ms"], out["ops_ms"], out["bytes_ms"] = bound(
        0.0, ops, 12.0 * b * (m + n) + 4.0 * b * m * (k + 1))
    return out


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


def _moved_by_a_step(step, batch, gen, model, keys):
    """The entries of ``keys`` that one of :data:`RECHECK_STEPS` further
    train steps changes. A parameter whose gradient is all but 0 takes
    updates of a few f32 units of either sign, and the timed steps' net
    change can come back to exactly 0: PointConv's DensityNet ends in
    ReLU(BN), and while that BN's shift is near 0 its scale only scales
    the layer's density, which the layer's own train-mode BN cancels. A
    parameter that no step reaches never moves."""
    state = model.state_dict()
    moved = set()
    for _ in range(RECHECK_STEPS):
        before = {k: state[k].detach().clone() for k in keys
                  if k not in moved}
        step(batch, gen)
        moved.update(k for k, v in before.items()
                     if not torch.equal(v, state[k]))
    return moved


def phase_train(name, variables, power, batch_size, per_step,
                n_points=None, grad_check=True, model_kw=None, recipe=None):
    """``name`` trains at ``batch_size``: a classification model on
    ModelNet40-shaped clouds at N=1024 (or ``n_points``) with the
    reference's flat lr, or a part-segmentation model (:data:`SEG`) on
    ShapeNet-part-shaped clouds at N=2048 with lr 0.01, built with
    ``model_kw`` (KPConv's pyramid shapes), or with ``recipe(model) →
    (optimizer, clip norm, description)`` in place of SGD at that lr;
    with ``grad_check`` the card-vs-CPU gradient check follows."""
    tag = name if n_points is None else f"{name} N={n_points}"
    if n_points is None:
        n_points = SEG_POINTS if name in SEG else N_POINTS
    batch = {k: v.to(DEV) for k, v in synthetic_batch(
        name, batch_size, 5, n_points).items()}
    model = build_model(name, **(model_kw or {}))
    from_jax_variables(model, variables)
    flat_lr = {"dgcnn": DGCNN_LR, "pointconv": PC_LR, "pointnet": CLS_LR,
               "pointcnn": CLS_LR, "kpconv": CLS_LR,
               "kpconv_deform": CLS_LR}
    if name in SEG:
        lr, make = SEG_LR, make_seg_train_step
    elif name in flat_lr:
        lr, make = flat_lr[name], make_cls_train_step
    else:  # ModelNet40's training set
        lr, make = reference_flat_lr(0.02, 9840, batch_size), \
            make_cls_train_step
    if recipe is None:
        opt = sgd_momentum(model.parameters(), lr)
        step = make(model, opt)
    else:
        opt, clip, lr = recipe(model)
        step = make(model, opt, clip_norm=clip)
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
    # may leave a parameter where it was: the structural ones of
    # grad_check.cancelled_by_structure, PointNet++'s SA3 last BN bias
    # and DGCNN part segmentation's conv6 BN bias (0 where the pooled
    # values are positive throughout); so may a parameter whose last
    # update rounds away in every element
    cancelled = cancelled_by_structure(model)
    if isinstance(model, (PointNet2SSG, PointNet2MSG, PointNet2PartSeg)):
        cancelled.add("sa3.mlp.2.bn.bias")
    if isinstance(model, DGCNNPartSeg):
        cancelled.add("conv6.bn.bias")
    params = dict(model.named_parameters())
    stuck = [k for k in still if k not in cancelled
             and not (k in params and _update_rounds_away(params[k], opt))]
    if stuck:
        moved = _moved_by_a_step(step, batch, gen, model, stuck)
        stuck = [k for k in stuck if k not in moved]
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
           "group": _interp_group(b, m),
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


def _interp_group(b, m):
    """The lanes a query ``three_interp`` takes at these shapes
    (``three_interp.interp_group``; None in a checkout before the lane
    groups)."""
    group = getattr(kti, "interp_group", None)
    return group(b, m) if group else None


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
            _kernel_time(kernel, rec, fn)
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


def _edge_eval_route_name(c) -> str:
    """The route ``edge_eval`` takes at width ``c``
    (``fused_edge.edge_eval_route``; ``rows`` in a checkout before the
    routes)."""
    route = getattr(kfe, "edge_eval_route", None)
    return "rows" if route is None else kfe.EDGE_EVAL_ROUTES[route(c)]


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
            _kernel_time(kernel, rec, fn)
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
        err = _check_equal(f"edge_eval {name}", kfe.edge_eval(*ev),
                           _per_clouds(kfe.edge_eval_plain, *ev))
        # gather, BN, LeakyReLU and max: ~5 operations an edge element
        record("edge_eval", {"case": f"{name} N={n}", "B": b, "N": n, "k": k,
                             "C": c, "route": _edge_eval_route_name(c),
                             "bit_identical": True, **_errs([err])},
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
        rec = {"case": f"{name} N={n}", **shape,
               "route": _edge_f1_route_name(c), "h_bit_identical": True,
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
            _kernel_time(kernel, rec, fn)
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
        route = ({"route": _edge_f1_route_name(c1)} if kernel == "edge_f1"
                 else {})
        record(kernel, {"case": f"{name} N={n}", **shape, **route,
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
        found = _edge2_case(f"partseg {name}", layer, xe, xt, g, True)
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
           "stride": stride,
           "route": kkg.ROUTES[kkg.knn_gather_route(n, k, stride)],
           "bit_identical": True, "max_abs_err": 0.0}
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


def _gather_calls(model, *inputs):
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


def _path_calls(model, *inputs):
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


def phase_path_kernels(paths):
    """``{kernel: [records]}`` of the kernels at the model paths' own
    shapes, for each ``(tag, model, inputs, want)`` of ``paths``: the row
    gather and the fused kNN + gather (idx and values bit-identical, the
    route the wrapper took named, ``torch.cdist`` + ``torch.topk`` +
    ``torch.gather`` timed as the yardstick), FPS, ``knn`` and the 3-NN
    interpolation with their arguments recorded from the model's eval
    forward, the row scatter-add from its train-mode backward; each
    against its plain version, timed by CUDA graphs. Fails where a path
    made other than ``want[kernel]`` calls of a kernel ``want`` names."""
    recs = {}
    for tag, model, inputs, want in paths:
        got = dict.fromkeys(want, 0)

        def add(kernel, rec):
            recs.setdefault(kernel, []).append(rec)
            got[kernel] = got.get(kernel, 0) + 1

        gathers, fused = _gather_calls(model, *inputs)
        for points, idx in gathers:
            add("gather_neighbors", _gather_case(
                f"{tag} N={points.shape[1]} C={points.shape[2]}", points,
                idx, True))
        for query, points, values, k, stride in fused:
            add("knn_gather", _knn_gather_case(
                f"{tag} M={query.shape[1]} N={points.shape[1]} "
                f"Cv={values.shape[2]} k={k} stride={stride}", query,
                points, values, k, stride, True))
        del gathers, fused
        calls = _path_calls(model, *inputs)
        for x, m, skip in calls["fps"]:
            add("fps", _fps_case(f"{tag} {x.shape[1]}->{m}", x, m, skip,
                                 True))
        for query, points, k in calls["knn"]:
            add("knn", _knn_case(
                f"{tag} M={query.shape[1]} N={points.shape[1]} k={k}",
                query, points, k, True))
        for query, points, feats in calls["three_interp"]:
            add("three_interp", _three_interp_case(
                f"{tag} M={query.shape[1]} N={points.shape[1]} "
                f"C={feats.shape[2]}", query, points, feats, True)[0])
        for g, idx, n in calls["scatter_rows"]:
            add("scatter_rows", _scatter_case(
                f"{tag} backward rows={idx[0].numel()} n={n} "
                f"C={g.shape[-1]}", g, idx, n, True))
        del calls
        torch.cuda.empty_cache()
        got = {k: got[k] for k in want}
        if got != want:
            fail(f"{tag}: the model made {got} calls, expected {want}")
    return recs


def phase_gather_edge_cases():
    """The row gather and the fused kNN + gather against their plain
    versions at edge cases, untimed: sentinel indices and a 2-D idx, M
    not a multiple of 8, C = 1 and C = 5 (gather); duplicate points,
    k·stride = N, stride 2 and N = 4096 (kNN + gather)."""
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
    ("knn rank route (k > 40)", "knn.cu", PALLAS + "neighbors.py:155",
     "knn_rank", "knn_rank", "kpconv_large"),
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
    if timed and all("device_ms" in r for r in timed):
        extra["device_ms"] = sum(r["device_ms"] for r in timed)
    if all("topk_selection_yardstick_ms" in r for r in timed):
        extra["topk_selection_yardstick_ms"] = sum(
            r["topk_selection_yardstick_ms"] for r in timed)
    routes = sorted({str(r[key]) for r in recs for key in ("route", "group")
                     if r.get(key) is not None})
    if routes:  # the wrapper's routes or lane groups the cases took
        extra["kernel_routes"] = routes
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
    (``_path_calls``, ``_gather_calls``): the scatters of
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
        for g, idx, n in _path_calls(model,
                                               *inputs)["scatter_rows"]:
            _scatter_case(f"{tag} backward rows={idx[0].numel()} n={n} "
                          f"C={g.shape[-1]}", g, idx, n, True)
        if name != PN2_SEG:
            for points, idx in _gather_calls(model, *inputs)[0]:
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
        for q, p, k in _path_calls(model, *inputs)["knn"]:
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


def tail2_times() -> None:
    """``edge2_stats2`` and ``edge2_out`` at DGCNN part segmentation's two
    pairs (B=16, N=2048, k=40) and on its kNN route (16 clouds of 1,000
    points), inputs built as ``edge2_times`` builds them (pass 1's plain
    h1 from the model's own train chain, BN rows of its batch moments):
    after the device line and the kernels' registers and spills, one
    ``edge2_tail:`` line a kernel and case with device ms by CUDA graphs
    (stats2 with the wrapper's memset), the bound and its share, and the
    deviation from the plain version over max|plain| (held to 1e-3 for
    the sums, 1e-5 for out). It times the package beside this file; for
    old against new, copy this file into the other checkout's root and
    run it there too:

        python3 -c 'import chip_smoke; chip_smoke.tail2_times()'
    """
    phase_device()
    _build.build(SOURCES)
    emit("edge2_tail build", {
        "ptxas": _ptxas("edge2_tail"),
        "dynamic_smem": getattr(kfe, "edge2_tail_smem", lambda *_: None)(
            64, 64)})
    dseg = _model_on_card(DSEG, random_jax_variables(build_model(DSEG),
                                                     seed=0))
    x_odd = SyntheticShapeNetPart(n_points=DSEG_ODD_TRAIN, size=SEG_BATCH,
                                  seed=3).batch(0, SEG_BATCH)[0]
    for x in (torch.from_numpy(_seg_data(SEG_BATCH)[0]).to(DEV),
              torch.from_numpy(x_odd).to(DEV)):
        for name, layer, _, xt in _dseg_layers(dseg, x)[:2]:
            b, n, _ = xt.shape
            k, (c1, c2) = layer.k, layer.w2.shape
            e = float(b * n * k)
            with torch.no_grad():
                q, off = layer.prepare(xt)
                qb = q.bfloat16()
                if n % 128:
                    h1, psum = kfe.edge_f1_plain(qb, off,
                                                 kknn.knn(xt, xt, k)[1])
                else:
                    h1, psum = kfe.edge_knn_f1_plain(xt, qb, off, k)[1:]
                st1 = kfs._stack_stats(*kft._moments(psum, e),
                                       layer.bn1_scale, layer.bn1_bias)
                sums = kfe.edge2_stats2_plain(h1, st1, layer.w2)
                st2 = kfs._stack_stats(*kft._moments(sums, e),
                                       layer.bn2_scale, layer.bn2_bias)
                hb = 2.0 * e * c1 + 2.0 * c1 * c2 + 32.0 * (c1 + c2)
                # as _edge2_train_cases counts them
                stages = (
                    ("edge2_stats2", kfe.edge2_stats2, (h1, st1, layer.w2),
                     sums, SUM_TOL, (3.0 * c1 + 3.0 * c2) * e, hb + 8.0 * c2),
                    ("edge2_out", kfe.edge2_out, (h1, st1, st2, layer.w2),
                     kfe.edge2_out_plain(h1, st1, st2, layer.w2), EDGE_TOL,
                     (3.0 * c1 + 4.0 * c2) * e, hb + 4.0 * b * n * c2))
                for kernel, fn, a, want, tol, f32_ops, nbytes in stages:
                    err = _check_sums(f"{kernel} {name} N={n}", fn(*a), want,
                                      tol)
                    ms = graph_ms(lambda: fn(*a), 10)
                    bound_ms, ops_ms, bytes_ms = bound(2.0 * c1 * c2 * e,
                                                       f32_ops, nbytes)
                    emit("edge2_tail", {
                        "kernel": kernel, "case": f"{name} N={n}", "B": b,
                        "N": n, "k": k, "C1": c1, "C2": c2, "device_ms": ms,
                        "bound_ms": bound_ms,
                        "bound_by": ("operations" if ops_ms >= bytes_ms
                                     else "bytes"),
                        "share_of_bound": bound_ms / ms, **_errs([err])})
            del h1, stages
            torch.cuda.empty_cache()


def _edge_f1_bound(b, n, cin, c, k):
    """``bound()`` of ``edge_knn_f1``: the selection's d² of every pair
    and h's sum and square (4 an edge element, f32); x, q and off read,
    idx, h and psum written."""
    e = float(b * n * k)
    return bound(0.0, float(b * n * n) * (2 * cin + 3) + 4.0 * e * c,
                 4.0 * b * n * cin + 6.0 * b * n * c + 4.0 * e + 2.0 * e * c
                 + 8.0 * c)


def _edge_f1_route_name(c) -> str:
    """The route ``edge_f1`` takes at width ``c``
    (``fused_edge.edge_f1_route``; ``rows`` in a checkout before the
    routes)."""
    route = getattr(kfe, "edge_f1_route", None)
    return "rows" if route is None else kfe.EDGE_F1_ROUTES[route(c)]


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



def edgeevalidx_times() -> None:
    """``edge_eval`` at its six launches of the served paths on the kNN
    route, each layer's input from the models' serving chains with seeded
    weights: DGCNN's four EdgeConvs at 32 clouds of 10,000 points (k=20)
    and DGCNN part segmentation's EC3 at 16 clouds of 1,000 and of 5,000
    points (k=40). After the device line, one ``edge_eval:`` line a launch
    with the route the wrapper took (``rows`` in a checkout before the
    routes), device ms by CUDA graphs (the wrapper's allocation included),
    the bytes bound and its share, the L2 gather volume B·M·k·C·2 bytes,
    bit identity with the plain version (held) and the route's kernel's
    registers, shared memory and spills. It times the package beside this
    file; for old against new, copy this file into the other checkout's
    root and run it there too:

        python3 -c 'import chip_smoke; chip_smoke.edgeevalidx_times()'
    """
    phase_device()
    _build.build(["knn", "edge_eval", "edge2_eval"])
    routed = hasattr(kfe, "edge_eval_route")

    def case(name, f, x):
        b, n, _ = x.shape
        k, c = f.k, f.bn_scale.shape[0]
        q, off = f.prepare(x)
        ev = (q.bfloat16(), off, kknn.knn(x, x, k)[1],
              kfs._stack_stats(f.mean, f.var, f.bn_scale, f.bn_bias))
        _check_equal(f"edge_eval {name}", kfe.edge_eval(*ev),
                     _per_clouds(kfe.edge_eval_plain, *ev))
        ms = graph_ms(lambda: kfe.edge_eval(*ev), 10)
        e = float(b * n * k * c)
        # as _edge_idx_case counts them
        bound_ms, ops_ms, bytes_ms = bound(
            0.0, 5.0 * e, 2.0 * b * n * c + 4.0 * b * n * k
            + 8.0 * b * n * c + 16.0 * c)
        route = _edge_eval_route_name(c)
        lib = kfe._lib("edge_eval")
        smem = (lib.edge_eval_smem(c, k, kfe.edge_eval_route(c)) if routed
                else lib.edge_eval_smem(k))
        emit("edge_eval", {
            "case": f"{name} N={n}", "B": b, "N": n, "k": k, "C": c,
            "route": route, "device_ms": ms, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "share_of_bound": bound_ms / ms, "l2_gather_gb": 2.0 * e / 1e9,
            "bit_identical": True, "dynamic_smem": smem,
            "ptxas": _ptxas_of("edge_eval", f"center_kernelILi{c}E"
                               if route == "center" else "edge_eval_kernel")})
        torch.cuda.empty_cache()

    dg = _model_on_card("dgcnn", random_jax_variables(
        get_cls_model("dgcnn"), seed=0))
    x = torch.from_numpy(SyntheticModelNet(
        n_points=ODD_SERVE_POINTS, size=DGCNN_BATCH, seed=0).batch(
        0, DGCNN_BATCH)[0]).to(DEV)
    with torch.no_grad():
        for i, ec in enumerate(dg.edge):
            case(f"DGCNN EC{i + 1}", ec.fused, x)
            x = ec(x)
    del dg, x
    dseg = _model_on_card(DSEG, random_jax_variables(build_model(DSEG),
                                                     seed=0))
    for n in (DSEG_ODD_TRAIN, DSEG_ODD_POINTS):
        x = torch.from_numpy(SyntheticShapeNetPart(
            n_points=n, size=SEG_BATCH, seed=0).batch(0, SEG_BATCH)[0]).to(DEV)
        with torch.no_grad():  # the serving chain up to EC3 (kNN route)
            case("DGCNN-seg EC3", dseg.edge3, dseg.edge2(dseg.edge1(x)))

def _edge_bwd_bound(b, n, k, c):
    """``bound()`` of ``edge_bwd`` as ``_edge_tail_cases`` counts it: h,
    dout, idx and the rows read once, ps, scat's 2C + 1 columns, d1 and
    d2 written once; 15 operations an edge element."""
    e = float(b * n * k)
    return bound(0.0, 15.0 * e * c,
                 2.0 * e * c + 4.0 * b * n * c + 4.0 * e + 16.0 * c + 8.0 * c
                 + 4.0 * b * n * (2 * c + 1) + 8.0 * b * n * c)


def edgebwd_times() -> None:
    """``edge_bwd`` at each of its launches of the main paths, with
    inputs from the models' own train chains: DGCNN's four EdgeConvs at
    B=32, N=1024 (kNN inside) and N=1,000 (the kNN route), k=20, and part
    segmentation's EC3 at B=16, N=2,048 and on its kNN route (16 clouds
    of 1,000 points), k=40; then ``edge2_eval`` at both pairs on that
    route (the serving chain's inputs). After the device line and the two
    kernels' registers and spills, one ``edge_bwd:`` or ``edge2_eval:``
    line a launch with device ms by CUDA graphs (the wrapper's
    allocations included), the bound and its share and the deviation
    from the plain version over max|plain| (``edge_bwd``: the count
    column exact, the sums and the assembled dq, doff, dγ, dβ within
    1e-3; ``edge2_eval`` within 1e-5). Beside them, by the same device
    timing: ``edge_f1`` and ``edge_out`` at DGCNN's N=1,000 layers and
    ``edge_eval`` at part segmentation's EC3 on the kNN route (held bit
    for bit, with its route).
    It times the package beside this file; for old against new, copy
    this file into the other checkout's root and run it there too:

        python3 -c 'import chip_smoke; chip_smoke.edgebwd_times()'
    """
    phase_device()
    _build.build(SOURCES)
    emit("edge_bwd build", {"ptxas": {n: _ptxas(n) for n in (
        "edge_bwd", "edge2_eval")}})
    g = torch.Generator(device=DEV).manual_seed(12)

    def device(kernel, case, fn, bounds, **extra):
        bound_ms, ops_ms, bytes_ms = bounds
        ms = graph_ms(fn, 10)
        emit(kernel, {"case": case, **extra, "device_ms": ms,
                      "bound_ms": bound_ms,
                      "bound_by": "operations" if ops_ms >= bytes_ms
                      else "bytes", "share_of_bound": bound_ms / ms})

    def bwd_case(case, layer, xt):
        b, n, _ = xt.shape
        k = layer.k
        with torch.no_grad():
            q, off = layer.prepare(xt)
            if n % 128:
                idx = kknn.knn(xt, xt, k)[1]
                f1 = (q.bfloat16(), off, idx)
                h, psum = kfe.edge_f1(*f1)
            else:
                idx, h, psum = kfe.edge_knn_f1(xt, q.bfloat16(), off, k)
            c = h.shape[-1]
            st = kfs._stack_stats(*kft._moments(psum, float(b * n * k)),
                                  layer.bn_scale, layer.bn_bias)
            if n % 128 and case.startswith("DGCNN EC"):  # as _edge_idx_case
                e = float(b * n * k * c)
                shape = {"B": b, "N": n, "k": k, "C": c}
                device("edge_f1", case, lambda: kfe.edge_f1(*f1), bound(
                    0.0, 4.0 * e, 6.0 * b * n * c + 4.0 * b * n * k
                    + 2.0 * e + 8.0 * c), **shape)
                device("edge_out", case, lambda: kfe.edge_out(h, st), bound(
                    0.0, 5.0 * e, 2.0 * e + 4.0 * b * n * c + 16.0 * c),
                    **shape)
            bw = (h, torch.randn((b, n, c), generator=g, device=DEV), idx,
                  st, SLOPE, n)
            got, want = kfe.edge_bwd(*bw), kfe.edge_bwd_plain(*bw)
            torch.cuda.synchronize()
            counts = bool(torch.equal(got[1][..., 2 * c],
                                      want[1][..., 2 * c]))
            errs = [_check_sums(f"edge_bwd {case} {w}", x, y)
                    for x, y, w in zip(got, want, ("ps", "scat", "d1", "d2"))]
            errs += [_check_sums(f"edge_bwd {case} {w}", x, y)
                     for x, y, w in zip(kfe.assemble_grads(*got, st, k),
                                        kfe.assemble_grads(*want, st, k),
                                        ("dq", "doff", "dgamma", "dbeta"))]
            del got, want
            ms = graph_ms(lambda: kfe.edge_bwd(*bw), 10)
            bound_ms, ops_ms, bytes_ms = _edge_bwd_bound(b, n, k, c)
            emit("edge_bwd", {
                "case": case, "B": b, "N": n, "k": k, "C": c,
                "device_ms": ms, "bound_ms": bound_ms,
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "share_of_bound": bound_ms / ms,
                "counts_exact": counts, **_errs(errs)})
            if not counts:
                fail(f"edge_bwd {case}: scatter counts differ")
            torch.cuda.empty_cache()

    clouds = SyntheticModelNet(n_points=N_POINTS, size=DGCNN_BATCH,
                               seed=0).batch(0, DGCNN_BATCH)[0]
    dg = _model_on_card("dgcnn", random_jax_variables(
        get_cls_model("dgcnn"), seed=0))
    for name, f, _, xt in _edge_inputs(dg, torch.from_numpy(clouds).to(DEV)):
        bwd_case(f"DGCNN {name}", f, xt)
    xt = synthetic_batch("dgcnn", DGCNN_BATCH, 5,
                         ODD_TRAIN_POINTS)["xyz"].to(DEV)
    with torch.no_grad():
        for i, ec in enumerate(dg.edge):
            f = ec.fused
            bwd_case(f"DGCNN EC{i + 1} N={ODD_TRAIN_POINTS}", f, xt)
            q, off = f.prepare(xt)
            xt = kfe.fused_edge_conv(q, off, kknn.knn(xt, xt, f.k)[1],
                                     f.bn_scale, f.bn_bias)[0]
    del dg
    dseg = _model_on_card(DSEG, random_jax_variables(build_model(DSEG),
                                                     seed=0))
    x_odd = SyntheticShapeNetPart(n_points=DSEG_ODD_TRAIN, size=SEG_BATCH,
                                  seed=3).batch(0, SEG_BATCH)[0]
    for x in (torch.from_numpy(_seg_data(SEG_BATCH)[0]).to(DEV),
              torch.from_numpy(x_odd).to(DEV)):
        layers = _dseg_layers(dseg, x)
        _, layer, xe, xt = layers[2]
        bwd_case(f"DGCNN-seg EC3 N={xt.shape[1]}", layer, xt)
    with torch.no_grad():  # EC3 served on that route (as _edge_idx_case)
        b, n, _ = xe.shape
        c = layer.bn_scale.shape[0]
        q, off = layer.prepare(xe)
        ev = (q.bfloat16(), off, kknn.knn(xe, xe, layer.k)[1],
              kfs._stack_stats(layer.mean, layer.var, layer.bn_scale,
                               layer.bn_bias))
        e = float(b * n * layer.k * c)
        _check_equal("edge_eval DGCNN-seg EC3", kfe.edge_eval(*ev),
                     kfe.edge_eval_plain(*ev))
        device("edge_eval", f"DGCNN-seg EC3 N={n}", lambda: kfe.edge_eval(*ev),
               bound(0.0, 5.0 * e, 2.0 * b * n * c + 4.0 * b * n * layer.k
                     + 8.0 * b * n * c + 16.0 * c),
               B=b, N=n, k=layer.k, C=c, route=_edge_eval_route_name(c),
               bit_identical=True)
    for name, layer, xe, _ in layers[:2]:
        b, n, cin = xe.shape
        k, (c1, c2) = layer.k, layer.w2.shape
        with torch.no_grad():
            q, off = layer.prepare(xe)
            st1, st2 = kfe._folded2(*_pair_params(layer)[1:], layer.stats())
            ev = (q.bfloat16(), off, kknn.knn(xe, xe, k)[1], st1, st2,
                  layer.w2)
            err = _check_sums(f"edge2_eval {name}", kfe.edge2_eval(*ev),
                              kfe.edge2_eval_plain(*ev), EDGE_TOL)
            ms = graph_ms(lambda: kfe.edge2_eval(*ev), 10)
            e = float(b * n * k)
            # as _edge2_case counts them
            bound_ms, ops_ms, bytes_ms = bound(
                2.0 * c1 * c2 * e, (4.0 * c1 + 4.0 * c2) * e,
                6.0 * b * n * c1 + 4.0 * b * n * c2 + 4.0 * e
                + 2.0 * c1 * c2 + 32.0 * (c1 + c2))
            emit("edge2_eval", {
                "case": f"DGCNN-seg {name} N={n}", "B": b, "N": n, "k": k,
                "C_in": cin, "C1": c1, "C2": c2,
                "device_ms": ms, "bound_ms": bound_ms,
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "share_of_bound": bound_ms / ms, **_errs([err])})


def _ptxas_of(name, pattern) -> list:
    """``_ptxas(name)``'s entries of the kernels whose mangled names match
    ``pattern``; all of them where none does (a parent's one kernel)."""
    entries = _ptxas(name)
    found = [e for e in entries if re.search(pattern, e["fn"])]
    return found or entries


def interp_times() -> None:
    """``three_interp`` at its six launches of the main paths (PointNet++
    part segmentation's FP2 and FP1, PointConv part segmentation's four
    decoders; B=16, N=2,048, the arguments recorded from the models' eval
    forward) and ``edge_f1`` at its seven (DGCNN's four EdgeConvs in a
    train step at B=32, N=1,000, k=20; DGCNN part segmentation's two
    pairs and EC3 in a train step on its kNN route, B=16, N=1,000, k=40).
    After the device line, one ``three_interp:`` or ``edge_f1:`` line a
    launch with the lane group or route the wrapper took, device ms by
    CUDA graphs (the wrapper's allocations included, and ``edge_f1``'s
    psum memset), the bound and its share, the deviation from the plain
    version (held: idx or h bit-identical, w and out within
    1e-6·max|plain|, psum within 1e-3) and the registers, shared memory
    and spills of the kernel it launched. It times the package beside
    this file; for old against new, copy this file into the other
    checkout's root and run it there too:

        python3 -c 'import chip_smoke; chip_smoke.interp_times()'
    """
    phase_device()
    _build.build(SOURCES)

    def device(kernel, rec, fn, bounds, ptxas):
        bound_ms, ops_ms, bytes_ms = bounds
        ms = graph_ms(fn, 20)
        emit(kernel, {**rec, "device_ms": ms, "bound_ms": bound_ms,
                      "bound_by": "operations" if ops_ms >= bytes_ms
                      else "bytes", "share_of_bound": bound_ms / ms,
                      "ptxas": ptxas})

    seg_xyz = torch.from_numpy(_seg_data(SEG_BATCH)[0]).to(DEV)
    onehot = torch.zeros((SEG_BATCH, 16), device=DEV)
    for tag, name, inputs in (("partseg", PN2_SEG,
                               (seg_xyz, onehot, seg_xyz)),
                              ("pointconv seg", PC_SEG, (seg_xyz, onehot))):
        model = _model_on_card(name, random_jax_variables(build_model(name),
                                                          seed=0))
        calls = []
        orig = _record_calls(kti, "three_interp_fwd", calls)
        try:
            with torch.no_grad():
                model(*inputs)
        finally:
            kti.three_interp_fwd = orig
        del model
        for q, p, f in calls:
            b, m, _ = q.shape
            n, c = f.shape[1:]
            rec = _three_interp_case(f"{tag} M={m} N={n} C={c}", q, p, f,
                                     False)[0]
            instance = f"ILi{rec['group']}ELi{4 if c % 4 == 0 else 1}E"
            device("three_interp", rec,
                   lambda: kti.three_interp_fwd(q, p, f),
                   bound(0.0, 10.0 * b * m * n + 5.0 * b * m * c,
                         12.0 * b * (m + n) + 4.0 * b * n * c
                         + 4.0 * b * m * c + 24.0 * b * m),
                   _ptxas_of("three_interp", instance))
        torch.cuda.empty_cache()

    def f1_case(case, layer, xt):
        b, n, _ = xt.shape
        k = layer.k
        with torch.no_grad():
            q, off = layer.prepare(xt)
            f1 = (q.bfloat16(), off, kknn.knn(xt, xt, k)[1])
            h, psum = kfe.edge_f1(*f1)
            wh, wpsum = kfe.edge_f1_plain(*f1)
            torch.cuda.synchronize()
            c = h.shape[-1]
            if not torch.equal(h.view(torch.int16), wh.view(torch.int16)):
                fail(f"edge_f1 {case}: h not bit-identical to the plain "
                     f"version")
            err = _check_sums(f"edge_f1 {case}", psum, wpsum)
            del h, wh
            route = _edge_f1_route_name(c)
            e = float(b * n * k * c)
            # as _edge_idx_case counts them
            device("edge_f1", {"case": case, "B": b, "N": n, "k": k, "C": c,
                               "route": route, "h_bit_identical": True,
                               **_errs([err])},
                   lambda: kfe.edge_f1(*f1),
                   bound(0.0, 4.0 * e, 6.0 * b * n * c + 4.0 * b * n * k
                         + 2.0 * e + 8.0 * c),
                   _ptxas_of("edge_f1", f"center_kernelILi{c}E"
                             if route == "center" else "edge_f1_kernel"))
            torch.cuda.empty_cache()

    dg = _model_on_card("dgcnn", random_jax_variables(
        get_cls_model("dgcnn"), seed=0))
    xt = synthetic_batch("dgcnn", DGCNN_BATCH, 5,
                         ODD_TRAIN_POINTS)["xyz"].to(DEV)
    with torch.no_grad():
        for i, ec in enumerate(dg.edge):
            f = ec.fused
            f1_case(f"DGCNN EC{i + 1} N={ODD_TRAIN_POINTS}", f, xt)
            q, off = f.prepare(xt)
            xt = kfe.fused_edge_conv(q, off, kknn.knn(xt, xt, f.k)[1],
                                     f.bn_scale, f.bn_bias)[0]
    del dg
    dseg = _model_on_card(DSEG, random_jax_variables(build_model(DSEG),
                                                     seed=0))
    x_odd = SyntheticShapeNetPart(n_points=DSEG_ODD_TRAIN, size=SEG_BATCH,
                                  seed=3).batch(0, SEG_BATCH)[0]
    for name, layer, _, xt in _dseg_layers(dseg,
                                           torch.from_numpy(x_odd).to(DEV)):
        f1_case(f"DGCNN-seg {name} N={DSEG_ODD_TRAIN}", layer, xt)


def _neighbor_calls():
    """``(knn_gathers, ball_queries)``: the arguments of the fused kNN +
    gather at its fifteen launches of the main paths (the PointConv and
    PointCNN models' eval forward: classification at B=32, N=1024, with
    normals for PointConv, part segmentation at B=16, N=2048) and of the
    ball query at its three (the
    MSG model's eval forward at B=32, N=1024; SSG's at B=32, N=4096, the
    clouds Hilbert-sorted as the train step and the Predictor sort them),
    seeded weights, the main run's data."""
    clouds, normals, _ = SyntheticModelNet(
        n_points=N_POINTS, size=N_CLOUDS, seed=0).batch(0, N_CLOUDS)
    xyz = torch.from_numpy(clouds[:BATCH]).to(DEV)
    nrm = torch.from_numpy(normals[:BATCH]).to(DEV)
    seg_xyz = torch.from_numpy(_seg_data(SEG_BATCH)[0]).to(DEV)
    fused = []
    onehot = torch.zeros((SEG_BATCH, 16), device=DEV)
    for name, inputs in (("pointconv", (xyz[:PC_BATCH], nrm[:PC_BATCH])),
                         (PC_SEG, (seg_xyz, onehot)),
                         ("pointcnn", (xyz[:PCNN_BATCH],)),
                         (PCNN_SEG, (seg_xyz, onehot))):
        model = _model_on_card(name, random_jax_variables(build_model(name),
                                                          seed=0))
        fused += _gather_calls(model, *inputs)[1]
        del model
    big, big_n, _ = SyntheticModelNet(
        n_points=BIG_POINTS, size=BIG_CLOUDS - BIG_BATCH, seed=0).batch(
        0, BIG_CLOUDS - BIG_BATCH)
    big = spatial.canonicalize(torch.from_numpy(big[:BIG_BATCH]).to(DEV),
                               torch.from_numpy(big_n[:BIG_BATCH]).to(DEV))
    bqs = []
    for name, inputs in (("pointnet2_msg", (xyz[:MSG_BATCH],
                                            nrm[:MSG_BATCH])),
                         ("pointnet2", big[:2])):
        model = _model_on_card(name, random_jax_variables(build_model(name),
                                                          seed=0))
        orig = _record_calls(kbq, "ball_query", bqs)
        try:
            with torch.no_grad():
                model(*inputs)
        finally:
            kbq.ball_query = orig
        del model
    return fused, bqs


def neighbor_times() -> None:
    """``knn_gather`` at its fifteen launches of the main paths
    (PointConv's SA2; PointConv part segmentation's SA2 and SA3; PointCNN's
    four layers and its part segmentation's eight) and ``ball_query`` at
    its three (MSG's two k=128 scales; SSG's SA1 at N=4096, sorted), the
    arguments recorded from the models' eval forward (:func:`_neighbor_calls`).
    After the device line, one ``knn_gather:`` or ``ball_query:`` line a
    launch with the route the wrapper took, device ms by CUDA graphs (the
    wrapper's allocations included), the bound and its share, bit identity
    with the plain version (held), the pairs the ball query's cull route
    tests, and the registers, shared memory and spills of the kernels of
    its source. It times the package beside this file; for old against
    new, copy this file into the other checkout's root and run it there
    too:

        python3 -c 'import chip_smoke; chip_smoke.neighbor_times()'
    """
    phase_device()
    _build.build(["knn_gather", "ball_query"])
    fused, bqs = _neighbor_calls()
    kg_route = getattr(kkg, "knn_gather_route", None)
    bq_route = getattr(kbq, "ball_query_route", None)

    def device(kernel, rec, fn, bounds, ptxas):
        bound_ms, ops_ms, bytes_ms = bounds
        ms = graph_ms(fn, 20)
        emit(kernel, {**rec, "device_ms": ms, "bound_ms": bound_ms,
                      "bound_by": "operations" if ops_ms >= bytes_ms
                      else "bytes", "share_of_bound": bound_ms / ms,
                      "ptxas": ptxas})

    for q, p, v, k, stride in fused:
        b, m, c = q.shape
        n, cv = v.shape[1:]
        idx, grouped = kkg.knn_gather(q, p, v, k, stride)
        widx, wgrouped = kkg.knn_gather_plain(q, p, v, k, stride)
        torch.cuda.synchronize()
        if not (torch.equal(idx, widx) and torch.equal(grouped, wgrouped)):
            fail(f"knn_gather M={m} N={n}: not bit-identical to the plain "
                 f"version")
        del idx, grouped, wgrouped
        route = kkg.ROUTES[kg_route(n, k, stride)] if kg_route else "parent"
        device("knn_gather",
               {"case": f"M={m} N={n} Cv={cv} k={k} stride={stride}",
                "B": b, "C": c,
                "route": route, "bit_identical": True},
               lambda: kkg.knn_gather(q, p, v, k, stride),
               bound(0.0, b * m * n * (2.0 * c + 3.0),
                     4.0 * b * n * cv + 4.0 * b * m * k
                     + 4.0 * b * m * k * cv),
               _ptxas_of("knn_gather", f"{route}_kernel"))
        torch.cuda.empty_cache()
    for nx, p, radius, k in bqs:
        b, m, _ = nx.shape
        n = p.shape[1]
        idx, cnt = kbq.ball_query(nx, p, radius, k)
        widx, wcnt = kbq.ball_query_plain(nx, p, radius, k)
        torch.cuda.synchronize()
        if not (torch.equal(idx, widx) and torch.equal(cnt, wcnt)):
            fail(f"ball_query M={m} N={n}: not bit-identical to the plain "
                 f"version")
        route = kbq.ROUTES[bq_route(n)] if bq_route else "parent"
        bd = _ball_query_bound(nx, p, radius, k)
        device("ball_query",
               {"case": f"M={m} N={n} r={radius} k={k}", "B": b,
                "route": route, "bit_identical": True,
                "cnt_mean": wcnt.float().mean().item(), "pairs": bd["pairs"],
                "pairs_tested": bd.get("pairs_tested")},
               lambda: kbq.ball_query(nx, p, radius, k),
               (bd["bound_ms"], bd["ops_ms"], bd["bytes_ms"]),
               _ptxas_of("ball_query", route))


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
    ("pointcnn", "modelnet", PCNN_BATCH, (384, 128), True),
    ("pointcnn partseg", "shapenet", SEG_BATCH, (768, 384, 128), True),
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


# ------------------------------------------------------------- KPConv


def _kp_model(name, variables, shapes, device=None):
    """KPConv model ``name`` at pyramid ``shapes`` (a calibration, or
    ``None`` for the uncalibrated defaults) with ``variables``, on
    ``device`` in eval mode."""
    kw = {} if shapes is None else dict(
        caps=shapes.caps, neighborhood_limits=shapes.neighborhood_limits)
    model = from_jax_variables(get_cls_model(name, **kw), variables)
    return model.to(device or DEV).eval()


def _kp_counts(model, batch, n_points=N_POINTS):
    """``(per served batch, per train step)`` launches of ``knn``, the row
    gather and the scatter-add of KPConv ``model`` at ``batch`` clouds of
    ``n_points`` (the served bucket, for uncalibrated caps), derived from
    its pyramid's shapes and the wrappers' gates: ``knn`` at each
    neighbour search over a support layer of at least
    ``KNN_MIN_SUPPORTS`` points (self-neighbours and pools), the row
    gather at each KPConv's ``[xyz ‖ features]`` (the deformable ones'
    offset convolution too) and each strided block's max-pool where
    ``geometry.gather_takes_kernel`` takes it, in a train step a
    scatter-add for each of those whose input carries a gradient (all
    but the first block's)."""
    cfg = model.cfg
    n_layers = len(layer_blocks(cfg.architecture))
    caps, ks = pyramid_shapes(n_points, n_layers, cfg.neighborhood_limits)
    caps = list(cfg.caps) if cfg.caps is not None else caps
    knn = sum(caps[l] >= KNN_MIN_SUPPORTS for l in range(n_layers)) + sum(
        caps[l] >= KNN_MIN_SUPPORTS for l in range(n_layers - 1))
    gathers = scatters = 0
    for i, (layer, blk) in enumerate(zip(model.kpcnn.layers,
                                         model.kpcnn.blocks)):
        if not hasattr(blk, "conv"):  # a unary block gathers nothing
            continue
        m = caps[layer + 1] if blk.strided else caps[layer]
        rows = batch * m * ks[layer]
        conv_in = blk.conv.weights.shape[1]
        widths = [3 + conv_in] * (2 if blk.conv.deformable else 1)
        if blk.strided and hasattr(blk, "unary2"):  # the max-pool of x
            widths.append(conv_in if blk.unary1 is None
                          else blk.unary1.dense.in_features)
        taken = sum(geometry.gather_takes_kernel(caps[layer], c, rows)
                    for c in widths)
        gathers += taken
        scatters += taken if i else 0
    serve = {"knn": knn, "gather_neighbors": gathers}
    return serve, {**serve, "scatter_rows": scatters}


def _kp_bench_clouds():
    """``bench.py``'s 16 surface clouds at N=1024 (``_surface_clouds``,
    seed 0), which it calibrates KPConv's pyramid on."""
    return SyntheticModelNet(n_points=N_POINTS, size=KP_BATCH, train=True,
                             seed=0).batch(0, KP_BATCH)[0]


def _pyramid_tensors(pyr):
    return [t for field in pyr for t in (field if isinstance(field, list)
                                         else [field])]


def phase_kpconv_kernels(name, variables):
    """KPConv ``name`` at full width with the pyramid calibrated as
    ``bench.py`` does, on the card and on the CPU (equal); its launch
    counts derived from the shapes must be :data:`KP_SERVE` and
    :data:`KP_STEP`; two pyramid builds on the card are bit-identical and
    equal to the CPU's; ``knn``, the row gather and the scatter-add at
    their launches (arguments recorded from the model's eval forward and
    train-mode backward) against their plain versions as in phase 21.
    Returns ``(calibration, {kernel: [records]})``."""
    xyz = _kp_bench_clouds()
    arch = get_cls_model(name).cfg.architecture
    cal = bench_calibration(xyz, arch, device=DEV)
    cal_cpu = bench_calibration(xyz, arch, device="cpu")
    if cal != cal_cpu:
        fail(f"{name}: the card's calibration {cal} is not the CPU's "
             f"{cal_cpu}")
    model = _kp_model(name, variables, cal)
    counts = _kp_counts(model, KP_BATCH)
    if counts != (KP_SERVE, KP_STEP):
        fail(f"{name}: launches by the gates {counts}, expected "
             f"{(KP_SERVE, KP_STEP)}")
    x = torch.from_numpy(xyz).to(DEV)
    with torch.no_grad():
        first = _pyramid_tensors(model.kpcnn.pyramid(x))
        again = _pyramid_tensors(model.kpcnn.pyramid(x))
        cpu = _pyramid_tensors(_kp_model(name, variables, cal, "cpu")
                               .kpcnn.pyramid(x.cpu()))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        fail(f"{name}: two pyramid builds on the card differ")
    differ = [i for i, (a, b) in enumerate(zip(first, cpu))
              if not torch.equal(a.cpu(), b)]
    if differ:
        fail(f"{name}: the card's pyramid differs from the CPU's in "
             f"tensors {differ}")
    pyr = model.kpcnn.pyramid(x)
    far = [int((~m).sum()) for m in pyr.masks]
    emit(f"kpconv {name} calibration", {
        "caps": list(cal.caps), "limits": list(cal.neighborhood_limits),
        "max_occupancy": list(cal.max_occupancy),
        "masked_points_by_layer": far,
        "voxel_overflow": int(pyr.overflow.sum()),
        "pyramid_bit_identical_twice_and_to_cpu": True,
        "serve": counts[0], "step": counts[1]})
    recs = phase_path_kernels(((f"{name}", model, (x,), {
        "knn": KP_SERVE["knn"],
        "gather_neighbors": KP_SERVE["gather_neighbors"],
        "scatter_rows": KP_STEP["scatter_rows"]}),))
    return cal, recs


def _kp_reg_check(name, variables, cal, batch):
    """The deformable model's regulariser on ``batch``: finite and
    positive, and the first train step's loss is the cross entropy plus
    it (within 1e-5 relative)."""
    model = _kp_model(name, variables, cal)
    model.train()
    with torch.no_grad():
        logits = model(batch["xyz"])
        ce = soft_cross_entropy(logits, batch["label"])
        reg = model.aux["reg_loss"]
    model = build_model(name, caps=cal.caps,
                        neighborhood_limits=cal.neighborhood_limits)
    from_jax_variables(model, variables)
    step = make_cls_train_step(model, sgd_momentum(model.parameters(),
                                                   CLS_LR))
    loss = step(batch)["loss"]
    got = {"cross_entropy": ce.item(), "reg_loss": reg.item(),
           "step_loss": loss.item()}
    if not (np.isfinite(got["reg_loss"]) and got["reg_loss"] > 0):
        fail(f"{name}: regulariser {got}")
    if abs(got["step_loss"] - got["cross_entropy"] - got["reg_loss"]) > \
            1e-5 * abs(got["step_loss"]):
        fail(f"{name}: the step's loss is not the cross entropy plus the "
             f"regulariser: {got}")
    return got


def _kp_deform_recipe(model):
    """The CLI's KPConv recipe (``train.kpconv_optimizer`` and its clip)
    at the original KPConv's offset factor 0.1, lr 1e-2 throughout the
    phase: the deformable model's train phase. At ``bench.py``'s step
    (SGD, lr 0.1, momentum 0.9, no clip) its seeded weights diverge (loss
    38.2 → 4,089 → NaN in four steps, card and CPU alike: the
    regulariser's gradient)."""
    opt, set_lr = kpconv_optimizer(model, 9840 // KP_BATCH, 0.1)
    set_lr(0)
    return opt, KPCONV_CLIP_NORM, (
        "kpconv recipe: clip 100, momentum 0.98, lr 1e-2, offsets x0.1")


def phase_kpconv(name, variables, power, cal, data):
    """Serving (``Predictor(batch_size=16)`` on the model at ``cal``'s
    shapes, as phase 6: three requests of 256 clouds and one at N=1000,
    exact launches a batch, card against CPU on 8 clouds) and training
    (``make_cls_train_step`` at B=16 as phase 7, with the gradient check:
    the rigid model at ``bench.py``'s lr 0.1 and momentum 0.9, the
    deformable one by :func:`_kp_deform_recipe`); for the deformable
    model first :func:`_kp_reg_check`. Returns the two paths'
    launches."""
    shapes = dict(caps=cal.caps, neighborhood_limits=cal.neighborhood_limits)
    serving = phase_serving(name, variables, data, power, KP_BATCH,
                            KP_SERVE, {"calibration": shapes},
                            build=lambda: get_cls_model(name, **shapes))
    if name == "kpconv_deform":
        batch = {k: v.to(DEV) for k, v in synthetic_batch(
            name, KP_BATCH, 5, N_POINTS).items()}
        emit(f"kpconv {name} regulariser",
             _kp_reg_check(name, variables, cal, batch))
    train = phase_train(name, variables, power, KP_BATCH, KP_STEP,
                        model_kw=shapes,
                        recipe=_kp_deform_recipe if name == "kpconv_deform"
                        else None)
    return serving, train


def _kp_column(recs):
    """``PERF.md``'s KPConv column: each kernel's device ms, plain ms,
    library ms, bound ms and records summed over KPConv's cases."""
    out = {}
    for kernel, rs in recs.items():
        timed = [r for r in rs if "ms" in r]
        out[kernel] = {key: sum(r[key] for r in timed) for key in
                       ("ms", "plain_ms", "bound_ms", "library_ms")}
        out[kernel]["cases"] = len(timed)
        if kernel == "knn":
            out[kernel]["device_ms"] = sum(r["device_ms"] for r in timed)
    return out


# ------------------------------------------------ the training CLIs

CLI_TRAIN, CLI_TEST = 64, 32       # clouds of the phase's ModelNet40 tree
CLI_BATCH, CLI_STEPS = 32, 2       # train_cls: B and steps an epoch
CLI_SEG_SIZE = 32                  # train_partseg: 2 steps at B=16, 64 test


def _cli_run(what, main, argv, want, total):
    """``main(argv)`` with the counts zeroed just before and read just
    after: exactly ``want`` launches of each kernel (or ``want(summary)``
    of the run's summary), added to ``total``."""
    _zero_counts()
    t0 = time.perf_counter()
    out = main(argv)
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    launches = _read_totals(what, want(out) if callable(want) else want)
    for name, count in launches.items():
        total[name] = total.get(name, 0) + count
    out["launches"] = {k: c for k, c in launches.items() if c}
    return out


def _times(per_step, steps, per_batch, batches):
    return {k: per_step.get(k, 0) * steps + per_batch.get(k, 0) * batches
            for k in set(per_step) | set(per_batch)}


def _no_dropout(x, rate, training, generator):
    return x


def _kp_cli_want(evals):
    """``want(summary)`` of a ``train_cls --model kpconv`` run: each
    bucket's step launches (:func:`_kp_counts` at its calibrated shapes)
    times its steps, and the merged shapes' served launches times
    ``evals`` eval batches."""
    def want(summary):
        cal = summary["calibration"]

        def counts(c):
            return _kp_counts(get_cls_model(
                "kpconv", caps=c["caps"],
                neighborhood_limits=c["neighborhood_limits"]), KP_BATCH)

        out = _times({}, 0, counts(cal)[0], evals)
        for b, steps in summary.get("steps_by_bucket", {}).items():
            for k, v in counts(cal["buckets"][b])[1].items():
                out[k] = out.get(k, 0) + v * steps
        return out

    return want


def _kp_cli(root, tmp, power) -> dict:
    """``train_cls --model kpconv`` on the phase's ModelNet40 tree at B=16
    (``--kp-buckets 2``, 2 epochs of at most 2 steps), ``--eval --votes
    2`` (``evaluate_voting_kpconv``) and ``Predictor.from_checkpoint``
    (the uncalibrated shapes, as the JAX package's) on the test clouds,
    card against CPU on 8 → the launches over these runs."""
    from pointcloudlib_tpu_torch.cli import train_cls
    from pointcloudlib_tpu_torch.data.modelnet40 import ModelNet40

    total = {}
    evals = -(-CLI_TEST // KP_BATCH)
    ck = f"{tmp}/ck_kpconv"
    base = ["--model", "kpconv", "--data-root", str(root), "--batch_size",
            str(KP_BATCH), "--num_points", str(N_POINTS), "--checkpoint-dir",
            ck, "--log-dir", f"{tmp}/log", "--steps-per-epoch",
            str(CLI_STEPS), "--kp-buckets", "2"]
    run = _cli_run("train_cls --model kpconv", train_cls.main,
                   base + ["--epochs", "2"], _kp_cli_want(2 * evals), total)
    cal = run["calibration"]
    steps = sum(run["steps_by_bucket"].values())
    if run["epochs"] != [0, 1] or not 2 <= steps <= 2 * CLI_STEPS or \
            steps != run["steps"] or len(cal["buckets"]) != 2 or \
            not np.isfinite([run["first_loss"], run["last_loss"]]).all():
        fail(f"train_cls --model kpconv: {run}")
    votes = _cli_run("train_cls --model kpconv --eval --votes 2",
                     train_cls.main, base + ["--eval", "--votes", "2"],
                     _kp_cli_want(2 * evals), total)
    if not 0.0 <= votes["eval_oa"] <= 100.0 or \
            votes["calibration"] != cal:
        fail(f"train_cls --model kpconv --eval --votes 2: {votes}")

    test = ModelNet40(N_POINTS, train=False, data_root=str(root))
    pts = test.get_batch(np.arange(len(test)))[0]
    default = _kp_counts(get_cls_model("kpconv"), KP_BATCH)[0]
    _zero_counts()
    served = Predictor.from_checkpoint(
        f"{ck}/kpconv", "kpconv", which="current",
        batch_size=KP_BATCH).predict_proba(pts)
    launches = _read_totals("Predictor.from_checkpoint('kpconv')",
                            _times({}, 0, default, evals))
    for k, c in launches.items():
        total[k] = total.get(k, 0) + c
    ref = Predictor.from_checkpoint(
        f"{ck}/kpconv", "kpconv", which="current", batch_size=8,
        device="cpu").predict_proba(pts[:8])
    diff = float(np.abs(ref - served[:8]).max())
    if served.shape != (len(pts), 40) or not np.isfinite(served).all() \
            or diff > PROB_ATOL:
        fail(f"Predictor.from_checkpoint('kpconv'): shape {served.shape}, "
             f"card vs CPU {diff} > {PROB_ATOL}")
    emit("cli train_cls kpconv", {
        "card": power, "batch": KP_BATCH, "n_points": N_POINTS,
        "run": run, "votes": votes, "served_launches": {
            k: c for k, c in launches.items() if c},
        "served_default_shapes": default,
        "served_max_abs_prob_diff_vs_cpu": diff, "launches": total})
    return total


def phase_cli(power) -> dict:
    """Both training CLIs on the card through ``main(argv)``: ``train_cls``
    on a ModelNet40 text tree written here (trains, evaluates, votes,
    serves from its checkpoint and resumes; its first step against a CPU
    run's), ``train_partseg`` on synthetic part-segmentation clouds, one
    epoch in the prefetch thread and one with two forked workers → the
    launches of each CLI over the phase, by kernel."""
    import tempfile
    from unittest import mock

    from pointcloudlib_tpu_torch.cli import train_cls, train_partseg
    from pointcloudlib_tpu_torch.data.modelnet40 import (
        ModelNet40,
        write_synthetic_tree,
    )
    from pointcloudlib_tpu_torch.models import pointnet2 as pn2_module

    t_phase = time.perf_counter()
    cls_total, seg_total = {}, {}
    evals = -(-CLI_TEST // CLI_BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        root = write_synthetic_tree(f"{tmp}/modelnet40", CLI_TRAIN, CLI_TEST,
                                    n_points=2 * N_POINTS, seed=0)
        ck = f"{tmp}/ck"
        base = ["--model", "pointnet2", "--data-root", str(root),
                "--batch_size", str(CLI_BATCH), "--num_points",
                str(N_POINTS), "--checkpoint-dir", ck, "--log-dir",
                f"{tmp}/log", "--steps-per-epoch", str(CLI_STEPS)]

        def cls(what, extra, steps, batches):
            return _cli_run(f"train_cls {what}", train_cls.main,
                            base + extra,
                            _times(SSG_STEP, steps, SSG_SERVE, batches),
                            cls_total)

        run = cls("2 epochs", ["--epochs", "2"], 2 * CLI_STEPS, 2 * evals)
        if run["epochs"] != [0, 1] or run["steps"] != 2 * CLI_STEPS or \
                not np.isfinite([run["first_loss"], run["last_loss"]]).all():
            fail(f"train_cls: {run}")
        last = run["test_oa"][1]
        ev = cls("--eval", ["--eval"], 0, evals)
        conf = cls("--eval --confusion", ["--eval", "--confusion"], 0, evals)
        votes = cls("--eval --votes 2", ["--eval", "--votes", "2"], 0,
                    2 * evals)
        if ev["eval_oa"] != last or conf["eval_oa"] != last:
            fail(f"train_cls --eval OA {ev['eval_oa']}, with --confusion "
                 f"{conf['eval_oa']}; the last epoch printed {last}")
        if not 0.0 <= votes["eval_oa"] <= 100.0:
            fail(f"train_cls --votes 2: {votes}")

        test = ModelNet40(N_POINTS, train=False, data_root=str(root))
        pts, nrm, labels = test.get_batch(np.arange(len(test)))
        _zero_counts()
        served = Predictor.from_checkpoint(
            f"{ck}/pointnet2", "pointnet2", which="current",
            batch_size=CLI_BATCH).predict_proba(pts, nrm)
        served_launches = _read_totals("Predictor.from_checkpoint",
                                       _times({}, 0, SSG_SERVE, evals))
        for name, count in served_launches.items():
            cls_total[name] = cls_total.get(name, 0) + count
        served_oa = 100.0 * int((served.argmax(-1) == labels).sum()) / \
            len(labels)
        ref = Predictor.from_checkpoint(
            f"{ck}/pointnet2", "pointnet2", which="current", batch_size=8,
            device="cpu").predict_proba(pts[:8], nrm[:8])
        prob_diff = float(np.abs(ref - served[:8]).max())
        if served_oa != ev["eval_oa"] or prob_diff > PROB_ATOL:
            fail(f"Predictor.from_checkpoint: OA {served_oa} against "
                 f"--eval's {ev['eval_oa']}; card vs CPU probabilities "
                 f"{prob_diff} > {PROB_ATOL}")

        res = cls("--resume --epochs 3", ["--resume", "--epochs", "3"],
                  CLI_STEPS, evals)
        if (res["start_epoch"], res["epochs"], res["steps"]) != \
                (2, [2], 3 * CLI_STEPS) or \
                res["best_at_start"] != run["best_oa"]:
            fail(f"train_cls --resume: {res}; the first run: {run}")

        # the card's and the CPU's generators draw other dropout masks
        # (Philox, Mersenne Twister), and a mask alone moves SSG's first
        # loss past the bound: the two first steps run without dropout
        with mock.patch.object(pn2_module, "dropout", _no_dropout):
            card = cls("1 step, no dropout",
                       ["--epochs", "1", "--checkpoint-dir", f"{tmp}/ck1",
                        "--steps-per-epoch", "1"], 1, evals)
            t0 = time.perf_counter()
            cpu = train_cls.main(base + [
                "--epochs", "1", "--checkpoint-dir", f"{tmp}/ck2",
                "--steps-per-epoch", "1", "--device", "cpu"])
            cpu["seconds"] = time.perf_counter() - t0
        loss_diff = abs(card["first_loss"] - cpu["first_loss"]) / \
            abs(cpu["first_loss"])
        if loss_diff > LOSS_RTOL:
            fail(f"train_cls first-step loss: card {card['first_loss']}, "
                 f"CPU {cpu['first_loss']} ({loss_diff} > {LOSS_RTOL})")
        emit("cli train_cls pointnet2", {
            "card": power, "batch": CLI_BATCH, "n_points": N_POINTS,
            "train_clouds": CLI_TRAIN, "test_clouds": CLI_TEST,
            "run": run, "eval": ev, "confusion": conf, "votes": votes,
            "served_oa": served_oa, "served_launches": {
                k: c for k, c in served_launches.items() if c},
            "served_max_abs_prob_diff_vs_cpu": prob_diff, "resume": res,
            "first_step_no_dropout": {"card": card["first_loss"],
                                      "cpu": cpu["first_loss"],
                                      "rel_diff": loss_diff,
                                      "cpu_seconds": cpu["seconds"]},
            "launches": cls_total})

        kp_total = _kp_cli(root, tmp, power)

        seg = ["--model", "dgcnn", "--synthetic", "--synthetic-size",
               str(CLI_SEG_SIZE), "--batch_size", str(SEG_BATCH),
               "--num_points", str(SEG_POINTS), "--checkpoint-dir", ck,
               "--log-dir", f"{tmp}/log"]
        steps = CLI_SEG_SIZE // SEG_BATCH
        batches = -(-max(64, CLI_SEG_SIZE // 4) // SEG_BATCH)
        want = _times(DSEG_STEP, steps, DSEG_SERVE, batches)
        first = _cli_run("train_partseg dgcnn", train_partseg.main,
                         seg + ["--epochs", "1"], want, seg_total)
        forked = _cli_run("train_partseg dgcnn --num-workers 2",
                          train_partseg.main,
                          seg + ["--resume", "--epochs", "2",
                                 "--num-workers", "2"], want, seg_total)
        for r, epochs in ((first, [0]), (forked, [1])):
            if r["epochs"] != epochs or not np.isfinite(
                    [r["first_loss"], r["last_loss"]]).all():
                fail(f"train_partseg: {r}")
        emit("cli train_partseg dgcnn", {
            "card": power, "batch": SEG_BATCH, "n_points": SEG_POINTS,
            "synthetic_size": CLI_SEG_SIZE, "run": first,
            "num_workers_2": forked, "launches": seg_total})
    emit("cli phase", {"seconds": time.perf_counter() - t_phase})
    return {"cli_train_cls": cls_total, "cli_train_cls_kpconv": kp_total,
            "cli_train_partseg": seg_total}


# ----------------------------------- KPConv on large clouds, data parallel

KP_LARGE = (4096, 5000)            # served points: layer 2 holds 256 / 312
KP_LARGE_BATCH = 16                # bench.py's KPConv batch
KP_LARGE_CHECK = 2                 # clouds also served on the CPU
KP_LARGE_RUNS, KP_LARGE_BATCHES = 3, 50   # timed runs, batches a run
KP_LOGIT_RTOL = 1e-4               # logits against the CPU's largest
KP_RANK_EXTRA = {4096: 76, 5000: 42}  # a longer list at the same layer


def _kp_rank_launches(model, n_points):
    """Launches of the kNN's rank route in a batch of ``model`` served at
    ``n_points`` (uncalibrated caps): each neighbour search, self and
    pools, over a support layer of at least ``KNN_MIN_SUPPORTS`` points
    whose list is longer than ``knn.MAX_K``."""
    cfg = model.cfg
    n_layers = len(layer_blocks(cfg.architecture))
    caps, ks = pyramid_shapes(n_points, n_layers, cfg.neighborhood_limits)
    big = [caps[l] >= KNN_MIN_SUPPORTS and ks[l] > kknn.MAX_K
           for l in range(n_layers)]
    return sum(big) + sum(big[:n_layers - 1])


def _served_logits(pred, clouds):
    """``(probabilities, logits)`` of ``pred.predict_proba(clouds)``: the
    logits under them as the model returned them, on the CPU."""
    logits = []
    hook = pred.model.register_forward_hook(
        lambda _m, _i, out: logits.append(out.detach().cpu()))
    try:
        probs = pred.predict_proba(clouds)
    finally:
        hook.remove()
    return probs, torch.cat(logits)


def phase_kpconv_large(variables, power):
    """Served KPConv (rigid) on clouds of 4,096 and 5,000 points through
    ``Predictor.from_variables("kpconv")`` at its uncalibrated shapes (as
    ``from_checkpoint`` builds it), batches of 16 clouds: after a warm-up,
    :data:`KP_LARGE_RUNS` runs of :data:`KP_LARGE_BATCHES` batches each,
    timed, with exact launches over them all (the kNN six times a batch,
    two of them on its rank route at layer 2's k = 41; the row gather by
    its gate); the rate of each run and over all; finite probability
    rows; 2 clouds within 5e-3 of the CPU's probabilities and, since the
    random weights saturate the softmax, their logits within
    :data:`KP_LOGIT_RTOL` of the CPU's largest logit. Then the rank route
    at its launches (layer 2's self-neighbours and pools, recorded from
    the model's pyramid, masked supports at 1e9) and at k = 76 and 42 on
    the same layer, bit for bit against ``knn_plain`` and timed. Returns
    ``(records, {path: launches})``."""
    recs, paths = [], {}
    for n in KP_LARGE:
        clouds = SyntheticModelNet(n_points=n, size=KP_LARGE_BATCH,
                                   seed=4).batch(0, KP_LARGE_BATCH)[0]
        pred = Predictor.from_variables("kpconv", variables,
                                        batch_size=KP_LARGE_BATCH,
                                        device=DEV)
        serve = _kp_counts(pred.model, KP_LARGE_BATCH, n)[0]
        serve["knn_rank"] = _kp_rank_launches(pred.model, n)
        if serve["knn_rank"] != 2:
            fail(f"kpconv N={n}: {serve['knn_rank']} rank-route launches "
                 f"a batch by the shapes, expected 2")
        probs, logits = _served_logits(pred, clouds)  # warm-up
        secs = []
        _zero_counts()
        for _ in range(KP_LARGE_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(KP_LARGE_BATCHES):
                pred.predict_proba(clouds)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        rates = [KP_LARGE_BATCH * KP_LARGE_BATCHES / t for t in secs]
        batches = KP_LARGE_RUNS * KP_LARGE_BATCHES
        launches = _read_counts(f"kpconv N={n} serving", serve, batches)
        if probs.shape != (KP_LARGE_BATCH, 40) or not np.isfinite(
                probs).all() or np.abs(probs.sum(-1) - 1).max() > 1e-4:
            fail(f"kpconv N={n}: probabilities {probs.shape} not finite "
                 f"rows summing to 1")
        ref, ref_logits = _served_logits(Predictor.from_variables(
            "kpconv", variables, batch_size=KP_LARGE_CHECK, device="cpu"),
            clouds[:KP_LARGE_CHECK])
        diff = float(np.abs(ref - probs[:KP_LARGE_CHECK]).max())
        if diff > PROB_ATOL:
            fail(f"kpconv N={n}: card vs CPU probabilities differ by "
                 f"{diff} > {PROB_ATOL}")
        scale = float(ref_logits.abs().max())
        logit_diff = float((logits[:KP_LARGE_CHECK] - ref_logits).abs().max())
        if not torch.isfinite(logits).all() or (
                logit_diff > KP_LOGIT_RTOL * scale):
            fail(f"kpconv N={n}: card vs CPU logits differ by {logit_diff}"
                 f" > {KP_LOGIT_RTOL} of the largest, {scale}")
        emit(f"serving kpconv N={n}", {
            "clouds_per_s": KP_LARGE_BATCH * batches / sum(secs),
            "clouds_per_s_by_run": rates,
            "run_spread": (max(rates) - min(rates)) / min(rates),
            "batches_timed": batches, "batch": KP_LARGE_BATCH,
            "n_points": n, "card": power, "launches": launches,
            "max_abs_prob_diff_vs_cpu": diff,
            "max_abs_logit_diff_vs_cpu": logit_diff,
            "max_abs_logit_cpu": scale})
        paths[f"kpconv_large_{n}"] = launches
        with torch.no_grad():
            pyr = pred.model.kpcnn.pyramid(torch.from_numpy(clouds).to(DEV))
        far = _far_supports(pyr.points[2], pyr.masks[2])
        k = pred.model.cfg.neighborhood_limits[2]
        for case, query, kk in (("self2", pyr.points[2], k),
                                ("pool2", pyr.points[3], k),
                                ("self2", pyr.points[2], KP_RANK_EXTRA[n])):
            rec = _knn_case(f"kpconv N={n} {case} k={kk}", query, far, kk,
                            True)
            if rec["route"] != "rank":
                fail(f"knn at k={kk}: route {rec['route']}, not rank")
            recs.append(rec)
        del pred
        torch.cuda.empty_cache()
    return recs, paths


DP_WORLD = 2
DP_TOL = 1e-4                      # loss (relative) and BN statistics
DP_SPREAD = 2                      # × one process's largest order spread
DP_FAULTS = ("local_bn", "grad_scale")
DP_STEP_TIMES = 10


def _dp_model(name, variables, dropout):
    model = build_model(name, dropout=dropout)
    return from_jax_variables(model, variables)


def _dp_device() -> torch.device:
    return torch.device("cuda", 0) if DEV.type == "cuda" else DEV


def _dp_step(name, variables, batch, group, seed, dropout, fault=None):
    """One SGD step (the phase 7 learning rates) of model ``name`` from
    ``variables`` on ``batch`` (the global batch; a ``group``'s step keeps
    its rows), dropout drawn from a generator seeded ``seed``. ``fault``
    plants one of :data:`DP_FAULTS` in a group's step: BatchNorm over the
    rank's own rows only, or the gradients averaged where the step sums
    them and summed where it averages them. Returns the loss, every
    gradient and every buffer, on the CPU."""
    dev = batch["xyz"].device
    model = _dp_model(name, variables, dropout)
    lr = SEG_LR if name in SEG else reference_flat_lr(
        0.02, 9840, batch["xyz"].shape[0])
    make = make_seg_train_step if name in SEG else make_cls_train_step
    step = make(model, sgd_momentum(model.parameters(), lr), device=(
        dev if group is None else None), group=group)
    reduce = trainer.reduce_gradients
    if fault == "local_bn":
        sync_batchnorm(model, None)
    elif fault == "grad_scale":
        trainer.reduce_gradients = (
            lambda params, g, average: reduce(params, g, not average))
    try:
        met = step(batch, torch.Generator(device=dev).manual_seed(seed))
    finally:
        trainer.reduce_gradients = reduce
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return {"loss": met["loss"].cpu(),
            "grads": {k: p.grad.cpu() for k, p in model.named_parameters()
                      if p.grad is not None},
            "buffers": {k: v.cpu() for k, v in model.named_buffers()}}


def _dp_rank(group, name, variables, batch):
    """A rank of the two-process check (``parallel.run_ranks``): gloo over
    CUDA tensors, both ranks on this card. The step, then the step with
    each fault of :data:`DP_FAULTS` planted, by fault (``None`` for
    none)."""
    batch = {k: v.to(group.device) for k, v in batch.items()}
    return {fault: _dp_step(name, variables, batch, group,
                            rank_seed(0, group.rank), 0.0, fault)
            for fault in (None, *DP_FAULTS)}


def _dp_orders(b: int, device) -> list:
    """The batch's clouds in other orders: pairs swapped, reversed, the
    halves swapped (the same sums in another order)."""
    i = torch.arange(b, device=device)
    return [i.view(-1, 2).flip(1).reshape(-1), i.flip(0), i.roll(b // 2)]


def _dp_check(name, got, want, spreads, cancelled, fragile):
    """``(failures, readings)`` of a two-rank step ``got`` against one
    process's ``want``: the gradients under ``tools/grad_check.py``'s
    bounds; the loss within :data:`DP_TOL` relative and every BN running
    statistic within :data:`DP_TOL` of its largest element (at least 1),
    or, where larger, :data:`DP_SPREAD` × the largest deviation of the
    one-process ``spreads`` (the step on the clouds in other orders)."""
    check = compare_grads(name, (float(got["loss"]), got["grads"]),
                          (float(want["loss"]), want["grads"], cancelled,
                           fragile))
    failures, widened = list(check["failures"]), []
    loss = float(want["loss"])
    dev = abs(float(got["loss"]) - loss)
    own = max(abs(float(s["loss"]) - loss) for s in spreads)
    if dev > max(DP_TOL * abs(loss), DP_SPREAD * own):
        failures.append(f"loss {float(got['loss'])} against one process's "
                        f"{loss} (its order spread {own})")
    elif dev > DP_TOL * abs(loss):
        widened.append("loss")
    stats = {}
    for k, w in want["buffers"].items():
        if not w.is_floating_point():
            continue
        dev = float((got["buffers"][k] - w).abs().max())
        own = max(float((s["buffers"][k] - w).abs().max()) for s in spreads)
        stats[k] = (dev, own)
        tol = DP_TOL * max(1.0, float(w.abs().max()))
        if dev > max(tol, DP_SPREAD * own):
            failures.append(f"BN statistic {k} off by {dev} (one "
                            f"process's order spread {own})")
        elif dev > tol:
            widened.append(k)
    agree = check["agree"]
    return failures, {
        "loss_ranks": float(got["loss"]),
        "worst_grad_cos": min(agree.items(), key=lambda kv: kv[1][0]),
        "worst_grad_norm_ratio": max(agree.items(),
                                     key=lambda kv: abs(kv[1][1] - 1)),
        "grads_not_compared": sorted(check["not_compared"]),
        "loss_spread_one_process": max(
            abs(float(s["loss"]) - loss) for s in spreads),
        "max_bn_stat_dev": max(d for d, _ in stats.values()),
        "max_bn_stat_spread_one_process": max(o for _, o in
                                              stats.values()),
        f"held_to_{DP_SPREAD}x_spread": widened}


def _dp_two_ranks(name, variables, batch, power):
    """Two processes on this card over gloo (``parallel.run_ranks``),
    each on half of ``batch``, against one process on all of it (dropout
    0) under :func:`_dp_check`, the ranks' reduced gradients equal to
    each other. The bound of the loss and the BN statistics widens to
    :data:`DP_SPREAD` × one process's own spread over
    :func:`_dp_orders` where that spread is above :data:`DP_TOL` (the
    bf16 layers' roundings follow the order of the sums), and the line
    names what was so held. So each fault of :data:`DP_FAULTS`, planted
    in both ranks' steps, must fail that check."""
    want = _dp_step(name, variables, batch, None, 0, 0.0)
    spreads = [_dp_step(name, variables, {k: v[order] for k, v in
                                          batch.items()}, None, 0, 0.0)
               for order in _dp_orders(batch["xyz"].shape[0],
                                       batch["xyz"].device)]
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    # the gradients 0 in exact arithmetic on this batch (grad_check's)
    _, _, cancelled, fragile = model_grads(
        _dp_model(name, variables, 0.0).to(DEV), name, batch)
    runs = run_ranks(_dp_rank, DP_WORLD, (name, variables, cpu_batch),
                     device=_dp_device(), backend="gloo")
    ranks = [r[None] for r in runs]
    for got in ranks[1:]:
        if not all(torch.equal(got["grads"][k], ranks[0]["grads"][k])
                   for k in got["grads"]):
            fail(f"dp {name}: the ranks' reduced gradients differ")
    failures, readings = _dp_check(name, ranks[0], want, spreads,
                                   cancelled, fragile)
    caught = {}
    for fault in DP_FAULTS:
        found = [_dp_check(name, r[fault], want, spreads, cancelled,
                           fragile)[0] for r in runs]
        caught[fault] = [len(f) for f in found]
        if not all(found):
            fail(f"dp {name}: the check passed a step with the fault "
                 f"{fault} planted")
    emit(f"dp {name} two gloo ranks on one card", {
        "card": power, "world": DP_WORLD, "batch": batch["xyz"].shape[0],
        "loss_one_process": float(want["loss"]),
        **readings, "failures_of_planted_faults_by_rank": caught})
    if failures:
        fail(f"dp {name}: two ranks against one process: {failures}")


def _step_ms(step, batch, gen):
    """Milliseconds a step of ``step``, over :data:`DP_STEP_TIMES` steps
    ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DP_STEP_TIMES):
        step(batch, gen)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / DP_STEP_TIMES


def _same(a, b) -> bool:
    return a["grads"].keys() == b["grads"].keys() and torch.equal(
        a["loss"], b["loss"]) and all(
        torch.equal(a[part][k], b[part][k])
        for part in ("grads", "buffers") for k in a[part])


def _world1(name, variables, dropout, group, power):
    """The step of model ``name`` (B=64, N=1024, PointNet++ with normals)
    with the one-process ``group`` against the step without one, twice.
    At a world of 1 the group's step sums nothing over ranks and keeps
    sync-BN local, so the two run the same arithmetic: bit-identical
    where the step is bit-reproducible run to run. Where its kernels'
    atomic sums are not, the group's step and a second step without a
    group are each held to the first under ``tools/grad_check.py``'s
    bounds (loss and every gradient). Then both timed in turns (plain,
    group, group, plain)."""
    batch = {k: v.to(DEV) for k, v in synthetic_batch(
        name, BATCH, 5, N_POINTS).items()}
    plain = _dp_step(name, variables, batch, None, 0, dropout)
    again = _dp_step(name, variables, batch, None, 0, dropout)
    world1 = _dp_step(name, variables, batch, group, 0, dropout)
    reproducible = _same(plain, again)
    if reproducible and not _same(plain, world1):
        fail(f"dp {name} world of 1 over NCCL: the step differs from the "
             f"step without a group (bit-reproducible run to run)")
    agreement = {}
    if not reproducible:
        _, _, cancelled, fragile = model_grads(
            _dp_model(name, variables, 0.0).to(DEV), name, batch)
        for tag, run in (("rerun", again), ("world1", world1)):
            check = compare_grads(name, (float(run["loss"]), run["grads"]),
                                  (float(plain["loss"]), plain["grads"],
                                   cancelled, fragile))
            if check["failures"]:
                fail(f"dp {name} world of 1 over NCCL: {tag} against the "
                     f"step without a group: {check['failures']}")
            agree = check["agree"]
            agreement[tag] = {
                "loss_rel_dev": abs(float(run["loss"]) - float(
                    plain["loss"])) / abs(float(plain["loss"])),
                "worst_grad_cos": min(agree.items(),
                                      key=lambda kv: kv[1][0]),
                "worst_grad_norm_ratio": max(
                    agree.items(), key=lambda kv: abs(kv[1][1] - 1))}
    steps = []
    for g in (None, group):
        model = _dp_model(name, variables, dropout)
        make = make_seg_train_step if name in SEG else make_cls_train_step
        steps.append(make(model, sgd_momentum(model.parameters(), 0.05),
                          device=DEV if g is None else None, group=g))
    gen = torch.Generator(device=DEV).manual_seed(0)
    for st in steps:
        st(batch, gen)
    order = (0, 1, 1, 0)
    ms = [_step_ms(steps[i], batch, gen) for i in order]
    emit(f"dp {name} world of 1 over NCCL", {
        "card": power, "batch": BATCH,
        "plain_rerun_bit_identical": reproducible,
        "bit_identical": _same(plain, world1),
        "grad_check_vs_plain": agreement,
        "plain_step_ms": [m for i, m in zip(order, ms) if i == 0],
        "world1_step_ms": [m for i, m in zip(order, ms) if i == 1]})


def phase_dp(power):
    """Data parallelism at full width. (a) A world of 1 over NCCL
    (:func:`_world1`): PointNet (B=64; no kernel, every step
    bit-reproducible) bit-identical to its step without a group, and
    PointNet++ SSG (B=64, N=1024, normals, its dropout) bit-identical
    where two steps without a group are, else under grad_check's bounds
    as such a second step is; at a world of 1 the group's step sums
    nothing over ranks and keeps sync-BN local. (b) Two processes on this
    one card over gloo (which takes CUDA tensors), SSG at B=32 each,
    against one process at B=64 (:func:`_dp_two_ranks`), with two faults
    planted that the check must reject. (c) The same for one DGCNN
    part-segmentation step (B=16, N=2048; 8 a rank), which puts the
    two-layer EdgeConv kernels' statistics under the sums over the ranks.
    Two ranks on one card measure correctness, not speed. Prints the
    phase's seconds."""
    t0 = time.perf_counter()
    name = "pointnet2"
    variables = random_jax_variables(get_cls_model(name), seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        group = init_group(0, 1, f"file://{tmp}/store", device=_dp_device())
        try:
            _world1("pointnet", random_jax_variables(
                get_cls_model("pointnet"), seed=0), 0.5, group, power)
            _world1(name, variables, 0.5, group, power)
        finally:
            torch.distributed.destroy_process_group()
    batch = {k: v.to(DEV) for k, v in synthetic_batch(
        name, BATCH, 5, N_POINTS).items()}
    torch.cuda.empty_cache()
    _dp_two_ranks(name, variables, batch, power)
    dseg_vars = random_jax_variables(build_model(DSEG), seed=0)
    dseg = {k: v.to(DEV) for k, v in synthetic_batch(
        DSEG, SEG_BATCH, 5, SEG_POINTS).items()}
    _dp_two_ranks(DSEG, dseg_vars, dseg, power)
    torch.cuda.empty_cache()
    emit("dp phase", {"seconds": time.perf_counter() - t0})


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
    pn_vars = random_jax_variables(get_cls_model("pointnet"), seed=0)
    pnseg_vars = random_jax_variables(build_model(PN_SEG), seed=0)
    pcnn_vars = random_jax_variables(get_cls_model("pointcnn"), seed=0)
    pcnnseg_vars = random_jax_variables(build_model(PCNN_SEG), seed=0)
    onehot = torch.zeros((seg_xyz.shape[0], 16), device=DEV)
    for kernel, rs in phase_path_kernels((
            ("pointconv cls", _model_on_card("pointconv", pc_vars),
             (xyz[:PC_BATCH], nrm[:PC_BATCH]),
             {"gather_neighbors": 2, "knn_gather": 1}),
            ("pointconv seg", _model_on_card(PC_SEG, pcseg_vars),
             (seg_xyz, onehot), {"gather_neighbors": 3, "knn_gather": 2}),
            ("pointcnn cls", _model_on_card("pointcnn", pcnn_vars),
             (xyz[:PCNN_BATCH],),
             {"knn_gather": 4, "fps": 2, "scatter_rows": 4}),
            ("pointcnn seg", _model_on_card(PCNN_SEG, pcnnseg_vars),
             (seg_xyz, onehot),
             {"knn_gather": 8, "fps": 3, "scatter_rows": 8}))).items():
        recs.setdefault(kernel, []).extend(rs)
    phase_gather_edge_cases()
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
    paths["pointnet_serving"] = phase_serving(
        "pointnet", pn_vars, (clouds, normals), power, PN_BATCH, PN_SERVE,
        {})
    paths["pointnet_train"] = phase_train("pointnet", pn_vars, power,
                                          PN_BATCH, PN_STEP)
    paths["pointnet_partseg_serving"] = phase_seg_serving(
        PN_SEG, pnseg_vars, power, PN_SERVE, SEG_CHECK)
    paths["pointnet_partseg_train"] = phase_train(
        PN_SEG, pnseg_vars, power, SEG_BATCH, PN_STEP)
    paths["pointcnn_serving"] = phase_serving(
        "pointcnn", pcnn_vars, (clouds, normals), power, PCNN_BATCH,
        PCNN_SERVE, {})
    paths["pointcnn_train"] = phase_train("pointcnn", pcnn_vars, power,
                                          PCNN_BATCH, PCNN_STEP)
    paths["pointcnn_partseg_serving"] = phase_seg_serving(
        PCNN_SEG, pcnnseg_vars, power, PCNNSEG_SERVE, SEG_CHECK)
    paths["pointcnn_partseg_train"] = phase_train(
        PCNN_SEG, pcnnseg_vars, power, SEG_BATCH, PCNNSEG_STEP)
    paths.update(phase_cli(power))
    for name in KP_NAMES:
        kp_vars = random_jax_variables(get_cls_model(name), seed=0)
        cal, kp_recs = phase_kpconv_kernels(name, kp_vars)
        for kernel, rs in kp_recs.items():
            recs.setdefault(kernel, []).extend(rs)
        emit(f"kpconv {name} kernel column", _kp_column(kp_recs))
        paths[f"{name}_serving"], paths[f"{name}_train"] = phase_kpconv(
            name, kp_vars, power, cal, (clouds, normals))
        torch.cuda.empty_cache()
    recs["knn_rank"], large = phase_kpconv_large(
        random_jax_variables(get_cls_model("kpconv"), seed=0), power)
    paths.update(large)
    phase_dp(power)

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
