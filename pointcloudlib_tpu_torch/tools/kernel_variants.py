"""Design variants of the FPS kernel, of the forward tail's stage 2, of
forward pass 1, of the row scatter-add and gather, of the standalone kNN,
of the two-layer EdgeConv's backward passes and forward tails and of the
EdgeConv kernels with the kNN inside, of the EdgeConv backward, of
the two-layer eval kernel from a given index, of the 3-NN interpolation,
of the EdgeConv's given-index pass 1, of the fused kNN + gather and of
the ball query, timed against each other on the card. Each variant
is an edit of the committed source (``csrc/fps.cu``,
``csrc/fused_sa_tail.cu``, ``csrc/fused_sa_bq_f1.cu`` and
``fused_sa_f1.cu``, ``csrc/scatter_rows.cu`` and ``gather_rows.cu``,
``csrc/knn.cu``, ``csrc/edge2_bwd_p1.cu``, ``csrc/edge2_bwd_p2.cu``,
``csrc/edge_knn_f1.cu``, ``csrc/edge_knn_eval.cu`` and
``edge2_knn_eval.cu``, ``csrc/edge2_tail.cu``, ``csrc/edge_bwd.cu``,
``csrc/edge2_eval.cu``, ``csrc/three_interp.cu``, ``csrc/edge_f1.cu``,
``csrc/knn_gather.cu``, ``csrc/ball_query.cu``),
built beside it by ``nvcc`` with the package's flags into
``build/variants/``.

    python -m pointcloudlib_tpu_torch.tools.kernel_variants \
        [--only fps tail f1 rows knn edge2p1 edgef1 edge2p2 edgeeval tail2
                edgebwd edge2eval interp edgef1idx kg bq read cluster]
        [--parent DIR]

``--parent DIR`` names another checkout's ``csrc/`` (the parent commit's,
unpacked by ``git archive``): its ``fps.cu``, ``fused_sa_tail.cu``,
pass-1 and row sources are built against its own headers and timed
beside the variants. Prints one JSON line a case:

* ``fps``: ns a pick (device ms of one launch by CUDA graphs over the
  m - 1 picks after the seed) and whether the indices equal the plain
  version's, at each FPS launch shape of the ported paths, for the
  launcher's table (``table``) and for every instance (points a thread ×
  warps a cloud) of each variant: ``built``, ``redux2`` (the candidates of
  every warp count reduced by ``redux.sync``; the built kernel reads up to
  four in registers) and ``shuffle`` (a warp's argmax by a shuffle tree in
  place of ``redux.sync``);
* ``tail``: stage 2's device ms and deviation over max|plain| at each
  train shape of the PointNet++ paths (random h1: stage 2 takes no path
  that depends on the data) for ``built``, ``depth2`` / ``depth4`` (h1
  tiles a warpgroup), ``two_an_sm`` (two warpgroups an SM at every
  width), ``copy_only`` (the copies alone: no y1 staging, no product;
  time only) and ``copy_cm`` (``copy_only`` with each warp's copies in
  y1's core-matrix order, eight half lines a warp; time only);
* ``f1``: pass 1's kernel alone at the train shapes of ``F1`` (device
  ms by CUDA graphs, h1 bit-identical to the plain version's, psum's
  deviation over max|plain|) for each of ``F1_VARIANTS`` (store paths,
  unroll, occupancy, the grid of ``bq_f1`` and the split of the design
  into its parts; a part's h1 and sums are wrong by design);
* ``rows`` (not in the default set): at every path shape of
  ``SCATTER_PATHS`` and ``GATHER_PATHS``, device ms by CUDA graphs and the
  deviation from the plain version (scatter, over max|plain|) or bit
  identity (gather) of each of ``NEW_VARIANTS`` by the wrapper's route,
  both routes where the scatter's narrow route fits (``built_narrow``,
  ``built_wide``), and the library call (``index_add``: with its
  ``zero_``; ``torch.gather``); with ``--parent``, the parent's kernels,
  its wrapper's memset and the parents' split (``PARENT_SPLIT``: edits of
  the sources before the routes, a part's output wrong by design); the
  atomic and reduction instructions of the built kernels (``cuobjdump
  -sass``); and both scatter routes forced at the cut-off sizes of
  ``SCATTER_CUTOFF``;
* ``knn`` (not in the default set): at the self-kNN inputs of DGCNN's
  four EdgeConvs (the model's eval chain, seeded weights; B=32, k=20) at
  N=10,000 and N=1,000, device ms (events over three calls above 2·10⁵
  point channels, else CUDA graphs) and idx and d² against the plain
  version, for the built kernel at every route (``block`` and each
  select instance of ``knn.SELECT``: queries a block, tiles in the ring,
  the FMA pass) and for ``KNN_VARIANTS`` (``no_select``: the products
  alone); with ``--parent``, the parent's kernel and its split
  (``PARENT_KNN_SPLIT``: products, walk and loads alone, and the walk's
  insertion counts);
* ``edge2p1`` (not in the default set): pass 1 at DGCNN part
  segmentation's shapes (B=16, k=40, N=2,048 and 1,000; seeded random
  inputs), device ms with the memsets and the largest deviation from the
  plain version over max|plain|, for the built kernel and
  ``E2_VARIANTS`` (the mats product left out, or waited for at once);
  with ``--parent``, the parent's kernels and their split
  (``PARENT_E2_SPLIT``);
* ``edgef1`` (not in the default set): pass 1 with the kNN inside at
  its seven launches of the DGCNN paths (the models' own train inputs,
  seeded weights), device ms with the psum memset (and the select
  route's norms launch), idx and h against the plain version and psum's
  deviation, for the built kernel on every route of ``knn.EDGE_ROUTES``
  that takes the shapes and for ``EF1_VARIANTS``; with ``--parent``, the
  parent's kernel and its split (``PARENT_F1_SPLIT``: the selection, the
  write and the selection's loads alone);
* ``edge2p2`` (not in the default set): the two-layer pass 2 at DGCNN
  part segmentation's shapes (B=16, k=40, N=2,048 and 1,000), device ms
  with dq's memset and the deviation of dq and doff, for the built
  kernel and ``E2P2_VARIANTS``; with ``--parent``, the parent's kernel
  and its split (``PARENT_P2_SPLIT``: the tie walk alone, the products
  as copies, without dq's reductions, the reductions alone);
* ``edgeeval`` (not in the default set): the eval kernels with the kNN
  inside at their seven served launches (the models' eval chains, seeded
  weights), device ms by CUDA graphs (with the select route's norms
  launch) and out against the plain version (bit-identical, and the
  deviation over max|plain|), for the built kernels on every route of
  ``knn.EDGE_ROUTES`` that takes the shapes and for ``EVAL_VARIANTS``;
  with ``--parent``, the parents' kernels and their split
  (``PARENT_EVAL_SPLIT``: the selection alone, the rows or the chain
  with the lists given, the chain's loads alone);
* ``tail2`` (not in the default set): the two-layer forward tails
  (``edge2_stats2``, ``edge2_out``) at DGCNN part segmentation's shapes
  (h1 [16, N, 40, 64], N=2,048 and 1,000; seeded random inputs), device
  ms by CUDA graphs and the deviation from the plain version over
  max|plain|, for the built kernel and ``TAIL2_VARIANTS`` (stats2 also
  over h1 read flat, ``TAIL2_FLAT``); with ``--parent``, the parent's
  kernel and its split (``PARENT_TAIL2_SPLIT``: the loads, the product
  and the flush alone);
* ``edgebwd`` (not in the default set): ``edge_bwd`` at its ten
  launches of the main paths (DGCNN's four EdgeConvs at N=1024 and
  N=1,000, part segmentation's EC3 at N=2,048 and 1,000; the models' own
  inputs, seeded weights), device ms by CUDA graphs with the wrapper's
  two memsets, the count column exact, the deviation of
  ps, scat, d1 and d2 over max|plain|, with the quads whose dz is not
  all 0, for the built kernel and
  ``BWD_VARIANTS``; with ``--parent``, the parent and its split
  (``PARENT_BWD_SPLIT``: no reductions, each half's alone, the dz half
  sparse by quads or by channels);
* ``edge2eval`` (not in the default set): ``edge2_eval`` at part
  segmentation's two pairs on the kNN route (B=16, N=1,000, k=40), device
  ms by CUDA graphs and the deviation over max|plain|, for the built
  kernel and ``E2E_VARIANTS``; with ``--parent``, the parent's kernel;
* ``interp`` (not in the default set): ``three_interp`` at its six
  launches of the main paths (the part-segmentation models' eval forward,
  seeded weights), device ms by CUDA graphs, idx bit-identical and the
  deviation of w and out over max|plain|, for the built kernel at every
  lane group of ``three_interp.GROUPS`` and for ``TI_VARIANTS`` (output
  units in flight, launch bounds); with
  ``--parent``, the parent's kernel and its split (``PARENT_TI_SPLIT``:
  the staging, the staging and walk, the rows from a given idx);
* ``edgef1idx`` (not in the default set): ``edge_f1`` at its seven
  launches (DGCNN's train chain at N=1,000, part segmentation's on its
  kNN route), device ms with the psum memset, h bit-identical and psum's
  deviation, for the built kernel on both routes and ``EFG_VARIANTS``;
  with ``--parent``, the parent's kernel and its split
  (``PARENT_EFG_SPLIT``: ``load_nbr``, the row pass);
* ``kg`` (not in the default set): the fused kNN + gather at its three
  launches of the main paths (the PointConv models' eval forward, seeded
  weights), device ms by CUDA graphs and idx and grouped against the plain
  version, for the built kernel on both routes of ``knn_gather.ROUTES``
  and ``KG_VARIANTS``; with ``--parent``, the parent's kernel and its split
  (``PARENT_KG_SPLIT``: the d² row, the selection, the rows from a given
  idx);
* ``bq`` (not in the default set): the ball query at its three launches
  (the MSG model's two k=128 scales, SSG's SA1 at N=4096 Hilbert-sorted),
  device ms by CUDA graphs and idx and cnt against the plain version, the
  pairs the cull route tests, for the built kernel on both routes of
  ``ball_query.ROUTES`` and ``BQ_VARIANTS``; with ``--parent``, the
  parent's kernel and its split (``PARENT_BQ_SPLIT``: staging, ballots,
  stores, fill);
* ``read``: the card's rate reading 268 MB by plain 16-byte vector loads,
  and writing it by 16-byte stores with and without the streaming hint;
* ``cluster``: ns an exchange shaped like one pick's (each warp writes a
  candidate, one barrier, every thread reads one), by a block barrier and
  by a two-block cluster's barrier through the peer's shared memory.

Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

import torch

from pointcloudlib_tpu_torch.data.synthetic import (
    SyntheticModelNet,
    SyntheticShapeNetPart,
)
from pointcloudlib_tpu_torch.ops import geometry
from pointcloudlib_tpu_torch.ops.kernels import _build
from pointcloudlib_tpu_torch.ops.kernels import fps as kfps
from pointcloudlib_tpu_torch.ops.kernels import knn as kknn
from pointcloudlib_tpu_torch.ops.kernels import fused_sa_train as kft

OUT = _build.BUILD_DIR.parent / "variants"
DEV = torch.device("cuda")

# (points a thread, warps a cloud) instances timed for each FPS variant
FPS_SHAPES = [(p, w) for p in (1, 2, 4, 8, 16, 32)
              for w in (1, 2, 4, 8, 16, 32) if p * w <= 512]
SHUFFLE_BEST = """__device__ __forceinline__ void warp_best(unsigned& key,
                                          unsigned& idx) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    const unsigned ok = __shfl_xor_sync(0xffffffffu, key, off);
    const unsigned oi = __shfl_xor_sync(0xffffffffu, idx, off);
    if (ok > key || (ok == key && oi < idx)) {
      key = ok;
      idx = oi;
    }
  }
}
"""
STAGE2_CONVERT = """#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int e = t + i * WT;
      const uint4 hv = raw[raw_unit<C1>(e / C1 * 8 + e % 8, c0)];
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = bn_relu(bf_at(hv, j), sc1[j], bi1[j]);
      reinterpret_cast<uint4*>(y1s)[e] = pack8(v);
    }
"""
STAGE2_PRODUCT = """    wg::product<C2, 0, 1, C1 / 16>(h2, wg::k_major(y1s, C1, 0, 0),
                                   wg::mn_major(w2s, C2, 0, 0));
"""
STAGE2_NO_PRODUCT = """#pragma unroll
    for (int i = 0; i < C2 / 2; ++i) h2[i] = __bfloat162float(y1s[t + i]);
"""
STAGE2_COPY = ("cp_async16(dst + raw_unit<C1>(u / (C1 / 8), u % (C1 / 8)), "
               "src + u);")
STAGE2_COPY_CM = ("cp_async16(dst + raw_unit<C1>(u / C1 * 8 + u % 8, "
                  "(u % C1) / 8), src + (u / C1 * 8 + u % 8) * (C1 / 8) + "
                  "(u % C1) / 8);")
DEPTH = "static constexpr int depth = 3;"
PER_SM = "C2 <= 32 ? 6 : C2 <= 64 ? 4 : C2 <= 96 ? 3 : 2;"
TAIL_VARIANTS = {
    "built": [],
    "depth2": [(DEPTH, DEPTH.replace("3", "2"))],
    "depth4": [(DEPTH, DEPTH.replace("3", "4"))],
    "two_an_sm": [(PER_SM, "2;")],
    "copy_only": [(STAGE2_CONVERT, ""), (STAGE2_PRODUCT, STAGE2_NO_PRODUCT)],
    "copy_cm": [(STAGE2_CONVERT, ""), (STAGE2_PRODUCT, STAGE2_NO_PRODUCT),
                (STAGE2_COPY, STAGE2_COPY_CM)],
}
# train shapes of the PointNet++ paths: case, rows = B·M·k, k, widths
TRAIN = [
    ("SSG SA1", 64 * 512 * 64, 64, (64, 64, 128)),
    ("SSG SA2", 64 * 128 * 64, 64, (128, 128, 256)),
    ("MSG1/0", 32 * 512 * 16, 16, (32, 32, 64)),
    ("MSG1/1", 32 * 512 * 32, 32, (64, 64, 128)),
    ("MSG1/2", 32 * 512 * 128, 128, (64, 96, 128)),
    ("MSG2/0", 32 * 128 * 32, 32, (64, 64, 128)),
    ("MSG2/1", 32 * 128 * 64, 64, (128, 128, 256)),
    ("MSG2/2", 32 * 128 * 128, 128, (128, 128, 256)),
    ("PS SA1", 16 * 512 * 64, 64, (64, 64, 128)),
    ("PS SA2", 16 * 128 * 64, 64, (128, 128, 256)),
    ("SSG4096 SA1", 32 * 512 * 64, 64, (64, 64, 128)),
    ("SSG4096 SA2", 32 * 128 * 64, 64, (128, 128, 256)),
]
READ = r"""
#include <cuda_runtime.h>
template <int U>
__global__ void read_kernel(const uint4* __restrict__ p, long long n,
                            float* out) {
  float acc = 0.0f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + (U - 1) * stride < n; i += U * stride) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = __ldcs(p + i + u * stride);
#pragma unroll
    for (int u = 0; u < U; ++u)
      acc += __uint_as_float(v[u].x ^ v[u].y ^ v[u].z ^ v[u].w);
  }
  if (acc == 1.2345f) out[0] = acc;  // keeps the loads
}
template <bool CS>
__global__ void write_kernel(uint4* p, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const uint4 v = make_uint4(threadIdx.x, blockIdx.x, 0u, 0u);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (CS)
      __stcs(p + i, v);
    else
      p[i] = v;
  }
}
extern "C" int write_launch(void* p, long long n16, int blocks, int cs,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cs) write_kernel<true><<<blocks, 256, 0, s>>>((uint4*)p, n16);
  else write_kernel<false><<<blocks, 256, 0, s>>>((uint4*)p, n16);
  return cudaGetLastError();
}
extern "C" int read_launch(const void* p, long long n16, void* out,
                           int blocks, int unroll, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const uint4* x = (const uint4*)p;
  if (unroll == 1) read_kernel<1><<<blocks, 256, 0, s>>>(x, n16, (float*)out);
  if (unroll == 4) read_kernel<4><<<blocks, 256, 0, s>>>(x, n16, (float*)out);
  if (unroll == 8) read_kernel<8><<<blocks, 256, 0, s>>>(x, n16, (float*)out);
  return cudaGetLastError();
}
"""
CLUSTER = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
__global__ void __cluster_dims__(2, 1, 1) cluster_loop(int m, unsigned* out) {
  __shared__ unsigned buf[2][32];
  cg::cluster_group cluster = cg::this_cluster();
  unsigned* peer =
      cluster.map_shared_rank(&buf[0][0], cluster.block_rank() ^ 1);
  const int w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  unsigned v = threadIdx.x;
  for (int s = 0; s < m; ++s) {
    if ((threadIdx.x & 31) == 0) {
      buf[s & 1][w] = v;
      peer[(s & 1) * 32 + nw + w] = v;
    }
    cluster.sync();
    v = buf[s & 1][(w + 1) % (2 * nw)] + 1;
  }
  if (v == 12345u) out[0] = v;
}
__global__ void block_loop(int m, unsigned* out) {
  __shared__ unsigned buf[2][32];
  const int w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  unsigned v = threadIdx.x;
  for (int s = 0; s < m; ++s) {
    if ((threadIdx.x & 31) == 0) buf[s & 1][w] = v;
    __syncthreads();
    v = buf[s & 1][(w + 1) % nw] + 1;
  }
  if (v == 12345u) out[0] = v;
}
extern "C" int exchange_launch(int cluster, int blocks, int threads, int m,
                               void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cluster) cluster_loop<<<blocks, threads, 0, s>>>(m, (unsigned*)out);
  else block_loop<<<blocks, threads, 0, s>>>(m, (unsigned*)out);
  return cudaGetLastError();
}
"""


def edited(text: str, edits) -> str:
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"variant edit not found in the source: {old}")
        text = text.replace(old, new)
    return text


def build(sources: Dict[str, tuple]) -> Dict[str, ctypes.CDLL]:
    """``{name: (source text, include dir)}`` compiled in parallel, each
    one's compiler report kept beside it (``build/variants/NAME.log``)."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, (text, include) in sources.items():
        src = OUT / f"{name}.cu"
        src.write_text(text)
        jobs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(include), "-o",
             str(OUT / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, job in jobs.items():
        log, _ = job.communicate()
        (OUT / f"{name}.log").write_text(log)  # -Xptxas -v's report
        if job.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(OUT / f"{name}.so"))
    return libs


def graph_ms(fn, iters: int = 10) -> float:
    """Mean device ms a call: ``iters`` calls in one CUDA graph, replayed
    three times between CUDA events."""
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
    return start.elapsed_time(end) / (3 * iters)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def fps_cases():
    """``(case, xyz, m, skip)`` at each FPS launch shape of the ported
    paths; a second launch takes the first one's centers."""
    ssg = torch.from_numpy(SyntheticModelNet(
        n_points=1024, size=64, seed=0).batch(0, 64)[0]).to(DEV)
    seg = torch.from_numpy(SyntheticShapeNetPart(
        n_points=2048, size=16, seed=0).batch(0, 16)[0]).to(DEV)
    big = torch.from_numpy(SyntheticModelNet(
        n_points=4096, size=32, seed=0).batch(0, 32)[0]).to(DEV)

    def centers(x, m, skip):
        return geometry.index_points(x, kfps.fps_plain(x, m, skip))

    seg256 = centers(centers(seg, 1024, False), 256, False)
    return [("SSG 1024->512", ssg, 512, True),
            ("SSG 512->128", centers(ssg, 512, True), 128, True),
            ("PS 2048->512", seg, 512, True),
            ("SSG4096 4096->512", big, 512, True),
            ("PC seg 256->64", seg256, 64, False),
            ("PC seg 64->36", centers(seg256, 64, False), 36, False)]


def run_fps(parent: Optional[Path]) -> None:
    new = (_build.CSRC / "fps.cu").read_text()
    launcher = ("\nextern \"C\" int fps_launch_at(const void* xyz, void* out, "
                "int b, int n, int m, int skip, void* stream, int ppt, "
                "int nw) {\n")
    for p, w in FPS_SHAPES:
        launcher += (f"  if (ppt == {p} && nw == {w}) return pcl::launch<{p}, "
                     f"{w}>(static_cast<const float*>(xyz), static_cast<int*>"
                     "(out), b, n, m, skip, static_cast<cudaStream_t>"
                     "(stream));\n")
    launcher += "  return 1;\n}\n"
    a = new.index("__device__ __forceinline__ void warp_best")
    b = new.index("}\n", new.index("key = best;")) + 2
    sources = {
        "fps_built": (new + launcher, _build.CSRC),
        "fps_redux2": (edited(new, [("if (NW <= 4) {", "if (NW <= 0) {")])
                       + launcher, _build.CSRC),
        "fps_shuffle": (new[:a] + SHUFFLE_BEST + new[b:] + launcher,
                        _build.CSRC),
    }
    if parent:
        sources["fps_parent"] = ((parent / "fps.cu").read_text(), parent)
    libs = build(sources)
    for case, x, m, skip in fps_cases():
        b, n, _ = x.shape
        want = kfps.fps_plain(x, m, skip)
        out = torch.empty((b, m), dtype=torch.int32, device=DEV)
        rec: Dict[str, list] = {}

        def timed(key, fn):
            out.zero_()
            if fn() != 0:
                raise RuntimeError(f"fps {key}: launch error")
            torch.cuda.synchronize()
            same = torch.equal(out, want)
            rec[key] = [round(graph_ms(fn) * 1e6 / (m - 1), 1), same]

        args = (_ptr(x), _ptr(out), b, n, m, int(skip))
        timed("table", lambda: libs["fps_built"].fps_launch(*args, _stream()))
        if parent:
            timed("parent",
                  lambda: libs["fps_parent"].fps_launch(*args, _stream()))
        for name in ("built", "redux2", "shuffle"):
            for p, w in FPS_SHAPES:
                if not n <= 32 * p * w < 4 * n:
                    continue
                timed(f"{name} {p}x{w}", lambda: getattr(
                    libs[f"fps_{name}"], "fps_launch_at")(
                        *args, _stream(), p, w))
        print(json.dumps({"fps": case, "B": b, "N": n, "M": m,
                          "ns_a_pick_and_identical": rec}), flush=True)


def run_tail(parent: Optional[Path]) -> None:
    src = (_build.CSRC / "fused_sa_tail.cu").read_text()
    sources = {f"tail_{name}": (edited(src, edits), _build.CSRC)
               for name, edits in TAIL_VARIANTS.items()}
    if parent:
        sources["tail_parent"] = ((parent / "fused_sa_tail.cu").read_text(),
                                  parent)
    libs = build(sources)
    g = torch.Generator(device=DEV).manual_seed(0)
    for case, rows, k, (c1, c2, c3) in TRAIN:
        h1 = (torch.randn((rows // k, 1, k, c1), generator=g, device=DEV)
              * 0.7).bfloat16()
        st1 = torch.stack([torch.rand(c1, generator=g, device=DEV) + 0.5,
                           torch.randn(c1, generator=g, device=DEV) * 0.1,
                           torch.ones(c1, device=DEV),
                           torch.zeros(c1, device=DEV)])
        w2 = torch.randn((c1, c2), generator=g, device=DEV) / c1 ** 0.5
        w3 = torch.randn((c2, c3), generator=g, device=DEV) / c2 ** 0.5
        st = torch.zeros(4 * (c1 + c2 + c3), device=DEV)
        st[:4 * c1] = st1.reshape(-1)
        w2b, w3b = w2.bfloat16().contiguous(), w3.bfloat16().contiguous()
        want = kft.sa_tail_plain(2, h1, st1, None, None, w2, w3).double()
        out = torch.zeros((2, c2), device=DEV)
        rec: Dict[str, list] = {}
        for name, lib in libs.items():
            def call(lib=lib):
                out.zero_()
                return lib.sa_tail_launch(
                    2, _ptr(h1), _ptr(st), _ptr(w2b), _ptr(w3b), _ptr(out),
                    ctypes.c_longlong(rows), k, c1, c2, c3, _stream())

            if call() != 0:
                raise RuntimeError(f"{name}: launch error")
            torch.cuda.synchronize()
            dev = ((out.double() - want).abs().max()
                   / want.abs().max()).item()
            rec[name.replace("tail_", "")] = [round(graph_ms(call, 5), 4),
                                              float(f"{dev:.2e}")]
        print(json.dumps({"tail stage 2": case, "rows": rows,
                          "widths": [c1, c2, c3], "ms_and_dev": rec}),
              flush=True)


# Forward pass 1 (csrc/fused_sa_bq_f1.cu, the ball query inside, "bq";
# csrc/fused_sa_f1.cu, from the ball query's idx, "idx") at the train
# shapes of the PointNet++ paths: case, clouds, B, centers of each FPS
# level in turn (a level samples the previous one's centers), radius, k,
# C1, route. q and off are random: the pass's work depends on the
# neighbours alone, which come from the clouds as in the models.
F1 = [
    ("SSG SA1", "modelnet", 64, (512,), 0.2, 64, 64, "bq"),
    ("SSG SA2", "modelnet", 64, (512, 128), 0.4, 64, 128, "bq"),
    ("MSG1/0", "modelnet", 32, (512,), 0.1, 16, 32, "bq"),
    ("MSG1/1", "modelnet", 32, (512,), 0.2, 32, 64, "bq"),
    ("MSG1/2", "modelnet", 32, (512,), 0.4, 128, 64, "idx"),
    ("MSG2/2", "modelnet", 32, (512, 128), 0.8, 128, 128, "idx"),
    ("PS SA1", "shapenet", 16, (512,), 0.2, 64, 64, "bq"),
    ("PS SA2", "shapenet", 16, (512, 128), 0.4, 64, 128, "bq"),
    ("SSG4096 SA1", "modelnet4096", 32, (512,), 0.2, 64, 64, "idx"),
]
F1_SOURCES = {"bq": "fused_sa_bq_f1.cu", "idx": "fused_sa_f1.cu"}
F1_STORE = "  __stcs(reinterpret_cast<uint4*>(p), v);\n"
F1_PLAIN_STORE = "  *reinterpret_cast<uint4*>(p) = v;\n"
F1_CALL = """  f1_span<C1>(qc, off, nbr, first, p0, 0, k, rr, hc + cg * 8, s);
"""
# the rows staged in shared memory, two 2 KB halves a warp, each half
# written by one bulk asynchronous copy (cp.async.bulk, no tensor map)
F1_BULK = """  __shared__ __align__(16) unsigned char stage[kWarps][4096];
  constexpr int R = 2048 / (C1 * 2);  // rows a half
  unsigned char* stg = stage[threadIdx.x / 32];
  int half = 0;
  for (int cb = 0; cb < k; cb += R, half ^= 1) {
    const int ce = min(cb + R, k);
    __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(stg + half * 2048);
    if (lane == 0)  // the copy that read this half two chunks ago is done
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
    __syncwarp();
    f1_span<C1>(qc, off, nbr, first, p0, cb, ce, rr, sb + cg * 8, s);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0)
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\\n"
          "cp.async.bulk.commit_group;" ::"l"(hc + (size_t)cb * C1),
          "r"((unsigned)__cvta_generic_to_shared(sb)),
          "r"((ce - cb) * C1 * 2)
          : "memory");
  }
  if (lane == 0)  // the next center (or the block's exit) reuses stage
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  __syncwarp();
"""
F1_UNROLL = "constexpr int kF1Unroll = 4;"
F1_MIN_BLOCKS = "constexpr int kF1MinBlocks = 3;"
F1_CHUNKS = "const int chunks = max(1, wave / batch);"
F1_WRITE = """    f1_center<C1>(qg, a.off + center * C1, a.h1 + center * k * C1, nbr, k,
                  lane, s);
"""
F1_SCAN = """    const int count = bq_scan(a.new_xyz + center * 3, ptss, n, k, a.r2,
                              lane, nbr);
    bq_fill(nbr, count, k, lane);
"""
STAGE_CLOUD = ("  stage_cloud(a.pts + (size_t)b * n * 3, n, ptss, "
               "threadIdx.x, kThreads);\n")
F1_SUMS = """      s[c] = fmaf(times, h[c], s[c]);
      ss[c] = fmaf(times, h[c] * h[c], ss[c]);
"""
# Variants of the committed pass 1: (routes, edits of the source, edits
# of its header fused_sa_f1.cuh). The store path: 16-byte stores with the
# streaming hint (built) or without it (plain_store), or rows staged in
# shared memory and written by bulk asynchronous copies (bulk4k: two
# 2 KB halves a warp); the gathers in flight a lane (unroll2, unroll8);
# the registers a thread (min2, min4: launch bounds of 2 or 4 resident
# blocks an SM in place of 3); the centers a block of bq_f1 (waves2,
# waves4: the grid two or four waves of resident blocks in place of
# one); and the split of the design into its parts (scan_only;
# write_only, the scan and the cloud's staging replaced by a copy of the
# ball query's idx, which the harness leaves in the idx buffer;
# no_sums).
F1_VARIANTS = {
    "built": (("bq", "idx"), [], []),
    "plain_store": (("bq", "idx"), [], [(F1_STORE, F1_PLAIN_STORE)]),
    "bulk4k": (("bq", "idx"), [],
               [(F1_STORE, F1_PLAIN_STORE), (F1_CALL, F1_BULK)]),
    "unroll2": (("bq", "idx"), [], [(F1_UNROLL, F1_UNROLL.replace("4", "2"))]),
    "unroll8": (("bq", "idx"), [], [(F1_UNROLL, F1_UNROLL.replace("4", "8"))]),
    "min2": (("bq", "idx"), [],
             [(F1_MIN_BLOCKS, F1_MIN_BLOCKS.replace("3", "2"))]),
    "min4": (("bq", "idx"), [],
             [(F1_MIN_BLOCKS, F1_MIN_BLOCKS.replace("3", "4"))]),
    "waves2": (("bq",), [(F1_CHUNKS, F1_CHUNKS.replace("wave", "2 * wave"))],
               []),
    "waves4": (("bq",), [(F1_CHUNKS, F1_CHUNKS.replace("wave", "4 * wave"))],
               []),
    "scan_only": (("bq",), [(F1_WRITE, "")], []),
    "write_only": (("bq",), [
        (STAGE_CLOUD, ""),
        (F1_SCAN, "    for (int e = lane; e < k; e += 32)\n"
                  "      nbr[e] = a.idx[center * k + e];\n"
                  "    const int count = k;\n")], []),
    "no_sums": (("bq", "idx"), [], [(F1_SUMS, "")]),
}


def f1_source(csrc: Path, route: str, edits, header_edits) -> str:
    """A pass-1 source of ``csrc`` with its edits; edits of its header
    ``fused_sa_f1.cuh`` are made in a copy pasted in place of its
    include."""
    header = "fused_sa_f1.cuh"
    text = (csrc / F1_SOURCES[route]).read_text()
    if header_edits:
        head = edited((csrc / header).read_text(), header_edits)
        text = edited(text, [(f'#include "{header}"', head)])
    return edited(text, edits)


def f1_cases():
    """``(case, route, nx, pts, q, off, radius, k)`` for each entry of
    ``F1``: clouds from the synthetic sets (SSG4096 sorted as its train
    step sorts them), centers by FPS."""
    from pointcloudlib_tpu_torch.ops import spatial

    g = torch.Generator(device=DEV).manual_seed(0)
    clouds = {
        "modelnet": lambda b: SyntheticModelNet(
            n_points=1024, size=b, seed=0).batch(0, b)[0],
        "modelnet4096": lambda b: SyntheticModelNet(
            n_points=4096, size=b, seed=0).batch(0, b)[0],
        "shapenet": lambda b: SyntheticShapeNetPart(
            n_points=2048, size=b, seed=0).batch(0, b)[0],
    }
    for case, data, b, levels, radius, k, c1, route in F1:
        pts = torch.from_numpy(clouds[data](b)).to(DEV)
        if data == "modelnet4096":
            pts = spatial.canonicalize(pts)[0]
        for i, m in enumerate(levels):
            nx = geometry.index_points(pts, kfps.fps_plain(pts, m, True))
            if i < len(levels) - 1:
                pts = nx
        n = pts.shape[1]
        q = torch.randn((b, n, c1), generator=g, device=DEV).bfloat16()
        off = torch.randn((b, m, c1), generator=g, device=DEV) * 0.3
        yield case, route, nx.contiguous(), pts.contiguous(), q, off, radius, k


def run_f1(parent: Optional[Path]) -> None:
    sources = {}
    for name, (routes, edits, head) in F1_VARIANTS.items():
        for route in routes:
            sources[f"f1{route}_{name}"] = (
                f1_source(_build.CSRC, route, edits, head), _build.CSRC)
    if parent:
        for route in ("bq", "idx"):
            sources[f"f1{route}_parent"] = (
                (parent / F1_SOURCES[route]).read_text(), parent)
    libs = build(sources)
    for name, lib in libs.items():
        source = "fused_sa_bq_f1" if name.startswith("f1bq") else "fused_sa_f1"
        for fn, (args, res) in kft._SIGNATURES[source].items():
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = args, res
    for case, route, nx, pts, q, off, radius, k in f1_cases():
        b, n, c1 = q.shape
        m = nx.shape[1]
        if route == "bq":
            idx, want, cnt, wsum = kft.bq_f1_plain(nx, pts, q, off, radius, k)
        else:
            idx, cnt = geometry.ball_query(nx, pts, radius, k)
            want, wsum = kft.sa_f1_plain(q, off, idx)
        idx_buf = idx.clone()
        h1 = torch.empty_like(want)
        cnt_out = torch.empty_like(cnt)
        psum = torch.zeros((2, c1), device=DEV)
        rec: Dict[str, list] = {}
        for name, lib in libs.items():
            if not name.startswith(f"f1{route}_"):
                continue

            def call(lib=lib):
                psum.zero_()
                if route == "bq":
                    return lib.sa_bq_f1_launch(
                        nx.data_ptr(), pts.data_ptr(), q.data_ptr(),
                        off.data_ptr(), idx_buf.data_ptr(), h1.data_ptr(),
                        cnt_out.data_ptr(), psum.data_ptr(), b, n, m, c1, k,
                        radius * radius, _stream().value)
                return lib.sa_f1_launch(
                    q.data_ptr(), off.data_ptr(), idx_buf.data_ptr(),
                    h1.data_ptr(), psum.data_ptr(), b, n, m, c1, k,
                    _stream().value)

            h1.zero_()
            idx_buf.copy_(idx)  # the write-only variants read it
            if call() != 0:
                raise RuntimeError(f"{name}: launch error")
            torch.cuda.synchronize()
            same = torch.equal(h1.view(torch.int16), want.view(torch.int16))
            dev = ((psum.double() - wsum.double()).abs().max()
                   / wsum.double().abs().max()).item()
            rec[name.split("_", 1)[1]] = [round(graph_ms(call, 5), 4), same,
                                          float(f"{dev:.2e}")]
        rows = b * m * k
        print(json.dumps({"f1": case, "route": route, "B": b, "N": n, "M": m,
                          "k": k, "C1": c1,
                          "cnt_mean": round(cnt.float().mean().item(), 2),
                          "h1_MB": round(2 * rows * c1 / 1e6, 1),
                          "ms_identical_dev": rec}), flush=True)
        del h1, want
        torch.cuda.empty_cache()


# The row scatter-add (csrc/scatter_rows.cu) and the row gather
# (csrc/gather_rows.cu) at every shape of the main paths: case, B, rows a
# batch, n, C. Inputs are random (uniform indices in [0, n), a few
# sentinels in the gather's): neither kernel's work depends on the data
# beyond how many rows meet in one target.
SCATTER_PATHS = [
    ("PS FP2 bwd", 16, 1536, 128, 256),
    ("PS FP1 bwd", 16, 6144, 512, 128),
    ("PC cls C=132", 32, 8192, 512, 132),
    ("PC cls C=1", 32, 16384, 1024, 1),
    ("PC seg 32768/2048/128", 16, 32768, 2048, 128),
    ("PC seg 16384/1024/256", 16, 16384, 1024, 256),
    ("PC seg 4096/256/512", 16, 4096, 256, 512),
    ("PC seg 6144/1024/128", 16, 6144, 1024, 128),
    ("PC seg 3072/256/256", 16, 3072, 256, 256),
    ("PC seg 768/64/512", 16, 768, 64, 512),
    ("PC seg 192/36/512", 16, 192, 36, 512),
    ("PC seg 2048/256/132", 16, 2048, 256, 132),
    ("PC seg 8192/1024/68", 16, 8192, 1024, 68),
]
# the narrow/wide cut-off of the scatter: out[b] of 4 to 64 KB at
# PointConv SA1's rows (B=32, 16,384 rows a batch), both routes forced
SCATTER_CUTOFF = [(f"cut-off C={c} n={n}", 32, 16384, n, c)
                  for c, ns in ((1, (4096, 8192, 12288, 16384)),
                                (3, (683, 1365, 2730, 4096)),
                                (6, (341, 682, 1365, 2048)),
                                (4, (1024, 2048, 3072, 4096)),
                                (12, (256, 512, 1024, 1365)))
                  for n in ns]
GATHER_PATHS = [
    ("PC cls SA1 C=6", 32, 16384, 1024, 6),
    ("PC cls SA1 C=1", 32, 16384, 1024, 1),
    ("PC seg n=256 C=512", 16, 4096, 256, 512),
    ("PC seg n=1024 C=256", 16, 16384, 1024, 256),
    ("PC seg n=2048 C=128", 16, 32768, 2048, 128),
]
# The parents' split (the sources before the routes, given by --parent):
# scatter with a plain store in place of the atomic (loads_only) and with
# a fixed index pattern, so that no load waits for the index
# (atomics_only); gather with the loads replaced by a value made from the
# index math (index_math_only), with the store kept only behind a test
# that never holds (loads_only), and with the body a store of zeros
# (stores_only). A part's output is wrong by design.
SCATTER_ATOMIC = ("for (int ch = lane; ch < c; ch += 32) "
                  "atomicAdd(o + ch, gr[ch]);")
GATHER_LOADS = """    const int t = __ldg(idx + r);
    T v;
    if (t >= 0 && t < n) {
      const long long b = r / rows_per_batch;
      v = __ldg(pts + ((size_t)b * n + t) * c + ch);
    } else {
      v = T{};
    }
"""
GATHER_BODY = """    const long long r = e / c;
    const int ch = (int)(e - r * c);
""" + GATHER_LOADS + "    out[e] = v;\n"
PARENT_SPLIT = {
    "scatter_rows": {
        "loads_only": [(SCATTER_ATOMIC, SCATTER_ATOMIC.replace(
            "atomicAdd(o + ch, gr[ch])", "o[ch] = gr[ch]"))],
        "atomics_only": [("const int t = idx[r];",
                          "const int t = (int)(r % n);")],
    },
    "gather_rows": {
        "index_math_only": [(GATHER_LOADS, """\
    const long long b = r / rows_per_batch;
    T v{};
    reinterpret_cast<float*>(&v)[0] = (float)(b + ch);
""")],
        "loads_only": [("    out[e] = v;\n", "    if (reinterpret_cast<const "
                        "float*>(&v)[0] == 1.2345f) out[e] = v;\n")],
        "stores_only": [(GATHER_BODY, "    out[e] = T{};\n")],
    },
}
# the parents' launchers: (a, idx, out, b, rows a batch, n, c, stream);
# this tree's take the route too: (..., c, narrow, stream)
PARENT_ROWS_ARGS = [ctypes.c_void_p] * 3 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]
ROWS_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# Variants of this tree's sources. Scatter: the narrow route's blocks
# flushing their copies into a zeroed out by 16-byte reductions in place
# of the cluster's sum (flush); clusters of at most 2, 4 or 16 blocks
# (cluster2/4/16; 16 is a non-portable size); 4 elements a narrow thread
# in place of 8 (per_thread4); 512 or 1024 threads a narrow block
# (narrow512/1024); loads of 2 or 8 steps in flight in place of 4
# (inflight2/8); the wide route's grid up to one or sixteen waves of
# resident blocks in place of four (waves1/16) and its f32 reductions in
# place of 16-byte ones (scalar_red), and at least 6 or 8 of its blocks
# resident an SM (min_blocks6/8: registers capped). Gather: the narrow
# route reading rows through L1/L2 without staging the cloud (unstaged);
# 256 threads a narrow block in place of 512 (threads256); 4 narrow
# blocks an SM in the grid's wave in place of 2 (per_sm4).
SR_REDUCE = ("  // this block's slice of out[b], summed over the cluster in "
             "rank order\n", "  cluster.sync();  // no block leaves while a "
             "peer still reads its copy\n")
SR_FLUSH = """  // flush: the block's copy added into a zeroed out by reductions
  float* ob = out + b * nw;
  if (nw % 4 == 0) {
    for (int i = threadIdx.x; i < nw4; i += kSrThreads)
      atomicAdd(reinterpret_cast<float4*>(ob) + i, acc4[i]);
  } else {
    for (int i = threadIdx.x; i < nw; i += kSrThreads)
      atomicAdd(ob + i, acc[i]);
  }
"""
SR_CLUSTER = "constexpr int kSrMaxCluster = 8;"
SR_PER_THREAD = "constexpr int kSrNarrowPerThread = 8;"
SR_INFLIGHT = "constexpr int kSrInFlight = 4;"
GN_THREADS = "constexpr int kGnThreads = 512;"
GN_PER_SM = "constexpr int kGnBlocksPerSm = 2;"
SR_WAVES = "constexpr int kSrWideWaves = 4;"
SR_WIDE_BOUNDS = ("__global__ void __launch_bounds__(kSrThreads)\n"
                  "    scatter_rows_kernel(")
SR_NARROW_THREADS = "constexpr int kSrNarrowThreads = 256;"
SR_KERNEL = "  auto kernel = narrow_scatter_rows_kernel<ONE>;\n"
NEW_VARIANTS = {
    "scatter_rows": {
        "built": [],
        "flush": [("const int rank = (int)cluster.block_rank();",
                   "const int rank = blockIdx.x;"),
                  ("const int cs = (int)cluster.num_blocks();",
                   "const int cs = gridDim.x;"),
                  ("cluster.sync();", "__syncthreads();"),
                  ("attr[0].val.clusterDim.x = cs;",
                   "attr[0].val.clusterDim.x = 1;")],
        "cluster2": [(SR_CLUSTER, SR_CLUSTER.replace("8", "2"))],
        "cluster4": [(SR_CLUSTER, SR_CLUSTER.replace("8", "4"))],
        "cluster16": [(SR_CLUSTER, SR_CLUSTER.replace("8", "16")),
                      (SR_KERNEL, SR_KERNEL + (
                          "  cudaFuncSetAttribute(kernel, cudaFuncAttribute"
                          "NonPortableClusterSizeAllowed, 1);\n"))],
        "per_thread4": [(SR_PER_THREAD, SR_PER_THREAD.replace("8", "4"))],
        "narrow512": [(SR_NARROW_THREADS,
                       SR_NARROW_THREADS.replace("256", "512"))],
        "narrow1024": [(SR_NARROW_THREADS,
                        SR_NARROW_THREADS.replace("256", "1024"))],
        "inflight2": [(SR_INFLIGHT, SR_INFLIGHT.replace("4", "2"))],
        "inflight8": [(SR_INFLIGHT, SR_INFLIGHT.replace("4", "8"))],
        "waves1": [(SR_WAVES, SR_WAVES.replace("4", "1"))],
        "waves16": [(SR_WAVES, SR_WAVES.replace("4", "16"))],
        "scalar_red": [("const bool vec = c % 4 == 0 &&",
                        "const bool vec = false &&")],
        "min_blocks6": [(SR_WIDE_BOUNDS, SR_WIDE_BOUNDS.replace(
            "(kSrThreads)", "(kSrThreads, 6)"))],
        "min_blocks8": [(SR_WIDE_BOUNDS, SR_WIDE_BOUNDS.replace(
            "(kSrThreads)", "(kSrThreads, 8)"))],
    },
    "gather_rows": {
        "built": [],
        "unstaged": [("constexpr int kGnStageBytes = 64 * 1024;",
                      "constexpr int kGnStageBytes = 0;")],
        "threads256": [(GN_THREADS, GN_THREADS.replace("512", "256"))],
        "per_sm4": [(GN_PER_SM, GN_PER_SM.replace("2", "4"))],
    },
}
# where a narrow scatter is forced beside the built routes: out[b] up to
# the shared memory a block can take
SMEM_BLOCK = 232448


def _bytes_ms(nbytes: float) -> float:
    return 1e3 * nbytes / 3.35e12


def _new_source(src: str, name: str) -> str:
    """This tree's ``csrc/<src>.cu`` with variant ``name``'s edits (flush:
    the cluster's sum replaced by ``SR_FLUSH`` first)."""
    text = (_build.CSRC / f"{src}.cu").read_text()
    if (src, name) == ("scatter_rows", "flush"):
        a, b = text.index(SR_REDUCE[0]), text.index(SR_REDUCE[1])
        text = text[:a] + SR_FLUSH + text[b:]
    return edited(text, NEW_VARIANTS[src][name])


def _sass_counts(lib: Path) -> Dict[str, Dict[str, int]]:
    """Atomic and reduction instructions of each kernel in ``lib``, from
    ``cuobjdump -sass`` (empty where the tool is missing)."""
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    try:
        text = subprocess.run([str(tool), "-sass", str(lib)],
                              capture_output=True, text=True,
                              timeout=120).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    counts: Dict[str, Dict[str, int]] = {}
    fn = None
    for ln in text.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[1].strip()
            counts[fn] = {}
        elif fn:
            for key in re.findall(r"\b((?:RED|ATOM)\w*\.[\w.]+)", ln):
                counts[fn][key] = counts[fn].get(key, 0) + 1
    return counts


def run_rows(parent: Optional[Path]) -> None:
    """The parents' split (with ``--parent``) and this tree's variants of
    the row scatter-add and the row gather at every path shape."""
    from pointcloudlib_tpu_torch.ops.kernels import gather as kga

    sources = {}
    if parent:
        for src, split in PARENT_SPLIT.items():
            text = (parent / f"{src}.cu").read_text()
            sources[f"{src}_parent"] = (text, parent)
            for name, edits in split.items():
                sources[f"{src}_parent_{name}"] = (edited(text, edits),
                                                   parent)
    for src, variants in NEW_VARIANTS.items():
        for name in variants:
            sources[f"{src}_{name}"] = (_new_source(src, name), _build.CSRC)
    libs = build(sources)
    for name, lib in libs.items():
        fn = getattr(lib, name.split("_rows")[0] + "_rows_launch")
        fn.argtypes = PARENT_ROWS_ARGS if "_parent" in name else ROWS_ARGS
        fn.restype = ctypes.c_int
    for name in ("scatter_rows_built", "scatter_rows_flush",
                 "gather_rows_built"):
        print(json.dumps({"sass": name,
                          "ops": _sass_counts(OUT / f"{name}.so")}),
              flush=True)
    g = torch.Generator(device=DEV).manual_seed(0)

    for case, b, rows, n, c in SCATTER_PATHS:
        gr = torch.randn((b, rows, c), generator=g, device=DEV)
        idx = torch.randint(0, n, (b, rows), generator=g, device=DEV,
                            dtype=torch.int32)
        out = torch.zeros((b, n, c), device=DEV)
        want = kga.scatter_rows_plain(gr, idx, n)
        route = kga.scatter_route(n, c)
        rec: Dict[str, list] = {}

        def launch(key, narrow=None):
            lib = libs[f"scatter_rows_{key}"]
            if "_parent" in key or key.startswith("parent"):
                return lambda: lib.scatter_rows_launch(
                    _ptr(gr), _ptr(idx), _ptr(out), b, rows, n, c,
                    _stream())
            return lambda: lib.scatter_rows_launch(
                _ptr(gr), _ptr(idx), _ptr(out), b, rows, n, c, int(narrow),
                _stream())

        def timed(label, key, narrow=None, zero=True, check=True):
            call = launch(key, narrow)
            # a route that writes every element starts from NaN
            out.fill_(0.0 if zero else float("nan"))
            if call() != 0:
                raise RuntimeError(f"scatter {case} {label}: launch error")
            torch.cuda.synchronize()
            dev = ((out - want).abs().max() / want.abs().max()).item()
            ms = graph_ms((lambda: (out.zero_(), call())) if zero else call,
                          20)
            rec[label] = [round(ms, 5), float(f"{dev:.2e}") if check
                          else None]

        if parent:
            timed("parent", "parent")
            rec["parent_kernel"] = [round(graph_ms(launch("parent"), 20), 5)]
            rec["memset"] = [round(graph_ms(lambda: out.zero_(), 20), 5)]
            for name in PARENT_SPLIT["scatter_rows"]:
                rec[f"parent_{name}"] = [round(graph_ms(
                    launch(f"parent_{name}"), 20), 5)]
        fits = 4 * n * c <= SMEM_BLOCK
        for name in NEW_VARIANTS["scatter_rows"]:
            narrow = route == "narrow" or name == "flush"
            if name == "flush" and not fits:
                continue
            timed(name, name, narrow, zero=not narrow or name == "flush")
        if route == "wide" and fits:
            timed("built_narrow", "built", True, zero=False)
        if route == "narrow":
            timed("built_wide", "built", False)
        target = (idx.long() + n * torch.arange(b, device=DEV)[:, None])
        acc = torch.zeros((b * n, c), device=DEV)
        flat_g, flat_t = gr.reshape(-1, c), target.reshape(-1)
        rec["index_add"] = [round(graph_ms(
            lambda: acc.zero_().index_add_(0, flat_t, flat_g), 20), 5)]
        print(json.dumps({
            "scatter": case, "B": b, "rows": rows, "n": n, "C": c,
            "route": route,
            "bound_ms": _bytes_ms(4.0 * b * rows * (c + 1) + 4.0 * b * n * c),
            "ms_dev": rec}), flush=True)
        del gr, out, acc
        torch.cuda.empty_cache()

    lib = libs["scatter_rows_built"].scatter_rows_launch
    for case, b, rows, n, c in SCATTER_CUTOFF:
        gr = torch.randn((b, rows, c), generator=g, device=DEV)
        idx = torch.randint(0, n, (b, rows), generator=g, device=DEV,
                            dtype=torch.int32)
        out = torch.empty((b, n, c), device=DEV)
        want = kga.scatter_rows_plain(gr, idx, n)
        rec = {}
        for route, narrow in (("narrow", 1), ("wide", 0)):
            def call(narrow=narrow):
                return lib(_ptr(gr), _ptr(idx), _ptr(out), b, rows, n, c,
                           narrow, _stream())

            out.fill_(float("nan") if narrow else 0.0)
            if call() != 0:
                raise RuntimeError(f"scatter {case} {route}: launch error")
            torch.cuda.synchronize()
            dev = ((out - want).abs().max() / want.abs().max()).item()
            ms = graph_ms(call if narrow else lambda: (out.zero_(), call()),
                          20)
            rec[route] = [round(ms, 5), float(f"{dev:.2e}")]
        print(json.dumps({"scatter cut-off": case,
                          "out_b_KB": 4 * n * c / 1024,
                          "route": kga.scatter_route(n, c), "ms_dev": rec}),
              flush=True)

    for case, b, rows, n, c in GATHER_PATHS:
        pts = torch.randn((b, n, c), generator=g, device=DEV)
        idx = torch.randint(0, n, (b, rows), generator=g, device=DEV,
                            dtype=torch.int32)
        idx.view(-1)[::97] = n
        out = torch.empty((b, rows, c), device=DEV)
        want = kga.gather_neighbors_plain(pts, idx)
        route = kga.gather_route(pts)
        rec = {}

        def launch(key):
            lib = libs[f"gather_rows_{key}"]
            if key.startswith("parent"):
                return lambda: lib.gather_rows_launch(
                    _ptr(pts), _ptr(idx), _ptr(out), b, rows, n, c,
                    _stream())
            return lambda: lib.gather_rows_launch(
                _ptr(pts), _ptr(idx), _ptr(out), b, rows, n, c,
                int(route == "narrow"), _stream())

        for key in ((["parent"] + [f"parent_{k}" for k in
                                   PARENT_SPLIT["gather_rows"]])
                    if parent else []) + list(NEW_VARIANTS["gather_rows"]):
            call = launch(key)
            out.fill_(float("nan"))
            if call() != 0:
                raise RuntimeError(f"gather {case} {key}: launch error")
            torch.cuda.synchronize()
            rec[key] = [round(graph_ms(call, 20), 5),
                        torch.equal(out, want)]
        # torch.gather takes no sentinel: the same rows with them clamped
        flat = idx.clamp(0, n - 1).long()[..., None].expand(-1, -1, c)
        rec["torch.gather"] = [round(graph_ms(
            lambda: torch.gather(pts, 1, flat), 20), 5)]
        print(json.dumps({
            "gather": case, "B": b, "rows": rows, "n": n, "C": c,
            "route": route,
            "bound_ms": _bytes_ms(4.0 * b * rows * (c + 1) + 4.0 * b * n * c),
            "ms_identical": rec}), flush=True)
        del pts, out
        torch.cuda.empty_cache()


# The standalone kNN (csrc/knn.cu) at the shapes of DGCNN's route at N %
# 128 != 0 and PointConv's, and the two-layer EdgeConv's backward pass 1
# (csrc/edge2_bwd_p1.cu) at DGCNN part segmentation's. The parents' split
# (--parent; a part's output is wrong by design). kNN, by edits of its
# selection knn_block in edge_knn.cuh, pasted in place of the include:
# products_only (no walk), walk_only (no loads, no products: a hashed d2
# that keeps the walk's insertions those of a random order), loads_only
# (the tile loads, the norms, the barriers and the d2 tile's stores) and
# counted (the built kernel with counters: a warp's walk steps, the steps
# in which any lane inserts, and the lanes' insertions). Pass 1:
# rows_only (no mats kernel), tie_split_only (the rows kernel's first
# walk alone), rows_no_stores (the rows kernel without the scratch
# stores) and mats_only (the mats kernel over an unwritten scratch).
KNN_HEADER = '#include "edge_knn.cuh"'
KNN_WALK = """    const float* row = d2s + wq * kKnnD2;
#pragma unroll 4
    for (int i = 0; i < kKnnT / kKnnWalkers; ++i) {
      const int j = kKnnWalkers * i + ws;
      const float d = row[j];
      if (d < ld[KP - 1]) list_insert(ld, li, d, t0 + j);
    }
"""
KNN_PRODUCT = ("    float acc[4][4];\n",
               "    __syncthreads();  // q2s and p2s are written\n")
KNN_HASH = """    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s)
        acc[r][s] = -(float)((((unsigned)(q0 + qi + 16 * r) * 2654435761u) ^
                              ((unsigned)(t0 + cj + 16 * s) * 40503u)) >> 12);
"""
KNN_ZERO = """    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) acc[r][s] = 0.0f;
"""
KNN_COUNTERS = """namespace pcl {
__device__ unsigned long long walk_counts[3];
}
"""
KNN_READ_COUNTS = """
extern "C" int knn_counts(void* host, int reset) {
  if (reset) {
    const unsigned long long zero[3] = {0, 0, 0};
    return cudaMemcpyToSymbol(pcl::walk_counts, zero, sizeof(zero));
  }
  return cudaMemcpyFromSymbol(host, pcl::walk_counts,
                              3 * sizeof(unsigned long long));
}
"""
PARENT_KNN_SPLIT = {
    "products_only": [(KNN_WALK, "")],
    "walk_only": [("    load_tile(xb, n, cin, t0, xs);\n", ""),
                  (KNN_PRODUCT, KNN_HASH)],
    "loads_only": [(KNN_WALK, ""), (KNN_PRODUCT, KNN_ZERO)],
    "counted": [
        ("  for (int t0 = 0; t0 < n; t0 += kKnnT) {\n",
         "  unsigned long long n_steps = 0, n_busy = 0, n_ins = 0;\n"
         "  for (int t0 = 0; t0 < n; t0 += kKnnT) {\n"),
        ("      if (d < ld[KP - 1]) list_insert(ld, li, d, t0 + j);\n",
         "      const bool ins = d < ld[KP - 1];\n"
         "      const unsigned any = __ballot_sync(0xffffffffu, ins);\n"
         "      n_steps += 1;\n"
         "      n_busy += any != 0u;\n"
         "      n_ins += __popc(any);\n"
         "      if (ins) list_insert(ld, li, d, t0 + j);\n"),
        ("  // merge the four walkers' lists of a query",
         "  if ((threadIdx.x & 31) == 0) {\n"
         "    atomicAdd(&walk_counts[0], n_steps);\n"
         "    atomicAdd(&walk_counts[1], n_busy);\n"
         "    atomicAdd(&walk_counts[2], n_ins);\n"
         "  }\n"
         "  // merge the four walkers' lists of a query")],
}
E2_MATS = ("  return launch_mats<3 * C1, 2 * C2>(a.left, a.right, a.mats,\n"
           "                                     a.centers * a.k, stream);\n")
E2_SECOND = ("    for (int kk = 0; kk < k; ++kk) {\n      __syncthreads();\n"
             "      // the y1 tile, and this slot's rows of left\n")
E2_LEFT_STORES = """          __nv_bfloat16* lg = a.left + row * (3 * C1) + cc;
          *reinterpret_cast<uint32_t*>(lg) = v;
          *reinterpret_cast<uint32_t*>(lg + C1) = pack2(m[0], m[1]);
          *reinterpret_cast<uint32_t*>(lg + 2 * C1) = pack2(x[0], x[1]);
"""
E2_RIGHT_STORES = """        *reinterpret_cast<uint4*>(rp) = pack8(dz[i]);
        *reinterpret_cast<uint4*>(rp + C2) = pack8(x);
"""
PARENT_E2_SPLIT = {
    "rows_only": [(E2_MATS, "  return cudaSuccess;\n")],
    "tie_split_only": [(E2_MATS, "  return cudaSuccess;\n"),
                       (E2_SECOND, E2_SECOND.replace("kk < k;", "kk < 0;"))],
    "rows_no_stores": [(E2_MATS, "  return cudaSuccess;\n"),
                       (E2_LEFT_STORES, ""), (E2_RIGHT_STORES, "")],
    "mats_only": [("  kernel<<<blocks, kThreads, smem, stream>>>(a);\n", "")],
}
# this tree's design variants: knn (edits of knn.cu, edits of
# edge_knn.cuh) and pass 1 (edits of edge2_bwd_p1.cu). kNN, the select
# route's split: its products and norms alone, the filter and the merges
# left out (no_select; the d2 kept alive by a sink).
KNN_SEL_CALL = """#pragma unroll
    for (int r = 0; r < QPT; ++r)
      group_select<E>(dv[r], ld[r], lj[r], tau[r], t0, n - t0, cg, gbase,
                      ksrc, ke);
"""
KNN_SEL_LOOP = "  float q2[QPT];\n  for (int t = 0; t < tiles; ++t) {\n"
KNN_SEL_OUT = ("#pragma unroll\n  for (int r = 0; r < QPT; ++r) {\n"
               "    const int q = qg + 32 * r;\n    if (q >= nq) continue;\n")
KNN_VARIANTS: Dict[str, tuple] = {
    "no_select": ([
        (KNN_SEL_LOOP, KNN_SEL_LOOP.replace("q2[QPT];",
                                            "q2[QPT], sink = INFINITY;")),
        (KNN_SEL_CALL, "#pragma unroll\n    for (int r = 0; r < QPT; ++r)\n"
                       "#pragma unroll\n      for (int s = 0; s < kSelCand; "
                       "++s) sink = fminf(sink, dv[r][s]);\n"),
        (KNN_SEL_OUT, "  if (sink == 1.2345f) d2[0] = sink;\n" + KNN_SEL_OUT),
    ], ()),
}
E2_MATS_LAUNCH = """      wg::issue<WL, 1, 1, kRows / 16>(macc, wg::mn_major(rt, WR, 0, 64 * g),
                                      wg::mn_major(lt, WL, 0, 0));
      wg::commit();
"""
# pass 1: without the mats product (no_mats); with each step's mats
# product waited for at once (mats_waited), not left in flight behind the
# next step's staging
E2_VARIANTS: Dict[str, list] = {
    "no_mats": [(E2_MATS_LAUNCH, "")],
    "mats_waited": [(E2_MATS_LAUNCH, E2_MATS_LAUNCH.replace(
        "wg::commit();", "wg::commit_wait();"))],
}
PARENT_KNN_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
KNN_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
PARENT_E2_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong]
                  + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
E2_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 3
           + [ctypes.c_float, ctypes.c_void_p])


def _segment_edits(text: str, edits):
    """``edits`` with each ``(start, end)`` pair of markers turned into
    the text from ``start`` up to ``end``."""
    out = []
    for old, new in edits:
        if isinstance(old, tuple):
            a = text.index(old[0])
            old = text[a:text.index(old[1], a)]
        out.append((old, new))
    return out


def knn_source(csrc: Path, edits=(), header_edits=()) -> str:
    """``csrc/knn.cu`` with its edits; edits of its selection
    (``edge_knn.cuh``) are made in a copy pasted in place of the include,
    behind the walk counters of the ``counted`` variant."""
    text = (csrc / "knn.cu").read_text()
    if header_edits:
        head = (csrc / "edge_knn.cuh").read_text()
        head = edited(head, _segment_edits(head, header_edits))
        text = edited(text, [(KNN_HEADER, '#include "fused_sa_common.cuh"\n'
                              + KNN_COUNTERS + head)]) + KNN_READ_COUNTS
    return edited(text, _segment_edits(text, edits))


def _dgcnn_on_card():
    from pointcloudlib_tpu_torch.models import get_cls_model
    from pointcloudlib_tpu_torch.utils.interop import (
        from_jax_variables, random_jax_variables)

    model = get_cls_model("dgcnn")
    from_jax_variables(model, random_jax_variables(get_cls_model("dgcnn"),
                                                   seed=0))
    return model.to(DEV).eval()


def knn_cases():
    """``(case, query, points, k, (d2, idx))``: the self-kNN inputs of
    DGCNN's four EdgeConvs on the route of N % 128 != 0 (B=32, k=20), from
    the model's own eval chain with seeded weights, at N=10,000 (serving)
    and at N=1,000 (training's shape), with the plain version's result."""
    from pointcloudlib_tpu_torch.ops.kernels import fused_edge as kfe

    model = _dgcnn_on_card()
    for n in (10000, 1000):
        x = torch.from_numpy(SyntheticModelNet(
            n_points=n, size=32, seed=0).batch(0, 32)[0]).to(DEV)
        with torch.no_grad():
            for i, ec in enumerate(model.edge):
                f = ec.fused
                want = _plain_by_clouds(x, f.k)
                yield f"EC{i + 1} N={n}", x, x, f.k, want
                q, off = f.prepare(x)
                x = kfe.fused_edge_eval(q, off, want[1], f.bn_scale, f.bn_bias,
                                        kfe.EdgeStats(f.mean, f.var))


def _plain_by_clouds(x, k):
    """The plain self-kNN's ``(d2, idx)`` of a batch, a cloud at a
    time."""
    found = [geometry.knn_plain(x[i:i + 1], x[i:i + 1], k)
             for i in range(x.shape[0])]
    return (torch.cat([f[0] for f in found]),
            torch.cat([f[1] for f in found]))


def _ms(fn, big: bool) -> float:
    """Device ms a call: CUDA graphs for short calls, events over three
    calls after one for calls of milliseconds."""
    if not big:
        return graph_ms(fn, 10)
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 3


def run_knn(parent: Optional[Path]) -> None:
    """The parents' split and this tree's kNN variants at each shape of
    :func:`knn_cases`: device ms, idx and d2 bit-identical to the plain
    version, and the counted variant's walk counts."""
    sources = {"knn_built": (knn_source(_build.CSRC), _build.CSRC)}
    for name, (edits, head) in KNN_VARIANTS.items():
        sources[f"knn_{name}"] = (knn_source(_build.CSRC, edits, head),
                                  _build.CSRC)
    if parent:
        sources["knn_parent"] = (knn_source(parent), parent)
        for name, head in PARENT_KNN_SPLIT.items():
            sources[f"knn_parent_{name}"] = (knn_source(parent, (), head),
                                             parent)
    libs = build(sources)
    # the launchers that take a route (this tree's), by their text: each
    # of their select routes (and the built one's block route) is timed
    routed = {name for name, (text, _) in sources.items()
              if "int route" in text}
    for name, lib in libs.items():
        lib.knn_launch.argtypes = (KNN_ARGS if name in routed
                                   else PARENT_KNN_ARGS)
        lib.knn_launch.restype = ctypes.c_int
    runs = []
    for name, lib in libs.items():
        if name not in routed:
            runs.append((name[4:], lib, None))
            continue
        for route in ([0] if name == "knn_built" else []) + list(kknn.SELECT):
            runs.append((f"{name[4:]} {kknn.route_name(route)}", lib, route))
    for case, query, points, k, (want_d2, want_idx) in knn_cases():
        b, m, c = query.shape
        n = points.shape[1]
        d2 = torch.empty((b, m, k), device=DEV)
        idx = torch.empty((b, m, k), dtype=torch.int32, device=DEV)
        norms = torch.empty(b * n, device=DEV)
        rec: Dict[str, list] = {}
        for label, lib, route in runs:
            def call(lib=lib, route=route):
                if route is None:  # the parents' launcher
                    return lib.knn_launch(_ptr(query), _ptr(points),
                                          _ptr(d2), _ptr(idx), b, m, n, c, k,
                                          _stream())
                return lib.knn_launch(_ptr(query), _ptr(points), _ptr(d2),
                                      _ptr(idx), _ptr(norms), b, m, n, c, k,
                                      route, _stream())

            if "counted" in label:
                counts = (ctypes.c_ulonglong * 3)()
                lib.knn_counts(counts, 1)
            idx.fill_(-1)
            err = call()
            if err != 0:  # a select instance whose shared memory does not fit
                rec[label] = f"launch error {err}"
                continue
            torch.cuda.synchronize()
            same = torch.equal(idx, want_idx) and torch.equal(d2, want_d2)
            if "counted" in label:
                lib.knn_counts(counts, 0)
                steps, busy, ins = counts
                rec[label] = {"warp_steps": steps, "busy_share": busy / steps,
                              "insertions_a_query": ins / (b * m)}
                continue
            rec[label] = [round(_ms(call, n * c > 200000), 4), same]
        ops = b * m * n * (2.0 * c + 3.0)
        print(json.dumps({
            "knn": case, "B": b, "M": m, "N": n, "C": c, "k": k,
            "fma_bound_ms": 1e3 * ops / 67e12,
            "plain_order_floor_ms": 2e3 * ops / 67e12,
            "ms_identical": rec}), flush=True)
        del d2, idx
        torch.cuda.empty_cache()


def edge2p1_cases():
    """``(case, h1, dout, st, w2)``: pass 1's inputs at DGCNN part
    segmentation's shapes (k=40, C1 = C2 = 64; random values, seeded:
    its work depends on the data only through max-pool ties), B=16 at
    N=2,048 and on the kNN route at N=1,000."""
    g = torch.Generator(device=DEV).manual_seed(0)
    for case, b, n in (("pair N=2048", 16, 2048), ("pair N=1000", 16, 1000)):
        h1 = torch.randn((b, n, 40, 64), generator=g,
                         device=DEV).bfloat16()
        dout = torch.randn((b, n, 64), generator=g, device=DEV)
        st = torch.stack([1.0 + 0.1 * torch.randn(64, generator=g,
                                                  device=DEV)
                          if i % 4 in (0, 2) else
                          0.1 * torch.randn(64, generator=g, device=DEV)
                          for i in range(8)])
        w2 = (0.15 * torch.randn((64, 64), generator=g,
                                 device=DEV)).bfloat16()
        yield case, h1, dout, st, w2


def run_edge2p1(parent: Optional[Path]) -> None:
    """The parents' split and this tree's pass-1 variants at each shape of
    :func:`edge2p1_cases`: device ms with the wrapper's memsets, and the
    largest deviation of ps2, vecs and mats over max|plain|."""
    from pointcloudlib_tpu_torch.ops.kernels import fused_edge as kfe

    sources = {"e2_built": ((_build.CSRC / "edge2_bwd_p1.cu").read_text(),
                            _build.CSRC)}
    for name, edits in E2_VARIANTS.items():
        sources[f"e2_{name}"] = (edited((_build.CSRC / "edge2_bwd_p1.cu")
                                        .read_text(), edits), _build.CSRC)
    if parent:
        text = (parent / "edge2_bwd_p1.cu").read_text()
        sources["e2_parent"] = (text, parent)
        for name, edits in PARENT_E2_SPLIT.items():
            sources[f"e2_parent_{name}"] = (edited(text, edits), parent)
    libs = build(sources)
    # the launchers that take the scratch (the parents') by their text
    with_scratch = {name for name, (text, _) in sources.items()
                    if "void* left" in text}
    for name, lib in libs.items():
        fn = lib.edge2_bwd_p1_launch
        fn.argtypes = PARENT_E2_ARGS if name in with_scratch else E2_ARGS
        fn.restype = ctypes.c_int
    for case, h1, dout, st, w2 in edge2p1_cases():
        b, m, k, c1 = h1.shape
        c2 = w2.shape[1]
        want = kfe.edge2_p1_plain(h1, dout, st[:4], st[4:], w2)
        ps2 = torch.zeros((2, c2), device=DEV)
        vecs = torch.zeros(3 * c1, device=DEV)
        mats = torch.zeros((3 * c1, 2 * c2), device=DEV)
        rows = b * m * k
        stf = st.reshape(-1).contiguous()
        scratch = None
        rec: Dict[str, list] = {}
        for name, lib in libs.items():
            if name in with_scratch and scratch is None:
                scratch = (torch.empty((rows, 3 * c1), dtype=torch.bfloat16,
                                       device=DEV),
                           torch.empty((rows, 2 * c2), dtype=torch.bfloat16,
                                       device=DEV))

            def call(lib=lib, name=name):
                ps2.zero_()
                vecs.zero_()
                mats.zero_()
                extra = ([_ptr(scratch[0]), _ptr(scratch[1])]
                         if name in with_scratch else [])
                return lib.edge2_bwd_p1_launch(
                    _ptr(h1), _ptr(dout), _ptr(stf), _ptr(w2), _ptr(ps2),
                    _ptr(vecs), *extra, _ptr(mats), b * m, k, c1, c2,
                    ctypes.c_float(0.2), _stream())

            if call() != 0:
                raise RuntimeError(f"{name} {case}: launch error")
            torch.cuda.synchronize()
            dev = max(((x - y).abs().max() / y.abs().max()).item()
                      for x, y in zip((ps2, vecs, mats), want))
            rec[name[3:]] = [round(graph_ms(call, 5), 4),
                             float(f"{dev:.2e}")]
        print(json.dumps({
            "edge2_p1": case, "B": b, "M": m, "k": k, "C1": c1, "C2": c2,
            "bf16_bound_ms": 1e3 * 2.0 * rows * (c1 * c2 + 6 * c1 * c2)
            / 989e12, "ms_dev": rec}), flush=True)
        del scratch, h1
        torch.cuda.empty_cache()


# Forward pass 1 with the kNN inside (csrc/edge_knn_f1.cu) at its seven
# launches of the DGCNN paths, and the two-layer EdgeConv's backward pass
# 2 (csrc/edge2_bwd_p2.cu) at DGCNN part segmentation's. The parents'
# split (--parent; a part's output is wrong by design). Pass 1:
# select_only (no h write), write_only (the neighbour list given: the
# idx buffer holds the plain version's and is read back in place of the
# selection) and loads_only (the selection's tile loads, norms, barriers
# and d2 stores, and no h write). Pass 2: tie_only (the first walk, the
# max and tie count, alone), no_products (the chain of both walks and
# dh2 . W2^T replaced by copies of their inputs), no_scatter (without dq's
# reductions) and scatter_only (dh1 from the h1 rows and dq's reductions:
# no chain, no tie walk).
F1_SELECT = "  const int* nbr = knn_block<KP>(xb, n, xb, n, cin, q0, k, sm);\n"
F1_GIVEN = ("  load_nbr(idx + (size_t)b * n * k, q0, min(kKnnQ, n - q0), k,\n"
            "           reinterpret_cast<int*>(sm));\n"
            "  const int* nbr = reinterpret_cast<const int*>(sm);\n")
F1_WRITE = ("  edge_f1_rows(nbr, q + cb, off + cb, h + cb * k, red, c, k, q0, "
            "nq);\n")
PARENT_F1_SPLIT = {
    "select_only": ([(F1_WRITE, "")], ()),
    "write_only": ([(F1_SELECT, F1_GIVEN)], ()),
    "loads_only": ([(F1_WRITE, "")], [(KNN_WALK, ""),
                                      (KNN_PRODUCT, KNN_ZERO)]),
}
E2_HEADER = '#include "edge2.cuh"'
P2_SECOND = ("    for (int kk = 0; kk < k; ++kk) {\n      __syncthreads();\n"
             "      load_y1_slot(s, a.h1, c0, nc, k, kk, slope);\n")


def _copy_product(dst: str, src: str, rpt: str, width: str, rg: str,
                  cg: str) -> str:
    return (f"#pragma unroll\n  for (int i = 0; i < {rpt}; ++i)\n"
            f"#pragma unroll\n    for (int c = 0; c < 8; ++c)\n"
            f"      {dst}[i][c] = __bfloat162float({src}[({rg} * {rpt} + i) * "
            f"({width}) + {cg} * 8 + c]);\n")


P2_CHAIN = "        product<C1, C2>(s.ys, s.w2, rg, cg, h);\n"
P2_BACK = "      product<C2, C1>(s.ds, s.wt2, rg1, cg1, dy);\n"
P2_HEAD_CHAIN = "  product<C1, C2>(s.ys, s.w2, rg, cg, z);\n"
P2_SCATTER = """        atomicAdd(reinterpret_cast<float4*>(dst),
                  make_float4(d[0], d[1], d[2], d[3]));
        atomicAdd(reinterpret_cast<float4*>(dst + 4),
                  make_float4(d[4], d[5], d[6], d[7]));
"""
PARENT_P2_SPLIT = {
    "tie_only": ([(P2_SECOND, P2_SECOND.replace("kk < k;", "kk < 0;"))],
                 ()),
    "no_products": (
        [(P2_CHAIN, _copy_product("h", "s.ys", "T2::RPT", "C1 + 8", "rg",
                                  "cg")),
         (P2_BACK, _copy_product("dy", "s.ds", "T1::RPT", "C2 + 8", "rg1",
                                 "cg1"))],
        [(P2_HEAD_CHAIN, _copy_product("z", "s.ys", "Tile<C2>::RPT",
                                       "C1 + 8", "rg", "cg"))]),
    "no_scatter": ([(P2_SCATTER, "")], ()),
    "scatter_only": (
        [("    tie_split(s, a.h1, a.dout, c0, nc, k, slope, rg, cg, mx, g);\n",
          ""),
         (("      load_y1_slot(s, a.h1, c0, nc, k, kk, slope);\n"
           "      __syncthreads();\n      // layer 2", "      // layer 1:"),
          ""),
         ("      float dy[T1::RPT][8];\n" + P2_BACK,
          "      float dy[T1::RPT][8] = {};\n")], ()),
}


def _with_header(csrc: Path, source: str, header: str, edits,
                 header_edits) -> str:
    """``csrc/<source>`` with its edits; edits of ``header`` are made in a
    copy pasted in place of its include."""
    text = (csrc / source).read_text()
    if header_edits:
        head = (csrc / header).read_text()
        head = edited(head, _segment_edits(head, header_edits))
        text = edited(text, [(f'#include "{header}"', head)])
    return edited(text, _segment_edits(text, edits))


def _seeded(name: str):
    from pointcloudlib_tpu_torch.tools.grad_check import build_model
    from pointcloudlib_tpu_torch.utils.interop import (
        from_jax_variables, random_jax_variables)

    model = build_model(name)
    from_jax_variables(model, random_jax_variables(build_model(name),
                                                   seed=0))
    return model.to(DEV).eval()


def edgef1_cases():
    """``(case, x, q, off, k)``: pass 1's inputs at its seven launches of
    the main paths, from the models' own train chains with seeded
    weights: DGCNN's four EdgeConvs (B=32, N=1024, k=20) and DGCNN part
    segmentation's two pairs and EC3 (B=16, N=2048, k=40)."""
    from pointcloudlib_tpu_torch.ops.kernels import fused_edge as kfe

    x = torch.from_numpy(SyntheticModelNet(
        n_points=1024, size=32, seed=0).batch(0, 32)[0]).to(DEV)
    model = _seeded("dgcnn")
    with torch.no_grad():
        for i, ec in enumerate(model.edge):
            f = ec.fused
            q, off = f.prepare(x)
            yield f"DGCNN EC{i + 1}", x, q.bfloat16(), off, f.k
            x = kfe.fused_edge_conv_knn(x, q, off, f.bn_scale, f.bn_bias,
                                        f.k)[0]
    del model
    x = torch.from_numpy(SyntheticShapeNetPart(
        n_points=2048, size=16, seed=0).batch(0, 16)[0]).to(DEV)
    model = _seeded("dgcnn_partseg")
    with torch.no_grad():
        for name, layer in (("pair1", model.edge1), ("pair2", model.edge2),
                            ("EC3", model.edge3)):
            q, off = layer.prepare(x)
            yield f"DGCNN-seg {name}", x, q.bfloat16(), off, layer.k
            if name != "EC3":
                x = kfe.fused_edge2_conv_knn(
                    x, q, off, layer.w2, layer.bn1_scale, layer.bn1_bias,
                    layer.bn2_scale, layer.bn2_bias, layer.k)[0]


# this tree's design variants of pass 1 (edits of edge_knn_f1.cu and of
# its selection's header): the select route's split (select_only: no
# write half, idx still written), a ring of two tiles (stages2), one
# block an SM (one_block)
EF1_WRITE = ("  const __nv_bfloat16* qb = q + (size_t)b * n * C;\n",
             "  f1_flush<C>(s, lane, red, psum);\n")
EF1_BOUNDS = ("__global__ void __launch_bounds__(kThreads, 2)\n"
              "    edge_knn_f1_select_kernel")
EF1_VARIANTS: Dict[str, tuple] = {
    "select_only": ([(EF1_WRITE, ""),
                     ("  f1_flush<C>(s, lane, red, psum);\n", "")], ()),
    "stages2": ([("constexpr int kF1Stages = 3;",
                  "constexpr int kF1Stages = 2;")], ()),
    "one_block": ([(EF1_BOUNDS, EF1_BOUNDS.replace("2)", "1)"))], ()),
}
PARENT_F1_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
F1_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def run_edgef1(parent: Optional[Path]) -> None:
    """The parents' split and this tree's pass-1 variants at each shape of
    :func:`edgef1_cases`: device ms with the psum memset (and the new
    kernel's norms launch), idx and h bit-identical to the plain version,
    and psum's deviation over max|plain|; this tree's kernel on every
    route it has that takes the shapes."""
    from pointcloudlib_tpu_torch.ops.kernels import fused_edge as kfe

    sources = {"f1_built": ((_build.CSRC / "edge_knn_f1.cu").read_text(),
                            _build.CSRC)}
    for name, (edits, head) in EF1_VARIANTS.items():
        sources[f"f1_{name}"] = (_with_header(
            _build.CSRC, "edge_knn_f1.cu", "knn_select.cuh", edits, head),
            _build.CSRC)
    if parent:
        sources["f1_parent"] = ((parent / "edge_knn_f1.cu").read_text(),
                                parent)
        for name, (edits, head) in PARENT_F1_SPLIT.items():
            sources[f"f1_parent_{name}"] = (_with_header(
                parent, "edge_knn_f1.cu", "edge_knn.cuh", edits, head),
                parent)
    libs = build(sources)
    routed = {name for name, (text, _) in sources.items()
              if "int route" in text}
    for name, lib in libs.items():
        lib.edge_knn_f1_launch.argtypes = (F1_ARGS if name in routed
                                           else PARENT_F1_ARGS)
        lib.edge_knn_f1_launch.restype = ctypes.c_int
    for case, x, q, off, k in edgef1_cases():
        b, n, cin = x.shape
        c = q.shape[-1]
        widx, wh, wpsum = kfe.edge_knn_f1_plain(x, q, off, k)
        idx = torch.empty_like(widx)
        h = torch.empty_like(wh)
        psum = torch.zeros_like(wpsum)
        norms = torch.empty(b * n, device=DEV)
        runs = []
        for name, lib in libs.items():
            routes = [None]
            if name in routed:
                routes = [r for r in kknn.EDGE_ROUTES
                          if kknn.edge_f1_route_fits(r, n, cin, c, k)]
            runs += [(name[3:] if r is None else
                      f"{name[3:]} {kknn.edge_route_name(r)}", lib, r)
                     for r in routes]
        rec: Dict[str, list] = {}
        for label, lib, route in runs:
            def call(lib=lib, route=route):
                psum.zero_()
                if route is None:  # the parents' launcher
                    return lib.edge_knn_f1_launch(
                        _ptr(x), _ptr(q), _ptr(off), _ptr(idx), _ptr(h),
                        _ptr(psum), b, n, cin, c, k, _stream())
                return lib.edge_knn_f1_launch(
                    _ptr(x), _ptr(q), _ptr(off), _ptr(idx), _ptr(h),
                    _ptr(psum), _ptr(norms), b, n, cin, c, k, route,
                    _stream())

            if "write_only" in label:
                idx.copy_(widx)
            else:
                idx.fill_(-1)
            h.zero_()
            if call() != 0:
                raise RuntimeError(f"{label} {case}: launch error")
            torch.cuda.synchronize()
            same = bool(torch.equal(idx, widx) and torch.equal(
                h.view(torch.int16), wh.view(torch.int16)))
            dev = ((psum - wpsum).abs().max() / wpsum.abs().max()).item()
            rec[label] = [round(graph_ms(call, 10), 4), same,
                          float(f"{dev:.2e}")]
        pairs = float(b * n * n)
        print(json.dumps({
            "edge_knn_f1": case, "B": b, "N": n, "k": k, "C_in": cin, "C": c,
            "fma_bound_ms": 1e3 * pairs * (2.0 * cin + 3.0) / 67e12,
            "h_write_ms": 1e3 * 2.0 * b * n * k * c / 3.35e12,
            "ms_identical_dev": rec}), flush=True)
        del idx, h, widx, wh
        torch.cuda.empty_cache()


def edge2p2_cases():
    """``(case, h1, dout, idx, st1, st2, w2, us2, us1, n)``: pass 2's
    inputs at DGCNN part segmentation's shapes (B=16, k=40, C1 = C2 =
    64), N=2,048 and N=1,000 (the kNN route): the neighbour lists of the
    synthetic part-seg clouds (so dq's reductions meet the path's
    locality), random h1, BN rows and sums (seeded: the work depends on
    the values only through max-pool ties and the kink band)."""
    g = torch.Generator(device=DEV).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, device=DEV)

    for case, b, n in (("pair N=2048", 16, 2048), ("pair N=1000", 16, 1000)):
        x = torch.from_numpy(SyntheticShapeNetPart(
            n_points=n, size=b, seed=0).batch(0, b)[0]).to(DEV)
        idx = kknn.knn(x, x, 40)[1]
        h1 = rnd(b, n, 40, 64).bfloat16()
        st = [torch.stack([1.0 + rnd(64, scale=0.1), rnd(64, scale=0.1),
                           1.0 + rnd(64, scale=0.1), rnd(64, scale=0.1)])
              for _ in range(2)]
        w2 = rnd(64, 64, scale=0.15).bfloat16().float()
        yield (case, h1, rnd(b, n, 64), idx, st[0], st[1], w2,
               rnd(2, 64, scale=0.01), rnd(2, 64, scale=0.01), n)


# this tree's design variants of pass 2 (edits of edge2_bwd_p2.cu and of
# the chain's header): its split (a_only: every step a pass-A step, so
# twice the first walk; no_scatter: without dq's reductions and the
# lanes' trade; no_dy: dy1's product replaced by zeros; no_dh1: dh1 left
# as dy1; no_fences: without the proxy fences, its output unchecked), one
# block an SM (one_block) and h1's copies three steps ahead (ring4)
E2P2_SCATTER = """        if (rq < nc)
          atomicAdd(reinterpret_cast<float4*>(
                        a.dq + (size_t)(dq_rows + jq) * C1 + col),
                    v4);
"""
E2P2_DY = """      wg::product<N1, 0, 0, C2 / 16>(dy, wg::k_major(ds, C2, 0, 0),
                                     wg::k_major(w2s, C2, g * N1, 0));
"""
E2P2_BOUNDS = ("__global__ void __launch_bounds__(kThreads, 2)\n"
               "    edge2_p2_kernel")
E2P2_FENCE = "    wg::fence_to_async();\n"
E2P2_PASS_A = ("    const bool pass_b = cur.pass;",
               "    const bool pass_b = false;")
E2P2_VARIANTS: Dict[str, tuple] = {
    "a_only": ([E2P2_PASS_A], ()),
    "no_scatter": ([(E2P2_SCATTER, "")], ()),
    "no_dy": ([(E2P2_DY, "#pragma unroll\n      for (int v = 0; v < N1 / 2; "
                         "++v) dy[v] = 0.0f;\n")], ()),
    "one_block": ([(E2P2_BOUNDS, E2P2_BOUNDS.replace("2)", "1)"))], ()),
    "ring4": ([("  static constexpr int RING = 3;",
                "  static constexpr int RING = 4;")], ()),
    "no_fences": ([(E2P2_FENCE + "    __syncthreads();  // the y1",
                    "    __syncthreads();  // the y1"),
                   ("  " + E2P2_FENCE + "      __syncthreads();  // the dh2",
                    "      __syncthreads();  // the dh2")], ()),
    "no_dh1": ([("""            dy[v] = bn_bwd(dz, xhat(hj, rs1[ch], mrs1[ch]), sc1[ch], us1[ch],
                           us1[C1 + ch]);
""", "            dy[v] = dz;\n")], ()),
}
PARENT_P2_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong]
                  + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
P2_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong]
           + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])


def run_edge2p2(parent: Optional[Path]) -> None:
    """The parents' split and this tree's pass-2 variants at each shape of
    :func:`edge2p2_cases`: device ms with dq's memset, and the largest
    deviation of dq and doff over max|plain| (a max-pool tie share may
    move: the card tests hold them tie-robust)."""
    from pointcloudlib_tpu_torch.ops.kernels import fused_edge as kfe

    sources = {"p2_built": ((_build.CSRC / "edge2_bwd_p2.cu").read_text(),
                            _build.CSRC)}
    for name, (edits, head) in E2P2_VARIANTS.items():
        sources[f"p2_{name}"] = (_with_header(
            _build.CSRC, "edge2_bwd_p2.cu", "edge2_wgmma.cuh", edits, head),
            _build.CSRC)
    if parent:
        sources["p2_parent"] = ((parent / "edge2_bwd_p2.cu").read_text(),
                                parent)
        for name, (edits, head) in PARENT_P2_SPLIT.items():
            sources[f"p2_parent_{name}"] = (_with_header(
                parent, "edge2_bwd_p2.cu", "edge2.cuh", edits, head), parent)
    libs = build(sources)
    with_wt2 = {name for name, (text, _) in sources.items()
                if "const void* wt2" in text}
    for name, lib in libs.items():
        fn = lib.edge2_bwd_p2_launch
        fn.argtypes = PARENT_P2_ARGS if name in with_wt2 else P2_ARGS
        fn.restype = ctypes.c_int
    for case, h1, dout, idx, st1, st2, w2, us2, us1, n in edge2p2_cases():
        b, m, k, c1 = h1.shape
        c2 = w2.shape[1]
        want = kfe.edge2_p2_plain(h1, dout, idx, st1, st2, w2, us2, us1,
                                  0.2, n)
        dq = torch.zeros((b, n, c1), device=DEV)
        doff = torch.empty((b, m, c1), device=DEV)
        st = torch.cat([st1.reshape(-1), st2.reshape(-1)]).contiguous()
        us = torch.cat([us2.reshape(-1), us1.reshape(-1)]).contiguous()
        w2b = w2.bfloat16().contiguous()
        wt2 = w2.t().bfloat16().contiguous()
        rec: Dict[str, list] = {}
        for name, lib in libs.items():
            def call(lib=lib, name=name):
                dq.zero_()
                extra = [_ptr(wt2)] if name in with_wt2 else []
                return lib.edge2_bwd_p2_launch(
                    _ptr(h1), _ptr(dout), _ptr(idx), _ptr(st), _ptr(us),
                    _ptr(w2b), *extra, _ptr(dq), _ptr(doff), b * m, m, n, k,
                    c1, c2, ctypes.c_float(0.2), _stream())

            if call() != 0:
                raise RuntimeError(f"{name} {case}: launch error")
            torch.cuda.synchronize()
            dev = [float(f"{((x - y).abs().max() / y.abs().max()).item():.2e}")
                   for x, y in zip((dq, doff), want)]
            rec[name[3:]] = [round(graph_ms(call, 5), 4), dev]
        e = float(b * m * k)
        print(json.dumps({
            "edge2_p2": case, "B": b, "M": m, "k": k, "C1": c1, "C2": c2,
            "bf16_bound_ms": 1e3 * 3.0 * 2.0 * e * c1 * c2 / 989e12,
            "bytes_bound_ms": 1e3 * (2.0 * 2.0 * e * c1 + 4.0 * e
                                     + 8.0 * b * n * c1) / 3.35e12,
            "ms_dev": rec}), flush=True)
        del dq, doff, h1, want
        torch.cuda.empty_cache()


def edgeeval_cases():
    """``(case, kind, inputs)``: the eval kernels' inputs at their seven
    launches of the served paths, from the models' own eval chains
    (running statistics, seeded weights): ``edge_knn_eval`` (kind
    ``ev``: x, q, off, st, k) at DGCNN's four EdgeConvs (B=32, N=1024,
    k=20) and part segmentation's EC3, ``edge2_knn_eval`` (kind ``e2``:
    x, q, off, the stacked rows of both layers, bf16 W2, k) at its two
    pairs (B=16, N=2048, k=40)."""
    from pointcloudlib_tpu_torch.ops.kernels import fused_edge as kfe
    from pointcloudlib_tpu_torch.ops.kernels.fused_sa import _stack_stats

    def ev(f, x):
        q, off = f.prepare(x)
        st = _stack_stats(f.mean, f.var, f.bn_scale, f.bn_bias)
        return x, q.bfloat16(), off, st, f.k

    x = torch.from_numpy(SyntheticModelNet(
        n_points=1024, size=32, seed=0).batch(0, 32)[0]).to(DEV)
    model = _seeded("dgcnn")
    with torch.no_grad():
        for i, ec in enumerate(model.edge):
            yield f"DGCNN EC{i + 1}", "ev", ev(ec.fused, x)
            x = ec(x)
    del model
    x = torch.from_numpy(SyntheticShapeNetPart(
        n_points=2048, size=16, seed=0).batch(0, 16)[0]).to(DEV)
    model = _seeded("dgcnn_partseg")
    with torch.no_grad():
        for name, layer in (("pair1", model.edge1), ("pair2", model.edge2)):
            q, off = layer.prepare(x)
            st1, st2 = kfe._folded2(layer.bn1_scale, layer.bn1_bias,
                                    layer.bn2_scale, layer.bn2_bias,
                                    layer.stats())
            yield f"DGCNN-seg {name}", "e2", (
                x, q.bfloat16(), off, kfe._st2(st1, st2),
                layer.w2.bfloat16().contiguous(), layer.k)
            x = layer(x)
        yield "DGCNN-seg EC3", "ev", ev(model.edge3, x)


# The eval kernels with the kNN inside: the parents' split (--parent; a
# part's output is wrong by design). edge_knn_eval: select_only (no
# gather, no out) and rows_only (the gather, BN, LeakyReLU and max alone:
# the plain version's lists read from the buffer passed as x, in place of
# the selection); edge2_knn_eval: select_only (no chain), chain_only (the
# lists given, as rows_only) and loads_only (the lists given and the y1
# gathers, the product replaced by a copy of y1).
EV_SELECT = ("  const int* nbr = knn_block<KP>(xb, n, xb, n, cin, q0, k,\n"
             "                                 reinterpret_cast<float*>"
             "(smem));\n")
EV_GIVEN = ("  load_nbr(reinterpret_cast<const int*>(x) + (size_t)b * n * k, "
            "q0,\n           min(kKnnQ, n - q0), k, reinterpret_cast<int*>"
            "(smem));\n"
            "  const int* nbr = reinterpret_cast<const int*>(smem);\n")
EV_ROWS = ("  edge_eval_rows(nbr, q + cb, off + cb, st, out + cb, c, k, slope,"
           " q0,\n                 min(kKnnQ, n - q0));\n")
E2_GATHER = ("  gather_max(s, nbr, q + cb * C1, off + cb * C1, out + cb * C2, "
             "q0,\n             min(kKnnQ, n - q0), k, slope);\n")
E2_CHAIN = "    chain_z2(s, rg, cg, z);\n"
PARENT_EVAL_SPLIT = {
    "ev": {
        "select_only": ([(EV_ROWS, "")], ()),
        "rows_only": ([(EV_SELECT, EV_GIVEN)], ()),
    },
    "e2": {
        "select_only": ([(E2_GATHER, "")], ()),
        "chain_only": ([(EV_SELECT, EV_GIVEN)], ()),
        "loads_only": ([(EV_SELECT, EV_GIVEN)], [(E2_CHAIN, _copy_product(
            "z", "s.ys", "T2::RPT", "C1 + 8", "rg", "cg"))]),
    },
}
EV_SOURCES = {"ev": ("edge_knn_eval.cu", "edge_knn.cuh"),
              "e2": ("edge2_knn_eval.cu", "edge2.cuh")}
# this tree's variants of the select routes (edits of edge_knn_eval.cu
# and edge2_knn_eval.cu): their split (select_only: the walk and the
# lists alone, no eval half or chain), and the C = 256 instance's walk at
# 128 queries a block and a ring of three tiles, two blocks an SM
# (walk128; 256 queries and two tiles, one block an SM, are built)
EV_WALK = """  static constexpr int QPT = C == 256 ? 8 : 4;
  static constexpr int STAGES = C == 256 ? 2 : 3;
  static constexpr int BLOCKS = C == 256 ? 1 : 2;"""
EVAL_VARIANTS: Dict[str, Dict[str, tuple]] = {
    "ev": {
        "select_only": ([("""  for (int ql = warp; ql < nq; ql += kWarps)
    eval_center<C>(qb, off + (row0 + ql) * C, out + (row0 + ql) * C,
                   nbr + ql * k, k, sc, bi, slope, lane);
""", "")], ()),
        "walk128": ([(EV_WALK, """  static constexpr int QPT = 4;
  static constexpr int STAGES = 3;
  static constexpr int BLOCKS = 2;""")], ()),
    },
    "e2": {
        "select_only": ([("  eval_tiles<Q / kRows, C1, C2>(",
                          "  if (k < 0) eval_tiles<Q / kRows, C1, C2>(")],
                        ()),
    },
}
EV_ARGS = {  # the launchers' arguments, before the routes and after
    ("ev", False): [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_void_p],
    ("ev", True): [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_void_p],
    ("e2", False): [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_void_p],
    ("e2", True): [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p],
}


def run_edgeeval(parent: Optional[Path]) -> None:
    """The parents' split and this tree's eval kernels at each launch of
    :func:`edgeeval_cases`: device ms by CUDA graphs (the select route's
    norms launch included), ``edge_knn_eval``'s out bit-identical to the
    plain version and ``edge2_knn_eval``'s deviation over max|plain|,
    for this tree's kernels on every route that takes the shapes."""
    from pointcloudlib_tpu_torch.ops.kernels import fused_edge as kfe

    sources = {}
    for kind, (src, _) in EV_SOURCES.items():
        sources[f"{kind}_built"] = ((_build.CSRC / src).read_text(),
                                    _build.CSRC)
    for kind, variants in EVAL_VARIANTS.items():
        for name, (edits, head) in variants.items():
            sources[f"{kind}_{name}"] = (_with_header(
                _build.CSRC, EV_SOURCES[kind][0], "knn_select.cuh", edits,
                head), _build.CSRC)
    if parent:
        for kind, split in PARENT_EVAL_SPLIT.items():
            src, header = EV_SOURCES[kind]
            text = (parent / src).read_text()
            sources[f"{kind}_parent"] = (text, parent)
            if "int route" in text:  # the split is of the block route's
                continue             # kernels, before PR 17's select route
            for name, (edits, head) in split.items():
                sources[f"{kind}_parent_{name}"] = (_with_header(
                    parent, src, header, edits, head), parent)
    libs = build(sources)
    kinds = {"ev": "edge_knn_eval_launch", "e2": "edge2_knn_eval_launch"}
    routed = {name for name, (text, _) in sources.items()
              if "int route" in text}
    for name, lib in libs.items():
        fn = getattr(lib, kinds[name[:2]])
        fn.argtypes = EV_ARGS[(name[:2], name in routed)]
        fn.restype = ctypes.c_int
    for case, kind, args in edgeeval_cases():
        x, q = args[0], args[1]
        b, n, cin = x.shape
        c1, k = q.shape[-1], args[-1]
        if kind == "ev":
            c2 = c1
            want = kfe.edge_knn_eval_plain(*args)
        else:
            c2 = args[4].shape[1]
            st1, st2 = args[3][:4 * c1].view(4, c1), args[3][4 * c1:].view(
                4, c2)
            want = kfe.edge2_knn_eval_plain(x, q, args[2], st1, st2,
                                            args[4].float(), k)
        widx = _plain_by_clouds(x, k)[1]
        out = torch.empty_like(want)
        norms = torch.empty(b * n, device=DEV)
        runs = []
        for name, lib in libs.items():
            if name[:2] != kind:
                continue
            routes, layers = [None], 1 if kind == "ev" else 2
            if name in routed:
                routes = [r for r in kknn.EDGE_ROUTES if
                          kknn.edge_eval_route_fits(r, n, cin, c1, k, layers)]
            runs += [(name[3:] if r is None else
                      f"{name[3:]} {kknn.edge_route_name(r, layers)}", lib,
                      r) for r in routes]
        rec: Dict[str, list] = {}
        for label, lib, route in runs:
            given = "rows_only" in label or "chain_only" in label or (
                "loads_only" in label)
            first = widx if given else x
            rest = [_ptr(a) for a in args[1:-1]]

            def call(lib=lib, route=route, first=first, rest=rest):
                fn = getattr(lib, kinds[kind])
                if route is None:  # the parents' launcher
                    return fn(_ptr(first), *rest, _ptr(out), b, n, cin,
                              *((c1,) if kind == "ev" else (c1, c2)), k,
                              ctypes.c_float(0.2), _stream())
                return fn(_ptr(first), *rest, _ptr(out), _ptr(norms), b, n,
                          cin, *((c1,) if kind == "ev" else (c1, c2)), k,
                          route, ctypes.c_float(0.2), _stream())

            out.fill_(float("nan"))
            if call() != 0:
                raise RuntimeError(f"{label} {case}: launch error")
            torch.cuda.synchronize()
            dev = ((out - want).abs().max() / want.abs().max()).item()
            rec[label] = [round(graph_ms(call, 10), 4),
                          bool(torch.equal(out, want)), float(f"{dev:.2e}")]
        print(json.dumps({
            "kernel": kinds[kind][:-7], "case": case, "B": b, "N": n, "k": k,
            "C_in": cin, "C": c1, "ms_identical_dev": rec}), flush=True)
        del out, want, widx
        torch.cuda.empty_cache()


# The two-layer EdgeConv's forward tails (csrc/edge2_tail.cu: stats2 and
# out, one kernel templated on its stage) at DGCNN part segmentation's
# shapes. The parents' split (--parent; a part's output is wrong by
# design): loads_only (h1's loads, BN1 and LeakyReLU into the y1 tile,
# the product replaced by a copy of y1's tile), product_only (the product
# on the y1 tile as it stands, no loads) and flush_only (no slot: W2's
# staging, then stats2's flush or out's store).
T2_LOAD = "      load_y1_slot(s, a.h1, c0, nc, a.k, kk, a.slope);\n"
T2_STATS = "        product<C1, C2>(s.ys, s.w2, rg, cg, h);\n"
T2_OUT = "        chain_z2(s, rg, cg, h);\n"
T2_COPY = _copy_product("h", "s.ys", "T2::RPT", "C1 + 8", "rg", "cg")
PARENT_TAIL2_SPLIT = {
    "loads_only": [(T2_STATS, T2_COPY), (T2_OUT, T2_COPY)],
    "product_only": [(T2_LOAD, "")],
    "flush_only": [("for (int kk = 0; kk < a.k; ++kk) {",
                    "for (int kk = 0; kk < 0; ++kk) {")],
}
# this tree's design variants of the tails (edits of edge2_tail.cu): a
# tile a warpgroup (threads128_b4: m64n64, four blocks an SM; two
# warpgroups of m64n32 and two blocks are built), three blocks an SM
# (blocks3), h1's copies one step ahead (ring2), an L2 prefetch of h1's
# rows 4 steps ahead (prefetch4), and the design's split (no_product: the
# chain left out; no_loads: no copies and no y1 staging, the chain on the
# first y1 tile)
T2_CHAIN = ("    chain_issue<C1, C2, C1, WGS>(h, ys + (s & 1) * kRows * C1, w2s, "
            "g);\n")
T2_THREADS = "constexpr int kT2Threads = 256;"
T2_BLOCKS = "constexpr int kT2Blocks = 2;"
T2_RING = "constexpr int kT2Ring = 3;"
T2_LOAD = "    if (s + kT2Ring < steps) load_raw(ahead, rb);\n"
T2_RB = "  int rb = 0;  // this step's raw tile\n"


def _t2_prefetch(d: int) -> list:
    return [(T2_RB, T2_RB + f"  T2Walk pf = cur;\n  for (int i = 0; i < {d}; "
             "++i) pf.next(k, stride);\n"),
            (T2_LOAD, f"    if (s + {d} < steps && tid < rows(pf))\n"
             '      asm volatile("prefetch.global.L2 [%0];" ::"l"(\n'
             "          a.h1 + ((size_t)(pf.c0 + tid) * k + pf.kk) * C1));\n"
             "    pf.next(k, stride);\n" + T2_LOAD)]


TAIL2_VARIANTS: Dict[str, list] = {
    "threads128_b4": [(T2_THREADS, T2_THREADS.replace("256", "128")),
                      (T2_BLOCKS, T2_BLOCKS.replace("= 2", "= 4"))],
    "blocks3": [(T2_BLOCKS, T2_BLOCKS.replace("= 2", "= 3"))],
    "ring2": [(T2_RING, T2_RING.replace("= 3", "= 2"))],
    "prefetch4": _t2_prefetch(4),
    "no_product": [(T2_CHAIN, "")],
    "no_loads": [(T2_LOAD, ""),
                 ("    if (s + 1 < steps) stage_y1(nxt, rn, ys + ((s + 1) & 1) "
                  "* kRows * C1);\n", "")],
}
# the variants whose stats2 is also timed over h1 read as one center of a
# slot each ("flat": centers B*M*k, k = 1; the same sums, 64 contiguous
# rows a step)
TAIL2_FLAT = ("built", "no_product", "parent")
TAIL2_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
              + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])


def run_tail2(parent: Optional[Path]) -> None:
    """The parents' split and this tree's variants of ``edge2_stats2``
    and ``edge2_out`` at each shape of :func:`edge2p1_cases` (both pairs
    of part segmentation give the tails the same shapes: h1 [B, N, 40,
    64]): device ms by CUDA graphs (stats2 with the wrapper's memset) and
    the largest deviation over max|plain| of the sums and of out."""
    from pointcloudlib_tpu_torch.ops.kernels import fused_edge as kfe

    src = (_build.CSRC / "edge2_tail.cu").read_text()
    sources = {"t2_built": (src, _build.CSRC)}
    for name, edits in TAIL2_VARIANTS.items():
        sources[f"t2_{name}"] = (edited(src, edits), _build.CSRC)
    if parent:
        text = (parent / "edge2_tail.cu").read_text()
        sources["t2_parent"] = (text, parent)
        for name, edits in PARENT_TAIL2_SPLIT.items():
            sources[f"t2_parent_{name}"] = (edited(text, edits), parent)
    libs = build(sources)
    for lib in libs.values():
        for stage in ("stats2", "out"):
            fn = getattr(lib, f"edge2_{stage}_launch")
            fn.argtypes = TAIL2_ARGS
            fn.restype = ctypes.c_int
    for case, h1, _, st, w2 in edge2p1_cases():
        b, m, k, c1 = h1.shape
        c2 = w2.shape[1]
        e = float(b * m * k)
        want = {"stats2": kfe.edge2_stats2_plain(h1, st[:4], w2),
                "out": kfe.edge2_out_plain(h1, st[:4], st[4:], w2)}
        got = {"stats2": torch.zeros((2, c2), device=DEV),
               "out": torch.empty((b, m, c2), device=DEV)}
        stf = st.reshape(-1).contiguous()
        rec: Dict[str, dict] = {}
        for name, lib in libs.items():
            rec[name[3:]] = {}
            for stage in ("stats2", "out"):
                out = got[stage]

                def call(lib=lib, stage=stage, out=out):
                    if stage == "stats2":
                        out.zero_()
                    return getattr(lib, f"edge2_{stage}_launch")(
                        _ptr(h1), _ptr(stf), _ptr(w2), _ptr(out), b * m, k,
                        c1, c2, ctypes.c_float(0.2), _stream())

                if call() != 0:
                    raise RuntimeError(f"{name} {stage} {case}: launch error")
                torch.cuda.synchronize()
                ref = want[stage]
                dev = ((out - ref).abs().max() / ref.abs().max()).item()
                rec[name[3:]][stage] = [round(graph_ms(call, 5), 4),
                                        float(f"{dev:.2e}")]
            if name[3:] in TAIL2_FLAT:
                out = got["stats2"]

                def flat(lib=lib, out=out):
                    out.zero_()
                    return lib.edge2_stats2_launch(
                        _ptr(h1), _ptr(stf), _ptr(w2), _ptr(out), b * m * k,
                        1, c1, c2, ctypes.c_float(0.2), _stream())

                if flat() != 0:
                    raise RuntimeError(f"{name} flat {case}: launch error")
                torch.cuda.synchronize()
                ref = want["stats2"]
                dev = ((out - ref).abs().max() / ref.abs().max()).item()
                rec[name[3:]]["stats2 flat"] = [round(graph_ms(flat, 5), 4),
                                                float(f"{dev:.2e}")]
        hb = 2.0 * e * c1 + 2.0 * c1 * c2 + 32.0 * (c1 + c2)
        print(json.dumps({
            "edge2_tail": case, "B": b, "M": m, "k": k, "C1": c1, "C2": c2,
            "bytes_bound_ms": {"stats2": 1e3 * (hb + 8.0 * c2) / 3.35e12,
                               "out": 1e3 * (hb + 4.0 * b * m * c2)
                               / 3.35e12},
            "bf16_bound_ms": 1e3 * 2.0 * e * c1 * c2 / 989e12,
            "ms_dev": rec}), flush=True)
        del h1, want, got
        torch.cuda.empty_cache()


# The EdgeConv backward (csrc/edge_bwd.cu) at its launches of the main
# paths. The parent's split (--parent; a part's output is wrong by
# design): no_reductions (the two walks, d1, d2 and ps only), dz_only
# (the dz half's reductions alone), xhat_only (the x^ half's alone, no
# count), sparse_dz (the dz quads that are all 0 not reduced; the x^ half
# and the count kept) and sparse_scalar (a scalar reduction for each
# non-zero dz channel in place of the quad's). This tree's variants:
# unroll2 / unroll4 (both walks unrolled by the compiler, their loads in
# flight together).
BWD_DZ = """      atomicAdd(reinterpret_cast<float4*>(sr + c0),
                make_float4(bf_round(dz[0]), bf_round(dz[1]),
                            bf_round(dz[2]), bf_round(dz[3])));
"""
BWD_XH = """      atomicAdd(reinterpret_cast<float4*>(sr + c + c0),
                make_float4(bf_round(xh[0]), bf_round(xh[1]),
                            bf_round(xh[2]), bf_round(xh[3])));
"""
BWD_CNT = "      if (cq == 0) atomicAdd(sr + 2 * c, 1.0f);\n"
BWD_NONZERO = ("      if (dz[0] != 0.0f || dz[1] != 0.0f || dz[2] != 0.0f "
               "|| dz[3] != 0.0f)\n  ")
BWD_SCALAR = """#pragma unroll
      for (int u = 0; u < kQuad; ++u)
        if (dz[u] != 0.0f) atomicAdd(sr + c0 + u, bf_round(dz[u]));
"""
PARENT_BWD_SPLIT = {
    "no_reductions": [(BWD_DZ, ""), (BWD_XH, ""), (BWD_CNT, "")],
    "dz_only": [(BWD_XH, ""), (BWD_CNT, "")],
    "xhat_only": [(BWD_DZ, ""), (BWD_CNT, "")],
    "sparse_dz": [(BWD_DZ, BWD_NONZERO + BWD_DZ.replace("\n  ", "\n    "))],
    "sparse_scalar": [(BWD_DZ, BWD_SCALAR)],
}
BWD_WALK = "    for (int kk = 0; kk < k; ++kk) {\n"
BWD_VARIANTS = {
    "unroll2": [(BWD_WALK, "#pragma unroll 2\n" + BWD_WALK)],
    "unroll4": [(BWD_WALK, "#pragma unroll 4\n" + BWD_WALK)],
}
BWD_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_void_p])


def edgebwd_cases():
    """``(case, h, dout, idx, st)``: ``edge_bwd``'s inputs at its
    launches of the main paths, from the models' own chains (seeded
    weights; each layer's input from the eval forward of the layers
    before it, its h and idx from pass 1, BN rows from h's batch moments,
    a seeded random output gradient): DGCNN's four EdgeConvs at B=32,
    N=1024 (kNN inside) and N=1,000 (the kNN route), k=20, and part
    segmentation's EC3 at B=16, N=2,048 and N=1,000, k=40."""
    from pointcloudlib_tpu_torch.ops.kernels import fused_edge as kfe
    from pointcloudlib_tpu_torch.ops.kernels.fused_sa import _stack_stats

    g = torch.Generator(device=DEV).manual_seed(0)

    def inputs(layer, x):
        q, off = layer.prepare(x)
        b, n, _ = x.shape
        if n % 128:
            idx = kknn.knn(x, x, layer.k)[1]
            h, psum = kfe.edge_f1(q.bfloat16(), off, idx)
        else:
            idx, h, psum = kfe.edge_knn_f1(x, q.bfloat16(), off, layer.k)
        st = _stack_stats(*kft._moments(psum, float(b * n * layer.k)),
                          layer.bn_scale, layer.bn_bias)
        dout = torch.randn((b, n, h.shape[-1]), generator=g, device=DEV)
        return h, dout, idx, st

    model = _seeded("dgcnn")
    with torch.no_grad():
        for n in (1024, 1000):
            x = torch.from_numpy(SyntheticModelNet(
                n_points=n, size=32, seed=0).batch(0, 32)[0]).to(DEV)
            for i, ec in enumerate(model.edge):
                yield (f"DGCNN EC{i + 1} N={n}", *inputs(ec.fused, x))
                x = ec(x)
    del model
    model = _seeded("dgcnn_partseg")
    with torch.no_grad():
        for n in (2048, 1000):
            x = torch.from_numpy(SyntheticShapeNetPart(
                n_points=n, size=16, seed=0).batch(0, 16)[0]).to(DEV)
            x = model.edge2(model.edge1(x))
            yield (f"DGCNN-seg EC3 N={n}", *inputs(model.edge3, x))


def run_edgebwd(parent: Optional[Path]) -> None:
    """The parent's split and this tree's design variants of
    ``edge_bwd`` at each launch of :func:`edgebwd_cases`: device ms by
    CUDA graphs with the wrapper's two memsets (``memsets`` times them
    alone), whether the count column is exact and the largest deviation
    of ps, scat, d1 and d2 over max|plain|, with the bytes bound."""
    from pointcloudlib_tpu_torch.ops.kernels import fused_edge as kfe

    src = (_build.CSRC / "edge_bwd.cu").read_text()
    sources = {"bwd_built": (src, _build.CSRC)}
    for name, edits in BWD_VARIANTS.items():
        sources[f"bwd_{name}"] = (edited(src, edits), _build.CSRC)
    if parent:
        text = (parent / "edge_bwd.cu").read_text()
        sources["bwd_parent"] = (text, parent)
        for name, edits in PARENT_BWD_SPLIT.items():
            sources[f"bwd_parent_{name}"] = (edited(text, edits), parent)
    libs = build(sources)
    for lib in libs.values():
        lib.edge_bwd_launch.argtypes = BWD_ARGS
        lib.edge_bwd_launch.restype = ctypes.c_int
    for case, h, dout, idx, st in edgebwd_cases():
        b, n, k, c = h.shape
        want = kfe.edge_bwd_plain(h, dout, idx, st, 0.2, n)
        ps = torch.empty((2, c), device=DEV)
        scat = torch.empty((b, n, 2 * c + 4), device=DEV)
        d1 = torch.empty((b, n, c), device=DEV)
        d2 = torch.empty((b, n, c), device=DEV)
        rec: Dict[str, list] = {"memsets": [round(graph_ms(
            lambda: (ps.zero_(), scat.zero_()), 10), 4)]}
        for name, lib in libs.items():
            label = name[4:]

            def call(lib=lib):
                ps.zero_()
                scat.zero_()
                return lib.edge_bwd_launch(
                    _ptr(h), _ptr(dout), _ptr(idx), _ptr(st), _ptr(ps),
                    _ptr(scat), _ptr(d1), _ptr(d2), b, n, k, c,
                    ctypes.c_float(0.2), _stream())

            for t in (ps, scat, d1, d2):
                t.fill_(float("nan"))
            if call() != 0:
                raise RuntimeError(f"{label} {case}: launch error")
            torch.cuda.synchronize()
            got = (ps, scat[..., :2 * c + 1], d1, d2)
            counts = bool(torch.equal(got[1][..., 2 * c],
                                      want[1][..., 2 * c]))
            dev = max(((x - w).abs().max() / w.abs().max()).item()
                      for x, w in zip(got, want))
            rec[label] = [round(graph_ms(call, 10), 4), counts,
                          float(f"{dev:.2e}")]
        e = float(b * n * k)
        io = (4.0 * b * n * c + 4.0 * e + 16.0 * c + 8.0 * c
              + 4.0 * b * n * (2 * c + 1) + 8.0 * b * n * c)
        nonzero = _dz_nonzero(h, dout, st, k)
        print(json.dumps({
            "edge_bwd": case, "B": b, "N": n, "k": k, "C": c,
            "bytes_bound_ms": 1e3 * (2.0 * e * c + io) / 3.35e12,
            "nonzero_dz_quads": nonzero, "quads": e * c / 4,
            "ms_counts_dev": rec}), flush=True)
        del h, dout, idx, want, scat
        torch.cuda.empty_cache()


def _dz_nonzero(h, dout, st, k) -> float:
    """Rows and channel quads of the backward whose dz is not all 0: the
    quads the sparse dz half reduces."""
    from pointcloudlib_tpu_torch.ops.kernels import fused_edge as kfe
    from pointcloudlib_tpu_torch.ops.kernels.fused_sa_train import _z

    dz = kfe._maxpool_dz(_z(h.float(), st), dout, 0.2)
    b, n, _, c = dz.shape
    return float((dz.reshape(b, n, k, c // 4, 4) != 0).any(-1).sum())


# The two-layer eval kernel from a given index (csrc/edge2_eval.cu) at
# DGCNN part segmentation's two pairs on the kNN route: this tree's
# kernel and its variant tiles2 (two tiles of 64 centers a block), and
# the parent's kernel (--parent).
E2E_TILES = "constexpr int kE2EvalTiles = 1;"
E2E_VARIANTS = {"tiles2": [(E2E_TILES, E2E_TILES.replace("1;", "2;"))]}
E2E_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_void_p])


def edge2eval_cases():
    """``(case, q, off, idx, st, w2)``: ``edge2_eval``'s inputs at its two
    launches of served part segmentation on the kNN route (16 clouds of
    1,000 points, k=40; the model's eval chain with seeded weights, the
    kNN kernel's index), ``st`` the stacked rows of both layers, ``w2``
    bf16."""
    from pointcloudlib_tpu_torch.ops.kernels import fused_edge as kfe

    model = _seeded("dgcnn_partseg")
    x = torch.from_numpy(SyntheticShapeNetPart(
        n_points=1000, size=16, seed=0).batch(0, 16)[0]).to(DEV)
    with torch.no_grad():
        for name, layer in (("pair1", model.edge1), ("pair2", model.edge2)):
            q, off = layer.prepare(x)
            st1, st2 = kfe._folded2(layer.bn1_scale, layer.bn1_bias,
                                    layer.bn2_scale, layer.bn2_bias,
                                    layer.stats())
            idx = kknn.knn(x, x, layer.k)[1]
            yield (f"DGCNN-seg {name} N=1000", q.bfloat16(), off, idx,
                   kfe._st2(st1, st2), layer.w2.bfloat16().contiguous())
            x = layer(x)


def run_edge2eval(parent: Optional[Path]) -> None:
    """This tree's ``edge2_eval`` and its variants, and
    the parent's, at each launch of :func:`edge2eval_cases`: device ms by
    CUDA graphs and the deviation from the plain version over
    max|plain|, with the bf16 operations bound."""
    from pointcloudlib_tpu_torch.ops.kernels import fused_edge as kfe

    src = (_build.CSRC / "edge2_eval.cu").read_text()
    sources = {"e2e_built": (src, _build.CSRC)}
    for name, edits in E2E_VARIANTS.items():
        sources[f"e2e_{name}"] = (edited(src, edits), _build.CSRC)
    if parent:
        sources["e2e_parent"] = ((parent / "edge2_eval.cu").read_text(),
                                 parent)
    libs = build(sources)
    for name, lib in libs.items():
        lib.edge2_eval_launch.argtypes = E2E_ARGS
        lib.edge2_eval_launch.restype = ctypes.c_int
    for case, q, off, idx, st, w2 in edge2eval_cases():
        b, n, c1 = q.shape
        m, k = idx.shape[1:]
        c2 = w2.shape[1]
        want = kfe.edge2_eval_plain(q, off, idx, st[:4 * c1].view(4, c1),
                                    st[4 * c1:].view(4, c2), w2.float())
        out = torch.empty((b, m, c2), device=DEV)
        rec: Dict[str, list] = {}
        for name, lib in libs.items():
            label = name[4:]

            def call(lib=lib):
                return lib.edge2_eval_launch(
                    _ptr(q), _ptr(idx), _ptr(off), _ptr(st), _ptr(w2),
                    _ptr(out), b, m, n, c1, c2, k, ctypes.c_float(0.2),
                    _stream())

            out.fill_(float("nan"))
            if call() != 0:
                raise RuntimeError(f"{label} {case}: launch error")
            torch.cuda.synchronize()
            dev = ((out - want).abs().max() / want.abs().max()).item()
            rec[label] = [round(graph_ms(call, 10), 4), float(f"{dev:.2e}")]
        e = float(b * m * k)
        print(json.dumps({
            "edge2_eval": case, "B": b, "M": m, "k": k, "C1": c1, "C2": c2,
            "bf16_bound_ms": 1e3 * 2.0 * e * c1 * c2 / 989e12,
            "f32_bound_ms": 1e3 * (4.0 * c1 + 4.0 * c2) * e / 67e12,
            "ms_dev": rec}), flush=True)


# The 3-NN interpolation (csrc/three_interp.cu) at its six launches of
# the main paths. The parent's split (--parent; a part's output is wrong
# by design): stage_only (the support cloud staged, one store a query),
# walk_only (staging and the selection walk, idx and w stored; no output
# rows) and write_only (the output rows alone, idx and w read from a
# copy of the plain version's).
TI_END = "}\n\n}  // namespace pcl"
TI_WALK = ("  const int i = m0 + t;\n", TI_END)
TI_WRITE = ("  // each warp writes its own 32 queries' rows", TI_END)
TI_SETUP = ("  const float* pg = pts + (size_t)b * n * 3;\n",
            "  // each warp writes its own 32 queries' rows")
TI_GIVEN = """  if (m0 + t < m) {
    const size_t row = (size_t)b * m + m0 + t;
    for (int s = 0; s < 3; ++s) {
      s_idx[t][s] = idx[row * 3 + s];
      s_w[t][s] = wout[row * 3 + s];
    }
  }
  __syncthreads();

"""
PARENT_TI_SPLIT = {
    "stage_only": [(TI_WALK, "  if (m0 + t < m)\n    idx[((size_t)b * m + m0 "
                    "+ t) * 3] = __float_as_int(ptss[t % n].w);\n")],
    "walk_only": [(TI_WRITE, "")],
    "write_only": [(TI_SETUP, TI_GIVEN)],
}
# This tree's variants: the output units a thread has in flight
# (unroll2, unroll8) and the launch bounds' blocks an SM (min2, min4).
TI_UNROLL = "constexpr int kTiUnroll = 4;"
TI_MIN_BLOCKS = "constexpr int kTiMinBlocks = 3;"
TI_VARIANTS = {
    "unroll2": [(TI_UNROLL, TI_UNROLL.replace("4", "2"))],
    "unroll8": [(TI_UNROLL, TI_UNROLL.replace("4", "8"))],
    "min2": [(TI_MIN_BLOCKS, TI_MIN_BLOCKS.replace("3", "2"))],
    "min4": [(TI_MIN_BLOCKS, TI_MIN_BLOCKS.replace("3", "4"))],
}
TI_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4


def interp_cases():
    """``(case, query, points, feats)``: ``three_interp``'s inputs at its
    six launches of the main paths, recorded from the models' own eval
    forward with seeded weights: PointNet++ part segmentation's FP2 and
    FP1 and PointConv part segmentation's four decoders (B=16, N=2,048,
    xyz as features)."""
    from pointcloudlib_tpu_torch.ops.kernels import three_interp as kti

    x = torch.from_numpy(SyntheticShapeNetPart(
        n_points=2048, size=16, seed=0).batch(0, 16)[0]).to(DEV)
    onehot = torch.zeros((16, 16), device=DEV)
    for tag, name, inputs in (("PS", "pointnet2_partseg", (x, onehot, x)),
                              ("PC-seg", "pointconv_partseg", (x, onehot))):
        calls, orig = [], kti.three_interp_fwd

        def rec(q, p, f, calls=calls, orig=orig):
            calls.append(tuple(t.detach().float().contiguous()
                               for t in (q, p, f)))
            return orig(q, p, f)

        rec.launches = 0  # the original counts on its module name
        model = _seeded(name)
        kti.three_interp_fwd = rec
        try:
            with torch.no_grad():
                model(*inputs)
        finally:
            kti.three_interp_fwd = orig
        del model
        for q, p, f in calls:
            yield (f"{tag} (M, N, C) = ({q.shape[1]}, {p.shape[1]}, "
                   f"{f.shape[2]})", q, p, f)


def run_interp(parent: Optional[Path]) -> None:
    """This tree's ``three_interp`` at every lane group it has, its
    variants, and the parent's kernel and split, at each launch of
    :func:`interp_cases`: device ms by CUDA graphs, idx bit-identical to
    the plain version, and the larger deviation of w and out over
    max|plain|, with the bytes bound."""
    from pointcloudlib_tpu_torch.ops.kernels import three_interp as kti

    src = (_build.CSRC / "three_interp.cu").read_text()
    sources = {"ti_built": (src, _build.CSRC)}
    for name, edits in TI_VARIANTS.items():
        sources[f"ti_{name}"] = (edited(src, _segment_edits(src, edits)),
                                 _build.CSRC)
    if parent:
        text = (parent / "three_interp.cu").read_text()
        sources["ti_parent"] = (text, parent)
        for name, edits in PARENT_TI_SPLIT.items():
            sources[f"ti_parent_{name}"] = (
                edited(text, _segment_edits(text, edits)), parent)
    libs = build(sources)
    grouped = {name for name, (text, _) in sources.items()
               if "int group" in text}
    for name, lib in libs.items():
        lib.three_interp_launch.argtypes = TI_ARGS + (
            [ctypes.c_int] if name in grouped else []) + [ctypes.c_void_p]
        lib.three_interp_launch.restype = ctypes.c_int
    for case, q, p, f in interp_cases():
        b, m, _ = q.shape
        n, c = f.shape[1:]
        wout, widx, ww = kti.three_interp_plain(q, p, f)
        out, idx, w = map(torch.empty_like, (wout, widx, ww))
        runs = []
        for name, lib in libs.items():
            groups = kti.GROUPS if name in grouped else (None,)
            runs += [(name[3:] + ("" if g is None else f" g={g}"), lib, g)
                     for g in groups]
        rec: Dict[str, list] = {}
        for label, lib, g in runs:
            def call(lib=lib, g=g):
                extra = () if g is None else (g,)
                return lib.three_interp_launch(
                    _ptr(q), _ptr(p), _ptr(f), _ptr(out), _ptr(idx), _ptr(w),
                    b, n, m, c, *extra, _stream())

            if "write_only" in label:
                idx.copy_(widx)
                w.copy_(ww)
            else:
                idx.fill_(-1)
                w.fill_(float("nan"))
            out.fill_(float("nan"))
            if call() != 0:
                raise RuntimeError(f"{label} {case}: launch error")
            torch.cuda.synchronize()
            dev = max(((x - y).abs().max() / y.abs().max()).item()
                      for x, y in ((out, wout), (w, ww)))
            rec[label] = [round(graph_ms(call, 20), 4),
                          bool(torch.equal(idx, widx)), float(f"{dev:.2e}")]
        group = getattr(kti, "interp_group", None)
        print(json.dumps({
            "three_interp": case, "B": b, "M": m, "N": n, "C": c,
            "group": group(b, m) if group else None,
            "bytes_bound_ms": 1e3 * (12.0 * b * (m + n) + 4.0 * b * n * c
                                     + 4.0 * b * m * c + 24.0 * b * m)
            / 3.35e12,
            "ms_identical_dev": rec}), flush=True)


# Pass 1 of the EdgeConv from a given index (csrc/edge_f1.cu) at its
# seven launches of the main paths (the kNN route). The parent's split
# (--parent; wrong by design): load_nbr_only (the block's idx slice into
# shared memory, no rows) and rows_only (the row pass alone, its
# neighbour lists made up in shared memory from the row and slot).
EFG_ROWS = ("  edge_f1_rows(nbr, q + (size_t)b * n * c, off + mb, h + mb * k, "
            "red, c, k,\n               q0, nq);\n")
EFG_LOAD = "  load_nbr(idx + (size_t)b * m * k, q0, nq, k, nbr);\n"
EFG_MADE_UP = """  for (int e = tid; e < nq * k; e += kThreads) {
    const int ql = e / k;
    nbr[(e - ql * k) * kKnnQ + ql] = (q0 + ql + 37 * (e - ql * k)) % n;
  }
  __syncthreads();
"""
PARENT_EFG_SPLIT = {
    "load_nbr_only": [(EFG_ROWS, "  if (tid == 0) red[0] += (float)nbr[(k - 1)"
                       " * kKnnQ + nq - 1];\n")],
    "rows_only": [(EFG_LOAD, EFG_MADE_UP)],
}
# This tree's variants, edits of the shared write half (fused_sa_f1.cuh):
# the gathers in flight a lane (unroll2, unroll8) and the launch bounds'
# blocks an SM (min2, min4), as F1_VARIANTS times them for sa_f1.
EFG_VARIANTS = {
    "unroll2": [(F1_UNROLL, F1_UNROLL.replace("4", "2"))],
    "unroll8": [(F1_UNROLL, F1_UNROLL.replace("4", "8"))],
    "min2": [(F1_MIN_BLOCKS, F1_MIN_BLOCKS.replace("3", "2"))],
    "min4": [(F1_MIN_BLOCKS, F1_MIN_BLOCKS.replace("3", "4"))],
}
EFG_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5


def edgef1idx_cases():
    """``(case, q, off, idx)``: ``edge_f1``'s inputs at its seven launches
    of the main paths, from the models' own train chains on the kNN
    route with seeded weights: DGCNN's four EdgeConvs (B=32, N=1,000,
    k=20) and DGCNN part segmentation's two pairs and EC3 (B=16, N=1,000,
    k=40)."""
    from pointcloudlib_tpu_torch.ops.kernels import fused_edge as kfe

    x = torch.from_numpy(SyntheticModelNet(
        n_points=1000, size=32, seed=0).batch(0, 32)[0]).to(DEV)
    model = _seeded("dgcnn")
    with torch.no_grad():
        for i, ec in enumerate(model.edge):
            f = ec.fused
            q, off = f.prepare(x)
            idx = kknn.knn(x, x, f.k)[1]
            yield f"DGCNN EC{i + 1} N=1000", q.bfloat16(), off, idx
            x = kfe.fused_edge_conv(q, off, idx, f.bn_scale, f.bn_bias)[0]
    del model
    x = torch.from_numpy(SyntheticShapeNetPart(
        n_points=1000, size=16, seed=0).batch(0, 16)[0]).to(DEV)
    model = _seeded("dgcnn_partseg")
    with torch.no_grad():
        for name, layer in (("pair1", model.edge1), ("pair2", model.edge2),
                            ("EC3", model.edge3)):
            q, off = layer.prepare(x)
            idx = kknn.knn(x, x, layer.k)[1]
            yield f"DGCNN-seg {name} N=1000", q.bfloat16(), off, idx
            if name != "EC3":
                x = kfe.fused_edge2_conv(
                    q, off, idx, layer.w2, layer.bn1_scale, layer.bn1_bias,
                    layer.bn2_scale, layer.bn2_bias)[0]


def run_edgef1idx(parent: Optional[Path]) -> None:
    """This tree's ``edge_f1`` on every route that takes the shapes, its
    variants, and the parent's kernel and split, at each launch of
    :func:`edgef1idx_cases`: device ms by CUDA graphs with the psum
    memset, h bit-identical to the plain version and psum's deviation
    over max|plain|, with the bytes bound."""
    from pointcloudlib_tpu_torch.ops.kernels import fused_edge as kfe

    src = (_build.CSRC / "edge_f1.cu").read_text()
    sources = {"efg_built": (src, _build.CSRC)}
    for name, head in EFG_VARIANTS.items():
        sources[f"efg_{name}"] = (_with_header(
            _build.CSRC, "edge_f1.cu", "fused_sa_f1.cuh", [], head),
            _build.CSRC)
    if parent:
        text = (parent / "edge_f1.cu").read_text()
        sources["efg_parent"] = (text, parent)
        for name, edits in PARENT_EFG_SPLIT.items():
            sources[f"efg_parent_{name}"] = (
                edited(text, _segment_edits(text, edits)), parent)
    libs = build(sources)
    routed = {name for name, (text, _) in sources.items()
              if "int route" in text}
    for name, lib in libs.items():
        lib.edge_f1_launch.argtypes = EFG_ARGS + (
            [ctypes.c_int] if name in routed else []) + [ctypes.c_void_p]
        lib.edge_f1_launch.restype = ctypes.c_int
    for case, q, off, idx in edgef1idx_cases():
        b, m, k = idx.shape
        n, c = q.shape[1:]
        wh, wpsum = kfe.edge_f1_plain(q, off, idx)
        h, psum = torch.empty_like(wh), torch.zeros_like(wpsum)
        runs = []
        for name, lib in libs.items():
            routes = (None,)
            if name in routed:
                routes = [r for r in kfe.EDGE_F1_ROUTES
                          if kfe.edge_f1_route_fits(r, c)]
            runs += [(name[4:] + ("" if r is None else
                                  f" {kfe.EDGE_F1_ROUTES[r]}"), lib, r)
                     for r in routes]
        rec: Dict[str, list] = {}
        for label, lib, route in runs:
            def call(lib=lib, route=route):
                psum.zero_()
                extra = () if route is None else (route,)
                return lib.edge_f1_launch(
                    _ptr(q), _ptr(idx), _ptr(off), _ptr(h), _ptr(psum),
                    b, m, n, c, k, *extra, _stream())

            h.zero_()
            if call() != 0:
                raise RuntimeError(f"{label} {case}: launch error")
            torch.cuda.synchronize()
            same = bool(torch.equal(h.view(torch.int16),
                                    wh.view(torch.int16)))
            dev = ((psum - wpsum).abs().max() / wpsum.abs().max()).item()
            rec[label] = [round(graph_ms(call, 10), 4), same,
                          float(f"{dev:.2e}")]
        e = float(b * m * k)
        print(json.dumps({
            "edge_f1": case, "B": b, "M": m, "k": k, "C": c,
            "bytes_bound_ms": 1e3 * (2.0 * b * n * c + 4.0 * b * m * c
                                     + 4.0 * e + 2.0 * e * c + 8.0 * c)
            / 3.35e12,
            "ms_identical_dev": rec}), flush=True)
        del h, wh
        torch.cuda.empty_cache()


# The fused kNN + gather (csrc/knn_gather.cu) at its three launches of the
# main paths. The parent's split (--parent; a part's output is wrong by
# design): d2_only (the d² row alone, one store a query), select_only
# (the selection rounds, idx written, no rows copied) and copy_only (the
# rows copied from a given idx: the plain version's, which the harness
# leaves in the idx buffer; no d² row, no selection).
KG_END = "\n// Queries a block for n points"
KG_COPY = ("      const float* src = vb + (size_t)wj * cv;",
           "    if (lane == (wj & 31)) {")
KG_GIVEN = """  for (int s = 0; s < k; ++s) {
    const long long slot = qid * k + s;
    const int wj = idx[slot];
    const float* src = vb + (size_t)wj * cv;
    float* dst = grouped + slot * cv;
    if (VEC) {
      const float4* s4 = reinterpret_cast<const float4*>(src);
      float4* d4 = reinterpret_cast<float4*>(dst);
      for (int e = lane; e < cv / 4; e += 32) d4[e] = __ldg(s4 + e);
    } else {
      for (int e = lane; e < cv; e += 32) dst[e] = __ldg(src + e);
    }
  }
  (void)row;
  (void)pb;
  (void)qp;
}

"""
PARENT_KG_SPLIT = {
    "d2_only": [(("  const int rounds = (k - 1) * stride + 1;", KG_END),
                 "  if (lane == 0) idx[qid * k] = bj;\n}\n\n")],
    "select_only": [(KG_COPY, "    }\n")],
    "copy_only": [(("  float q2 = __fmul_rn(qp[0], qp[0]);", KG_END),
                   KG_GIVEN)],
}
# This tree's variants: the copy units in flight a lane (inflight4), the
# queries a block (warps16), the candidates the bisection finishes in
# registers (cand32, cand128), and the selection alone (select_only: no
# rows copied; grouped wrong by design).
KG_INFLIGHT = "constexpr int kKgInFlight = 8;"
KG_WARPS = "constexpr int kKgMaxWarps = 8;"
KG_CAND = "constexpr int kKgCand = 64;"
KG_VARIANTS = {
    "inflight4": [(KG_INFLIGHT, KG_INFLIGHT.replace("8", "4"))],
    "warps16": [(KG_WARPS, KG_WARPS.replace("8", "16"))],
    "cand32": [(KG_CAND, KG_CAND.replace("64", "32"))],
    "cand128": [(KG_CAND, KG_CAND.replace("64", "128"))],
    "select_only": [(("  // the rows: unit u of the query's",
                      "// ---------------------------------------------------"
                      "------------- launch"), "}\n\n")],
}
KG_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7


def kg_cases():
    """``(case, query, points, values, k, stride)``: the fused kNN +
    gather's inputs at its three launches of the main paths, recorded from
    the PointConv models' own eval forward with seeded weights:
    classification's SA2 (B=32, N=1024 with normals) and part
    segmentation's SA2 and SA3 (B=16, N=2048, xyz only)."""
    from pointcloudlib_tpu_torch.ops.kernels import knn_gather as kkg

    cls = SyntheticModelNet(n_points=1024, size=32, seed=0).batch(0, 32)
    seg = torch.from_numpy(SyntheticShapeNetPart(
        n_points=2048, size=16, seed=0).batch(0, 16)[0]).to(DEV)
    for tag, name, inputs in (
            ("cls", "pointconv", (torch.from_numpy(cls[0]).to(DEV),
                                  torch.from_numpy(cls[1]).to(DEV))),
            ("seg", "pointconv_partseg",
             (seg, torch.zeros((16, 16), device=DEV)))):
        calls, orig = [], kkg.knn_gather

        def rec(q, p, v, k, stride=1, calls=calls, orig=orig):
            calls.append((q.detach().clone(), p.detach().clone(),
                          v.detach().clone(), k, stride))
            return orig(q, p, v, k, stride)

        rec.launches = 0  # the original counts on its module name
        model = _seeded(name)
        kkg.knn_gather = rec
        try:
            with torch.no_grad():
                model(*inputs)
        finally:
            kkg.knn_gather = orig
        del model
        for q, p, v, k, stride in calls:
            yield (f"{tag} M={q.shape[1]} N={p.shape[1]} Cv={v.shape[2]} "
                   f"k={k}", q, p, v, k, stride)


def run_kg(parent: Optional[Path]) -> None:
    """This tree's fused kNN + gather on every route it has, its variants,
    and the parent's kernel and split, at each launch of
    :func:`kg_cases`: device ms by CUDA graphs, idx and grouped
    bit-identical to the plain version, with the bytes bound."""
    from pointcloudlib_tpu_torch.ops.kernels import knn_gather as kkg

    src = (_build.CSRC / "knn_gather.cu").read_text()
    sources = {"kg_built": (src, _build.CSRC)}
    for name, edits in KG_VARIANTS.items():
        sources[f"kg_{name}"] = (edited(src, _segment_edits(src, edits)),
                                 _build.CSRC)
    if parent:
        text = (parent / "knn_gather.cu").read_text()
        sources["kg_parent"] = (text, parent)
        for name, edits in PARENT_KG_SPLIT.items():
            sources[f"kg_parent_{name}"] = (
                edited(text, _segment_edits(text, edits)), parent)
    libs = build(sources)
    routed = {name for name, (text, _) in sources.items()
              if "knn_gather_route_launch" in text}
    for name, lib in libs.items():
        lib.knn_gather_launch.argtypes = KG_ARGS + [ctypes.c_void_p]
        lib.knn_gather_launch.restype = ctypes.c_int
        if name in routed:
            fn = lib.knn_gather_route_launch
            fn.argtypes = KG_ARGS + [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
    for case, q, p, v, k, stride in kg_cases():
        b, m, c = q.shape
        n, cv = v.shape[1:]
        widx, wg = kkg.knn_gather_plain(q, p, v, k, stride)
        idx, grouped = torch.empty_like(widx), torch.empty_like(wg)
        runs = []
        for name, lib in libs.items():
            routes = kkg.ROUTES if name in routed else (None,)
            runs += [(name[3:] + ("" if r is None else f" {kkg.ROUTES[r]}"),
                      lib, r) for r in routes]
        rec: Dict[str, list] = {}
        for label, lib, route in runs:
            def call(lib=lib, route=route):
                args = (_ptr(q), _ptr(p), _ptr(v), _ptr(idx), _ptr(grouped),
                        b, m, n, c, cv, k, stride)
                if route is None:
                    return lib.knn_gather_launch(*args, _stream())
                return lib.knn_gather_route_launch(*args, route, _stream())

            if "copy_only" in label:
                idx.copy_(widx)
            else:
                idx.fill_(-1)
            grouped.fill_(float("nan"))
            if call() != 0:
                raise RuntimeError(f"{label} {case}: launch error")
            torch.cuda.synchronize()
            rec[label] = [round(graph_ms(call, 10), 4),
                          bool(torch.equal(idx, widx)),
                          bool(torch.equal(grouped, wg))]
        route = getattr(kkg, "knn_gather_route", None)
        print(json.dumps({
            "knn_gather": case, "B": b, "M": m, "N": n, "C": c, "Cv": cv,
            "k": k, "stride": stride,
            "route": kkg.ROUTES[route(n, k, stride)] if route else None,
            "bytes_bound_ms": 1e3 * (4.0 * b * n * cv + 4.0 * b * m * k
                                     + 4.0 * b * m * k * cv) / 3.35e12,
            "ms_idx_grouped_identical": rec}), flush=True)
        del grouped, wg
        torch.cuda.empty_cache()


# The standalone ball query (csrc/ball_query.cu) at its three launches of
# the main paths. The parent's split (--parent; a part's output is wrong
# by design): stage_only (the cloud staged, one store a block), ballots
# (the scan with its ballots, cnt stored, no idx stores, no fill), stores
# (the scan with its idx stores, no fill) and fill_only (the fill alone,
# count and slot 0 given: the plain version's cnt and idx, which the
# harness leaves in the buffers; no staging, no scan).
BQ_LOOP = ("  for (int c = warp; c < mt; c += kWarps) {",
           "}\n\n}  // namespace pcl")
BQ_SCAN = """    const int count =
        bq_scan(new_xyz + center * 3, ptss, n, k, r2, lane, row);
"""
BQ_FILL = "    bq_fill(row, count, k, lane);\n"
BQ_STAGE = ("  stage_cloud(pts + (size_t)b * n * 3, n, ptss, threadIdx.x, "
            "kThreads);\n  __syncthreads();\n")
BQ_BALLOTS = """    const float* cp = new_xyz + center * 3;
    const float cx = cp[0], cy = cp[1], cz = cp[2];
    const float c2 = sumsq3(cx, cy, cz);
    int count = 0;
    for (int base = 0; base < n; base += kScanStep) {
      unsigned bal[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int j = base + 32 * s + lane;
        bal[s] = __ballot_sync(
            0xffffffffu, j < n && sq_dist(cx, cy, cz, c2, ptss[j]) < r2);
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) count += __popc(bal[s]);
    }
"""
PARENT_BQ_SPLIT = {
    "stage_only": [(BQ_LOOP, "  if (threadIdx.x == 0) cnt[(size_t)b * m + "
                    "m0] = __float_as_int(ptss[n - 1].w);\n")],
    "ballots": [(BQ_SCAN, BQ_BALLOTS), (BQ_FILL, "")],
    "stores": [(BQ_FILL, "")],
    "fill_only": [(BQ_STAGE, ""),
                  (BQ_SCAN, "    const int count = cnt[center];\n")],
}
# This tree's variants, alone and combined (names joined by "+"): the
# blocks the scan's grid aims at (min1056: fewer centers a warp), its
# sets a step (sets4: 4 at one center a warp), the near chunks a cull step
# walks (inflight4), the cull's centers a block (cull_c128), and the
# split (wrong by design): emit_none (no flush stores), cull_stage_only
# (staging and boxes, one store a block), cull_no_tests (the centers'
# loop without box tests or walks) and cull_no_visits (the box tests
# without walks, cnt the near chunks: the harness adds the points they
# hold).
BQ_MIN = "constexpr int kBqScanMinBlocks = 528;"
BQ_SETS = "constexpr int kSets = R == 1 ? 8 : 4 / R;"
BQ_FLIGHT = "constexpr int kBqInFlight = 8;"
BQ_CC = "constexpr int kBqCullCenters = 64;"
BQ_CENTERS = ("  const unsigned below = (1u << lane) - 1u;\n",
              "// ---------------------------------------------------------"
              "------- launch")
BQ_NEAR = "sc < supers && !bq_far("
BQ_WALK = "    for (int t = 0; t < nn; t += kBqInFlight) {"
_BQ = {
    "min1056": (BQ_MIN, BQ_MIN.replace("528", "1056")),
    "sets4": (BQ_SETS, "constexpr int kSets = R < 4 ? 4 / R : 1;"),
    "inflight4": (BQ_FLIGHT, BQ_FLIGHT.replace("8", "4")),
    "cull_c128": (BQ_CC, BQ_CC.replace("64", "128")),
}
BQ_VARIANTS = {
    **{"+".join(names): [_BQ[x] for x in names] for names in (
        ("min1056",), ("sets4",), ("inflight4",), ("cull_c128",))},
    "emit_none": [("  } else if (r.count < r.k) {", "  } else if (false) {"),
                  ("      if (h < take) r.row[r.count + h] = js + pos;\n",
                   "")],
    "cull_stage_only": [(BQ_CENTERS, "  if (threadIdx.x == 0) cnt[(size_t)b "
                         "* m + m0] = __float_as_int(cloud_l1);\n}\n\n")],
    "cull_no_tests": [(BQ_NEAR, "false && !bq_far(")],
    "cull_no_visits": [(BQ_WALK, "    rw.count += nn;\n"
                        "    for (int t = 0; t < 0; t += kBqInFlight) {")],
}
BQ_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float]


def bq_cases():
    """``(case, centers, points, radius, k)``: the ball query's inputs at
    its three launches of the main paths, recorded from the models' own
    eval forward with seeded weights: PointNet++ MSG's two k=128 scales
    (B=32, N=1024 with normals) and SSG's SA1 at N=4096 (B=32, the clouds
    Hilbert-sorted as the train step and the Predictor sort them)."""
    from pointcloudlib_tpu_torch.ops import spatial
    from pointcloudlib_tpu_torch.ops.kernels import ball_query as kbq

    msg = SyntheticModelNet(n_points=1024, size=32, seed=0).batch(0, 32)
    big = SyntheticModelNet(n_points=4096, size=32, seed=0).batch(0, 32)
    big = spatial.canonicalize(torch.from_numpy(big[0]).to(DEV),
                               torch.from_numpy(big[1]).to(DEV))
    for tag, name, inputs in (
            ("MSG", "pointnet2_msg", (torch.from_numpy(msg[0]).to(DEV),
                                      torch.from_numpy(msg[1]).to(DEV))),
            ("SSG4096", "pointnet2", big[:2])):
        calls, orig = [], kbq.ball_query

        def rec(c, p, radius, k, calls=calls, orig=orig):
            calls.append((c.detach().clone(), p.detach().clone(), radius, k))
            return orig(c, p, radius, k)

        rec.launches = 0
        model = _seeded(name)
        kbq.ball_query = rec
        try:
            with torch.no_grad():
                model(*inputs)
        finally:
            kbq.ball_query = orig
        del model
        for c, p, radius, k in calls:
            yield (f"{tag} M={c.shape[1]} N={p.shape[1]} r={radius} k={k}",
                   c, p, radius, k)


def run_bq(parent: Optional[Path]) -> None:
    """This tree's ball query on every route it has, its variants, and the
    parent's kernel and split, at each launch of :func:`bq_cases`: device
    ms by CUDA graphs, idx and cnt bit-identical to the plain version,
    with the bounds (every pair's ~10 operations; bytes) and the pairs the
    culling route tests."""
    from pointcloudlib_tpu_torch.ops.kernels import ball_query as kbq

    src = (_build.CSRC / "ball_query.cu").read_text()
    sources = {"bq_built": (src, _build.CSRC)}
    for name, edits in BQ_VARIANTS.items():
        sources[f"bq_{name}"] = (edited(src, _segment_edits(src, edits)),
                                 _build.CSRC)
    if parent:
        text = (parent / "ball_query.cu").read_text()
        sources["bq_parent"] = (text, parent)
        for name, edits in PARENT_BQ_SPLIT.items():
            sources[f"bq_parent_{name}"] = (
                edited(text, _segment_edits(text, edits)), parent)
    libs = build(sources)
    routed = {name for name, (text, _) in sources.items()
              if "int route" in text}
    for name, lib in libs.items():
        lib.ball_query_launch.argtypes = BQ_ARGS + (
            [ctypes.c_int] if name in routed else []) + [ctypes.c_void_p]
        lib.ball_query_launch.restype = ctypes.c_int
    for case, nx, p, radius, k in bq_cases():
        b, m, _ = nx.shape
        n = p.shape[1]
        widx, wcnt = kbq.ball_query_plain(nx, p, radius, k)
        idx, cnt = torch.empty_like(widx), torch.empty_like(wcnt)
        runs = []
        for name, lib in libs.items():
            routes = kbq.ROUTES if name in routed else (None,)
            runs += [(name[3:] + ("" if r is None else f" {kbq.ROUTES[r]}"),
                      lib, r) for r in routes]
        rec: Dict[str, list] = {}
        for label, lib, route in runs:
            def call(lib=lib, route=route):
                extra = () if route is None else (route,)
                return lib.ball_query_launch(
                    _ptr(nx), _ptr(p), _ptr(idx), _ptr(cnt), b, n, m, k,
                    ctypes.c_float(radius * radius), *extra, _stream())

            if "fill_only" in label:
                idx.copy_(widx)
                cnt.copy_(wcnt)
            else:
                idx.fill_(-1)
                cnt.fill_(-1)
            if call() != 0:
                raise RuntimeError(f"{label} {case}: launch error")
            torch.cuda.synchronize()
            rec[label] = [round(graph_ms(call, 20), 4),
                          bool(torch.equal(idx, widx) and
                               torch.equal(cnt, wcnt))]
            if "no_visits" in label:  # cnt: the near chunks, 32 points each
                rec[label].append(32 * int(cnt.sum()))
        route = getattr(kbq, "ball_query_route", None)
        tested = getattr(kbq, "pairs_tested", None)
        print(json.dumps({
            "ball_query": case, "B": b, "M": m, "N": n, "k": k,
            "route": kbq.ROUTES[route(n)] if route else None,
            "cnt_mean": round(wcnt.float().mean().item(), 2),
            "pairs": b * m * n,
            "pairs_tested_culling": tested(nx, p, radius) if tested else None,
            "ops_bound_ms": 1e3 * 10.0 * b * m * n / 67e12,
            "bytes_bound_ms": 1e3 * (12.0 * b * (m + n)
                                     + 4.0 * b * m * (k + 1)) / 3.35e12,
            "ms_identical": rec}), flush=True)



# The eval-mode EdgeConv from a given index (csrc/edge_eval.cu) at its six
# launches of the served paths on the kNN route. The parent's split
# (--parent; a part's output is wrong by design): staging_only (load_nbr
# and its barrier, no rows), gathers_only (the max of the raw Q values,
# no BN, no LeakyReLU, no Off) and no_stores (the gathers and the
# arithmetic, out stored only behind a test no value passes).
EEV_ROWS = ("  edge_eval_rows(nbr, q + (size_t)b * n * c, off + mb, st, "
            "out + mb, c, k,\n                 slope, q0, nq);\n")
EEV_MAX0 = ("      m0 = fmaxf(m0, leaky(bn_z(__fsub_rn(bf_lo(w), o0), sc0, "
            "bi0), slope));\n")
EEV_MAX1 = ("      m1 = fmaxf(m1, leaky(bn_z(__fsub_rn(bf_hi(w), o1), sc1, "
            "bi1), slope));\n")
EEV_STORE = ("    *reinterpret_cast<float2*>(out + row * c + cc) = "
             "make_float2(m0, m1);\n")
PARENT_EEV_SPLIT = {
    "staging_only": ([(EEV_ROWS, "  if (threadIdx.x == 0) out[mb] = "
                       "(float)nbr[(k - 1) * kKnnQ + nq - 1];\n")], ()),
    "gathers_only": ((), [(EEV_MAX0, "      m0 = fmaxf(m0, bf_lo(w));\n"),
                          (EEV_MAX1, "      m1 = fmaxf(m1, bf_hi(w));\n")]),
    "no_stores": ((), [(EEV_STORE, "    if (__float_as_uint(m0) == "
                        "0x7fc00001u)\n  " + EEV_STORE)]),
}
# This tree's variants of the center route, edits of edge_eval.cu and of
# edge_eval.cuh: the reduction in the plain order (eval_center, the eval
# half of edge_knn_eval's select route: every slot's leaky(BN(.)), then
# the max, a warp a center), the lanes a center (a warp, or 16: two
# centers a warp at C = 64), the gathers in flight a lane (kEvUnroll 2,
# 6, 8), the launch bounds' blocks an SM (2, 3, 5), out by streaming
# stores, and the split idx_only (the walk and the idx rows alone, no
# gathers).
EEV_UNROLL = "constexpr int kEvUnroll = 4;"
EEV_MIN_BLOCKS = "constexpr int kEvMinBlocks = 4;"
EEV_LANES = "constexpr int kEvLanes = 8;"
EEV_CALL = """    eval_center_extreme<C, kEvUnroll, W>(
        q + (center / m) * n * C, off + center * C,
        c0 + grp < centers ? out + center * C : nullptr, nbr, k, stc, flip,
        slope, gl);
"""
EEV_PLAIN = """    float sc[8], bi[8];
    for (int c = 0; c < 8; ++c) {
      sc[c] = stc[c];
      bi[c] = stc[C + c];
    }
    eval_center<C, kEvUnroll>(q + (center / m) * n * C, off + center * C,
                              out + center * C, nbr, k, sc, bi, slope, gl);
"""
EEV_STORES = """  o[0] = make_float4(r[0], r[1], r[2], r[3]);
  o[1] = make_float4(r[4], r[5], r[6], r[7]);
}"""
EEV_VARIANTS = {
    "plain_order": ([(EEV_LANES, EEV_LANES.replace("8", "32")),
                     (EEV_CALL, EEV_PLAIN)], ()),
    "lanes32": ([(EEV_LANES, EEV_LANES.replace("8", "32"))], ()),
    "lanes16": ([(EEV_LANES, EEV_LANES.replace("8", "16"))], ()),
    "unroll2": ([(EEV_UNROLL, EEV_UNROLL.replace("4", "2"))], ()),
    "unroll6": ([(EEV_UNROLL, EEV_UNROLL.replace("4", "6"))], ()),
    "unroll8": ([(EEV_UNROLL, EEV_UNROLL.replace("4", "8"))], ()),
    "min2": ([(EEV_MIN_BLOCKS, EEV_MIN_BLOCKS.replace("4", "2"))], ()),
    "min3": ([(EEV_MIN_BLOCKS, EEV_MIN_BLOCKS.replace("4", "3"))], ()),
    "min5": ([(EEV_MIN_BLOCKS, EEV_MIN_BLOCKS.replace("4", "5"))], ()),
    "streaming_stores": ((), [(EEV_STORES, """  __stcs(o, make_float4(r[0], r[1], r[2], r[3]));
  __stcs(o + 1, make_float4(r[4], r[5], r[6], r[7]));
}""")]),
    "idx_only": ([(EEV_CALL, "    if (c0 + grp < centers && gl == 0) "
                   "out[center * C] = (float)nbr[k - 1];\n")], ()),
}
EEV_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5


def edgeevalidx_cases():
    """``(case, q, off, idx, st)``: ``edge_eval``'s inputs at its six
    launches of the served paths, from the models' own eval chains on
    the kNN route with seeded weights (running statistics): DGCNN's four
    EdgeConvs at 32 clouds of 10,000 points (k=20) and DGCNN part
    segmentation's EC3 at 16 clouds of 1,000 and of 5,000 points
    (k=40)."""
    from pointcloudlib_tpu_torch.ops.kernels.fused_sa import _stack_stats

    def ev(f, x):
        q, off = f.prepare(x)
        st = _stack_stats(f.mean, f.var, f.bn_scale, f.bn_bias)
        return q.bfloat16(), off, kknn.knn(x, x, f.k)[1], st

    x = torch.from_numpy(SyntheticModelNet(
        n_points=10000, size=32, seed=0).batch(0, 32)[0]).to(DEV)
    model = _seeded("dgcnn")
    with torch.no_grad():
        for i, ec in enumerate(model.edge):
            yield f"DGCNN EC{i + 1} N=10000", *ev(ec.fused, x)
            x = ec(x)
    del model, x
    model = _seeded("dgcnn_partseg")
    for n in (1000, 5000):
        x = torch.from_numpy(SyntheticShapeNetPart(
            n_points=n, size=16, seed=0).batch(0, 16)[0]).to(DEV)
        with torch.no_grad():
            x = model.edge2(model.edge1(x))
            yield f"DGCNN-seg EC3 N={n}", *ev(model.edge3, x)


def _sass_of(lib: Path, pattern: str) -> Dict[str, str]:
    """``{function: instructions}`` of the kernels in ``lib`` whose names
    match ``pattern``, from ``cuobjdump -sass`` with the addresses and
    encodings left out."""
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120).stdout
    out: Dict[str, List[str]] = {}
    fn = None
    for ln in text.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[1].strip()
            fn = fn if re.search(pattern, fn) else None
            if fn:
                out[fn] = []
        elif fn:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", ln)
            if m:
                out[fn].append(m.group(1))
    return {f: "\n".join(v) for f, v in out.items()}


def run_edgeevalidx(parent: Optional[Path]) -> None:
    """This tree's ``edge_eval`` on every route that takes the shapes, its
    variants, and the parent's kernel (built twice) and split, at each
    launch of :func:`edgeevalidx_cases`: device ms by CUDA graphs with the
    wrapper's output left out, out bit-identical (``torch.equal``) to the
    plain version, with the bytes bound and the L2 gather volume
    (B·M·k·C·2 bytes). With ``--parent``, first whether this tree's
    ``edge_knn_eval.cu`` compiles its select route to the parent's code
    (``cuobjdump -sass``)."""
    from pointcloudlib_tpu_torch.ops.kernels import fused_edge as kfe

    src = (_build.CSRC / "edge_eval.cu").read_text()
    sources = {"eev_built": (src, _build.CSRC)}
    for name, (edits, head) in EEV_VARIANTS.items():
        sources[f"eev_{name}"] = (_with_header(
            _build.CSRC, "edge_eval.cu", "edge_eval.cuh", edits, head),
            _build.CSRC)
    if parent:
        text = (parent / "edge_eval.cu").read_text()
        sources["eev_parent"] = (text, parent)
        sources["eev_parent_again"] = (text, parent)
        for name, (edits, head) in PARENT_EEV_SPLIT.items():
            sources[f"eev_parent_{name}"] = (_with_header(
                parent, "edge_eval.cu", "edge_knn.cuh", edits, head), parent)
        sources["knn_eval_parent"] = (
            (parent / "edge_knn_eval.cu").read_text(), parent)
        sources["knn_eval_built"] = (
            (_build.CSRC / "edge_knn_eval.cu").read_text(), _build.CSRC)
    libs = build(sources)
    if parent:
        del libs["knn_eval_parent"], libs["knn_eval_built"]
        old, new = (_sass_of(OUT / f"knn_eval_{w}.so", "select_kernel")
                    for w in ("parent", "built"))
        print(json.dumps({
            "edge_knn_eval_select_sass": {
                f: {"instructions": len(old[f].splitlines()),
                    "same_as_parent": new.get(f) == old[f]}
                for f in sorted(old)}}), flush=True)
    routed = {name for name, (text, _) in sources.items()
              if "int route" in text}
    for name, lib in libs.items():
        lib.edge_eval_launch.argtypes = EEV_ARGS + (
            [ctypes.c_int] if name in routed else []) + [
            ctypes.c_float, ctypes.c_void_p]
        lib.edge_eval_launch.restype = ctypes.c_int
    for case, q, off, idx, st in edgeevalidx_cases():
        b, m, k = idx.shape
        n, c = q.shape[1:]
        want = torch.cat([kfe.edge_eval_plain(q[s:s + 8], off[s:s + 8],
                                              idx[s:s + 8], st)
                          for s in range(0, b, 8)])
        out = torch.empty_like(want)
        runs = []
        for name, lib in libs.items():
            routes = (None,)
            if name in routed:  # the variants: the center route only
                routes = [r for r in kfe.EDGE_EVAL_ROUTES
                          if kfe.edge_eval_route_fits(r, c)
                          and (r == 1 or name == "eev_built")]
            runs += [(name[4:] + ("" if r is None else
                                  f" {kfe.EDGE_EVAL_ROUTES[r]}"), lib, r)
                     for r in routes]
        rec: Dict[str, list] = {}
        for label, lib, route in runs:
            def call(lib=lib, route=route):
                extra = () if route is None else (route,)
                return lib.edge_eval_launch(
                    _ptr(q), _ptr(idx), _ptr(off), _ptr(st), _ptr(out),
                    b, m, n, c, k, *extra, 0.2, _stream())

            out.fill_(float("nan"))
            if call() != 0:
                raise RuntimeError(f"{label} {case}: launch error")
            torch.cuda.synchronize()
            rec[label] = [round(graph_ms(call, 10), 4),
                          bool(torch.equal(out, want))]
        print(json.dumps({
            "edge_eval": case, "B": b, "M": m, "N": n, "k": k, "C": c,
            "bytes_bound_ms": 1e3 * (2.0 * b * n * c + 8.0 * b * m * c
                                     + 4.0 * b * m * k + 16.0 * c)
            / 3.35e12,
            "l2_gather_GB": 2.0 * b * m * k * c / 1e9,
            "ms_identical": rec}), flush=True)
        del out, want
        torch.cuda.empty_cache()

def run_read() -> None:
    lib = build({"read": (READ, _build.CSRC)})["read"]
    x = torch.empty(2 ** 27, dtype=torch.bfloat16, device=DEV).normal_()
    out = torch.zeros(1, device=DEV)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for unroll in (1, 4, 8):
        ms = graph_ms(lambda: lib.read_launch(
            _ptr(x), ctypes.c_longlong(x.numel() // 8), _ptr(out), 8 * sms,
            unroll, _stream()), 5)
        print(json.dumps({"read": 2 * x.numel(), "loads_in_flight": unroll,
                          "ms": round(ms, 4),
                          "TB_s": round(2 * x.numel() / ms / 1e9, 3)}),
              flush=True)
    for cs in (0, 1):
        for per_sm in (8, 16):
            ms = graph_ms(lambda: lib.write_launch(
                _ptr(x), ctypes.c_longlong(x.numel() // 8), per_sm * sms, cs,
                _stream()), 5)
            print(json.dumps({"write": 2 * x.numel(), "streaming_hint": cs,
                              "blocks_an_sm": per_sm, "ms": round(ms, 4),
                              "TB_s": round(2 * x.numel() / ms / 1e9, 3)}),
                  flush=True)


def run_cluster() -> None:
    lib = build({"exchange": (CLUSTER, _build.CSRC)})["exchange"]
    out = torch.zeros(1, dtype=torch.int32, device=DEV)
    m = 4096
    for cluster in (0, 1):
        for threads in (128, 256):
            ms = graph_ms(lambda: lib.exchange_launch(
                cluster, 128, threads, m, _ptr(out), _stream()), 5)
            print(json.dumps({"exchange": "cluster" if cluster else "block",
                              "threads": threads,
                              "ns": round(ms * 1e6 / m, 1)}), flush=True)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", default=["fps", "tail", "f1", "read",
                                                  "cluster"],
                    choices=["fps", "tail", "f1", "rows", "knn", "edge2p1",
                             "edgef1", "edge2p2", "edgeeval", "tail2",
                             "edgebwd", "edge2eval", "interp", "edgef1idx",
                             "edgeevalidx", "kg", "bq", "read",
                             "cluster"])
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("kernel_variants: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(json.dumps({"card": smi.stdout.strip()}), flush=True)
    if "fps" in args.only:
        run_fps(args.parent)
    if "tail" in args.only:
        run_tail(args.parent)
    if "f1" in args.only:
        run_f1(args.parent)
    if "rows" in args.only:
        run_rows(args.parent)
    if "knn" in args.only:
        run_knn(args.parent)
    if "edge2p1" in args.only:
        run_edge2p1(args.parent)
    if "edgef1" in args.only:
        run_edgef1(args.parent)
    if "edge2p2" in args.only:
        run_edge2p2(args.parent)
    if "edgeeval" in args.only:
        run_edgeeval(args.parent)
    if "tail2" in args.only:
        run_tail2(args.parent)
    if "edgebwd" in args.only:
        run_edgebwd(args.parent)
    if "edge2eval" in args.only:
        run_edge2eval(args.parent)
    if "interp" in args.only:
        run_interp(args.parent)
    if "edgef1idx" in args.only:
        run_edgef1idx(args.parent)
    if "edgeevalidx" in args.only:
        run_edgeevalidx(args.parent)
    if "kg" in args.only:
        run_kg(args.parent)
    if "bq" in args.only:
        run_bq(args.parent)
    if "read" in args.only:
        run_read()
    if "cluster" in args.only:
        run_cluster()


if __name__ == "__main__":
    main()
