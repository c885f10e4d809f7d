"""Design variants of the FPS kernel, of the forward tail's stage 2, of
forward pass 1, of the row scatter-add and gather, of the standalone kNN,
of the two-layer EdgeConv's backward passes and of the EdgeConv kernels
with the kNN inside, timed against each other on the card. Each variant
is an edit of the committed source (``csrc/fps.cu``,
``csrc/fused_sa_tail.cu``, ``csrc/fused_sa_bq_f1.cu`` and
``fused_sa_f1.cu``, ``csrc/scatter_rows.cu`` and ``gather_rows.cu``,
``csrc/knn.cu``, ``csrc/edge2_bwd_p1.cu``, ``csrc/edge2_bwd_p2.cu``,
``csrc/edge_knn_f1.cu``, ``csrc/edge_knn_eval.cu`` and
``edge2_knn_eval.cu``), built beside it by ``nvcc`` with the package's
flags into ``build/variants/``.

    python -m pointcloudlib_tpu_torch.tools.kernel_variants \
        [--only fps tail f1 rows knn edge2p1 edgef1 edge2p2 edgeeval read
                cluster]
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
    """``{name: (source text, include dir)}`` compiled in parallel."""
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
        "select_only": ([("  const int steps = (nq + kRows - 1) / kRows * k;",
                          "  const int steps = 0;")], ()),
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
            sources[f"{kind}_parent"] = ((parent / src).read_text(), parent)
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
                             "edgef1", "edge2p2", "edgeeval", "read",
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
    if "read" in args.only:
        run_read()
    if "cluster" in args.only:
        run_cluster()


if __name__ == "__main__":
    main()
