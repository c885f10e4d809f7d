"""Design variants of the FPS kernel, of the forward tail's stage 2 and
of forward pass 1, timed against each other on the card. Each variant is
an edit of the committed source (``csrc/fps.cu``, ``csrc/fused_sa_tail.cu``,
``csrc/fused_sa_bq_f1.cu`` and ``fused_sa_f1.cu``), built beside it by
``nvcc`` with the package's flags into ``build/variants/``.

    python -m pointcloudlib_tpu_torch.tools.kernel_variants \
        [--only fps tail f1 read cluster] [--parent DIR]

``--parent DIR`` names another checkout's ``csrc/`` (the parent commit's,
unpacked by ``git archive``): its ``fps.cu``, ``fused_sa_tail.cu`` and
pass-1 sources are built against its own headers and timed beside the
variants. Prints one JSON line a case:

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
                    choices=["fps", "tail", "f1", "read", "cluster"])
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
    if "read" in args.only:
        run_read()
    if "cluster" in args.only:
        run_cluster()


if __name__ == "__main__":
    main()
