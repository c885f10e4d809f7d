// Fused k nearest neighbours and row gather, for Hopper (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/neighbors.py
// (knn_gather -> _knn_gather_fwd_call -> _knn_gather_kernel). For query
// [B, M, C], points [B, N, C] and values [B, N, Cv] (f32):
//   idx [B, M, k] i32        ranks 0, D, 2D, ..., (k-1)D of the points
//       ordered by d2 = max((|q|^2 - 2 q.p) + |p|^2, 0), ascending, the
//       lower index first on ties (D = stride; 1 for PointConv, the
//       dilation of PointCNN's kNN otherwise);
//   grouped [B, M, k, Cv] f32  values[b, idx[b, m, s], :], exact copies.
//
// The TPU kernel holds a [mt, N] distance tile in VMEM and runs k*D
// masked argmin rounds over it, each round's mask doubling as the one-hot
// row of a gather matmul (hi/lo bf16 halves), and writes [B, k, M, Cv]
// for a swap afterwards. Here one warp takes one query:
//   * its d2 row over the N points goes to shared memory (N floats a
//     warp), each lane forming the d2 of points lane, lane + 32, ... in
//     the plain square_distance's operations and order (products and sums
//     rounded one at a time, no FMA), so the order is bit-identical to
//     knn_plain's; each lane keeps the least (d2, j) of its own points;
//   * a round is a warp-wide argmin of the 32 lane minima by shuffles on
//     (d2, j), lexicographic, so the lower index wins a tie; the winner's
//     owner lane masks it (NaN, which no comparison selects) and rescans
//     its N/32 points for its next minimum;
//   * on a kept rank the warp copies that point's values row to
//     grouped[b, m, slot, :], lanes over Cv (float4 where Cv % 4 == 0),
//     so reads and writes coalesce and the layout is final.
// No list is kept, so k has no register limit (the kNN kernels of
// edge_knn.cuh stop at 40; PointConv's SA2 takes k = 64); N is bounded
// by shared memory, N*4 bytes a warp.
//
// What bounds it: bytes at PointConv's shapes: the grouped rows written,
// B*M*k*Cv*4 (138 MB at classification's SA2), beside values read and idx
// written once, against B*M*N pairs at 2*C + 3 f32 operations (the
// convention of the kNN kernels), under 1 % of it there.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pcl {

constexpr int kKgMaxWarps = 8;               // queries a block
constexpr int kKgSmem = 227 * 1024;          // shared memory a block may use

__device__ __forceinline__ bool kg_better(float d, int j, float bd, int bj) {
  return d < bd || (d == bd && j < bj);
}

template <bool VEC>
__global__ void __launch_bounds__(kKgMaxWarps * 32)
    knn_gather_kernel(const float* __restrict__ query,
                      const float* __restrict__ pts,
                      const float* __restrict__ values, int* __restrict__ idx,
                      float* __restrict__ grouped, long long queries, int m,
                      int n, int c, int cv, int k, int stride) {
  extern __shared__ float d2s[];  // [warps][n]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long qid = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (qid >= queries) return;  // no block-wide barrier follows
  float* row = d2s + (size_t)warp * n;
  const long long b = qid / m;
  const float* qp = query + qid * c;
  const float* pb = pts + (size_t)b * n * c;
  const float* vb = values + (size_t)b * n * cv;

  float q2 = __fmul_rn(qp[0], qp[0]);
  for (int ch = 1; ch < c; ++ch) q2 = __fadd_rn(q2, __fmul_rn(qp[ch], qp[ch]));

  float bd = INFINITY;
  int bj = 0x7fffffff;
  for (int j = lane; j < n; j += 32) {
    const float* pj = pb + (size_t)j * c;
    float inner = __fmul_rn(qp[0], pj[0]);
    float p2 = __fmul_rn(pj[0], pj[0]);
    for (int ch = 1; ch < c; ++ch) {
      inner = __fadd_rn(inner, __fmul_rn(qp[ch], pj[ch]));
      p2 = __fadd_rn(p2, __fmul_rn(pj[ch], pj[ch]));
    }
    const float d =
        fmaxf(__fadd_rn(__fsub_rn(q2, __fmul_rn(2.0f, inner)), p2), 0.0f);
    row[j] = d;
    if (kg_better(d, j, bd, bj)) {
      bd = d;
      bj = j;
    }
  }
  __syncwarp();

  const int rounds = (k - 1) * stride + 1;  // the last slot's skips unread
  for (int r = 0; r < rounds; ++r) {
    float wd = bd;
    int wj = bj;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, wd, off);
      const int oj = __shfl_xor_sync(0xffffffffu, wj, off);
      if (kg_better(od, oj, wd, wj)) {
        wd = od;
        wj = oj;
      }
    }
    if (r % stride == 0) {
      const long long slot = qid * k + r / stride;
      if (lane == 0) idx[slot] = wj;
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
    if (lane == (wj & 31)) {  // the owner masks the winner and rescans
      row[wj] = NAN;
      bd = INFINITY;
      bj = 0x7fffffff;
      for (int j = lane; j < n; j += 32) {
        const float d = row[j];
        if (kg_better(d, j, bd, bj)) {
          bd = d;
          bj = j;
        }
      }
    }
    __syncwarp();
  }
}

// Queries a block for n points: as many warps as shared memory holds, at
// most kKgMaxWarps; 0 when one warp's row does not fit.
inline int kg_warps(int n) {
  const long long fit = kKgSmem / (4LL * n);
  return fit < kKgMaxWarps ? (int)fit : kKgMaxWarps;
}

template <bool VEC>
cudaError_t launch(const void* query, const void* pts, const void* values,
                   void* idx, void* grouped, int b, int m, int n, int c,
                   int cv, int k, int stride, cudaStream_t stream) {
  const int warps = kg_warps(n);
  const size_t smem = (size_t)warps * n * 4;
  cudaError_t err = cudaFuncSetAttribute(
      knn_gather_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long queries = (long long)b * m;
  const long long blocks = (queries + warps - 1) / warps;
  knn_gather_kernel<VEC><<<(unsigned)blocks, warps * 32, smem, stream>>>(
      static_cast<const float*>(query), static_cast<const float*>(pts),
      static_cast<const float*>(values), static_cast<int*>(idx),
      static_cast<float*>(grouped), queries, m, n, c, cv, k, stride);
  return cudaGetLastError();
}

}  // namespace pcl

// query [b, m, c], pts [b, n, c], values [b, n, cv] f32; idx [b, m, k] i32,
// grouped [b, m, k, cv] f32; all contiguous. Returns the launch's
// cudaGetLastError() code, or cudaErrorInvalidValue for sizes it does not
// take (empty sizes, k * stride > n, n above 58,112: one warp's d2 row in
// shared memory).
extern "C" int knn_gather_launch(const void* query, const void* pts,
                                 const void* values, void* idx, void* grouped,
                                 int b, int m, int n, int c, int cv, int k,
                                 int stride, void* stream) {
  if (b < 1 || m < 1 || n < 1 || c < 1 || cv < 1 || k < 1 || stride < 1 ||
      (long long)k * stride > n || pcl::kg_warps(n) < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = cv % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(values) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(grouped) % 16 == 0;
  if (vec)
    return pcl::launch<true>(query, pts, values, idx, grouped, b, m, n, c, cv,
                             k, stride, s);
  return pcl::launch<false>(query, pts, values, idx, grouped, b, m, n, c, cv,
                            k, stride, s);
}
