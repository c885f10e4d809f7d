// Eval-mode fused PointNet++ set abstraction with the ball query inside,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/fused_sa.py
// (fused_sa_bq_eval -> _k_bqeval). Same function, for each center:
//   ball query: the first k source points in index order with
//     d2 = max((|c|^2 - 2 c.p) + |p|^2, 0) < r^2 (the _bq_setup form);
//   for each live slot j < min(cnt, k):
//     h1 = float(bf16 Q[b, idx_j]) - off[b, center]
//     y1 = relu(h1*sc1 + bi1) -> bf16 -> h2 = y1 . W2 (f32 sums)
//     y2 = relu(h2*sc2 + bi2) -> bf16 -> h3 = y2 . W3 (f32 sums)
//     y3 = relu(h3*sc3 + bi3)
//   out = max over live slots of y3; a row with cnt == 0 outputs the
//   chain of Q[b, 0] - off (the XLA path's idx = 0 fallback).
// Slots past cnt replicate slot 0 and cannot change the max, so they are
// skipped, as on the TPU.
//
// What bounds it: the two products over the live slots,
// 2 * sum(min(cnt, k)) * (C1*C2 + C2*C3) flops, against a few tens of MB
// of traffic (q, off, out) — operations, not bytes. This first version
// runs them on the CUDA cores in f32 (each bf16 x bf16 product is exact
// in f32, so an FMA equals the TPU's bf16-operand, f32-accumulate
// product up to summation order); tensor cores are later work. The
// design keeps every intermediate on chip: one block per (cloud, tile of
// MT centers); the cloud's points, W2 and W3 (bf16) and the tile's off
// rows are staged in shared memory once; one warp per center scans the
// cloud 32 points a step and a ballot gives the in-order ranks of the
// first k hits (bq_scan); the tile's live (center, slot) rows are then
// packed densely and run through the chain 64 rows at a time
// (eval_chain, shared with the kernel that takes a given idx), so a tile
// pays for live slots only; each thread owns a register tile of rows x 8
// channels of each product and folds its rows into a running max per
// center before one shared-memory atomicMax per channel.
//
// Numerics: distances and the BN affines use explicit round-to-nearest
// intrinsics (no FMA contraction), exactly as the plain version's
// separate tensor ops round; only the products' summation order differs
// from the plain version.

#include "fused_sa_eval.cuh"

namespace pcl {

struct BqEvalArgs {
  EvalArgs e;
  const float* new_xyz;  // [B, M, 3]
  const float* pts;      // [B, N, 3]
  float r2;
};

// after the chain's arrays: n float4 points, then MT * k neighbour slots
template <int C1, int C2, int C3, int MT>
size_t bq_eval_bytes(int n, int k) {
  return EvalLayout<C1, C2, C3, MT>::end + (size_t)n * 16 +
         (size_t)MT * k * 4;
}

template <int C1, int C2, int C3, int MT>
__global__ void __launch_bounds__(kThreads)
    bq_eval_kernel(const BqEvalArgs a) {
  using L = EvalLayout<C1, C2, C3, MT>;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* ptss = reinterpret_cast<float4*>(smem + L::end);
  int* nbr = reinterpret_cast<int*>(smem + L::end + (size_t)a.e.n * 16);
  __shared__ int s_live[MT];

  const int n = a.e.n, m = a.e.m, k = a.e.k;
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * MT;
  const int mt = min(MT, m - m0);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  eval_stage<C1, C2, C3, MT>(smem, a.e, b, m0, mt);
  stage_cloud(a.pts + (size_t)b * n * 3, n, ptss);
  __syncthreads();

  // ---- ball query: one warp per center, up to the k-th hit
  for (int c = warp; c < mt; c += kWarps) {
    const int count = bq_scan<false>(
        a.new_xyz + ((size_t)b * m + m0 + c) * 3, ptss, n, k, a.r2, lane,
        nbr + c * k);
    if (lane == 0) {
      if (count == 0) nbr[c * k] = 0;  // empty row: one slot at point 0
      s_live[c] = count == 0 ? 1 : min(count, k);
    }
  }
  __syncthreads();

  eval_chain<C1, C2, C3, MT>(smem, a.e, b, m0, mt, nbr, s_live);
}

template <int C1, int C2, int C3, int MT>
cudaError_t launch(const BqEvalArgs& a, int batch, cudaStream_t stream) {
  const size_t smem = bq_eval_bytes<C1, C2, C3, MT>(a.e.n, a.e.k);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bq_eval_kernel<C1, C2, C3, MT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.e.m + MT - 1) / MT, batch);
  bq_eval_kernel<C1, C2, C3, MT><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace pcl

// Widths compiled: (32, 32, 64), (64, 64, 128), (64, 96, 128) and
// (128, 128, 256). Returns the launch's cudaGetLastError() code, or
// cudaErrorInvalidValue for widths or sizes it does not take.
extern "C" int sa_bq_eval_launch(const void* new_xyz, const void* pts,
                                 const void* q, const void* off,
                                 const void* st, const void* w2,
                                 const void* w3, void* out, int batch, int n,
                                 int m, int c1, int c2, int c3, int k,
                                 float r2, void* stream) {
  if (batch < 1 || n < 1 || m < 1 || k < 1) return cudaErrorInvalidValue;
  pcl::BqEvalArgs a;
  a.new_xyz = static_cast<const float*>(new_xyz);
  a.pts = static_cast<const float*>(pts);
  a.e.q = static_cast<const __nv_bfloat16*>(q);
  a.e.off = static_cast<const float*>(off);
  a.e.st = static_cast<const float*>(st);
  a.e.w2 = static_cast<const __nv_bfloat16*>(w2);
  a.e.w3 = static_cast<const __nv_bfloat16*>(w3);
  a.e.out = static_cast<float*>(out);
  a.e.n = n;
  a.e.m = m;
  a.e.k = k;
  a.r2 = r2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PCL_LAUNCH(A, B, C, MT)         \
  if (c1 == A && c2 == B && c3 == C)    \
    return pcl::launch<A, B, C, MT>(a, batch, s);
  PCL_EVAL_WIDTHS(PCL_LAUNCH)
#undef PCL_LAUNCH
  return cudaErrorInvalidValue;
}

// Dynamic shared memory the launch above needs (0: widths not compiled).
extern "C" long long sa_bq_eval_smem(int n, int c1, int c2, int c3, int k) {
#define PCL_BYTES(A, B, C, MT)          \
  if (c1 == A && c2 == B && c3 == C)    \
    return (long long)pcl::bq_eval_bytes<A, B, C, MT>(n, k);
  PCL_EVAL_WIDTHS(PCL_BYTES)
#undef PCL_BYTES
  return 0;
}
