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
// 2 * sum(min(cnt, k)) * (C1*C2 + C2*C3) bf16 flops, against a few tens
// of MB of traffic (q, off, out) — operations, not bytes. Both products
// run on the tensor cores (wgmma, fused_sa_eval.cuh): resident blocks of
// two warpgroups, each walking its own units of MT centers. A unit's
// cloud is staged in shared memory and scanned by one warp a center, 128
// points a step, ballots giving the in-order ranks of the first k hits
// (bq_step); then its live rows, padded to whole 8-row groups a center,
// run through the chain 64 rows at a time with the next tile's q rows
// copied in by cp.async meanwhile, and the max is folded from the
// accumulator fragment.
//
// Numerics: distances and the BN affines use explicit round-to-nearest
// intrinsics (no FMA contraction), exactly as the plain version's
// separate tensor ops round; the products sum in another order than the
// plain version's, and y2's bf16 roundings are held to the plain
// version's where that order could move them (layer2_z).

#include "fused_sa_eval.cuh"

namespace pcl {

template <int C1, int C2, int C3, int MT>
__global__ void __launch_bounds__(2 * wg::kWGThreads,
                                  EvalLayout<C1, C2, C3, MT>::min_blocks)
    bq_eval_kernel(const EvalArgs a) {
  eval_walk<C1, C2, C3, MT, true>(a);
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
  pcl::EvalArgs a = {};
  a.new_xyz = static_cast<const float*>(new_xyz);
  a.pts = static_cast<const float*>(pts);
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.off = static_cast<const float*>(off);
  a.st = static_cast<const float*>(st);
  a.w2 = static_cast<const __nv_bfloat16*>(w2);
  a.w3 = static_cast<const __nv_bfloat16*>(w3);
  a.out = static_cast<float*>(out);
  a.batch = batch;
  a.n = n;
  a.m = m;
  a.k = k;
  a.r2 = r2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PCL_LAUNCH(A, B, C, MT)                                         \
  if (c1 == A && c2 == B && c3 == C)                                    \
    return pcl::launch_eval<A, B, C, MT>(pcl::bq_eval_kernel<A, B, C, MT>, \
                                         a, n, s);
  PCL_EVAL_WIDTHS(PCL_LAUNCH)
#undef PCL_LAUNCH
  return cudaErrorInvalidValue;
}

// Dynamic shared memory the launch above needs (0: widths not compiled).
extern "C" long long sa_bq_eval_smem(int n, int c1, int c2, int c3, int k) {
#define PCL_BYTES(A, B, C, MT)       \
  if (c1 == A && c2 == B && c3 == C) \
    return (long long)pcl::EvalLayout<A, B, C, MT>::bytes(n, k);
  PCL_EVAL_WIDTHS(PCL_BYTES)
#undef PCL_BYTES
  return 0;
}
