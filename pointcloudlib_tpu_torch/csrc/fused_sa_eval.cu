// Eval-mode fused PointNet++ set abstraction from a given neighbour
// index, for Hopper (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/fused_sa.py
// (_fused_sa_eval_jit -> _k_eval; at N >= 4096 it also stands for
// _k_evalw). For each center, over its k slots:
//   h1 = float(bf16 Q[b, idx[b, center, j]]) - off[b, center]
//   y1 = relu(h1*sc1 + bi1) -> bf16 -> h2 = y1 . W2 (f32 sums)
//   y2 = relu(h2*sc2 + bi2) -> bf16 -> h3 = y2 . W3 (f32 sums)
//   out = max_j relu(h3*sc3 + bi3)
// with the running BatchNorm statistics folded into (sc, bi). When the
// ball query's cnt is given, only the first max(min(cnt, k), 1) slots of
// a center run: the slots past them repeat slot 0 and cannot raise the
// max, so the result is the same (the TPU kernel's slot cap rests on the
// same argument). Without cnt every slot runs.
//
// This is the ball-query eval kernel (fused_sa_bq_eval.cu) after its
// ball query, and shares that code (eval_walk): each unit's live idx
// slots are read into shared memory, then its rows run through the chain
// on the tensor cores, 64 rows at a time, no grouped tensor in device
// memory.
//
// What bounds it: operations, 2 * live rows * (C1*C2 + C2*C3) bf16 flops,
// against q, idx, off and out in bytes.

#include "fused_sa_eval.cuh"

namespace pcl {

template <int C1, int C2, int C3, int MT>
__global__ void __launch_bounds__(2 * wg::kWGThreads,
                                  EvalLayout<C1, C2, C3, MT>::min_blocks)
    eval_kernel(const EvalArgs a) {
  eval_walk<C1, C2, C3, MT, false>(a);
}

}  // namespace pcl

// Widths compiled: (32, 32, 64), (64, 64, 128), (64, 96, 128) and
// (128, 128, 256). cnt may be null. Every idx must lie in [0, n).
// Returns the launch's cudaGetLastError() code, or cudaErrorInvalidValue
// for widths or sizes it does not take.
extern "C" int sa_eval_launch(const void* q, const void* off,
                              const void* idx, const void* cnt,
                              const void* st, const void* w2, const void* w3,
                              void* out, int batch, int n, int m, int c1,
                              int c2, int c3, int k, void* stream) {
  if (batch < 1 || n < 1 || m < 1 || k < 1) return cudaErrorInvalidValue;
  pcl::EvalArgs a = {};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.off = static_cast<const float*>(off);
  a.idx = static_cast<const int*>(idx);
  a.cnt = static_cast<const int*>(cnt);
  a.st = static_cast<const float*>(st);
  a.w2 = static_cast<const __nv_bfloat16*>(w2);
  a.w3 = static_cast<const __nv_bfloat16*>(w3);
  a.out = static_cast<float*>(out);
  a.batch = batch;
  a.n = n;
  a.m = m;
  a.k = k;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PCL_LAUNCH(A, B, C, MT)                                      \
  if (c1 == A && c2 == B && c3 == C)                                 \
    return pcl::launch_eval<A, B, C, MT>(pcl::eval_kernel<A, B, C, MT>, \
                                         a, 0, s);
  PCL_EVAL_WIDTHS(PCL_LAUNCH)
#undef PCL_LAUNCH
  return cudaErrorInvalidValue;
}

// Dynamic shared memory the launch above needs (0: widths not compiled).
extern "C" long long sa_eval_smem(int c1, int c2, int c3, int k) {
#define PCL_BYTES(A, B, C, MT)       \
  if (c1 == A && c2 == B && c3 == C) \
    return (long long)pcl::EvalLayout<A, B, C, MT>::bytes(0, k);
  PCL_EVAL_WIDTHS(PCL_BYTES)
#undef PCL_BYTES
  return 0;
}
