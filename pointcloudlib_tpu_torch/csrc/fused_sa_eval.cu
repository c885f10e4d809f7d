// Eval-mode fused PointNet++ set abstraction from a given neighbour
// index, for Hopper (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/fused_sa.py
// (_fused_sa_eval_jit -> _k_eval). For each center, over its k slots:
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
// ball query, and shares that code (eval_stage, eval_chain): one block
// per (cloud, tile of MT centers), weights staged in shared memory, the
// tile's live rows packed densely and run 64 rows at a time, no grouped
// tensor in device memory.
//
// What bounds it: operations, 2 * live rows * (C1*C2 + C2*C3) flops on
// the CUDA cores in f32 in this first version, against q, idx, off and
// out in bytes.

#include "fused_sa_eval.cuh"

namespace pcl {

template <int C1, int C2, int C3, int MT>
__global__ void __launch_bounds__(kThreads)
    eval_kernel(const EvalArgs a, const int* idx, const int* cnt) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_live[MT];
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * MT;
  const int mt = min(MT, a.m - m0);
  const size_t center0 = (size_t)b * a.m + m0;

  eval_stage<C1, C2, C3, MT>(smem, a, b, m0, mt);
  if (threadIdx.x < mt)
    s_live[threadIdx.x] =
        cnt ? max(min(cnt[center0 + threadIdx.x], a.k), 1) : a.k;
  __syncthreads();
  eval_chain<C1, C2, C3, MT>(smem, a, b, m0, mt, idx + center0 * a.k,
                             s_live);
}

template <int C1, int C2, int C3, int MT>
cudaError_t launch(const EvalArgs& a, const int* idx, const int* cnt,
                   int batch, cudaStream_t stream) {
  constexpr size_t smem = EvalLayout<C1, C2, C3, MT>::end;
  static_assert(smem <= 227 * 1024, "shared memory of one block");
  cudaError_t err = cudaFuncSetAttribute(
      eval_kernel<C1, C2, C3, MT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.m + MT - 1) / MT, batch);
  eval_kernel<C1, C2, C3, MT><<<grid, kThreads, smem, stream>>>(a, idx, cnt);
  return cudaGetLastError();
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
  pcl::EvalArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.off = static_cast<const float*>(off);
  a.st = static_cast<const float*>(st);
  a.w2 = static_cast<const __nv_bfloat16*>(w2);
  a.w3 = static_cast<const __nv_bfloat16*>(w3);
  a.out = static_cast<float*>(out);
  a.n = n;
  a.m = m;
  a.k = k;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PCL_LAUNCH(A, B, C, MT)                                      \
  if (c1 == A && c2 == B && c3 == C)                                 \
    return pcl::launch<A, B, C, MT>(a, static_cast<const int*>(idx), \
                                    static_cast<const int*>(cnt), batch, s);
  PCL_EVAL_WIDTHS(PCL_LAUNCH)
#undef PCL_LAUNCH
  return cudaErrorInvalidValue;
}
