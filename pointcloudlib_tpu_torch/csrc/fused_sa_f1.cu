// Train-mode fused set abstraction, forward pass 1 from a given
// neighbour index, for Hopper (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/fused_sa.py
// (_call_f1 -> _k_f1). For every grouped row (b, center, slot), replicas
// included:
//   h1 = float(bf16 Q[b, idx[b, center, slot]]) - off[b, center]   (f32)
// writes h1 [B, M, k, C1] bf16 and adds [sum h1, sum h1^2] over all
// rows, taken on the f32 h1 before its rounding, into psum [2, C1]
// (zeroed by the caller).
//
// The TPU kernel gathers with a one-hot matmul; here a thread reads its
// channel pair of the indexed row directly. This is the second half of
// the ball-query pass-1 kernel (fused_sa_bq_f1.cu) and shares its code
// (f1_rows): one block per (cloud, kF1Centers centers), neighbours read
// from global memory.
//
// What bounds it: bytes. It reads the gathered rows of q (rows*C1*2
// bytes, mostly from L2: a cloud's q is N*C1*2 bytes), idx and off, and
// writes h1 (rows*C1*2 bytes); 4 f32 operations per element.
//
// Numerics: one f32 subtraction and one rounding per element,
// bit-identical to the plain version; the sums are f32 in another order
// (atomics), within 1e-3 relative.

#include "fused_sa_common.cuh"

namespace pcl {

constexpr int kF1Centers = 32;  // centers per block

template <int C1>
__global__ void __launch_bounds__(kThreads)
    f1_kernel(const __nv_bfloat16* q, const float* off, const int* idx,
              __nv_bfloat16* h1, float* psum, int n, int m, int k) {
  __shared__ float red[2 * C1];
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kF1Centers;
  const int mt = min(kF1Centers, m - m0);
  for (int i = threadIdx.x; i < 2 * C1; i += kThreads) red[i] = 0.0f;
  __syncthreads();
  const size_t center0 = (size_t)b * m + m0;
  f1_rows<C1>(q + (size_t)b * n * C1, off + center0 * C1,
              h1 + center0 * k * C1, idx + center0 * k, mt * k, k, red,
              psum);
}

template <int C1>
cudaError_t launch_f1(const void* q, const void* off, const void* idx,
                      void* h1, void* psum, int batch, int n, int m, int k,
                      cudaStream_t stream) {
  const dim3 grid((m + kF1Centers - 1) / kF1Centers, batch);
  f1_kernel<C1><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const float*>(off),
      static_cast<const int*>(idx), static_cast<__nv_bfloat16*>(h1),
      static_cast<float*>(psum), n, m, k);
  return cudaGetLastError();
}

}  // namespace pcl

// Widths compiled: C1 = 32, 64 and 128. Every idx must lie in [0, n).
// Returns the launch's cudaGetLastError() code, or cudaErrorInvalidValue
// for what it does not take.
extern "C" int sa_f1_launch(const void* q, const void* off, const void* idx,
                            void* h1, void* psum, int batch, int n, int m,
                            int c1, int k, void* stream) {
  if (batch < 1 || n < 1 || m < 1 || k < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c1 == 32)
    return pcl::launch_f1<32>(q, off, idx, h1, psum, batch, n, m, k, s);
  if (c1 == 64)
    return pcl::launch_f1<64>(q, off, idx, h1, psum, batch, n, m, k, s);
  if (c1 == 128)
    return pcl::launch_f1<128>(q, off, idx, h1, psum, batch, n, m, k, s);
  return cudaErrorInvalidValue;
}
