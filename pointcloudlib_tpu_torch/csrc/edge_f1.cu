// Train-mode fused EdgeConv, forward pass 1, from a given neighbour index,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/fused_edge.py
// (_call_ef1 -> _ke_f1), the route DGCNN takes at N % 128 != 0 after the
// standalone kNN (knn.cu). For each row i of each cloud, with Q = X.Wa
// (bf16) and Off = X.(Wa - Wb) (f32) computed outside and idx [B, M, k]:
//   h [B, M, k, C] bf16   the checkpoint bf16(float(Q[b, idx]) - Off[b, i]);
//   psum [2, C] f32       += [sum h, sum h^2] over all B*M*k rows, of the
//                          f32 h before its rounding (zeroed by the
//                          caller).
// The TPU kernel gathers Q with a one-hot product; here each neighbour's
// Q row is read by index from L2. It is edge_knn_f1.cu with the selection
// replaced by the block's slice of idx, staged in shared memory in the
// selection's layout: the row pass (edge_f1_rows in edge_knn.cuh) is the
// same code. edge_out.cu and edge_bwd.cu read its h.
//
// What bounds it: bytes. Writing h (B*M*k*C*2 bytes, 328 MB at DGCNN's
// layer 4 at B=32, N=1,000) against 4 operations an element. Blocks run
// in parallel, so each thread keeps its channel pair's sums in registers
// and a block adds them once into shared memory, then once into psum with
// f32 atomics.
//
// Numerics: h is bit-identical to the plain version; the sums are taken
// in another order (and the atomics' order changes from run to run), so
// psum agrees to f32 rounding of its largest element.

#include "edge_knn.cuh"

namespace pcl {

__global__ void __launch_bounds__(kThreads)
    edge_f1_kernel(const __nv_bfloat16* __restrict__ q,
                   const int* __restrict__ idx, const float* __restrict__ off,
                   __nv_bfloat16* __restrict__ h, float* __restrict__ psum,
                   int m, int n, int c, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* nbr = reinterpret_cast<int*>(smem);                   // [k][kKnnQ]
  float* red = reinterpret_cast<float*>(nbr + k * kKnnQ);  // [2c]
  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * c; i += kThreads) red[i] = 0.0f;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kKnnQ;
  const int nq = min(kKnnQ, m - q0);
  load_nbr(idx + (size_t)b * m * k, q0, nq, k, nbr);
  const size_t mb = (size_t)b * m * c;
  edge_f1_rows(nbr, q + (size_t)b * n * c, off + mb, h + mb * k, red, c, k,
               q0, nq);
  __syncthreads();
  for (int i = tid; i < 2 * c; i += kThreads) atomicAdd(psum + i, red[i]);
}

}  // namespace pcl

// Shared memory bytes of one block for width c and k neighbours.
extern "C" long long edge_f1_smem(int c, int k) {
  return 4LL * ((long long)k * pcl::kKnnQ + 2LL * c);
}

// q [b, n, c] bf16, idx [b, m, k] i32 with every entry in [0, n),
// off [b, m, c] f32; h [b, m, k, c] bf16, psum [2, c] f32 zeroed; all
// contiguous. Returns the launch's cudaGetLastError() code, or
// cudaErrorInvalidValue for sizes it does not take (an odd c or one whose
// channel pairs do not divide the block, too much shared memory).
extern "C" int edge_f1_launch(const void* q, const void* idx, const void* off,
                              void* h, void* psum, int b, int m, int n, int c,
                              int k, void* stream) {
  if (b < 1 || m < 1 || n < 1 || k < 1 || !pcl::edge_width_ok(c))
    return cudaErrorInvalidValue;
  const long long smem = edge_f1_smem(c, k);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      pcl::edge_f1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + pcl::kKnnQ - 1) / pcl::kKnnQ, b);
  pcl::edge_f1_kernel<<<grid, pcl::kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int*>(idx),
      static_cast<const float*>(off), static_cast<__nv_bfloat16*>(h),
      static_cast<float*>(psum), m, n, c, k);
  return cudaGetLastError();
}
