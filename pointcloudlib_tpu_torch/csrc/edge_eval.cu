// Eval-mode fused EdgeConv from a given neighbour index, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/fused_edge.py
// (fused_edge_eval -> _ke_eval), the route DGCNN takes at N % 128 != 0
// after the standalone kNN (knn.cu). With Q = X.Wa (bf16) and
// Off = X.(Wa - Wb) (f32) computed outside and idx [B, M, k]:
//   out[b, i, c] = max over kk of
//       leaky(sc[c] * (float(Q[b, idx[b, i, kk], c]) - Off[b, i, c]) + bi[c])
// with (sc, bi) the folded BatchNorm rows of the running statistics. No
// per-edge tensor reaches device memory.
//
// The TPU kernel gathers Q with a one-hot product; here each neighbour's
// Q row is read by index from L2 (a cloud's Q is 5 MB at DGCNN's layer 4
// at N = 10,000). It is edge_knn_eval.cu with the selection replaced by
// the block's slice of idx, staged in shared memory in the selection's
// layout: the row pass (edge_eval_rows in edge_knn.cuh) is the same code.
//
// What bounds it: bytes. It reads idx, Off and Q's rows once each
// (k reads of a Q row, most of them from L2) and writes out, against 5
// operations an edge element.
//
// Numerics: the gather, BN and LeakyReLU take the plain version's rounded
// operations in its order, so out is bit-identical to it.

#include "edge_knn.cuh"

namespace pcl {

__global__ void __launch_bounds__(kThreads)
    edge_eval_kernel(const __nv_bfloat16* __restrict__ q,
                     const int* __restrict__ idx,
                     const float* __restrict__ off,
                     const float* __restrict__ st, float* __restrict__ out,
                     int m, int n, int c, int k, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* nbr = reinterpret_cast<int*>(smem);  // [k][kKnnQ]
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kKnnQ;
  const int nq = min(kKnnQ, m - q0);
  load_nbr(idx + (size_t)b * m * k, q0, nq, k, nbr);
  const size_t mb = (size_t)b * m * c;
  edge_eval_rows(nbr, q + (size_t)b * n * c, off + mb, st, out + mb, c, k,
                 slope, q0, nq);
}

}  // namespace pcl

// Shared memory bytes of one block for k neighbours.
extern "C" long long edge_eval_smem(int k) {
  return 4LL * (long long)k * pcl::kKnnQ;
}

// q [b, n, c] bf16, idx [b, m, k] i32 with every entry in [0, n),
// off [b, m, c] f32, st [4, c] f32 (folded BN rows sc, bi, rs, mrs),
// out [b, m, c] f32; all contiguous. Returns the launch's
// cudaGetLastError() code, or cudaErrorInvalidValue for sizes it does not
// take (as edge_f1_launch).
extern "C" int edge_eval_launch(const void* q, const void* idx,
                                const void* off, const void* st, void* out,
                                int b, int m, int n, int c, int k, float slope,
                                void* stream) {
  if (b < 1 || m < 1 || n < 1 || k < 1 || !pcl::edge_width_ok(c))
    return cudaErrorInvalidValue;
  const long long smem = edge_eval_smem(k);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      pcl::edge_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + pcl::kKnnQ - 1) / pcl::kKnnQ, b);
  pcl::edge_eval_kernel<<<grid, pcl::kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int*>(idx),
      static_cast<const float*>(off), static_cast<const float*>(st),
      static_cast<float*>(out), m, n, c, k, slope);
  return cudaGetLastError();
}
