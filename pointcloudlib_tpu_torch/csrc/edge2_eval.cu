// Eval-mode two-layer EdgeConv from a given neighbour index, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/fused_edge.py
// (fused_edge2_eval -> _ke2_eval), the route DGCNN part segmentation
// takes at N % 128 != 0 after the standalone kNN (knn.cu). With
// Q = X.Wa (bf16) and Off = X.(Wa - Wb) (f32) computed outside and
// idx [B, M, k]:
//   out[b, i, c] = max over kk of leaky(BN2(bf16(leaky(BN1(
//       float(Q[b, idx[b, i, kk]]) - Off[b, i]))) . W2))[c]
// with the folded BN rows of the running statistics. No per-edge tensor
// reaches device memory.
//
// The TPU kernel gathers Q with a one-hot product; here a block stages
// its 64 queries' slice of idx in shared memory (load_nbr, as
// edge_eval.cu) and walks their k slots, gathering one Q row per query
// and slot from L2 into the y1 tile of edge2.cuh, then the product with
// W2 (staged once per block) and a running max in registers.
//
// What bounds it: the product, 2*C1*C2 flops an edge on the CUDA cores
// in f32, against reading idx, Off and Q's rows and writing out.
//
// Numerics: y1 is bit-identical to the plain version; h2 sums in another
// order, so out agrees to f32 rounding of the product.

#include "edge2.cuh"

namespace pcl {

template <int C1, int C2>
__global__ void __launch_bounds__(kThreads)
    edge2_eval_kernel(const __nv_bfloat16* __restrict__ q,
                      const int* __restrict__ idx,
                      const float* __restrict__ off,
                      const float* __restrict__ st,
                      const __nv_bfloat16* __restrict__ w2,
                      float* __restrict__ out, int m, int n, int k,
                      float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Edge2Smem<C1, C2> s(smem);
  int* nbr = reinterpret_cast<int*>(smem + Edge2Layout<C1, C2>::bytes);
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kKnnQ;
  const int nq = min(kKnnQ, m - q0);
  stage_chain(s, w2, st);
  load_nbr(idx + (size_t)b * m * k, q0, nq, k, nbr);
  gather_max(s, nbr, q + (size_t)b * n * C1, off + (size_t)b * m * C1,
             out + (size_t)b * m * C2, q0, nq, k, slope);
}

template <int C1, int C2>
cudaError_t launch_eval2(const void* q, const void* idx, const void* off,
                         const void* st, const void* w2, void* out, int b,
                         int m, int n, int k, float slope, size_t smem,
                         cudaStream_t stream) {
  auto kernel = edge2_eval_kernel<C1, C2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + kKnnQ - 1) / kKnnQ, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int*>(idx),
      static_cast<const float*>(off), static_cast<const float*>(st),
      static_cast<const __nv_bfloat16*>(w2), static_cast<float*>(out), m, n,
      k, slope);
  return cudaGetLastError();
}

}  // namespace pcl

// Shared memory bytes of one block for k neighbours: the chain's (the
// compiled widths' largest) and the neighbour lists.
extern "C" long long edge2_eval_smem(int k) {
  return (long long)pcl::Edge2Layout<64, 64>::bytes +
         4LL * (long long)k * pcl::kKnnQ;
}

// q [b, n, c1] bf16, idx [b, m, k] i32 with every entry in [0, n),
// off [b, m, c1] f32, st [4*c1 + 4*c2] f32 (the folded rows of both
// layers), w2 [c1, c2] bf16, out [b, m, c2] f32; all contiguous and
// 16-byte aligned. Returns the launch's cudaGetLastError() code, or
// cudaErrorInvalidValue for widths not compiled (PCL_EDGE2_WIDTHS), an
// empty size or too much shared memory.
extern "C" int edge2_eval_launch(const void* q, const void* idx,
                                 const void* off, const void* st,
                                 const void* w2, void* out, int b, int m,
                                 int n, int c1, int c2, int k, float slope,
                                 void* stream) {
  if (b < 1 || m < 1 || n < 1 || k < 1) return cudaErrorInvalidValue;
  const long long smem = edge2_eval_smem(k);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PCL_LAUNCH(A, B)                                                   \
  if (c1 == A && c2 == B)                                                  \
    return pcl::launch_eval2<A, B>(q, idx, off, st, w2, out, b, m, n, k, \
                                   slope, (size_t)smem, s);
  PCL_EDGE2_WIDTHS(PCL_LAUNCH)
#undef PCL_LAUNCH
  return cudaErrorInvalidValue;
}
