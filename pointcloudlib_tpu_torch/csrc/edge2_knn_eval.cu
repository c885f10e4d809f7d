// Eval-mode two-layer EdgeConv with the kNN graph built inside, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/fused_edge.py
// (_fused_edge2_eval_knn_jit -> _ke2_knn_eval). DGCNN part
// segmentation's EdgeConv pairs in eval mode, with Q = X.Wa (bf16) and
// Off = X.(Wa - Wb) (f32) computed outside:
//   out[b, i, c] = max over the k nearest j of x_i in x of
//       leaky(BN2(bf16(leaky(BN1(float(Q[b, j]) - Off[b, i]))) . W2))[c]
// with the folded BN rows of the running statistics. No per-edge tensor
// reaches device memory.
//
// The TPU kernel runs k masked argmins over a [mt, n] distance tile and
// the chain after each; here knn_block (edge_knn.cuh) selects a block's
// 64 queries' lists as edge_knn_eval.cu does (64-point candidate tiles,
// four walkers a query with sorted lists in registers), and the chain of
// edge2.cuh then walks the lists slot by slot (gather_max).
//
// What bounds it: operations. The selection forms d2 for all B*N^2
// pairs at 2*cin + 3 f32 operations each, and the chain is 2*C1*C2 flops
// an edge on the CUDA cores in f32 (10.7 GFLOP a layer at B=16, N=2048,
// k=40).
//
// Numerics: the neighbour lists are bit-identical to the plain
// version's (ascending d2, the lower index first on ties), y1 too; h2
// sums in another order, so out agrees to f32 rounding of the product.

#include "edge2.cuh"

namespace pcl {

__host__ __device__ inline size_t knn_bytes(int cin, int k) {
  return (4 * knn_smem_words(cin, k) + 15) / 16 * 16;
}

template <int KP, int C1, int C2>
__global__ void __launch_bounds__(kThreads)
    edge2_knn_eval_kernel(const float* __restrict__ x,
                          const __nv_bfloat16* __restrict__ q,
                          const float* __restrict__ off,
                          const float* __restrict__ st,
                          const __nv_bfloat16* __restrict__ w2,
                          float* __restrict__ out, int n, int cin, int k,
                          float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Edge2Smem<C1, C2> s(smem + knn_bytes(cin, k));
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kKnnQ;
  const float* xb = x + (size_t)b * n * cin;
  stage_chain(s, w2, st);
  const int* nbr = knn_block<KP>(xb, n, xb, n, cin, q0, k,
                                 reinterpret_cast<float*>(smem));
  const size_t cb = (size_t)b * n;
  gather_max(s, nbr, q + cb * C1, off + cb * C1, out + cb * C2, q0,
             min(kKnnQ, n - q0), k, slope);
}

template <int KP, int C1, int C2>
cudaError_t launch_knn_eval2(const void* x, const void* q, const void* off,
                             const void* st, const void* w2, void* out,
                             int b, int n, int cin, int k, float slope,
                             size_t smem, cudaStream_t stream) {
  auto kernel = edge2_knn_eval_kernel<KP, C1, C2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kKnnQ - 1) / kKnnQ, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(q),
      static_cast<const float*>(off), static_cast<const float*>(st),
      static_cast<const __nv_bfloat16*>(w2), static_cast<float*>(out), n,
      cin, k, slope);
  return cudaGetLastError();
}

template <int C1, int C2>
cudaError_t launch_widths(const void* x, const void* q, const void* off,
                          const void* st, const void* w2, void* out, int b,
                          int n, int cin, int k, float slope, size_t smem,
                          cudaStream_t s) {
  switch (knn_list_length(k)) {
#define PCL_CASE(KP) \
  case KP:           \
    return launch_knn_eval2<KP, C1, C2>(x, q, off, st, w2, out, b, n, cin, k, slope, smem, s);
    PCL_CASE(8)
    PCL_CASE(16)
    PCL_CASE(24)
    PCL_CASE(32)
    PCL_CASE(40)
#undef PCL_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace pcl

// Shared memory bytes of one block for input width cin and k neighbours:
// the selection's and the chain's (the compiled widths' largest).
extern "C" long long edge2_knn_eval_smem(int cin, int k) {
  return (long long)pcl::knn_bytes(cin, k) +
         (long long)pcl::Edge2Layout<64, 64>::bytes;
}

// x [b, n, cin] f32, q [b, n, c1] bf16, off [b, n, c1] f32, st
// [4*c1 + 4*c2] f32 (the folded rows of both layers), w2 [c1, c2] bf16,
// out [b, n, c2] f32; all contiguous and 16-byte aligned. Returns the
// launch's cudaGetLastError() code, or cudaErrorInvalidValue for sizes it
// does not take (k > n, k > 40, widths not compiled, too much shared
// memory).
extern "C" int edge2_knn_eval_launch(const void* x, const void* q,
                                     const void* off, const void* st,
                                     const void* w2, void* out, int b, int n,
                                     int cin, int c1, int c2, int k,
                                     float slope, void* stream) {
  if (b < 1 || cin < 1 || k < 1 || k > n || k > pcl::kKnnMaxK)
    return cudaErrorInvalidValue;
  const long long smem = edge2_knn_eval_smem(cin, k);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PCL_LAUNCH(A, B)                                                      \
  if (c1 == A && c2 == B)                                                     \
    return pcl::launch_widths<A, B>(x, q, off, st, w2, out, b, n, cin, k,    \
                                    slope, (size_t)smem, s);
  PCL_EDGE2_WIDTHS(PCL_LAUNCH)
#undef PCL_LAUNCH
  return cudaErrorInvalidValue;
}
