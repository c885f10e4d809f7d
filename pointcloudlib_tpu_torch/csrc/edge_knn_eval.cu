// Eval-mode fused EdgeConv with the kNN graph built inside, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/fused_edge.py
// (_fused_edge_eval_knn_jit -> _ke_knn_eval). One DGCNN EdgeConv in
// eval mode, with Q = X.Wa (bf16) and Off = X.(Wa - Wb) (f32) computed
// outside:
//   out[b, i, c] = max over the k nearest j of x_i in x of
//                  leaky(sc[c] * (float(Q[b, j, c]) - Off[b, i, c]) + bi[c])
// with (sc, bi) the folded BatchNorm rows of the running statistics. No
// per-edge tensor reaches device memory.
//
// What bounds it: operations. The selection forms d2 for all B*N^2
// (query, point) pairs at 2*cin + 3 f32 operations each (33.5 M pairs a
// layer at B=32, N=1024), against reading x, Q and Off once and writing
// out. The design: knn_block (edge_knn.cuh) streams the candidates
// through shared memory in 64-point tiles with 4 x 4 register tiles of
// products and walks each tile with four threads a query, keeping sorted
// lists in registers; the gather then reads each neighbour's Q row from
// L2 (a cloud's Q is at most 512 KB), one channel pair a thread, so a
// warp reads a row in 128-byte pieces, and keeps a running max in
// registers.
//
// Numerics: the neighbour list is bit-identical to the plain version's;
// the gather, BN and LeakyReLU take the plain version's rounded
// operations in its order, so out is bit-identical too.

#include "edge_knn.cuh"

namespace pcl {

template <int KP>
__global__ void __launch_bounds__(kThreads)
    edge_knn_eval_kernel(const float* __restrict__ x,
                         const __nv_bfloat16* __restrict__ q,
                         const float* __restrict__ off,
                         const float* __restrict__ st,
                         float* __restrict__ out, int n, int cin, int c,
                         int k, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kKnnQ;
  const float* xb = x + (size_t)b * n * cin;
  const int* nbr = knn_block<KP>(xb, n, xb, n, cin, q0, k,
                                 reinterpret_cast<float*>(smem));
  const size_t cb = (size_t)b * n * c;
  edge_eval_rows(nbr, q + cb, off + cb, st, out + cb, c, k, slope, q0,
                 min(kKnnQ, n - q0));
}

template <int KP>
cudaError_t launch(const void* x, const void* q, const void* off,
                   const void* st, void* out, int b, int n, int cin, int c,
                   int k, float slope, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      edge_knn_eval_kernel<KP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kKnnQ - 1) / kKnnQ, b);
  edge_knn_eval_kernel<KP><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(q),
      static_cast<const float*>(off), static_cast<const float*>(st),
      static_cast<float*>(out), n, cin, c, k, slope);
  return cudaGetLastError();
}

}  // namespace pcl

// Shared memory bytes of one block for input width cin and k neighbours.
extern "C" long long edge_knn_eval_smem(int cin, int k) {
  return 4LL * (long long)pcl::knn_smem_words(cin, k);
}

// x [b, n, cin] f32, q [b, n, c] bf16, off [b, n, c] f32, st [4, c] f32
// (folded BN rows sc, bi, rs, mrs), out [b, n, c] f32; all contiguous.
// Returns the launch's cudaGetLastError() code, or cudaErrorInvalidValue
// for sizes it does not take (k > n, k > 40, an odd c or one whose
// channel pairs do not divide the block, too much shared memory).
extern "C" int edge_knn_eval_launch(const void* x, const void* q,
                                    const void* off, const void* st,
                                    void* out, int b, int n, int cin, int c,
                                    int k, float slope, void* stream) {
  if (b < 1 || cin < 1 || k < 1 || k > n || k > pcl::kKnnMaxK ||
      !pcl::edge_width_ok(c))
    return cudaErrorInvalidValue;
  const long long smem = edge_knn_eval_smem(cin, k);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pcl::knn_list_length(k)) {
    case 8: return pcl::launch<8>(x, q, off, st, out, b, n, cin, c, k, slope, smem, s);
    case 16: return pcl::launch<16>(x, q, off, st, out, b, n, cin, c, k, slope, smem, s);
    case 24: return pcl::launch<24>(x, q, off, st, out, b, n, cin, c, k, slope, smem, s);
    case 32: return pcl::launch<32>(x, q, off, st, out, b, n, cin, c, k, slope, smem, s);
    case 40: return pcl::launch<40>(x, q, off, st, out, b, n, cin, c, k, slope, smem, s);
    default: return cudaErrorInvalidValue;
  }
}
