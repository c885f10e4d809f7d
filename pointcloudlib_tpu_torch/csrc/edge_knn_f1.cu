// Train-mode fused EdgeConv, forward pass 1, with the kNN graph built
// inside, for Hopper (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/fused_edge.py
// (_call_eknn_f1 -> _ke_knn_f1). For each point i of each cloud, with
// Q = X.Wa (bf16) and Off = X.(Wa - Wb) (f32) computed outside:
//   idx [B, N, k] i32     the k nearest points j of x_i in x (self
//                          included), ascending d2, lower index on ties;
//   h [B, N, k, C] bf16   the checkpoint bf16(float(Q[b, j]) - Off[b, i]);
//   psum [2, C] f32       += [sum h, sum h^2] over all B*N*k rows, of the
//                          f32 h before its rounding (zeroed by the
//                          caller).
// The TPU kernel writes h as [k, N, C] because its round index must land
// on an untiled dimension; here rows are written in [B, N, k, C], the
// layout edge_out.cu and edge_bwd.cu read.
//
// What bounds it: operations, as edge_knn_eval.cu (the same selection,
// knn_block in edge_knn.cuh); beside it, writing h (B*N*k*C*2 bytes,
// 335 MB at layer 4 of DGCNN at B=32). The TPU kernel carries the BN
// sums across its sequential grid; here blocks run in parallel, so each
// thread keeps its channel pair's sums in registers and a block adds
// them once into shared memory, then once into psum with f32 atomics.
//
// Numerics: idx and h are bit-identical to the plain version; the sums
// are taken in another order (and the atomics' order changes from run
// to run), so psum agrees to f32 rounding of its largest element.

#include "edge_knn.cuh"

namespace pcl {

template <int KP>
__global__ void __launch_bounds__(kThreads)
    edge_knn_f1_kernel(const float* __restrict__ x,
                       const __nv_bfloat16* __restrict__ q,
                       const float* __restrict__ off, int* __restrict__ idx,
                       __nv_bfloat16* __restrict__ h,
                       float* __restrict__ psum, int n, int cin, int c,
                       int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sm = reinterpret_cast<float*>(smem);
  float* red = sm + knn_smem_words(cin, k);  // [2c] block sums
  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * c; i += kThreads) red[i] = 0.0f;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kKnnQ;
  const float* xb = x + (size_t)b * n * cin;
  const int* nbr = knn_block<KP>(xb, n, xb, n, cin, q0, k, sm);

  const int nq = min(kKnnQ, n - q0);
  int* ib = idx + ((size_t)b * n + q0) * k;
  for (int e = tid; e < nq * k; e += kThreads) {
    const int ql = e / k;
    ib[e] = nbr[(e - ql * k) * kKnnQ + ql];
  }
  const size_t cb = (size_t)b * n * c;
  edge_f1_rows(nbr, q + cb, off + cb, h + cb * k, red, c, k, q0, nq);
  __syncthreads();
  for (int i = tid; i < 2 * c; i += kThreads) atomicAdd(psum + i, red[i]);
}

template <int KP>
cudaError_t launch(const void* x, const void* q, const void* off, void* idx,
                   void* h, void* psum, int b, int n, int cin, int c, int k,
                   size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      edge_knn_f1_kernel<KP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kKnnQ - 1) / kKnnQ, b);
  edge_knn_f1_kernel<KP><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(q),
      static_cast<const float*>(off), static_cast<int*>(idx),
      static_cast<__nv_bfloat16*>(h), static_cast<float*>(psum), n, cin, c,
      k);
  return cudaGetLastError();
}

}  // namespace pcl

// Shared memory bytes of one block for input width cin, output width c
// and k neighbours.
extern "C" long long edge_knn_f1_smem(int cin, int c, int k) {
  return 4LL * ((long long)pcl::knn_smem_words(cin, k) + 2LL * c);
}

// x [b, n, cin] f32, q [b, n, c] bf16, off [b, n, c] f32; idx [b, n, k]
// i32, h [b, n, k, c] bf16, psum [2, c] f32 zeroed; all contiguous.
// Returns the launch's cudaGetLastError() code, or cudaErrorInvalidValue
// for sizes it does not take (as edge_knn_eval_launch).
extern "C" int edge_knn_f1_launch(const void* x, const void* q,
                                  const void* off, void* idx, void* h,
                                  void* psum, int b, int n, int cin, int c,
                                  int k, void* stream) {
  if (b < 1 || cin < 1 || k < 1 || k > n || k > pcl::kKnnMaxK ||
      !pcl::edge_width_ok(c))
    return cudaErrorInvalidValue;
  const long long smem = edge_knn_f1_smem(cin, c, k);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pcl::knn_list_length(k)) {
    case 8: return pcl::launch<8>(x, q, off, idx, h, psum, b, n, cin, c, k, smem, s);
    case 16: return pcl::launch<16>(x, q, off, idx, h, psum, b, n, cin, c, k, smem, s);
    case 24: return pcl::launch<24>(x, q, off, idx, h, psum, b, n, cin, c, k, smem, s);
    case 32: return pcl::launch<32>(x, q, off, idx, h, psum, b, n, cin, c, k, smem, s);
    case 40: return pcl::launch<40>(x, q, off, idx, h, psum, b, n, cin, c, k, smem, s);
    default: return cudaErrorInvalidValue;
  }
}
