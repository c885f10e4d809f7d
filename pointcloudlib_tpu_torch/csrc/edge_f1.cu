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
// Q row is read by index from L2. edge_out.cu and edge_bwd.cu read its h.
// Two routes, chosen by the wrapper from C (fused_edge.py
// edge_f1_route):
// - center (C = 64, 128 and 256, DGCNN's widths): the set abstraction's
//   given-index pass 1 (fused_sa_f1.cuh f1_idx_walk; its h1 is this h),
//   one wave of resident blocks whose warps walk the rows, a row a warp:
//   the row's idx slice by one vector load a lane into shared memory,
//   then f1_center: 8 channels a lane, 16-byte gathers of Q with
//   kF1Unroll in flight, 16-byte streaming stores of h, the sums in
//   registers over all of a lane's rows, folded once a block;
// - rows (every other width edge_width_ok takes): the first version, the
//   block's slice of idx staged by load_nbr in the selection's layout,
//   then edge_f1_rows (edge_knn.cuh), one thread a channel pair with
//   4-byte gathers and stores.
//
// What bounds it: bytes. Writing h (B*M*k*C*2 bytes, 328 MB at DGCNN's
// layer 4 at B=32, N=1,000) against 4 operations an element. The rows
// route kept one 4-byte gather in flight a thread behind a block-wide
// load_nbr; the center route has 16-byte ones, kF1Unroll a lane.
//
// Numerics: h is bit-identical to the plain version; the sums are taken
// in another order (the atomics' order changes from run to run, and the
// center route adds the copies of a row's slot 0 as a count times slot
// 0's h), so psum agrees to f32 rounding of its largest element.

#include "edge_knn.cuh"
#include "fused_sa_f1.cuh"

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

template <int C>
__global__ void __launch_bounds__(kThreads, kF1MinBlocks)
    edge_f1_center_kernel(const __nv_bfloat16* q, const float* off,
                          const int* idx, __nv_bfloat16* h, float* psum,
                          int n, int m, int k, long long rows) {
  f1_idx_walk<C>(q, off, idx, h, psum, n, m, k, rows);
}

}  // namespace pcl

// Shared memory bytes of one block for width c and k neighbours on route
// 0 (rows) or 1 (center).
extern "C" long long edge_f1_smem(int c, int k, int route) {
  if (route == 1) return (long long)pcl::f1_idx_smem(k, c);
  return 4LL * ((long long)k * pcl::kKnnQ + 2LL * c);
}

// q [b, n, c] bf16, idx [b, m, k] i32 with every entry in [0, n),
// off [b, m, c] f32; h [b, m, k, c] bf16, psum [2, c] f32 zeroed; all
// contiguous, 16-byte aligned on route 1. Route 0 (rows) takes an even c
// whose channel pairs divide the block, route 1 (center) c = 64, 128 or
// 256. Returns the launch's cudaGetLastError() code, or
// cudaErrorInvalidValue for what the route does not take (another width,
// too much shared memory).
extern "C" int edge_f1_launch(const void* q, const void* idx, const void* off,
                              void* h, void* psum, int b, int m, int n, int c,
                              int k, int route, void* stream) {
  if (b < 1 || m < 1 || n < 1 || k < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (c == 64)
      return pcl::launch_f1_idx<64>(pcl::edge_f1_center_kernel<64>, q, off,
                                    idx, h, psum, b, n, m, k, s);
    if (c == 128)
      return pcl::launch_f1_idx<128>(pcl::edge_f1_center_kernel<128>, q,
                                     off, idx, h, psum, b, n, m, k, s);
    if (c == 256)
      return pcl::launch_f1_idx<256>(pcl::edge_f1_center_kernel<256>, q,
                                     off, idx, h, psum, b, n, m, k, s);
    return cudaErrorInvalidValue;
  }
  if (route != 0 || !pcl::edge_width_ok(c)) return cudaErrorInvalidValue;
  const long long smem = edge_f1_smem(c, k, 0);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      pcl::edge_f1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + pcl::kKnnQ - 1) / pcl::kKnnQ, b);
  pcl::edge_f1_kernel<<<grid, pcl::kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int*>(idx),
      static_cast<const float*>(off), static_cast<__nv_bfloat16*>(h),
      static_cast<float*>(psum), m, n, c, k);
  return cudaGetLastError();
}
