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
// What bounds it: operations, the product's 2*C1*C2 bf16 flops an edge
// (5.2 GFLOP at B=16, M=1,000, k=40: 0.005 ms on the tensor cores) and 8
// f32 operations an element of y1 and y2, against reading idx, Off and
// Q's rows (from L2: Q is 2 MB at that size) and writing out.
//
// A block of two warpgroups takes kE2EvalTiles tiles of kRows = 64
// centers of one cloud, two blocks an SM. It loads its slice of idx
// slot-major into shared memory (slot kk of center r at nbr[kk * Q + r]),
// then runs edge2_knn_eval.cu's select route after its walk
// (edge2_wgmma.cuh eval_tiles): h2 = y1 . W2 by wgmma while the next
// slot's y1 is staged from 16-byte gathers of Q, max leaky(BN2(h2)) in
// the accumulator fragment's fixed rows and channels, one barrier a step.
// Built for the two-layer widths the port compiles (C1 = C2 = 64,
// ops/kernels/fused_edge.py EDGE2_WIDTHS).
//
// Numerics: y1 is bit-identical to the plain version; h2 sums in another
// order (the tensor cores' f32 sums of the exact bf16 products), so out
// agrees to f32 rounding of the product.

#include "edge2_wgmma.cuh"

namespace pcl {

constexpr int kE2EvalTiles = 1;  // tiles of kRows centers a block

// Shared memory of a block, byte offsets: the lists [k][Q] (i32),
// W2 (core-matrix [C1, C2]) and two y1 tiles [kRows, C1] (core-matrix).
template <int C1, int C2>
struct E2EvalLayout {
  static constexpr int Q = kE2EvalTiles * kRows;
  __host__ __device__ static size_t w2(int k) {
    return ((size_t)4 * Q * k + 127) / 128 * 128;
  }
  __host__ __device__ static size_t ys(int k) {
    return w2(k) + (size_t)2 * C1 * C2;
  }
  __host__ __device__ static size_t bytes(int k) {
    return ys(k) + (size_t)2 * kRows * C1 * 2;
  }
};

template <int C1, int C2>
__global__ void __launch_bounds__(kThreads, 2)
    edge2_eval_kernel(const __nv_bfloat16* __restrict__ q,
                      const int* __restrict__ idx,
                      const float* __restrict__ off,
                      const float* __restrict__ st,
                      const __nv_bfloat16* __restrict__ w2,
                      float* __restrict__ out, int m, int n, int k,
                      float slope) {
  using L = E2EvalLayout<C1, C2>;
  constexpr int Q = L::Q;
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.y, q0 = blockIdx.x * Q;
  const int nq = min(Q, m - q0);
  const size_t row0 = (size_t)b * m + q0;
  // the lists slot-major, each thread on the next center (no bank
  // conflicts; the block's idx rows are one 4 k Q-byte span)
  int* nbr = reinterpret_cast<int*>(smem);
  const int* ib = idx + row0 * k;
  for (int e = threadIdx.x; e < nq * k; e += kThreads) {
    const int kk = e / nq, ql = e - kk * nq;
    nbr[kk * Q + ql] = __ldg(ib + (size_t)ql * k + kk);
  }
  __syncthreads();
  eval_tiles<kE2EvalTiles, C1, C2>(
      nbr, nq, k, q + (size_t)b * n * C1, off + row0 * C1, out + row0 * C2,
      st, w2, reinterpret_cast<__nv_bfloat16*>(smem + L::w2(k)),
      reinterpret_cast<__nv_bfloat16*>(smem + L::ys(k)), slope);
}

}  // namespace pcl

// Shared memory bytes of one block for k neighbours.
extern "C" long long edge2_eval_smem(int k) {
  return (long long)pcl::E2EvalLayout<64, 64>::bytes(k);
}

// q [b, n, c1] bf16, idx [b, m, k] i32 with every entry in [0, n),
// off [b, m, c1] f32, st [4*c1 + 4*c2] f32 (the folded rows of both
// layers), w2 [c1, c2] bf16, out [b, m, c2] f32; all contiguous and
// 16-byte aligned. Returns the launch's cudaGetLastError() code, or
// cudaErrorInvalidValue for widths other than c1 = c2 = 64, an empty
// size or too much shared memory.
extern "C" int edge2_eval_launch(const void* q, const void* idx,
                                 const void* off, const void* st,
                                 const void* w2, void* out, int b, int m,
                                 int n, int c1, int c2, int k, float slope,
                                 void* stream) {
  if (b < 1 || m < 1 || n < 1 || k < 1 || c1 != 64 || c2 != 64)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)edge2_eval_smem(k);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  const auto kernel = pcl::edge2_eval_kernel<64, 64>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int rows = pcl::E2EvalLayout<64, 64>::Q;
  const dim3 grid((m + rows - 1) / rows, b);
  kernel<<<grid, pcl::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int*>(idx),
      static_cast<const float*>(off), static_cast<const float*>(st),
      static_cast<const __nv_bfloat16*>(w2), static_cast<float*>(out), m, n,
      k, slope);
  return cudaGetLastError();
}
