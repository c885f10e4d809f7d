// Row scatter-add for Hopper (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/gather.py
// (scatter_rows -> _gather_bwd_impl -> _scatter_kernel), the backward
// pass of every row gather (three_interp's d_feats among them):
//   out[b, idx[b, r], :] += g[b, r, :]   for every row r of g [B, R, C],
// out [B, n, C] zeroed by the caller; an index outside [0, n) adds
// nothing, as the TPU kernel's all-zero one-hot rows and the XLA
// route's mode="drop" do.
//
// The TPU kernel builds an [mt*k, n] one-hot tile and accumulates its
// transposed product with g across the sequential grid. Here blocks run
// in parallel, so rows are added with f32 atomics: each warp takes one
// row at a time, grid-stride, its lanes over channels, so the row of g
// is read and the target row of out is updated in coalesced 128-byte
// pieces. The atomics compile to reductions (RED.ADD.F32), resolved in
// the L2 cache.
//
// What bounds it: bytes. It reads B*R*C*4 + B*R*4 bytes and writes
// B*n*C*4, against one f32 add per element of g.
//
// Numerics: the order in which rows meet in one target changes from run
// to run, so the last bits of out do too. Any two orders of t rows
// differ by at most (t - 1) roundings of the running sum, each within
// 2^-24 of its magnitude; the interpolation backward gives a support
// point ~3M/n rows (12 on average at FP1 of part segmentation).

#include <cuda_runtime.h>
#include <stdint.h>

namespace pcl {

constexpr int kSrThreads = 256;

__global__ void __launch_bounds__(kSrThreads)
    scatter_rows_kernel(const float* __restrict__ g,
                        const int* __restrict__ idx, float* __restrict__ out,
                        long long rows_per_batch, long long rows, int n,
                        int c) {
  const int lane = threadIdx.x % 32;
  const long long warps = (long long)gridDim.x * (kSrThreads / 32);
  for (long long r = (long long)blockIdx.x * (kSrThreads / 32) +
                     threadIdx.x / 32;
       r < rows; r += warps) {
    const int t = idx[r];
    if (t < 0 || t >= n) continue;
    const long long b = r / rows_per_batch;
    float* o = out + ((size_t)b * n + t) * c;
    const float* gr = g + (size_t)r * c;
    for (int ch = lane; ch < c; ch += 32) atomicAdd(o + ch, gr[ch]);
  }
}

}  // namespace pcl

// g [b, rows_per_batch, c] f32, idx [b, rows_per_batch] i32, out
// [b, n, c] f32 already zeroed; all contiguous. Returns the launch's
// cudaGetLastError() code, or cudaErrorInvalidValue for empty sizes.
extern "C" int scatter_rows_launch(const void* g, const void* idx, void* out,
                                   int b, long long rows_per_batch, int n,
                                   int c, void* stream) {
  if (b < 1 || rows_per_batch < 1 || n < 1 || c < 1)
    return cudaErrorInvalidValue;
  const long long rows = (long long)b * rows_per_batch;
  const long long per_block = pcl::kSrThreads / 32;
  // one row a warp, at most 16 blocks an SM (the warps then stride)
  long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 132 * 16) blocks = 132 * 16;
  pcl::scatter_rows_kernel<<<(unsigned)blocks, pcl::kSrThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int*>(idx),
      static_cast<float*>(out), rows_per_batch, rows, n, c);
  return cudaGetLastError();
}
