// Standalone ball query for Hopper (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/neighbors.py
// (_ball_query_pallas_jit -> _ball_query_kernel). For each center, the
// first k source points in index order with
//   d2 = max((|c|^2 - 2 c.p) + |p|^2, 0) < r^2
// go to idx [B, M, k] int32; slots past min(cnt, k) repeat slot 0, a row
// with no hit is all 0; cnt [B, M] int32 counts every hit, also beyond k.
//
// The TPU kernel ranks hits with a cumulative sum built from triangular
// matmuls and extracts one slot at a time, because its compiler has no
// scan. Here one warp per center walks the cloud 32 points a step: a
// ballot marks the hits, the popcount of the lower lanes ranks them in
// index order (bq_scan, shared with the fused kernels that run the same
// query inside). The cloud is staged in shared memory once per tile of
// kBqCenters centers; idx is written straight to global memory.
//
// What bounds it: operations. It reads B*(M+N)*12 bytes and writes
// B*M*(k+1)*4, against ~10 f32 operations for each of the B*M*N
// (center, point) pairs.
//
// Numerics: the distance uses explicit round-to-nearest multiplies and
// adds in the plain version's order (no FMA contraction), so idx and cnt
// are bit-identical to geometry.ball_query.

#include "fused_sa_common.cuh"

namespace pcl {

constexpr int kBqCenters = 32;  // centers per block

__global__ void __launch_bounds__(kThreads)
    ball_query_kernel(const float* new_xyz, const float* pts, int* idx,
                      int* cnt, int n, int m, int k, float r2) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* ptss = reinterpret_cast<float4*>(smem);
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kBqCenters;
  const int mt = min(kBqCenters, m - m0);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  stage_cloud(pts + (size_t)b * n * 3, n, ptss, threadIdx.x, kThreads);
  __syncthreads();

  for (int c = warp; c < mt; c += kWarps) {
    const size_t center = (size_t)b * m + m0 + c;
    int* row = idx + center * k;
    const int count =
        bq_scan(new_xyz + center * 3, ptss, n, k, r2, lane, row);
    bq_fill(row, count, k, lane);
    if (lane == 0) cnt[center] = count;
  }
}

}  // namespace pcl

// Returns the launch's cudaGetLastError() code, or cudaErrorInvalidValue
// for sizes it does not take (the cloud must fit one block's shared
// memory: 16 bytes a point).
extern "C" int ball_query_launch(const void* new_xyz, const void* pts,
                                 void* idx, void* cnt, int batch, int n,
                                 int m, int k, float r2, void* stream) {
  if (batch < 1 || n < 1 || m < 1 || k < 1) return cudaErrorInvalidValue;
  const size_t smem = (size_t)n * 16;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      pcl::ball_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + pcl::kBqCenters - 1) / pcl::kBqCenters, batch);
  pcl::ball_query_kernel<<<grid, pcl::kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(new_xyz), static_cast<const float*>(pts),
      static_cast<int*>(idx), static_cast<int*>(cnt), n, m, k, r2);
  return cudaGetLastError();
}
