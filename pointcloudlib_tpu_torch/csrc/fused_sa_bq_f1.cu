// Train-mode fused set abstraction, forward pass 1, for Hopper (sm_90a):
// ball query + gather + the bf16 h1 checkpoint + the BN sums of h1.
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/fused_sa.py
// (_call_bqf1 -> _k_bqf1). For each center:
//   ball query: the first k source points in index order with
//     d2 = max((|c|^2 - 2 c.p) + |p|^2, 0) < r^2, cnt = all hits;
//     slots past min(cnt, k) repeat slot 0, a row with no hit is all 0;
//   for every slot j < k (replicas included):
//     h1[j] = float(bf16 Q[b, idx_j]) - off[b, center]   (f32)
//   writes idx [B, M, k] int32, cnt [B, M] int32, h1 [B, M, k, C1] bf16
//   (row-major: the TPU's slot-major layout only avoided an XLA
//   transpose) and adds [sum h1, sum h1^2] over all rows, taken on the
//   f32 h1 before its rounding, into psum [2, C1] (zeroed by the caller).
//
// What bounds it: bytes. It reads q, off and the clouds once and writes
// h1 (2 * B*M*k*C1 bytes, 268 MB at the SA1 train shape), idx and cnt;
// the distance tests are ~10 f32 operations per (center, point). The
// design:
// - a block stages its cloud in shared memory once (stage_cloud) behind
//   one barrier; the only other barrier is before the block's sums;
// - then each warp owns a center end to end: it scans the cloud 128
//   points a step (a ballot gives the in-order ranks of the hits;
//   bq_scan, shared with the standalone ball query and the eval kernel),
//   pads the row (bq_fill), writes its idx row and cnt and at once that
//   center's k rows of h1 (f1_center, fused_sa_f1.cuh: 16-byte gathers
//   and stores, slot 0's replicas stored without a gather, sums in
//   registers). No barrier stands between one warp's scan and another's
//   writes, so the scans of some warps overlap the writes of others;
// - the grid is sized to the card: the blocks of a cloud split its
//   centers so that the whole grid is one wave of resident blocks (at
//   the smallest train grid, PS SA2's 2,048 centers, 15.5 warps an SM).
//
// Numerics: the distances use the eval kernel's round-to-nearest
// sequence, so membership is bit-identical to geometry.ball_query; h1 is
// one f32 subtraction and one rounding, bit-identical to the plain
// version. The sums are f32 in another order (atomics): within 1e-3
// relative.

#include "fused_sa_f1.cuh"

namespace pcl {

struct F1Args {
  const float* new_xyz;      // [B, M, 3]
  const float* pts;          // [B, N, 3]
  const __nv_bfloat16* q;    // [B, N, C1]
  const float* off;          // [B, M, C1]
  int* idx;                  // [B, M, k]
  __nv_bfloat16* h1;         // [B, M, k, C1]
  int* cnt;                  // [B, M]
  float* psum;               // [2, C1]
  int n, m, k;
  float r2;
  int per_block;             // centers a block
};

// Dynamic shared memory: the cloud (x, y, z, |p|^2), a neighbour row a
// warp, the block's sums.
inline size_t f1_smem(int n, int k, int c1) {
  return (size_t)n * 16 + (size_t)kWarps * ((k + 3) / 4 * 16) +
         (size_t)2 * c1 * 4;
}

template <int C1>
__global__ void __launch_bounds__(kThreads, kF1MinBlocks)
    bq_f1_kernel(const F1Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, k = a.k;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int kp = (k + 3) / 4 * 4;
  float4* ptss = reinterpret_cast<float4*>(smem);
  int* nbr = reinterpret_cast<int*>(smem + (size_t)n * 16) + warp * kp;
  float* red = reinterpret_cast<float*>(smem + (size_t)n * 16 +
                                        (size_t)kWarps * kp * 4);

  const int b = blockIdx.y;
  const int m0 = blockIdx.x * a.per_block;
  const int centers = min(a.per_block, a.m - m0);
  stage_cloud(a.pts + (size_t)b * n * 3, n, ptss, threadIdx.x, kThreads);
  for (int i = threadIdx.x; i < 2 * C1; i += kThreads) red[i] = 0.0f;
  __syncthreads();

  const __nv_bfloat16* qg = a.q + (size_t)b * n * C1;
  F1Sums s;
  s.zero();
  for (int c = warp; c < centers; c += kWarps) {
    const size_t center = (size_t)b * a.m + m0 + c;
    const int count = bq_scan(a.new_xyz + center * 3, ptss, n, k, a.r2,
                              lane, nbr);
    bq_fill(nbr, count, k, lane);
    __syncwarp();
    for (int e = lane; e < k; e += 32) a.idx[center * k + e] = nbr[e];
    if (lane == 0) a.cnt[center] = count;
    f1_center<C1>(qg, a.off + center * C1, a.h1 + center * k * C1, nbr, k,
                  lane, s);
    __syncwarp();  // before the next scan overwrites nbr
  }
  f1_flush<C1>(s, lane, red, a.psum);
}

template <int C1>
cudaError_t launch_f1(F1Args a, int batch, cudaStream_t stream) {
  const size_t smem = f1_smem(a.n, a.k, C1);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  int wave = 0;
  cudaError_t err = wave_blocks(bq_f1_kernel<C1>, smem, &wave);
  if (err != cudaSuccess) return err;
  // one wave: the resident blocks shared among the clouds
  const int chunks = max(1, wave / batch);
  a.per_block = (a.m + chunks - 1) / chunks;
  const dim3 grid((a.m + a.per_block - 1) / a.per_block, batch);
  bq_f1_kernel<C1><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace pcl

// Widths compiled: C1 = 32, 64 and 128. Returns the launch's
// cudaGetLastError() code, or cudaErrorInvalidValue for what it does not
// take.
extern "C" int sa_bq_f1_launch(const void* new_xyz, const void* pts,
                               const void* q, const void* off, void* idx,
                               void* h1, void* cnt, void* psum, int batch,
                               int n, int m, int c1, int k, float r2,
                               void* stream) {
  if (batch < 1 || n < 1 || m < 1 || k < 1) return cudaErrorInvalidValue;
  pcl::F1Args a;
  a.new_xyz = static_cast<const float*>(new_xyz);
  a.pts = static_cast<const float*>(pts);
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.off = static_cast<const float*>(off);
  a.idx = static_cast<int*>(idx);
  a.h1 = static_cast<__nv_bfloat16*>(h1);
  a.cnt = static_cast<int*>(cnt);
  a.psum = static_cast<float*>(psum);
  a.n = n;
  a.m = m;
  a.k = k;
  a.r2 = r2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c1 == 32) return pcl::launch_f1<32>(a, batch, s);
  if (c1 == 64) return pcl::launch_f1<64>(a, batch, s);
  if (c1 == 128) return pcl::launch_f1<128>(a, batch, s);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory the launch above needs (0: width not compiled).
extern "C" long long sa_bq_f1_smem(int n, int c1, int k) {
  if (c1 == 32 || c1 == 64 || c1 == 128)
    return (long long)pcl::f1_smem(n, k, c1);
  return 0;
}
