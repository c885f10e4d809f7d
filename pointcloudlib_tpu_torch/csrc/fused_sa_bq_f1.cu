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
// design stages each cloud in shared memory once per tile of MT centers,
// lets one warp per center scan it 32 points a step (a ballot gives the
// in-order ranks of the hits; bq_scan, shared with the standalone ball
// query and the eval kernel), and writes h1 with consecutive threads on
// consecutive channel pairs (f1_rows, shared with the forward pass that
// takes a given idx).
//
// Numerics: the distances use the eval kernel's round-to-nearest
// sequence, so membership is bit-identical to geometry.ball_query; h1 is
// one f32 subtraction and one rounding, bit-identical to the plain
// version. The sums are f32 in another order (atomics): within 1e-3
// relative.

#include "fused_sa_common.cuh"

namespace pcl {

constexpr int kF1Centers = 32;  // centers per block

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
};

template <int C1>
struct F1Layout {
  static size_t bytes(int n, int k) {
    return (size_t)n * 16 + (size_t)kF1Centers * k * 4 + (size_t)2 * C1 * 4;
  }
};

template <int C1>
__global__ void __launch_bounds__(kThreads) bq_f1_kernel(const F1Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* ptss = reinterpret_cast<float4*>(smem);
  int* nbr = reinterpret_cast<int*>(smem + (size_t)a.n * 16);
  float* red = reinterpret_cast<float*>(smem + (size_t)a.n * 16 +
                                        (size_t)kF1Centers * a.k * 4);

  const int n = a.n, k = a.k;
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kF1Centers;
  const int mt = min(kF1Centers, a.m - m0);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  stage_cloud(a.pts + (size_t)b * n * 3, n, ptss, threadIdx.x, kThreads);
  for (int i = tid; i < 2 * C1; i += kThreads) red[i] = 0.0f;
  __syncthreads();

  // ball query: one warp per center, the whole cloud (cnt counts every hit)
  for (int c = warp; c < mt; c += kWarps) {
    const int count = bq_scan(
        a.new_xyz + ((size_t)b * a.m + m0 + c) * 3, ptss, n, k, a.r2, lane,
        nbr + c * k);
    bq_fill(nbr + c * k, count, k, lane);
    if (lane == 0) a.cnt[(size_t)b * a.m + m0 + c] = count;
  }
  __syncthreads();

  int* idxg = a.idx + ((size_t)b * a.m + m0) * k;
  for (int e = tid; e < mt * k; e += kThreads) idxg[e] = nbr[e];

  f1_rows<C1>(a.q + (size_t)b * n * C1, a.off + ((size_t)b * a.m + m0) * C1,
              a.h1 + ((size_t)b * a.m + m0) * k * C1, nbr, mt * k, k, red,
              a.psum);
}

template <int C1>
cudaError_t launch_f1(const F1Args& a, int batch, cudaStream_t stream) {
  const size_t smem = F1Layout<C1>::bytes(a.n, a.k);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bq_f1_kernel<C1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.m + kF1Centers - 1) / kF1Centers, batch);
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
  if (c1 == 32) return (long long)pcl::F1Layout<32>::bytes(n, k);
  if (c1 == 64) return (long long)pcl::F1Layout<64>::bytes(n, k);
  if (c1 == 128) return (long long)pcl::F1Layout<128>::bytes(n, k);
  return 0;
}
