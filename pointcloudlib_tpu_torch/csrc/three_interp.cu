// 3-NN inverse-distance interpolation for Hopper (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/neighbors.py
// (_three_interp_fwd_call -> _k_three_interp). For each query q of
// query [B, M, 3] against support points [B, N, 3] with features
// feats [B, N, C]:
//   idx [B, M, 3] i32 — the three smallest
//       d2 = max((|q|^2 - 2 q.p) + |p|^2, 0), ascending, the lower index
//       first on ties (three masked argmins);
//   w [B, M, 3] f32   — inv_j = 1 / (sum_c (q - p_j)^2 + 1e-8), the
//       distance recomputed exactly from the selected coordinates (a
//       query equal to a support point gets d2 = 0 and weight ~1: a hard
//       copy), normalized w_j = inv_j / ((inv_0 + inv_1) + inv_2);
//   out [B, M, C] f32 — (w_0 f_0 + w_1 f_1) + w_2 f_2.
//
// The TPU kernel selects with three argmin rounds over a [mt, N]
// distance tile and gathers through a [3 mt, N] one-hot matmul (bf16
// hi/lo splits), because gathers are slow on its vector unit. Here the
// support cloud of one batch element is staged in shared memory, one
// thread per query walks it in index order and keeps the three smallest
// d2 with a strict "<" (ties keep the earlier index ahead), and each
// warp then writes its 32 queries' output rows with lanes over channels,
// so feature reads and output stores coalesce.
//
// What bounds it: bytes. It reads B*(M+N)*12 + B*N*C*4 bytes and writes
// B*M*C*4 + B*M*24, against ~10 f32 operations for each of the B*M*N
// (query, point) pairs and 5 per output element.
//
// Numerics: explicit round-to-nearest operations in the plain version's
// order (no FMA contraction), so idx is bit-identical to
// three_interp_plain and w and out agree with it to the last bits.

#include "fused_sa_common.cuh"

namespace pcl {

constexpr int kTiQueries = 128;  // queries (threads) per block

__global__ void __launch_bounds__(kTiQueries)
    three_interp_kernel(const float* __restrict__ query,
                        const float* __restrict__ pts,
                        const float* __restrict__ feats,
                        float* __restrict__ out, int* __restrict__ idx,
                        float* __restrict__ wout, int n, int m, int c) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* ptss = reinterpret_cast<float4*>(smem);
  __shared__ int s_idx[kTiQueries][3];
  __shared__ float s_w[kTiQueries][3];

  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kTiQueries;
  const int t = threadIdx.x;
  const float* pg = pts + (size_t)b * n * 3;
  for (int j = t; j < n; j += kTiQueries) {
    const float x = pg[3 * j], y = pg[3 * j + 1], z = pg[3 * j + 2];
    ptss[j] = make_float4(x, y, z, sumsq3(x, y, z));
  }
  __syncthreads();

  const int i = m0 + t;
  if (i < m) {
    const float* qp = query + ((size_t)b * m + i) * 3;
    const float qx = qp[0], qy = qp[1], qz = qp[2];
    const float q2 = sumsq3(qx, qy, qz);
    float d0 = INFINITY, d1 = INFINITY, d2 = INFINITY;
    int i0 = 0, i1 = 0, i2 = 0;
    for (int j = 0; j < n; ++j) {
      const float d = sq_dist(qx, qy, qz, q2, ptss[j]);
      if (d < d2) {
        if (d < d1) {
          d2 = d1;
          i2 = i1;
          if (d < d0) {
            d1 = d0;
            i1 = i0;
            d0 = d;
            i0 = j;
          } else {
            d1 = d;
            i1 = j;
          }
        } else {
          d2 = d;
          i2 = j;
        }
      }
    }
    const int sel[3] = {i0, i1, i2};
    float inv[3];
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const float4 p = ptss[sel[s]];
      const float e = sumsq3(__fsub_rn(qx, p.x), __fsub_rn(qy, p.y),
                             __fsub_rn(qz, p.z));
      inv[s] = __frcp_rn(__fadd_rn(e, 1e-8f));
    }
    const float denom = __fadd_rn(__fadd_rn(inv[0], inv[1]), inv[2]);
    const size_t row = (size_t)b * m + i;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const float w = __fdiv_rn(inv[s], denom);
      s_idx[t][s] = sel[s];
      s_w[t][s] = w;
      idx[row * 3 + s] = sel[s];
      wout[row * 3 + s] = w;
    }
  }
  __syncthreads();

  // each warp writes its own 32 queries' rows, lanes over channels
  const int lane = t % 32;
  const int q0 = (t / 32) * 32;
  const float* fb = feats + (size_t)b * n * c;
  for (int qq = q0; qq < q0 + 32 && m0 + qq < m; ++qq) {
    const float* f0 = fb + (size_t)s_idx[qq][0] * c;
    const float* f1 = fb + (size_t)s_idx[qq][1] * c;
    const float* f2 = fb + (size_t)s_idx[qq][2] * c;
    const float w0 = s_w[qq][0], w1 = s_w[qq][1], w2 = s_w[qq][2];
    float* o = out + ((size_t)b * m + m0 + qq) * c;
    for (int ch = lane; ch < c; ch += 32) {
      o[ch] = __fadd_rn(
          __fadd_rn(__fmul_rn(w0, f0[ch]), __fmul_rn(w1, f1[ch])),
          __fmul_rn(w2, f2[ch]));
    }
  }
}

}  // namespace pcl

// query [b, m, 3], pts [b, n, 3], feats [b, n, c] f32 contiguous; out
// [b, m, c] f32, idx [b, m, 3] i32, w [b, m, 3] f32. Returns the launch's
// cudaGetLastError() code, or cudaErrorInvalidValue for sizes it does
// not take (n < 3, or a cloud beyond one block's shared memory).
extern "C" int three_interp_launch(const void* query, const void* pts,
                                   const void* feats, void* out, void* idx,
                                   void* w, int b, int n, int m, int c,
                                   void* stream) {
  if (b < 1 || n < 3 || m < 1 || c < 1) return cudaErrorInvalidValue;
  const size_t smem = (size_t)n * 16;
  const size_t fixed = sizeof(int) * 3 * pcl::kTiQueries +
                       sizeof(float) * 3 * pcl::kTiQueries;
  if (smem + fixed > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      pcl::three_interp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + pcl::kTiQueries - 1) / pcl::kTiQueries, b);
  pcl::three_interp_kernel<<<grid, pcl::kTiQueries, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const float*>(pts),
      static_cast<const float*>(feats), static_cast<float*>(out),
      static_cast<int*>(idx), static_cast<float*>(w), n, m, c);
  return cudaGetLastError();
}
