// Train-mode fused EdgeConv, forward pass 2 (the max-pool), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/fused_edge.py
// (_call_eout -> _ke_out):
//   out[r, c] = max over k slots of leaky(sc[c] * float(h[r, kk, c]) + bi[c])
// for every center row r of the bf16 checkpoint h [R, k, C] that
// edge_knn_f1.cu wrote, (sc, bi) the BN rows folded from the batch
// statistics of that pass.
//
// What bounds it: bytes. It reads h once (R*k*C*2 bytes, 335 MB at
// layer 4 of DGCNN at B=32) and writes out (R*C*4), against 5 f32
// operations an element of h. One thread takes one channel pair of one
// center and walks its k slots, so a warp reads each slot's row of h in
// 128-byte pieces; the loop over slots is unrolled to keep loads in
// flight.
//
// Numerics: the plain version's rounded operations in its order; out is
// bit-identical to it.

#include "edge_knn.cuh"

namespace pcl {

__global__ void __launch_bounds__(kThreads)
    edge_out_kernel(const __nv_bfloat16* __restrict__ h,
                    const float* __restrict__ st, float* __restrict__ out,
                    long long centers, int k, int c, float slope) {
  const int ncp = c / 2;
  const long long total = centers * ncp;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
       e < total; e += (long long)gridDim.x * kThreads) {
    const long long ctr = e / ncp;
    const int cc = 2 * (int)(e - ctr * ncp);
    const float sc0 = st[cc], sc1 = st[cc + 1];
    const float bi0 = st[c + cc], bi1 = st[c + cc + 1];
    const __nv_bfloat16* hr = h + (size_t)ctr * k * c + cc;
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll 4
    for (int kk = 0; kk < k; ++kk) {
      const uint32_t w =
          *reinterpret_cast<const uint32_t*>(hr + (size_t)kk * c);
      m0 = fmaxf(m0, leaky(bn_z(bf_lo(w), sc0, bi0), slope));
      m1 = fmaxf(m1, leaky(bn_z(bf_hi(w), sc1, bi1), slope));
    }
    *reinterpret_cast<float2*>(out + (size_t)ctr * c + cc) =
        make_float2(m0, m1);
  }
}

}  // namespace pcl

// h [centers, k, c] bf16, st [4, c] f32 (sc, bi, rs, mrs), out
// [centers, c] f32; all contiguous. Returns the launch's
// cudaGetLastError() code, or cudaErrorInvalidValue for an empty or odd
// size.
extern "C" int edge_out_launch(const void* h, const void* st, void* out,
                               long long centers, int k, int c, float slope,
                               void* stream) {
  if (centers < 1 || k < 1 || c < 2 || c % 2) return cudaErrorInvalidValue;
  const long long total = centers * (c / 2);
  long long blocks = (total + pcl::kThreads - 1) / pcl::kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // the rest stride
  pcl::edge_out_kernel<<<(unsigned)blocks, pcl::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const float*>(st),
      static_cast<float*>(out), centers, k, c, slope);
  return cudaGetLastError();
}
