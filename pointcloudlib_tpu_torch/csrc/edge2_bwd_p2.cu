// Train-mode two-layer EdgeConv, backward pass 2, for Hopper (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/fused_edge.py
// (_e2_bwd_rule -> _ke2_p2). With the BN sums known (us2 = ps2/R from
// pass 1, us1 = s1/R from _combine_p1; R = B*M*k), per edge (the chain of
// edge2.cuh, dz2 as in edge2_bwd_p1.cu):
//   dh2 = sc2*((dz2 - us2[0]) - x2*us2[1])
//   dy1 = bf16(dh2) . bf16(W2^T)                      (f32 sums)
//   dh1 = sc1*((m1*dy1 - us1[0]) - x1*us1[1])
// and per center and per source point:
//   doff [B*M, C1] = -sum over the k slots of dh1
//   dq   [B, N, C1] += dh1 at row idx of the edge    (zeroed by the caller)
//
// The TPU kernel scatters dh1 with a hi/lo bf16 one-hot product, an
// almost exact f32 scatter; here each thread adds its row's 8 channels
// with two 16-byte f32 vector atomics (RED.ADD.F32x4 in L2), as
// edge_bwd.cu does. doff needs no atomics: a thread owns its centers'
// channels over all k slots (edge2.cuh).
//
// What bounds it: operations. The chain runs twice (tie_split, then the
// backward) and the second product dh2 . W2^T is 2*C2*C1 flops an edge,
// on the CUDA cores in f32 in this first version; beside them the
// scatter's B*M*k*C1 f32 additions (84 M at B=16, N=2048, k=40).
//
// Numerics: y1 and the tie structure are the plain version's; h2, dy1 and
// the sums of doff and dq take another order (and the atomics' order
// changes from run to run), so dq and doff agree to f32 rounding, except
// where a last-bit change of h2 moves a max-pool tie share.

#include "edge2.cuh"

namespace pcl {

struct Edge2P2Args {
  const __nv_bfloat16* h1;   // [centers, k, C1]
  const float* dout;         // [centers, C2]
  const int* idx;            // [centers, k]
  const float* st;           // [4, C1] ++ [4, C2]
  const float* us;           // [2, C2] ++ [2, C1]
  const __nv_bfloat16* w2;   // [C1, C2]
  const __nv_bfloat16* wt2;  // [C2, C1]
  float* dq;                 // [centers / m, n, C1]
  float* doff;               // [centers, C1]
  long long centers;
  int m, n, k;
  float slope;
};

template <int C1, int C2>
__global__ void __launch_bounds__(kThreads)
    edge2_p2_kernel(const Edge2P2Args a) {
  using T2 = Tile<C2>;
  using T1 = Tile<C1>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Edge2Smem<C1, C2> s(smem);
  stage_chain(s, a.w2, a.wt2, a.st, a.us);
  const int tid = threadIdx.x;
  const int rg = tid / T2::NCG, cg = tid % T2::NCG;
  const int rg1 = tid / T1::NCG, cg1 = tid % T1::NCG;
  const int k = a.k;
  const float slope = a.slope;
  for (long long u = blockIdx.x; u < center_tiles(a.centers);
       u += gridDim.x) {
    const long long c0 = u * kRows;
    const int nc = (int)min((long long)kRows, a.centers - c0);
    float mx[T2::RPT][8], g[T2::RPT][8];
    tie_split(s, a.h1, a.dout, c0, nc, k, slope, rg, cg, mx, g);
    float dsum[T1::RPT][8];
#pragma unroll
    for (int i = 0; i < T1::RPT; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) dsum[i][c] = 0.0f;
    for (int kk = 0; kk < k; ++kk) {
      __syncthreads();
      load_y1_slot(s, a.h1, c0, nc, k, kk, slope);
      __syncthreads();
      // layer 2: dh2 of this slot's rows into the bf16 tile s.ds
      {
        float h[T2::RPT][8], dz[T2::RPT][8];
        product<C1, C2>(s.ys, s.w2, rg, cg, h);
#pragma unroll
        for (int i = 0; i < T2::RPT; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int ch = cg * 8 + c;
            dz[i][c] = bn_z(h[i][c], s.st2(0)[ch], s.st2(1)[ch]);
          }
        maxpool_dz2(dz, mx, g, slope);
#pragma unroll
        for (int i = 0; i < T2::RPT; ++i) {
          float d[8];
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int ch = cg * 8 + c;
            d[c] = bn_bwd(dz[i][c], xhat(h[i][c], s.st2(2)[ch], s.st2(3)[ch]),
                          s.st2(0)[ch], s.us2(0)[ch], s.us2(1)[ch]);
          }
          *reinterpret_cast<uint4*>(s.ds + (rg * T2::RPT + i) * (C2 + 8) +
                                    cg * 8) = pack8(d);
        }
      }
      __syncthreads();
      // layer 1: dy1 = dh2 . W2^T, then dh1 into doff and dq
      float dy[T1::RPT][8];
      product<C2, C1>(s.ds, s.wt2, rg1, cg1, dy);
#pragma unroll
      for (int i = 0; i < T1::RPT; ++i) {
        const int r = rg1 * T1::RPT + i;
        if (r >= nc) continue;
        const long long ctr = c0 + r;
        const size_t row = (size_t)ctr * k + kk;
        const uint4 hv =
            *reinterpret_cast<const uint4*>(a.h1 + row * C1 + cg1 * 8);
        float d[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int ch = cg1 * 8 + c;
          const float h = bf_at(hv, c);
          const float z = bn_z(h, s.st1(0)[ch], s.st1(1)[ch]);
          const float dz = z > 0.0f ? dy[i][c] : __fmul_rn(slope, dy[i][c]);
          d[c] = bn_bwd(dz, xhat(h, s.st1(2)[ch], s.st1(3)[ch]),
                        s.st1(0)[ch], s.us1(0)[ch], s.us1(1)[ch]);
          dsum[i][c] += d[c];
        }
        float* dst = a.dq + ((size_t)(ctr / a.m) * a.n + a.idx[row]) * C1 +
                     cg1 * 8;
        atomicAdd(reinterpret_cast<float4*>(dst),
                  make_float4(d[0], d[1], d[2], d[3]));
        atomicAdd(reinterpret_cast<float4*>(dst + 4),
                  make_float4(d[4], d[5], d[6], d[7]));
      }
    }
#pragma unroll
    for (int i = 0; i < T1::RPT; ++i) {
      const int r = rg1 * T1::RPT + i;
      if (r >= nc) continue;
      float* o = a.doff + (size_t)(c0 + r) * C1 + cg1 * 8;
      *reinterpret_cast<float4*>(o) =
          make_float4(-dsum[i][0], -dsum[i][1], -dsum[i][2], -dsum[i][3]);
      *reinterpret_cast<float4*>(o + 4) =
          make_float4(-dsum[i][4], -dsum[i][5], -dsum[i][6], -dsum[i][7]);
    }
  }
}

template <int C1, int C2>
cudaError_t launch_p2(const Edge2P2Args& a, cudaStream_t stream) {
  constexpr size_t smem = Edge2Layout<C1, C2>::bytes;
  auto kernel = edge2_p2_kernel<C1, C2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = resident_blocks(kernel, smem, center_tiles(a.centers), &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace pcl

// h1 [centers, k, c1] bf16, dout [centers, c2] f32, idx [centers, k] i32
// with every entry in [0, n), st [4*c1 + 4*c2] f32, us [2*c2 + 2*c1] f32
// (us2 then us1), w2 [c1, c2] and wt2 [c2, c1] bf16; dq [centers/m, n, c1]
// f32 zeroed, doff [centers, c1] f32; all contiguous and 16-byte aligned.
// Returns the launch's cudaGetLastError() code, or cudaErrorInvalidValue
// for widths not compiled (PCL_EDGE2_WIDTHS) or sizes it does not take.
extern "C" int edge2_bwd_p2_launch(const void* h1, const void* dout,
                                   const void* idx, const void* st,
                                   const void* us, const void* w2,
                                   const void* wt2, void* dq, void* doff,
                                   long long centers, int m, int n, int k,
                                   int c1, int c2, float slope,
                                   void* stream) {
  if (centers < 1 || m < 1 || n < 1 || k < 1 || centers % m)
    return cudaErrorInvalidValue;
  pcl::Edge2P2Args a;
  a.h1 = static_cast<const __nv_bfloat16*>(h1);
  a.dout = static_cast<const float*>(dout);
  a.idx = static_cast<const int*>(idx);
  a.st = static_cast<const float*>(st);
  a.us = static_cast<const float*>(us);
  a.w2 = static_cast<const __nv_bfloat16*>(w2);
  a.wt2 = static_cast<const __nv_bfloat16*>(wt2);
  a.dq = static_cast<float*>(dq);
  a.doff = static_cast<float*>(doff);
  a.centers = centers;
  a.m = m;
  a.n = n;
  a.k = k;
  a.slope = slope;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PCL_LAUNCH(A, B) \
  if (c1 == A && c2 == B) return pcl::launch_p2<A, B>(a, s);
  PCL_EDGE2_WIDTHS(PCL_LAUNCH)
#undef PCL_LAUNCH
  return cudaErrorInvalidValue;
}
