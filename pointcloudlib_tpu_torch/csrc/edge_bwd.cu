// Train-mode fused EdgeConv, the backward pass, for Hopper (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/fused_edge.py
// (_edge_bwd_rule -> _ke_bwd). From the bf16 checkpoint h [B, N, k, C],
// the output gradient dout [B, N, C], the neighbour index idx [B, N, k]
// and the folded BN rows (sc, bi, rs, mrs) of the batch statistics, for
// every row (b, i, kk) and channel:
//   z = h*sc + bi, y = leaky(z); dz = dout[b, i] / t where y reaches the
//   max of its center's k slots (t of them: ties share evenly, as
//   jnp.max's gradient), else 0, times slope where z <= 0;
//   x^ = h*rs - mrs;
// and writes
//   ps [2, C]            += [sum dz, sum dz*x^] over all rows (dbeta,
//                           dgamma), zeroed by the caller;
//   scat [B, N, SW]      += [bf16(dz) | bf16(x^) | 1] in columns [0, 2C]
//                           of row idx[b, i, kk] of cloud b (zeroed by the
//                           caller; SW = 2C + 4 keeps rows 16-byte
//                           aligned, the TPU pads to 2C + 8);
//   d1, d2 [B, N, C]      the per-center sums over k of dz and of x^.
// dq and doff are affine in those (the BN backward's mean terms need ps
// first) and are assembled outside: ops/kernels/fused_edge.py.
//
// The TPU kernel accumulates the scatter as a transposed one-hot product
// and the sums across its sequential grid. Here blocks run in parallel:
// one thread takes four channels of a center, first folding (max, tie
// count) of y over the k slots in one walk, then walking them again for
// dz; the scatter is 16-byte f32 vector atomics (RED.ADD.F32x4 in L2),
// the threads of a center on neighbouring channel quads of one target
// row, the dz half's only where the quad is not all 0; ps goes through
// registers, shared memory and one global atomic per channel and block.
//
// What bounds it: bytes. It reads h (B*N*k*C*2 bytes), dout and idx,
// writes d1 and d2, and scat once (B*N*(2C+1)*4), against ~15 f32
// operations an element of h. In practice its time splits about evenly
// between the two walks (2.5x that bound without any reduction: latency,
// an 8-byte load in flight a thread) and the scatter's reductions
// (43-48 % of the first version: B*N*k*C/4 of each 16-byte half and the
// count). dz is 0 at every slot but the few that reach a center's max
// (about 1 in k), so a thread's four channels are all 0 at ~(1 - 1/k)^4
// of the slots (81 % at k = 20, 90 % at k = 40): only the other slots'
// dz quads are reduced (adding +-0 to an f32 sum leaves it as it was).
// Summing the x^ half and the count target-major from a reverse index
// of idx, in place of their reductions, was measured and lost: it reads
// h a second time, and those bytes cost as much as the reductions
// (PERF.md, slice 19).
//
// Numerics: dz, x^ and the ties are bit-identical to the plain version;
// the sums and the scatter take another order (the atomics' order changes
// from run to run), so they agree to f32 rounding of their largest
// elements.

#include "edge_knn.cuh"

namespace pcl {

constexpr int kQuad = 4;  // channels a thread

__device__ __forceinline__ void load4(const float* p, float (&v)[kQuad]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

__device__ __forceinline__ void unpack4(const __nv_bfloat16* p,
                                        float (&v)[kQuad]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  v[0] = bf_lo(w.x);
  v[1] = bf_hi(w.x);
  v[2] = bf_lo(w.y);
  v[3] = bf_hi(w.y);
}

__global__ void __launch_bounds__(kThreads)
    edge_bwd_kernel(const __nv_bfloat16* __restrict__ h,
                    const float* __restrict__ dout,
                    const int* __restrict__ idx,
                    const float* __restrict__ st, float* __restrict__ ps,
                    float* __restrict__ scat, float* __restrict__ d1,
                    float* __restrict__ d2, long long centers, int n, int k,
                    int c, int sw, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);  // [2c] block sums
  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * c; i += kThreads) red[i] = 0.0f;
  __syncthreads();

  const int ncq = c / kQuad;
  const int per = kThreads / ncq;  // centers a block takes at a time
  const int cq = tid % ncq;
  const int c0 = kQuad * cq;
  float sc[kQuad], bi[kQuad], rs[kQuad], mr[kQuad];
  load4(st + c0, sc);
  load4(st + c + c0, bi);
  load4(st + 2 * c + c0, rs);
  load4(st + 3 * c + c0, mr);
  float s[kQuad] = {}, ss[kQuad] = {};
  for (long long ctr = (long long)blockIdx.x * per + tid / ncq;
       ctr < centers; ctr += (long long)gridDim.x * per) {
    const __nv_bfloat16* hr = h + (size_t)ctr * k * c + c0;
    float m[kQuad], g[kQuad];
    int t[kQuad];
#pragma unroll
    for (int u = 0; u < kQuad; ++u) {
      m[u] = -INFINITY;
      t[u] = 0;
    }
    for (int kk = 0; kk < k; ++kk) {
      float hv[kQuad];
      unpack4(hr + (size_t)kk * c, hv);
#pragma unroll
      for (int u = 0; u < kQuad; ++u) {
        const float y = leaky(bn_z(hv[u], sc[u], bi[u]), slope);
        if (y > m[u]) {
          m[u] = y;
          t[u] = 1;
        } else if (y == m[u]) {
          ++t[u];
        }
      }
    }
    load4(dout + (size_t)ctr * c + c0, g);
#pragma unroll
    for (int u = 0; u < kQuad; ++u) g[u] = __fdiv_rn(g[u], (float)t[u]);
    float* sb = scat + (size_t)(ctr / n) * n * sw;
    const int* ir = idx + (size_t)ctr * k;
    float a[kQuad] = {}, x[kQuad] = {};
    for (int kk = 0; kk < k; ++kk) {
      float hv[kQuad], dz[kQuad], xh[kQuad];
      unpack4(hr + (size_t)kk * c, hv);
#pragma unroll
      for (int u = 0; u < kQuad; ++u) {
        const float z = bn_z(hv[u], sc[u], bi[u]);
        const float da = leaky(z, slope) == m[u] ? g[u] : 0.0f;
        dz[u] = z > 0.0f ? da : __fmul_rn(slope, da);
        xh[u] = xhat(hv[u], rs[u], mr[u]);
        a[u] += dz[u];
        x[u] += xh[u];
        s[u] += dz[u];
        ss[u] += dz[u] * xh[u];
      }
      float* sr = sb + (size_t)ir[kk] * sw;
      if (dz[0] != 0.0f || dz[1] != 0.0f || dz[2] != 0.0f || dz[3] != 0.0f)
        atomicAdd(reinterpret_cast<float4*>(sr + c0),
                  make_float4(bf_round(dz[0]), bf_round(dz[1]),
                              bf_round(dz[2]), bf_round(dz[3])));
      atomicAdd(reinterpret_cast<float4*>(sr + c + c0),
                make_float4(bf_round(xh[0]), bf_round(xh[1]),
                            bf_round(xh[2]), bf_round(xh[3])));
      if (cq == 0) atomicAdd(sr + 2 * c, 1.0f);
    }
    *reinterpret_cast<float4*>(d1 + (size_t)ctr * c + c0) =
        make_float4(a[0], a[1], a[2], a[3]);
    *reinterpret_cast<float4*>(d2 + (size_t)ctr * c + c0) =
        make_float4(x[0], x[1], x[2], x[3]);
  }
#pragma unroll
  for (int u = 0; u < kQuad; ++u) {
    atomicAdd(red + c0 + u, s[u]);
    atomicAdd(red + c + c0 + u, ss[u]);
  }
  __syncthreads();
  for (int i = tid; i < 2 * c; i += kThreads) atomicAdd(ps + i, red[i]);
}

}  // namespace pcl

// h [b, n, k, c] bf16, dout [b, n, c] f32, idx [b, n, k] i32 with every
// entry in [0, n), st [4, c] f32; ps [2, c] and scat [b, n, 2c + 4] f32
// zeroed, d1 and d2 [b, n, c] f32; all contiguous and 16-byte aligned.
// Returns the launch's cudaGetLastError() code, or cudaErrorInvalidValue
// for sizes it does not take (c not a multiple of 4, or one whose channel
// quads do not divide the block).
extern "C" int edge_bwd_launch(const void* h, const void* dout,
                               const void* idx, const void* st, void* ps,
                               void* scat, void* d1, void* d2, int b, int n,
                               int k, int c, float slope, void* stream) {
  if (b < 1 || n < 1 || k < 1 || c < pcl::kQuad || c % pcl::kQuad ||
      pcl::kThreads % (c / pcl::kQuad))
    return cudaErrorInvalidValue;
  const long long centers = (long long)b * n;
  const int per = pcl::kThreads / (c / pcl::kQuad);
  const size_t smem = sizeof(float) * 2 * c;
  int blocks = 0;
  cudaError_t err = pcl::resident_blocks(
      pcl::edge_bwd_kernel, smem, (centers + per - 1) / per, &blocks);
  if (err != cudaSuccess) return err;
  pcl::edge_bwd_kernel<<<blocks, pcl::kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const float*>(dout),
      static_cast<const int*>(idx), static_cast<const float*>(st),
      static_cast<float*>(ps), static_cast<float*>(scat),
      static_cast<float*>(d1), static_cast<float*>(d2), centers, n, k, c,
      2 * c + 4, slope);
  return cudaGetLastError();
}
