// Train-mode two-layer EdgeConv, backward pass 1, for Hopper (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/fused_edge.py
// (_e2_bwd_rule -> _ke2_p1). From the bf16 checkpoint h1 [B*M, k, C1],
// the output gradient dout [B*M, C2], W2 and the folded BN rows of both
// layers, per edge (the chain of edge2.cuh):
//   z1 = h1*sc1 + bi1, y1 = leaky(z1), m1 = (z1 > 0 ? 1 : slope),
//   x1 = h1*rs1 - mrs1; h2, z2, x2 = h2*rs2 - mrs2;
//   dz2 = dout / ties where leaky(z2) reaches the max of the center's k
//         slots (the even tie split of jnp.max's gradient), else 0, times
//         slope where z2 <= 0;
//   left = [y1 | m1 | m1*x1] (3*C1), right = [dz2 | x2] (2*C2)
// and over all edges:
//   ps2 = [sum dz2, sum dz2*x2] (2, C2), vecs = sum left (3*C1),
//   mats = bf16(left)^T . bf16(right) (3*C1, 2*C2), f32 sums.
// _combine_p1 (ops/kernels/fused_sa_train.py) turns them into dW2 and the
// BN1 sums.
//
// What bounds it: operations. mats is 2*3*C1*2*C2 flops an edge (64
// GFLOP at B=16, N=2048, k=40), and the chain runs twice (below), both on
// the CUDA cores in f32 in this first version. The TPU kernel sums across
// its sequential grid; here two kernels run: (a) resident blocks walk
// tiles of 64 centers (edge2.cuh) twice over their k slots -- once to
// fold each center's max and tie count in registers (tie_split), once to
// form dz2 and the rest -- add ps2 and vecs in registers and write left
// and right as bf16 rows to a scratch the caller allocates; (b) the
// split-row product of split_mats.cuh. Every sum reaches global memory
// by atomics, f32 in another order than the plain version.

#include "edge2.cuh"
#include "split_mats.cuh"

namespace pcl {

struct Edge2P1Args {
  const __nv_bfloat16* h1;  // [centers, k, C1]
  const float* dout;        // [centers, C2]
  const float* st;          // [4, C1] ++ [4, C2]
  const __nv_bfloat16* w2;  // [C1, C2]
  float* ps2;               // [2, C2]
  float* vecs;              // [3 * C1]
  __nv_bfloat16* left;      // [centers * k, 3 * C1] scratch
  __nv_bfloat16* right;     // [centers * k, 2 * C2] scratch
  float* mats;              // [3 * C1, 2 * C2]
  long long centers;
  int k;
  float slope;
};

template <int C1, int C2>
__global__ void __launch_bounds__(kThreads)
    edge2_p1_rows_kernel(const Edge2P1Args a) {
  using T2 = Tile<C2>;
  constexpr int RPT = T2::RPT;
  extern __shared__ __align__(16) unsigned char smem[];
  const Edge2Smem<C1, C2> s(smem);
  stage_chain(s, a.w2, nullptr, a.st, nullptr);
  const int tid = threadIdx.x;
  const int rg = tid / T2::NCG, cg = tid % T2::NCG;
  const int cc = (tid % (C1 / 2)) * 2;  // this thread's pair in the y1 tile
  const float* sc1 = s.st1(0);
  const float* bi1 = s.st1(1);
  const float* rs1 = s.st1(2);
  const float* mrs1 = s.st1(3);
  const float* rs2 = s.st2(2);
  const float* mrs2 = s.st2(3);
  const int k = a.k;
  const float slope = a.slope;
  float vl[6] = {};  // sum of left at (cc, cc + 1): y1, m1, m1*x1
  float sd[8] = {}, sdx[8] = {};
  for (long long u = blockIdx.x; u < center_tiles(a.centers);
       u += gridDim.x) {
    const long long c0 = u * kRows;
    const int nc = (int)min((long long)kRows, a.centers - c0);
    float mx[RPT][8], g[RPT][8];
    tie_split(s, a.h1, a.dout, c0, nc, k, slope, rg, cg, mx, g);
    for (int kk = 0; kk < k; ++kk) {
      __syncthreads();
      // the y1 tile, and this slot's rows of left
      for (int e = tid; e < kRows * (C1 / 2); e += kThreads) {
        const int r = e / (C1 / 2);
        uint32_t v = 0;
        if (r < nc) {
          const size_t row = (size_t)(c0 + r) * k + kk;
          const uint32_t hh =
              *reinterpret_cast<const uint32_t*>(a.h1 + row * C1 + cc);
          float y[2], m[2], x[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float h = j ? bf_hi(hh) : bf_lo(hh);
            const float z = bn_z(h, sc1[cc + j], bi1[cc + j]);
            y[j] = leaky(z, slope);
            m[j] = z > 0.0f ? 1.0f : slope;
            x[j] = __fmul_rn(m[j], xhat(h, rs1[cc + j], mrs1[cc + j]));
            vl[j] += y[j];
            vl[2 + j] += m[j];
            vl[4 + j] += x[j];
          }
          v = pack2(y[0], y[1]);
          __nv_bfloat16* lg = a.left + row * (3 * C1) + cc;
          *reinterpret_cast<uint32_t*>(lg) = v;
          *reinterpret_cast<uint32_t*>(lg + C1) = pack2(m[0], m[1]);
          *reinterpret_cast<uint32_t*>(lg + 2 * C1) = pack2(x[0], x[1]);
        }
        *reinterpret_cast<uint32_t*>(s.ys + r * (C1 + 8) + cc) = v;
      }
      __syncthreads();
      float h[RPT][8], dz[RPT][8];
      product<C1, C2>(s.ys, s.w2, rg, cg, h);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          dz[i][c] = bn_z(h[i][c], s.st2(0)[cg * 8 + c], s.st2(1)[cg * 8 + c]);
      maxpool_dz2(dz, mx, g, slope);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = rg * RPT + i;
        if (r >= nc) continue;
        float x[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          x[c] = xhat(h[i][c], rs2[cg * 8 + c], mrs2[cg * 8 + c]);
          sd[c] += dz[i][c];
          sdx[c] += dz[i][c] * x[c];
        }
        __nv_bfloat16* rp =
            a.right + ((size_t)(c0 + r) * k + kk) * (2 * C2) + cg * 8;
        *reinterpret_cast<uint4*>(rp) = pack8(dz[i]);
        *reinterpret_cast<uint4*>(rp + C2) = pack8(x);
      }
    }
  }
  flush_sum<C2>(sd, cg, s.red, a.ps2);
  flush_sum<C2>(sdx, cg, s.red, a.ps2 + C2);
  __syncthreads();
  for (int i = tid; i < 3 * C1; i += kThreads) s.red[i] = 0.0f;
  __syncthreads();
#pragma unroll
  for (int part = 0; part < 3; ++part) {
    atomicAdd(s.red + part * C1 + cc, vl[2 * part]);
    atomicAdd(s.red + part * C1 + cc + 1, vl[2 * part + 1]);
  }
  __syncthreads();
  for (int i = tid; i < 3 * C1; i += kThreads) atomicAdd(a.vecs + i, s.red[i]);
}

template <int C1, int C2>
cudaError_t launch_p1(const Edge2P1Args& a, cudaStream_t stream) {
  constexpr size_t smem = Edge2Layout<C1, C2>::bytes;
  auto kernel = edge2_p1_rows_kernel<C1, C2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = resident_blocks(kernel, smem, center_tiles(a.centers), &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_mats<3 * C1, 2 * C2>(a.left, a.right, a.mats,
                                     a.centers * a.k, stream);
}

}  // namespace pcl

// h1 [centers, k, c1] bf16, dout [centers, c2] f32, st [4*c1 + 4*c2] f32,
// w2 [c1, c2] bf16; ps2 [2, c2], vecs [3*c1] and mats [3*c1, 2*c2] f32
// zeroed; left and right scratch of centers*k*3*c1 and centers*k*2*c2
// bf16; all contiguous and 16-byte aligned. Returns cudaGetLastError() of
// the launches, or cudaErrorInvalidValue for widths not compiled
// (PCL_EDGE2_WIDTHS) or an empty size.
extern "C" int edge2_bwd_p1_launch(const void* h1, const void* dout,
                                   const void* st, const void* w2, void* ps2,
                                   void* vecs, void* left, void* right,
                                   void* mats, long long centers, int k,
                                   int c1, int c2, float slope,
                                   void* stream) {
  if (centers < 1 || k < 1) return cudaErrorInvalidValue;
  pcl::Edge2P1Args a;
  a.h1 = static_cast<const __nv_bfloat16*>(h1);
  a.dout = static_cast<const float*>(dout);
  a.st = static_cast<const float*>(st);
  a.w2 = static_cast<const __nv_bfloat16*>(w2);
  a.ps2 = static_cast<float*>(ps2);
  a.vecs = static_cast<float*>(vecs);
  a.left = static_cast<__nv_bfloat16*>(left);
  a.right = static_cast<__nv_bfloat16*>(right);
  a.mats = static_cast<float*>(mats);
  a.centers = centers;
  a.k = k;
  a.slope = slope;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PCL_LAUNCH(A, B) \
  if (c1 == A && c2 == B) return pcl::launch_p1<A, B>(a, s);
  PCL_EDGE2_WIDTHS(PCL_LAUNCH)
#undef PCL_LAUNCH
  return cudaErrorInvalidValue;
}
