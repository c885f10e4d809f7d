// The two-layer EdgeConv of DGCNN part segmentation (Fused2EdgeConv),
// the row chain of its given-index eval kernel on CUDA cores
// (edge2_eval.cu, and edge2_knn_eval.cu's block route; the tails, the
// backward passes and edge2_knn_eval's select route form it on the
// tensor cores, edge2_wgmma.cuh). From an edge's
// first-layer pre-activation h1 (the bf16 checkpoint, or float(bf16
// Q[j]) - Off[i] gathered) and the folded BN rows (sc, bi, rs, mrs):
//   y1 = bf16(leaky(h1*sc1 + bi1))      one rounding per operation, in the
//                                       plain version's order, so y1 is
//                                       bit-identical to it
//   h2 = y1 . bf16(W2)                  f32 sums (another order than the
//                                       plain version's product)
//   z2 = h2*sc2 + bi2, y2 = leaky(z2)
//
// A tile is kRows = 64 centers at one neighbour slot kk: its row r is the
// kk-th edge of center c0 + r, and a kernel walks the k slots of its 64
// centers one tile after another. The TPU kernels take a center's k slots
// together; here thread (rg, cg) of the 256 owns the same rows and 8
// channels of h2 in every tile (Tile<C2>, fused_sa_common.cuh), so what
// folds over a center's slots (the max, the tie count, per-center sums)
// stays in its registers and needs no traffic between threads, whatever
// k is. Each row runs the same instructions wherever it sits, so equal h1
// rows give equal y2: the max-pool's ties are the plain version's.

#pragma once

#include "edge_knn.cuh"

namespace pcl {

// Width pairs (C1, C2) the two-layer kernels are compiled for.
#define PCL_EDGE2_WIDTHS(X) X(64, 64)

// Shared memory of the chain: W2 (bf16), the folded rows of both layers
// (f32) and the y1 tile (bf16); byte offsets.
template <int C1, int C2>
struct Edge2Layout {
  static_assert(Tile<C1>::ACTIVE == kThreads && Tile<C2>::ACTIVE == kThreads,
                "every thread owns a tile of each product");
  static_assert(kThreads % (C1 / 2) == 0, "a fixed channel pair a thread");
  static constexpr size_t w2 = 0;
  static constexpr size_t st = w2 + (size_t)C1 * C2 * 2;
  static constexpr size_t ys = st + (size_t)4 * (C1 + C2) * 4;
  static constexpr size_t bytes = ys + (size_t)kRows * (C1 + 8) * 2;
};

// Pointers into the chain's shared memory, with its folded rows.
template <int C1, int C2>
struct Edge2Smem {
  using L = Edge2Layout<C1, C2>;
  __nv_bfloat16 *w2, *ys;
  float* st;
  __device__ explicit Edge2Smem(unsigned char* base)
      : w2(reinterpret_cast<__nv_bfloat16*>(base + L::w2)),
        ys(reinterpret_cast<__nv_bfloat16*>(base + L::ys)),
        st(reinterpret_cast<float*>(base + L::st)) {}
  // (sc, bi, rs, mrs) of layer 1 at st[0..4*C1), of layer 2 after it
  __device__ const float* st1(int row) const { return st + row * C1; }
  __device__ const float* st2(int row) const { return st + 4 * C1 + row * C2; }
};

// Stages W2 (bf16 [C1, C2]) and the folded rows st (4*C1 ++ 4*C2
// floats). Ends with a barrier.
template <int C1, int C2>
__device__ __forceinline__ void stage_chain(const Edge2Smem<C1, C2>& s,
                                            const __nv_bfloat16* w2,
                                            const float* st) {
  const int tid = threadIdx.x;
  for (int i = tid; i < C1 * C2 / 8; i += kThreads)
    reinterpret_cast<uint4*>(s.w2)[i] = reinterpret_cast<const uint4*>(w2)[i];
  for (int i = tid; i < 4 * (C1 + C2); i += kThreads) s.st[i] = st[i];
  __syncthreads();
}

// leaky(h*sc + bi) of one element, the plain version's order
__device__ __forceinline__ float bn_leaky(float h, float sc, float bi,
                                          float slope) {
  return leaky(bn_z(h, sc, bi), slope);
}

// The y1 tile from a gather: row r is query q0 + r of one cloud and its
// kk-th neighbour nbr[kk * kKnnQ + r] (the layout of knn_block and
// load_nbr), h1 = float(Q[j]) - Off[q0 + r] with q [n, C1] bf16 and off
// [m, C1] f32 of the cloud; rows at or past nq are zero.
template <int C1, int C2>
__device__ __forceinline__ void load_y1_gather(const Edge2Smem<C1, C2>& s,
                                               const int* nbr,
                                               const __nv_bfloat16* q,
                                               const float* off, int q0,
                                               int nq, int kk, float slope) {
  const float* sc1 = s.st1(0);
  const float* bi1 = s.st1(1);
  for (int e = threadIdx.x; e < kRows * (C1 / 2); e += kThreads) {
    const int r = e / (C1 / 2);
    const int cc = (e % (C1 / 2)) * 2;
    uint32_t v = 0;
    if (r < nq) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(
          q + (size_t)nbr[kk * kKnnQ + r] * C1 + cc);
      const float2 o =
          *reinterpret_cast<const float2*>(off + (size_t)(q0 + r) * C1 + cc);
      v = pack2(bn_leaky(__fsub_rn(bf_lo(w), o.x), sc1[cc], bi1[cc], slope),
                bn_leaky(__fsub_rn(bf_hi(w), o.y), sc1[cc + 1], bi1[cc + 1],
                         slope));
    }
    *reinterpret_cast<uint32_t*>(s.ys + r * (C1 + 8) + cc) = v;
  }
}

// z2 of this thread's rows and channels of the tile in s.ys:
// bn_z(y1 . W2). Every thread must call it after the tile's barrier.
template <int C1, int C2>
__device__ __forceinline__ void chain_z2(const Edge2Smem<C1, C2>& s, int rg,
                                         int cg,
                                         float (&z)[Tile<C2>::RPT][8]) {
  product<C1, C2>(s.ys, s.w2, rg, cg, z);
  const float* sc2 = s.st2(0);
  const float* bi2 = s.st2(1);
#pragma unroll
  for (int i = 0; i < Tile<C2>::RPT; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      z[i][c] = bn_z(z[i][c], sc2[cg * 8 + c], bi2[cg * 8 + c]);
}

// The running max of leaky(z2) over the slots of the gathered rows of one
// cloud's queries q0 .. q0 + nq - 1, written to out [m, C2] of the cloud:
// the eval kernels' whole chain after the neighbour lists are known.
template <int C1, int C2>
__device__ __forceinline__ void gather_max(const Edge2Smem<C1, C2>& s,
                                           const int* nbr,
                                           const __nv_bfloat16* q,
                                           const float* off, float* out,
                                           int q0, int nq, int k,
                                           float slope) {
  using T2 = Tile<C2>;
  const int rg = threadIdx.x / T2::NCG, cg = threadIdx.x % T2::NCG;
  float mx[T2::RPT][8];
#pragma unroll
  for (int i = 0; i < T2::RPT; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) mx[i][c] = -INFINITY;
  for (int kk = 0; kk < k; ++kk) {
    __syncthreads();  // the last slot's product is done with s.ys
    load_y1_gather(s, nbr, q, off, q0, nq, kk, slope);
    __syncthreads();
    float z[T2::RPT][8];
    chain_z2(s, rg, cg, z);
#pragma unroll
    for (int i = 0; i < T2::RPT; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) mx[i][c] = fmaxf(mx[i][c], leaky(z[i][c], slope));
  }
#pragma unroll
  for (int i = 0; i < T2::RPT; ++i) {
    const int r = rg * T2::RPT + i;
    if (r >= nq) continue;
    float* o = out + (size_t)(q0 + r) * C2 + cg * 8;
    *reinterpret_cast<float4*>(o) =
        make_float4(mx[i][0], mx[i][1], mx[i][2], mx[i][3]);
    *reinterpret_cast<float4*>(o + 4) =
        make_float4(mx[i][4], mx[i][5], mx[i][6], mx[i][7]);
  }
}

__host__ __device__ inline long long center_tiles(long long centers) {
  return (centers + kRows - 1) / kRows;
}

}  // namespace pcl
