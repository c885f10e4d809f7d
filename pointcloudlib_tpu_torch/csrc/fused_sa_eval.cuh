// The eval-mode chain shared by the two fused set-abstraction eval
// kernels (ball query inside: fused_sa_bq_eval.cu; from a given neighbour
// index: fused_sa_eval.cu). Once each center's neighbour slots and its
// number of live slots are known, both do the same: pack the tile's live
// (center, slot) rows densely, run them 64 rows at a time through
//   h1 = float(bf16 Q[b, nbr]) - off[b, center]
//   y1 = relu(h1*sc1 + bi1) -> bf16 -> h2 = y1 . W2 (f32 sums)
//   y2 = relu(h2*sc2 + bi2) -> bf16 -> h3 = y2 . W3 (f32 sums)
//   y3 = relu(h3*sc3 + bi3)
// and keep the max of y3 per center in shared memory. No grouped tensor
// reaches device memory.

#pragma once

#include "fused_sa_common.cuh"

namespace pcl {

struct EvalArgs {
  const __nv_bfloat16* q;      // [B, N, C1]
  const float* off;            // [B, M, C1]
  const float* st;             // sc1, bi1 [C1], sc2, bi2 [C2], sc3, bi3 [C3]
  const __nv_bfloat16* w2;     // [C1, C2]
  const __nv_bfloat16* w3;     // [C2, C3]
  float* out;                  // [B, M, C3]
  int n, m, k;
};

// Dynamic shared memory of a block of MT centers; a kernel's own arrays
// start at `end`.
template <int C1, int C2, int C3, int MT>
struct EvalLayout {
  static constexpr size_t w2 = 0;
  static constexpr size_t w3 = w2 + (size_t)C1 * C2 * 2;
  static constexpr size_t st = w3 + (size_t)C2 * C3 * 2;
  static constexpr size_t off = st + (size_t)2 * (C1 + C2 + C3) * 4;
  static constexpr size_t outm = off + (size_t)MT * C1 * 4;
  static constexpr size_t y1 = outm + (size_t)MT * C3 * 4;
  static constexpr size_t y2 = y1 + (size_t)kRows * (C1 + 8) * 2;
  static constexpr size_t end = y2 + (size_t)kRows * (C2 + 8) * 2;
};

// Stages the weights, the folded BN constants and the tile's off rows,
// and zeroes the running max (y3 >= 0). The caller's barrier follows.
template <int C1, int C2, int C3, int MT>
__device__ __forceinline__ void eval_stage(unsigned char* smem,
                                           const EvalArgs& a, int b, int m0,
                                           int mt) {
  using L = EvalLayout<C1, C2, C3, MT>;
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem + L::w2);
  __nv_bfloat16* w3s = reinterpret_cast<__nv_bfloat16*>(smem + L::w3);
  float* sts = reinterpret_cast<float*>(smem + L::st);
  float* offs = reinterpret_cast<float*>(smem + L::off);
  float* outm = reinterpret_cast<float*>(smem + L::outm);
  const int tid = threadIdx.x;
  for (int i = tid; i < C1 * C2 / 8; i += kThreads)
    reinterpret_cast<uint4*>(w2s)[i] = reinterpret_cast<const uint4*>(a.w2)[i];
  for (int i = tid; i < C2 * C3 / 8; i += kThreads)
    reinterpret_cast<uint4*>(w3s)[i] = reinterpret_cast<const uint4*>(a.w3)[i];
  for (int i = tid; i < 2 * (C1 + C2 + C3); i += kThreads) sts[i] = a.st[i];
  const float* offg = a.off + ((size_t)b * a.m + m0) * C1;
  for (int i = tid; i < mt * C1; i += kThreads) offs[i] = offg[i];
  for (int i = tid; i < MT * C3; i += kThreads) outm[i] = 0.0f;
}

// The chain and the max over the first live[c] slots of each of the
// tile's mt centers, then the tile's rows of out. nbr[c * k + j] is the
// source point of center c's slot j (shared or global memory), live[c]
// >= 1 its number of slots to run (shared memory). Called by every
// thread after a barrier that follows eval_stage and the writes of nbr
// and live.
template <int C1, int C2, int C3, int MT>
__device__ __forceinline__ void eval_chain(unsigned char* smem,
                                           const EvalArgs& a, int b, int m0,
                                           int mt, const int* nbr,
                                           const int* live) {
  static_assert(MT <= 32, "one warp scans the tile's row counts");
  using L = EvalLayout<C1, C2, C3, MT>;
  using T2 = Tile<C2>;
  using T3 = Tile<C3>;
  static_assert(T3::ACTIVE == kThreads, "every thread owns a tile of h3");
  const __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem + L::w2);
  const __nv_bfloat16* w3s = reinterpret_cast<__nv_bfloat16*>(smem + L::w3);
  const float* sts = reinterpret_cast<float*>(smem + L::st);
  const float* offs = reinterpret_cast<float*>(smem + L::off);
  float* outm = reinterpret_cast<float*>(smem + L::outm);
  __nv_bfloat16* y1s = reinterpret_cast<__nv_bfloat16*>(smem + L::y1);
  __nv_bfloat16* y2s = reinterpret_cast<__nv_bfloat16*>(smem + L::y2);
  __shared__ int s_rowoff[MT + 1];
  __shared__ int s_rowc[kRows];
  __shared__ int s_rowsrc[kRows];

  const float* sc1 = sts;
  const float* bi1 = sc1 + C1;
  const float* sc2 = bi1 + C1;
  const float* bi2 = sc2 + C2;
  const float* sc3 = bi2 + C2;
  const float* bi3 = sc3 + C3;

  const int k = a.k;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  // ---- dense packing of the tile's live rows
  if (warp == 0) {
    int v = lane < mt ? live[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int u = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += u;
    }
    if (lane < MT) s_rowoff[lane + 1] = v;
    if (lane == 0) s_rowoff[0] = 0;
  }
  __syncthreads();
  const int total = s_rowoff[mt];

  const int rg2 = tid / T2::NCG, cg2 = tid % T2::NCG;
  const int rg3 = tid / T3::NCG, cg3 = tid % T3::NCG;
  const __nv_bfloat16* qg = a.q + (size_t)b * a.n * C1;

  for (int base = 0; base < total; base += kRows) {
    if (tid < kRows) {
      const int g = base + tid;
      int c = -1, src = 0;
      if (g < total) {
        c = 0;
        while (s_rowoff[c + 1] <= g) ++c;
        src = nbr[c * k + (g - s_rowoff[c])];
      }
      s_rowc[tid] = c;
      s_rowsrc[tid] = src;
    }
    __syncthreads();

    // layer 1: gather Q, subtract off, BN, ReLU, round to bf16
    for (int e = tid; e < kRows * (C1 / 2); e += kThreads) {
      const int r = e / (C1 / 2);
      const int cc = (e % (C1 / 2)) * 2;
      const int c = s_rowc[r];
      float v0 = 0.0f, v1 = 0.0f;
      if (c >= 0) {
        const uint32_t qq = *reinterpret_cast<const uint32_t*>(
            qg + (size_t)s_rowsrc[r] * C1 + cc);
        v0 = bn_relu(__fsub_rn(bf_lo(qq), offs[c * C1 + cc]), sc1[cc], bi1[cc]);
        v1 = bn_relu(__fsub_rn(bf_hi(qq), offs[c * C1 + cc + 1]), sc1[cc + 1],
                     bi1[cc + 1]);
      }
      *reinterpret_cast<uint32_t*>(y1s + r * (C1 + 8) + cc) = pack2(v0, v1);
    }
    __syncthreads();

    // layer 2: y2 = bf16(relu(BN(y1 . W2)))
    if (T2::active()) {
      float acc[T2::RPT][8];
      product<C1, C2>(y1s, w2s, rg2, cg2, acc);
      store_bn_relu<C2>(acc, sc2, bi2, y2s, rg2, cg2);
    }
    __syncthreads();

    // layer 3: y3 = relu(BN(y2 . W3)), folded into the per-center max
    {
      float acc[T3::RPT][8];
      product<C2, C3>(y2s, w3s, rg3, cg3, acc);
      int cur = -1;
      float mx[8];
#pragma unroll
      for (int i = 0; i < T3::RPT; ++i) {
        const int c = s_rowc[rg3 * T3::RPT + i];
        if (c != cur) {
          if (cur >= 0) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
              atomicMax(reinterpret_cast<int*>(outm + cur * C3 + cg3 * 8 + j),
                        __float_as_int(mx[j]));
          }
          cur = c;
#pragma unroll
          for (int j = 0; j < 8; ++j) mx[j] = 0.0f;
        }
        if (c >= 0) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int ch = cg3 * 8 + j;
            mx[j] = fmaxf(mx[j], bn_relu(acc[i][j], sc3[ch], bi3[ch]));
          }
        }
      }
      if (cur >= 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          atomicMax(reinterpret_cast<int*>(outm + cur * C3 + cg3 * 8 + j),
                    __float_as_int(mx[j]));
      }
    }
    __syncthreads();
  }

  float* og = a.out + ((size_t)b * a.m + m0) * C3;
  for (int i = tid; i < mt * C3; i += kThreads) og[i] = outm[i];
}

// The block tile per width triple: what fits one block's shared memory.
#define PCL_EVAL_WIDTHS(X) \
  X(32, 32, 64, 32)        \
  X(64, 64, 128, 32)       \
  X(64, 96, 128, 32)       \
  X(128, 128, 256, 16)

}  // namespace pcl
