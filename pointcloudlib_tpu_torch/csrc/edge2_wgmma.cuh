// The two-layer EdgeConv's chain on Hopper's tensor cores, shared by the
// backward passes (edge2_bwd_p1.cu, edge2_bwd_p2.cu) so that both form
// h2, its max-pool ties and its leaky masks bit for bit alike, and by the
// eval kernel with the kNN inside (edge2_knn_eval.cu, its product alone:
// no gradient follows, so it needs no tie walk and no kink band).
//
// A block of two warpgroups walks tiles of 64 centers (edge2.cuh's
// layout: a tile's row r is slot kk of center c0 + r, its k slots one
// tile after another), each tile twice: pass A folds each center's max
// of leaky(z2) and its tie count (fold_ties), then turns the counts into
// the shares dout / ties (tie_shares); pass B does the kernel's own
// work. At every step (one slot of one pass), warpgroup g forms h2's
// columns [C2/2 g, C2/2 g + C2/2) by wgmma (chain_h2: m64n32k16 at C2 =
// 64, y1 the K-major A in the core-matrix layout of wgmma_tile.cuh, W2
// the MN-major B), and each thread keeps the accumulator fragment's rows
// and columns (fixed centers and channels) for the whole tile. Both
// passes run the same instructions on the same bf16 operands, so pass
// B's h2 is pass A's, and a row's h2 does not depend on where it sits in
// the tile: equal h1 rows give equal h2, which the max-pool's even tie
// split depends on. Where z2 lies within kKinkBand of 0, h2 is taken
// again as the plain product sums it (f32 FMAs in the order of k, as
// layer2_z of fused_sa_eval.cuh does near a bf16 rounding boundary):
// there a last-bit difference of the sum turns dz2's factor between 1
// and slope, and a card test met one such z2 (0 in the plain product,
// 2e-8 in exact arithmetic) whose center moved ps2 by 0.8 |dout|.

#pragma once

#include "edge2.cuh"
#include "fused_sa_chain.cuh"

namespace pcl {

// Half-width of the band around z2 = 0 where the leaky mask's decision
// is taken again from the plain product's sum: two f32 sums of the 64
// products of a row differ by ~1e-5 at these widths (64 u sum|y1 w2|),
// far inside it.
constexpr float kKinkBand = 0x1p-13f;

// h2[r, c] = y1[r, :] . W2[:, c] as the plain product sums it: f32 FMAs
// in the order of k, from 0 (y1: the first C1 columns of the tile lt,
// width WL; w2s: core-matrix [C1, C2]).
template <int C1, int C2, int WL>
__device__ __forceinline__ float seq_h2(const __nv_bfloat16* lt,
                                        const __nv_bfloat16* w2s, int r,
                                        int c) {
  const __nv_bfloat16* wc = w2s + wg::cm(0, c, C2);
  float acc = 0.0f;
#pragma unroll
  for (int k0 = 0; k0 < C1; k0 += 8) {
    const uint4 y = *reinterpret_cast<const uint4*>(lt + wg::cm(r, k0, WL));
#pragma unroll
    for (int i = 0; i < 8; ++i)
      acc = fmaf(bf_at(y, i), __bfloat162float(wc[wg::cm(k0 + i, 0, C2)]),
                 acc);
  }
  return acc;
}

// A block's place in its walk: the first center of its tile, the pass
// and the slot, advanced by increments (no divisions a step).
struct E2Walk {
  long long c0;
  int pass, kk;
  __device__ void next(int k, long long stride) {
    if (++kk < k) return;
    kk = 0;
    if (++pass < 2) return;
    pass = 0;
    c0 += stride;
  }
};

// Issues h[v] += y1 . W2 over this warpgroup's columns (h zeroed by the
// caller) and commits it without waiting: the eval kernel
// (edge2_knn_eval.cu) stages its next tile meanwhile, then waits
// (wg::wait<0>, wg::fence_regs). lt: the y1 tile (its first C1 columns,
// width WL, staged and fenced for the async proxy); w2s: W2 core-matrix
// [C1, C2]; g: the warpgroup.
template <int C1, int C2, int WL>
__device__ __forceinline__ void chain_issue(float (&h)[C2 / 4],
                                            const __nv_bfloat16* lt,
                                            const __nv_bfloat16* w2s, int g) {
  constexpr int N2 = C2 / 2;  // chain columns a warpgroup
  wg::fence_regs(h);
  wg::begin();
  wg::issue<N2, 0, 1, C1 / 16>(h, wg::k_major(lt, WL, 0, 0),
                               wg::mn_major(w2s, C2, 0, g * N2));
  wg::commit();
}

// The chain of the backward passes: chain_issue waited for, then the
// kink band: z2 = bn_z(h2) within kKinkBand of 0 from the plain product's
// sum. t: the thread in its warpgroup.
template <int C1, int C2, int WL>
__device__ __forceinline__ void chain_h2(float (&h)[C2 / 4],
                                         const __nv_bfloat16* lt,
                                         const __nv_bfloat16* w2s,
                                         const float* sc2, const float* bi2,
                                         int g, int t) {
  constexpr int N2 = C2 / 2;
  chain_issue<C1, C2, WL>(h, lt, w2s, g);
  wg::wait<0>();
  wg::fence_regs(h);
  unsigned kink = 0;
#pragma unroll
  for (int v = 0; v < N2 / 2; ++v) {
    const int col = g * N2 + wg::frag_col(t, v >> 2, v & 1);
    if (fabsf(bn_z(h[v], sc2[col], bi2[col])) < kKinkBand) kink |= 1u << v;
  }
  while (kink) {
    const int v = __ffs(kink) - 1;
    kink &= kink - 1;
    const float hv = seq_h2<C1, C2, WL>(lt, w2s, wg::frag_row(t, (v >> 1) & 1),
                                        g * N2 + wg::frag_col(t, v >> 2, v & 1));
#pragma unroll
    for (int i = 0; i < N2 / 2; ++i)
      if (i == v) h[i] = hv;
  }
}

// Pass A at one slot: each fragment element's running max of
// leaky(z2) over the center's slots and how many reach it (mx, tg;
// -inf and 0 before the first slot).
template <int C2>
__device__ __forceinline__ void fold_ties(const float (&h)[C2 / 4],
                                          float (&mx)[C2 / 4],
                                          float (&tg)[C2 / 4],
                                          const float* sc2, const float* bi2,
                                          float slope, int g, int t) {
  constexpr int N2 = C2 / 2;
#pragma unroll
  for (int v = 0; v < N2 / 2; ++v) {
    const int col = g * N2 + wg::frag_col(t, v >> 2, v & 1);
    const float y = leaky(bn_z(h[v], sc2[col], bi2[col]), slope);
    if (y > mx[v]) {
      mx[v] = y;
      tg[v] = 1.0f;
    } else if (y == mx[v]) {
      tg[v] += 1.0f;
    }
  }
}

// After pass A's last slot: the tie counts into the shares dout / ties
// of the plain version's even tie split (0 on rows at or past nc).
// dout [centers, C2].
template <int C2>
__device__ __forceinline__ void tie_shares(float (&tg)[C2 / 4],
                                           const float* dout, long long c0,
                                           int nc, int g, int t) {
  constexpr int N2 = C2 / 2;
#pragma unroll
  for (int v = 0; v < N2 / 2; ++v) {
    const int r = wg::frag_row(t, (v >> 1) & 1);
    const int col = g * N2 + wg::frag_col(t, v >> 2, v & 1);
    tg[v] = r < nc ? __fdiv_rn(dout[(size_t)(c0 + r) * C2 + col], tg[v])
                   : 0.0f;
  }
}

}  // namespace pcl
