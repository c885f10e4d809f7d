// The two-layer EdgeConv's chain on Hopper's tensor cores, shared by the
// backward passes (edge2_bwd_p1.cu, edge2_bwd_p2.cu) so that both form
// h2, its max-pool ties and its leaky masks bit for bit alike, by the
// forward tails (edge2_tail.cu: the product alone, chain_issue; no
// gradient follows, so they need no tie walk and no kink band) and by
// the two eval kernels (edge2_knn_eval.cu, edge2_eval.cu: eval_tiles,
// the chain over gathered rows once the neighbour lists are known).
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
// caller) and commits it without waiting: the eval kernel and the tails
// (edge2_knn_eval.cu, edge2_tail.cu) stage their next tile meanwhile,
// then wait (wg::wait<0>, wg::fence_regs). lt: the y1 tile (its first C1
// columns, width WL, staged and fenced for the async proxy); w2s: W2
// core-matrix [C1, C2]; g: the warpgroup, one of WGS that share the
// tile's columns.
template <int C1, int C2, int WL, int WGS = 2>
__device__ __forceinline__ void chain_issue(float (&h)[C2 / (2 * WGS)],
                                            const __nv_bfloat16* lt,
                                            const __nv_bfloat16* w2s, int g) {
  constexpr int N2 = C2 / WGS;  // chain columns a warpgroup
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

// A step's place in eval_tiles: the tile of the block's centers and the
// slot.
struct E2Slot {
  int tile, kk;
  __device__ void next(int k) {
    if (++kk == k) {
      kk = 0;
      ++tile;
    }
  }
};

// The eval kernels' chain once the neighbour lists are known: centers
// 0 .. nq - 1 of a block (TILES tiles of kRows; rows of one cloud), their
// lists slot-major in shared memory (slot kk of center ql at nbr[kk * Q
// + ql], Q = TILES * kRows: a slot's entries of a tile side by side, so
// the gathers read them without bank conflicts; visible to every thread),
// q [n, C1] bf16 of the cloud, off and out the block's first rows
// ([nq, C1] f32 and [nq, C2] f32), st the folded rows of both layers,
// w2 [C1, C2] bf16 in global memory; w2s (core-matrix [C1, C2]) and ys
// (two core-matrix y1 tiles [kRows, C1]) in shared memory. A step is one
// slot of one tile:
//   - warpgroup g forms h2's columns [32 g, 32 g + 32) by wgmma
//     (chain_issue, m64n32k16: y1 the K-major A, W2 the MN-major B,
//     staged once);
//   - while it runs, one warp a group of 8 channels stages the next
//     step's y1 = bf16(leaky(BN1(float(Q[j]) - Off[i]))) into the other
//     y1 tile, from Q rows gathered by 16-byte __ldg a step before (Off's
//     rows and the BN rows stay in registers);
//   - each thread folds max leaky(BN2(h2)) into its accumulator
//     fragment's fixed rows and channels, and writes them to out after
//     the tile's last slot.
// One barrier a step; every thread of the block (256) calls it.
template <int TILES, int C1, int C2>
__device__ __forceinline__ void eval_tiles(
    const int* nbr, int nq, int k, const __nv_bfloat16* q, const float* off,
    float* out, const float* st, const __nv_bfloat16* w2,
    __nv_bfloat16* w2s, __nv_bfloat16* ys, float slope) {
  constexpr int Q = TILES * kRows, N2 = C2 / 2;  // h2's columns a warpgroup
  static_assert(C1 == 8 * kWarps && N2 == 32,
                "a warp a channel group of y1; m64n32 products");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = tid / wg::kWGThreads, t = tid % wg::kWGThreads;
  stage_w<C1, C2>(w2, w2s, kThreads);

  // staging: rows lane and lane + 32 of a tile, channels sc .. sc + 7,
  // their BN1 rows; the fragment's columns g N2 + frag_col(t, n, j) and
  // their BN2 rows at [2 n + j]
  const int sc = warp * 8;
  float sc1[8], bi1[8], sc2[N2 / 4], bi2[N2 / 4];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    sc1[c] = st[sc + c];
    bi1[c] = st[C1 + sc + c];
  }
#pragma unroll
  for (int nn = 0; nn < N2 / 8; ++nn)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = g * N2 + wg::frag_col(t, nn, j);
      sc2[2 * nn + j] = st[4 * C1 + col];
      bi2[2 * nn + j] = st[4 * C1 + C2 + col];
    }
  const int steps = (nq + kRows - 1) / kRows * k;
  float offr[2][8];  // Off of the staging rows of the tile being staged
  uint4 qv[2];       // their gathered Q rows at the slot being staged

  auto gather = [&](const E2Slot& p) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ql = p.tile * kRows + lane + 32 * i;
      if (ql < nq)
        qv[i] = __ldg(reinterpret_cast<const uint4*>(
            q + (size_t)nbr[p.kk * Q + ql] * C1 + sc));
    }
  };
  auto stage = [&](const E2Slot& p, __nv_bfloat16* dst) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = lane + 32 * i, ql = p.tile * kRows + r;
      uint4 yv = make_uint4(0, 0, 0, 0);
      if (ql < nq) {
        if (p.kk == 0) {
          const float4* o =
              reinterpret_cast<const float4*>(off + (size_t)ql * C1 + sc);
          const float4 oa = o[0], ob = o[1];
          offr[i][0] = oa.x, offr[i][1] = oa.y, offr[i][2] = oa.z;
          offr[i][3] = oa.w, offr[i][4] = ob.x, offr[i][5] = ob.y;
          offr[i][6] = ob.z, offr[i][7] = ob.w;
        }
        float y[8];
#pragma unroll
        for (int c = 0; c < 8; ++c)
          y[c] = leaky(bn_z(__fsub_rn(bf_at(qv[i], c), offr[i][c]), sc1[c],
                            bi1[c]),
                       slope);
        yv = pack8(y);
      }
      *reinterpret_cast<uint4*>(dst + wg::cm(r, sc, C1)) = yv;
    }
  };

  E2Slot cur{0, 0}, ahead{0, 0};
  gather(ahead);
  stage(ahead, ys);
  ahead.next(k);
  if (steps > 1) gather(ahead);
  wg::fence_to_async();
  __syncthreads();  // W2 and the first y1 tile are staged
  float mx[N2 / 2];
#pragma unroll
  for (int v = 0; v < N2 / 2; ++v) mx[v] = -INFINITY;
  for (int s = 0; s < steps; ++s, cur.next(k)) {
    float h[N2 / 2];
#pragma unroll
    for (int v = 0; v < N2 / 2; ++v) h[v] = 0.0f;
    chain_issue<C1, C2, C1>(h, ys + (s & 1) * kRows * C1, w2s, g);
    if (s + 1 < steps) {  // ahead is step s + 1, its rows gathered
      stage(ahead, ys + ((s + 1) & 1) * kRows * C1);
      ahead.next(k);
      if (s + 2 < steps) gather(ahead);
    }
    wg::wait<0>();
    wg::fence_regs(h);
#pragma unroll
    for (int v = 0; v < N2 / 2; ++v) {
      const int nj = 2 * (v >> 2) + (v & 1);
      mx[v] = fmaxf(mx[v], leaky(bn_z(h[v], sc2[nj], bi2[nj]), slope));
    }
    if (cur.kk == k - 1) {  // the tile's last slot: its rows of out
#pragma unroll
      for (int nn = 0; nn < N2 / 8; ++nn)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int ql = cur.tile * kRows + wg::frag_row(t, i);
          const int v = 4 * nn + 2 * i;
          if (ql < nq)
            *reinterpret_cast<float2*>(
                out + (size_t)ql * C2 + g * N2 + wg::frag_col(t, nn, 0)) =
                make_float2(mx[v], mx[v + 1]);
        }
#pragma unroll
      for (int v = 0; v < N2 / 2; ++v) mx[v] = -INFINITY;
    }
    wg::fence_to_async();
    __syncthreads();  // the next y1 tile is staged; this one is free
  }
}

}  // namespace pcl
