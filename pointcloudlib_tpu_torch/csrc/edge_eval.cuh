// The eval half of the eval-mode EdgeConv kernels that reduce a center's
// k neighbour rows in registers: the select route of the kernel with the
// kNN inside (edge_knn_eval.cu, after its selection; a warp a center) and
// the center route of the one that takes a given index (edge_eval.cu;
// C/8 lanes a center). For one center i with its neighbour list nbr (in
// shared memory, read only):
//   out[i, c] = max over kk of
//       leaky(sc[c] * (float(Q[nbr[kk], c]) - Off[i, c]) + bi[c])
// A lane owns 8 channels, C/8 lanes a row (F1Lanes of fused_sa_f1.cuh,
// pass 1's write half) and a center's lanes take W/(C/8) rows an
// instruction: each neighbour's Q row comes from L2 by 16-byte __ldg, U
// of them in flight a lane, the lane's running reduction stays in
// registers, folds across the center's row groups by shuffles, and out
// goes by 16-byte stores.
//
// Two reductions, both bit-identical to the plain version (the max of a
// set does not depend on its order):
// - eval_center, the plain order: every slot's leaky(BN(.)) from the
//   plain version's rounded operations, then the max;
// - eval_center_extreme, the extreme first. Every rounded step of
//   g(v) = leaky(bn_z(__fsub_rn(v, off), sc, bi)) is monotone in v:
//   __fsub_rn(v, off) does not decrease as v grows, __fmul_rn(h, sc) does
//   not decrease where sc > 0 and does not increase where sc < 0,
//   __fadd_rn(z, bi) does not decrease, and leaky (slope > 0) does not
//   decrease. Round to nearest is itself monotone, so each step keeps the
//   order of its input. Hence max over kk of g(Q_kk) = g(max Q_kk) where
//   sc > 0 and g(min Q_kk) where sc < 0; where sc = 0 every g(Q_kk) is the
//   same value up to the sign of a zero, which compares equal. The max
//   of the bf16 rows is exact (bf16 to f32 keeps the order), so the warp
//   takes max.bf16x2 of the rows with the sign bit of each channel whose
//   scale is negative flipped (max of -Q is -(min of Q)), flips it back
//   and applies g once a center: 2 operations a channel pair a row in
//   place of about 12. A zero's sign may differ from the plain version's
//   where a -0 and a +0 tie; they are equal values.

#pragma once

#include "edge_knn.cuh"
#include "fused_sa_f1.cuh"

namespace pcl {

// One warp takes the k slots of one center: qg the cloud's Q [N, C],
// offc the center's Off [C], outc its out row [C], nbr its list in shared
// memory; sc, bi the folded rows of this lane's 8 channels.
template <int C, int U = kF1Unroll>
__device__ __forceinline__ void eval_center(const __nv_bfloat16* qg,
                                            const float* offc, float* outc,
                                            const int* nbr, int k,
                                            const float (&sc)[8],
                                            const float (&bi)[8], float slope,
                                            int lane) {
  constexpr int L = F1Lanes<C>::L, RPW = F1Lanes<C>::RPW;
  const int cg = lane % L, rr = lane / L;
  const float4 oa = reinterpret_cast<const float4*>(offc)[2 * cg];
  const float4 ob = reinterpret_cast<const float4*>(offc)[2 * cg + 1];
  const float off[8] = {oa.x, oa.y, oa.z, oa.w, ob.x, ob.y, ob.z, ob.w};
  const __nv_bfloat16* qc = qg + cg * 8;
  float m[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) m[c] = -INFINITY;
  for (int j = rr; j < k; j += RPW * U) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int jj = j + u * RPW;
      if (jj < k)
        v[u] = __ldg(reinterpret_cast<const uint4*>(qc + (size_t)nbr[jj] * C));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j + u * RPW >= k) break;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        m[c] = fmaxf(m[c], leaky(bn_z(__fsub_rn(bf_at(v[u], c), off[c]),
                                      sc[c], bi[c]),
                                 slope));
    }
  }
#pragma unroll
  for (int o = L; o < 32; o *= 2)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      m[c] = fmaxf(m[c], __shfl_xor_sync(0xffffffffu, m[c], o));
  if (rr == 0) {
    float4* o = reinterpret_cast<float4*>(outc + cg * 8);
    o[0] = make_float4(m[0], m[1], m[2], m[3]);
    o[1] = make_float4(m[4], m[5], m[6], m[7]);
  }
}

// max.bf16x2 of two packed bf16 pairs (NaN-free inputs)
__device__ __forceinline__ uint32_t bf2_max(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("max.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
constexpr uint32_t kBf2NegInf = 0xff80ff80u;  // -inf in both halves

// The sign bits of the channels whose BN scale is negative, for the
// lane's 8 channels (stc: the lane's slice of the folded rows, sc at
// stc[0..7]): those channels take the min of their rows.
__device__ __forceinline__ void ev_flip(const float* stc, uint32_t (&flip)[4]) {
#pragma unroll
  for (int w = 0; w < 4; ++w)
    flip[w] = (stc[2 * w] < 0.0f ? 0x8000u : 0u) |
              (stc[2 * w + 1] < 0.0f ? 0x80000000u : 0u);
}

// eval_center's out with the extreme first, for a center of W lanes
// (W = 32: a warp; less: 32 / W centers a warp, lane the lane in the
// center's group): stc the lane's slice of the folded rows (sc at
// stc[0..7], bi at stc[C..C + 7]), flip its ev_flip. Only the running
// extremes (4 registers) and the rows in flight stay in registers across
// the gathers; off and the rows are read after them. outc == nullptr: the
// group's lanes take part in the shuffles and store nothing.
template <int C, int U, int W = 32>
__device__ __forceinline__ void eval_center_extreme(
    const __nv_bfloat16* qg, const float* offc, float* outc, const int* nbr,
    int k, const float* stc, const uint32_t (&flip)[4], float slope,
    int lane) {
  constexpr int L = F1Lanes<C>::L, RPW = W / L;
  static_assert(W % L == 0 && 32 % W == 0, "a center's lanes hold its rows");
  const int cg = lane % L, rr = lane / L;
  const __nv_bfloat16* qc = qg + cg * 8;
  uint32_t mx[4] = {kBf2NegInf, kBf2NegInf, kBf2NegInf, kBf2NegInf};
  for (int j = rr; j < k; j += RPW * U) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int jj = j + u * RPW;
      if (jj < k)
        v[u] = __ldg(reinterpret_cast<const uint4*>(qc + (size_t)nbr[jj] * C));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j + u * RPW >= k) break;
#pragma unroll
      for (int w = 0; w < 4; ++w)
        mx[w] = bf2_max(mx[w], word(v[u], w) ^ flip[w]);
    }
  }
#pragma unroll
  for (int o = L; o < W; o *= 2)
#pragma unroll
    for (int w = 0; w < 4; ++w)
      mx[w] = bf2_max(mx[w], __shfl_xor_sync(0xffffffffu, mx[w], o));
  if (rr != 0 || outc == nullptr) return;
  const uint4 ext = make_uint4(mx[0] ^ flip[0], mx[1] ^ flip[1],
                               mx[2] ^ flip[2], mx[3] ^ flip[3]);
  const float4* o4 = reinterpret_cast<const float4*>(offc + cg * 8);
  const float4* s4 = reinterpret_cast<const float4*>(stc);
  const float4 oa = o4[0], ob = o4[1];
  const float4 sa = __ldg(s4), sb = __ldg(s4 + 1);
  const float4 ba = __ldg(s4 + C / 4), bb = __ldg(s4 + C / 4 + 1);
  const float off[8] = {oa.x, oa.y, oa.z, oa.w, ob.x, ob.y, ob.z, ob.w};
  const float sc[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
  const float bi[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
  float r[8];
#pragma unroll
  for (int c = 0; c < 8; ++c)
    r[c] = leaky(bn_z(__fsub_rn(bf_at(ext, c), off[c]), sc[c], bi[c]), slope);
  float4* o = reinterpret_cast<float4*>(outc + cg * 8);
  o[0] = make_float4(r[0], r[1], r[2], r[3]);
  o[1] = make_float4(r[4], r[5], r[6], r[7]);
}

}  // namespace pcl
