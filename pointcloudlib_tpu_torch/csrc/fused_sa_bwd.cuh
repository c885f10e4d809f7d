// Pieces the two set-abstraction backward passes share on the tensor
// cores (fused_sa_bwd_p1.cu, fused_sa_bwd_p2.cu), beside the forward
// chain's staging (fused_sa_chain.cuh): the max-pool gradient and the
// per-channel row sums in the accumulator fragment of wgmma_tile.cuh.
//
// Two warpgroups (a pair, 256 threads) work on one 64-row tile at a
// time; a block holds one or two pairs that share the staged weights and
// walk their own tiles, synchronized by a named barrier each. Every
// product of a tile is split between the pair's warpgroups by output
// columns: warpgroup g computes columns [g * N, (g + 1) * N) of an
// [64, 2N] result, so a thread holds two rows (frag_row) of N / 4
// columns. Per-center and per-channel reductions over rows go through
// the eight lanes that share a column (rows8_*), then one shared-memory
// atomic a column and warp. Every row runs the same instruction sequence
// whatever its slot, so repeat-first padding rows (replicas of slot 0)
// come out bit-identical to slot 0, which the max-pool's tie split
// depends on.

#pragma once

#include "fused_sa_chain.cuh"

namespace pcl {

constexpr int kPairThreads = 2 * wg::kWGThreads;

// Barrier of pair p (named barrier p + 1; 0 is __syncthreads).
__device__ __forceinline__ void pair_sync(int p) {
  bar_sync<kPairThreads>(p + 1);
}

// The max-pool gradient at z3 for a tile of whole centers (k divides
// 64), in place on this thread's fragment of z3 (columns c0 + frag_col
// of C3): dz3 = (z3 > 0 && relu(z3) == max) ? dout / #ties : 0, the
// max and tie count over the center's k slots, replicas included.
// mx / ts are [64 / k, C3] shared arrays zeroed before the call; each
// tie count is replaced by its share dout / #ties, one division a
// center and channel. dout_tile is the tile's first center's row.
// Contains three barriers of pair p.
template <int N, int C3>
__device__ __forceinline__ void frag_maxpool_dz(float (&z)[N / 2], int t,
                                                int c0, int k,
                                                const float* dout_tile,
                                                float* mx, int* ts, int p) {
  const bool lead = (t & 31) < 4;
  const int cl0 = wg::frag_row(t, 0) / k, cl1 = wg::frag_row(t, 1) / k;
  const bool one = cl0 == cl1;  // k >= 16: both rows in one center
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int ch = c0 + wg::frag_col(t, n, j);
      const float v0 = fmaxf(z[4 * n + j], 0.0f);
      const float v1 = fmaxf(z[4 * n + 2 + j], 0.0f);
      if (one) {
        const float m = wg::rows8_max(fmaxf(v0, v1));
        if (lead)
          atomicMax(reinterpret_cast<int*>(mx + cl0 * C3 + ch),
                    __float_as_int(m));
      } else {
        const float m0 = wg::rows8_max(v0);
        const float m1 = wg::rows8_max(v1);
        if (lead) {
          atomicMax(reinterpret_cast<int*>(mx + cl0 * C3 + ch),
                    __float_as_int(m0));
          atomicMax(reinterpret_cast<int*>(mx + cl1 * C3 + ch),
                    __float_as_int(m1));
        }
      }
    }
  pair_sync(p);
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int ch = c0 + wg::frag_col(t, n, j);
      const float e0 = fmaxf(z[4 * n + j], 0.0f) == mx[cl0 * C3 + ch];
      const float e1 = fmaxf(z[4 * n + 2 + j], 0.0f) == mx[cl1 * C3 + ch];
      if (one) {
        const float c = wg::rows8_sum(e0 + e1);
        if (lead) atomicAdd(ts + cl0 * C3 + ch, (int)c);
      } else {
        const float c0s = wg::rows8_sum(e0);
        const float c1s = wg::rows8_sum(e1);
        if (lead) {
          atomicAdd(ts + cl0 * C3 + ch, (int)c0s);
          atomicAdd(ts + cl1 * C3 + ch, (int)c1s);
        }
      }
    }
  pair_sync(p);
  float* sh = reinterpret_cast<float*>(ts);
  const int cpt = centers_per_tile(k);
  for (int e = t; e < cpt * N; e += wg::kWGThreads) {
    const int i = (e / N) * C3 + c0 + e % N;
    sh[i] = __fdiv_rn(dout_tile[i], (float)ts[i]);
  }
  pair_sync(p);
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int at = (i ? cl1 : cl0) * C3 + c0 + wg::frag_col(t, n, j);
        float& v = z[4 * n + 2 * i + j];
        v = (v > 0.0f && fmaxf(v, 0.0f) == mx[at]) ? sh[at] : 0.0f;
      }
}

// For a center spanning several tiles (k a multiple of 64): folds this
// thread's (max, tie count) of relu(z3) into mc[C3], one 64-bit word a
// channel, the max's bits above the count, zeroed before the center.
template <int N>
__device__ __forceinline__ void frag_tie_merge(const float (&z)[N / 2], int t,
                                               int c0,
                                               unsigned long long* mc) {
  const bool lead = (t & 31) < 4;
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float v0 = fmaxf(z[4 * n + j], 0.0f);
      const float v1 = fmaxf(z[4 * n + 2 + j], 0.0f);
      const float m = wg::rows8_max(fmaxf(v0, v1));
      const unsigned cnt =
          (unsigned)wg::rows8_sum((float)(v0 == m) + (float)(v1 == m));
      if (!lead) continue;
      const unsigned mb = __float_as_uint(m);
      unsigned long long* slot = mc + c0 + wg::frag_col(t, n, j);
      unsigned long long old = *slot;
      while (true) {
        const unsigned ob = (unsigned)(old >> 32);
        if (mb < ob) break;
        const unsigned long long next =
            mb > ob ? ((unsigned long long)mb << 32) | cnt : old + cnt;
        const unsigned long long seen = atomicCAS(slot, old, next);
        if (seen == old) break;
        old = seen;
      }
    }
}

// z3 -> dz3 from the folded words of frag_tie_merge; dout_row is the
// center's output gradient.
template <int N>
__device__ __forceinline__ void frag_merged_dz(float (&z)[N / 2], int t,
                                               int c0, const float* dout_row,
                                               const unsigned long long* mc) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int ch = c0 + wg::frag_col(t, n, j);
      const unsigned long long w = mc[ch];
      const float m = __uint_as_float((unsigned)(w >> 32));
      const float share =
          __fdiv_rn(dout_row[ch], (float)(unsigned)(w & 0xffffffffu));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float& v = z[4 * n + 2 * i + j];
        v = (v > 0.0f && fmaxf(v, 0.0f) == m) ? share : 0.0f;
      }
    }
}

// Adds the block's shared-memory sums red[n] into out[n].
__device__ __forceinline__ void flush_red(const float* red, float* out,
                                          int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) atomicAdd(out + i, red[i]);
}

// The tiles a pair walks: units (a tile of whole centers, or the tiles
// of one center) first, first + stride, ...; a unit whose center spans
// tpc > 1 tiles is walked twice (pass 0 folds the max and tie count,
// pass 1 does the work). Step it of the walk:
struct Walk {
  long long first, stride, iters;
  int tpc, np;
  __device__ Walk(long long units, long long first_, long long stride_,
                  int tpc_)
      : first(first_), stride(stride_), tpc(tpc_), np(tpc_ > 1 ? 2 : 1) {
    const long long mine =
        first < units ? (units - first + stride - 1) / stride : 0;
    iters = mine * np * tpc;
  }
  __device__ long long unit(long long it) const {
    return first + it / (np * tpc) * stride;
  }
  __device__ int step(long long it) const { return (int)(it % (np * tpc)); }
  __device__ int pass(long long it) const {
    return np == 2 ? step(it) / tpc : 1;
  }
  __device__ size_t tile(long long it) const {
    return (size_t)unit(it) * tpc + step(it) % tpc;
  }
};

}  // namespace pcl
