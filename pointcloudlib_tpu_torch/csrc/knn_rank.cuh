// Rank selection over one query's d2 row, one warp a query, for Hopper
// (sm_90a): the pieces that knn_gather.cu's select route (the fused kNN
// + gather) and knn.cu's rank route (the kNN for lists longer than 40)
// share.
//
// A warp forms its query's row of d2 over the N points in knn_plain's
// operations and order (products and sums rounded one at a time, no FMA;
// ops/geometry.py square_distance), as order keys in shared memory:
//   * at C = 3, where a block's queries share a batch, the block first
//     stages the cloud as (x, y, z, |p|^2) (kg_stage_cloud); the lanes
//     form the d2 of consecutive points (kg_key_row);
//   * a point's order key is its d2's bits with the sign cleared (d2 >=
//     0, so the bits order as the values; -0 counts as +0), then its
//     index.
// kg_select then chooses the R smallest (key, index) words without
// sorting: the R-th smallest key by bisection on the 31 key bits, each
// step one count of the keys below a bound, read four at a time from
// shared memory by all 32 lanes and summed by redux.sync. It stops as
// soon as exactly R keys lie below the bound. Once the bounds hold at
// most kKgCand keys, those go to registers and the bisection goes on
// there; where equal keys straddle rank R, a second bisection on the
// index takes the lower indices among them. The R chosen points go by
// ballots into a list of 64-bit (key, index) words, in no order; a
// word's rank is the count of smaller words in the list (the callers
// do that last step, each for its own outputs).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pcl {

constexpr int kKgMaxWarps = 8;               // queries a block
constexpr int kKgSmem = 227 * 1024;          // shared memory a block may use
constexpr int kKgCand = 64;                  // candidates a warp's bisection
                                             // finishes in registers

__device__ __forceinline__ bool kg_better(float d, int j, float bd, int bj) {
  return d < bd || (d == bd && j < bj);
}

// d2 of query qp against point pj, in knn_plain's order (q2 given)
__device__ __forceinline__ float kg_d2(const float* qp, const float* pj,
                                       float q2, int c) {
  float inner = __fmul_rn(qp[0], __ldg(pj));
  float p2 = __fmul_rn(__ldg(pj), __ldg(pj));
  for (int ch = 1; ch < c; ++ch) {
    const float v = __ldg(pj + ch);
    inner = __fadd_rn(inner, __fmul_rn(qp[ch], v));
    p2 = __fadd_rn(p2, __fmul_rn(v, v));
  }
  return fmaxf(__fadd_rn(__fsub_rn(q2, __fmul_rn(2.0f, inner)), p2), 0.0f);
}

__device__ __forceinline__ float kg_q2(const float* qp, int c) {
  float q2 = __fmul_rn(qp[0], qp[0]);
  for (int ch = 1; ch < c; ++ch) q2 = __fadd_rn(q2, __fmul_rn(qp[ch], qp[ch]));
  return q2;
}

// A d2's order key: its bits with the sign cleared (d2 >= 0; -0 is +0).
__device__ __forceinline__ uint32_t kg_key(float d) {
  return __float_as_uint(d) & 0x7fffffffu;
}

// Keys of the row below thr (lane reads words lane, lane + 32, ...),
// summed over the warp. Padding keys hold 0xffffffff, above every bound.
__device__ __forceinline__ int kg_count(const uint4* row4, int words,
                                        int lane, uint32_t thr) {
  int c = 0;
#pragma unroll 4
  for (int i = lane; i < words; i += 32) {
    const uint4 v = row4[i];
    c += (v.x < thr) + (v.y < thr) + (v.z < thr) + (v.w < thr);
  }
  return __reduce_add_sync(0xffffffffu, c);
}

// Keys equal to key with index below jthr, summed over the warp.
__device__ __forceinline__ int kg_count_ties(const uint4* row4, int words,
                                             int lane, uint32_t key,
                                             int jthr) {
  int c = 0;
  for (int i = lane; i < words; i += 32) {
    const uint4 v = row4[i];
    const int j = 4 * i;
    c += (v.x == key && j < jthr) + (v.y == key && j + 1 < jthr) +
         (v.z == key && j + 2 < jthr) + (v.w == key && j + 3 < jthr);
  }
  return __reduce_add_sync(0xffffffffu, c);
}

// The ballots' compaction: where sel, w goes to out[base + rank among the
// lanes]; returns base plus the warp's count.
__device__ __forceinline__ int kg_push(bool sel, unsigned long long w,
                                       unsigned long long* out, int base,
                                       int lane) {
  const unsigned bal = __ballot_sync(0xffffffffu, sel);
  if (sel) out[base + __popc(bal & ((1u << lane) - 1u))] = w;
  return base + __popc(bal);
}

__device__ __forceinline__ unsigned long long kg_word(uint32_t key, int j) {
  return (unsigned long long)key << 32 | (unsigned)j;
}

// Bytes of one warp's part of a select block: its key row (n rounded up
// to whole uint4 words), its list of R words, the candidates' kKgCand
// words and its k slots, rounded up to 16 bytes.
__host__ __device__ inline size_t kg_sel_warp_bytes(int n, int k, int ranks) {
  const size_t row = (size_t)((n + 3) / 4) * 16;
  return (row + 8 * ((size_t)ranks + kKgCand) + 4 * (size_t)k + 15) / 16 *
         16;
}

// Queries a block: as many warps as shared memory holds beside fixed
// bytes, at most kKgMaxWarps; 0 when one warp's part does not fit.
inline int kg_fit(size_t warp_bytes, size_t fixed = 0) {
  if (fixed + warp_bytes > (size_t)kKgSmem) return 0;
  const size_t fit = (kKgSmem - fixed) / warp_bytes;
  return fit < (size_t)kKgMaxWarps ? (int)fit : kKgMaxWarps;
}

// The block's cloud pg [n, 3] into shared memory as (x, y, z, |p|^2),
// |p|^2 in the plain order; every thread of the block calls it.
__device__ __forceinline__ void kg_stage_cloud(const float* __restrict__ pg,
                                               int n, float4* dst) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float x = __ldg(pg + 3 * j), y = __ldg(pg + 3 * j + 1),
                z = __ldg(pg + 3 * j + 2);
    dst[j] = make_float4(
        x, y, z,
        __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                  __fmul_rn(z, z)));
  }
  __syncthreads();
}

// The warp's key row of query qp (|q|^2 = q2) over the n points, lanes on
// consecutive points, padded with 0xffffffff to 4 * words: from the staged
// cloud where STAGED (C = 3), else from pb [n, c] in global memory.
template <bool STAGED>
__device__ __forceinline__ void kg_key_row(const float* qp, float q2,
                                           const float4* cloud,
                                           const float* pb, int n, int c,
                                           int words, uint32_t* row,
                                           int lane) {
  const float qx = qp[0], qy = STAGED ? qp[1] : 0.0f,
              qz = STAGED ? qp[2] : 0.0f;
  for (int j = lane; j < 4 * words; j += 32) {
    uint32_t key = 0xffffffffu;
    if (j < n) {
      if (STAGED) {
        const float4 p = cloud[j];
        const float inner = __fadd_rn(
            __fadd_rn(__fmul_rn(qx, p.x), __fmul_rn(qy, p.y)),
            __fmul_rn(qz, p.z));
        key = kg_key(fmaxf(
            __fadd_rn(__fsub_rn(q2, __fmul_rn(2.0f, inner)), p.w), 0.0f));
      } else {
        key = kg_key(kg_d2(qp, pb + (size_t)j * c, q2, c));
      }
    }
    row[j] = key;
  }
  __syncwarp();
}

// The `ranks` smallest (key, index) words of the row into list[0, ranks),
// in no order; cand holds kKgCand words of scratch. 1 <= ranks <= n.
__device__ __forceinline__ void kg_select(const uint4* row4,
                                          const uint32_t* row, int words,
                                          int n, int ranks, int lane,
                                          unsigned long long* list,
                                          unsigned long long* cand) {
  // bisection on the full row while the bounds hold more than kKgCand
  // keys: count(key < lo) = clo < ranks <= count(key < hi) = chi
  uint32_t lo = 0, hi = 0x80000000u;
  int clo = 0, chi = n;
  while (chi != ranks && hi - lo > 1 && chi - clo > kKgCand) {
    const uint32_t mid = lo + ((hi - lo) >> 1);
    const int cm = kg_count(row4, words, lane, mid);
    if (cm >= ranks) {
      hi = mid;
      chi = cm;
    } else {
      lo = mid;
      clo = cm;
    }
  }

  if (chi != ranks && chi - clo <= kKgCand) {
    // the keys below lo go to the list, those in [lo, hi) to the
    // candidates, whose bisection goes on in registers
    int nl = 0, nc = 0;
    for (int j0 = 0; j0 < 4 * words; j0 += 32) {
      const int j = j0 + lane;
      const uint32_t key = j < n ? row[j] : 0xffffffffu;
      nl = kg_push(key < lo, kg_word(key, j), list, nl, lane);
      nc = kg_push(key >= lo && key < hi, kg_word(key, j), cand, nc, lane);
    }
    __syncwarp();
    unsigned long long mine_c[kKgCand / 32];
#pragma unroll
    for (int t = 0; t < kKgCand / 32; ++t)
      mine_c[t] = 32 * t + lane < nc ? cand[32 * t + lane] : ~0ull;
    const int base = clo;
    while (chi != ranks && hi - lo > 1) {
      const uint32_t mid = lo + ((hi - lo) >> 1);
      int cm = 0;
#pragma unroll
      for (int t = 0; t < kKgCand / 32; ++t) cm += (mine_c[t] >> 32) < mid;
      cm = base + __reduce_add_sync(0xffffffffu, cm);
      if (cm >= ranks) {
        hi = mid;
        chi = cm;
      } else {
        lo = mid;
        clo = cm;
      }
    }
    // chosen: key < hi (exact count), else key < lo or (key == lo, j <
    // tj): the lower indices among equal keys
    uint32_t tk = hi;
    unsigned tj = 0;
    if (chi != ranks) {
      tk = lo;
      const int need = ranks - clo;
      int jlo = 0, jhi = n;
      while (jhi - jlo > 1) {
        const int mid = (jlo + jhi) >> 1;
        int cm = 0;
#pragma unroll
        for (int t = 0; t < kKgCand / 32; ++t)
          cm += (mine_c[t] >> 32) == lo && (unsigned)mine_c[t] < (unsigned)mid;
        if (__reduce_add_sync(0xffffffffu, cm) >= need)
          jhi = mid;
        else
          jlo = mid;
      }
      tj = jhi;
    }
#pragma unroll
    for (int t = 0; t < kKgCand / 32; ++t) {
      const uint32_t key = mine_c[t] >> 32;
      nl = kg_push(key < tk || (key == tk && (unsigned)mine_c[t] < tj),
                   mine_c[t], list, nl, lane);
    }
  } else {
    // exact count below hi, or equal keys at lo straddling rank R (more
    // of them than the candidates hold): the lower indices among them
    uint32_t tk = hi;
    int tj = 0;
    if (chi != ranks) {
      tk = lo;
      const int need = ranks - clo;
      int jlo = 0, jhi = n;
      while (jhi - jlo > 1) {
        const int mid = (jlo + jhi) >> 1;
        if (kg_count_ties(row4, words, lane, lo, mid) >= need)
          jhi = mid;
        else
          jlo = mid;
      }
      tj = jhi;
    }
    int nl = 0;
    for (int j0 = 0; j0 < 4 * words; j0 += 32) {
      const int j = j0 + lane;
      const uint32_t key = j < n ? row[j] : 0xffffffffu;
      nl = kg_push(key < tk || (key == tk && j < tj), kg_word(key, j), list,
                   nl, lane);
    }
  }
  __syncwarp();
}

}  // namespace pcl
