// The select route of the kNN, shared by the standalone kNN (knn.cu) and
// train-mode pass 1 with the kNN inside (edge_knn_f1.cu): the points
// streamed by cp.async through a ring of shared-memory tiles, d2 formed
// in the plain order in register tiles (or, at C % 4 == 0, by an FMA
// pass with an error bound whose near pairs are formed again in the
// plain order), filtered against each query's k-th and merged into lists
// that the 8 lanes of a group hold in registers. knn.cu's note describes
// the design and its numerics; every d2 that enters a list is the plain
// version's, bit for bit.

#pragma once

#include "edge_knn.cuh"
#include "fused_sa_chain.cuh"

namespace pcl {

constexpr int kSelT = 64;        // candidates a tile
constexpr int kSelCand = 8;      // candidates a thread in a tile
constexpr int kNoIndex = 0x7fffffff;  // an empty list entry's index
static_assert(kThreads == 256 && kSelT == 64, "8 warps of 4 x 8 lanes");

// Row stride of the query and point tiles in words: C rounded up to 4,
// then 4 (mod 8).
__host__ __device__ inline int sel_stride(int c) {
  const int p = (c + 3) / 4 * 4;
  return p % 8 ? p : p + 4;
}

// Shared memory of knn_select_kernel in bytes: the query tile, STAGES
// point tiles and their |p|^2, and |q|^2.
__host__ __device__ inline size_t sel_smem(int qpt, int stages, int c) {
  const size_t q = 32 * qpt, p = sel_stride(c);
  return 4 * (q * p + (size_t)stages * kSelT * (p + 1) + q);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// Starts copying rows r0 .. r0 + 63 (those below n) of the cloud xb [n, c]
// into dst [64][p], and their |p|^2 from p2b [n] into p2d [64].
__device__ __forceinline__ void sel_load(const float* __restrict__ xb,
                                         const float* __restrict__ p2b, int n,
                                         int c, int p, int r0, float* dst,
                                         float* p2d) {
  const int rows = min(kSelT, n - r0);
  const float* src = xb + (size_t)r0 * c;
  if (threadIdx.x < rows) cp_async4(p2d + threadIdx.x, p2b + r0 + threadIdx.x);
  if ((c & 3) == 0) {
    const int cq = c >> 2;
    for (int e = threadIdx.x; e < rows * cq; e += kThreads) {
      const int r = e / cq, u = e - r * cq;
      cp_async16(dst + r * p + 4 * u, src + (size_t)r * c + 4 * u);
    }
  } else {
    for (int e = threadIdx.x; e < rows * c; e += kThreads) {
      const int r = e / c, u = e - r * c;
      cp_async4(dst + r * p + u, src + e);
    }
  }
}

// (x[0]*x[0] + x[1]*x[1]) + ... over c entries, the plain _sumsq order.
__device__ __forceinline__ float sel_sumsq(const float* x, int c) {
  float acc = __fmul_rn(x[0], x[0]);
  for (int i = 1; i < c; ++i) acc = __fadd_rn(acc, __fmul_rn(x[i], x[i]));
  return acc;
}

// |p|^2 of every row of x [rows, c] in the plain order, one row a thread:
// the select route reads them with each tile instead of forming them
// between its barriers.
__global__ void __launch_bounds__(kThreads)
    knn_norms_kernel(const float* __restrict__ x, float* __restrict__ out,
                     long long rows, int c) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r < rows) out[r] = sel_sumsq(x + r * c, c);
}

__device__ __forceinline__ float f4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// d2 of this thread's QPT x 8 pairs of a tile into d[r][s]: the cross
// terms channel by channel in order, then max((|q|^2 - 2 q.p) + |p|^2,
// 0). -0.0f + y == y for every y, so starting the sums at -0 gives the
// plain version's q[0]*p[0] first term exactly. Every four channels the
// thread reads its 8 candidates' values once and its queries' one query
// at a time (16-byte reads), so a QPT x 8 tile costs QPT + 8 reads for
// 64 QPT products and sums.
template <int QPT>
__device__ __forceinline__ void sel_d2(const float* qrow, const float* xrow,
                                       const float* p2t, int p, int c,
                                       int cg, const float (&q2)[QPT],
                                       float (&d)[QPT][kSelCand]) {
#pragma unroll
  for (int r = 0; r < QPT; ++r)
#pragma unroll
    for (int s = 0; s < kSelCand; ++s) d[r][s] = -0.0f;
  int ch = 0;
#pragma unroll 1
  for (; ch + 4 <= c; ch += 4) {
    float4 xv[kSelCand];
#pragma unroll
    for (int s = 0; s < kSelCand; ++s)
      xv[s] = *reinterpret_cast<const float4*>(xrow + 8 * s * p + ch);
#pragma unroll
    for (int r = 0; r < QPT; ++r) {
      const float4 qv = *reinterpret_cast<const float4*>(qrow + 32 * r * p + ch);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int s = 0; s < kSelCand; ++s)
          d[r][s] = __fadd_rn(d[r][s], __fmul_rn(f4(qv, u), f4(xv[s], u)));
    }
  }
#pragma unroll 1
  for (; ch < c; ++ch) {
    float xv[kSelCand];
#pragma unroll
    for (int s = 0; s < kSelCand; ++s) xv[s] = xrow[8 * s * p + ch];
#pragma unroll
    for (int r = 0; r < QPT; ++r) {
      const float qv = qrow[32 * r * p + ch];
#pragma unroll
      for (int s = 0; s < kSelCand; ++s)
        d[r][s] = __fadd_rn(d[r][s], __fmul_rn(qv, xv[s]));
    }
  }
#pragma unroll
  for (int s = 0; s < kSelCand; ++s) {
    const float p2 = p2t[cg + 8 * s];
#pragma unroll
    for (int r = 0; r < QPT; ++r)
      d[r][s] = fmaxf(
          __fadd_rn(__fsub_rn(q2[r], __fmul_rn(2.0f, d[r][s])), p2), 0.0f);
  }
}

// The exact d2 of one pair from its rows in shared memory (c % 4 == 0),
// in the plain order: the cross term channel by channel, each product
// and sum rounded on its own.
__device__ __forceinline__ float sel_exact(const float* q, const float* x,
                                           int c, float q2, float p2) {
  float acc = -0.0f;
  for (int ch = 0; ch < c; ch += 4) {
    const float4 qv = *reinterpret_cast<const float4*>(q + ch);
    const float4 xv = *reinterpret_cast<const float4*>(x + ch);
    acc = __fadd_rn(acc, __fmul_rn(qv.x, xv.x));
    acc = __fadd_rn(acc, __fmul_rn(qv.y, xv.y));
    acc = __fadd_rn(acc, __fmul_rn(qv.z, xv.z));
    acc = __fadd_rn(acc, __fmul_rn(qv.w, xv.w));
  }
  return fmaxf(__fadd_rn(__fsub_rn(q2, __fmul_rn(2.0f, acc)), p2), 0.0f);
}

// The fast pass (c % 4 == 0): the cross terms by FMA, one instruction a
// channel, and a pair that may pass the filter when its approximate
// (|q|^2 - 2 q.p) + |p|^2, less the error bound eps = kappa (|q|^2 +
// |p|^2), is below tau. Its exact d2 is then formed in the plain order
// (sel_exact) by the lane that holds it, one pair a lane a round; every
// other pair gets d2 = inf, which the filter rejects (tau is a number
// here: a query's list is full by the first fast tile).
//
// The bound. With S = sum |q_c p_c| <= (|q|^2 + |p|^2) / 2 and
// gamma_n = n u / (1 - n u), u = 2^-24, both cross terms lie within
// gamma_{c+1} S of the true one (an FMA sum rounds once a step, the plain
// order twice), so they differ by at most 2 gamma_{c+1} S; the two
// roundings of the sum with |q|^2 and |p|^2, the FMA pass's reassociation
// of the bound into it, and the float arithmetic of eps itself add a few
// u (|q|^2 + |p|^2). So kappa = 1.25 (2c + 16) u covers it with room, and
// 2^-110 covers underflow (each of the 2c + 4 operations errs by at most
// 2^-149 there).
template <int QPT>
__device__ __forceinline__ void sel_fast(const float* qrow,
                                         const float* xrow, const float* p2t,
                                         int p, int c, int cg,
                                         const float (&q2)[QPT],
                                         const float (&tau)[QPT],
                                         float (&d)[QPT][kSelCand]) {
  float (&acc)[QPT][kSelCand] = d;  // the cross terms, then d2
#pragma unroll
  for (int r = 0; r < QPT; ++r)
#pragma unroll
    for (int s = 0; s < kSelCand; ++s) acc[r][s] = 0.0f;
#pragma unroll 1
  for (int ch = 0; ch < c; ch += 4) {
    float4 xv[kSelCand];
#pragma unroll
    for (int s = 0; s < kSelCand; ++s)
      xv[s] = *reinterpret_cast<const float4*>(xrow + 8 * s * p + ch);
#pragma unroll
    for (int r = 0; r < QPT; ++r) {
      const float4 qv = *reinterpret_cast<const float4*>(qrow + 32 * r * p + ch);
#pragma unroll
      for (int s = 0; s < kSelCand; ++s) {
        acc[r][s] = fmaf(qv.x, xv[s].x, acc[r][s]);
        acc[r][s] = fmaf(qv.y, xv[s].y, acc[r][s]);
        acc[r][s] = fmaf(qv.z, xv[s].z, acc[r][s]);
        acc[r][s] = fmaf(qv.w, xv[s].w, acc[r][s]);
      }
    }
  }
  const float kappa = 1.25f * (2.0f * c + 16.0f) * 0x1p-24f;
  float p2[kSelCand], pb[kSelCand];
#pragma unroll
  for (int s = 0; s < kSelCand; ++s) {
    p2[s] = p2t[cg + 8 * s];
    pb[s] = fmaf(-kappa, p2[s], p2[s]) - 0x1p-110f;
  }
  unsigned long long maybe = 0;
#pragma unroll
  for (int r = 0; r < QPT; ++r) {
    const float qb = fmaf(-kappa, q2[r], q2[r]);
#pragma unroll
    for (int s = 0; s < kSelCand; ++s) {
      const float lo = fmaf(-2.0f, acc[r][s], qb) + pb[s];
      maybe |= (unsigned long long)!(lo >= tau[r]) << (r * kSelCand + s);
      d[r][s] = INFINITY;
    }
  }
  while (__any_sync(0xffffffffu, maybe != 0ull)) {
    if (maybe) {
      const int slot = __ffsll((long long)maybe) - 1;
      const int r = slot / kSelCand, s = slot % kSelCand;
      float qr = q2[0];
#pragma unroll
      for (int i = 1; i < QPT; ++i) qr = i == r ? q2[i] : qr;
      const float dx = sel_exact(qrow + 32 * r * p, xrow + 8 * s * p, c, qr,
                                 p2t[cg + 8 * s]);
#pragma unroll
      for (int i = 0; i < QPT; ++i)
#pragma unroll
        for (int j = 0; j < kSelCand; ++j)
          if (i * kSelCand + j == slot) d[i][j] = dx;
      maybe &= maybe - 1;
    }
  }
}

__device__ __forceinline__ bool sel_lt(float da, int ja, float db, int jb) {
  return da < db || (da == db && ja < jb);
}

// (d, j) into the ascending list that the 8 lanes of a group hold in
// blocks of E (lane cg: entries cg*E .. cg*E + E - 1), where the group's
// `on` is set; the last entry drops out. Every lane of the warp calls it.
// A lane counts its entries below (d, j); the first lane with one not
// below takes (d, j) at that place and every later lane the entry its
// left neighbour drops, so each lane does one branch-free shift.
template <int E>
__device__ __forceinline__ void group_insert(float (&ld)[E], int (&lj)[E],
                                             float d, int j, int cg,
                                             bool on) {
  int below = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) below += sel_lt(ld[e], lj[e], d, j);
  const float pd = __shfl_up_sync(0xffffffffu, ld[E - 1], 1, 8);
  const int pj = __shfl_up_sync(0xffffffffu, lj[E - 1], 1, 8);
  const int pb = __shfl_up_sync(0xffffffffu, below, 1, 8);
  const bool first = cg == 0 || pb == E;
  const float cd = first ? d : pd;
  const int cj = first ? j : pj;
  if (on && below < E) {
#pragma unroll
    for (int e = E - 1; e > 0; --e) {
      ld[e] = e > below ? ld[e - 1] : (e == below ? cd : ld[e]);
      lj[e] = e > below ? lj[e - 1] : (e == below ? cj : lj[e]);
    }
    if (below == 0) {
      ld[0] = cd;
      lj[0] = cj;
    }
  }
}

// The group's k-th entry as its filter: NaN while the list is short (so
// that every candidate passes), else its d2. kl, ke: the k-th entry's
// lane in the group and place in that lane's block.
template <int E>
__device__ __forceinline__ float group_tau(const float (&ld)[E],
                                           const int (&lj)[E], int src,
                                           int ke) {
  float d = ld[0];
  int j = lj[0];
#pragma unroll
  for (int e = 1; e < E; ++e) {
    d = e == ke ? ld[e] : d;
    j = e == ke ? lj[e] : j;
  }
  d = __shfl_sync(0xffffffffu, d, src);
  j = __shfl_sync(0xffffffffu, j, src);
  return j == kNoIndex ? __int_as_float(0x7fffffff) : d;
}

// Filters this thread's d2 of one query against its group's tau and
// merges the group's survivors into the group's list, one a round, the 4
// groups of the warp side by side; then refreshes tau for the next tile.
// Survivors are inserted in no particular order and every one goes in:
// the insertion is exact in (d2, j), so one that an earlier survivor has
// pushed past the k-th lands behind it or drops out. A candidate that
// ties tau at the tile's start comes after it (a higher index), so the
// filter is exact too. A query past the block's keeps tau = -inf:
// nothing passes.
template <int E>
__device__ __forceinline__ void group_select(const float (&dv)[kSelCand],
                                             float (&ld)[E], int (&lj)[E],
                                             float& tau, int t0, int nvalid,
                                             int cg, int gbase, int ksrc,
                                             int ke) {
  unsigned mine = 0;
#pragma unroll
  for (int s = 0; s < kSelCand; ++s)
    mine |= (unsigned)(!(dv[s] >= tau) && cg + 8 * s < nvalid) << s;
  if (!__any_sync(0xffffffffu, mine != 0u)) return;
  do {
    const unsigned gb =
        (__ballot_sync(0xffffffffu, mine != 0u) >> gbase) & 0xffu;
    const int src = gb ? __ffs(gb) - 1 : 0;
    const int s_mine = mine ? __ffs(mine) - 1 : 0;
    float d_mine = dv[0];
#pragma unroll
    for (int s = 1; s < kSelCand; ++s) d_mine = s == s_mine ? dv[s] : d_mine;
    const float d = __shfl_sync(0xffffffffu, d_mine, gbase + src);
    const int s = __shfl_sync(0xffffffffu, s_mine, gbase + src);
    group_insert<E>(ld, lj, d, t0 + src + 8 * s, cg, gb != 0u);
    if (gb && cg == src) mine &= mine - 1;
  } while (__any_sync(0xffffffffu, mine != 0u));
  const float fresh = group_tau<E>(ld, lj, ksrc, ke);
  if (tau != -INFINITY) tau = fresh;
}


// The select route's walk over a cloud: for the queries qb [nq, c] of a
// block (nq <= 32 * QPT; the block's rows of the query cloud), the k
// nearest of the points xb [n, c], whose |p|^2 (knn_norms_kernel) are at
// p2b [n]. Tile t + STAGES - 1 loads while tile t is used (its |p|^2
// beside it), one barrier a tile. On return the 8 lanes of group
// qg = 4 * warp + lane / 8 hold the ascending list of each query qg +
// 32 r (r < QPT, the query below nq) in ld[r], lj[r]: lane cg = lane % 8
// its entries cg * E .. cg * E + E - 1. Needs k <= n, k <= 8 E and
// sel_smem(QPT, STAGES, c) bytes at smem (16-byte aligned, as qb, xb at
// c % 4 == 0); every thread of the block calls it. The last tiles' copies
// may still be pending in the group counters, none of them a real copy.
template <int QPT, int E, int STAGES, bool FAST>
__device__ __forceinline__ void sel_walk(const float* __restrict__ qb,
                                         int nq,
                                         const float* __restrict__ xb,
                                         const float* __restrict__ p2b, int n,
                                         int c, int k, unsigned char* smem,
                                         float (&ld)[QPT][E],
                                         int (&lj)[QPT][E]) {
  constexpr int Q = 32 * QPT;
  const int p = sel_stride(c);
  float* qs = reinterpret_cast<float*>(smem);  // [Q][p]
  float* xs = qs + Q * p;                      // [STAGES][64][p]
  float* p2s = xs + STAGES * kSelT * p;        // [STAGES][64]
  float* q2s = p2s + STAGES * kSelT;           // [Q]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = (n + kSelT - 1) / kSelT;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < tiles)
      sel_load(xb, p2b, n, c, p, s * kSelT, xs + s * kSelT * p,
               p2s + s * kSelT);
    cp_async_commit();
  }
  for (int e = tid; e < Q * c; e += kThreads) {
    const int r = e / c, u = e - r * c;
    qs[r * p + u] = r < nq ? qb[e] : 0.0f;
  }
  __syncthreads();
  for (int q = tid; q < Q; q += kThreads) q2s[q] = sel_sumsq(qs + q * p, c);

  const int qg = warp * 4 + (lane >> 3), cg = lane & 7;
  const int gbase = lane & ~7;
  const int ksrc = gbase + (k - 1) / E, ke = (k - 1) % E;
  float tau[QPT];
#pragma unroll
  for (int r = 0; r < QPT; ++r) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      ld[r][e] = INFINITY;
      lj[r][e] = kNoIndex;
    }
    tau[r] = qg + 32 * r < nq ? __int_as_float(0x7fffffff) : -INFINITY;
  }
  // the first fast tile: by tile t about 32 k / (64 t) of a lane's 32
  // pairs may pass in a random order, each one an exact pass of its own,
  // so the FMA pass pays from about t = k / 8 on; each list is full by
  // then (k <= 64)
  const int fast_from = max(1, (k + 7) / 8);
  float q2[QPT];
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile t
    __syncthreads();  // tile t in place; the stage of tile t - 1 is free
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < QPT; ++r) q2[r] = q2s[qg + 32 * r];
    }
    const int ahead = t + STAGES - 1;
    if (ahead < tiles)
      sel_load(xb, p2b, n, c, p, ahead * kSelT,
               xs + (ahead % STAGES) * kSelT * p,
               p2s + (ahead % STAGES) * kSelT);
    cp_async_commit();
    float dv[QPT][kSelCand];
    if (FAST && t >= fast_from)
      sel_fast<QPT>(qs + qg * p, xs + (t % STAGES) * kSelT * p + cg * p,
                    p2s + (t % STAGES) * kSelT, p, c, cg, q2, tau, dv);
    else
      sel_d2<QPT>(qs + qg * p, xs + (t % STAGES) * kSelT * p + cg * p,
                  p2s + (t % STAGES) * kSelT, p, c, cg, q2, dv);
    const int t0 = t * kSelT;
#pragma unroll
    for (int r = 0; r < QPT; ++r)
      group_select<E>(dv[r], ld[r], lj[r], tau[r], t0, n - t0, cg, gbase,
                      ksrc, ke);
  }
}

}  // namespace pcl
