// k nearest neighbours, for Hopper (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/neighbors.py
// (knn_pallas -> _knn_kernel). For query [B, M, C] and points [B, N, C]
// (f32):
//   d2 [B, M, k] f32, idx [B, M, k] i32   the k points with the smallest
//       d2 = max((|q|^2 - 2 q.p) + |p|^2, 0), ascending, the lower index
//       first on ties.
// DGCNN's EdgeConvs take it at N % 128 != 0 (query = points = the layer
// input), before the EdgeConv kernels that take a given index
// (edge_f1.cu, edge_eval.cu); PointConv's layers take it for their
// neighbourhoods.
//
// The TPU kernel holds a [mt, N] distance tile in VMEM and runs k masked
// argmins over it, with an f32 cross term only under exact=True. Here d2
// is formed channel by channel in f32 without FMA, each product and sum
// rounded on its own in the plain version's order (ops/geometry.py
// square_distance), so idx and d2 are bit-identical to the plain version
// and the TPU's exact flag changes nothing here.
//
// What bounds it: operations, B*M*N pairs at 2*C + 3 f32 operations each
// (3.2 * 10^9 pairs a layer for DGCNN at B=32, N=10,000). At the FMA peak
// (67 TFLOP/s) that is 0.43 / 6.26 / 12.37 ms at C = 3 / 64 / 128; the
// plain order takes one instruction an operation (a multiply and an add
// that may not fuse), so no kernel that forms every d2 in it goes below
// twice that: 0.86 / 12.5 / 24.8 ms. Reading the clouds and writing 8
// bytes a neighbour is far below either.
//
// Two routes, chosen by the wrapper (ops/kernels/knn.py knn_route):
//
// "select" (knn_select_kernel), for large clouds or grids. A block takes
// Q = 32 * QPT queries (128 or 256) and streams the points through
// shared memory in tiles of 64, copied by cp.async (16-byte copies where
// C % 4 == 0, else 4-byte ones) into a ring of STAGES tiles, so the next
// tiles load while this one is used; rows are padded to a stride of
// 4 (mod 8) words, so a warp's 16-byte reads of eight rows hit distinct
// banks. The 8 lanes of a group (lane / 8) share QPT queries (qg + 32 r)
// and take 8 candidates each (cg + 8 s), so a thread forms a QPT x 8
// register tile of cross terms from QPT + 8 16-byte reads every four
// channels (sel_d2); the norms in the plain order, |q|^2 once a block,
// |p|^2 by a small kernel before (knn_norms_kernel, into the wrapper's
// [B, N] scratch), copied in with each tile. Selection in the manner of
// WarpSelect (Johnson, Douze, Jegou, 2017), without a queue: each query's
// k best (d2, j) form an ascending list held by its group's 8 lanes in
// registers, E = ceil(k / 8) entries a lane (group_insert), and the
// list's k-th d2 is the filter tau, the same in the 8 lanes. A pair whose
// d2 is not below tau costs one compare; survivors go in one a round, the
// 4 groups of a warp side by side, each round a branch-free shift of E
// entries a lane behind one shuffle. Candidates come in index order tile
// by tile, so one that ties tau at the tile's start comes after it and
// is rightly dropped; within a tile every survivor goes in, and the
// insertion is exact in (d2, j). No barrier waits on a selection: one
// barrier a tile guards the ring.
//
// Where C % 4 == 0 the select route's fast pass (sel_fast) forms the
// cross terms by FMA, one instruction a channel, from the tile
// fast_from = ceil(k / 8) on, and filters with a bound: a pair can pass
// only if its approximate d2 less eps = kappa (|q|^2 + |p|^2), kappa =
// 1.25 (2C + 16) 2^-24, is below tau (the derivation is at sel_fast).
// Those pairs, about one a lane a tile or fewer once the lists have
// settled, are formed again in the plain order (sel_exact) and go
// through the same filter and insertion as above; every other pair is
// rejected outright. So every d2 that enters a list is the plain
// version's, bit for bit, and the kernel can go below the plain order's
// floor (it does at C = 64 and 128, PERF.md §5).
//
// "block" (knn_kernel, with knn_block of edge_knn.cuh): 64
// queries a block, a 64 x 64 d2 tile through shared memory, four walkers
// a query with sorted lists in registers. It stays faster where the
// select route's first tiles (every candidate of tile 0 enters a list)
// and a grid of one block an SM or less weigh most, and takes widths the
// select route's shared memory does not (C up to 379 at k = 40).

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

// The select route: tile t + STAGES - 1 loads while tile t is used (its
// |p|^2 beside it, from knn_norms_kernel), one barrier a tile.
template <int QPT, int E, int STAGES, bool FAST>
__global__ void __launch_bounds__(kThreads, QPT <= 4 ? 2 : 1)
    knn_select_kernel(const float* __restrict__ query,
                      const float* __restrict__ pts,
                      const float* __restrict__ p2g, float* __restrict__ d2,
                      int* __restrict__ idx, int m, int n, int c, int k) {
  constexpr int Q = 32 * QPT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int p = sel_stride(c);
  float* qs = reinterpret_cast<float*>(smem);  // [Q][p]
  float* xs = qs + Q * p;                      // [STAGES][64][p]
  float* p2s = xs + STAGES * kSelT * p;        // [STAGES][64]
  float* q2s = p2s + STAGES * kSelT;           // [Q]
  const int b = blockIdx.y, q0 = blockIdx.x * Q;
  const int nq = min(Q, m - q0);
  const float* qb = query + ((size_t)b * m + q0) * c;
  const float* xb = pts + (size_t)b * n * c;
  const float* p2b = p2g + (size_t)b * n;
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
  float ld[QPT][E], tau[QPT];
  int lj[QPT][E];
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
#pragma unroll
  for (int r = 0; r < QPT; ++r) {
    const int q = qg + 32 * r;
    if (q >= nq) continue;
    const size_t base = ((size_t)b * m + q0 + q) * k;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int slot = cg * E + e;
      if (slot < k) {
        d2[base + slot] = ld[r][e];
        idx[base + slot] = lj[r][e];
      }
    }
  }
}

template <int KP>
__global__ void __launch_bounds__(kThreads)
    knn_kernel(const float* __restrict__ query, const float* __restrict__ pts,
               float* __restrict__ d2, int* __restrict__ idx, int m, int n,
               int c, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sm = reinterpret_cast<float*>(smem);
  float* nd = sm + knn_smem_words(c, k);  // [k][kKnnQ] d2 of the lists
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kKnnQ;
  const int* nbr = knn_block<KP>(query + (size_t)b * m * c, m,
                                 pts + (size_t)b * n * c, n, c, q0, k, sm,
                                 nd);
  const int nq = min(kKnnQ, m - q0);
  const size_t base = ((size_t)b * m + q0) * k;
  for (int e = threadIdx.x; e < nq * k; e += kThreads) {
    const int ql = e / k;
    const int s = (e - ql * k) * kKnnQ + ql;
    idx[base + e] = nbr[s];
    d2[base + e] = nd[s];
  }
}

template <typename K>
cudaError_t launch_kernel(K kernel, dim3 grid, size_t smem,
                          cudaStream_t stream, const void* query,
                          const void* pts, void* d2, void* idx, int m, int n,
                          int c, int k) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(query), static_cast<const float*>(pts),
      static_cast<float*>(d2), static_cast<int*>(idx), m, n, c, k);
  return cudaGetLastError();
}

}  // namespace pcl

// Shared memory bytes of one block of the block route for width c and k
// neighbours.
extern "C" long long knn_smem(int c, int k) {
  return 4LL * ((long long)pcl::knn_smem_words(c, k) +
                (long long)k * pcl::kKnnQ);
}

namespace pcl {

// The select route's instances: (queries a thread, tiles in the ring,
// the fast pass from the tile fast_from on), route r at kSelRoutes[r - 1]:
// the ones the wrapper takes (ops/kernels/knn.py knn_route). The fast
// pass takes c % 4 == 0.
constexpr int kSelRoutes[][3] = {{4, 3, 0}, {4, 3, 1}, {8, 2, 1}};
constexpr int kSelRouteCount = 3;
constexpr int kSelMaxK8 = 24;  // 8 queries a thread: lists of 24 at most

template <typename K>
cudaError_t launch_sel(K kernel, dim3 grid, size_t smem, cudaStream_t stream,
                       const void* query, const void* pts, const float* p2g,
                       void* d2, void* idx, int m, int n, int c, int k) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(query), static_cast<const float*>(pts), p2g,
      static_cast<float*>(d2), static_cast<int*>(idx), m, n, c, k);
  return cudaGetLastError();
}

template <int QPT, int STAGES, bool FAST>
cudaError_t launch_select(dim3 grid, size_t smem, cudaStream_t s,
                          const void* query, const void* pts,
                          const float* p2g, void* d2, void* idx, int m,
                          int n, int c, int k) {
#define PCL_SELECT(E)                                                        \
  if (k <= E * kSelCand)                                                     \
    return launch_sel(knn_select_kernel<QPT, E, STAGES, FAST>, grid, smem,   \
                      s, query, pts, p2g, d2, idx, m, n, c, k);
  PCL_SELECT(1)
  PCL_SELECT(2)
  PCL_SELECT(3)
  if constexpr (QPT < 8) {
    PCL_SELECT(4)
    PCL_SELECT(5)
  }
#undef PCL_SELECT
  return cudaErrorInvalidValue;
}

}  // namespace pcl

// query [b, m, c] f32, pts [b, n, c] f32; d2 [b, m, k] f32, idx [b, m, k]
// i32; norms [b, n] f32 scratch of the select route (its |p|^2; unused by
// the block route); all contiguous and 16-byte aligned. route: 0 the
// block route; 1 .. 3 the select route with (queries a thread, tiles in
// the ring, the fast pass) = (4, 3, no), (4, 3, yes), (8, 2, yes); the
// fast pass for c % 4 == 0 only, 8 queries a thread for k <= 24 only.
// Returns the launch's cudaGetLastError() code, or cudaErrorInvalidValue
// for sizes it does not take (k > n, k > 40, too much shared memory, an
// unknown route).
extern "C" int knn_launch(const void* query, const void* pts, void* d2,
                          void* idx, void* norms, int b, int m, int n, int c,
                          int k, int route, void* stream) {
  if (b < 1 || m < 1 || c < 1 || k < 1 || k > n || k > pcl::kKnnMaxK ||
      route < 0 || route > pcl::kSelRouteCount)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route > 0) {
    const int* rt = pcl::kSelRoutes[route - 1];
    const size_t smem = pcl::sel_smem(rt[0], rt[1], c);
    if (smem > 227 * 1024 || (rt[2] && c % 4) ||
        (rt[0] == 8 && k > pcl::kSelMaxK8))
      return cudaErrorInvalidValue;
    const long long rows = (long long)b * n;
    float* p2g = static_cast<float*>(norms);
    pcl::knn_norms_kernel<<<(unsigned)((rows + pcl::kThreads - 1) /
                                        pcl::kThreads),
                            pcl::kThreads, 0, s>>>(
        static_cast<const float*>(pts), p2g, rows, c);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const dim3 grid((m + 32 * rt[0] - 1) / (32 * rt[0]), b);
    switch (route) {
      case 1: return pcl::launch_select<4, 3, false>(grid, smem, s, query, pts, p2g, d2, idx, m, n, c, k);
      case 2: return pcl::launch_select<4, 3, true>(grid, smem, s, query, pts, p2g, d2, idx, m, n, c, k);
      default: return pcl::launch_select<8, 2, true>(grid, smem, s, query, pts, p2g, d2, idx, m, n, c, k);
    }
  }
  const long long smem = knn_smem(c, k);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  const dim3 grid((m + pcl::kKnnQ - 1) / pcl::kKnnQ, b);
  switch (pcl::knn_list_length(k)) {
    case 8: return pcl::launch_kernel(pcl::knn_kernel<8>, grid, smem, s, query, pts, d2, idx, m, n, c, k);
    case 16: return pcl::launch_kernel(pcl::knn_kernel<16>, grid, smem, s, query, pts, d2, idx, m, n, c, k);
    case 24: return pcl::launch_kernel(pcl::knn_kernel<24>, grid, smem, s, query, pts, d2, idx, m, n, c, k);
    case 32: return pcl::launch_kernel(pcl::knn_kernel<32>, grid, smem, s, query, pts, d2, idx, m, n, c, k);
    case 40: return pcl::launch_kernel(pcl::knn_kernel<40>, grid, smem, s, query, pts, d2, idx, m, n, c, k);
    default: return cudaErrorInvalidValue;
  }
}
