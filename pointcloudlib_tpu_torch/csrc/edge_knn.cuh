// kNN selection of one block of queries, shared by the two fused EdgeConv
// kernels that build the DGCNN graph inside (edge_knn_eval.cu,
// edge_knn_f1.cu) and the standalone kNN (knn.cu); and the EdgeConv row
// passes that follow a selection or a given index (edge_eval.cu,
// edge_f1.cu).
//
// The block takes kKnnQ queries of a query cloud [m, cin] (f32; the cloud
// itself for a self-kNN) and keeps, for each, the k points of a cloud
// x [n, cin] with the smallest
//   d2 = max((|x_q|^2 - 2 x_q.x_j) + |x_j|^2, 0)
// in (d2, j) lexicographic order: ascending d2, the lower index first on
// ties. That is the order of the TPU kernels' k argmin rounds and of the
// plain version's stable sort (ops/geometry.py knn). d2 takes the plain
// square_distance's operations in its order, channel by channel, each
// product and sum rounded on its own (no FMA contraction), so the
// selected indices are bit-identical to the plain version's.
//
// The TPU kernels hold a [mt, n] distance tile in VMEM and run k masked
// argmins over it. A layer-4 cloud (1024 x 128 f32, 512 KB) does not fit
// a block's shared memory, so here the candidates stream through it in
// tiles of kKnnT points, channel-major. Each thread forms a 4 x 4
// register tile of (query, candidate) products from two 16-byte loads a
// channel; the tile's d2 go to shared memory. Four threads share a query
// and walk a quarter of each tile each (candidates 4i + s), in index
// order, keeping the KP smallest (d2, j) they have met in a sorted list in
// registers: an insertion compares against every slot at once (a
// branch-free shift, no memory traffic), and a strict "<" puts an equal
// d2 met later (a higher index) after the earlier one. A warp executes
// an insertion whenever one of its lanes needs one, so what an insertion
// costs, and not how many a query makes, sets the walk's time: one
// walker a query with its list in shared memory, shifted one entry at a
// time, made the kernel three times slower on an H100 (0.83 against
// 0.29 ms at B=32, N=1024, cin=3, k=20). After the last tile the four
// lists of a query merge by warp shuffles, k times the lexicographic
// least head, into the neighbour list. KP is k rounded up to a multiple
// of 8: the k least of the four lists' KP least each are the k least of
// all.

#pragma once

#include "fused_sa_common.cuh"

namespace pcl {

constexpr int kKnnQ = 64;          // queries a block
constexpr int kKnnT = 64;          // candidates a shared-memory tile
constexpr int kKnnD2 = kKnnT + 4;  // d2 tile row: conflict-free walk reads
constexpr int kKnnMaxK = 40;       // longest neighbour list
constexpr int kKnnWalkers = kThreads / kKnnQ;  // threads a query
static_assert(kThreads == 256 && kKnnQ == 64 && kKnnT == 64 &&
                  kKnnWalkers == 4,
              "the 16 x 16 thread grid of 4 x 4 register tiles");

// Shared memory of knn_block: query and candidate features, the d2 tile,
// the squared norms and the neighbour lists, in 4-byte words.
__host__ __device__ inline size_t knn_smem_words(int cin, int k) {
  return (size_t)cin * (kKnnQ + kKnnT) + (size_t)kKnnQ * kKnnD2 + kKnnQ +
         kKnnT + (size_t)k * kKnnQ;
}

// Slot of row r (0..63) in a channel row of the feature tiles: the rows
// r, r + 16, r + 32, r + 48 that one thread of the 16 x 16 grid takes sit
// side by side, so it reads them with one 16-byte load.
__device__ __forceinline__ int tile_slot(int r) { return (r & 15) * 4 + (r >> 4); }

// (p[0]*p[0] + p[s]*p[s]) + ... over cin entries s apart, the plain
// _sumsq order.
__device__ __forceinline__ float sumsq_strided(const float* p, int cin,
                                               int s) {
  float acc = __fmul_rn(p[0], p[0]);
  for (int c = 1; c < cin; ++c) acc = __fadd_rn(acc, __fmul_rn(p[c * s], p[c * s]));
  return acc;
}

// Rows r0 .. r0 + 63 of xb [n, cin] into tile [cin][64] at tile_slot(r),
// zeros past n.
__device__ __forceinline__ void load_tile(const float* __restrict__ xb, int n,
                                          int cin, int r0, float* tile) {
  for (int e = threadIdx.x; e < kKnnQ * cin; e += kThreads) {
    const int r = e & (kKnnQ - 1);
    const int c = e >> 6;
    tile[c * kKnnQ + tile_slot(r)] =
        r0 + r < n ? xb[(size_t)(r0 + r) * cin + c] : 0.0f;
  }
}

// (d, j) into the ascending list (ld, li) of KP entries, after every
// entry with an equal d; the last entry drops out.
template <int KP>
__device__ __forceinline__ void list_insert(float (&ld)[KP], int (&li)[KP],
                                            float d, int j) {
#pragma unroll
  for (int i = KP - 1; i > 0; --i) {
    const bool up = d < ld[i - 1];
    const bool here = d < ld[i];
    li[i] = up ? li[i - 1] : (here ? j : li[i]);
    ld[i] = up ? ld[i - 1] : (here ? d : ld[i]);
  }
  if (d < ld[0]) {
    ld[0] = d;
    li[0] = j;
  }
}

// The k nearest points in the cloud xb [n, cin] of queries q0 .. q0 +
// kKnnQ - 1 of the query cloud qb [m, cin] (queries past m are computed
// and ignored). Returns the lists in shared memory, nbr[kk * kKnnQ + q]
// the kk-th neighbour of query q0 + q; with nbrd, its d2 goes to
// nbrd[kk * kKnnQ + q]. Needs k <= n, k <= KP <= kKnnMaxK and
// knn_smem_words(cin, k) words at sm. Every thread of the block must call
// it; it ends with a barrier.
template <int KP>
__device__ __forceinline__ const int* knn_block(const float* __restrict__ qb,
                                                int m,
                                                const float* __restrict__ xb,
                                                int n, int cin, int q0, int k,
                                                float* sm,
                                                float* nbrd = nullptr) {
  float* qs = sm;                           // [cin][kKnnQ], tile_slot order
  float* xs = qs + (size_t)cin * kKnnQ;     // [cin][kKnnT], tile_slot order
  float* d2s = xs + (size_t)cin * kKnnT;    // [kKnnQ][kKnnD2]
  float* q2s = d2s + kKnnQ * kKnnD2;        // [kKnnQ]
  float* p2s = q2s + kKnnQ;                 // [kKnnT]
  int* nbr = reinterpret_cast<int*>(p2s + kKnnT);  // [k][kKnnQ]
  const int tid = threadIdx.x;

  load_tile(qb, m, cin, q0, qs);
  __syncthreads();
  if (tid < kKnnQ) q2s[tid] = sumsq_strided(qs + tile_slot(tid), cin, kKnnQ);

  const int qi = tid >> 4;  // queries qi + 16 r, candidates cj + 16 s
  const int cj = tid & 15;
  const int wq = tid / kKnnWalkers;  // the query this thread walks for
  const int ws = tid % kKnnWalkers;  // and its quarter of each tile
  float ld[KP];
  int li[KP];
#pragma unroll
  for (int i = 0; i < KP; ++i) {
    ld[i] = INFINITY;
    li[i] = 0x7fffffff;
  }
  for (int t0 = 0; t0 < n; t0 += kKnnT) {
    __syncthreads();  // the last tile's walk is done with xs and d2s
    load_tile(xb, n, cin, t0, xs);
    __syncthreads();
    if (tid < kKnnT) p2s[tid] = sumsq_strided(xs + tile_slot(tid), cin, kKnnT);

    float acc[4][4];
    {
      const float4 qv = *reinterpret_cast<const float4*>(qs + qi * 4);
      const float4 xv = *reinterpret_cast<const float4*>(xs + cj * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = __fmul_rn(qa[r], xa[s]);
    }
    for (int c = 1; c < cin; ++c) {
      const float4 qv =
          *reinterpret_cast<const float4*>(qs + c * kKnnQ + qi * 4);
      const float4 xv =
          *reinterpret_cast<const float4*>(xs + c * kKnnT + cj * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s)
          acc[r][s] = __fadd_rn(acc[r][s], __fmul_rn(qa[r], xa[s]));
    }
    __syncthreads();  // q2s and p2s are written
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int q = qi + 16 * r;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int j = cj + 16 * s;
        const float d = fmaxf(
            __fadd_rn(__fsub_rn(q2s[q], __fmul_rn(2.0f, acc[r][s])), p2s[j]),
            0.0f);
        d2s[q * kKnnD2 + j] = t0 + j < n ? d : INFINITY;
      }
    }
    __syncthreads();
    const float* row = d2s + wq * kKnnD2;
#pragma unroll 4
    for (int i = 0; i < kKnnT / kKnnWalkers; ++i) {
      const int j = kKnnWalkers * i + ws;
      const float d = row[j];
      if (d < ld[KP - 1]) list_insert(ld, li, d, t0 + j);
    }
  }

  // merge the four walkers' lists of a query (neighbouring lanes): k
  // rounds of the lexicographic least (d2, j) head, which its owner pops
  for (int kk = 0; kk < k; ++kk) {
    float bd = ld[0];
    int bj = li[0];
#pragma unroll
    for (int off = 1; off < kKnnWalkers; off <<= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, off);
      const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
      if (od < bd || (od == bd && oj < bj)) {
        bd = od;
        bj = oj;
      }
    }
    if (li[0] == bj) {
#pragma unroll
      for (int i = 0; i < KP - 1; ++i) {
        ld[i] = ld[i + 1];
        li[i] = li[i + 1];
      }
      ld[KP - 1] = INFINITY;
      li[KP - 1] = 0x7fffffff;
    }
    if (ws == 0) {
      nbr[kk * kKnnQ + wq] = bj;
      if (nbrd) nbrd[kk * kKnnQ + wq] = bd;
    }
  }
  __syncthreads();
  return nbr;
}

// The list length KP a walker keeps for k neighbours: k rounded up to a
// multiple of 8 (8 .. kKnnMaxK, one kernel instance each).
inline int knn_list_length(int k) { return (k + 7) / 8 * 8; }

// LeakyReLU as the TPU kernels' _bn_leaky: z > 0 ? z : slope * z
__device__ __forceinline__ float leaky(float z, float slope) {
  return z > 0.0f ? z : __fmul_rn(slope, z);
}

// What the fused EdgeConv kernels take: an even output width whose
// channel pairs divide the block, so that each thread keeps one pair.
__host__ __device__ inline bool edge_width_ok(int c) {
  return c >= 2 && c % 2 == 0 && kThreads % (c / 2) == 0;
}

// The neighbour lists of rows q0 .. q0 + nq - 1 from a given index
// idx [m, k] (one cloud) into nbr[kk * kKnnQ + q], the layout knn_block
// returns; ends with a barrier.
__device__ __forceinline__ void load_nbr(const int* __restrict__ idx, int q0,
                                         int nq, int k, int* nbr) {
  const int* ib = idx + (size_t)q0 * k;
  for (int e = threadIdx.x; e < nq * k; e += kThreads) {
    const int ql = e / k;
    nbr[(e - ql * k) * kKnnQ + ql] = ib[e];
  }
  __syncthreads();
}

// Eval rows q0 .. q0 + nq - 1 of one cloud, with Q [n, c] (bf16) and Off,
// out [m, c] of the cloud:
//   out[i, c] = max_k leaky(sc[c] * (float(Q[nbr(i, kk), c]) - Off[i, c])
//                           + bi[c])
// One channel pair a thread; each neighbour's Q row comes from L2 in
// 128-byte pieces a warp, the running max stays in registers. The
// operations are the plain version's, rounded one by one in its order.
__device__ __forceinline__ void edge_eval_rows(
    const int* nbr, const __nv_bfloat16* __restrict__ q,
    const float* __restrict__ off, const float* __restrict__ st,
    float* __restrict__ out, int c, int k, float slope, int q0, int nq) {
  const int ncp = c / 2;
  const int cc = 2 * (threadIdx.x % ncp);
  const float sc0 = st[cc], sc1 = st[cc + 1];
  const float bi0 = st[c + cc], bi1 = st[c + cc + 1];
  const __nv_bfloat16* qc = q + cc;
  for (int ql = threadIdx.x / ncp; ql < nq; ql += kThreads / ncp) {
    const size_t row = (size_t)q0 + ql;
    const float o0 = off[row * c + cc], o1 = off[row * c + cc + 1];
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll 4
    for (int kk = 0; kk < k; ++kk) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(
          qc + (size_t)nbr[kk * kKnnQ + ql] * c);
      m0 = fmaxf(m0, leaky(bn_z(__fsub_rn(bf_lo(w), o0), sc0, bi0), slope));
      m1 = fmaxf(m1, leaky(bn_z(__fsub_rn(bf_hi(w), o1), sc1, bi1), slope));
    }
    *reinterpret_cast<float2*>(out + row * c + cc) = make_float2(m0, m1);
  }
}

// Train rows q0 .. q0 + nq - 1 of one cloud, pass 1: the checkpoint
//   h[i, kk, c] = bf16(float(Q[nbr(i, kk), c]) - Off[i, c])   (h [m, k, c])
// and the block's share of [sum h, sum h^2] of the f32 h, added into
// red[2c] in shared memory (the caller zeroes it and adds it into the
// global sums after a barrier).
__device__ __forceinline__ void edge_f1_rows(
    const int* nbr, const __nv_bfloat16* __restrict__ q,
    const float* __restrict__ off, __nv_bfloat16* __restrict__ h,
    float* red, int c, int k, int q0, int nq) {
  const int ncp = c / 2;
  const int cc = 2 * (threadIdx.x % ncp);
  const __nv_bfloat16* qc = q + cc;
  float s0 = 0.0f, s1 = 0.0f, ss0 = 0.0f, ss1 = 0.0f;
  for (int ql = threadIdx.x / ncp; ql < nq; ql += kThreads / ncp) {
    const size_t row = (size_t)q0 + ql;
    const float o0 = off[row * c + cc], o1 = off[row * c + cc + 1];
    __nv_bfloat16* hr = h + row * k * c + cc;
#pragma unroll 4
    for (int kk = 0; kk < k; ++kk) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(
          qc + (size_t)nbr[kk * kKnnQ + ql] * c);
      const float h0 = __fsub_rn(bf_lo(w), o0);
      const float h1 = __fsub_rn(bf_hi(w), o1);
      *reinterpret_cast<uint32_t*>(hr + (size_t)kk * c) = pack2(h0, h1);
      s0 += h0;
      s1 += h1;
      ss0 += h0 * h0;
      ss1 += h1 * h1;
    }
  }
  atomicAdd(red + cc, s0);
  atomicAdd(red + cc + 1, s1);
  atomicAdd(red + c + cc, ss0);
  atomicAdd(red + c + cc + 1, ss1);
}

}  // namespace pcl
