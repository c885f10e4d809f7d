// Standalone ball query for Hopper (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/neighbors.py
// (_ball_query_pallas_jit -> _ball_query_kernel). For each center, the
// first k source points in index order with
//   d2 = max((|c|^2 - 2 c.p) + |p|^2, 0) < r^2
// go to idx [B, M, k] int32; slots past min(cnt, k) repeat slot 0, a row
// with no hit is all 0; cnt [B, M] int32 counts every hit, also beyond k.
//
// The TPU kernel ranks hits with a cumulative sum built from triangular
// matmuls and extracts one slot at a time, because its compiler has no
// scan. Here a block stages its batch's cloud in shared memory as
// (x, y, z, |p|^2) and its warps walk the cloud 32 points a set: a ballot
// marks a set's hits, the popcount of the lower lanes ranks them in index
// order, and hits below k go straight to idx. Two routes (route argument;
// ops/kernels/ball_query.py ball_query_route):
//
// scan (every pair tested): a warp walks R centers together, so that one
// shared-memory read of a set serves R centers and their R ballots are
// independent; R and the centers a block (8 warps x R) are the largest
// whose grid still has kBqScanMinBlocks blocks (R = 2, 1). From N =
// kBqFlushMinPoints up a set's ballot is not ranked at once: lane s keeps
// the ballot of the s-th set, and every 32 sets one flush (bq_flush) ranks
// their hits by a prefix sum over the lanes and writes those below k, so
// that a set costs a center its distances, a ballot and one select.
//
// cull (Hilbert-sorted clouds, N >= 4096): after staging, the block
// builds the bounding box of each 32-point chunk and of each super-chunk
// of kBqSuper chunks (one redux.sync a bound). A warp takes one center at
// a time from the block's queue (walks differ in length): its lanes test
// 32 super-chunks' boxes at a time, then the chunks of the near ones, and
// list the near chunks in index order; the warp walks them kBqInFlight at
// a time and ranks the hits by flushes, so the hits and their ranks are
// the scan's. A box is skipped only when
//   dbox >= (r2 + 2^-21 S)(1 + 2^-21) + 2^-100,
// all in f32 as written (bq_thr, bq_far), where dbox is the box's squared
// distance from the center and S = (|c|_1 + max |p|_1)^2, the max over the
// cloud. (A super-chunk's box holds its chunks', so its dbox is no larger:
// a chunk the super-chunk test skips, its own test would skip.) Why that
// holds no hit, with u = 2^-24 and a = |c|, b = |p| (no overflow):
//   * sq_dist forms c2, p2 and inner each with error at most g3 = 3u/(1-3u)
//     times a^2, b^2, ab (three products and two sums); 2*inner is exact;
//     t1 = c2 - 2 inner and t2 = t1 + p2 are rounded once each. So
//     |t2 - D| <= (g3 + u(1 + g3) + u(1 + g3 + u(1 + g3))) (a + b)^2
//     < 5.01 u S for the exact D = |c - p|^2 <= (a + b)^2 <= S.
//   * Each gap max(lo - c, c - hi, 0) is rounded once (at most (1+u)
//     times the exact gap) and dbox sums their squares with g3 more, so
//     the exact box distance is at least dbox (1 - 5.01u); S computed in
//     f32 is at least (1 - 7u) times the exact bound.
//   * The threshold's three roundings (2^-21 S is exact) lose at most 2u,
//     so for every p in the box D >= r2 + 7.9 u S > r2 + 5.01 u S, hence
//     t2 > r2: no hit. Below 2^-76 the 2^-100 covers underflow's absolute
//     errors (at most 2^-149 an operation). A threshold of inf (overflow)
//     skips nothing.
// The cull is exact on any cloud; it pays only where chunks of
// consecutive points are small in space, as after the Hilbert sort.
//
// What bounds it: operations on the scan route, ~10 f32 operations for
// each of the B*M*N (center, point) pairs beside B*(M+N)*12 bytes read
// and B*M*(k+1)*4 written; on the cull route the pairs it tests, which
// depend on the data, so no operations count is a floor there and the
// bytes are its bound.
//
// Numerics: d2's terms use explicit round-to-nearest multiplies and adds
// in the plain version's order (c2 - 2*inner by one fused multiply-add,
// the same rounding as 2*inner is exact), and a hit is t2 < r2 in place of
// max(t2, 0) < r2, the same for r2 > 0 (the launcher passes -inf for any
// other r2, where no point is a hit); so idx and cnt are bit-identical
// to geometry.ball_query. bq_step and bq_scan of fused_sa_common.cuh,
// which the fused kernels use, are not touched.

#include "fused_sa_common.cuh"

namespace pcl {

constexpr int kBqWarps = 8;             // warps a scan block
constexpr int kBqScanTopR = 2;          // most centers a warp walks together
constexpr int kBqScanMinBlocks = 528;   // blocks the scan's grid aims at
constexpr int kBqFlushMinPoints = 1024; // the scan flushes from this N up
constexpr int kBqCullWarps = 32;        // warps a cull block
constexpr int kBqCullCenters = 64;      // centers a cull block
constexpr int kBqSuper = 4;             // 32-point chunks a super-chunk
constexpr int kBqInFlight = 8;          // near chunks a cull step walks

// t2 of sq_dist without its clamp at 0 (see the note on numerics)
__device__ __forceinline__ float bq_t2(float cx, float cy, float cz,
                                       float c2, const float4& p) {
  const float inner = __fadd_rn(
      __fadd_rn(__fmul_rn(cx, p.x), __fmul_rn(cy, p.y)), __fmul_rn(cz, p.z));
  return __fadd_rn(__fmaf_rn(-2.0f, inner, c2), p.w);
}

// A center's walk so far: its idx row, hits counted, the first hit.
struct BqRow {
  int* row;
  int k;  // 0 for a center past M: nothing stored
  int count = 0;
  int first = 0;
};

// The hits of up to 32 sets, lane L holding the ballot w of the L-th
// (points j0, j0 + 1, ...; w = 0 where there is none): their ranks follow
// the count, the sets in lane order; those below k go to the row, each
// lane writing its set's (SPREAD false: as many steps as the most hits a
// set) or ranks L, L + 32, ... (SPREAD: a search of the lanes' prefix
// sums and of the set's bits a rank; for sets dense with hits).
template <bool SPREAD>
__device__ __forceinline__ void bq_flush(unsigned w, int j0, int lane,
                                         BqRow& r) {
  const int c = __popc(w);
  int incl = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  if (r.count == 0 && total) {  // the lowest lane with a hit has the first
    const int f = __ffs(__ballot_sync(0xffffffffu, w != 0)) - 1;
    r.first = __shfl_sync(0xffffffffu, j0 + __ffs(w) - 1, f);
  }
  if (SPREAD) {
    // lane L writes ranks count + L, count + L + 32, ...: the set s of
    // its hit h by a search over the lanes' prefix sums, then the bit
    const int take = min(total, r.k - r.count);
    for (int q = 0; q < take; q += 32) {
      const int h = q + lane;
      int s = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1)
        if (__shfl_sync(0xffffffffu, incl, s + step - 1) <= h) s += step;
      unsigned ws = __shfl_sync(0xffffffffu, w, s);
      const int js = __shfl_sync(0xffffffffu, j0, s);
      int nth = h - __shfl_sync(0xffffffffu, incl - c, s), pos = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1) {
        const int below = __popc((ws >> pos) & ((1u << step) - 1u));
        if (below <= nth) {
          nth -= below;
          pos += step;
        }
      }
      if (h < take) r.row[r.count + h] = js + pos;
    }
  } else if (r.count < r.k) {
    int rank = r.count + incl - c;
    while (w && rank < r.k) {
      r.row[rank++] = j0 + __ffs(w) - 1;
      w &= w - 1;
    }
  }
  r.count += total;
}

// A set's hits ranked at once: ranks count, count + 1, ... in index
// order; those below k go to the row.
__device__ __forceinline__ void bq_take(unsigned bal, int j0, int lane,
                                        BqRow& r) {
  const int rank = r.count + __popc(bal & ((1u << lane) - 1u));
  if ((bal >> lane & 1u) && rank < r.k) r.row[rank] = j0 + lane;
  if (r.count == 0 && bal) r.first = j0 + __ffs(bal) - 1;
  r.count += __popc(bal);
}

// The rest of a row: slots past min(count, k) repeat slot 0, a row with
// no hit is all 0; cnt by lane 0.
__device__ __forceinline__ void bq_finish(const BqRow& r, int* cnt,
                                          int lane) {
  const int live = r.count == 0 ? 0 : min(r.count, r.k);
  const int fill = r.count == 0 ? 0 : r.first;
  for (int s = live + lane; s < r.k; s += 32) r.row[s] = fill;
  if (lane == 0) *cnt = r.count;
}

// ------------------------------------------------------------------ scan

// FLUSH: the ballots ranked by a flush every 32 sets (bq_flush), else each
// set's at once (bq_take).
template <int R, bool FLUSH>
__global__ void __launch_bounds__(kBqWarps * 32)
    ball_query_scan_kernel(const float* __restrict__ new_xyz,
                           const float* __restrict__ pts,
                           int* __restrict__ idx, int* __restrict__ cnt,
                           int n, int m, int k, float r2) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* ptss = reinterpret_cast<float4*>(smem);
  constexpr int kCenters = kBqWarps * R;
  constexpr int kSets = R == 1 ? 8 : 4 / R;  // sets a step
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kCenters;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  stage_cloud(pts + (size_t)b * n * 3, n, ptss, threadIdx.x, kBqWarps * 32);
  __syncthreads();

  const int c0 = m0 + warp * R;
  if (c0 >= m) return;  // no barrier follows
  float cx[R], cy[R], cz[R], c2[R];
  BqRow rw[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {  // a center past m repeats the last, k 0
    const size_t center = (size_t)b * m + min(c0 + r, m - 1);
    cx[r] = new_xyz[3 * center];
    cy[r] = new_xyz[3 * center + 1];
    cz[r] = new_xyz[3 * center + 2];
    c2[r] = sumsq3(cx[r], cy[r], cz[r]);
    rw[r].row = idx + center * k;
    rw[r].k = c0 + r < m ? k : 0;
  }
  for (int seg = 0; seg < n; seg += 32 * 32) {  // 32 sets a flush
    unsigned w[R];
#pragma unroll
    for (int r = 0; r < R; ++r) w[r] = 0;
    const int sets = min(32, (n - seg + 31) / 32);
    for (int s = 0; s < sets; s += kSets) {
      float4 p[kSets];
#pragma unroll
      for (int t = 0; t < kSets; ++t)
        p[t] = ptss[min(seg + 32 * (s + t) + lane, n - 1)];
#pragma unroll
      for (int t = 0; t < kSets; ++t) {
        const bool in = seg + 32 * (s + t) + lane < n;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const unsigned bal = __ballot_sync(
              0xffffffffu, in && bq_t2(cx[r], cy[r], cz[r], c2[r], p[t]) < r2);
          if (!FLUSH)
            bq_take(bal, seg + 32 * (s + t), lane, rw[r]);
          else if (lane == s + t)
            w[r] = bal;
        }
      }
    }
    if (FLUSH) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        bq_flush<false>(w[r], seg + 32 * lane, lane, rw[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (c0 + r < m) bq_finish(rw[r], cnt + (size_t)b * m + c0 + r, lane);
}

// ------------------------------------------------------------------ cull

// The skip threshold of a center (bq_far), S = (c1 + l1max)^2 with c1 its
// |c|_1 and l1max the cloud's largest |p|_1: in f32 as written.
__device__ __forceinline__ float bq_thr(float c1, float l1max, float r2) {
  const float s = __fadd_rn(c1, l1max);
  return __fadd_rn(
      __fmul_rn(__fadd_rn(r2, __fmul_rn(0x1p-21f, __fmul_rn(s, s))),
                1.0f + 0x1p-21f),
      0x1p-100f);
}

// Whether a chunk's box (lo.xyz, hi.xyz) holds no hit of the center
// (cx, cy, cz) of threshold thr: the bound derived at the top of this
// file.
__device__ __forceinline__ bool bq_far(const float4& lo, const float4& hi,
                                       float cx, float cy, float cz,
                                       float thr) {
  const float gx =
      fmaxf(fmaxf(__fsub_rn(lo.x, cx), __fsub_rn(cx, hi.x)), 0.0f);
  const float gy =
      fmaxf(fmaxf(__fsub_rn(lo.y, cy), __fsub_rn(cy, hi.y)), 0.0f);
  const float gz =
      fmaxf(fmaxf(__fsub_rn(lo.z, cz), __fsub_rn(cz, hi.z)), 0.0f);
  const float dbox = __fadd_rn(
      __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), __fmul_rn(gz, gz));
  return dbox >= thr && thr < INFINITY;
}

__device__ __forceinline__ float bq_l1(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(fabsf(x), fabsf(y)), fabsf(z));
}

// f32 <-> u32 keys that order as the values (NaN past the infinities), so
// that a warp's min and max are one redux.sync each.
__device__ __forceinline__ unsigned bq_ukey(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : u | 0x80000000u;
}
__device__ __forceinline__ float bq_unkey(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? u & 0x7fffffffu : ~u);
}

__global__ void __launch_bounds__(kBqCullWarps * 32)
    ball_query_cull_kernel(const float* __restrict__ new_xyz,
                           const float* __restrict__ pts,
                           int* __restrict__ idx, int* __restrict__ cnt,
                           int n, int m, int k, float r2) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* ptss = reinterpret_cast<float4*>(smem);
  const int chunks = (n + 31) / 32;              // 32-point chunks
  const int supers = (chunks + kBqSuper - 1) / kBqSuper;
  float4* boxes = ptss + n;                      // [chunks][lo, hi]
  float4* sboxes = boxes + 2 * chunks;           // [supers][lo, hi]
  unsigned* l1max = reinterpret_cast<unsigned*>(sboxes + 2 * supers);
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kBqCullCenters;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  int* list = reinterpret_cast<int*>(l1max + 4) + warp * chunks;

  __shared__ int next;  // the block's next center: walks differ in length
  if (threadIdx.x == 0) {
    *l1max = 0;
    next = 0;
  }
  stage_cloud(pts + (size_t)b * n * 3, n, ptss, threadIdx.x,
              kBqCullWarps * 32);
  __syncthreads();
  // the boxes: a warp a super-chunk, one redux.sync a bound and chunk
  for (int sc = warp; sc < supers; sc += kBqCullWarps) {
    unsigned slo[3], shi[3], l1 = 0;
    for (int s = 0; s < kBqSuper; ++s) {
      const int ch = sc * kBqSuper + s;
      if (ch >= chunks) break;
      // a point past n repeats the last, which is in the last chunk
      const float4 p = ptss[min(ch * 32 + lane, n - 1)];
      const unsigned u[3] = {bq_ukey(p.x), bq_ukey(p.y), bq_ukey(p.z)};
      unsigned lo[3], hi[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        lo[d] = __reduce_min_sync(0xffffffffu, u[d]);
        hi[d] = __reduce_max_sync(0xffffffffu, u[d]);
        slo[d] = s == 0 ? lo[d] : min(slo[d], lo[d]);
        shi[d] = s == 0 ? hi[d] : max(shi[d], hi[d]);
      }
      l1 = max(l1, bq_ukey(bq_l1(p.x, p.y, p.z)));
      if (lane == 0) {
        boxes[2 * ch] = make_float4(bq_unkey(lo[0]), bq_unkey(lo[1]),
                                    bq_unkey(lo[2]), 0.0f);
        boxes[2 * ch + 1] = make_float4(bq_unkey(hi[0]), bq_unkey(hi[1]),
                                        bq_unkey(hi[2]), 0.0f);
      }
    }
    l1 = __reduce_max_sync(0xffffffffu, l1);
    if (lane == 0) {
      sboxes[2 * sc] = make_float4(bq_unkey(slo[0]), bq_unkey(slo[1]),
                                   bq_unkey(slo[2]), 0.0f);
      sboxes[2 * sc + 1] = make_float4(bq_unkey(shi[0]), bq_unkey(shi[1]),
                                       bq_unkey(shi[2]), 0.0f);
      atomicMax(l1max, l1);
    }
  }
  __syncthreads();
  const float cloud_l1 = bq_unkey(*l1max);

  const unsigned below = (1u << lane) - 1u;
  const int mt = min(m - m0, kBqCullCenters);
  for (;;) {
    int c = 0;
    if (lane == 0) c = atomicAdd(&next, 1);
    c = __shfl_sync(0xffffffffu, c, 0);
    if (c >= mt) break;
    const size_t center = (size_t)b * m + m0 + c;
    const float cx = new_xyz[3 * center], cy = new_xyz[3 * center + 1],
                cz = new_xyz[3 * center + 2];
    const float c2 = sumsq3(cx, cy, cz);
    const float thr = bq_thr(bq_l1(cx, cy, cz), cloud_l1, r2);
    // the near chunks, in order: the super-chunks' boxes 32 at a time,
    // then the chunks of the near ones, 32 / kBqSuper super-chunks a test
    int nn = 0;
    for (int s0 = 0; s0 < supers; s0 += 32) {
      const int sc = s0 + lane;
      const bool near = sc < supers && !bq_far(sboxes[2 * sc],
                                               sboxes[2 * sc + 1], cx, cy,
                                               cz, thr);
      unsigned ns = __ballot_sync(0xffffffffu, near);
      while (ns) {
        // lane L tests chunk L % kBqSuper of the (L / kBqSuper)-th of the
        // next 32 / kBqSuper near super-chunks
        int mine = -1;
#pragma unroll
        for (int q = 0; q < 32 / kBqSuper; ++q) {
          const int i = ns ? __ffs(ns) - 1 : -1;
          if (i >= 0) ns &= ns - 1;
          if (lane / kBqSuper == q && i >= 0)
            mine = (s0 + i) * kBqSuper + lane % kBqSuper;
        }
        const bool hit_box = mine >= 0 && mine < chunks &&
                             !bq_far(boxes[2 * mine], boxes[2 * mine + 1],
                                     cx, cy, cz, thr);
        const unsigned nb = __ballot_sync(0xffffffffu, hit_box);
        if (hit_box) list[nn + __popc(nb & below)] = mine;
        nn += __popc(nb);
      }
    }
    __syncwarp();
    // the walk: kBqInFlight near chunks a step; lane v keeps the ballot of
    // the v-th set since a flush
    BqRow rw;
    rw.row = idx + center * k;
    rw.k = k;
    unsigned w = 0;
    int wj = 0, v = 0;
    for (int t = 0; t < nn; t += kBqInFlight) {
      if (v > 32 - kBqInFlight) {
        bq_flush<true>(w, wj, lane, rw);
        w = 0;
        v = 0;
      }
      unsigned bal[kBqInFlight];
      int id[kBqInFlight];
#pragma unroll
      for (int u = 0; u < kBqInFlight; ++u) {
        id[u] = t + u < nn ? list[t + u] : -1;
        const int j = max(id[u], 0) * 32 + lane;
        const float4 p = ptss[min(j, n - 1)];
        bal[u] = __ballot_sync(
            0xffffffffu,
            id[u] >= 0 && j < n && bq_t2(cx, cy, cz, c2, p) < r2);
      }
#pragma unroll
      for (int u = 0; u < kBqInFlight; ++u) {
        if (id[u] < 0) break;
        if (lane == v) {
          w = bal[u];
          wj = id[u] * 32;
        }
        ++v;
      }
    }
    bq_flush<true>(w, wj, lane, rw);
    bq_finish(rw, cnt + center, lane);
    __syncwarp();  // the list is read before the next center's
  }
}

// ---------------------------------------------------------------- launch

// Shared memory bytes of a block: the cloud at 16 bytes a point, and on
// the cull route 32 bytes a chunk's and a super-chunk's box, 16 for the
// cloud's largest |p|_1 and each warp's list of near chunks.
inline size_t bq_smem(int route, int n) {
  const size_t chunks = (n + 31) / 32;
  const size_t supers = (chunks + kBqSuper - 1) / kBqSuper;
  return (size_t)n * 16 + (route == 1 ? (chunks + supers) * 32 + 16 +
                                            kBqCullWarps * chunks * 4
                                      : 0);
}

template <int R, bool FLUSH>
cudaError_t bq_scan_launch(const float* new_xyz, const float* pts, int* idx,
                           int* cnt, int batch, int n, int m, int k, float r2,
                           size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ball_query_scan_kernel<R, FLUSH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + kBqWarps * R - 1) / (kBqWarps * R), batch);
  ball_query_scan_kernel<R, FLUSH><<<grid, kBqWarps * 32, smem, stream>>>(
      new_xyz, pts, idx, cnt, n, m, k, r2);
  return cudaGetLastError();
}

template <int R>
cudaError_t bq_scan_launch(const float* new_xyz, const float* pts, int* idx,
                           int* cnt, int batch, int n, int m, int k, float r2,
                           size_t smem, cudaStream_t stream) {
  return n >= kBqFlushMinPoints
             ? bq_scan_launch<R, true>(new_xyz, pts, idx, cnt, batch, n, m,
                                       k, r2, smem, stream)
             : bq_scan_launch<R, false>(new_xyz, pts, idx, cnt, batch, n, m,
                                        k, r2, smem, stream);
}

// The scan's centers a warp: the largest R of kBqScanTopR, ..., 1 whose
// grid has kBqScanMinBlocks blocks, else 1.
inline int bq_scan_r(int batch, int m) {
  for (int r = kBqScanTopR; r > 1; r /= 2)
    if ((long long)batch * ((m + kBqWarps * r - 1) / (kBqWarps * r)) >=
        kBqScanMinBlocks)
      return r;
  return 1;
}

}  // namespace pcl

// route 0 (scan) or 1 (cull). Returns the launch's cudaGetLastError()
// code, or cudaErrorInvalidValue for sizes it does not take (one block's
// shared memory, bq_smem, above 227 KB).
extern "C" int ball_query_launch(const void* new_xyz, const void* pts,
                                 void* idx, void* cnt, int batch, int n,
                                 int m, int k, float r2, int route,
                                 void* stream) {
  if (batch < 1 || n < 1 || m < 1 || k < 1 || route < 0 || route > 1)
    return cudaErrorInvalidValue;
  const size_t smem = pcl::bq_smem(route, n);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (!(r2 > 0.0f)) r2 = -INFINITY;  // no point is a hit
  const auto* c = static_cast<const float*>(new_xyz);
  const auto* p = static_cast<const float*>(pts);
  auto* i = static_cast<int*>(idx);
  auto* h = static_cast<int*>(cnt);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    cudaError_t err = cudaFuncSetAttribute(
        pcl::ball_query_cull_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((m + pcl::kBqCullCenters - 1) / pcl::kBqCullCenters,
                    batch);
    pcl::ball_query_cull_kernel<<<grid, pcl::kBqCullWarps * 32, smem, s>>>(
        c, p, i, h, n, m, k, r2);
    return cudaGetLastError();
  }
  switch (pcl::bq_scan_r(batch, m)) {
    case 2:
      return pcl::bq_scan_launch<2>(c, p, i, h, batch, n, m, k, r2, smem, s);
    default:
      return pcl::bq_scan_launch<1>(c, p, i, h, batch, n, m, k, r2, smem, s);
  }
}
