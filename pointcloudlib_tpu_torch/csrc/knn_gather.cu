// Fused k nearest neighbours and row gather, for Hopper (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/neighbors.py
// (knn_gather -> _knn_gather_fwd_call -> _knn_gather_kernel). For query
// [B, M, C], points [B, N, C] and values [B, N, Cv] (f32):
//   idx [B, M, k] i32        ranks 0, D, 2D, ..., (k-1)D of the points
//       ordered by d2 = max((|q|^2 - 2 q.p) + |p|^2, 0), ascending, the
//       lower index first on ties (D = stride; 1 for PointConv, the
//       dilation of PointCNN's kNN otherwise);
//   grouped [B, M, k, Cv] f32  values[b, idx[b, m, s], :], exact copies.
//
// The TPU kernel holds a [mt, N] distance tile in VMEM and runs k*D
// masked argmin rounds over it, each round's mask doubling as the one-hot
// row of a gather matmul (hi/lo bf16 halves), and writes [B, k, M, Cv]
// for a swap afterwards. Here one warp takes one query and forms its d2
// row over the N points in shared memory, in the plain square_distance's
// operations and order (products and sums rounded one at a time, no
// FMA), so the order is bit-identical to knn_plain's. Two routes
// (kg_route, ops/kernels/knn_gather.py knn_gather_route):
//
// select (R = (k-1)*D + 1 ranks, at most kKgSelMaxRanks, where a warp's
// row, list and slots fit in shared memory): every rank is chosen before
// any row is copied. The key row and the selection are knn_rank.cuh's,
// which knn.cu's rank route shares.
//   * At C = 3, where a block's queries share a batch, the block first
//     stages the cloud as (x, y, z, |p|^2); the lanes form the d2 of
//     consecutive points.
//   * A point's order key is its d2's bits with the sign cleared (d2 >= 0,
//     so the bits order as the values; -0 counts as +0), then its index.
//   * The R-th smallest key is found by bisection on the 31 key bits,
//     each step one count of the keys below a bound, read four at a time
//     from shared memory by all 32 lanes and summed by redux.sync. It
//     stops as soon as exactly R keys lie below the bound. Once the bounds
//     hold at most kKgCand keys, those go to registers and the bisection
//     goes on there; where equal keys straddle rank R, a second bisection
//     on the index takes the lower indices among them.
//   * The R chosen points go by ballots into a list of 64-bit (key,
//     index) words; each one's rank is the count of smaller words in the
//     list, and ranks 0, D, 2D, ... go to idx and to the warp's slots.
//   * The k rows are then copied in one pass over the query's k*Cv
//     output words, contiguous in grouped: 16-byte units at Cv % 4 == 0
//     (else 4-byte units), kKgInFlight loads in flight a lane, streaming
//     stores. No lane idles at a row's end.
// rounds (the first version, for more ranks or rows of up to 58,112
// points): (k-1)*D + 1 serial rounds of a shuffle argmin over the lanes'
// minima on (d2, j), each followed by a copy of a kept rank's row and a
// rescan of the winner's N/32 entries by its owner lane.
//
// What bounds it: bytes at PointConv's shapes: the grouped rows written,
// B*M*k*Cv*4 (138 MB at classification's SA2), beside values read and idx
// written once, against B*M*N pairs at 2*C + 3 f32 operations (the
// convention of the kNN kernels), under 1 % of it there. The rounds route
// pays k global-load latencies and k one-lane rescans in series a query;
// the select route keeps its loads for one streamed pass.

#include <type_traits>

#include "knn_rank.cuh"

namespace pcl {

constexpr int kKgSelMaxRanks = 256;          // ranks of the select route
constexpr int kKgInFlight = 8;               // copy units in flight a lane

// ---------------------------------------------------------------- rounds

template <bool VEC>
__global__ void __launch_bounds__(kKgMaxWarps * 32)
    knn_gather_rounds_kernel(const float* __restrict__ query,
                             const float* __restrict__ pts,
                             const float* __restrict__ values,
                             int* __restrict__ idx,
                             float* __restrict__ grouped, long long queries,
                             int m, int n, int c, int cv, int k, int stride) {
  extern __shared__ float d2s[];  // [warps][n]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long qid = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (qid >= queries) return;  // no block-wide barrier follows
  float* row = d2s + (size_t)warp * n;
  const long long b = qid / m;
  const float* qp = query + qid * c;
  const float* pb = pts + (size_t)b * n * c;
  const float* vb = values + (size_t)b * n * cv;
  const float q2 = kg_q2(qp, c);

  float bd = INFINITY;
  int bj = 0x7fffffff;
  for (int j = lane; j < n; j += 32) {
    const float d = kg_d2(qp, pb + (size_t)j * c, q2, c);
    row[j] = d;
    if (kg_better(d, j, bd, bj)) {
      bd = d;
      bj = j;
    }
  }
  __syncwarp();

  const int rounds = (k - 1) * stride + 1;  // the last slot's skips unread
  for (int r = 0; r < rounds; ++r) {
    float wd = bd;
    int wj = bj;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, wd, off);
      const int oj = __shfl_xor_sync(0xffffffffu, wj, off);
      if (kg_better(od, oj, wd, wj)) {
        wd = od;
        wj = oj;
      }
    }
    if (r % stride == 0) {
      const long long slot = qid * k + r / stride;
      if (lane == 0) idx[slot] = wj;
      const float* src = vb + (size_t)wj * cv;
      float* dst = grouped + slot * cv;
      if (VEC) {
        const float4* s4 = reinterpret_cast<const float4*>(src);
        float4* d4 = reinterpret_cast<float4*>(dst);
        for (int e = lane; e < cv / 4; e += 32) d4[e] = __ldg(s4 + e);
      } else {
        for (int e = lane; e < cv; e += 32) dst[e] = __ldg(src + e);
      }
    }
    if (lane == (wj & 31)) {  // the owner masks the winner and rescans
      row[wj] = NAN;
      bd = INFINITY;
      bj = 0x7fffffff;
      for (int j = lane; j < n; j += 32) {
        const float d = row[j];
        if (kg_better(d, j, bd, bj)) {
          bd = d;
          bj = j;
        }
      }
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------- select

// STAGED: C = 3 and every query of the block in one batch; the block's
// cloud goes to shared memory as (x, y, z, |p|^2) first.
template <bool VEC, bool STAGED>
__global__ void __launch_bounds__(kKgMaxWarps * 32)
    knn_gather_select_kernel(const float* __restrict__ query,
                             const float* __restrict__ pts,
                             const float* __restrict__ values,
                             int* __restrict__ idx,
                             float* __restrict__ grouped, long long queries,
                             int m, int n, int c, int cv, int k, int stride) {
  extern __shared__ __align__(16) unsigned char kg_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const long long qid = (long long)blockIdx.x * warps + warp;
  const int ranks = (k - 1) * stride + 1;
  const int words = (n + 3) / 4;
  const float4* cloud = reinterpret_cast<const float4*>(kg_smem);
  unsigned char* mine = kg_smem + (STAGED ? (size_t)n * 16 : 0) +
                        (size_t)warp * kg_sel_warp_bytes(n, k, ranks);
  uint4* row4 = reinterpret_cast<uint4*>(mine);
  uint32_t* row = reinterpret_cast<uint32_t*>(mine);
  unsigned long long* list =
      reinterpret_cast<unsigned long long*>(mine + (size_t)words * 16);
  unsigned long long* cand = list + ranks;
  int* slots = reinterpret_cast<int*>(cand + kKgCand);
  if (STAGED)
    kg_stage_cloud(pts + (size_t)((long long)blockIdx.x * warps / m) * n * 3,
                   n, reinterpret_cast<float4*>(kg_smem));
  if (qid >= queries) return;  // no block-wide barrier follows
  const long long b = qid / m;
  const float* qp = query + qid * c;
  const float q2 = kg_q2(qp, c);
  kg_key_row<STAGED>(qp, q2, cloud, pts + (size_t)b * n * c, n, c, words,
                     row, lane);
  kg_select(row4, row, words, n, ranks, lane, list, cand);

  // ranks: the count of smaller words; ranks 0, D, 2D, ... are kept
  for (int e = lane; e < ranks; e += 32) {
    const unsigned long long w = list[e];
    int r = 0;
#pragma unroll 8
    for (int f = 0; f < ranks; ++f) r += list[f] < w;
    if (r % stride == 0) {
      const int j = (int)(w & 0xffffffffu);
      slots[r / stride] = j;
      idx[qid * k + r / stride] = j;
    }
  }
  __syncwarp();

  // the rows: unit u of the query's k * Cv output words (16-byte units at
  // VEC) comes from row slots[u / per] of values, at u % per
  using Unit = typename std::conditional<VEC, float4, float>::type;
  const int per = VEC ? cv / 4 : cv;
  const int units = k * per;
  const Unit* vb =
      reinterpret_cast<const Unit*>(values + (size_t)b * n * cv);
  Unit* dst = reinterpret_cast<Unit*>(grouped + qid * k * cv);
  const float inv = 1.0f / (float)per;
  for (int u0 = 0; u0 < units; u0 += 32 * kKgInFlight) {
    Unit v[kKgInFlight];
#pragma unroll
    for (int t = 0; t < kKgInFlight; ++t) {
      const int u = u0 + 32 * t + lane;
      if (u < units) {
        // u / per by a float estimate, then corrected (by at most one
        // step while u < 2^24)
        int s = __float2int_rz(__int2float_rn(u) * inv);
        while ((s + 1) * per <= u) ++s;
        while (s * per > u) --s;
        v[t] = __ldg(vb + (size_t)slots[s] * per + (u - s * per));
      }
    }
#pragma unroll
    for (int t = 0; t < kKgInFlight; ++t) {
      const int u = u0 + 32 * t + lane;
      if (u < units) __stcs(dst + u, v[t]);
    }
  }
}

// ---------------------------------------------------------------- launch

inline int kg_rounds_warps(int n) { return kg_fit(4 * (size_t)n); }
inline int kg_select_warps(int n, int k, int stride, size_t fixed = 0) {
  const long long ranks = (long long)(k - 1) * stride + 1;
  if (ranks > kKgSelMaxRanks) return 0;
  return kg_fit(kg_sel_warp_bytes(n, k, (int)ranks), fixed);
}

// The route for these sizes: 1 (select) where its ranks and shared
// memory fit, else 0 (rounds).
inline int kg_route(int n, int k, int stride) {
  return kg_select_warps(n, k, stride) >= 1 ? 1 : 0;
}

template <bool VEC, bool STAGED>
cudaError_t launch_select(int warps, const void* query, const void* pts,
                          const void* values, void* idx, void* grouped, int b,
                          int m, int n, int c, int cv, int k, int stride,
                          cudaStream_t stream) {
  const size_t smem = (STAGED ? (size_t)n * 16 : 0) +
                      warps * kg_sel_warp_bytes(n, k, (k - 1) * stride + 1);
  auto kernel = knn_gather_select_kernel<VEC, STAGED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long queries = (long long)b * m;
  const long long blocks = (queries + warps - 1) / warps;
  kernel<<<(unsigned)blocks, warps * 32, smem, stream>>>(
      static_cast<const float*>(query), static_cast<const float*>(pts),
      static_cast<const float*>(values), static_cast<int*>(idx),
      static_cast<float*>(grouped), queries, m, n, c, cv, k, stride);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch(int route, const void* query, const void* pts,
                   const void* values, void* idx, void* grouped, int b, int m,
                   int n, int c, int cv, int k, int stride,
                   cudaStream_t stream) {
  if (route == 1) {
    // staged where C = 3 and a block's queries (as many warps as fit
    // beside the cloud, dividing M) share a batch
    int warps = c == 3 ? kg_select_warps(n, k, stride, (size_t)n * 16) : 0;
    while (warps > 1 && m % warps) --warps;
    if (warps >= 1 && m % warps == 0)
      return launch_select<VEC, true>(warps, query, pts, values, idx,
                                      grouped, b, m, n, c, cv, k, stride,
                                      stream);
    return launch_select<VEC, false>(kg_select_warps(n, k, stride), query,
                                     pts, values, idx, grouped, b, m, n, c,
                                     cv, k, stride, stream);
  }
  const int warps = kg_rounds_warps(n);
  const size_t smem = (size_t)warps * n * 4;
  cudaError_t err = cudaFuncSetAttribute(
      knn_gather_rounds_kernel<VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long queries = (long long)b * m;
  const long long blocks = (queries + warps - 1) / warps;
  knn_gather_rounds_kernel<VEC><<<(unsigned)blocks, warps * 32, smem,
                                  stream>>>(
      static_cast<const float*>(query), static_cast<const float*>(pts),
      static_cast<const float*>(values), static_cast<int*>(idx),
      static_cast<float*>(grouped), queries, m, n, c, cv, k, stride);
  return cudaGetLastError();
}

}  // namespace pcl

// query [b, m, c], pts [b, n, c], values [b, n, cv] f32; idx [b, m, k] i32,
// grouped [b, m, k, cv] f32; all contiguous; route 0 (rounds) or 1
// (select). Returns the launch's cudaGetLastError() code, or
// cudaErrorInvalidValue for sizes the route does not take (empty sizes,
// k * stride > n; rounds: n above 58,112, one warp's d2 row in shared
// memory; select: (k - 1) * stride + 1 above 256 ranks, or one warp's
// part above the shared memory).
extern "C" int knn_gather_route_launch(const void* query, const void* pts,
                                       const void* values, void* idx,
                                       void* grouped, int b, int m, int n,
                                       int c, int cv, int k, int stride,
                                       int route, void* stream) {
  if (b < 1 || m < 1 || n < 1 || c < 1 || cv < 1 || k < 1 || stride < 1 ||
      (long long)k * stride > n || route < 0 || route > 1 ||
      (route == 0 ? pcl::kg_rounds_warps(n)
                  : pcl::kg_select_warps(n, k, stride)) < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = cv % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(values) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(grouped) % 16 == 0;
  if (vec)
    return pcl::launch<true>(route, query, pts, values, idx, grouped, b, m,
                             n, c, cv, k, stride, s);
  return pcl::launch<false>(route, query, pts, values, idx, grouped, b, m, n,
                            c, cv, k, stride, s);
}

// The same on the route the sizes take (pcl::kg_route).
extern "C" int knn_gather_launch(const void* query, const void* pts,
                                 const void* values, void* idx, void* grouped,
                                 int b, int m, int n, int c, int cv, int k,
                                 int stride, void* stream) {
  if (n < 1 || k < 1 || stride < 1) return cudaErrorInvalidValue;
  return knn_gather_route_launch(query, pts, values, idx, grouped, b, m, n,
                                 c, cv, k, stride,
                                 pcl::kg_route(n, k, stride), stream);
}
