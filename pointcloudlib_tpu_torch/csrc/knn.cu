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
// "select" (knn_select_kernel; its pieces in knn_select.cuh, which
// edge_knn_f1.cu shares), for large clouds or grids. A block takes
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

#include "knn_select.cuh"

namespace pcl {

// The select route: one block's walk (sel_walk), then its lists out.
template <int QPT, int E, int STAGES, bool FAST>
__global__ void __launch_bounds__(kThreads, QPT <= 4 ? 2 : 1)
    knn_select_kernel(const float* __restrict__ query,
                      const float* __restrict__ pts,
                      const float* __restrict__ p2g, float* __restrict__ d2,
                      int* __restrict__ idx, int m, int n, int c, int k) {
  constexpr int Q = 32 * QPT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y, q0 = blockIdx.x * Q;
  const int nq = min(Q, m - q0);
  float ld[QPT][E];
  int lj[QPT][E];
  sel_walk<QPT, E, STAGES, FAST>(query + ((size_t)b * m + q0) * c, nq,
                                 pts + (size_t)b * n * c, p2g + (size_t)b * n,
                                 n, c, k, smem, ld, lj);
  const int lane = threadIdx.x & 31;
  const int qg = (threadIdx.x >> 5) * 4 + (lane >> 3), cg = lane & 7;
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
    float* p2g = static_cast<float*>(norms);
    const cudaError_t err = pcl::launch_norms(pts, p2g, (long long)b * n, c, s);
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
