// Eval-mode fused EdgeConv with the kNN graph built inside, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/fused_edge.py
// (_fused_edge_eval_knn_jit -> _ke_knn_eval). One DGCNN EdgeConv in
// eval mode, with Q = X.Wa (bf16) and Off = X.(Wa - Wb) (f32) computed
// outside:
//   out[b, i, c] = max over the k nearest j of x_i in x of
//                  leaky(sc[c] * (float(Q[b, j, c]) - Off[b, i, c]) + bi[c])
// with (sc, bi) the folded BatchNorm rows of the running statistics. No
// per-edge tensor reaches device memory.
//
// What bounds it: operations. The selection forms d2 for all B*N^2
// (query, point) pairs at 2*cin + 3 f32 operations each (33.5 M pairs a
// layer at B=32, N=1024), against reading x, Q and Off once and writing
// out. The selection is most of the kernel's time (PERF.md §5).
//
// Two routes, chosen by the wrapper (ops/kernels/knn.py edge_eval_route,
// the rule of pass 1's edge_f1_route):
//
// "select" (edge_knn_eval_select_kernel), for the shapes of DGCNN's
// paths: the kNN's select route (knn_select.cuh sel_walk: 128 queries a
// block, the points streamed through a ring of three cp.async tiles,
// each query's list in its group's 8 lanes' registers, |p|^2 by
// knn_norms_kernel before; no FMA pass, which lost at N = 2,048 and k =
// 40 in pass 1), the lists then written into the tiles' shared memory,
// and an eval half shaped like pass 1's write half (fused_sa_f1.cuh
// f1_center), eval_center of edge_eval.cuh (shared with edge_eval.cu's
// variants): one warp a center, 8 channels a lane, each neighbour's Q
// row read from L2 by 16-byte __ldg (kF1Unroll of them in flight a
// lane), the running max in registers over the lane's slots, folded
// across the warp's slot groups by shuffles, out written by 16-byte
// stores. Instances: kEdgeRoutes (knn_select.cuh), one for each list
// length and output width of the paths; the one at C = 256 (DGCNN's
// EC4, C_in = 128: 170 KB of tiles, one block an SM) takes 256 queries a
// block and a ring of two tiles, one wave of 128 blocks on 132 SMs in
// place of 1.94 waves of 256 (0.809 against 0.834 ms, PERF.md §5).
//
// "block" (edge_knn_eval_kernel, the first version): knn_block of
// edge_knn.cuh (64 queries, a 64 x 64 d2 tile through shared memory,
// four walkers a query), then one channel pair a thread (edge_eval_rows).
// It takes the widths and list lengths the select instances do not, and
// small grids.
//
// Numerics: the neighbour lists are bit-identical to the plain version's
// on both routes (every d2 that enters a list is the plain order's); the
// gather, BN and LeakyReLU take the plain version's rounded operations in
// its order, and the max of a set does not depend on its order, so out is
// bit-identical too.

#include "edge_eval.cuh"
#include "knn_select.cuh"

namespace pcl {

// The walk of a select instance: queries a thread (32 of them a block)
// and point tiles in the ring.
template <int C>
struct EvalWalk {
  static constexpr int QPT = C == 256 ? 8 : 4;
  static constexpr int STAGES = C == 256 ? 2 : 3;
  static constexpr int BLOCKS = C == 256 ? 1 : 2;  // a block's registers
};

// Shared memory of the select route in bytes: the walk's tiles, which
// then hold the lists [32 qpt][k].
__host__ __device__ inline size_t eval_sel_smem(int qpt, int stages, int cin,
                                                int k) {
  const size_t walk = sel_smem(qpt, stages, cin);
  const size_t lists = (size_t)4 * 32 * qpt * k;
  return ((walk > lists ? walk : lists) + 15) / 16 * 16;
}

template <int E, int C>
__global__ void __launch_bounds__(kThreads, EvalWalk<C>::BLOCKS)
    edge_knn_eval_select_kernel(const float* __restrict__ x,
                                const __nv_bfloat16* __restrict__ q,
                                const float* __restrict__ off,
                                const float* __restrict__ st,
                                const float* __restrict__ p2g,
                                float* __restrict__ out, int n, int cin,
                                int k, float slope) {
  using W = EvalWalk<C>;
  constexpr int Q = 32 * W::QPT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y, q0 = blockIdx.x * Q;
  const int nq = min(Q, n - q0);
  const float* xb = x + (size_t)b * n * cin;
  float ld[W::QPT][E];
  int lj[W::QPT][E];
  sel_walk<W::QPT, E, W::STAGES, false>(xb + (size_t)q0 * cin, nq, xb,
                                        p2g + (size_t)b * n, n, cin, k, smem,
                                        ld, lj);
  const int* nbr = sel_lists<W::QPT, E>(lj, nq, k, k, 1, smem);  // [Q][k]
  const int cc = (lane % F1Lanes<C>::L) * 8;
  float sc[8], bi[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    sc[c] = st[cc + c];
    bi[c] = st[C + cc + c];
  }
  const size_t row0 = (size_t)b * n + q0;
  const __nv_bfloat16* qb = q + (size_t)b * n * C;
  for (int ql = warp; ql < nq; ql += kWarps)
    eval_center<C>(qb, off + (row0 + ql) * C, out + (row0 + ql) * C,
                   nbr + ql * k, k, sc, bi, slope, lane);
}

template <int KP>
__global__ void __launch_bounds__(kThreads)
    edge_knn_eval_kernel(const float* __restrict__ x,
                         const __nv_bfloat16* __restrict__ q,
                         const float* __restrict__ off,
                         const float* __restrict__ st,
                         float* __restrict__ out, int n, int cin, int c,
                         int k, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kKnnQ;
  const float* xb = x + (size_t)b * n * cin;
  const int* nbr = knn_block<KP>(xb, n, xb, n, cin, q0, k,
                                 reinterpret_cast<float*>(smem));
  const size_t cb = (size_t)b * n * c;
  edge_eval_rows(nbr, q + cb, off + cb, st, out + cb, c, k, slope, q0,
                 min(kKnnQ, n - q0));
}

struct EvalLaunch {
  const float *x, *off, *st, *p2g;
  const __nv_bfloat16* q;
  float* out;
  int b, n, cin, c, k;
  float slope;
  size_t smem;
  cudaStream_t stream;
};

template <int KP>
cudaError_t launch_block(const EvalLaunch& a) {
  cudaError_t err = cudaFuncSetAttribute(
      edge_knn_eval_kernel<KP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)a.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + kKnnQ - 1) / kKnnQ, a.b);
  edge_knn_eval_kernel<KP><<<grid, kThreads, a.smem, a.stream>>>(
      a.x, a.q, a.off, a.st, a.out, a.n, a.cin, a.c, a.k, a.slope);
  return cudaGetLastError();
}

template <int E, int C>
cudaError_t launch_select(EvalLaunch a) {
  using W = EvalWalk<C>;
  a.smem = eval_sel_smem(W::QPT, W::STAGES, a.cin, a.k);
  if (a.smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kernel = edge_knn_eval_select_kernel<E, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + 32 * W::QPT - 1) / (32 * W::QPT), a.b);
  kernel<<<grid, kThreads, a.smem, a.stream>>>(a.x, a.q, a.off, a.st, a.p2g,
                                               a.out, a.n, a.cin, a.k,
                                               a.slope);
  return cudaGetLastError();
}

}  // namespace pcl

// Shared memory bytes of one block of the block route for input width
// cin and k neighbours.
extern "C" long long edge_knn_eval_smem(int cin, int k) {
  return 4LL * (long long)pcl::knn_smem_words(cin, k);
}

// x [b, n, cin] f32, q [b, n, c] bf16, off [b, n, c] f32, st [4, c] f32
// (folded BN rows sc, bi, rs, mrs), out [b, n, c] f32, norms [b, n] f32
// scratch of the select route (|p|^2; unused by the block route); all
// contiguous and 16-byte aligned. route: 0 the block route; 1 .. 4 the
// select instance kEdgeRoutes[route - 1] (knn_select.cuh; its width c, k
// <= 8 E). Returns the launch's cudaGetLastError() code, or
// cudaErrorInvalidValue for sizes it does not take (k > n, k > 40, an odd
// c or one whose channel pairs do not divide the block, too much shared
// memory, an unknown route or one that does not take them).
extern "C" int edge_knn_eval_launch(const void* x, const void* q,
                                    const void* off, const void* st,
                                    void* out, void* norms, int b, int n,
                                    int cin, int c, int k, int route,
                                    float slope, void* stream) {
  if (b < 1 || cin < 1 || k < 1 || k > n || k > pcl::kKnnMaxK ||
      !pcl::edge_width_ok(c) || route < 0 || route > pcl::kEdgeRouteCount)
    return cudaErrorInvalidValue;
  pcl::EvalLaunch a{static_cast<const float*>(x),
                    static_cast<const float*>(off),
                    static_cast<const float*>(st),
                    static_cast<const float*>(norms),
                    static_cast<const __nv_bfloat16*>(q),
                    static_cast<float*>(out),
                    b, n, cin, c, k, slope, 0,
                    static_cast<cudaStream_t>(stream)};
  if (route > 0) {
    if (!pcl::edge_route_takes(route, c, k)) return cudaErrorInvalidValue;
    const cudaError_t err =
        pcl::launch_norms(x, norms, (long long)b * n, cin, a.stream);
    if (err != cudaSuccess) return err;
    switch (route) {
      case 1: return pcl::launch_select<3, 64>(a);
      case 2: return pcl::launch_select<3, 128>(a);
      case 3: return pcl::launch_select<3, 256>(a);
      default: return pcl::launch_select<5, 64>(a);
    }
  }
  a.smem = (size_t)edge_knn_eval_smem(cin, k);
  if (a.smem > 227 * 1024) return cudaErrorInvalidValue;
  switch (pcl::knn_list_length(k)) {
    case 8: return pcl::launch_block<8>(a);
    case 16: return pcl::launch_block<16>(a);
    case 24: return pcl::launch_block<24>(a);
    case 32: return pcl::launch_block<32>(a);
    case 40: return pcl::launch_block<40>(a);
    default: return cudaErrorInvalidValue;
  }
}
