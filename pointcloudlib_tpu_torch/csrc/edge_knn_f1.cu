// Train-mode fused EdgeConv, forward pass 1, with the kNN graph built
// inside, for Hopper (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/fused_edge.py
// (_call_eknn_f1 -> _ke_knn_f1). For each point i of each cloud, with
// Q = X.Wa (bf16) and Off = X.(Wa - Wb) (f32) computed outside:
//   idx [B, N, k] i32     the k nearest points j of x_i in x (self
//                          included), ascending d2, lower index on ties;
//   h [B, N, k, C] bf16   the checkpoint bf16(float(Q[b, j]) - Off[b, i]);
//   psum [2, C] f32       += [sum h, sum h^2] over all B*N*k rows, of the
//                          f32 h before its rounding (zeroed by the
//                          caller).
// The TPU kernel writes h as [k, N, C] because its round index must land
// on an untiled dimension; here rows are written in [B, N, k, C], the
// layout edge_out.cu and edge_bwd.cu read.
//
// What bounds it: operations, the selection's B*N*N pairs at 2*C_in + 3
// f32 operations each (the kNN, knn.cu); beside them, writing h
// (B*N*k*C*2 bytes, 335 MB at layer 4 of DGCNN at B=32, 0.10 ms at 3.35
// TB/s) and gathering Q's rows from L2. The TPU kernel carries the BN
// sums across its sequential grid; here blocks run in parallel, so each
// keeps its sums in registers and adds them once into psum.
//
// Two routes, chosen by the wrapper (ops/kernels/knn.py edge_f1_route):
//
// "select" (edge_knn_f1_select_kernel), for the shapes of DGCNN's paths:
// the kNN's select route (knn_select.cuh: 128 queries a block, the
// points streamed through a ring of three cp.async tiles, each query's
// list in its group's 8 lanes' registers, |p|^2 by knn_norms_kernel
// before; not the FMA pass, which was slower at part segmentation's N =
// 2,048, PERF.md §5), then the block writes
// its queries' rows with pass 1's write half of the set abstraction
// (fused_sa_f1.cuh f1_center: one warp a center, 8 channels a lane, 16-
// byte gathers of Q's rows and 16-byte streaming stores of h, a slot that
// repeats slot 0's index stored without a gather, the sums in registers)
// and adds its sums into psum once (f1_flush). The lists go through the
// tiles' shared memory after the walk, so the selection keeps its ring.
// Instances: those the wrapper takes (kF1Routes), one for each list
// length and output width of the paths.
//
// "block" (edge_knn_f1_kernel, the first version): knn_block of
// edge_knn.cuh (64 queries, a 64 x 64 d2 tile through shared memory,
// four walkers a query), then one channel pair a thread (edge_f1_rows).
// It takes the widths and list lengths the select instances do not, and
// small grids.
//
// Numerics: idx and h are bit-identical to the plain version on both
// routes (every d2 that enters a list is the plain order's); the sums
// are taken in another order (and the atomics' order changes from run
// to run), so psum agrees to f32 rounding of its largest element.

#include "fused_sa_f1.cuh"
#include "knn_select.cuh"

namespace pcl {

constexpr int kF1Qpt = 4;     // queries a thread of the walk: 128 a block
constexpr int kF1Stages = 3;  // point tiles in the ring

// Shared memory of the select route in bytes: the walk's tiles, which
// then hold the lists [128][k], and the block's sums [2C] after them.
__host__ __device__ inline size_t f1_sel_lists(int cin, int k) {
  const size_t walk = sel_smem(kF1Qpt, kF1Stages, cin);
  const size_t lists = (size_t)4 * 32 * kF1Qpt * k;
  return ((walk > lists ? walk : lists) + 15) / 16 * 16;
}
__host__ __device__ inline size_t f1_sel_smem(int cin, int c, int k) {
  return f1_sel_lists(cin, k) + (size_t)8 * c;
}

template <int E, int C>
__global__ void __launch_bounds__(kThreads, 2)
    edge_knn_f1_select_kernel(const float* __restrict__ x,
                              const __nv_bfloat16* __restrict__ q,
                              const float* __restrict__ off,
                              const float* __restrict__ p2g,
                              int* __restrict__ idx,
                              __nv_bfloat16* __restrict__ h,
                              float* __restrict__ psum, int n, int cin,
                              int k) {
  constexpr int Q = 32 * kF1Qpt;
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + f1_sel_lists(cin, k));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < 2 * C; i += kThreads) red[i] = 0.0f;
  const int b = blockIdx.y, q0 = blockIdx.x * Q;
  const int nq = min(Q, n - q0);
  const float* xb = x + (size_t)b * n * cin;
  float ld[kF1Qpt][E];
  int lj[kF1Qpt][E];
  sel_walk<kF1Qpt, E, kF1Stages, false>(xb + (size_t)q0 * cin, nq, xb,
                                        p2g + (size_t)b * n, n, cin, k, smem,
                                        ld, lj);
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the tiles
  int* nbr = reinterpret_cast<int*>(smem);  // [Q][k]
  const int qg = warp * 4 + (lane >> 3), cg = lane & 7;
#pragma unroll
  for (int r = 0; r < kF1Qpt; ++r) {
    const int ql = qg + 32 * r;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int slot = cg * E + e;
      if (ql < nq && slot < k) nbr[ql * k + slot] = lj[r][e];
    }
  }
  __syncthreads();
  const size_t row0 = (size_t)b * n + q0;
  for (int e = tid; e < nq * k; e += kThreads) idx[row0 * k + e] = nbr[e];
  const __nv_bfloat16* qb = q + (size_t)b * n * C;
  F1Sums s;
  s.zero();
  for (int ql = warp; ql < nq; ql += kWarps)
    f1_center<C>(qb, off + (row0 + ql) * C, h + (row0 + ql) * k * C,
                 nbr + ql * k, k, lane, s);
  f1_flush<C>(s, lane, red, psum);
}

template <int KP>
__global__ void __launch_bounds__(kThreads)
    edge_knn_f1_kernel(const float* __restrict__ x,
                       const __nv_bfloat16* __restrict__ q,
                       const float* __restrict__ off, int* __restrict__ idx,
                       __nv_bfloat16* __restrict__ h,
                       float* __restrict__ psum, int n, int cin, int c,
                       int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sm = reinterpret_cast<float*>(smem);
  float* red = sm + knn_smem_words(cin, k);  // [2c] block sums
  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * c; i += kThreads) red[i] = 0.0f;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kKnnQ;
  const float* xb = x + (size_t)b * n * cin;
  const int* nbr = knn_block<KP>(xb, n, xb, n, cin, q0, k, sm);

  const int nq = min(kKnnQ, n - q0);
  int* ib = idx + ((size_t)b * n + q0) * k;
  for (int e = tid; e < nq * k; e += kThreads) {
    const int ql = e / k;
    ib[e] = nbr[(e - ql * k) * kKnnQ + ql];
  }
  const size_t cb = (size_t)b * n * c;
  edge_f1_rows(nbr, q + cb, off + cb, h + cb * k, red, c, k, q0, nq);
  __syncthreads();
  for (int i = tid; i < 2 * c; i += kThreads) atomicAdd(psum + i, red[i]);
}

struct F1Launch {
  const void *x, *q, *off;
  const float* p2g;
  void *idx, *h, *psum;
  int b, n, cin, c, k;
  size_t smem;
  cudaStream_t stream;
};

template <int KP>
cudaError_t launch_block(const F1Launch& a) {
  cudaError_t err = cudaFuncSetAttribute(
      edge_knn_f1_kernel<KP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)a.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + kKnnQ - 1) / kKnnQ, a.b);
  edge_knn_f1_kernel<KP><<<grid, kThreads, a.smem, a.stream>>>(
      static_cast<const float*>(a.x), static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const float*>(a.off), static_cast<int*>(a.idx),
      static_cast<__nv_bfloat16*>(a.h), static_cast<float*>(a.psum), a.n,
      a.cin, a.c, a.k);
  return cudaGetLastError();
}

template <int E, int C>
cudaError_t launch_select(const F1Launch& a) {
  auto kernel = edge_knn_f1_select_kernel<E, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + 32 * kF1Qpt - 1) / (32 * kF1Qpt), a.b);
  kernel<<<grid, kThreads, a.smem, a.stream>>>(
      static_cast<const float*>(a.x), static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const float*>(a.off), a.p2g, static_cast<int*>(a.idx),
      static_cast<__nv_bfloat16*>(a.h), static_cast<float*>(a.psum), a.n,
      a.cin, a.k);
  return cudaGetLastError();
}

// The select route's instances, route r at kF1Routes[r - 1]: (list
// entries a lane E, the output width C), the ones the wrapper takes
// (ops/kernels/knn.py EDGE_F1_SELECT): DGCNN's k = 20 at C = 64, 128,
// 256 and its part segmentation's k = 40 at C = 64.
constexpr int kF1Routes[][2] = {{3, 64}, {3, 128}, {3, 256}, {5, 64}};
constexpr int kF1RouteCount = 4;

}  // namespace pcl

// Shared memory bytes of one block of the block route for input width
// cin, output width c and k neighbours.
extern "C" long long edge_knn_f1_smem(int cin, int c, int k) {
  return 4LL * ((long long)pcl::knn_smem_words(cin, k) + 2LL * c);
}

// x [b, n, cin] f32, q [b, n, c] bf16, off [b, n, c] f32; idx [b, n, k]
// i32, h [b, n, k, c] bf16, psum [2, c] f32 zeroed, norms [b, n] f32
// scratch of the select route (|p|^2; unused by the block route); all
// contiguous and 16-byte aligned. route: 0 the block route; 1 .. 4 the
// select instance kF1Routes[route - 1] (its width c, k <= 8 E). Returns
// the launch's cudaGetLastError()
// code, or cudaErrorInvalidValue for sizes it does not take (as
// edge_knn_eval_launch; an unknown route or one that does not take
// them).
extern "C" int edge_knn_f1_launch(const void* x, const void* q,
                                  const void* off, void* idx, void* h,
                                  void* psum, void* norms, int b, int n,
                                  int cin, int c, int k, int route,
                                  void* stream) {
  if (b < 1 || cin < 1 || k < 1 || k > n || k > pcl::kKnnMaxK ||
      !pcl::edge_width_ok(c) || route < 0 || route > pcl::kF1RouteCount)
    return cudaErrorInvalidValue;
  pcl::F1Launch a{x, q, off, static_cast<const float*>(norms), idx, h, psum,
                  b, n, cin, c, k, 0, static_cast<cudaStream_t>(stream)};
  if (route > 0) {
    const int* rt = pcl::kF1Routes[route - 1];
    a.smem = pcl::f1_sel_smem(cin, c, k);
    if (a.smem > 227 * 1024 || rt[1] != c || 8 * rt[0] < k)
      return cudaErrorInvalidValue;
    const long long rows = (long long)b * n;
    pcl::knn_norms_kernel<<<(unsigned)((rows + pcl::kThreads - 1) /
                                        pcl::kThreads),
                            pcl::kThreads, 0, a.stream>>>(
        static_cast<const float*>(x), static_cast<float*>(norms), rows, cin);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    switch (route) {
      case 1: return pcl::launch_select<3, 64>(a);
      case 2: return pcl::launch_select<3, 128>(a);
      case 3: return pcl::launch_select<3, 256>(a);
      default: return pcl::launch_select<5, 64>(a);
    }
  }
  a.smem = (size_t)edge_knn_f1_smem(cin, c, k);
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
