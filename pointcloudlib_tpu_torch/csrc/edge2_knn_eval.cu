// Eval-mode two-layer EdgeConv with the kNN graph built inside, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/fused_edge.py
// (_fused_edge2_eval_knn_jit -> _ke2_knn_eval). DGCNN part
// segmentation's EdgeConv pairs in eval mode, with Q = X.Wa (bf16) and
// Off = X.(Wa - Wb) (f32) computed outside:
//   out[b, i, c] = max over the k nearest j of x_i in x of
//       leaky(BN2(bf16(leaky(BN1(float(Q[b, j]) - Off[b, i]))) . W2))[c]
// with the folded BN rows of the running statistics. No per-edge tensor
// reaches device memory.
//
// What bounds it: operations. The selection forms d2 for all B*N^2
// pairs at 2*cin + 3 f32 operations each; the chain is 2*C1*C2 flops an
// edge (10.7 GFLOP a layer at B=16, N=2048, k=40: 0.011 ms of bf16 on
// the tensor cores, 0.16 ms of f32 on the CUDA cores).
//
// Two routes, chosen by the wrapper (ops/kernels/knn.py edge_eval_route,
// the rule of pass 1's edge_f1_route):
//
// "select" (edge2_knn_eval_select_kernel), for part segmentation's
// pairs: the kNN's select route as edge_knn_eval.cu runs it
// (knn_select.cuh sel_walk: 128 queries a block, a ring of three
// cp.async tiles, lists in 8 lanes' registers, no FMA pass), the lists
// then written slot-major into the tiles' shared memory (a slot's 64
// entries of a tile side by side, so the gathers read them without bank
// conflicts), then the chain on the tensor cores. The block's 128 centers
// are two tiles of kRows = 64 (edge2.cuh's layout: a tile's row r is
// slot kk of center r); a step is one slot of one tile:
//   - warpgroup g forms h2's columns [32 g, 32 g + 32) by wgmma
//     (edge2_wgmma.cuh chain_issue, the backward passes' product: y1 the
//     K-major A in the core-matrix layout of wgmma_tile.cuh, W2 the
//     MN-major B, staged once);
//   - while it runs, one warp a group of 8 channels stages the next
//     step's y1 = bf16(leaky(BN1(float(Q[j]) - Off[i]))) into the other
//     of two y1 tiles, from Q rows gathered by 16-byte __ldg a step
//     before (Off's rows and the BN rows stay in registers);
//   - each thread folds max leaky(BN2(h2)) into its accumulator
//     fragment's fixed rows and channels, and writes them to out after
//     the tile's last slot.
// One barrier a step. No gradient follows, so there is no tie walk and no
// kink band. After the walk its tiles hold the lists, W2 and the y1
// tiles, so two blocks fit an SM.
//
// "block" (edge2_knn_eval_kernel, the first version): knn_block of
// edge_knn.cuh (64 queries, four walkers a query), then the chain of
// edge2.cuh on the CUDA cores (gather_max), for small grids and the list
// lengths no select instance takes.
//
// Numerics: the neighbour lists are bit-identical to the plain version's
// on both routes, y1 too; h2 sums in another order (the tensor cores'
// or the CUDA cores' f32 sums of the exact bf16 products), so out agrees
// to f32 rounding of the product.

#include "edge2_wgmma.cuh"
#include "knn_select.cuh"

namespace pcl {

constexpr int kE2Qpt = 4;     // queries a thread of the walk: 128 a block
constexpr int kE2Stages = 3;  // point tiles in the ring

// Shared memory of the select route, byte offsets: the walk's tiles, then
// the lists [k][Q] (i32), W2 (core-matrix [C1, C2]) and two y1 tiles
// [kRows, C1] (core-matrix).
template <int C1, int C2>
struct E2SelLayout {
  static constexpr int Q = 32 * kE2Qpt;
  __host__ __device__ static size_t w2(int k) {
    return ((size_t)4 * Q * k + 127) / 128 * 128;
  }
  __host__ __device__ static size_t ys(int k) {
    return w2(k) + (size_t)2 * C1 * C2;
  }
  __host__ __device__ static size_t bytes(int cin, int k) {
    const size_t walk = sel_smem(kE2Qpt, kE2Stages, cin);
    const size_t chain = ys(k) + (size_t)2 * kRows * C1 * 2;
    return ((walk > chain ? walk : chain) + 127) / 128 * 128;
  }
};

// A step's place: the tile of the block's centers and the slot.
struct E2Slot {
  int tile, kk;
  __device__ void next(int k) {
    if (++kk == k) {
      kk = 0;
      ++tile;
    }
  }
};

template <int E, int C1, int C2>
__global__ void __launch_bounds__(kThreads, 2)
    edge2_knn_eval_select_kernel(const float* __restrict__ x,
                                 const __nv_bfloat16* __restrict__ q,
                                 const float* __restrict__ off,
                                 const float* __restrict__ st,
                                 const __nv_bfloat16* __restrict__ w2,
                                 const float* __restrict__ p2g,
                                 float* __restrict__ out, int n, int cin,
                                 int k, float slope) {
  using L = E2SelLayout<C1, C2>;
  constexpr int Q = L::Q, N2 = C2 / 2;  // h2's columns a warpgroup
  static_assert(C1 == 8 * kWarps && N2 == 32 && Q == 2 * kRows,
                "a warp a channel group of y1; m64n32 products; two tiles");
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = tid / wg::kWGThreads, t = tid % wg::kWGThreads;
  const int b = blockIdx.y, q0 = blockIdx.x * Q;
  const int nq = min(Q, n - q0);
  const float* xb = x + (size_t)b * n * cin;
  float ld[kE2Qpt][E];
  int lj[kE2Qpt][E];
  sel_walk<kE2Qpt, E, kE2Stages, false>(xb + (size_t)q0 * cin, nq, xb,
                                        p2g + (size_t)b * n, n, cin, k, smem,
                                        ld, lj);
  const int* nbr = sel_lists<kE2Qpt, E>(lj, nq, k, 1, Q, smem);  // [k][Q]
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem + L::w2(k));
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem + L::ys(k));
  stage_w<C1, C2>(w2, w2s, kThreads);

  // staging: rows lane and lane + 32 of a tile, channels sc .. sc + 7,
  // their BN1 rows; the fragment's columns g N2 + frag_col(t, n, j) and
  // their BN2 rows at [2 n + j]
  const int sc = warp * 8;
  float sc1[8], bi1[8], sc2[N2 / 4], bi2[N2 / 4];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    sc1[c] = st[sc + c];
    bi1[c] = st[C1 + sc + c];
  }
#pragma unroll
  for (int nn = 0; nn < N2 / 8; ++nn)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = g * N2 + wg::frag_col(t, nn, j);
      sc2[2 * nn + j] = st[4 * C1 + col];
      bi2[2 * nn + j] = st[4 * C1 + C2 + col];
    }
  const size_t row0 = (size_t)b * n + q0;
  const __nv_bfloat16* qb = q + (size_t)b * n * C1;
  const int steps = (nq + kRows - 1) / kRows * k;
  float offr[2][8];  // Off of the staging rows of the tile being staged
  uint4 qv[2];       // their gathered Q rows at the slot being staged

  auto gather = [&](const E2Slot& p) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ql = p.tile * kRows + lane + 32 * i;
      if (ql < nq)
        qv[i] = __ldg(reinterpret_cast<const uint4*>(
            qb + (size_t)nbr[p.kk * Q + ql] * C1 + sc));
    }
  };
  auto stage = [&](const E2Slot& p, __nv_bfloat16* dst) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = lane + 32 * i, ql = p.tile * kRows + r;
      uint4 yv = make_uint4(0, 0, 0, 0);
      if (ql < nq) {
        if (p.kk == 0) {
          const float4* o =
              reinterpret_cast<const float4*>(off + (row0 + ql) * C1 + sc);
          const float4 oa = o[0], ob = o[1];
          offr[i][0] = oa.x, offr[i][1] = oa.y, offr[i][2] = oa.z;
          offr[i][3] = oa.w, offr[i][4] = ob.x, offr[i][5] = ob.y;
          offr[i][6] = ob.z, offr[i][7] = ob.w;
        }
        float y[8];
#pragma unroll
        for (int c = 0; c < 8; ++c)
          y[c] = leaky(bn_z(__fsub_rn(bf_at(qv[i], c), offr[i][c]), sc1[c],
                            bi1[c]),
                       slope);
        yv = pack8(y);
      }
      *reinterpret_cast<uint4*>(dst + wg::cm(r, sc, C1)) = yv;
    }
  };

  E2Slot cur{0, 0}, ahead{0, 0};
  gather(ahead);
  stage(ahead, ys);
  ahead.next(k);
  if (steps > 1) gather(ahead);
  wg::fence_to_async();
  __syncthreads();  // W2 and the first y1 tile are staged
  float mx[N2 / 2];
#pragma unroll
  for (int v = 0; v < N2 / 2; ++v) mx[v] = -INFINITY;
  for (int s = 0; s < steps; ++s, cur.next(k)) {
    float h[N2 / 2];
#pragma unroll
    for (int v = 0; v < N2 / 2; ++v) h[v] = 0.0f;
    chain_issue<C1, C2, C1>(h, ys + (s & 1) * kRows * C1, w2s, g);
    if (s + 1 < steps) {  // ahead is step s + 1, its rows gathered
      stage(ahead, ys + ((s + 1) & 1) * kRows * C1);
      ahead.next(k);
      if (s + 2 < steps) gather(ahead);
    }
    wg::wait<0>();
    wg::fence_regs(h);
#pragma unroll
    for (int v = 0; v < N2 / 2; ++v) {
      const int nj = 2 * (v >> 2) + (v & 1);
      mx[v] = fmaxf(mx[v], leaky(bn_z(h[v], sc2[nj], bi2[nj]), slope));
    }
    if (cur.kk == k - 1) {  // the tile's last slot: its rows of out
#pragma unroll
      for (int nn = 0; nn < N2 / 8; ++nn)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int ql = cur.tile * kRows + wg::frag_row(t, i);
          const int v = 4 * nn + 2 * i;
          if (ql < nq)
            *reinterpret_cast<float2*>(
                out + (row0 + ql) * C2 + g * N2 + wg::frag_col(t, nn, 0)) =
                make_float2(mx[v], mx[v + 1]);
        }
#pragma unroll
      for (int v = 0; v < N2 / 2; ++v) mx[v] = -INFINITY;
    }
    wg::fence_to_async();
    __syncthreads();  // the next y1 tile is staged; this one is free
  }
}

__host__ __device__ inline size_t knn_bytes(int cin, int k) {
  return (4 * knn_smem_words(cin, k) + 15) / 16 * 16;
}

template <int KP, int C1, int C2>
__global__ void __launch_bounds__(kThreads)
    edge2_knn_eval_kernel(const float* __restrict__ x,
                          const __nv_bfloat16* __restrict__ q,
                          const float* __restrict__ off,
                          const float* __restrict__ st,
                          const __nv_bfloat16* __restrict__ w2,
                          float* __restrict__ out, int n, int cin, int k,
                          float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Edge2Smem<C1, C2> s(smem + knn_bytes(cin, k));
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kKnnQ;
  const float* xb = x + (size_t)b * n * cin;
  stage_chain(s, w2, st);
  const int* nbr = knn_block<KP>(xb, n, xb, n, cin, q0, k,
                                 reinterpret_cast<float*>(smem));
  const size_t cb = (size_t)b * n;
  gather_max(s, nbr, q + cb * C1, off + cb * C1, out + cb * C2, q0,
             min(kKnnQ, n - q0), k, slope);
}

struct E2Launch {
  const float *x, *off, *st, *p2g;
  const __nv_bfloat16 *q, *w2;
  float* out;
  int b, n, cin, k;
  float slope;
  size_t smem;
  cudaStream_t stream;
};

template <typename K>
cudaError_t launch_e2(K kernel, dim3 grid, const E2Launch& a) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, a.smem, a.stream>>>(a.x, a.q, a.off, a.st, a.w2,
                                               a.out, a.n, a.cin, a.k,
                                               a.slope);
  return cudaGetLastError();
}

template <int E, int C1, int C2>
cudaError_t launch_select(const E2Launch& a) {
  auto kernel = edge2_knn_eval_select_kernel<E, C1, C2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + E2SelLayout<C1, C2>::Q - 1) / E2SelLayout<C1, C2>::Q,
                  a.b);
  kernel<<<grid, kThreads, a.smem, a.stream>>>(a.x, a.q, a.off, a.st, a.w2,
                                               a.p2g, a.out, a.n, a.cin, a.k,
                                               a.slope);
  return cudaGetLastError();
}

template <int C1, int C2>
cudaError_t launch_widths(const E2Launch& a) {
  const dim3 grid((a.n + kKnnQ - 1) / kKnnQ, a.b);
  switch (knn_list_length(a.k)) {
#define PCL_CASE(KP) \
  case KP:           \
    return launch_e2(edge2_knn_eval_kernel<KP, C1, C2>, grid, a);
    PCL_CASE(8)
    PCL_CASE(16)
    PCL_CASE(24)
    PCL_CASE(32)
    PCL_CASE(40)
#undef PCL_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace pcl

// Shared memory bytes of one block of the block route for input width
// cin and k neighbours: the selection's and the chain's (the compiled
// widths' largest).
extern "C" long long edge2_knn_eval_smem(int cin, int k) {
  return (long long)pcl::knn_bytes(cin, k) +
         (long long)pcl::Edge2Layout<64, 64>::bytes;
}

// x [b, n, cin] f32, q [b, n, c1] bf16, off [b, n, c1] f32, st
// [4*c1 + 4*c2] f32 (the folded rows of both layers), w2 [c1, c2] bf16,
// out [b, n, c2] f32, norms [b, n] f32 scratch of the select route
// (|p|^2; unused by the block route); all contiguous and 16-byte
// aligned. route: 0 the block route; 1 or 4 the select instance
// kEdgeRoutes[route - 1] (knn_select.cuh; C = c1 = c2 = 64, k <= 8 E).
// Returns the launch's cudaGetLastError() code, or cudaErrorInvalidValue
// for sizes it does not take (k > n, k > 40, widths not compiled, too
// much shared memory, an unknown route or one that does not take them).
extern "C" int edge2_knn_eval_launch(const void* x, const void* q,
                                     const void* off, const void* st,
                                     const void* w2, void* out, void* norms,
                                     int b, int n, int cin, int c1, int c2,
                                     int k, int route, float slope,
                                     void* stream) {
  if (b < 1 || cin < 1 || k < 1 || k > n || k > pcl::kKnnMaxK || route < 0 ||
      route > pcl::kEdgeRouteCount)
    return cudaErrorInvalidValue;
  pcl::E2Launch a{static_cast<const float*>(x),
                  static_cast<const float*>(off),
                  static_cast<const float*>(st),
                  static_cast<const float*>(norms),
                  static_cast<const __nv_bfloat16*>(q),
                  static_cast<const __nv_bfloat16*>(w2),
                  static_cast<float*>(out),
                  b, n, cin, k, slope, 0,
                  static_cast<cudaStream_t>(stream)};
  if (route > 0) {
    a.smem = pcl::E2SelLayout<64, 64>::bytes(cin, k);
    if (a.smem > 227 * 1024 || c1 != c2 ||
        !pcl::edge_route_takes(route, c2, k))
      return cudaErrorInvalidValue;
    const cudaError_t err =
        pcl::launch_norms(x, norms, (long long)b * n, cin, a.stream);
    if (err != cudaSuccess) return err;
    switch (route) {
      case 1: return pcl::launch_select<3, 64, 64>(a);
      case 4: return pcl::launch_select<5, 64, 64>(a);
      default: return cudaErrorInvalidValue;
    }
  }
  a.smem = (size_t)edge2_knn_eval_smem(cin, k);
  if (a.smem > 227 * 1024) return cudaErrorInvalidValue;
#define PCL_LAUNCH(A, B) \
  if (c1 == A && c2 == B) return pcl::launch_widths<A, B>(a);
  PCL_EDGE2_WIDTHS(PCL_LAUNCH)
#undef PCL_LAUNCH
  return cudaErrorInvalidValue;
}
