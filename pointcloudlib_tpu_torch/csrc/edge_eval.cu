// Eval-mode fused EdgeConv from a given neighbour index, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/fused_edge.py
// (fused_edge_eval -> _ke_eval), the route DGCNN takes at N % 128 != 0
// after the standalone kNN (knn.cu). With Q = X.Wa (bf16) and
// Off = X.(Wa - Wb) (f32) computed outside and idx [B, M, k]:
//   out[b, i, c] = max over kk of
//       leaky(sc[c] * (float(Q[b, idx[b, i, kk], c]) - Off[b, i, c]) + bi[c])
// with (sc, bi) the folded BatchNorm rows of the running statistics. No
// per-edge tensor reaches device memory.
//
// The TPU kernel gathers Q with a one-hot product; here each neighbour's
// Q row is read by index from L2 (a cloud's Q is 5 MB at DGCNN's layer 4
// at N = 10,000). Two routes, chosen by the wrapper from C (fused_edge.py
// edge_eval_route):
// - center (C = 64, 128 and 256, DGCNN's widths): one wave of resident
//   blocks whose warps walk the centers, C/8 lanes a center (four, two or
//   one center a warp), as the given-index pass 1 walks them a warp each
//   (fused_sa_f1.cuh f1_idx_walk): the center's idx row by 16-byte loads
//   (4 bytes where k % 4 != 0) into its slice of shared memory, then
//   edge_eval.cuh's eval_center_extreme: 8 channels a lane, one neighbour
//   row a group instruction by a 16-byte gather of Q, kEvUnroll in flight
//   a lane, the extreme of the bf16 rows by max.bf16x2 (the sign of each
//   channel whose BN scale is negative flipped), then Off, BN and
//   LeakyReLU once a center and 16-byte stores;
// - rows (every other width edge_width_ok takes): the first version, the
//   block's slice of idx staged by load_nbr in the selection's layout,
//   then edge_eval_rows (edge_knn.cuh, shared with edge_knn_eval.cu's
//   block route), one thread a channel pair with 4-byte gathers.
//
// What bounds it: bytes. It reads idx, Off and Q once each and writes out
// (0.25 GB at DGCNN's layer 4 at B=32, N = 10,000). Its practical floor
// is higher: every center gathers its k neighbours' Q rows from L2,
// B*M*k*C*2 bytes (3.3 GB there). The first version spent 43-65 % of its
// time in the per-edge arithmetic (PERF.md §5), which the extreme-first
// reduction takes out of the loop over the edges; a warp a center (the
// shuffles folding its row groups) and 8 rows in flight a lane (which
// spilled at 64 registers) were slower (tools/kernel_variants.py).
//
// Numerics: out is bit-identical to the plain version on both routes
// (torch.equal; edge_eval.cuh says why the extreme first is exact).

#include "edge_eval.cuh"

namespace pcl {

// Tuning constants of the center route, each timed against other values
// by tools/kernel_variants.py (--only edgeevalidx).
constexpr int kEvUnroll = 4;     // gathers in flight a lane
constexpr int kEvMinBlocks = 4;  // launch bounds: blocks an SM
constexpr int kEvLanes = 8;      // lanes a center: C/8, but at least this

// Lanes a center at width c, and centers a warp.
__host__ __device__ constexpr int ev_lanes(int c) {
  return c / 8 > kEvLanes ? c / 8 : kEvLanes;
}
__host__ __device__ constexpr int ev_groups(int c) { return 32 / ev_lanes(c); }

// Dynamic shared memory of the center route: an index row a center of
// each warp.
inline size_t ev_center_smem(int c, int k) {
  return (size_t)kWarps * ev_groups(c) * ((k + 3) / 4 * 16);
}

__global__ void __launch_bounds__(kThreads)
    edge_eval_kernel(const __nv_bfloat16* __restrict__ q,
                     const int* __restrict__ idx,
                     const float* __restrict__ off,
                     const float* __restrict__ st, float* __restrict__ out,
                     int m, int n, int c, int k, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* nbr = reinterpret_cast<int*>(smem);  // [k][kKnnQ]
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kKnnQ;
  const int nq = min(kKnnQ, m - q0);
  load_nbr(idx + (size_t)b * m * k, q0, nq, k, nbr);
  const size_t mb = (size_t)b * m * c;
  edge_eval_rows(nbr, q + (size_t)b * n * c, off + mb, st, out + mb, c, k,
                 slope, q0, nq);
}

// q [batch, n, C] bf16, off and out [batch, m, C], idx [batch, m, k]:
// the group of W lanes of each warp walks the centers
// (blockIdx.x * kWarps + warp) * G + group, stepping by the grid's
// groups. Every group of a warp runs the same number of steps
// (__syncwarp, and the shuffles where a center's row groups fold, take
// the whole warp); a group past the last center reduces the last one
// again and stores nothing.
template <int C>
__global__ void __launch_bounds__(kThreads, kEvMinBlocks)
    edge_eval_center_kernel(const __nv_bfloat16* __restrict__ q,
                            const int* __restrict__ idx,
                            const float* __restrict__ off,
                            const float* __restrict__ st,
                            float* __restrict__ out, int n, int m, int k,
                            float slope, long long centers) {
  constexpr int W = ev_lanes(C), G = ev_groups(C);
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int grp = lane / W, gl = lane % W;
  const int kp = (k + 3) / 4 * 4;
  int* nbr = reinterpret_cast<int*>(smem) + (warp * G + grp) * kp;
  const float* stc = st + (gl % F1Lanes<C>::L) * 8;
  uint32_t flip[4];
  ev_flip(stc, flip);
  const long long stride = (long long)gridDim.x * kWarps * G;
  for (long long c0 = ((long long)blockIdx.x * kWarps + warp) * G;
       c0 < centers; c0 += stride) {
    const long long center = min(c0 + grp, centers - 1);
    const int* ig = idx + center * k;
    if (k % 4 == 0) {
      for (int e = 4 * gl; e < k; e += 4 * W)
        *reinterpret_cast<int4*>(nbr + e) =
            __ldg(reinterpret_cast<const int4*>(ig + e));
    } else {
      for (int e = gl; e < k; e += W) nbr[e] = __ldg(ig + e);
    }
    __syncwarp();
    eval_center_extreme<C, kEvUnroll, W>(
        q + (center / m) * n * C, off + center * C,
        c0 + grp < centers ? out + center * C : nullptr, nbr, k, stc, flip,
        slope, gl);
    __syncwarp();  // before the next row overwrites nbr
  }
}

template <int C>
cudaError_t launch_center(const void* q, const void* idx, const void* off,
                          const void* st, void* out, int b, int m, int n,
                          int k, float slope, cudaStream_t stream) {
  const size_t smem = ev_center_smem(C, k);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kernel = edge_eval_center_kernel<C>;
  int wave = 0;
  cudaError_t err = wave_blocks(kernel, smem, &wave);
  if (err != cudaSuccess) return err;
  const long long centers = (long long)b * m;
  const long long per_block = (long long)kWarps * ev_groups(C);
  const int blocks = (int)std::min<long long>(
      wave, (centers + per_block - 1) / per_block);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int*>(idx),
      static_cast<const float*>(off), static_cast<const float*>(st),
      static_cast<float*>(out), n, m, k, slope, centers);
  return cudaGetLastError();
}

}  // namespace pcl

// Shared memory bytes of one block for width c and k neighbours on route
// 0 (rows) or 1 (center).
extern "C" long long edge_eval_smem(int c, int k, int route) {
  if (route == 1) return (long long)pcl::ev_center_smem(c, k);
  return 4LL * (long long)k * pcl::kKnnQ;
}

// q [b, n, c] bf16, idx [b, m, k] i32 with every entry in [0, n),
// off [b, m, c] f32, st [4, c] f32 (folded BN rows sc, bi, rs, mrs),
// out [b, m, c] f32; all contiguous, 16-byte aligned on route 1. Route 0
// (rows) takes an even c whose channel pairs divide the block, route 1
// (center) c = 64, 128 or 256. Returns the launch's cudaGetLastError()
// code, or cudaErrorInvalidValue for what the route does not take
// (another width, too much shared memory).
extern "C" int edge_eval_launch(const void* q, const void* idx,
                                const void* off, const void* st, void* out,
                                int b, int m, int n, int c, int k, int route,
                                float slope, void* stream) {
  if (b < 1 || m < 1 || n < 1 || k < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (c == 64)
      return pcl::launch_center<64>(q, idx, off, st, out, b, m, n, k, slope,
                                    s);
    if (c == 128)
      return pcl::launch_center<128>(q, idx, off, st, out, b, m, n, k,
                                     slope, s);
    if (c == 256)
      return pcl::launch_center<256>(q, idx, off, st, out, b, m, n, k,
                                     slope, s);
    return cudaErrorInvalidValue;
  }
  if (route != 0 || !pcl::edge_width_ok(c)) return cudaErrorInvalidValue;
  const long long smem = edge_eval_smem(c, k, 0);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      pcl::edge_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + pcl::kKnnQ - 1) / pcl::kKnnQ, b);
  pcl::edge_eval_kernel<<<grid, pcl::kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int*>(idx),
      static_cast<const float*>(off), static_cast<const float*>(st),
      static_cast<float*>(out), m, n, c, k, slope);
  return cudaGetLastError();
}
