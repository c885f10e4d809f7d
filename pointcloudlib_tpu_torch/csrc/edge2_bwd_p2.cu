// Train-mode two-layer EdgeConv, backward pass 2, for Hopper (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/fused_edge.py
// (_e2_bwd_rule -> _ke2_p2). With the BN sums known (us2 = ps2/R from
// pass 1, us1 = s1/R from _combine_p1; R = B*M*k), per edge (the chain
// and dz2 as in edge2_bwd_p1.cu):
//   dh2 = sc2*((dz2 - us2[0]) - x2*us2[1])
//   dy1 = bf16(dh2) . bf16(W2^T)                      (f32 sums)
//   dh1 = sc1*((m1*dy1 - us1[0]) - x1*us1[1])
// and per center and per source point:
//   doff [B*M, C1] = -sum over the k slots of dh1
//   dq   [B, N, C1] += dh1 at row idx of the edge    (zeroed by the caller)
// The TPU kernel scatters dh1 with a hi/lo bf16 one-hot product, an
// almost exact f32 scatter; here by 16-byte f32 vector reductions
// (RED.ADD.F32x4 in L2), as edge_bwd.cu does.
//
// What bounds it: bytes. Its three products (the chain in both walks
// below, and dy1), 2*C1*C2 flops an edge each, are 32 GFLOP of bf16 at
// B=16, N=2048, k=40, 0.033 ms on the tensor cores; reading h1 twice
// (0.34 GB) and dq's reductions (84 M f32, 0.34 GB) are ~0.2 ms at 3.35
// TB/s.
//
// The design is pass 1's (edge2_bwd_p1.cu), with the chain, pass A and
// the kink band of edge2_wgmma.cuh, so that this pass's h2, tie counts
// and leaky masks are pass 1's bit for bit. Blocks of two warpgroups,
// two blocks an SM, walk tiles of 64 centers twice. A step (one slot of
// one pass):
//   - the slot's h1 rows come in by cp.async two steps ahead, into a
//     ring of three raw tiles (a step reads its own again for dh1, so
//     the tile the copies go to is the last step's);
//   - one warp a group of 8 channels stages y1 as bf16 into the y1 tile
//     [64, C1], in the core-matrix layout of wgmma_tile.cuh;
//   - warpgroup g forms h2's columns [32 g, 32 g + 32) (chain_h2);
//   - pass A folds the max and tie count, then the shares dout / ties;
//   - pass B: from the accumulator fragment, dz2 (the share where
//     leaky(z2) reaches the max, times slope where z2 <= 0), x2 and dh2,
//     stored as bf16 into the dh2 tile [64, C2] (the K-major A); warpgroup
//     g forms dy1's columns [32 g, 32 g + 32) by wgmma (m64n32k16, W2 the
//     K-major B: W2^T without a copy); dh1 from dy1's fragment and the
//     raw h1 tile. A thread's fragment rows are fixed centers, so doff's
//     sums stay in its registers over the k slots; two neighbouring
//     lanes trade one row's channels, so that each adds 4 channels of its
//     row into dq by one 16-byte reduction.
// Three barriers a step in pass B, two in pass A. Registers a thread:
// h2's and dy1's accumulators 16 each, the folds (max and tie count,
// then the share) 32, doff's sums 16.
//
// Numerics: y1, h2 and the tie structure are pass 1's; dy1 and the sums
// of doff and dq take another order than the plain version (and the
// reductions' order changes from run to run), so dq and doff agree to
// f32 rounding, except where a last-bit change of h2 moves a max-pool
// tie share.

#include "edge2_wgmma.cuh"

namespace pcl {

struct Edge2P2Args {
  const __nv_bfloat16* h1;  // [centers, k, C1]
  const float* dout;        // [centers, C2]
  const int* idx;           // [centers, k]
  const float* st;          // [4, C1] ++ [4, C2]
  const float* us;          // [2, C2] ++ [2, C1]
  const __nv_bfloat16* w2;  // [C1, C2]
  float* dq;                // [centers / m, n, C1]
  float* doff;              // [centers, C1]
  long long centers;
  int m, n, k;
  float slope;
};

// Shared memory, byte offsets: W2 (core-matrix), the folded rows and the
// pre-divided sums, three raw h1 tiles, the y1 and dh2 tiles.
template <int C1, int C2>
struct E2P2Layout {
  static constexpr int RAW = C1 + 8;  // raw row stride, elements
  static constexpr int RING = 3;      // raw tiles: AHEAD in flight and
  static constexpr int AHEAD = RING - 1;  // the step's own
  static constexpr size_t w2 = 0;
  static constexpr size_t st = w2 + (size_t)C1 * C2 * 2;
  static constexpr size_t raw =
      (st + (size_t)6 * (C1 + C2) * 4 + 127) / 128 * 128;
  static constexpr size_t ys = raw + (size_t)RING * kRows * RAW * 2;
  static constexpr size_t ds = ys + (size_t)kRows * C1 * 2;
  static constexpr size_t bytes = ds + (size_t)kRows * C2 * 2;
};

template <int C1, int C2>
__global__ void __launch_bounds__(kThreads, 2)
    edge2_p2_kernel(const Edge2P2Args a) {
  using L = E2P2Layout<C1, C2>;
  constexpr int RAW = L::RAW;
  constexpr int N2 = C2 / 2, N1 = C1 / 2;  // h2's, dy1's columns a warpgroup
  static_assert(C1 == 8 * kWarps && N2 == 32 && N1 == 32,
                "a warp a channel group of h1; m64n32 products");
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem + L::w2);
  float* sts = reinterpret_cast<float*>(smem + L::st);
  __nv_bfloat16* raws = reinterpret_cast<__nv_bfloat16*>(smem + L::raw);
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem + L::ys);
  __nv_bfloat16* ds = reinterpret_cast<__nv_bfloat16*>(smem + L::ds);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = tid / wg::kWGThreads, t = tid % wg::kWGThreads;
  stage_w<C1, C2>(a.w2, w2s, kThreads);
  for (int i = tid; i < 4 * (C1 + C2); i += kThreads) sts[i] = a.st[i];
  for (int i = tid; i < 2 * (C1 + C2); i += kThreads)
    sts[4 * (C1 + C2) + i] = a.us[i];
  const float* sc1 = sts;
  const float* bi1 = sc1 + C1;
  const float* rs1 = bi1 + C1;
  const float* mrs1 = rs1 + C1;
  const float* sc2 = sts + 4 * C1;
  const float* bi2 = sc2 + C2;
  const float* rs2 = bi2 + C2;
  const float* mrs2 = rs2 + C2;
  const float* us2 = sts + 4 * (C1 + C2);  // [2, C2]
  const float* us1 = us2 + 2 * C2;         // [2, C1]
  const int k = a.k;
  const float slope = a.slope;

  // step s: slot s % k of pass (s / k) % 2 of the block's tile s / (2k)
  const long long tiles = center_tiles(a.centers);
  const long long mine =
      blockIdx.x < tiles ? (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x
                         : 0;
  const long long steps = mine * 2 * k;
  const long long stride = (long long)gridDim.x * kRows;
  auto load_raw = [&](const E2Walk& w, int buf) {
    const int nc = (int)min((long long)kRows, a.centers - w.c0);
    __nv_bfloat16* dst = raws + buf * kRows * RAW;
    for (int e = tid; e < nc * (C1 / 8); e += kThreads) {
      const int r = e / (C1 / 8), u = e % (C1 / 8);
      cp_async16(dst + r * RAW + u * 8,
                 a.h1 + ((size_t)(w.c0 + r) * k + w.kk) * C1 + u * 8);
    }
  };

  float h[N2 / 2];                 // h2's accumulator
  float mx[N2 / 2], tg[N2 / 2];    // the folds; tg: ties, then the share
  float dsum[N1 / 2];              // doff's sums
  const int sc = warp * 8;         // this thread's channels of h1 when staging
  // the row whose dq reductions this thread makes: its fragment's first
  // row on even lanes, its second on odd ones
  const int odd = t & 1;
  const int rq = wg::frag_row(t, odd);
  long long dq_rows = 0;  // dq's row of point 0 of rq's cloud

  E2Walk cur{(long long)blockIdx.x * kRows, 0, 0}, ahead = cur;
#pragma unroll
  for (int i = 0; i < L::AHEAD; ++i) {
    if (i < steps) load_raw(ahead, i);
    ahead.next(k, stride);
    cp_async_commit();
  }
  cp_async_wait<L::AHEAD - 1>();
  __syncthreads();
#pragma unroll
  for (int v = 0; v < N2 / 2; ++v) h[v] = 0.0f;
  int rb = 0;  // this step's raw tile
  for (long long s = 0; s < steps;
       ++s, cur.next(k, stride), rb = rb == L::RING - 1 ? 0 : rb + 1) {
    const long long c0 = cur.c0;
    const int nc = (int)min((long long)kRows, a.centers - c0);
    const bool pass_b = cur.pass;
    const int kk = cur.kk;
    if (kk == 0) {
#pragma unroll
      for (int v = 0; v < N2 / 2; ++v) {
        if (!pass_b) {
          mx[v] = -INFINITY;
          tg[v] = 0.0f;
        }
        dsum[v] = 0.0f;
      }
      dq_rows = (c0 + rq) / a.m * a.n;
    }
    // pass B: the neighbour of this thread's dq row, loaded early
    int jq = 0;
    if (pass_b && rq < nc) jq = __ldg(a.idx + (size_t)(c0 + rq) * k + kk);

    // y1 into the y1 tile
    const __nv_bfloat16* rw = raws + rb * kRows * RAW;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = lane + 32 * i;
      uint4 yv = make_uint4(0, 0, 0, 0);
      if (r < nc) {
        const uint4 hv = *reinterpret_cast<const uint4*>(rw + r * RAW + sc);
        float y[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          y[j] = leaky(bn_z(bf_at(hv, j), sc1[sc + j], bi1[sc + j]), slope);
        yv = pack8(y);
      }
      *reinterpret_cast<uint4*>(ys + wg::cm(r, sc, C1)) = yv;
    }
    wg::fence_to_async();
    __syncthreads();  // the y1 tile is staged; the oldest raw tile is free
    if (s + L::AHEAD < steps)
      load_raw(ahead, rb == 0 ? L::RING - 1 : rb - 1);
    ahead.next(k, stride);
    cp_async_commit();

    chain_h2<C1, C2, C1>(h, ys, w2s, sc2, bi2, g, t);
    if (!pass_b) {
      fold_ties<C2>(h, mx, tg, sc2, bi2, slope, g, t);
      if (kk == k - 1) tie_shares<C2>(tg, a.dout, c0, nc, g, t);
    } else {
      // dh2 into the dh2 tile
#pragma unroll
      for (int n = 0; n < N2 / 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float d[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int v = 4 * n + 2 * i + j;
            const int col = g * N2 + wg::frag_col(t, n, j);
            const float z = bn_z(h[v], sc2[col], bi2[col]);
            const float da = leaky(z, slope) == mx[v] ? tg[v] : 0.0f;
            const float dz = z > 0.0f ? da : __fmul_rn(slope, da);
            d[j] = bn_bwd(dz, xhat(h[v], rs2[col], mrs2[col]), sc2[col],
                          us2[col], us2[C2 + col]);
          }
          *reinterpret_cast<uint32_t*>(
              ds + wg::cm(wg::frag_row(t, i), g * N2 + wg::frag_col(t, n, 0),
                          C2)) = pack2(d[0], d[1]);
        }
      wg::fence_to_async();
      __syncthreads();  // the dh2 tile is staged

      // dy1 = bf16(dh2) . bf16(W2^T), then dh1 in place
      float dy[N1 / 2];
      wg::product<N1, 0, 0, C2 / 16>(dy, wg::k_major(ds, C2, 0, 0),
                                     wg::k_major(w2s, C2, g * N1, 0));
#pragma unroll
      for (int n = 0; n < N1 / 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = wg::frag_row(t, i);
          const int col = g * N1 + wg::frag_col(t, n, 0);
          const uint32_t hh =
              *reinterpret_cast<const uint32_t*>(rw + r * RAW + col);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int v = 4 * n + 2 * i + j;
            const int ch = col + j;
            const float hj = j ? bf_hi(hh) : bf_lo(hh);
            const float z = bn_z(hj, sc1[ch], bi1[ch]);
            const float dz = z > 0.0f ? dy[v] : __fmul_rn(slope, dy[v]);
            dy[v] = bn_bwd(dz, xhat(hj, rs1[ch], mrs1[ch]), sc1[ch], us1[ch],
                           us1[C1 + ch]);
            if (r < nc) dsum[v] += dy[v];
          }
        }
      // dq: lane pairs trade a row's two channels, each keeps 4 of its own
      // row and adds them by one 16-byte reduction
#pragma unroll
      for (int n = 0; n < N1 / 8; ++n) {
        const float a0 = dy[4 * n], a1 = dy[4 * n + 1];      // first row
        const float b0 = dy[4 * n + 2], b1 = dy[4 * n + 3];  // second row
        const float r0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : b0, 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : b1, 1);
        const float4 v4 = odd ? make_float4(r0, r1, b0, b1)
                              : make_float4(a0, a1, r0, r1);
        const int col = g * N1 + 8 * n + 2 * ((t & 3) & ~1);
        if (rq < nc)
          atomicAdd(reinterpret_cast<float4*>(
                        a.dq + (size_t)(dq_rows + jq) * C1 + col),
                    v4);
      }
      if (kk == k - 1) {  // doff = -sum of dh1 over the slots
#pragma unroll
        for (int n = 0; n < N1 / 8; ++n)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = wg::frag_row(t, i);
            if (r >= nc) continue;
            const int v = 4 * n + 2 * i;
            *reinterpret_cast<float2*>(
                a.doff + (size_t)(c0 + r) * C1 + g * N1 +
                wg::frag_col(t, n, 0)) = make_float2(-dsum[v], -dsum[v + 1]);
          }
      }
    }
#pragma unroll
    for (int v = 0; v < N2 / 2; ++v) h[v] = 0.0f;
    cp_async_wait<L::AHEAD - 1>();  // this thread's copies of the next
                                    // step's h1
    __syncthreads();     // ... visible; the y1 and dh2 tiles are free
  }
  cp_async_wait<0>();
}

template <int C1, int C2>
cudaError_t launch_p2(const Edge2P2Args& a, cudaStream_t stream) {
  constexpr size_t smem = E2P2Layout<C1, C2>::bytes;
  auto kernel = edge2_p2_kernel<C1, C2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = resident_blocks(kernel, smem, center_tiles(a.centers), &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace pcl

// h1 [centers, k, c1] bf16, dout [centers, c2] f32, idx [centers, k] i32
// with every entry in [0, n), st [4*c1 + 4*c2] f32, us [2*c2 + 2*c1] f32
// (us2 then us1), w2 [c1, c2] bf16; dq [centers/m, n, c1] f32 zeroed,
// doff [centers, c1] f32; all contiguous and 16-byte aligned. Returns the
// launch's cudaGetLastError() code, or cudaErrorInvalidValue for widths
// not compiled (PCL_EDGE2_WIDTHS) or sizes it does not take.
extern "C" int edge2_bwd_p2_launch(const void* h1, const void* dout,
                                   const void* idx, const void* st,
                                   const void* us, const void* w2, void* dq,
                                   void* doff, long long centers, int m,
                                   int n, int k, int c1, int c2, float slope,
                                   void* stream) {
  if (centers < 1 || m < 1 || n < 1 || k < 1 || centers % m)
    return cudaErrorInvalidValue;
  pcl::Edge2P2Args a;
  a.h1 = static_cast<const __nv_bfloat16*>(h1);
  a.dout = static_cast<const float*>(dout);
  a.idx = static_cast<const int*>(idx);
  a.st = static_cast<const float*>(st);
  a.us = static_cast<const float*>(us);
  a.w2 = static_cast<const __nv_bfloat16*>(w2);
  a.dq = static_cast<float*>(dq);
  a.doff = static_cast<float*>(doff);
  a.centers = centers;
  a.m = m;
  a.n = n;
  a.k = k;
  a.slope = slope;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PCL_LAUNCH(A, B) \
  if (c1 == A && c2 == B) return pcl::launch_p2<A, B>(a, s);
  PCL_EDGE2_WIDTHS(PCL_LAUNCH)
#undef PCL_LAUNCH
  return cudaErrorInvalidValue;
}
