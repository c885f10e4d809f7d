// Train-mode two-layer EdgeConv, backward pass 1, for Hopper (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/fused_edge.py
// (_e2_bwd_rule -> _ke2_p1). From the bf16 checkpoint h1 [B*M, k, C1],
// the output gradient dout [B*M, C2], W2 and the folded BN rows of both
// layers, per edge:
//   z1 = h1*sc1 + bi1, y1 = leaky(z1), m1 = (z1 > 0 ? 1 : slope),
//   x1 = h1*rs1 - mrs1; h2 = bf16(y1) . bf16(W2), z2 = h2*sc2 + bi2,
//   x2 = h2*rs2 - mrs2;
//   dz2 = dout / ties where leaky(z2) reaches the max of the center's k
//         slots (the even tie split of jnp.max's gradient), else 0, times
//         slope where z2 <= 0;
//   left = [y1 | m1 | m1*x1] (3*C1), right = [dz2 | x2] (2*C2)
// and over all edges:
//   ps2 = [sum dz2, sum dz2*x2] (2, C2), vecs = sum left (3*C1),
//   mats = bf16(left)^T . bf16(right) (3*C1, 2*C2), f32 sums.
// _combine_p1 (ops/kernels/fused_sa_train.py) turns them into dW2 and the
// BN1 sums. C1 = C2 = 64 (PCL_EDGE2_WIDTHS).
//
// What bounds it: operations, all of them products on the tensor cores:
// mats is 2*3*C1*2*C2 flops an edge and the chain, run twice (below),
// 2*2*C1*C2: 85 GFLOP of bf16 at B=16, N=2048, k=40, 0.086 ms at 989
// TFLOP/s; reading h1 twice is 0.34 GB, 0.10 ms at 3.35 TB/s.
//
// One kernel, one block of two warpgroups an SM, the blocks walking tiles
// of 64 centers (edge2.cuh's layout: a tile's row r is slot kk of center
// c0 + r, its k slots one tile after another). Each tile is walked twice:
// pass A folds each center's max of leaky(z2) and its tie count, pass B
// does the rest. A step (one slot of one pass):
//   - the slot's h1 rows come in by cp.async two steps ahead (a ring of
//     two 64-row tiles, rows padded so a warp's 16-byte reads of eight
//     rows hit distinct banks);
//   - one warp a group of 8 channels stages y1 (and in pass B m1 and
//     m1*x1, with their f32 sums for vecs) as bf16 into the left tile
//     [64, 192], in the core-matrix layout of wgmma_tile.cuh;
//   - warpgroup g forms h2's columns [32 g, 32 g + 32) by wgmma
//     (m64n32k16, y1 the K-major A, W2 the MN-major B);
//   - from the accumulator fragment, pass A folds (max, ties) in
//     registers; pass B forms dz2 and x2, adds ps2 in registers, and
//     stores [dz2 | x2] as bf16 into the right tile [64, 128];
//   - pass B: warpgroup g adds right[:, 64 g : 64 g + 64]^T . left into
//     its slab of mats^T (64 x 192 f32, 96 registers a thread; wgmma
//     m64n192k16, both operands MN-major), issued and left in flight
//     while the next step stages: left and right are double-buffered.
// Both chains of a row are the same instructions on the same bf16
// operands, so pass B's h2 is pass A's bit for bit, and a row's h2 does
// not depend on where it sits in the tile: equal h1 rows give equal h2,
// which the max-pool's even tie split depends on. Where z2 lies within
// 2^-13 of 0, the leaky mask's kink, h2 is taken again as the plain
// product sums it (f32 FMAs in the order of k, as layer2_z of
// fused_sa_eval.cuh does near a bf16 rounding boundary): there a
// last-bit difference of the sum turns dz2's factor between 1 and
// slope, and a card test met one such z2 (0 in the plain product,
// 2e-8 in exact arithmetic) whose center moved ps2 by 0.8 |dout|. mats, ps2 and vecs
// stay in registers for the whole walk and are added into the zeroed
// outputs once a block, mats by one atomicAdd an element. No scratch:
// left and right (640 bytes an edge) never leave shared memory.
//
// Registers a thread: mats 96, h2's accumulator 16, the folds (max and
// tie count, then the share) 32, ps2 16, vecs 24.
// All sums are f32 in another order than the plain version.

#include "edge2.cuh"
#include "fused_sa_chain.cuh"

namespace pcl {

struct Edge2P1Args {
  const __nv_bfloat16* h1;  // [centers, k, C1]
  const float* dout;        // [centers, C2]
  const float* st;          // [4, C1] ++ [4, C2]
  const __nv_bfloat16* w2;  // [C1, C2]
  float* ps2;               // [2, C2]
  float* vecs;              // [3 * C1]
  float* mats;              // [3 * C1, 2 * C2]
  long long centers;
  int k;
  float slope;
};

// Shared memory, byte offsets: W2 (core-matrix), the folded rows, the
// block's sums, two raw h1 tiles, two left and two right tiles.
template <int C1, int C2>
struct E2P1Layout {
  static constexpr int WL = 3 * C1, WR = 2 * C2;
  static constexpr int RAW = C1 + 8;  // raw row stride, elements
  static constexpr size_t w2 = 0;
  static constexpr size_t st = w2 + (size_t)C1 * C2 * 2;
  static constexpr size_t red = st + (size_t)4 * (C1 + C2) * 4;
  static constexpr size_t raw =
      (red + (size_t)(2 * C2 + 3 * C1) * 4 + 127) / 128 * 128;
  static constexpr size_t left = raw + (size_t)2 * kRows * RAW * 2;
  static constexpr size_t right = left + (size_t)2 * kRows * WL * 2;
  static constexpr size_t bytes = right + (size_t)2 * kRows * WR * 2;
};

// Half-width of the band around z2 = 0 where the leaky mask's decision
// is taken again from the plain product's sum: two f32 sums of the 64
// products of a row differ by ~1e-5 at these widths (64 u sum|y1 w2|),
// far inside it.
constexpr float kKinkBand = 0x1p-13f;

// h2[r, c] = y1[r, :] . W2[:, c] as the plain product sums it: f32 FMAs
// in the order of k, from 0 (y1: the first C1 columns of the left tile,
// width WL; w2s: core-matrix [C1, C2]).
template <int C1, int C2, int WL>
__device__ __forceinline__ float seq_h2(const __nv_bfloat16* lt,
                                        const __nv_bfloat16* w2s, int r,
                                        int c) {
  const __nv_bfloat16* wc = w2s + wg::cm(0, c, C2);
  float acc = 0.0f;
#pragma unroll
  for (int k0 = 0; k0 < C1; k0 += 8) {
    const uint4 y = *reinterpret_cast<const uint4*>(lt + wg::cm(r, k0, WL));
#pragma unroll
    for (int i = 0; i < 8; ++i)
      acc = fmaf(bf_at(y, i), __bfloat162float(wc[wg::cm(k0 + i, 0, C2)]),
                 acc);
  }
  return acc;
}

// A block's place in its walk: the first center of its tile, the pass
// and the slot, advanced by increments (no divisions a step).
struct E2Walk {
  long long c0;
  int pass, kk;
  __device__ void next(int k, long long stride) {
    if (++kk < k) return;
    kk = 0;
    if (++pass < 2) return;
    pass = 0;
    c0 += stride;
  }
};

template <int C1, int C2>
__global__ void __launch_bounds__(kThreads, 1)
    edge2_p1_kernel(const Edge2P1Args a) {
  using L = E2P1Layout<C1, C2>;
  constexpr int WL = L::WL, WR = L::WR, RAW = L::RAW;
  constexpr int N2 = C2 / 2;  // chain columns a warpgroup
  static_assert(C1 == 8 * kWarps && WR == 2 * 64 && WL == 192,
                "a warp a channel group of h1; a warpgroup a 64-row slab "
                "of mats^T");
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem + L::w2);
  float* sts = reinterpret_cast<float*>(smem + L::st);
  float* red = reinterpret_cast<float*>(smem + L::red);  // ps2 ++ vecs
  __nv_bfloat16* raws = reinterpret_cast<__nv_bfloat16*>(smem + L::raw);
  __nv_bfloat16* lefts = reinterpret_cast<__nv_bfloat16*>(smem + L::left);
  __nv_bfloat16* rights = reinterpret_cast<__nv_bfloat16*>(smem + L::right);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = tid / wg::kWGThreads, t = tid % wg::kWGThreads;
  stage_w<C1, C2>(a.w2, w2s, kThreads);
  for (int i = tid; i < 4 * (C1 + C2); i += kThreads) sts[i] = a.st[i];
  for (int i = tid; i < 2 * C2 + 3 * C1; i += kThreads) red[i] = 0.0f;
  const float* sc1 = sts;
  const float* bi1 = sc1 + C1;
  const float* rs1 = bi1 + C1;
  const float* mrs1 = rs1 + C1;
  const float* sc2 = sts + 4 * C1;
  const float* bi2 = sc2 + C2;
  const float* rs2 = bi2 + C2;
  const float* mrs2 = rs2 + C2;
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

  float macc[WL / 2];  // mats^T rows [64 g, 64 g + 64), all 192 columns
#pragma unroll
  for (int i = 0; i < WL / 2; ++i) macc[i] = 0.0f;
  float mx[N2 / 2], tg[N2 / 2];  // the folds; tg: ties, then the share
  float sd[N2 / 4] = {}, sdx[N2 / 4] = {};  // ps2 of columns (n, j)
  float vl[3][8] = {};  // vecs of this warp's 8 channels
  const int sc = warp * 8;  // this thread's channels of h1 when staging

  E2Walk cur{(long long)blockIdx.x * kRows, 0, 0}, ahead = cur;
  if (steps > 0) load_raw(ahead, 0);
  ahead.next(k, stride);
  cp_async_commit();
  if (steps > 1) load_raw(ahead, 1);
  ahead.next(k, stride);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  float h[N2 / 2];  // h2's accumulator, zeroed before any mats product
#pragma unroll
  for (int v = 0; v < N2 / 2; ++v) h[v] = 0.0f;
  for (long long s = 0; s < steps; ++s, cur.next(k, stride)) {
    const long long c0 = cur.c0;
    const int nc = (int)min((long long)kRows, a.centers - c0);
    const bool pass_b = cur.pass;
    const int kk = cur.kk;
    const int buf = (int)(s & 1);
    __nv_bfloat16* lt = lefts + buf * kRows * WL;
    __nv_bfloat16* rt = rights + buf * kRows * WR;
    if (!pass_b && kk == 0) {
#pragma unroll
      for (int v = 0; v < N2 / 2; ++v) {
        mx[v] = -INFINITY;
        tg[v] = 0.0f;
      }
    }

    // y1 (pass B: m1, m1*x1 and their sums) into the left tile
    const __nv_bfloat16* rw = raws + buf * kRows * RAW;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = lane + 32 * i;
      uint4 yv = make_uint4(0, 0, 0, 0), mv = yv, xv = yv;
      if (r < nc) {
        const uint4 hv = *reinterpret_cast<const uint4*>(rw + r * RAW + sc);
        float y[8], m[8], x[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float hj = bf_at(hv, j);
          const float z = bn_z(hj, sc1[sc + j], bi1[sc + j]);
          y[j] = leaky(z, slope);
          if (pass_b) {
            m[j] = z > 0.0f ? 1.0f : slope;
            x[j] = __fmul_rn(m[j], xhat(hj, rs1[sc + j], mrs1[sc + j]));
            vl[0][j] += y[j];
            vl[1][j] += m[j];
            vl[2][j] += x[j];
          }
        }
        yv = pack8(y);
        if (pass_b) {
          mv = pack8(m);
          xv = pack8(x);
        }
      }
      *reinterpret_cast<uint4*>(lt + wg::cm(r, sc, WL)) = yv;
      if (pass_b) {
        *reinterpret_cast<uint4*>(lt + wg::cm(r, C1 + sc, WL)) = mv;
        *reinterpret_cast<uint4*>(lt + wg::cm(r, 2 * C1 + sc, WL)) = xv;
      }
    }
    wg::fence_to_async();
    __syncthreads();  // the left tile is staged; this raw tile is free
    if (s + 2 < steps) load_raw(ahead, buf);
    ahead.next(k, stride);
    cp_async_commit();

    // h2[:, 32 g + ...] = y1 . W2 (also waits for the last step's mats)
    wg::fence_regs(h);
    wg::fence_regs(macc);
    wg::begin();
    wg::issue<N2, 0, 1, C1 / 16>(h, wg::k_major(lt, WL, 0, 0),
                                 wg::mn_major(w2s, C2, 0, g * N2));
    wg::commit_wait();
    wg::fence_regs(h);
    wg::fence_regs(macc);
    // a z2 near 0 (the leaky mask's kink) from the plain product's sum,
    // in both passes alike
    unsigned kink = 0;
#pragma unroll
    for (int v = 0; v < N2 / 2; ++v) {
      const int col = g * N2 + wg::frag_col(t, v >> 2, v & 1);
      if (fabsf(bn_z(h[v], sc2[col], bi2[col])) < kKinkBand) kink |= 1u << v;
    }
    while (kink) {
      const int v = __ffs(kink) - 1;
      kink &= kink - 1;
      const float hv = seq_h2<C1, C2, WL>(lt, w2s, wg::frag_row(t, (v >> 1) & 1),
                                          g * N2 + wg::frag_col(t, v >> 2, v & 1));
#pragma unroll
      for (int i = 0; i < N2 / 2; ++i)
        if (i == v) h[i] = hv;
    }

#pragma unroll
    for (int n = 0; n < N2 / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wg::frag_row(t, i);
        float dz[2], x2[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int v = 4 * n + 2 * i + j;
          const int col = g * N2 + wg::frag_col(t, n, j);
          const float z = bn_z(h[v], sc2[col], bi2[col]);
          const float y = leaky(z, slope);
          if (!pass_b) {
            if (y > mx[v]) {
              mx[v] = y;
              tg[v] = 1.0f;
            } else if (y == mx[v]) {
              tg[v] += 1.0f;
            }
          } else {
            const float da = y == mx[v] ? tg[v] : 0.0f;
            dz[j] = z > 0.0f ? da : __fmul_rn(slope, da);
            x2[j] = xhat(h[v], rs2[col], mrs2[col]);
            if (r < nc) {
              sd[2 * n + j] += dz[j];
              sdx[2 * n + j] += dz[j] * x2[j];
            }
          }
        }
        if (pass_b) {
          const int col = g * N2 + wg::frag_col(t, n, 0);
          *reinterpret_cast<uint32_t*>(rt + wg::cm(r, col, WR)) =
              pack2(dz[0], dz[1]);
          *reinterpret_cast<uint32_t*>(rt + wg::cm(r, C2 + col, WR)) =
              pack2(x2[0], x2[1]);
        }
      }
    if (!pass_b && kk == k - 1) {  // tie counts -> shares dout / ties
#pragma unroll
      for (int n = 0; n < N2 / 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int v = 4 * n + 2 * i + j;
            const int r = wg::frag_row(t, i);
            const int col = g * N2 + wg::frag_col(t, n, j);
            tg[v] = r < nc ? __fdiv_rn(a.dout[(size_t)(c0 + r) * C2 + col],
                                       tg[v])
                           : 0.0f;
          }
    }
#pragma unroll
    for (int v = 0; v < N2 / 2; ++v) h[v] = 0.0f;
    if (pass_b) wg::fence_to_async();
    cp_async_wait<1>();  // this thread's copies of the next step's h1
    __syncthreads();     // ... visible; the right tile is stored
    if (pass_b) {
      wg::fence_regs(macc);
      wg::begin();
      wg::issue<WL, 1, 1, kRows / 16>(macc, wg::mn_major(rt, WR, 0, 64 * g),
                                      wg::mn_major(lt, WL, 0, 0));
      wg::commit();
    }
  }
  wg::wait<0>();
  wg::fence_regs(macc);
  cp_async_wait<0>();

  // mats [WL, WR] row-major holds mats^T[m][n] at n * WR + m
#pragma unroll
  for (int n = 0; n < WL / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        atomicAdd(a.mats + (size_t)wg::frag_col(t, n, j) * WR + 64 * g +
                      wg::frag_row(t, i),
                  macc[4 * n + 2 * i + j]);
  // ps2: over the 16 rows of a warp by lanes, then the block in shared
  // memory; vecs: over the 64 rows of a warp's channels by lanes
#pragma unroll
  for (int n = 0; n < N2 / 8; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float s0 = wg::rows8_sum(sd[2 * n + j]);
      const float s1 = wg::rows8_sum(sdx[2 * n + j]);
      if (lane < 4) {
        const int col = g * N2 + wg::frag_col(t, n, j);
        atomicAdd(red + col, s0);
        atomicAdd(red + C2 + col, s1);
      }
    }
#pragma unroll
  for (int part = 0; part < 3; ++part)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = vl[part][j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[2 * C2 + part * C1 + sc + j] = v;
    }
  __syncthreads();
  for (int i = tid; i < 2 * C2; i += kThreads) atomicAdd(a.ps2 + i, red[i]);
  for (int i = tid; i < 3 * C1; i += kThreads)
    atomicAdd(a.vecs + i, red[2 * C2 + i]);
}

template <int C1, int C2>
cudaError_t launch_p1(const Edge2P1Args& a, cudaStream_t stream) {
  constexpr size_t smem = E2P1Layout<C1, C2>::bytes;
  auto kernel = edge2_p1_kernel<C1, C2>;
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

// h1 [centers, k, c1] bf16, dout [centers, c2] f32, st [4*c1 + 4*c2] f32,
// w2 [c1, c2] bf16; ps2 [2, c2], vecs [3*c1] and mats [3*c1, 2*c2] f32
// zeroed; all contiguous and 16-byte aligned. Returns cudaGetLastError()
// of the launch, or cudaErrorInvalidValue for widths not compiled
// (PCL_EDGE2_WIDTHS) or an empty size.
extern "C" int edge2_bwd_p1_launch(const void* h1, const void* dout,
                                   const void* st, const void* w2, void* ps2,
                                   void* vecs, void* mats, long long centers,
                                   int k, int c1, int c2, float slope,
                                   void* stream) {
  if (centers < 1 || k < 1) return cudaErrorInvalidValue;
  pcl::Edge2P1Args a;
  a.h1 = static_cast<const __nv_bfloat16*>(h1);
  a.dout = static_cast<const float*>(dout);
  a.st = static_cast<const float*>(st);
  a.w2 = static_cast<const __nv_bfloat16*>(w2);
  a.ps2 = static_cast<float*>(ps2);
  a.vecs = static_cast<float*>(vecs);
  a.mats = static_cast<float*>(mats);
  a.centers = centers;
  a.k = k;
  a.slope = slope;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PCL_LAUNCH(A, B) \
  if (c1 == A && c2 == B) return pcl::launch_p1<A, B>(a, s);
  PCL_EDGE2_WIDTHS(PCL_LAUNCH)
#undef PCL_LAUNCH
  return cudaErrorInvalidValue;
}
