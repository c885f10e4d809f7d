// Train-mode two-layer EdgeConv, the forward tails, for Hopper (sm_90a):
// one kernel templated on its stage.
//
// Replaces the TPU kernels pointcloudlib_tpu/ops/pallas/fused_edge.py
//   stats2: _e2_fwd / _e2_knn_fwd -> _ke2_stats2: [sum h2, sum h2^2]
//   out:    _e2_fwd / _e2_knn_fwd -> _ke2_out:    out = max_k leaky(z2)
// with h2 and z2 of every edge recomputed from the bf16 checkpoint
// h1 [B*M, k, C1] that edge_knn_f1.cu or edge_f1.cu wrote, and the folded
// BN rows of the layers already known.
//
// What bounds it: reading h1 once (168 MB at B=16, N=2048, k=40: 0.050
// ms at 3.35 TB/s). The product, 2*C1*C2 flops an edge (10.7 GFLOP),
// takes 0.011 ms of bf16 on the tensor cores.
//
// A block of kT2Threads threads (two warpgroups) walks tiles of 64
// centers over the resident blocks, kT2Blocks an SM (edge2.cuh's layout:
// a tile's row r is slot kk of center c0 + r, its k slots one step after
// another). A step:
//   - the slot's h1 rows come in by 16-byte cp.async into a ring of
//     kT2Ring raw tiles, two steps ahead at three tiles;
//   - warpgroup g forms h2's columns [32 g, 32 g + 32) of the step's y1
//     tile by wgmma (edge2_wgmma.cuh chain_issue, the product of the
//     backward passes and of edge2_knn_eval: m64n32k16, y1 the K-major A
//     in the core-matrix layout of wgmma_tile.cuh, W2 the MN-major B);
//   - while it runs, the block stages the next slot's y1 =
//     bf16(leaky(BN1(h1))) from its raw tile into the other of two y1
//     tiles, each thread one group of 8 channels (BN1 rows in registers);
//   - stats2 adds h2 and h2^2 into each thread's registers over the whole
//     walk (its fragment's columns are fixed) and reduces once at the
//     end: over the 8 lanes that share a column, over warps in shared
//     memory, then one atomicAdd a block and channel;
//   - out keeps the max over the tile's slots of sgn*h2 in the fragment's
//     fixed rows and channels (sgn = -1 where BN2's scale is below 0:
//     leaky(BN2(.)) is monotone in h2, so its max is at h2's max or min),
//     then writes leaky(BN2(.)) of it to the tile's rows of out after the
//     last slot.
// One barrier a step. Rows at or past the last center are zero y1 rows:
// they add exactly 0 to the sums, and out writes none of them.
//
// Numerics: y1 is bit-identical to the plain version (one rounding per
// operation, in its order). h2 sums in the tensor cores' order, as the
// backward passes' pass A forms it outside their kink band; out agrees
// with the plain version to f32 rounding of the product (the monotone
// fold picks the same slot as a max of leaky(BN2(h2)) would), and the
// sums (f32 atomics in another order) within 1e-3 of their largest
// element.

#include "edge2_wgmma.cuh"

namespace pcl {

constexpr int kT2Threads = 256;  // a block: the warpgroups of one tile
constexpr int kT2Ring = 3;       // raw h1 tiles a block
constexpr int kT2Blocks = 2;     // blocks an SM the kernel is built for

struct Edge2TailArgs {
  const __nv_bfloat16* h1;  // [centers, k, C1]
  const float* st;          // [4, C1] ++ [4, C2] (sc, bi, rs, mrs)
  const __nv_bfloat16* w2;  // [C1, C2]
  float* out;               // stats2: [2, C2] zeroed; out: [centers, C2]
  long long centers;
  int k;
  float slope;
};

// Shared memory, byte offsets: W2 (core-matrix), the folded rows, the
// sums' scratch, the raw h1 tiles (rows padded by 8 elements: a warp's
// 16-byte reads of 8 rows meet no bank twice) and two y1 tiles
// (core-matrix).
template <int C1, int C2>
struct T2Layout {
  static constexpr int RAW = C1 + 8;  // raw row stride, elements
  static constexpr size_t w2 = 0;
  static constexpr size_t st = w2 + (size_t)C1 * C2 * 2;
  static constexpr size_t red = st + (size_t)4 * (C1 + C2) * 4;
  static constexpr size_t raw = (red + (size_t)2 * C2 * 4 + 127) / 128 * 128;
  static constexpr size_t ys = raw + (size_t)kT2Ring * kRows * RAW * 2;
  static constexpr size_t bytes = ys + (size_t)2 * kRows * C1 * 2;
};

// A block's place in its walk: the first center of its tile and the slot.
struct T2Walk {
  long long c0;
  int kk;
  __device__ void next(int k, long long stride) {
    if (++kk < k) return;
    kk = 0;
    c0 += stride;
  }
};

template <int C1, int C2, bool OUT>
__global__ void __launch_bounds__(kT2Threads, kT2Blocks)
    edge2_tail_kernel(const Edge2TailArgs a) {
  using L = T2Layout<C1, C2>;
  constexpr int RAW = L::RAW, NT = kT2Threads;
  constexpr int WGS = NT / wg::kWGThreads;  // warpgroups that share a tile
  constexpr int N2 = C2 / WGS;              // h2's columns a warpgroup
  constexpr int V = N2 / 2;                 // accumulators a thread
  constexpr int TPG = NT / (C1 / 8);       // threads that stage a channel group
  constexpr int RPT = kRows / TPG;          // y1 rows a thread stages a step
  static_assert(C1 % 16 == 0 && NT % wg::kWGThreads == 0 && N2 % 8 == 0,
                "k16 steps; whole warpgroups; 8-column groups");
  static_assert(NT % (C1 / 8) == 0 && TPG % 8 == 0 && kRows % TPG == 0,
                "a channel group a thread, 8 rows a quarter warp");
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem + L::w2);
  float* sts = reinterpret_cast<float*>(smem + L::st);
  float* red = reinterpret_cast<float*>(smem + L::red);
  __nv_bfloat16* raws = reinterpret_cast<__nv_bfloat16*>(smem + L::raw);
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem + L::ys);
  const int tid = threadIdx.x;
  const int g = tid / wg::kWGThreads, t = tid % wg::kWGThreads;
  stage_w<C1, C2>(a.w2, w2s, NT);
  for (int i = tid; i < 4 * (C1 + C2); i += NT) sts[i] = a.st[i];
  for (int i = tid; i < 2 * C2; i += NT) red[i] = 0.0f;
  const int k = a.k;
  const float slope = a.slope;

  // the block's tiles: every gridDim.x-th from its own
  const long long tiles = center_tiles(a.centers);
  const long long steps =
      (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * k;
  const long long stride = (long long)gridDim.x * kRows;
  auto rows = [&](const T2Walk& w) {
    return (int)min((long long)kRows, a.centers - w.c0);
  };
  auto load_raw = [&](const T2Walk& w, int slot) {
    const int nc = rows(w);
    __nv_bfloat16* dst = raws + slot * kRows * RAW;
    for (int e = tid; e < nc * (C1 / 8); e += NT) {
      const int r = e / (C1 / 8), u = e % (C1 / 8);
      cp_async16(dst + r * RAW + u * 8,
                 a.h1 + ((size_t)(w.c0 + r) * k + w.kk) * C1 + u * 8);
    }
  };
  // y1 of a raw tile into a y1 tile: this thread's channels sg .. sg + 7
  // (their BN1 rows in registers) of rows sr + TPG i, so that a quarter
  // warp reads 8 rows of the raw tile and writes one core matrix
  const int sg = tid / TPG * 8, sr = tid % TPG;
  float sc1[8], bi1[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sc1[j] = a.st[sg + j];
    bi1[j] = a.st[C1 + sg + j];
  }
  auto stage_y1 = [&](const T2Walk& w, int slot, __nv_bfloat16* dst) {
    const int nc = rows(w);
    const __nv_bfloat16* src = raws + slot * kRows * RAW + sg;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = sr + TPG * i;
      uint4 yv = make_uint4(0, 0, 0, 0);
      if (r < nc) {
        const uint4 hv = *reinterpret_cast<const uint4*>(src + r * RAW);
        float y[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          y[j] = leaky(bn_z(bf_at(hv, j), sc1[j], bi1[j]), slope);
        yv = pack8(y);
      }
      *reinterpret_cast<uint4*>(dst + wg::cm(r, sg, C1)) = yv;
    }
  };

  // the fragment's columns g N2 + frag_col(t, n, j) at [2 n + j]: their
  // sums of h2 and h2^2 (stats2); for out, the sign of their BN2 scale.
  // z2 = h2*sc2 + bi2 and LeakyReLU, each rounding included, are monotone
  // in h2: rising where sc2 >= 0, falling where sc2 < 0. So the max over
  // a center's slots of leaky(z2) is leaky(z2) of h2's max or min, and
  // out keeps max(sgn h2) (sgn = -1 where sc2 < 0; exact) and applies BN2
  // and LeakyReLU once a tile.
  const float* sc2 = sts + 4 * C1 + g * N2;
  const float* bi2 = sc2 + C2;
  float s1[V / 2], s2[V / 2], sgn[V / 2], h[V], mx[V];
#pragma unroll
  for (int n = 0; n < N2 / 8; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = g * N2 + wg::frag_col(t, n, j);
      s1[2 * n + j] = s2[2 * n + j] = 0.0f;
      sgn[2 * n + j] = OUT && a.st[4 * C1 + col] < 0.0f ? -1.0f : 1.0f;
    }
#pragma unroll
  for (int v = 0; v < V; ++v) mx[v] = -INFINITY;

  T2Walk cur{(long long)blockIdx.x * kRows, 0}, ahead = cur;
#pragma unroll
  for (int i = 0; i < kT2Ring; ++i) {
    if (i < steps) load_raw(ahead, i);
    ahead.next(k, stride);
    cp_async_commit();
  }
  cp_async_wait<kT2Ring - 1>();
  __syncthreads();  // W2, the rows and the first raw tile are in
  stage_y1(cur, 0, ys);
  wg::fence_to_async();
  cp_async_wait<kT2Ring - 2>();
  __syncthreads();  // the first y1 tile is staged; the second raw tile is in
  T2Walk nxt = cur;
  nxt.next(k, stride);
  int rb = 0;  // this step's raw tile
  for (long long s = 0; s < steps; ++s) {
    const int rn = rb == kT2Ring - 1 ? 0 : rb + 1;  // the next step's
#pragma unroll
    for (int v = 0; v < V; ++v) h[v] = 0.0f;
    chain_issue<C1, C2, C1, WGS>(h, ys + (s & 1) * kRows * C1, w2s, g);
    // this step's raw tile is free: the copies of step s + kT2Ring
    if (s + kT2Ring < steps) load_raw(ahead, rb);
    ahead.next(k, stride);
    cp_async_commit();
    if (s + 1 < steps) stage_y1(nxt, rn, ys + ((s + 1) & 1) * kRows * C1);
    wg::fence_to_async();
    wg::wait<0>();
    wg::fence_regs(h);
    if (!OUT) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int nj = 2 * (v >> 2) + (v & 1);
        s1[nj] += h[v];
        s2[nj] = fmaf(h[v], h[v], s2[nj]);
      }
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v)
        mx[v] = fmaxf(mx[v], h[v] * sgn[2 * (v >> 2) + (v & 1)]);
      if (cur.kk == k - 1) {  // the tile's last slot: its rows of out
        const int nc = rows(cur);
#pragma unroll
        for (int n = 0; n < N2 / 8; ++n) {
          const int col = wg::frag_col(t, n, 0);
          float y[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = e & 1;
            y[e] = leaky(bn_z(mx[4 * n + e] * sgn[2 * n + j], sc2[col + j],
                              bi2[col + j]),
                         slope);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = wg::frag_row(t, i);
            if (r < nc)
              *reinterpret_cast<float2*>(
                  a.out + (size_t)(cur.c0 + r) * C2 + g * N2 + col) =
                  make_float2(y[2 * i], y[2 * i + 1]);
          }
        }
#pragma unroll
        for (int v = 0; v < V; ++v) mx[v] = -INFINITY;
      }
    }
    cp_async_wait<kT2Ring - 2>();  // this thread's copies of step s + 2
    __syncthreads();  // ... visible; the next y1 tile staged, this one free
    cur.next(k, stride);
    nxt.next(k, stride);
    rb = rn;
  }
  cp_async_wait<0>();
  if (!OUT) {  // over the 8 lanes of a column, then the block, then out
#pragma unroll
    for (int v = 0; v < V / 2; ++v) {
      s1[v] = wg::rows8_sum(s1[v]);
      s2[v] = wg::rows8_sum(s2[v]);
    }
    if ((t & 31) < 4) {
#pragma unroll
      for (int n = 0; n < N2 / 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = g * N2 + wg::frag_col(t, n, j);
          atomicAdd(red + col, s1[2 * n + j]);
          atomicAdd(red + C2 + col, s2[2 * n + j]);
        }
    }
    __syncthreads();
    for (int i = tid; i < 2 * C2; i += NT) atomicAdd(a.out + i, red[i]);
  }
}

template <int C1, int C2, bool OUT>
cudaError_t launch_tail2(const Edge2TailArgs& a, cudaStream_t stream) {
  using L = T2Layout<C1, C2>;
  auto kernel = edge2_tail_kernel<C1, C2, OUT>;
  int wave = 0;
  const cudaError_t err = wave_blocks(kernel, L::bytes, &wave, kT2Threads);
  if (err != cudaSuccess) return err;
  const int blocks =
      (int)std::min<long long>(wave, center_tiles(a.centers));
  kernel<<<blocks, kT2Threads, L::bytes, stream>>>(a);
  return cudaGetLastError();
}

template <bool OUT>
int tail2(const void* h1, const void* st, const void* w2, void* out,
          long long centers, int k, int c1, int c2, float slope,
          void* stream) {
  if (centers < 1 || k < 1) return cudaErrorInvalidValue;
  Edge2TailArgs a;
  a.h1 = static_cast<const __nv_bfloat16*>(h1);
  a.st = static_cast<const float*>(st);
  a.w2 = static_cast<const __nv_bfloat16*>(w2);
  a.out = static_cast<float*>(out);
  a.centers = centers;
  a.k = k;
  a.slope = slope;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PCL_LAUNCH(A, B) \
  if (c1 == A && c2 == B) return launch_tail2<A, B, OUT>(a, s);
  PCL_EDGE2_WIDTHS(PCL_LAUNCH)
#undef PCL_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace pcl

// h1 [centers, k, c1] bf16, st [4*c1 + 4*c2] f32 (the folded rows of both
// layers; stats2 reads only the first's), w2 [c1, c2] bf16, out [2, c2]
// f32 zeroed; all contiguous and 16-byte aligned. Returns the launch's
// cudaGetLastError() code, or cudaErrorInvalidValue for widths not
// compiled (PCL_EDGE2_WIDTHS) or an empty size.
extern "C" int edge2_stats2_launch(const void* h1, const void* st,
                                   const void* w2, void* out,
                                   long long centers, int k, int c1, int c2,
                                   float slope, void* stream) {
  return pcl::tail2<false>(h1, st, w2, out, centers, k, c1, c2, slope,
                           stream);
}

// As edge2_stats2_launch, with out [centers, c2] f32.
extern "C" int edge2_out_launch(const void* h1, const void* st,
                                const void* w2, void* out, long long centers,
                                int k, int c1, int c2, float slope,
                                void* stream) {
  return pcl::tail2<true>(h1, st, w2, out, centers, k, c1, c2, slope,
                          stream);
}
