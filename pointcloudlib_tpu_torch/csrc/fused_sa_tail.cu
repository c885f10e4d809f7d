// Train-mode fused set abstraction, the forward tails, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels pointcloudlib_tpu/ops/pallas/fused_sa.py
//   stage 2: _call_stats2 -> _k_stats2: [sum h2, sum h2^2]
//   stage 3: _call_stats3 -> _k_stats3: [sum h3, sum h3^2]
//   stage 4: _call_out    -> _k_out:    out = max_k relu(BN3(h3))
// where, from the bf16 checkpoint h1 [B*M*k, C1] and the folded BN rows
// (sc, bi, rs, mrs) of the layers already known:
//   y1 = bf16(relu(h1*sc1 + bi1)), h2 = y1 . bf16 W2 (f32 sums)
//   y2 = bf16(relu(h2*sc2 + bi2)), h3 = y2 . bf16 W3 (f32 sums)
// Every grouped row counts, repeat-first replicas included. Each stage
// recomputes the chain from h1 and writes nothing but its sums or the
// pooled rows.
//
// What bounds them: bytes, the h1 read (268 MB at SSG SA1 with B=64,
// 0.08 ms at 3.35 TB/s); the chain's products are 51.5 GFLOP there,
// 0.05 ms at the bf16 peak, 0.77 ms at the f32 peak of CUDA cores.
//
// Stage 2 (stats2_kernel) runs its one product on CUDA cores
// (fused_sa_common.cuh: resident blocks walk 64-row tiles, W2 staged
// once a block). Stages 3 and 4 (chain_kernel) run both products on the
// tensor cores (wgmma, fused_sa_chain.cuh): each of a block's two
// warpgroups walks its own 64-row tiles, two blocks an SM where their
// shared memory fits, W2 and W3 staged once a block. A tile goes: the
// prefetched h1 -> y1 (core-matrix image) -> h2 = y1 . W2 over all C2
// columns -> y2 stored from the fragment -> h3 = y2 . W3 in column
// chunks (64 at two blocks an SM, 128 at one), each chunk folded and
// dropped before the next (sums and max are separable by column); the
// next tile's h1 is copied in by cp.async meanwhile. The folds read the
// accumulator fragment: stage 3 adds each lane's two rows, then a
// reduce-scatter over the eight lanes that share a column leaves one
// register a lane for two 8-column groups, held across tiles and added
// into shared memory once, then into out once a block and channel
// (atomicAdd: f32 in another order than the plain version). Stage 4
// takes the max by the same reduce-scatter (a lane's eight values: two
// column groups of its two rows, each row's eight lanes one center at
// k = 8, part of one at k >= 16), then each lane's one shared-memory
// atomicMax for its (center, column) on the float's bits: the values are
// relu outputs, >= 0, and non-negative floats order as their bits, so a
// zeroed array is the max's identity and no compare-and-swap loop is
// needed. That folds the rows and warps of one center (k >= 16) and,
// where k is a multiple of 64, the tiles of one center, which one
// warpgroup walks in a row. A unit's pooled rows are written once,
// coalesced.

#include "fused_sa_chain.cuh"

namespace pcl {

struct TailArgs {
  const __nv_bfloat16* h1;  // [rows, C1], rows = B*M*k
  const float* st;          // [4, C1] ++ [4, C2] ++ [4, C3] (sc, bi, rs, mrs)
  const __nv_bfloat16* w2;  // [C1, C2]
  const __nv_bfloat16* w3;  // [C2, C3]
  float* out;               // stage 2/3: [2, C]; stage 4: [rows / k, C3]
  long long rows;
  int k;
};

// ------------------------------------------------ stage 2, CUDA cores

template <int C1, int C2>
struct Stats2Layout {
  static constexpr size_t w2 = 0;
  static constexpr size_t st = w2 + (size_t)C1 * C2 * 2;
  static constexpr size_t y1 = st + (size_t)2 * C1 * 4;
  static constexpr size_t red = y1 + (size_t)kRows * (C1 + 8) * 2;
  static constexpr size_t bytes = red + (size_t)C2 * 4;
};

template <int C1, int C2>
__global__ void __launch_bounds__(kThreads) stats2_kernel(const TailArgs a) {
  using L = Stats2Layout<C1, C2>;
  using T2 = Tile<C2>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem + L::w2);
  float* sts = reinterpret_cast<float*>(smem + L::st);
  __nv_bfloat16* y1s = reinterpret_cast<__nv_bfloat16*>(smem + L::y1);
  float* red = reinterpret_cast<float*>(smem + L::red);

  const int tid = threadIdx.x;
  for (int i = tid; i < C1 * C2 / 8; i += kThreads)
    reinterpret_cast<uint4*>(w2s)[i] = reinterpret_cast<const uint4*>(a.w2)[i];
  for (int i = tid; i < 2 * C1; i += kThreads) sts[i] = a.st[i];
  __syncthreads();
  const float* sc1 = sts;
  const float* bi1 = sc1 + C1;

  const bool act2 = T2::active();
  const int rg2 = tid / T2::NCG, cg2 = tid % T2::NCG;
  const int tpc = tiles_per_center(a.k);
  float s[8], ss[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) s[c] = ss[c] = 0.0f;

  // a unit: one tile of whole centers, or the tiles of one center
  const long long units = a.rows / ((long long)kRows * tpc);
  for (long long u = blockIdx.x; u < units; u += gridDim.x)
    for (int sub = 0; sub < tpc; ++sub) {
      const size_t row0 = ((size_t)u * tpc + sub) * kRows;
      load_y1<C1>(a.h1, row0, sc1, bi1, y1s);
      __syncthreads();
      float acc2[T2::RPT][8];
      if (act2) product<C1, C2>(y1s, w2s, rg2, cg2, acc2);
      if (act2) {
#pragma unroll
        for (int i = 0; i < T2::RPT; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            s[c] += acc2[i][c];
            ss[c] += acc2[i][c] * acc2[i][c];
          }
      }
      __syncthreads();
    }
  flush_sum<C2>(s, cg2, red, a.out, act2);
  flush_sum<C2>(ss, cg2, red, a.out + C2, act2);
}

// ---------------------------------------- stages 3 and 4, tensor cores

// Shared memory: the weights, the BN rows and (stage 3) the block's sums,
// then per warpgroup its y1 and y2 tiles, the h1 tile the next copy lands
// in and (stage 4) the running max of the tile's centers.
template <int C1, int C2, int C3, int STAGE>
struct ChainLayout {
  static constexpr int groups = 2;  // warpgroups a block
  static constexpr size_t w2 = 0;
  static constexpr size_t w3 = w2 + (size_t)C1 * C2 * 2;
  static constexpr size_t st = w3 + (size_t)C2 * C3 * 2;
  static constexpr size_t red = st + (size_t)4 * (C1 + C2 + C3) * 4;
  static constexpr size_t shared = red + (STAGE == 3 ? (size_t)2 * C3 * 4 : 0);
  static constexpr size_t y1 = 0;
  static constexpr size_t y2 = y1 + (size_t)kRows * C1 * 2;
  static constexpr size_t raw = y2 + (size_t)kRows * C2 * 2;
  static constexpr size_t outm = raw + (size_t)kRows * C1 * 2;
  static constexpr size_t group_size =
      outm + (STAGE == 4 ? (size_t)(kRows / 8) * C3 * 4 : 0);
  static constexpr size_t bytes = shared + groups * group_size;
  // two blocks an SM where their shared memory fits
  static constexpr int min_blocks = 2 * bytes <= 227 * 1024 ? 2 : 1;
  // layer-3 column chunk: 64 where two blocks share an SM's registers
  static constexpr int chunk = min_blocks == 2 || C3 < 128 ? 64 : 128;
};

template <int C1, int C2, int C3, int STAGE>
__global__ void __launch_bounds__(
    ChainLayout<C1, C2, C3, STAGE>::groups * wg::kWGThreads,
    ChainLayout<C1, C2, C3, STAGE>::min_blocks)
    chain_kernel(const TailArgs a) {
  using L = ChainLayout<C1, C2, C3, STAGE>;
  constexpr int NT = L::groups * wg::kWGThreads;
  constexpr int WT = wg::kWGThreads;
  constexpr int L3 = L::chunk;
  static_assert(C3 % L3 == 0 && L3 % 16 == 0, "layer-3 chunks");
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem + L::w2);
  __nv_bfloat16* w3s = reinterpret_cast<__nv_bfloat16*>(smem + L::w3);
  float* sts = reinterpret_cast<float*>(smem + L::st);
  float* red = reinterpret_cast<float*>(smem + L::red);  // stage 3

  const int tid = threadIdx.x;
  const int g = tid / WT, t = tid % WT;  // warpgroup, thread in it
  unsigned char* mine = smem + L::shared + g * L::group_size;
  __nv_bfloat16* y1s = reinterpret_cast<__nv_bfloat16*>(mine + L::y1);
  __nv_bfloat16* y2s = reinterpret_cast<__nv_bfloat16*>(mine + L::y2);
  __nv_bfloat16* raw = reinterpret_cast<__nv_bfloat16*>(mine + L::raw);
  float* outm = reinterpret_cast<float*>(mine + L::outm);  // stage 4

  stage_w<C1, C2>(a.w2, w2s, NT);
  stage_w<C2, C3>(a.w3, w3s, NT);
  for (int i = tid; i < 4 * (C1 + C2 + C3); i += NT) sts[i] = a.st[i];
  if (STAGE == 3)
    for (int i = tid; i < 2 * C3; i += NT) red[i] = 0.0f;
  if (STAGE == 4)
    for (int i = t; i < (kRows / 8) * C3; i += WT) outm[i] = 0.0f;
  wg::fence_to_async();
  __syncthreads();
  const float* sc1 = sts;
  const float* bi1 = sc1 + C1;
  const float* sc2 = sts + 4 * C1;
  const float* bi2 = sc2 + C2;
  const float* sc3 = sts + 4 * (C1 + C2);
  const float* bi3 = sc3 + C3;

  const int lane = t & 31, q = t & 3;
  const int slot = wg::rows8_slot(lane);
  const int r0 = wg::frag_row(t, 0), r1 = wg::frag_row(t, 1);
  const int k = a.k;
  const int cpt = centers_per_tile(k);
  const int tpc = tiles_per_center(k);
  const int cl0 = r0 / k, cl1 = r1 / k;  // centers in the tile
  const wg::Opnd a3 = wg::k_major(y2s, C2, 0, 0);

  // stage 3: this lane's share of [sum h3, sum h3^2], groups (2i, 2i + 1)
  // of the columns in s[i]
  float s[C3 / 16];
#pragma unroll
  for (int i = 0; i < C3 / 16; ++i) s[i] = 0.0f;

  // the warpgroup's units (a tile of whole centers, or the tpc tiles of
  // one center): first, first + stride, ...; step it is tile(it)
  const long long units = a.rows / ((long long)kRows * tpc);
  const long long first = (long long)blockIdx.x * L::groups + g;
  const long long stride = (long long)gridDim.x * L::groups;
  const long long iters =
      first < units ? (units - first + stride - 1) / stride * tpc : 0;
  auto tile = [&](long long it) {
    return (size_t)((first + it / tpc * stride) * tpc + it % tpc);
  };

  if (iters > 0) prefetch_h1<C1, WT>(a.h1, tile(0) * kRows, raw, t);
  cp_async_commit();
  for (long long it = 0; it < iters; ++it) {
    const size_t row0 = tile(it) * kRows;
    cp_async_wait<0>();
    bar_sync<WT>(1 + g);
    stage_h1<C1, WT>(raw, sc1, bi1, y1s, nullptr, t);
    wg::fence_to_async();
    bar_sync<WT>(1 + g);
    if (it + 1 < iters)
      prefetch_h1<C1, WT>(a.h1, tile(it + 1) * kRows, raw, t);
    cp_async_commit();

    layer2_y2<C1, C2>(y1s, w2s, sc2, bi2, y2s, t);
    wg::fence_to_async();
    bar_sync<WT>(1 + g);

    // layer 3 by column chunks, each folded into the sums or the max
#pragma unroll
    for (int cc = 0; cc < C3; cc += L3) {
      float h3[L3 / 2];
      wg::product<L3, 0, 1, C2 / 16>(h3, a3, wg::mn_major(w3s, C3, 0, cc));
      if (STAGE == 3) {
        float pv[8];
#pragma unroll
        for (int n = 0; n < L3 / 8; ++n) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float v0 = h3[4 * n + j], v1 = h3[4 * n + 2 + j];
            pv[4 * (n & 1) + j] = v0 + v1;
            pv[4 * (n & 1) + 2 + j] = v0 * v0 + v1 * v1;
          }
          if (n & 1) s[cc / 16 + n / 2] += wg::rows8_scatter(pv, lane);
        }
      } else {
        float pv[8];
#pragma unroll
        for (int n = 0; n < L3 / 8; ++n) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = cc + wg::frag_col(t, n, j);
            pv[4 * (n & 1) + j] = bn_relu(h3[4 * n + j], sc3[c], bi3[c]);
            pv[4 * (n & 1) + 2 + j] =
                bn_relu(h3[4 * n + 2 + j], sc3[c], bi3[c]);
          }
          if (n & 1) {
            // slot: group n - 1 + (slot >> 2), row (slot >> 1) & 1,
            // column j = slot & 1
            const float m = wg::rows8_scatter<true>(pv, lane);
            const int c =
                cc + 8 * (n - 1 + (slot >> 2)) + 2 * q + (slot & 1);
            const int cl = (slot >> 1) & 1 ? cl1 : cl0;
            atomicMax(reinterpret_cast<int*>(outm + cl * C3 + c),
                      __float_as_int(m));
          }
        }
      }
    }
    if (STAGE == 4 && it % tpc == tpc - 1) {  // the unit's centers are done
      bar_sync<WT>(1 + g);
      float4* og = reinterpret_cast<float4*>(a.out + (row0 / k) * C3);
      float4* om = reinterpret_cast<float4*>(outm);
      for (int i = t; i < cpt * C3 / 4; i += WT) {
        og[i] = om[i];
        om[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
  }
  cp_async_wait<0>();
  if (STAGE == 3) {
#pragma unroll
    for (int i = 0; i < C3 / 16; ++i)
      atomicAdd(red + ((slot >> 1) & 1) * C3 + 8 * (2 * i + (slot >> 2)) +
                    2 * q + (slot & 1),
                s[i]);
    __syncthreads();
    for (int i = tid; i < 2 * C3; i += NT) atomicAdd(a.out + i, red[i]);
  }
}

template <typename K>
cudaError_t launch(K kernel, size_t smem, long long work, int threads,
                   const TailArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = resident_blocks(kernel, smem, work, &blocks, threads);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int C1, int C2, int C3>
cudaError_t launch_stage(int stage, const TailArgs& a, cudaStream_t s) {
  static_assert(Stats2Layout<C1, C2>::bytes <= 227 * 1024 &&
                    ChainLayout<C1, C2, C3, 3>::bytes <= 227 * 1024 &&
                    ChainLayout<C1, C2, C3, 4>::bytes <= 227 * 1024,
                "shared memory of one block");
  const long long units = a.rows / ((long long)kRows * tiles_per_center(a.k));
  if (stage == 2)
    return launch(stats2_kernel<C1, C2>, Stats2Layout<C1, C2>::bytes, units,
                  kThreads, a, s);
  constexpr int groups = ChainLayout<C1, C2, C3, 3>::groups;
  const long long work = (units + groups - 1) / groups;
  if (stage == 3)
    return launch(chain_kernel<C1, C2, C3, 3>,
                  ChainLayout<C1, C2, C3, 3>::bytes, work,
                  groups * wg::kWGThreads, a, s);
  if (stage == 4)
    return launch(chain_kernel<C1, C2, C3, 4>,
                  ChainLayout<C1, C2, C3, 4>::bytes, work,
                  groups * wg::kWGThreads, a, s);
  return cudaErrorInvalidValue;
}

}  // namespace pcl

// Widths compiled: (32, 32, 64), (64, 64, 128), (64, 96, 128) and
// (128, 128, 256). k is 8, 16, 32 or a multiple of 64, and rows = B*M*k a
// multiple of 64. out is zeroed by the caller for stages 2 and 3.
// Returns cudaGetLastError() of the launch.
extern "C" int sa_tail_launch(int stage, const void* h1, const void* st,
                              const void* w2, const void* w3, void* out,
                              long long rows, int k, int c1, int c2, int c3,
                              void* stream) {
  if (rows < 1 || !pcl::k_ok(k) || rows % pcl::kRows || rows % k)
    return cudaErrorInvalidValue;
  pcl::TailArgs a;
  a.h1 = static_cast<const __nv_bfloat16*>(h1);
  a.st = static_cast<const float*>(st);
  a.w2 = static_cast<const __nv_bfloat16*>(w2);
  a.w3 = static_cast<const __nv_bfloat16*>(w3);
  a.out = static_cast<float*>(out);
  a.rows = rows;
  a.k = k;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PCL_LAUNCH(A, B, C)          \
  if (c1 == A && c2 == B && c3 == C) \
    return pcl::launch_stage<A, B, C>(stage, a, s);
  PCL_TRAIN_WIDTHS(PCL_LAUNCH)
#undef PCL_LAUNCH
  return cudaErrorInvalidValue;
}
