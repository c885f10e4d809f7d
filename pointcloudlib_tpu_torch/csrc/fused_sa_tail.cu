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
// 0.05 ms at the bf16 peak, 0.77 ms at the f32 peak of CUDA cores. All
// three stages run their products on the tensor cores (wgmma,
// wgmma_tile.cuh), each warpgroup of a resident block walking its own
// 64-row tiles, the weights staged once a block.
//
// Stage 2 (sums2_kernel) is one product and a sum, so it is bound by the
// h1 read: each warpgroup keeps a ring of h1 tiles in flight, copied by
// cp.async in h1's own row order (whole 128-byte lines a warp; copies in
// the core-matrix order, eight half lines a warp, read h1 at 1.9 of the
// card's 3.35 TB/s) into a row-swizzled tile (raw_unit: the copies and
// the reads down a core matrix meet no bank conflict), converts it into
// y1's core-matrix image, runs h2 = y1 . W2 over all C2 columns and adds
// h2 and h2^2 into registers held across tiles (a lane's columns of its
// two rows); at the end one reduce-scatter over a column's eight lanes,
// shared memory, then out once a block and channel.
//
// Stages 3 and 4 (chain_kernel, fused_sa_chain.cuh): each of a block's
// two warpgroups walks its own units, two blocks an SM where their
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
// (atomicAdd, here and in stage 2: f32 in another order than the plain
// version). Stage 4
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
  const float* st;          // [4, C1] ++ [4, C2] ++ [4, C3] (sc, bi, rs, mrs);
                            // stage 2 reads [4, C1] only
  const __nv_bfloat16* w2;  // [C1, C2]
  const __nv_bfloat16* w3;  // [C2, C3]
  float* out;               // stage 2/3: [2, C]; stage 4: [rows / k, C3]
  long long rows;
  int k;
};

// ----------------------------------------------- stage 2, tensor cores

// Shared memory of stage 2: W2 and the block's sums, then per warpgroup a
// ring of `depth` h1 tiles (row order, swizzled: raw_unit) and y1's
// core-matrix image. By measurement (PERF.md): three tiles in flight, and
// as many warpgroups an SM as the registers allow (the sums of a lane's
// C2 / 4 columns live in registers), two a block where that count is
// even.
template <int C1, int C2>
struct Sums2Layout {
  static constexpr int per_sm =
      C2 <= 32 ? 6 : C2 <= 64 ? 4 : C2 <= 96 ? 3 : 2;
  static constexpr int groups = per_sm % 2 == 0 ? 2 : 1;
  static constexpr int min_blocks = per_sm / groups;
  static constexpr int depth = 3;
  static constexpr size_t w2 = 0;
  static constexpr size_t red = w2 + (size_t)C1 * C2 * 2;
  static constexpr size_t ring = red + (size_t)2 * C2 * 4;
  static constexpr size_t tile = (size_t)kRows * C1;  // elements
  static constexpr size_t bytes =
      ring + (size_t)groups * (depth + 1) * tile * 2;
};

// 16-byte unit of (row r, 8-channel chunk c) in an h1 tile kept in row
// order with each row's chunks XOR-swizzled by its row: the copies of a
// row (consecutive units of h1) and the reads of one chunk down eight
// rows (one core matrix of y1) both meet eight distinct bank groups.
template <int C1>
__device__ __forceinline__ int raw_unit(int r, int c) {
  constexpr int W = C1 / 8;         // chunks a row
  constexpr int S = W < 8 ? W : 8;  // chunks the swizzle permutes
  return r * W + (c ^ ((r / (8 / S)) & (S - 1)));
}

template <int C1, int C2>
__global__ void __launch_bounds__(Sums2Layout<C1, C2>::groups *
                                      wg::kWGThreads,
                                  Sums2Layout<C1, C2>::min_blocks)
    sums2_kernel(const TailArgs a) {
  using L = Sums2Layout<C1, C2>;
  constexpr int GROUPS = L::groups, DEPTH = L::depth;
  constexpr int NT = GROUPS * wg::kWGThreads;
  constexpr int WT = wg::kWGThreads;
  constexpr int CPT = kRows * C1 / 8 / WT;  // 16-byte units a thread a tile
  static_assert(128 % C1 == 0 && CPT >= 1, "fixed channels per thread");
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem + L::w2);
  float* red = reinterpret_cast<float*>(smem + L::red);

  const int tid = threadIdx.x;
  const int g = tid / WT, t = tid % WT;  // warpgroup, thread in it
  const int lane = t & 31, q = t & 3;
  uint4* ring = reinterpret_cast<uint4*>(smem + L::ring) +
                g * (DEPTH + 1) * L::tile / 8;
  __nv_bfloat16* y1s =
      reinterpret_cast<__nv_bfloat16*>(ring + DEPTH * L::tile / 8);

  stage_w<C1, C2>(a.w2, w2s, NT);
  for (int i = tid; i < 2 * C2; i += NT) red[i] = 0.0f;
  // the thread stages y1's units e = t + 128 i (core-matrix order: row
  // e / C1 * 8 + e % 8, chunk (e % C1) / 8), the same chunk in each where
  // C1 divides 128
  const int c0 = (t % C1) / 8;
  float sc1[8], bi1[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    sc1[i] = a.st[8 * c0 + i];
    bi1[i] = a.st[C1 + 8 * c0 + i];
  }
  wg::fence_to_async();
  __syncthreads();

  // the warpgroup's tiles: first, first + stride, ...
  const long long tiles = a.rows / kRows;
  const long long first = (long long)blockIdx.x * GROUPS + g;
  const long long stride = (long long)gridDim.x * GROUPS;
  const long long iters =
      first < tiles ? (tiles - first + stride - 1) / stride : 0;
  // copies tile it (if any), in row order, into ring slot r; one commit
  // group a tile
  auto fetch = [&](long long it, int r) {
    if (it < iters) {
      const uint4* src = reinterpret_cast<const uint4*>(
          a.h1 + (first + it * stride) * kRows * C1);
      uint4* dst = ring + r * L::tile / 8;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int u = t + i * WT;
        cp_async16(dst + raw_unit<C1>(u / (C1 / 8), u % (C1 / 8)), src + u);
      }
    }
    cp_async_commit();
  };

  // this lane's share of [sum h2, sum h2^2]: columns 8n + 2q + j of its
  // two fragment rows, at s[2n + j] and ss[2n + j]
  float s[C2 / 4], ss[C2 / 4];
#pragma unroll
  for (int i = 0; i < C2 / 4; ++i) s[i] = ss[i] = 0.0f;

  for (int d = 0; d < DEPTH; ++d) fetch(d, d);
  int r = 0;  // ring slot of tile it
  for (long long it = 0; it < iters; ++it) {
    cp_async_wait<DEPTH - 1>();  // this thread's part of tile it
    bar_sync<WT>(1 + g);  // all of it; the last product is done with y1
    const uint4* raw = ring + r * L::tile / 8;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int e = t + i * WT;
      const uint4 hv = raw[raw_unit<C1>(e / C1 * 8 + e % 8, c0)];
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = bn_relu(bf_at(hv, j), sc1[j], bi1[j]);
      reinterpret_cast<uint4*>(y1s)[e] = pack8(v);
    }
    wg::fence_to_async();
    bar_sync<WT>(1 + g);  // y1 staged; slot r free
    fetch(it + DEPTH, r);
    r = r + 1 == DEPTH ? 0 : r + 1;

    float h2[C2 / 2];
    wg::product<C2, 0, 1, C1 / 16>(h2, wg::k_major(y1s, C1, 0, 0),
                                   wg::mn_major(w2s, C2, 0, 0));
#pragma unroll
    for (int n = 0; n < C2 / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float v0 = h2[4 * n + j], v1 = h2[4 * n + 2 + j];
        s[2 * n + j] += v0 + v1;
        ss[2 * n + j] += v0 * v0 + v1 * v1;
      }
  }
  cp_async_wait<0>();

  // a column's eight lanes by one reduce-scatter a pair of 8-column
  // groups (as stage 3 folds h3), then shared memory, then out
  const int slot = wg::rows8_slot(lane);
#pragma unroll
  for (int n = 1; n < C2 / 8; n += 2) {
    float pv[8];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      pv[j] = s[2 * (n - 1) + j];
      pv[2 + j] = ss[2 * (n - 1) + j];
      pv[4 + j] = s[2 * n + j];
      pv[6 + j] = ss[2 * n + j];
    }
    atomicAdd(red + ((slot >> 1) & 1) * C2 + 8 * (n - 1 + (slot >> 2)) +
                  2 * q + (slot & 1),
              wg::rows8_scatter(pv, lane));
  }
  __syncthreads();
  for (int i = tid; i < 2 * C2; i += NT) atomicAdd(a.out + i, red[i]);
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
  static_assert(Sums2Layout<C1, C2>::bytes <= 227 * 1024 &&
                    ChainLayout<C1, C2, C3, 3>::bytes <= 227 * 1024 &&
                    ChainLayout<C1, C2, C3, 4>::bytes <= 227 * 1024,
                "shared memory of one block");
  if (stage == 2) {
    using L = Sums2Layout<C1, C2>;
    const long long tiles = a.rows / kRows;
    return launch(sums2_kernel<C1, C2>, L::bytes,
                  (tiles + L::groups - 1) / L::groups,
                  L::groups * wg::kWGThreads, a, s);
  }
  const long long units = a.rows / ((long long)kRows * tiles_per_center(a.k));
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
// multiple of 64. out is zeroed by the caller for stages 2 and 3. Stage 2
// reads st's first 2*C1 floats (sc1, bi1) and W2 only.
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
