// Train-mode fused set abstraction, backward pass 1, for Hopper (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/fused_sa.py
// (_call_p1 -> _k_p1). From the bf16 checkpoint h1 [rows, C1], the
// output gradient dout [B*M, C3] and the folded BN rows of all three
// layers, per grouped row:
//   h2, z2 = h2*sc2 + bi2, y2 = relu(z2), m2 = (z2 > 0), x2 = h2*rs2 - mrs2
//   h3, z3 = h3*sc3 + bi3, y3 = relu(z3), x3 = h3*rs3 - mrs3
//   dz3 = (z3 > 0) ? dout * tie / #ties : 0, the max-pool gradient split
//         evenly among the k slots (replicas included) that reach the max
//   left = [y2 | m2 | m2*x2] (3*C2), right = [dz3 | x3] (2*C3)
// and over all rows:
//   ps3 = [sum dz3, sum dz3*x3] (2, C3), vecs = sum left (3*C2),
//   mats = bf16(left)^T . bf16(right) (3*C2, 2*C3), f32 sums.
//
// What bounds it on this card: operations, ~258 GFLOP of bf16 products
// at SSG SA1 or SA2 with B=64 (the chain 2*rows*(C1*C2 + C2*C3), mats
// 2*rows*3*C2*2*C3), 0.26 ms at 989 TFLOP/s. Every product runs on the
// tensor cores (wgmma, bf16 operands in shared memory, f32 sums in
// registers; wgmma_tile.cuh). Two kernels:
//  (a) p1_rows_kernel: each block holds two pairs of warpgroups that
//      share the staged weights and walk their own 64-row tiles (two
//      tiles in flight an SM, 128 registers a thread), the next tile's
//      h1 prefetched by cp.async where shared memory allows. A pair
//      stages y1 = relu(BN1(h1)), runs layers 2 and 3 as wgmma products
//      (each warpgroup half of the output channels, layer 3 in chunks of
//      at most 64), reduces the per-center max and tie count through
//      lane shuffles and shared memory, and stores left and right as
//      bf16 into a scratch, each 64-row tile in the core-matrix layout
//      that (b) copies straight into shared memory. vecs and ps3 are
//      summed by a reduce-scatter over each warp's rows into registers,
//      flushed once: shared-memory atomics a tile cost 0.65 ms at SSG
//      SA1 (B=64) on an H100 80GB HBM3 at 700 W.
//  (b) p1_mats_kernel: mats^T = right^T . left as a split-K wgmma
//      contraction over the scratch (both operands MN-major), a ring of
//      cp.async stages with one tile's products kept in flight, one
//      atomicAdd an element of mats and split.
// Why the scratch stays: mats does not fit a block. At SA1 widths it is
// 192 x 256 f32 (192 KB); held in registers it takes 192 a thread over
// two warpgroups, or 128 over three beside the chain's 96 (layer 3's
// 64 accumulators and layer 2's 32): above the 65,536 registers of an
// SM. At (128, 128, 256) it is 768 KB. Splitting mats across blocks
// recomputes the chain once a slab (3 slabs at SA1: +103 GFLOP). The
// scratch costs its bytes instead, 1.88 GB written and read at SA1 and
// 0.94 GB at SA2; on that card its stores measured 0.17 ms of the rows
// kernel's 1.8 ms at SA1, the contraction 0.64 ms (PERF.md). What holds the rows
// kernel is the latency of each tile's serial chain of products,
// barriers and shuffles, with two tiles an SM to hide it. All sums are
// f32 in another order than the plain version.
//
// A center with k > 64 slots spans k/64 tiles, and its max and tie count
// are known only after the last of them. One pair then walks the
// center's tiles twice: a first pass runs the chain and folds (max, tie
// count) of relu(z3) into shared memory, the second runs the chain again
// and does everything else.

#include "fused_sa_bwd.cuh"

namespace pcl {

struct P1Args {
  const __nv_bfloat16* h1;  // [rows, C1]
  const float* dout;        // [rows / k, C3]
  const float* st;          // [4, C1] ++ [4, C2] ++ [4, C3]
  const __nv_bfloat16* w2;  // [C1, C2]
  const __nv_bfloat16* w3;  // [C2, C3]
  float* ps3;               // [2, C3]
  float* vecs;              // [3 * C2]
  __nv_bfloat16* left;      // [rows, 3 * C2] scratch, tiles in cm layout
  __nv_bfloat16* right;     // [rows, 2 * C3] scratch, tiles in cm layout
  float* mats;              // [3 * C2, 2 * C3]
  long long rows;
  int k;
};

// Shared memory: the weights, the BN rows and the block's sums, then per
// pair the y1 and y2 tiles, the per-center max and tie counts and, where
// it fits, a second h1 tile the next step's copy lands in.
template <int C1, int C2, int C3>
struct P1Layout {
  static constexpr int pairs = 2;
  static constexpr size_t w2 = 0;
  static constexpr size_t w3 = w2 + (size_t)C1 * C2 * 2;
  static constexpr size_t st = w3 + (size_t)C2 * C3 * 2;
  static constexpr size_t red = st + (size_t)4 * (C1 + C2 + C3) * 4;
  static constexpr size_t shared =
      red + ((size_t)(2 * C3 + 3 * C2) * 4 + 127) / 128 * 128;
  // per pair, from its base
  static constexpr size_t y1 = 0;
  static constexpr size_t y2 = y1 + (size_t)kRows * C1 * 2;
  static constexpr size_t mx = y2 + (size_t)kRows * C2 * 2;
  static constexpr size_t ts = mx + (size_t)(kRows / 8) * C3 * 4;
  static constexpr size_t raw = ts + (size_t)(kRows / 8) * C3 * 4;
  static constexpr size_t pair_bytes = raw + (size_t)kRows * C1 * 2;
  static constexpr bool prefetch =
      shared + pairs * pair_bytes <= 227 * 1024;
  static constexpr size_t pair_size = prefetch ? pair_bytes : raw;
  static constexpr size_t bytes = shared + pairs * pair_size;
};

template <int C1, int C2, int C3>
__global__ void __launch_bounds__(P1Layout<C1, C2, C3>::pairs *kPairThreads,
                                  1) p1_rows_kernel(const P1Args a) {
  using L = P1Layout<C1, C2, C3>;
  constexpr int N2 = C2 / 2, N3 = C3 / 2;  // output columns a warpgroup
  constexpr int L3 = N3 > 64 ? 64 : N3;  // layer-3 column chunk
  constexpr int WL = 3 * C2, WR = 2 * C3;  // scratch tile widths
  constexpr int NT = L::pairs * kPairThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem + L::w2);
  __nv_bfloat16* w3s = reinterpret_cast<__nv_bfloat16*>(smem + L::w3);
  float* sts = reinterpret_cast<float*>(smem + L::st);
  float* red = reinterpret_cast<float*>(smem + L::red);  // ps3 ++ vecs

  const int tid = threadIdx.x;
  stage_w<C1, C2>(a.w2, w2s, NT);
  stage_w<C2, C3>(a.w3, w3s, NT);
  for (int i = tid; i < 4 * (C1 + C2 + C3); i += NT) sts[i] = a.st[i];
  for (int i = tid; i < 2 * C3 + 3 * C2; i += NT) red[i] = 0.0f;
  __syncthreads();
  const float* sc1 = sts;
  const float* bi1 = sc1 + C1;
  const float* sc2 = sts + 4 * C1;
  const float* bi2 = sc2 + C2;
  const float* rs2 = bi2 + C2;
  const float* mrs2 = rs2 + C2;
  const float* sc3 = sts + 4 * (C1 + C2);
  const float* bi3 = sc3 + C3;
  const float* rs3 = bi3 + C3;
  const float* mrs3 = rs3 + C3;
  float* red3 = red;           // [2, C3]
  float* redv = red + 2 * C3;  // [3 * C2]

  const int pair = tid / kPairThreads, pt = tid % kPairThreads;
  unsigned char* base = smem + L::shared + pair * L::pair_size;
  __nv_bfloat16* y1s = reinterpret_cast<__nv_bfloat16*>(base + L::y1);
  __nv_bfloat16* y2s = reinterpret_cast<__nv_bfloat16*>(base + L::y2);
  float* mx = reinterpret_cast<float*>(base + L::mx);
  int* ts = reinterpret_cast<int*>(base + L::ts);
  __nv_bfloat16* raw = reinterpret_cast<__nv_bfloat16*>(base + L::raw);
  unsigned long long* mc = reinterpret_cast<unsigned long long*>(mx);

  const int g = pt / wg::kWGThreads;  // warpgroup in the pair
  const int t = pt % wg::kWGThreads;
  const int lane = t & 31;
  const int c2 = g * N2, c3 = g * N3;  // first output column
  const int r0 = wg::frag_row(t, 0), r1 = wg::frag_row(t, 1);
  const int k = a.k;
  const int tpc = tiles_per_center(k);
  const wg::Opnd a2 = wg::k_major(y1s, C1, 0, 0);
  const wg::Opnd b2 = wg::mn_major(w2s, C2, 0, c2);
  const wg::Opnd a3 = wg::k_major(y2s, C2, 0, 0);

  // this lane's share of the column sums: vecs of group n in sv[n], ps3
  // of groups (2i, 2i + 1) of the warpgroup's columns in s3[i]
  float sv[N2 / 8], s3[N3 / 16];
#pragma unroll
  for (int i = 0; i < N2 / 8; ++i) sv[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < N3 / 16; ++i) s3[i] = 0.0f;

  const Walk walk(a.rows / ((long long)kRows * tpc),
                  (long long)blockIdx.x * L::pairs + pair,
                  (long long)gridDim.x * L::pairs, tpc);
  if (L::prefetch && walk.iters > 0)
    prefetch_h1<C1, kPairThreads>(a.h1, walk.tile(0) * kRows, raw, pt);
  cp_async_commit();
  for (long long it = 0; it < walk.iters; ++it) {
    const int pass = walk.pass(it);
    const size_t tile = walk.tile(it);
    const size_t row0 = tile * kRows;
    if (walk.step(it) == 0)  // a new unit
      for (int i = pt; i < (kRows / 8) * C3; i += kPairThreads) {
        mx[i] = 0.0f;
        ts[i] = 0;
      }
    if (L::prefetch) {
      cp_async_wait<0>();
      pair_sync(pair);
      stage_h1<C1, kPairThreads>(raw, sc1, bi1, y1s, nullptr, pt);
    } else {
      stage_h1<C1, kPairThreads>(a.h1 + row0 * C1, sc1, bi1, y1s, nullptr,
                                 pt);
    }
    wg::fence_to_async();
    pair_sync(pair);
    if (L::prefetch && it + 1 < walk.iters)
      prefetch_h1<C1, kPairThreads>(a.h1, walk.tile(it + 1) * kRows, raw,
                                    pt);
    cp_async_commit();

    // layer 2: left = [y2 | m2 | m2*x2]; y2 to shared memory
    {
      float h[N2 / 2];
      wg::product<N2, 0, 1, C1 / 16>(h, a2, b2);
      __nv_bfloat16* lg = a.left + tile * kRows * WL;
#pragma unroll
      for (int n = 0; n < N2 / 8; ++n) {
        const int ch = c2 + wg::frag_col(t, n, 0);
        float y[4], m[4], x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = ch + (e & 1);
          const float z = bn_z(h[4 * n + e], sc2[c], bi2[c]);
          y[e] = fmaxf(z, 0.0f);
          m[e] = z > 0.0f ? 1.0f : 0.0f;
          x[e] = __fmul_rn(m[e], xhat(h[4 * n + e], rs2[c], mrs2[c]));
        }
        put2<C2>(y2s, r0, ch, y[0], y[1]);
        put2<C2>(y2s, r1, ch, y[2], y[3]);
        if (pass == 0) continue;
        put2<WL>(lg, r0, ch, y[0], y[1]);
        put2<WL>(lg, r1, ch, y[2], y[3]);
        put2<WL>(lg, r0, C2 + ch, m[0], m[1]);
        put2<WL>(lg, r1, C2 + ch, m[2], m[3]);
        put2<WL>(lg, r0, 2 * C2 + ch, x[0], x[1]);
        put2<WL>(lg, r1, 2 * C2 + ch, x[2], x[3]);
        // vecs: the group's six column sums over the warp's rows, one a
        // lane (two lanes idle), kept in a register across tiles
        const float v[8] = {y[0] + y[2], y[1] + y[3], m[0] + m[2],
                            m[1] + m[3], x[0] + x[2], x[1] + x[3], 0.0f,
                            0.0f};
        sv[n] += wg::rows8_scatter(v, lane);
      }
    }
    wg::fence_to_async();
    pair_sync(pair);

    // layer 3 by column chunks and the max-pool gradient: right =
    // [dz3 | x3]
    const float* dout_tile = a.dout + (row0 / k) * C3;
    __nv_bfloat16* rgp = a.right + tile * kRows * WR;
#pragma unroll
    for (int ci = 0; ci < N3 / L3; ++ci) {
      const int cc = c3 + ci * L3;
      float h[L3 / 2], dz[L3 / 2];
      float pv[8];
      wg::product<L3, 0, 1, C2 / 16>(h, a3, wg::mn_major(w3s, C3, 0, cc));
#pragma unroll
      for (int n = 0; n < L3 / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = cc + wg::frag_col(t, n, e & 1);
          dz[4 * n + e] = bn_z(h[4 * n + e], sc3[c], bi3[c]);
        }
      if (pass == 0) {
        frag_tie_merge<L3>(dz, t, cc, mc);
        continue;
      }
      if (tpc == 1)
        frag_maxpool_dz<L3, C3>(dz, t, cc, k, dout_tile, mx, ts, pair);
      else
        frag_merged_dz<L3>(dz, t, cc, dout_tile, mc);
#pragma unroll
      for (int n = 0; n < L3 / 8; ++n) {
        const int ch = cc + wg::frag_col(t, n, 0);
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = ch + (e & 1);
          x[e] = xhat(h[4 * n + e], rs3[c], mrs3[c]);
        }
        put2<WR>(rgp, r0, ch, dz[4 * n], dz[4 * n + 1]);
        put2<WR>(rgp, r1, ch, dz[4 * n + 2], dz[4 * n + 3]);
        put2<WR>(rgp, r0, C3 + ch, x[0], x[1]);
        put2<WR>(rgp, r1, C3 + ch, x[2], x[3]);
        // ps3: [dz3 | dz3*x3] of two groups a reduce-scatter
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          pv[4 * (n & 1) + j] = dz[4 * n + j] + dz[4 * n + 2 + j];
          pv[4 * (n & 1) + 2 + j] =
              dz[4 * n + j] * x[j] + dz[4 * n + 2 + j] * x[2 + j];
        }
        if (n & 1) s3[ci * (L3 / 16) + n / 2] += wg::rows8_scatter(pv, lane);
      }
    }
    pair_sync(pair);
  }
  cp_async_wait<0>();
  // each lane's register sums into the block's, then into the outputs
  const int slot = wg::rows8_slot(lane), q2 = 2 * (t & 3);
#pragma unroll
  for (int n = 0; n < N2 / 8; ++n)
    if (slot < 6)
      atomicAdd(redv + (slot >> 1) * C2 + c2 + 8 * n + q2 + (slot & 1),
                sv[n]);
#pragma unroll
  for (int i = 0; i < N3 / 16; ++i) {
    const int col = c3 + (i / (L3 / 16)) * L3 + 8 * (2 * (i % (L3 / 16)) +
                                                     (slot >> 2)) +
                    q2 + (slot & 1);
    atomicAdd(red3 + ((slot >> 1) & 1) * C3 + col, s3[i]);
  }
  __syncthreads();
  flush_red(red3, a.ps3, 2 * C3);
  flush_red(redv, a.vecs, 3 * C2);
}

// mats^T [WA, WB] += right^T . left over the scratch tiles of one range
// (blockIdx.y) for one 128 x BN block of mats^T (blockIdx.x): warpgroup
// g takes rows [64 g, 64 g + 64) of the block, BN columns. A stage is
// one 64-row scratch tile of each operand, copied by cp.async from its
// core-matrix image.
constexpr int kMatsStages = 4;
constexpr int kMatsM = 128;

template <int WA, int WB, int BN>
struct MatsLayout {
  static constexpr size_t a = (size_t)kRows * kMatsM * 2;  // per stage
  static constexpr size_t b = (size_t)kRows * BN * 2;
  static constexpr size_t bytes = kMatsStages * (a + b);
};

template <int WA, int WB, int BN>
__global__ void __launch_bounds__(kPairThreads)
    p1_mats_kernel(const __nv_bfloat16* right, const __nv_bfloat16* left,
                   float* mats, long long tiles, long long per_block) {
  using L = MatsLayout<WA, WB, BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NT = WB / BN;
  const int m0 = (blockIdx.x / NT) * kMatsM, n0 = (blockIdx.x % NT) * BN;
  const long long t0 = blockIdx.y * per_block;
  const long long nt = min(tiles, t0 + per_block) - t0;
  const int tid = threadIdx.x;
  const int g = tid / wg::kWGThreads, t = tid % wg::kWGThreads;

  auto stage_a = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem + s * (L::a + L::b));
  };
  auto stage_b = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem + s * (L::a + L::b) + L::a);
  };
  // tile tt into stage s: per row group, kMatsM / 8 (A) and BN / 8 (B)
  // core matrices that lie next to each other in the scratch image
  auto load = [&](int s, long long tt) {
    const __nv_bfloat16* ra = right + tt * kRows * WA;
    const __nv_bfloat16* lb = left + tt * kRows * WB;
    __nv_bfloat16* sa = stage_a(s);
    __nv_bfloat16* sb = stage_b(s);
    for (int e = tid; e < kRows * kMatsM / 8; e += kPairThreads) {
      const int grp = e / kMatsM, c = e % kMatsM;  // 16-byte chunks
      cp_async16(sa + grp * 8 * kMatsM + c * 8,
                 ra + grp * 8 * WA + m0 * 8 + c * 8);
    }
    for (int e = tid; e < kRows * BN / 8; e += kPairThreads) {
      const int grp = e / BN, c = e % BN;
      cp_async16(sb + grp * 8 * BN + c * 8, lb + grp * 8 * WB + n0 * 8 + c * 8);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  wg::fence_regs(acc);
  for (int s = 0; s < kMatsStages - 1; ++s) {
    if (s < nt) load(s, t0 + s);
    cp_async_commit();
  }
  // tile it: once it has landed, issue its products and keep them in
  // flight; once tile it - 1's products are done in both warpgroups,
  // refill that stage with tile it + stages - 1
  for (long long it = 0; it < nt; ++it) {
    const int s = (int)(it % kMatsStages);
    cp_async_wait<kMatsStages - 2>();
    wg::fence_to_async();
    __syncthreads();
    // A = right^T rows [m0 + 64 g, +64): columns of the stage's A tile;
    // B = left columns [n0, n0 + BN); K = the tile's 64 rows
    wg::begin();
    wg::issue<BN, 1, 1, kRows / 16>(
        acc, wg::mn_major(stage_a(s), kMatsM, 0, 64 * g),
        wg::mn_major(stage_b(s), BN, 0, 0));
    wg::commit();
    wg::wait<1>();
    __syncthreads();
    const long long next = it + kMatsStages - 1;
    if (next < nt) load((int)(next % kMatsStages), t0 + next);
    cp_async_commit();
  }
  wg::wait<0>();
  wg::fence_regs(acc);
  cp_async_wait<0>();
  // mats [WB, WA] row-major holds mats^T[m][n] at n * WA + m
#pragma unroll
  for (int n = 0; n < BN / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int m = m0 + 64 * g + wg::frag_row(t, i);
        const int c = n0 + wg::frag_col(t, n, j);
        atomicAdd(mats + (size_t)c * WA + m, acc[4 * n + 2 * i + j]);
      }
}

template <int WA, int WB, int BN>
cudaError_t launch_mats(const __nv_bfloat16* right, const __nv_bfloat16* left,
                        float* mats, long long rows, cudaStream_t stream) {
  static_assert(WA % kMatsM == 0 && WB % BN == 0 && BN % 8 == 0 &&
                    BN <= 256,
                "mats tiling");
  constexpr size_t smem = MatsLayout<WA, WB, BN>::bytes;
  static_assert(smem <= 227 * 1024, "shared memory of one block");
  auto kernel = p1_mats_kernel<WA, WB, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int resident = 0;
  err = resident_blocks(kernel, smem, 1LL << 40, &resident);
  if (err != cudaSuccess) return err;
  const long long tiles = rows / kRows;
  constexpr int blocks_mn = (WA / kMatsM) * (WB / BN);
  long long splits = (resident + blocks_mn - 1) / blocks_mn;
  if (splits > tiles) splits = tiles;
  const long long per_block = (tiles + splits - 1) / splits;
  splits = (tiles + per_block - 1) / per_block;
  const dim3 grid(blocks_mn, (unsigned)splits);
  kernel<<<grid, kPairThreads, smem, stream>>>(right, left, mats, tiles,
                                              per_block);
  return cudaGetLastError();
}

// The contraction's column block: all of 3*C2 up to 192 columns, else
// half of it.
__host__ __device__ constexpr int mats_bn(int c2) {
  return 3 * c2 <= 192 ? 3 * c2 : 3 * c2 / 2;
}

template <int C1, int C2, int C3>
cudaError_t launch_p1(const P1Args& a, cudaStream_t stream) {
  using L = P1Layout<C1, C2, C3>;
  static_assert(L::bytes <= 227 * 1024, "shared memory of one block");
  constexpr int threads = L::pairs * kPairThreads;
  auto rows_kernel = p1_rows_kernel<C1, C2, C3>;
  cudaError_t err = cudaFuncSetAttribute(
      rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::bytes);
  if (err != cudaSuccess) return err;
  const long long units = a.rows / ((long long)kRows * tiles_per_center(a.k));
  int blocks = 0;
  err = resident_blocks(rows_kernel, L::bytes,
                        (units + L::pairs - 1) / L::pairs, &blocks, threads);
  if (err != cudaSuccess) return err;
  rows_kernel<<<blocks, threads, L::bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_mats<2 * C3, 3 * C2, mats_bn(C2)>(a.right, a.left, a.mats,
                                                  a.rows, stream);
}

}  // namespace pcl

// Widths compiled: (32, 32, 64), (64, 64, 128), (64, 96, 128) and
// (128, 128, 256). k is 8, 16, 32 or a multiple of 64, and rows = B*M*k a
// multiple of 64. ps3, vecs and mats are zeroed by the caller; left and
// right are scratch of rows*3*C2 and rows*2*C3 bf16. Returns
// cudaGetLastError() of the launches.
extern "C" int sa_bwd_p1_launch(const void* h1, const void* dout,
                                const void* st, const void* w2,
                                const void* w3, void* ps3, void* vecs,
                                void* left, void* right, void* mats,
                                long long rows, int k, int c1, int c2,
                                int c3, void* stream) {
  if (rows < 1 || !pcl::k_ok(k) || rows % pcl::kRows || rows % k)
    return cudaErrorInvalidValue;
  pcl::P1Args a;
  a.h1 = static_cast<const __nv_bfloat16*>(h1);
  a.dout = static_cast<const float*>(dout);
  a.st = static_cast<const float*>(st);
  a.w2 = static_cast<const __nv_bfloat16*>(w2);
  a.w3 = static_cast<const __nv_bfloat16*>(w3);
  a.ps3 = static_cast<float*>(ps3);
  a.vecs = static_cast<float*>(vecs);
  a.left = static_cast<__nv_bfloat16*>(left);
  a.right = static_cast<__nv_bfloat16*>(right);
  a.mats = static_cast<float*>(mats);
  a.rows = rows;
  a.k = k;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PCL_LAUNCH(A, B, C)          \
  if (c1 == A && c2 == B && c3 == C) \
    return pcl::launch_p1<A, B, C>(a, s);
  PCL_TRAIN_WIDTHS(PCL_LAUNCH)
#undef PCL_LAUNCH
  return cudaErrorInvalidValue;
}
