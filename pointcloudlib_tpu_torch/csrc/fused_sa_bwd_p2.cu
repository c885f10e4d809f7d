// Train-mode fused set abstraction, backward pass 2, for Hopper (sm_90a).
//
// Replaces the TPU kernels pointcloudlib_tpu/ops/pallas/fused_sa.py
// (_call_p2 -> _k_p2, and _k_p2w on the N >= 4096 route). With the BN
// sums of layers 3 and 2 known (us3, us2: [sum dz, sum dz*x^] / R from
// pass 1), per grouped row of h1:
//   dz3  = max-pool gradient (even tie split over all k slots) * (z3 > 0)
//   dh3  = sc3 * ((dz3 - us3[0]) - x3 * us3[1])
//   dz2  = (z2 > 0) ? bf16(dh3) . bf16 W3^T : 0
//   dh2  = sc2 * ((dz2 - us2[0]) - x2 * us2[1])
//   dz1  = (z1 > 0) ? bf16(dh2) . bf16 W2^T : 0,  x1 = h1*rs1 - mrs1
// and writes or adds:
//   dw2  [C1, C2]      += bf16(y1)^T . bf16(dh2)
//   ps1  [2, C1]       += [sum dz1, sum dz1*x1]
//   scat [B, N, SW]    += [bf16 dz1 | bf16 x1 | 1] at the row's source
//                         point idx (the TPU's transposed one-hot matmul);
//                         rows padded to SW = 2*C1 + 4 floats
//   d1, d2 [B*M, C1]    = sum over the center's k slots of dz1, x1
// dw2, ps1 and scat are zeroed by the caller.
//
// What bounds it on this card: operations, ~120 GFLOP of bf16 products at
// SSG SA1 with B=64 (the recomputed chain, dz2, dz1 and dw2), 0.12 ms at
// 989 TFLOP/s, then the scatter, 2*C1 + 1 f32 additions a row into an
// L2-resident scat. Every product runs on the tensor cores
// (wgmma_tile.cuh): resident blocks of two warpgroups walk 64-row tiles,
// two blocks an SM where their shared memory fits (128 registers a
// thread), the next tile's h1 prefetched by cp.async; each product's
// output channels are split between the warpgroups; W3^T and W2^T are
// the staged W3 and W2 read K-major, and dw2 = y1^T . dh2 reads the y1
// and dh2 tiles MN-major, its accumulators staying in registers until
// one atomicAdd an element and block at the end (at C1 = 128 each
// warpgroup owns 64 rows of dw2, below it all rows and half the
// columns). Layer 3 goes in column chunks (32 at two blocks an SM, else
// 64) so the chunk, h2 and dw2 fit the registers without spilling in the
// epilogue: spills there cost 1.1 ms at SSG SA1 (B=64) on an H100 80GB
// HBM3 at 700 W. ps1 and, where a thread's
// two rows share a center, d1 and d2 are summed by a reduce-scatter over
// each warp's rows; the max, tie count and the other per-center sums go
// through lane shuffles and shared memory. The scatter pairs lanes so
// that each holds four consecutive channels of one row and adds them
// with one 16-byte vector atomicAdd (float4, sm_90, global memory); on
// that card it measured 0.18 ms of 2.3 at SA1. What holds the kernel is
// the latency of each tile's serial chain of products, barriers and
// shuffles. A center with k > 64 slots (k a multiple of 64) spans k/64
// tiles that one block walks twice: a first pass runs the forward chain
// and folds the center's max and tie count, the second runs everything,
// with d1/d2 summed in shared memory across the center's tiles. Sums are
// f32 in another order than the plain version.

#include "fused_sa_bwd.cuh"

namespace pcl {

struct P2Args {
  const __nv_bfloat16* h1;  // [rows, C1]
  const float* dout;        // [rows / k, C3]
  const int* idx;           // [rows]
  const float* st;          // [4, C1] ++ [4, C2] ++ [4, C3]
  const float* us;          // us3 [2, C3] ++ us2 [2, C2]
  const __nv_bfloat16* w2;  // [C1, C2]
  const __nv_bfloat16* w3;  // [C2, C3]
  float* dw2;               // [C1, C2]
  float* ps1;               // [2, C1]
  float* scat;              // [B, N, 2*C1 + 4]
  float* d1;                // [rows / k, C1]
  float* d2;                // [rows / k, C1]
  long long rows;
  int n;                    // source points per cloud
  int mk;                   // grouped rows per cloud, M*k
  int k;
};

template <int C1, int C2, int C3>
struct P2Layout {
  static constexpr size_t w2 = 0;
  static constexpr size_t w3 = w2 + (size_t)C1 * C2 * 2;
  static constexpr size_t h1 = w3 + (size_t)C2 * C3 * 2;
  // y2 follows y1: at C1 = 32 the dw2 product reads 64 rows of y1^T and
  // drops the 32 past C1, which lie in the next 512 bytes
  static constexpr size_t y1 = h1 + (size_t)kRows * C1 * 2;
  static constexpr size_t y2 = y1 + (size_t)kRows * C1 * 2;
  static constexpr size_t dh3 = y2 + (size_t)kRows * C2 * 2;
  static constexpr size_t st = dh3 + (size_t)kRows * C3 * 2;
  static constexpr size_t idx = st + (size_t)4 * (C1 + C2 + C3) * 4;
  static constexpr size_t mx = idx + (size_t)kRows * 4;
  static constexpr size_t ts = mx + (size_t)(kRows / 8) * C3 * 4;
  static constexpr size_t d1 = ts + (size_t)(kRows / 8) * C3 * 4;
  static constexpr size_t d2 = d1 + (size_t)(kRows / 8) * C1 * 4;
  static constexpr size_t red = d2 + (size_t)(kRows / 8) * C1 * 4;
  static constexpr size_t raw = red + (size_t)2 * C1 * 4;
  // the next tile's h1 is prefetched where it fits
  static constexpr bool prefetch =
      raw + (size_t)kRows * C1 * 2 <= 227 * 1024;
  static constexpr size_t bytes =
      prefetch ? raw + (size_t)kRows * C1 * 2 : raw;
  // two blocks an SM where their shared memory fits
  static constexpr int min_blocks = 2 * bytes <= 227 * 1024 ? 2 : 1;
};

template <int C1, int C2, int C3>
__global__ void __launch_bounds__(kPairThreads,
                                  P2Layout<C1, C2, C3>::min_blocks)
    p2_kernel(const P2Args a) {
  using L = P2Layout<C1, C2, C3>;
  constexpr int N1 = C1 / 2, N2 = C2 / 2, N3 = C3 / 2;
  // layer-3 column chunk: 32 where two blocks share an SM's registers
  constexpr int L3max = L::min_blocks == 2 ? 32 : 64;
  constexpr int L3 = N3 > L3max ? L3max : N3;
  // dw2 = y1^T . dh2: at C1 = 128 warpgroup g owns rows [64 g, 64 g + 64)
  // and all C2 columns, below it all (64) rows and half the columns
  constexpr bool DW_ROWS = C1 == 128;
  constexpr int NW = DW_ROWS ? C2 : N2;
  constexpr int SW = 2 * C1 + 4;  // scat row width
  static_assert(C1 == 128 || C1 <= 64, "dw2 tiling");

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem + L::w2);
  __nv_bfloat16* w3s = reinterpret_cast<__nv_bfloat16*>(smem + L::w3);
  __nv_bfloat16* h1s = reinterpret_cast<__nv_bfloat16*>(smem + L::h1);
  __nv_bfloat16* y1s = reinterpret_cast<__nv_bfloat16*>(smem + L::y1);
  __nv_bfloat16* y2s = reinterpret_cast<__nv_bfloat16*>(smem + L::y2);
  __nv_bfloat16* dh3s = reinterpret_cast<__nv_bfloat16*>(smem + L::dh3);
  float* sts = reinterpret_cast<float*>(smem + L::st);
  int* idxs = reinterpret_cast<int*>(smem + L::idx);
  float* mx = reinterpret_cast<float*>(smem + L::mx);
  int* ts = reinterpret_cast<int*>(smem + L::ts);
  float* d1s = reinterpret_cast<float*>(smem + L::d1);
  float* d2s = reinterpret_cast<float*>(smem + L::d2);
  float* red = reinterpret_cast<float*>(smem + L::red);  // ps1
  __nv_bfloat16* raw = reinterpret_cast<__nv_bfloat16*>(smem + L::raw);

  const int tid = threadIdx.x;
  stage_w<C1, C2>(a.w2, w2s, kPairThreads);
  stage_w<C2, C3>(a.w3, w3s, kPairThreads);
  for (int i = tid; i < 4 * (C1 + C2 + C3); i += kPairThreads)
    sts[i] = a.st[i];
  for (int i = tid; i < 2 * C1; i += kPairThreads) red[i] = 0.0f;
  __syncthreads();
  const float* sc1 = sts;
  const float* bi1 = sc1 + C1;
  const float* rs1 = bi1 + C1;
  const float* mrs1 = rs1 + C1;
  const float* sc2 = sts + 4 * C1;
  const float* bi2 = sc2 + C2;
  const float* rs2 = bi2 + C2;
  const float* mrs2 = rs2 + C2;
  const float* sc3 = sts + 4 * (C1 + C2);
  const float* bi3 = sc3 + C3;
  const float* rs3 = bi3 + C3;
  const float* mrs3 = rs3 + C3;
  const float* u31 = a.us;  // read through L1
  const float* u32 = u31 + C3;
  const float* u21 = u31 + 2 * C3;
  const float* u22 = u21 + C2;

  const int g = tid / wg::kWGThreads;  // warpgroup
  const int t = tid % wg::kWGThreads;
  const int q = t & 3;
  const int lane = t & 31;
  const bool lead = lane < 4;
  const int slot = wg::rows8_slot(lane);
  const int c1 = g * N1, c2 = g * N2, c3 = g * N3;  // first output column
  const int r0 = wg::frag_row(t, 0), r1 = wg::frag_row(t, 1);
  const int k = a.k;
  const int cpt = centers_per_tile(k);
  const int tpc = tiles_per_center(k);
  const int cl0 = r0 / k, cl1 = r1 / k;
  const bool one = cl0 == cl1;  // k >= 16: both rows in one center
  unsigned long long* mc = reinterpret_cast<unsigned long long*>(mx);

  const wg::Opnd a2 = wg::k_major(y1s, C1, 0, 0);
  const wg::Opnd b2 = wg::mn_major(w2s, C2, 0, c2);
  const wg::Opnd a3 = wg::k_major(y2s, C2, 0, 0);
  // dz2 = dh3 . W3^T: W3's rows [c2, c2 + N2) as N, its columns as K
  const wg::Opnd a4 = wg::k_major(dh3s, C3, 0, 0);
  const wg::Opnd b4 = wg::k_major(w3s, C3, c2, 0);
  // dw2 = y1^T . dh2 (dh2 over y2s)
  const wg::Opnd aw = wg::mn_major(y1s, C1, 0, DW_ROWS ? 64 * g : 0);
  const wg::Opnd bw = wg::mn_major(y2s, C2, 0, DW_ROWS ? 0 : c2);
  // dz1 = dh2 . W2^T: W2's rows [c1, c1 + N1) as N, its columns as K
  const wg::Opnd a5 = wg::k_major(y2s, C2, 0, 0);
  const wg::Opnd b5 = wg::k_major(w2s, C2, c1, 0);

  float dw[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) dw[i] = 0.0f;
  // this lane's share of ps1: groups (2i, 2i + 1) of its columns in s1[i]
  float s1[N1 / 16];
#pragma unroll
  for (int i = 0; i < N1 / 16; ++i) s1[i] = 0.0f;

  const Walk walk(a.rows / ((long long)kRows * tpc), blockIdx.x, gridDim.x,
                  tpc);
  if (L::prefetch && walk.iters > 0)
    prefetch_h1<C1, kPairThreads>(a.h1, walk.tile(0) * kRows, raw, tid);
  cp_async_commit();
  for (long long it = 0; it < walk.iters; ++it) {
    const int pass = walk.pass(it);
    const int sub = walk.step(it) % tpc;
    const long long u = walk.unit(it);
    const size_t row0 = walk.tile(it) * kRows;
    if (walk.step(it) == 0) {  // a new unit
      for (int i = tid; i < (kRows / 8) * C3; i += kPairThreads) {
        mx[i] = 0.0f;
        ts[i] = 0;
      }
      for (int i = tid; i < (kRows / 8) * C1; i += kPairThreads)
        d1s[i] = d2s[i] = 0.0f;
    }
    if (L::prefetch) {
      cp_async_wait<0>();
      pair_sync(0);
      stage_h1<C1, kPairThreads>(raw, sc1, bi1, y1s, h1s, tid);
    } else {
      stage_h1<C1, kPairThreads>(a.h1 + row0 * C1, sc1, bi1, y1s, h1s,
                                 tid);
    }
    if (tid < kRows) idxs[tid] = a.idx[row0 + tid];
    wg::fence_to_async();
    pair_sync(0);
    if (L::prefetch && it + 1 < walk.iters)
      prefetch_h1<C1, kPairThreads>(a.h1, walk.tile(it + 1) * kRows, raw,
                                    tid);
    cp_async_commit();

    // layer 2: h2 stays in registers, y2 to shared memory
    float h2[N2 / 2];
    wg::product<N2, 0, 1, C1 / 16>(h2, a2, b2);
#pragma unroll
    for (int n = 0; n < N2 / 8; ++n) {
      const int ch = c2 + wg::frag_col(t, n, 0);
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        y[e] = bn_relu(h2[4 * n + e], sc2[ch + (e & 1)], bi2[ch + (e & 1)]);
      put2<C2>(y2s, r0, ch, y[0], y[1]);
      put2<C2>(y2s, r1, ch, y[2], y[3]);
    }
    wg::fence_to_async();
    pair_sync(0);

    // layer 3 by column chunks: dz3 of the max-pool, dh3 -> bf16
    const float* dout_tile = a.dout + (row0 / k) * C3;
#pragma unroll 1
    for (int cc = c3; cc < c3 + N3; cc += L3) {
      float h3[L3 / 2], z[L3 / 2];
      wg::product<L3, 0, 1, C2 / 16>(h3, a3, wg::mn_major(w3s, C3, 0, cc));
#pragma unroll
      for (int n = 0; n < L3 / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = cc + wg::frag_col(t, n, e & 1);
          z[4 * n + e] = bn_z(h3[4 * n + e], sc3[c], bi3[c]);
        }
      if (pass == 0) {
        frag_tie_merge<L3>(z, t, cc, mc);
        continue;
      }
      if (tpc == 1)
        frag_maxpool_dz<L3, C3>(z, t, cc, k, dout_tile, mx, ts, 0);
      else
        frag_merged_dz<L3>(z, t, cc, dout_tile, mc);
#pragma unroll
      for (int n = 0; n < L3 / 8; ++n) {
        const int ch = cc + wg::frag_col(t, n, 0);
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = ch + (e & 1);
          v[e] = bn_bwd(z[4 * n + e], xhat(h3[4 * n + e], rs3[c], mrs3[c]),
                        sc3[c], u31[c], u32[c]);
        }
        put2<C3>(dh3s, r0, ch, v[0], v[1]);
        put2<C3>(dh3s, r1, ch, v[2], v[3]);
      }
    }
    if (pass == 0) {
      pair_sync(0);
      continue;
    }
    wg::fence_to_async();
    pair_sync(0);

    // dh2 = BN2 backward of (z2 > 0) * (dh3 . W3^T) -> bf16 over y2s
    {
      float d[N2 / 2];
      wg::product<N2, 0, 0, C3 / 16>(d, a4, b4);
#pragma unroll
      for (int n = 0; n < N2 / 8; ++n) {
        const int ch = c2 + wg::frag_col(t, n, 0);
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = ch + (e & 1);
          const float hh = h2[4 * n + e];
          const float dz2 = bn_z(hh, sc2[c], bi2[c]) > 0.0f ? d[4 * n + e]
                                                             : 0.0f;
          v[e] = bn_bwd(dz2, xhat(hh, rs2[c], mrs2[c]), sc2[c], u21[c],
                        u22[c]);
        }
        put2<C2>(y2s, r0, ch, v[0], v[1]);
        put2<C2>(y2s, r1, ch, v[2], v[3]);
      }
    }
    wg::fence_to_async();
    pair_sync(0);

    // dw2 += y1^T . dh2 and dz1 = dh2 . W2^T, issued together
    float d[N1 / 2];
#pragma unroll
    for (int i = 0; i < N1 / 2; ++i) d[i] = 0.0f;
    wg::fence_regs(dw);
    wg::fence_regs(d);
    wg::begin();
    wg::issue<NW, 1, 1, kRows / 16>(dw, aw, bw);
    wg::issue<N1, 0, 0, C2 / 16>(d, a5, b5);
    wg::commit_wait();
    wg::fence_regs(dw);
    wg::fence_regs(d);

    // dz1 = (z1 > 0) * d; sums, per-center sums, scatter
    float pv[8], cv[8];
    const size_t cloud0 = row0 / a.mk;
    const int split = (int)(((cloud0 + 1) * a.mk - row0));  // rows of cloud0
#pragma unroll
    for (int n = 0; n < N1 / 8; ++n) {
      const int ch = c1 + wg::frag_col(t, n, 0);
      float dz[4], x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = ch + (e & 1);
        const float h =
            __bfloat162float(h1s[wg::cm(e < 2 ? r0 : r1, c, C1)]);
        dz[e] = bn_z(h, sc1[c], bi1[c]) > 0.0f ? d[4 * n + e] : 0.0f;
        x[e] = xhat(h, rs1[c], mrs1[c]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = ch + j;
        if (one) {  // both rows in one center: with ps1 below
          cv[4 * (n & 1) + j] = dz[j] + dz[2 + j];
          cv[4 * (n & 1) + 2 + j] = x[j] + x[2 + j];
        } else {
          const float ds0 = wg::rows8_sum(dz[j]);
          const float ds1 = wg::rows8_sum(dz[2 + j]);
          const float xs0 = wg::rows8_sum(x[j]);
          const float xs1 = wg::rows8_sum(x[2 + j]);
          if (lead) {
            atomicAdd(d1s + cl0 * C1 + c, ds0);
            atomicAdd(d1s + cl1 * C1 + c, ds1);
            atomicAdd(d2s + cl0 * C1 + c, xs0);
            atomicAdd(d2s + cl1 * C1 + c, xs1);
          }
        }
        pv[4 * (n & 1) + j] = dz[j] + dz[2 + j];
        pv[4 * (n & 1) + 2 + j] = dz[j] * x[j] + dz[2 + j] * x[2 + j];
      }
      // ps1 = [sum dz1, sum dz1*x1] of two groups a reduce-scatter, kept
      // in a register across tiles; d1, d2 of two groups another, added
      // into the center's sums by every lane
      if (n & 1) {
        s1[n / 2] += wg::rows8_scatter(pv, lane);
        if (one) {
          const float v = wg::rows8_scatter(cv, lane);
          atomicAdd(((slot >> 1) & 1 ? d2s : d1s) + cl0 * C1 + c1 +
                        8 * (n - 1 + (slot >> 2)) + 2 * q + (slot & 1),
                    v);
        }
      }
      // lanes q and q^1 swap pairs: an even lane then holds channels
      // [ch, ch + 4) of row r0, an odd one [ch - 2, ch + 2) of row r1
      const bool even = (q & 1) == 0;
      float bd[4], bx[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bd[e] = bf_round(dz[e]);
        bx[e] = bf_round(x[e]);
      }
      const float pd0 = __shfl_xor_sync(0xffffffffu, even ? bd[2] : bd[0], 1);
      const float pd1 = __shfl_xor_sync(0xffffffffu, even ? bd[3] : bd[1], 1);
      const float px0 = __shfl_xor_sync(0xffffffffu, even ? bx[2] : bx[0], 1);
      const float px1 = __shfl_xor_sync(0xffffffffu, even ? bx[3] : bx[1], 1);
      const int r = even ? r0 : r1;
      const int cb = even ? ch : ch - 2;
      const size_t cloud = r < split ? cloud0 : (row0 + r) / a.mk;
      float* dst = a.scat + (cloud * a.n + idxs[r]) * SW + cb;
      atomicAdd(reinterpret_cast<float4*>(dst),
                even ? make_float4(bd[0], bd[1], pd0, pd1)
                     : make_float4(pd0, pd1, bd[2], bd[3]));
      atomicAdd(reinterpret_cast<float4*>(dst + C1),
                even ? make_float4(bx[0], bx[1], px0, px1)
                     : make_float4(px0, px1, bx[2], bx[3]));
    }
    if (tid < kRows) {
      const size_t cloud = (row0 + tid) / a.mk;
      atomicAdd(a.scat + (cloud * a.n + idxs[tid]) * SW + 2 * C1, 1.0f);
    }
    pair_sync(0);
    if (sub == tpc - 1) {  // the unit's centers are complete
      const size_t first = ((size_t)u * tpc * kRows) / k;
      for (int i = tid; i < cpt * C1; i += kPairThreads) {
        a.d1[first * C1 + i] = d1s[i];
        a.d2[first * C1 + i] = d2s[i];
      }
      pair_sync(0);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < N1 / 16; ++i)
    atomicAdd(red + ((slot >> 1) & 1) * C1 + c1 + 8 * (2 * i + (slot >> 2)) +
                  2 * q + (slot & 1),
              s1[i]);
  __syncthreads();
  flush_red(red, a.ps1, 2 * C1);
#pragma unroll
  for (int n = 0; n < NW / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int m = (DW_ROWS ? 64 * g : 0) + wg::frag_row(t, i);
        const int c = (DW_ROWS ? 0 : c2) + wg::frag_col(t, n, j);
        if (m < C1) atomicAdd(a.dw2 + m * C2 + c, dw[4 * n + 2 * i + j]);
      }
}

template <int C1, int C2, int C3>
cudaError_t launch_p2(const P2Args& a, cudaStream_t stream) {
  constexpr size_t smem = P2Layout<C1, C2, C3>::bytes;
  static_assert(smem <= 227 * 1024, "shared memory of one block");
  auto kernel = p2_kernel<C1, C2, C3>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = resident_blocks(
      kernel, smem, a.rows / ((long long)kRows * tiles_per_center(a.k)),
      &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kPairThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace pcl

// Widths compiled: (32, 32, 64), (64, 64, 128), (64, 96, 128) and
// (128, 128, 256). k is 8, 16, 32 or a multiple of 64, and rows = B*M*k a
// multiple of 64; scat rows are 2*C1 + 4 floats, 16-byte aligned. Returns
// cudaGetLastError() of the launch.
extern "C" int sa_bwd_p2_launch(const void* h1, const void* dout,
                                const void* idx, const void* st,
                                const void* us, const void* w2,
                                const void* w3, void* dw2, void* ps1,
                                void* scat, void* d1, void* d2,
                                long long rows, int n, int mk, int k, int c1,
                                int c2, int c3, void* stream) {
  if (rows < 1 || !pcl::k_ok(k) || rows % pcl::kRows || rows % k || n < 1 ||
      mk < 1 || mk % k || reinterpret_cast<uintptr_t>(scat) % 16)
    return cudaErrorInvalidValue;
  pcl::P2Args a;
  a.h1 = static_cast<const __nv_bfloat16*>(h1);
  a.dout = static_cast<const float*>(dout);
  a.idx = static_cast<const int*>(idx);
  a.st = static_cast<const float*>(st);
  a.us = static_cast<const float*>(us);
  a.w2 = static_cast<const __nv_bfloat16*>(w2);
  a.w3 = static_cast<const __nv_bfloat16*>(w3);
  a.dw2 = static_cast<float*>(dw2);
  a.ps1 = static_cast<float*>(ps1);
  a.scat = static_cast<float*>(scat);
  a.d1 = static_cast<float*>(d1);
  a.d2 = static_cast<float*>(d2);
  a.rows = rows;
  a.n = n;
  a.mk = mk;
  a.k = k;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PCL_LAUNCH(A, B, C)          \
  if (c1 == A && c2 == B && c3 == C) \
    return pcl::launch_p2<A, B, C>(a, s);
  PCL_TRAIN_WIDTHS(PCL_LAUNCH)
#undef PCL_LAUNCH
  return cudaErrorInvalidValue;
}
