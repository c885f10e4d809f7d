// The eval-mode chain shared by the two fused set-abstraction eval
// kernels (ball query inside: fused_sa_bq_eval.cu; from a given neighbour
// index: fused_sa_eval.cu), on Hopper's tensor cores (sm_90a). Once each
// center's neighbour slots and its number of live slots are known, both
// run every live (center, slot) row through
//   h1 = float(bf16 Q[b, nbr]) - off[b, center]
//   y1 = relu(h1*sc1 + bi1) -> bf16 -> h2 = y1 . W2 (f32 sums)
//   y2 = relu(h2*sc2 + bi2) -> bf16 -> h3 = y2 . W3 (f32 sums)
//   y3 = relu(h3*sc3 + bi3)
// and keep the max of y3 per center in shared memory. No grouped tensor
// reaches device memory.
//
// Each of a block's two warpgroups walks its own units (a cloud's tile of
// MT centers; every (2 * gridDim.x)-th unit a warpgroup) behind its own
// named barrier; W2 and W3 are staged once a block, in the core-matrix
// layout of wgmma_tile.cuh. A unit goes:
//   1. its off rows land by cp.async; its neighbours come from the ball
//      query (one warp a center, on the cloud staged in shared memory)
//      or from the given idx (its live slots only);
//   2. each center's live rows are padded up to a multiple of 8 with
//      replicas of its slot 0 and packed densely, so each 8-row group of
//      a tile belongs to one center (a table, group -> center); the tail
//      of the last tile repeats the last center's slot 0. A replica runs
//      the same row as slot 0 and cannot raise the max, the argument the
//      TPU kernels' slot cap rests on;
//   3. per 64-row tile, on two operand tiles in turn: the tile's q rows
//      were copied by cp.async into its operand tile (core-matrix image)
//      two tiles ahead, and turned into y1 = bf16(relu(BN1(q - off))) in
//      place while the previous tile's layer 3 ran (each thread always
//      the same 16-byte chunks of its rows: no barrier between a thread's
//      copy and its read); h2 = y1 . W2 on wgmma; y2 from the fragment
//      into the same tile, its roundings those of the plain version
//      (layer2_z); h3 = y2 . W3 on wgmma in column chunks (64 columns at
//      two blocks an SM, 128 at one), each chunk folded into the max from
//      the fragment: a reduce-scatter over the eight lanes that hold one
//      8-row group (one center), then one shared atomicMax a lane on the
//      float's bits (relu outputs are >= 0: a zeroed array is the
//      identity);
//   4. once every tile of the unit has folded, its pooled rows are
//      written, coalesced, and the running max zeroed.

#pragma once

#include "fused_sa_chain.cuh"

namespace pcl {

struct EvalArgs {
  const __nv_bfloat16* q;   // [B, N, C1]
  const float* off;         // [B, M, C1]
  const float* st;          // sc [C1 + C2 + C3], then bi, layer by layer
  const __nv_bfloat16* w2;  // [C1, C2]
  const __nv_bfloat16* w3;  // [C2, C3]
  float* out;               // [B, M, C3]
  const float* new_xyz;     // ball query: centers [B, M, 3]
  const float* pts;         //   and cloud [B, N, 3]
  float r2;
  const int* idx;           // given index: [B, M, k], every entry in [0, N)
  const int* cnt;           //   and the ball query's counts [B, M] or null
  int batch, n, m, k;
};

__host__ __device__ constexpr size_t round_up(size_t x, size_t to) {
  return (x + to - 1) / to * to;
}

// y2's bf16 roundings as the plain version makes them. Layer 2's sums on
// the tensor cores come in another order than the plain product's
// sequential f32 FMA over k; where that moves z2 = h2*sc2 + bi2 across a
// bf16 rounding boundary, one bf16 unit of y2 can move the pooled output
// by a few 1e-2 at large BN scales. So each z2 > 0 within kTieUlps f32
// units of a boundary is recomputed from the sequential sum.
constexpr int kTieUlps = 8;

__device__ __forceinline__ bool near_tie(float z) {
  const uint32_t low = __float_as_uint(z) & 0xffffu;
  return z > 0.0f && low - (0x8000u - kTieUlps) <= 2u * kTieUlps;
}

// h2[r, c] = y1[r, :] . W2[:, c] as the plain product sums it: f32 FMAs in
// the order of k, from 0 (y1s, w2s: core-matrix tiles). Each 16 terms'
// operands are loaded before their FMAs, so the chain waits on the FMAs
// alone.
template <int C1, int C2>
__device__ __forceinline__ float seq_dot(const __nv_bfloat16* y1s,
                                         const __nv_bfloat16* w2s, int r,
                                         int c) {
  const __nv_bfloat16* wc = w2s + wg::cm(0, c, C2);
  float acc = 0.0f;
#pragma unroll
  for (int k0 = 0; k0 < C1; k0 += 16) {
    const uint4 y0 = *reinterpret_cast<const uint4*>(y1s + wg::cm(r, k0, C1));
    const uint4 y8 =
        *reinterpret_cast<const uint4*>(y1s + wg::cm(r, k0 + 8, C1));
    float wv[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      wv[i] = __bfloat162float(wc[wg::cm(k0 + i, 0, C2)]);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      acc = fmaf(bf_at(i < 8 ? y0 : y8, i & 7), wv[i], acc);
  }
  return acc;
}

// Layer 2's epilogue before y1 is overwritten, by thread t of the
// warpgroup: z = h2*sc2 + bi2 in place, each near-tie z recomputed from
// seq_dot by the thread that holds it (a few threads a tile, for one z
// each as a rule).
template <int C1, int C2>
__device__ __forceinline__ void layer2_z(float (&z)[C2 / 2],
                                         const __nv_bfloat16* y1s,
                                         const __nv_bfloat16* w2s,
                                         const float* sc2, const float* bi2,
                                         int t) {
  static_assert(C2 / 2 <= 64, "one mask bit an element");
  unsigned long long mask = 0;
#pragma unroll
  for (int n = 0; n < C2 / 8; ++n) {
    const int c = wg::frag_col(t, n, 0);
    const float2 sc = *reinterpret_cast<const float2*>(sc2 + c);
    const float2 bi = *reinterpret_cast<const float2*>(bi2 + c);
#pragma unroll
    for (int e = 4 * n; e < 4 * n + 4; ++e) {
      z[e] = bn_z(z[e], e & 1 ? sc.y : sc.x, e & 1 ? bi.y : bi.x);
      if (near_tie(z[e])) mask |= 1ull << e;
    }
  }
  while (mask) {
    const int e = __ffsll((long long)mask) - 1;
    mask &= mask - 1;
    const int r = wg::frag_row(t, (e >> 1) & 1);
    const int c = wg::frag_col(t, e >> 2, e & 1);
    const float v = bn_z(seq_dot<C1, C2>(y1s, w2s, r, c), sc2[c], bi2[c]);
#pragma unroll
    for (int i = 0; i < C2 / 2; ++i)
      if (i == e) z[i] = v;
  }
}

// Dynamic shared memory: the weights and BN rows, then each warpgroup's
// region: two operand tiles (q rows, then y1, then y2), the unit's
// off rows and running max, its row plan (padded row offsets, live
// slots, group -> center), its neighbour slots and, for the ball query,
// its cloud as (x, y, z, |p|^2).
template <int C1, int C2, int C3, int MT>
struct EvalLayout {
  static constexpr int CA = C1 > C2 ? C1 : C2;
  static constexpr size_t w2 = 0;
  static constexpr size_t w3 = w2 + (size_t)C1 * C2 * 2;
  static constexpr size_t st = w3 + (size_t)C2 * C3 * 2;
  static constexpr size_t shared = st + (size_t)2 * (C1 + C2 + C3) * 4;
  static constexpr size_t ys = 0;  // two operand tiles, tiles alternating
  static constexpr size_t off = ys + (size_t)2 * kRows * CA * 2;
  static constexpr size_t outm = off + (size_t)MT * C1 * 4;
  static constexpr size_t rowoff = outm + (size_t)MT * C3 * 4;
  static constexpr size_t live = rowoff + (size_t)(MT + 1) * 4;
  static constexpr size_t gc = live + (size_t)MT * 4;
  __host__ __device__ static size_t nbr(int k) {
    return round_up(gc + ((size_t)MT * ((k + 7) / 8) + 8) * 4, 16);
  }
  __host__ __device__ static size_t cloud(int k) {
    return round_up(nbr(k) + (size_t)MT * k * 4, 16);
  }
  // n = 0 for the given-index kernel
  __host__ __device__ static size_t group_size(int n, int k) {
    return round_up(cloud(k) + (size_t)n * 16, 128);
  }
  __host__ __device__ static size_t bytes(int n, int k) {
    return shared + 2 * group_size(n, k);
  }
  // two blocks an SM at 64-wide layers (128 registers a thread); there a
  // layer-3 chunk of 64 columns, else 128
  static constexpr int min_blocks = C3 <= 128 ? 2 : 1;
  static constexpr int chunk = C3 <= 128 ? 64 : 128;
};

// The kernel body, by every thread of a block of two warpgroups; BQ: the
// ball query inside, else the given idx (and cnt).
template <int C1, int C2, int C3, int MT, bool BQ>
__device__ __forceinline__ void eval_walk(const EvalArgs& a) {
  using L = EvalLayout<C1, C2, C3, MT>;
  constexpr int WT = wg::kWGThreads, NT = 2 * WT;
  constexpr int L3 = L::chunk;
  constexpr int NQ = C1 / 32;   // quads of 8-channel chunks in a row of q
  constexpr int CPT = C1 / 16;  // chunks a thread copies a tile
  constexpr int RGS = 4 / NQ;   // step between a thread's row groups
  static_assert(MT <= 32, "one warp scans the unit's row counts");
  static_assert(C1 % 32 == 0 && C2 % 16 == 0 && C3 % L3 == 0 &&
                    (L3 / 8) % 2 == 0,
                "tile shapes");
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem + L::w2);
  __nv_bfloat16* w3s = reinterpret_cast<__nv_bfloat16*>(smem + L::w3);
  float* sts = reinterpret_cast<float*>(smem + L::st);

  const int n = a.n, m = a.m, k = a.k;
  const int tid = threadIdx.x;
  const int g = tid / WT, t = tid % WT;  // warpgroup, thread in it
  const int bar = 1 + g;                 // its named barrier
  unsigned char* mine = smem + L::shared + g * L::group_size(BQ ? n : 0, k);
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(mine + L::ys);
  __nv_bfloat16* ysb = ys + kRows * L::CA;
  float* offs = reinterpret_cast<float*>(mine + L::off);
  float* outm = reinterpret_cast<float*>(mine + L::outm);
  int* rowoff = reinterpret_cast<int*>(mine + L::rowoff);  // [MT + 1]
  int* live = reinterpret_cast<int*>(mine + L::live);      // [MT]
  int* gc = reinterpret_cast<int*>(mine + L::gc);          // group -> center
  int* nbr = reinterpret_cast<int*>(mine + L::nbr(k));     // [MT, k]
  float4* ptss = reinterpret_cast<float4*>(mine + L::cloud(k));

  stage_w<C1, C2>(a.w2, w2s, NT);
  stage_w<C2, C3>(a.w3, w3s, NT);
  for (int i = tid; i < 2 * (C1 + C2 + C3); i += NT) sts[i] = a.st[i];
  for (int i = t; i < MT * C3; i += WT) outm[i] = 0.0f;
  wg::fence_to_async();
  __syncthreads();
  constexpr int S = C1 + C2 + C3;  // sts: sc of the three layers, then bi
  const float* sc2 = sts + C1;
  const float* bi2 = sc2 + S;
  const float* sc3 = sc2 + C2;
  const float* bi3 = sc3 + S;

  // This thread's share of a tile's q rows: the 8 channels from ch0 of
  // rows 8 * (rg0 + p * RGS) + rr, p < CPT. A warp's copy covers 8 rows
  // x 64 bytes (whole sectors) and its 16-byte stores one core matrix
  // each 8 lanes (no bank conflict).
  const int lane = t & 31, w = t >> 5;
  const int ch0 = 8 * (4 * (w % NQ) + (lane >> 3));
  const int rg0 = w / NQ, rr = lane & 7;
  const int slot = wg::rows8_slot(lane), qd = t & 3;

  // the warpgroup's units: me, me + groups, ... (each from another cloud
  // as a rule, so that dense and sparse clouds share out evenly)
  const int mtiles = (m + MT - 1) / MT;
  const long long units = (long long)a.batch * mtiles;
  const long long groups = (long long)gridDim.x * 2;
  const long long me = (long long)blockIdx.x * 2 + g;
  int staged = -1;  // the cloud in ptss

  for (long long u = me; u < units; u += groups) {
    const int b = (int)(u / mtiles);
    const int m0 = (int)(u % mtiles) * MT;
    const int mt = min(MT, m - m0);
    const size_t c0 = (size_t)b * m + m0;  // the unit's first center

    const float* offg = a.off + c0 * C1;
    for (int i = t; i < mt * C1 / 4; i += WT)
      cp_async16(offs + 4 * i, offg + 4 * i);
    cp_async_commit();
    if (BQ) {
      if (b != staged) {
        stage_cloud(a.pts + (size_t)b * n * 3, n, ptss, t, WT);
        staged = b;
        bar_sync<WT>(bar);
      }
      // one warp a center: the first k hits in index order
      for (int c = w; c < mt; c += WT / 32) {
        const float* ce = a.new_xyz + (c0 + c) * 3;
        int* row = nbr + c * k;
        int count = 0;
        for (int base = 0; base < n && count < k; base += kScanStep)
          count = bq_step(ce[0], ce[1], ce[2], ptss, n, k, a.r2, lane, row,
                          base, count);
        if (lane == 0) {
          if (count == 0) row[0] = 0;  // empty row: one slot at point 0
          live[c] = count == 0 ? 1 : min(count, k);
        }
      }
    } else {
      if (t < mt) live[t] = a.cnt ? max(min(a.cnt[c0 + t], k), 1) : k;
      bar_sync<WT>(bar);
      const int* ig = a.idx + c0 * k;
      for (int e = t; e < mt * k; e += WT)
        if (e % k < live[e / k]) nbr[e] = ig[e];
    }
    bar_sync<WT>(bar);

    // the padded row offsets (one warp: MT <= 32), then group -> center
    if (w == 0) {
      int v = lane < mt ? (live[lane] + 7) & ~7 : 0;
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const int x = __shfl_up_sync(0xffffffffu, v, d);
        if (lane >= d) v += x;
      }
      if (lane < MT) rowoff[lane + 1] = v;
      if (lane == 0) rowoff[0] = 0;
    }
    bar_sync<WT>(bar);
    const int rows = rowoff[mt];
    const int tiles = (rows + kRows - 1) / kRows;
    for (int c = t; c < mt; c += WT)
      for (int gr = rowoff[c] / 8; gr < rowoff[c + 1] / 8; ++gr) gc[gr] = c;
    for (int gr = rows / 8 + t; gr < tiles * (kRows / 8); gr += WT)
      gc[gr] = mt - 1;
    cp_async_wait<0>();
    bar_sync<WT>(bar);

    const __nv_bfloat16* qg = a.q + (size_t)b * n * C1;
    // tile it's operand tile, and its q rows copied into it (this
    // thread's chunks), then turned into y1 in place
    auto tile_ys = [&](int it) { return it & 1 ? ysb : ys; };
    auto gather = [&](int it) {
#pragma unroll
      for (int p = 0; p < CPT; ++p) {
        const int rg = rg0 + p * RGS;
        const int c = gc[it * (kRows / 8) + rg];
        const int j = it * kRows + 8 * rg + rr - rowoff[c];
        const int src = nbr[c * k + (j < live[c] ? j : 0)];
        cp_async16(tile_ys(it) + wg::cm(8 * rg + rr, ch0, C1),
                   qg + (size_t)src * C1 + ch0);
      }
      cp_async_commit();
    };
    auto to_y1 = [&](int it) {
      __nv_bfloat16* y = tile_ys(it);
#pragma unroll
      for (int p = 0; p < CPT; ++p) {
        const int rg = rg0 + p * RGS;
        const int r = 8 * rg + rr;
        const int c = gc[it * (kRows / 8) + rg];
        const uint4 hv = *reinterpret_cast<const uint4*>(y + wg::cm(r, ch0, C1));
        const float4 o0 = *reinterpret_cast<const float4*>(offs + c * C1 + ch0);
        const float4 o1 =
            *reinterpret_cast<const float4*>(offs + c * C1 + ch0 + 4);
        const float4 s0 = *reinterpret_cast<const float4*>(sts + ch0);
        const float4 s4 = *reinterpret_cast<const float4*>(sts + ch0 + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(sts + S + ch0);
        const float4 b4 =
            *reinterpret_cast<const float4*>(sts + S + ch0 + 4);
        const float o[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
        const float s1[8] = {s0.x, s0.y, s0.z, s0.w, s4.x, s4.y, s4.z, s4.w};
        const float b1[8] = {b0.x, b0.y, b0.z, b0.w, b4.x, b4.y, b4.z, b4.w};
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[i] = bn_relu(__fsub_rn(bf_at(hv, i), o[i]), s1[i], b1[i]);
        *reinterpret_cast<uint4*>(y + wg::cm(r, ch0, C1)) = pack8(v);
      }
    };
    gather(0);
    if (tiles > 1) {
      gather(1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    to_y1(0);
    wg::fence_to_async();
    bar_sync<WT>(bar);
    for (int it = 0; it < tiles; ++it) {
      __nv_bfloat16* y = tile_ys(it);  // y1 of tile it

      // layer 2, y2 into the same tile once every warp's share is read
      float z2[C2 / 2];
      wg::product<C2, 0, 1, C1 / 16>(z2, wg::k_major(y, C1, 0, 0),
                                     wg::mn_major(w2s, C2, 0, 0));
      layer2_z<C1, C2>(z2, y, w2s, sc2, bi2, t);
      bar_sync<WT>(bar);
#pragma unroll
      for (int nn = 0; nn < C2 / 8; ++nn) {
        const int c = wg::frag_col(t, nn, 0);
        put2<C2>(y, wg::frag_row(t, 0), c, fmaxf(z2[4 * nn], 0.0f),
                 fmaxf(z2[4 * nn + 1], 0.0f));
        put2<C2>(y, wg::frag_row(t, 1), c, fmaxf(z2[4 * nn + 2], 0.0f),
                 fmaxf(z2[4 * nn + 3], 0.0f));
      }
      wg::fence_to_async();
      bar_sync<WT>(bar);

      // layer 3 by column chunks, each folded into the running max; the
      // fragment's rows of i = 0 / 1 are 8-row group 2w / 2w + 1. While
      // the first chunk's product runs, the next tile's y1 is formed.
      const int cl0 = gc[it * (kRows / 8) + 2 * w];
      const int cl1 = gc[it * (kRows / 8) + 2 * w + 1];
#pragma unroll
      for (int cc = 0; cc < C3; cc += L3) {
        float h3[L3 / 2];
#pragma unroll
        for (int i = 0; i < L3 / 2; ++i) h3[i] = 0.0f;
        wg::fence_regs(h3);
        wg::begin();
        wg::issue<L3, 0, 1, C2 / 16>(h3, wg::k_major(y, C2, 0, 0),
                                     wg::mn_major(w3s, C3, 0, cc));
        wg::commit();
        if (cc == 0 && it + 1 < tiles) {
          cp_async_wait<0>();
          to_y1(it + 1);
        }
        wg::wait<0>();
        wg::fence_regs(h3);
        float pv[8];
#pragma unroll
        for (int nn = 0; nn < L3 / 8; ++nn) {
          const int c0 = cc + wg::frag_col(t, nn, 0);
          const float2 s3 = *reinterpret_cast<const float2*>(sc3 + c0);
          const float2 b3 = *reinterpret_cast<const float2*>(bi3 + c0);
          pv[4 * (nn & 1)] = bn_relu(h3[4 * nn], s3.x, b3.x);
          pv[4 * (nn & 1) + 1] = bn_relu(h3[4 * nn + 1], s3.y, b3.y);
          pv[4 * (nn & 1) + 2] = bn_relu(h3[4 * nn + 2], s3.x, b3.x);
          pv[4 * (nn & 1) + 3] = bn_relu(h3[4 * nn + 3], s3.y, b3.y);
          if (nn & 1) {
            // slot: group nn - 1 + (slot >> 2), row (slot >> 1) & 1,
            // column j = slot & 1
            const float mx = wg::rows8_scatter<true>(pv, lane);
            const int c = cc + 8 * (nn - 1 + (slot >> 2)) + 2 * qd + (slot & 1);
            const int cl = (slot >> 1) & 1 ? cl1 : cl0;
            atomicMax(reinterpret_cast<int*>(outm + cl * C3 + c),
                      __float_as_int(mx));
          }
        }
      }
      // the next tile's y1 is in, and every warp is done with this one's
      // y2: its tile takes the q rows of the tile after next
      wg::fence_to_async();
      bar_sync<WT>(bar);
      if (it + 2 < tiles) gather(it + 2);
    }
    bar_sync<WT>(bar);  // every tile of the unit is folded
    float4* og = reinterpret_cast<float4*>(a.out + c0 * C3);
    float4* om = reinterpret_cast<float4*>(outm);
    for (int i = t; i < mt * C3 / 4; i += WT) {
      og[i] = om[i];
      om[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

// Launches kernel (a block of two warpgroups running eval_walk) on as many
// blocks as fit on the card at once, never more than there are pairs of
// units. Returns cudaErrorInvalidValue where the shared memory exceeds a
// block's.
template <int C1, int C2, int C3, int MT, typename K>
cudaError_t launch_eval(K kernel, const EvalArgs& a, int n_staged,
                        cudaStream_t stream) {
  const size_t smem = EvalLayout<C1, C2, C3, MT>::bytes(n_staged, a.k);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long units = (long long)a.batch * ((a.m + MT - 1) / MT);
  int blocks = 0;
  err = resident_blocks(kernel, smem, (units + 1) / 2, &blocks,
                        2 * wg::kWGThreads);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, 2 * wg::kWGThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The unit (centers a warpgroup's tile) per width triple: what lets two
// blocks share an SM at 64-wide layers and one block fit at 128/128/256.
#define PCL_EVAL_WIDTHS(X) \
  X(32, 32, 64, 32)        \
  X(64, 64, 128, 8)        \
  X(64, 96, 128, 8)        \
  X(128, 128, 256, 8)

}  // namespace pcl
