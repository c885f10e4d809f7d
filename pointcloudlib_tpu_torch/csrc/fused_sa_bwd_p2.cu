// Train-mode fused set abstraction, backward pass 2, for Hopper (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/fused_sa.py
// (_call_p2 -> _k_p2). With the BN sums of layers 3 and 2 known (us3, us2:
// [sum dz, sum dz*x^] / R from pass 1), per grouped row of h1:
//   dz3  = max-pool gradient (even tie split over all k slots) * (z3 > 0)
//   dh3  = sc3 * ((dz3 - us3[0]) - x3 * us3[1])
//   dz2  = (z2 > 0) ? bf16(dh3) . bf16 W3^T : 0
//   dh2  = sc2 * ((dz2 - us2[0]) - x2 * us2[1])
//   dz1  = (z1 > 0) ? bf16(dh2) . bf16 W2^T : 0,  x1 = h1*rs1 - mrs1
// and writes or adds:
//   dw2  [C1, C2]      += bf16(y1)^T . bf16(dh2)
//   ps1  [2, C1]       += [sum dz1, sum dz1*x1]
//   scat [B, N, 2C1+1] += [bf16 dz1 | bf16 x1 | 1] at the row's source
//                         point idx (the TPU's transposed one-hot matmul)
//   d1, d2 [B*M, C1]    = sum over the center's k slots of dz1, x1
// dw2, ps1 and scat are zeroed by the caller.
//
// What bounds it: operations (the recomputed chain and the three
// products of the backward, ~120 GFLOP at SA1 with B=64, on the CUDA
// cores in f32 in this first version), then the scatter: one f32
// atomicAdd per row and channel into an L2-resident [B, N, 2C1+1].
// Resident blocks walk 64-row tiles of whole centers (k divides 64), so
// the max-pool ties and d1/d2 are reduced in shared memory. A center with
// k > 64 slots (k a multiple of 64) spans k/64 tiles that one block walks
// twice: a first pass runs the forward chain and folds the center's max
// and tie count (tie_merge), the second runs everything, with d1/d2
// summed in shared memory across the center's tiles. W2 and W3
// sit in shared memory as bf16, their transposes are read from global
// memory (L1/L2) to stay within one block's 227 KB at SA2. dw2 and the
// ps1 sums stay in registers until one atomicAdd per element and block.
// Sums are f32 in another order than the plain version.

#include "fused_sa_common.cuh"

namespace pcl {

struct P2Args {
  const __nv_bfloat16* h1;   // [rows, C1]
  const float* dout;         // [rows / k, C3]
  const int* idx;            // [rows]
  const float* st;           // [4, C1] ++ [4, C2] ++ [4, C3]
  const float* us;           // us3 [2, C3] ++ us2 [2, C2]
  const __nv_bfloat16* w2;   // [C1, C2]
  const __nv_bfloat16* w3;   // [C2, C3]
  const __nv_bfloat16* wt2;  // [C2, C1]
  const __nv_bfloat16* wt3;  // [C3, C2]
  float* dw2;                // [C1, C2]
  float* ps1;                // [2, C1]
  float* scat;               // [B, N, 2*C1 + 1]
  float* d1;                 // [rows / k, C1]
  float* d2;                 // [rows / k, C1]
  long long rows;
  int n;                     // source points per cloud
  int mk;                    // grouped rows per cloud, M*k
  int k;
};

template <int C1, int C2, int C3>
struct P2Layout {
  static constexpr size_t w2 = 0;
  static constexpr size_t w3 = w2 + (size_t)C1 * C2 * 2;
  static constexpr size_t st = w3 + (size_t)C2 * C3 * 2;
  static constexpr size_t us = st + (size_t)4 * (C1 + C2 + C3) * 4;
  static constexpr size_t y1 = us + (size_t)2 * (C2 + C3) * 4;
  static constexpr size_t y2 = y1 + (size_t)kRows * (C1 + 8) * 2;
  static constexpr size_t dh3 = y2 + (size_t)kRows * (C2 + 8) * 2;
  static constexpr size_t mx = dh3 + (size_t)kRows * (C3 + 8) * 2;
  static constexpr size_t ts = mx + (size_t)(kRows / 8) * C3 * 4;
  static constexpr size_t d1 = ts + (size_t)(kRows / 8) * C3 * 4;
  static constexpr size_t d2 = d1 + (size_t)(kRows / 8) * C1 * 4;
  static constexpr size_t red = d2 + (size_t)(kRows / 8) * C1 * 4;
  static constexpr size_t bytes = red + (size_t)C1 * 4;
};

template <int C1, int C2, int C3>
__global__ void __launch_bounds__(kThreads) p2_kernel(const P2Args a) {
  using L = P2Layout<C1, C2, C3>;
  using T1 = Tile<C1>;
  using T2 = Tile<C2>;
  using T3 = Tile<C3>;
  // dw2 ownership: thread (igw, cgw) owns rows igw*RI..+RI, channels cgw*8..+8
  // (the first NCGW*NIGW threads; the rest own no part of dw2)
  constexpr int NCGW = C2 / 8;
  constexpr int NIGW =
      pow2_floor(kThreads / NCGW) < C1 ? pow2_floor(kThreads / NCGW) : C1;
  constexpr int RI = C1 / NIGW;
  static_assert(C1 % NIGW == 0 && NCGW * NIGW <= kThreads, "dw2 tiling");
  static_assert(T1::ACTIVE == kThreads && T3::ACTIVE == kThreads,
                "every thread owns a tile of h1 and of h3");

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem + L::w2);
  __nv_bfloat16* w3s = reinterpret_cast<__nv_bfloat16*>(smem + L::w3);
  float* sts = reinterpret_cast<float*>(smem + L::st);
  float* uss = reinterpret_cast<float*>(smem + L::us);
  __nv_bfloat16* y1s = reinterpret_cast<__nv_bfloat16*>(smem + L::y1);
  __nv_bfloat16* y2s = reinterpret_cast<__nv_bfloat16*>(smem + L::y2);
  __nv_bfloat16* dh3s = reinterpret_cast<__nv_bfloat16*>(smem + L::dh3);
  float* mx = reinterpret_cast<float*>(smem + L::mx);
  int* ts = reinterpret_cast<int*>(smem + L::ts);
  float* d1s = reinterpret_cast<float*>(smem + L::d1);
  float* d2s = reinterpret_cast<float*>(smem + L::d2);
  float* red = reinterpret_cast<float*>(smem + L::red);

  const int tid = threadIdx.x;
  for (int i = tid; i < C1 * C2 / 8; i += kThreads)
    reinterpret_cast<uint4*>(w2s)[i] = reinterpret_cast<const uint4*>(a.w2)[i];
  for (int i = tid; i < C2 * C3 / 8; i += kThreads)
    reinterpret_cast<uint4*>(w3s)[i] = reinterpret_cast<const uint4*>(a.w3)[i];
  for (int i = tid; i < 4 * (C1 + C2 + C3); i += kThreads) sts[i] = a.st[i];
  for (int i = tid; i < 2 * (C2 + C3); i += kThreads) uss[i] = a.us[i];
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
  const float* u31 = uss;
  const float* u32 = uss + C3;
  const float* u21 = uss + 2 * C3;
  const float* u22 = u21 + C2;

  const int rg1 = tid / T1::NCG, cg1 = tid % T1::NCG;
  const int rg2 = tid / T2::NCG, cg2 = tid % T2::NCG;
  const int rg3 = tid / T3::NCG, cg3 = tid % T3::NCG;
  const int igw = tid / NCGW, cgw = tid % NCGW;
  const bool act2 = T2::active();
  const bool actw = tid < NCGW * NIGW;
  const int k = a.k;
  const int cpt = centers_per_tile(k);
  const int tpc = tiles_per_center(k);
  const int cl1 = rg1 * T1::RPT / k;
  const int cl3 = rg3 * T3::RPT / k;
  constexpr int SW = 2 * C1 + 1;  // scat row width
  unsigned long long* mc = reinterpret_cast<unsigned long long*>(mx);

  float dw[RI][8], s1[8], ss1[8];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) dw[i][c] = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) s1[c] = ss1[c] = 0.0f;

  // a unit: one tile of whole centers, or the tiles of one center
  const long long units = a.rows / ((long long)kRows * tpc);
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    for (int i = tid; i < (kRows / 8) * C3; i += kThreads) {
      mx[i] = 0.0f;
      ts[i] = 0;
    }
    for (int i = tid; i < (kRows / 8) * C1; i += kThreads)
      d1s[i] = d2s[i] = 0.0f;
    // pass 0 (only when a center spans several tiles) folds the center's
    // max and tie count; pass 1 does the work
    for (int pass = tpc > 1 ? 0 : 1; pass < 2; ++pass)
      for (int sub = 0; sub < tpc; ++sub) {
        const size_t row0 = ((size_t)u * tpc + sub) * kRows;
        load_y1<C1>(a.h1, row0, sc1, bi1, y1s);
        __syncthreads();

        // forward recompute: h2 stays in registers, y2 goes to shared memory
        float acc2[T2::RPT][8];
        if (act2) {
          product<C1, C2>(y1s, w2s, rg2, cg2, acc2);
          store_bn_relu<C2>(acc2, sc2, bi2, y2s, rg2, cg2);
        }
        __syncthreads();
        float acc3[T3::RPT][8], dz3[T3::RPT][8];
        product<C2, C3>(y2s, w3s, rg3, cg3, acc3);
#pragma unroll
        for (int i = 0; i < T3::RPT; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            dz3[i][c] = bn_z(acc3[i][c], sc3[cg3 * 8 + c], bi3[cg3 * 8 + c]);
        if (pass == 0) {
          tie_merge<T3::RPT>(dz3, cg3, mc);
          __syncthreads();
          continue;
        }
        const float* dout_row = a.dout + (row0 / k + cl3) * C3;
        if (tpc == 1)
          maxpool_dz<T3::RPT, C3>(dz3, dout_row, cl3, cg3, mx, ts);
        else
          merged_dz<T3::RPT>(dz3, dout_row, cg3, mc);

        // dh3 -> bf16 in shared memory
#pragma unroll
        for (int i = 0; i < T3::RPT; ++i) {
          float v[8];
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int ch = cg3 * 8 + c;
            v[c] = bn_bwd(dz3[i][c], xhat(acc3[i][c], rs3[ch], mrs3[ch]),
                          sc3[ch], u31[ch], u32[ch]);
          }
          *reinterpret_cast<uint4*>(dh3s + (rg3 * T3::RPT + i) * (C3 + 8) +
                                    cg3 * 8) = pack8(v);
        }
        __syncthreads();

        // dh2 = BN2 backward of (z2 > 0) * (dh3 . W3^T) -> bf16 over y2s
        if (act2) {
          float dy2[T2::RPT][8];
          product<C3, C2>(dh3s, a.wt3, rg2, cg2, dy2);
#pragma unroll
          for (int i = 0; i < T2::RPT; ++i) {
            float v[8];
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const int ch = cg2 * 8 + c;
              const float z2 = bn_z(acc2[i][c], sc2[ch], bi2[ch]);
              const float dz2 = z2 > 0.0f ? dy2[i][c] : 0.0f;
              v[c] = bn_bwd(dz2, xhat(acc2[i][c], rs2[ch], mrs2[ch]), sc2[ch],
                            u21[ch], u22[ch]);
            }
            *reinterpret_cast<uint4*>(y2s + (rg2 * T2::RPT + i) * (C2 + 8) +
                                      cg2 * 8) = pack8(v);
          }
        }
        __syncthreads();
        const __nv_bfloat16* dh2s = y2s;

        // dw2 += bf16(y1)^T . bf16(dh2) over the tile's rows
        if (actw) {
#pragma unroll 4
          for (int r = 0; r < kRows; ++r) {
            const uint4 dv =
                *reinterpret_cast<const uint4*>(dh2s + r * (C2 + 8) + cgw * 8);
            float d[8];
#pragma unroll
            for (int c = 0; c < 8; ++c) d[c] = bf_at(dv, c);
#pragma unroll
            for (int i = 0; i < RI; ++i) {
              const float y =
                  __bfloat162float(y1s[r * (C1 + 8) + igw * RI + i]);
#pragma unroll
              for (int c = 0; c < 8; ++c) dw[i][c] = fmaf(y, d[c], dw[i][c]);
            }
          }
        }

        // dz1 = (z1 > 0) * (dh2 . W2^T); sums, per-center sums, scatter
        {
          float dy1[T1::RPT][8];
          product<C2, C1>(dh2s, a.wt2, rg1, cg1, dy1);
          float dsum[8], xsum[8];
#pragma unroll
          for (int c = 0; c < 8; ++c) dsum[c] = xsum[c] = 0.0f;
#pragma unroll
          for (int i = 0; i < T1::RPT; ++i) {
            const size_t row = row0 + rg1 * T1::RPT + i;
            const uint4 hv =
                *reinterpret_cast<const uint4*>(a.h1 + row * C1 + cg1 * 8);
            const size_t cloud = row / a.mk;
            float* dst = a.scat + (cloud * a.n + a.idx[row]) * SW;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const int ch = cg1 * 8 + c;
              const float h = bf_at(hv, c);
              const float z1 = bn_z(h, sc1[ch], bi1[ch]);
              const float dz1 = z1 > 0.0f ? dy1[i][c] : 0.0f;
              const float x1 = xhat(h, rs1[ch], mrs1[ch]);
              s1[c] += dz1;
              ss1[c] += dz1 * x1;
              dsum[c] += dz1;
              xsum[c] += x1;
              atomicAdd(dst + ch, bf_round(dz1));
              atomicAdd(dst + C1 + ch, bf_round(x1));
            }
            if (cg1 == 0) atomicAdd(dst + 2 * C1, 1.0f);
          }
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            atomicAdd(d1s + cl1 * C1 + cg1 * 8 + c, dsum[c]);
            atomicAdd(d2s + cl1 * C1 + cg1 * 8 + c, xsum[c]);
          }
        }
        __syncthreads();
        if (sub == tpc - 1) {  // the unit's centers are complete
          float* d1g = a.d1 + (row0 / k) * C1;
          float* d2g = a.d2 + (row0 / k) * C1;
          for (int i = tid; i < cpt * C1; i += kThreads) {
            d1g[i] = d1s[i];
            d2g[i] = d2s[i];
          }
          __syncthreads();
        }
      }
  }

  flush_sum<C1>(s1, cg1, red, a.ps1);
  flush_sum<C1>(ss1, cg1, red, a.ps1 + C1);
  if (actw) {
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        atomicAdd(a.dw2 + (igw * RI + i) * C2 + cgw * 8 + c, dw[i][c]);
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
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace pcl

// Widths compiled: (32, 32, 64), (64, 64, 128), (64, 96, 128) and
// (128, 128, 256). k is 8, 16, 32 or a multiple of 64, and rows = B*M*k a
// multiple of 64. Returns cudaGetLastError() of the launch.
extern "C" int sa_bwd_p2_launch(const void* h1, const void* dout,
                                const void* idx, const void* st,
                                const void* us, const void* w2,
                                const void* w3, const void* wt2,
                                const void* wt3, void* dw2, void* ps1,
                                void* scat, void* d1, void* d2,
                                long long rows, int n, int mk, int k, int c1,
                                int c2, int c3, void* stream) {
  if (rows < 1 || !pcl::k_ok(k) || rows % pcl::kRows || rows % k || n < 1 ||
      mk < 1 || mk % k)
    return cudaErrorInvalidValue;
  pcl::P2Args a;
  a.h1 = static_cast<const __nv_bfloat16*>(h1);
  a.dout = static_cast<const float*>(dout);
  a.idx = static_cast<const int*>(idx);
  a.st = static_cast<const float*>(st);
  a.us = static_cast<const float*>(us);
  a.w2 = static_cast<const __nv_bfloat16*>(w2);
  a.w3 = static_cast<const __nv_bfloat16*>(w3);
  a.wt2 = static_cast<const __nv_bfloat16*>(wt2);
  a.wt3 = static_cast<const __nv_bfloat16*>(wt3);
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
