// Eval-mode fused PointNet++ set abstraction with the ball query inside,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/fused_sa.py
// (fused_sa_bq_eval -> _k_bqeval). Same function, for each center:
//   ball query: the first k source points in index order with
//     d2 = max((|c|^2 - 2 c.p) + |p|^2, 0) < r^2 (the _bq_setup form);
//   for each live slot j < min(cnt, k):
//     h1 = float(bf16 Q[b, idx_j]) - off[b, center]
//     y1 = relu(h1*sc1 + bi1) -> bf16 -> h2 = y1 . W2 (f32 sums)
//     y2 = relu(h2*sc2 + bi2) -> bf16 -> h3 = y2 . W3 (f32 sums)
//     y3 = relu(h3*sc3 + bi3)
//   out = max over live slots of y3; a row with cnt == 0 outputs the
//   chain of Q[b, 0] - off (the XLA path's idx = 0 fallback).
// Slots past cnt replicate slot 0 and cannot change the max, so they are
// skipped, as on the TPU.
//
// What bounds it: the two products over the live slots,
// 2 * sum(min(cnt, k)) * (C1*C2 + C2*C3) flops, against a few tens of MB
// of traffic (q, off, out) — operations, not bytes. This first version
// runs them on the CUDA cores in f32 (each bf16 x bf16 product is exact
// in f32, so an FMA equals the TPU's bf16-operand, f32-accumulate
// product up to summation order); tensor cores are later work. The
// design keeps every intermediate on chip: one block per (cloud, tile of
// MT centers); the cloud's points, W2 and W3 (bf16) and the tile's off
// rows are staged in shared memory once; one warp per center scans the
// cloud 32 points a step and a ballot gives the in-order ranks of the
// first k hits; the tile's live (center, slot) rows are then packed
// densely and run through the chain 64 rows at a time, so a tile pays
// for live slots only; each thread owns a register tile of rows x 8
// channels of each product and folds its rows into a running max per
// center before one shared-memory atomicMax per channel.
//
// Numerics: distances and the BN affines use explicit round-to-nearest
// intrinsics (no FMA contraction), exactly as the plain version's
// separate tensor ops round; only the products' summation order differs
// from the plain version.

#include "fused_sa_common.cuh"

namespace pcl {

struct Args {
  const float* new_xyz;        // [B, M, 3]
  const float* pts;            // [B, N, 3]
  const __nv_bfloat16* q;      // [B, N, C1]
  const float* off;            // [B, M, C1]
  const float* st;             // sc1, bi1 [C1], sc2, bi2 [C2], sc3, bi3 [C3]
  const __nv_bfloat16* w2;     // [C1, C2]
  const __nv_bfloat16* w3;     // [C2, C3]
  float* out;                  // [B, M, C3]
  int n, m, k;
  float r2;
};

template <int C1, int C2, int C3, int MT>
struct Layout {
  static constexpr size_t w2 = 0;
  static constexpr size_t w3 = w2 + (size_t)C1 * C2 * 2;
  static constexpr size_t st = w3 + (size_t)C2 * C3 * 2;
  static constexpr size_t off = st + (size_t)2 * (C1 + C2 + C3) * 4;
  static constexpr size_t outm = off + (size_t)MT * C1 * 4;
  static constexpr size_t y1 = outm + (size_t)MT * C3 * 4;
  static constexpr size_t y2 = y1 + (size_t)kRows * (C1 + 8) * 2;
  static constexpr size_t pts = y2 + (size_t)kRows * (C2 + 8) * 2;
  // + n float4 points, then MT * k int neighbour slots
  static size_t bytes(int n, int k) {
    return pts + (size_t)n * 16 + (size_t)MT * k * 4;
  }
};

template <int C1, int C2, int C3, int MT>
__global__ void __launch_bounds__(kThreads)
    bq_eval_kernel(const Args a) {
  static_assert(MT <= 32, "one warp scans the tile's row counts");
  using L = Layout<C1, C2, C3, MT>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem + L::w2);
  __nv_bfloat16* w3s = reinterpret_cast<__nv_bfloat16*>(smem + L::w3);
  float* sts = reinterpret_cast<float*>(smem + L::st);
  float* offs = reinterpret_cast<float*>(smem + L::off);
  float* outm = reinterpret_cast<float*>(smem + L::outm);
  __nv_bfloat16* y1s = reinterpret_cast<__nv_bfloat16*>(smem + L::y1);
  __nv_bfloat16* y2s = reinterpret_cast<__nv_bfloat16*>(smem + L::y2);
  float4* ptss = reinterpret_cast<float4*>(smem + L::pts);
  int* nbr = reinterpret_cast<int*>(smem + L::pts + (size_t)a.n * 16);
  __shared__ int s_live[MT];
  __shared__ int s_rowoff[MT + 1];
  __shared__ int s_rowc[kRows];
  __shared__ int s_rowsrc[kRows];

  const float* sc1 = sts;
  const float* bi1 = sc1 + C1;
  const float* sc2 = bi1 + C1;
  const float* bi2 = sc2 + C2;
  const float* sc3 = bi2 + C2;
  const float* bi3 = sc3 + C3;

  const int n = a.n, k = a.k;
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * MT;
  const int mt = min(MT, a.m - m0);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  // ---- stage weights, folded BN constants, off rows and the cloud
  for (int i = tid; i < C1 * C2 / 8; i += kThreads)
    reinterpret_cast<uint4*>(w2s)[i] = reinterpret_cast<const uint4*>(a.w2)[i];
  for (int i = tid; i < C2 * C3 / 8; i += kThreads)
    reinterpret_cast<uint4*>(w3s)[i] = reinterpret_cast<const uint4*>(a.w3)[i];
  for (int i = tid; i < 2 * (C1 + C2 + C3); i += kThreads) sts[i] = a.st[i];
  const float* offg = a.off + ((size_t)b * a.m + m0) * C1;
  for (int i = tid; i < mt * C1; i += kThreads) offs[i] = offg[i];
  for (int i = tid; i < MT * C3; i += kThreads) outm[i] = 0.0f;  // y3 >= 0
  const float* pg = a.pts + (size_t)b * n * 3;
  for (int j = tid; j < n; j += kThreads) {
    const float x = pg[3 * j], y = pg[3 * j + 1], z = pg[3 * j + 2];
    const float p2 = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                               __fmul_rn(z, z));
    ptss[j] = make_float4(x, y, z, p2);
  }
  __syncthreads();

  // ---- ball query: one warp per center, 32 source points a step
  for (int c = warp; c < mt; c += kWarps) {
    const float* cg = a.new_xyz + ((size_t)b * a.m + m0 + c) * 3;
    const float cx = cg[0], cy = cg[1], cz = cg[2];
    const float c2 = __fadd_rn(
        __fadd_rn(__fmul_rn(cx, cx), __fmul_rn(cy, cy)), __fmul_rn(cz, cz));
    int count = 0;
    for (int base = 0; base < n && count < k; base += 32) {
      const int j = base + lane;
      bool hit = false;
      if (j < n) {
        const float4 p = ptss[j];
        const float inner = __fadd_rn(
            __fadd_rn(__fmul_rn(cx, p.x), __fmul_rn(cy, p.y)),
            __fmul_rn(cz, p.z));
        const float d2 =
            fmaxf(__fadd_rn(__fsub_rn(c2, __fmul_rn(2.0f, inner)), p.w), 0.0f);
        hit = d2 < a.r2;
      }
      const unsigned bal = __ballot_sync(0xffffffffu, hit);
      const int rank = count + __popc(bal & ((1u << lane) - 1u));
      if (hit && rank < k) nbr[c * k + rank] = j;
      count += __popc(bal);
    }
    if (lane == 0) {
      int live = min(count, k);
      if (live == 0) {  // empty row: one slot at point 0
        nbr[c * k] = 0;
        live = 1;
      }
      s_live[c] = live;
    }
  }
  __syncthreads();

  // ---- dense packing of the tile's live rows
  if (warp == 0) {
    int v = lane < mt ? s_live[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int u = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += u;
    }
    if (lane < MT) s_rowoff[lane + 1] = v;
    if (lane == 0) s_rowoff[0] = 0;
  }
  __syncthreads();
  const int total = s_rowoff[mt];

  using T2 = Tile<C2>;
  using T3 = Tile<C3>;
  const int rg2 = tid / T2::NCG, cg2 = tid % T2::NCG;
  const int rg3 = tid / T3::NCG, cg3 = tid % T3::NCG;
  const __nv_bfloat16* qg = a.q + (size_t)b * n * C1;

  for (int base = 0; base < total; base += kRows) {
    if (tid < kRows) {
      const int g = base + tid;
      int c = -1, src = 0;
      if (g < total) {
        c = 0;
        while (s_rowoff[c + 1] <= g) ++c;
        src = nbr[c * k + (g - s_rowoff[c])];
      }
      s_rowc[tid] = c;
      s_rowsrc[tid] = src;
    }
    __syncthreads();

    // layer 1: gather Q, subtract off, BN, ReLU, round to bf16
    for (int e = tid; e < kRows * (C1 / 2); e += kThreads) {
      const int r = e / (C1 / 2);
      const int cc = (e % (C1 / 2)) * 2;
      const int c = s_rowc[r];
      float v0 = 0.0f, v1 = 0.0f;
      if (c >= 0) {
        const uint32_t qq = *reinterpret_cast<const uint32_t*>(
            qg + (size_t)s_rowsrc[r] * C1 + cc);
        v0 = bn_relu(__fsub_rn(bf_lo(qq), offs[c * C1 + cc]), sc1[cc], bi1[cc]);
        v1 = bn_relu(__fsub_rn(bf_hi(qq), offs[c * C1 + cc + 1]), sc1[cc + 1],
                     bi1[cc + 1]);
      }
      *reinterpret_cast<uint32_t*>(y1s + r * (C1 + 8) + cc) = pack2(v0, v1);
    }
    __syncthreads();

    // layer 2: y2 = bf16(relu(BN(y1 . W2)))
    {
      float acc[T2::RPT][8];
      product<C1, C2>(y1s, w2s, rg2, cg2, acc);
#pragma unroll
      for (int i = 0; i < T2::RPT; ++i) {
        float v[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int ch = cg2 * 8 + c;
          v[c] = bn_relu(acc[i][c], sc2[ch], bi2[ch]);
        }
        uint4 pk;
        pk.x = pack2(v[0], v[1]);
        pk.y = pack2(v[2], v[3]);
        pk.z = pack2(v[4], v[5]);
        pk.w = pack2(v[6], v[7]);
        *reinterpret_cast<uint4*>(y2s + (rg2 * T2::RPT + i) * (C2 + 8) +
                                  cg2 * 8) = pk;
      }
    }
    __syncthreads();

    // layer 3: y3 = relu(BN(y2 . W3)), folded into the per-center max
    {
      float acc[T3::RPT][8];
      product<C2, C3>(y2s, w3s, rg3, cg3, acc);
      int cur = -1;
      float mx[8];
#pragma unroll
      for (int i = 0; i < T3::RPT; ++i) {
        const int c = s_rowc[rg3 * T3::RPT + i];
        if (c != cur) {
          if (cur >= 0) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
              atomicMax(reinterpret_cast<int*>(outm + cur * C3 + cg3 * 8 + j),
                        __float_as_int(mx[j]));
          }
          cur = c;
#pragma unroll
          for (int j = 0; j < 8; ++j) mx[j] = 0.0f;
        }
        if (c >= 0) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int ch = cg3 * 8 + j;
            mx[j] = fmaxf(mx[j], bn_relu(acc[i][j], sc3[ch], bi3[ch]));
          }
        }
      }
      if (cur >= 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          atomicMax(reinterpret_cast<int*>(outm + cur * C3 + cg3 * 8 + j),
                    __float_as_int(mx[j]));
      }
    }
    __syncthreads();
  }

  float* og = a.out + ((size_t)b * a.m + m0) * C3;
  for (int i = tid; i < mt * C3; i += kThreads) og[i] = outm[i];
}

template <int C1, int C2, int C3, int MT>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  const size_t smem = Layout<C1, C2, C3, MT>::bytes(a.n, a.k);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bq_eval_kernel<C1, C2, C3, MT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.m + MT - 1) / MT, batch);
  bq_eval_kernel<C1, C2, C3, MT><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace pcl

// Widths compiled: PointNet++ SSG's SA1 (64/64/128) and SA2
// (128/128/256). Returns the launch's cudaGetLastError() code, or
// cudaErrorInvalidValue for widths or sizes it does not take.
extern "C" int sa_bq_eval_launch(const void* new_xyz, const void* pts,
                                 const void* q, const void* off,
                                 const void* st, const void* w2,
                                 const void* w3, void* out, int batch, int n,
                                 int m, int c1, int c2, int c3, int k,
                                 float r2, void* stream) {
  if (batch < 1 || n < 1 || m < 1 || k < 1) return cudaErrorInvalidValue;
  pcl::Args a;
  a.new_xyz = static_cast<const float*>(new_xyz);
  a.pts = static_cast<const float*>(pts);
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.off = static_cast<const float*>(off);
  a.st = static_cast<const float*>(st);
  a.w2 = static_cast<const __nv_bfloat16*>(w2);
  a.w3 = static_cast<const __nv_bfloat16*>(w3);
  a.out = static_cast<float*>(out);
  a.n = n;
  a.m = m;
  a.k = k;
  a.r2 = r2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c1 == 64 && c2 == 64 && c3 == 128)
    return pcl::launch<64, 64, 128, 32>(a, batch, s);
  if (c1 == 128 && c2 == 128 && c3 == 256)
    return pcl::launch<128, 128, 256, 16>(a, batch, s);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory the launch above needs (0: widths not compiled).
extern "C" long long sa_bq_eval_smem(int n, int c1, int c2, int c3, int k) {
  if (c1 == 64 && c2 == 64 && c3 == 128)
    return (long long)pcl::Layout<64, 64, 128, 32>::bytes(n, k);
  if (c1 == 128 && c2 == 128 && c3 == 256)
    return (long long)pcl::Layout<128, 128, 256, 16>::bytes(n, k);
  return 0;
}
