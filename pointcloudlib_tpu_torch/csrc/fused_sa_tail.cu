// Train-mode fused set abstraction, the forward tails, for Hopper
// (sm_90a): one kernel templated on its stage.
//
// Replaces the TPU kernels pointcloudlib_tpu/ops/pallas/fused_sa.py
//   stage 2: _call_stats2 -> _k_stats2: [sum h2, sum h2^2]
//   stage 3: _call_stats3 -> _k_stats3: [sum h3, sum h3^2]
//   stage 4: _call_out    -> _k_out:    out = max_k relu(BN3(h3))
// where, from the bf16 checkpoint h1 [B*M*k, C1] and the folded BN rows
// (sc, bi, rs, mrs) of the layers already known:
//   y1 = bf16(relu(h1*sc1 + bi1)), h2 = y1 . bf16 W2 (f32 sums)
//   y2 = bf16(relu(h2*sc2 + bi2)), h3 = y2 . bf16 W3 (f32 sums)
// Every grouped row counts, repeat-first replicas included.
//
// What bounds it: bytes at stage 2 (the h1 read, 268 MB at SA1; its
// product is 2*C1*C2 flops a row), the products at stages 3 and 4 on
// this first version's CUDA cores. Each stage recomputes the chain from
// h1 in shared memory and registers and writes nothing but its sums or
// the pooled rows. Blocks stay resident (as many as fit) and walk
// 64-row tiles; W2 and W3 are staged once per block as bf16. A tile
// holds 64/k whole centers when k divides 64; when k is a multiple of 64
// a block walks the k/64 consecutive tiles of one center and keeps its
// running max in shared memory between them. Either way the max needs no
// traffic between blocks; the sums reach global memory once per block
// and channel (atomicAdd: f32 in another order than the plain version,
// within 1e-3 relative).

#include "fused_sa_common.cuh"

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

template <int C1, int C2, int C3>
struct TailLayout {
  static constexpr size_t w2 = 0;
  static constexpr size_t w3 = w2 + (size_t)C1 * C2 * 2;
  static constexpr size_t st = w3 + (size_t)C2 * C3 * 2;
  static constexpr size_t y1 = st + (size_t)4 * (C1 + C2 + C3) * 4;
  static constexpr size_t y2 = y1 + (size_t)kRows * (C1 + 8) * 2;
  static constexpr size_t outm = y2 + (size_t)kRows * (C2 + 8) * 2;
  static constexpr size_t red = outm + (size_t)(kRows / 8) * C3 * 4;
  static constexpr size_t bytes = red + (size_t)(C2 > C3 ? C2 : C3) * 4;
};

template <int C1, int C2, int C3, int STAGE>
__global__ void __launch_bounds__(kThreads) tail_kernel(const TailArgs a) {
  using L = TailLayout<C1, C2, C3>;
  using T2 = Tile<C2>;
  using T3 = Tile<C3>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem + L::w2);
  __nv_bfloat16* w3s = reinterpret_cast<__nv_bfloat16*>(smem + L::w3);
  float* sts = reinterpret_cast<float*>(smem + L::st);
  __nv_bfloat16* y1s = reinterpret_cast<__nv_bfloat16*>(smem + L::y1);
  __nv_bfloat16* y2s = reinterpret_cast<__nv_bfloat16*>(smem + L::y2);
  float* outm = reinterpret_cast<float*>(smem + L::outm);
  float* red = reinterpret_cast<float*>(smem + L::red);

  const int tid = threadIdx.x;
  for (int i = tid; i < C1 * C2 / 8; i += kThreads)
    reinterpret_cast<uint4*>(w2s)[i] = reinterpret_cast<const uint4*>(a.w2)[i];
  if (STAGE >= 3)
    for (int i = tid; i < C2 * C3 / 8; i += kThreads)
      reinterpret_cast<uint4*>(w3s)[i] =
          reinterpret_cast<const uint4*>(a.w3)[i];
  for (int i = tid; i < 4 * (C1 + C2 + C3); i += kThreads) sts[i] = a.st[i];
  for (int i = tid; i < (kRows / 8) * C3; i += kThreads) outm[i] = 0.0f;
  __syncthreads();
  const float* sc1 = sts;
  const float* bi1 = sc1 + C1;
  const float* sc2 = sts + 4 * C1;
  const float* bi2 = sc2 + C2;
  const float* sc3 = sts + 4 * (C1 + C2);
  const float* bi3 = sc3 + C3;

  static_assert(T3::ACTIVE == kThreads, "every thread owns a tile of h3");
  const bool act2 = T2::active();
  const int rg2 = tid / T2::NCG, cg2 = tid % T2::NCG;
  const int rg3 = tid / T3::NCG, cg3 = tid % T3::NCG;
  const int k = a.k;
  const int cpt = centers_per_tile(k);
  const int tpc = tiles_per_center(k);
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
      if (STAGE == 2) {
        if (act2) {
#pragma unroll
          for (int i = 0; i < T2::RPT; ++i)
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              s[c] += acc2[i][c];
              ss[c] += acc2[i][c] * acc2[i][c];
            }
        }
      } else {
        if (act2) store_bn_relu<C2>(acc2, sc2, bi2, y2s, rg2, cg2);
        __syncthreads();
        float acc3[T3::RPT][8];
        product<C2, C3>(y2s, w3s, rg3, cg3, acc3);
        if (STAGE == 3) {
#pragma unroll
          for (int i = 0; i < T3::RPT; ++i)
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              s[c] += acc3[i][c];
              ss[c] += acc3[i][c] * acc3[i][c];
            }
        } else {
          // this thread's RPT rows lie in one center (RPT divides 8 | k)
          const int cl = rg3 * T3::RPT / k;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int ch = cg3 * 8 + c;
            float mx = 0.0f;
#pragma unroll
            for (int i = 0; i < T3::RPT; ++i)
              mx = fmaxf(mx, bn_relu(acc3[i][c], sc3[ch], bi3[ch]));
            atomicMax(reinterpret_cast<int*>(outm + cl * C3 + ch),
                      __float_as_int(mx));
          }
          if (sub == tpc - 1) {  // the unit's centers are complete
            __syncthreads();
            float* og = a.out + (size_t)(row0 / k) * C3;
            for (int i = tid; i < cpt * C3; i += kThreads) {
              og[i] = outm[i];
              outm[i] = 0.0f;
            }
          }
        }
      }
      __syncthreads();
    }
  if (STAGE == 2) {
    flush_sum<C2>(s, cg2, red, a.out, act2);
    flush_sum<C2>(ss, cg2, red, a.out + C2, act2);
  } else if (STAGE == 3) {
    flush_sum<C3>(s, cg3, red, a.out);
    flush_sum<C3>(ss, cg3, red, a.out + C3);
  }
}

template <int C1, int C2, int C3, int STAGE>
cudaError_t launch_tail(const TailArgs& a, cudaStream_t stream) {
  constexpr size_t smem = TailLayout<C1, C2, C3>::bytes;
  static_assert(smem <= 227 * 1024, "shared memory of one block");
  auto kernel = tail_kernel<C1, C2, C3, STAGE>;
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

template <int C1, int C2, int C3>
cudaError_t launch_stage(int stage, const TailArgs& a, cudaStream_t s) {
  if (stage == 2) return launch_tail<C1, C2, C3, 2>(a, s);
  if (stage == 3) return launch_tail<C1, C2, C3, 3>(a, s);
  if (stage == 4) return launch_tail<C1, C2, C3, 4>(a, s);
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
