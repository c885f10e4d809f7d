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
// What bounds it: operations. mats is 2*rows*3*C2*2*C3 flops (206 GFLOP
// at SA1, B=64), which this first version runs on the CUDA cores in f32.
// The TPU kernel keeps mats in VMEM across its sequential grid; here
// blocks run in parallel and a [3*C2, 2*C3] f32 accumulator does not fit
// one block's registers (196,608 values at SA2), so the work is split in
// two kernels: (a) resident blocks walk 64-row tiles,
// recompute the chain from h1 as the forward tails do, reduce the
// per-center max and tie count in shared memory, accumulate ps3 and vecs
// in registers and write left and right as bf16 rows to a scratch the
// caller allocates; (b) the split-row product of split_mats.cuh (each
// block a 64 x 128 tile of mats for one range of rows; the last row of
// tiles may be ragged: 3*96 = 288 rows). All sums are f32 in another
// order than the plain version (atomics across blocks).
//
// A center with k > 64 slots spans k/64 tiles, and its max and tie count
// are known only after the last of them. One block then walks the
// center's tiles twice: a first pass runs the chain and folds (max, tie
// count) of relu(z3) into shared memory (tie_merge), the second runs the
// chain again and does everything else. The even tie split over all k
// slots holds as for k <= 64: every row runs the same instruction
// sequence in both passes.

#include "fused_sa_common.cuh"
#include "split_mats.cuh"

namespace pcl {

struct P1Args {
  const __nv_bfloat16* h1;  // [rows, C1]
  const float* dout;        // [rows / k, C3]
  const float* st;          // [4, C1] ++ [4, C2] ++ [4, C3]
  const __nv_bfloat16* w2;  // [C1, C2]
  const __nv_bfloat16* w3;  // [C2, C3]
  float* ps3;               // [2, C3]
  float* vecs;              // [3 * C2]
  __nv_bfloat16* left;      // [rows, 3 * C2] scratch
  __nv_bfloat16* right;     // [rows, 2 * C3] scratch
  float* mats;              // [3 * C2, 2 * C3]
  long long rows;
  int k;
};

template <int C1, int C2, int C3>
struct P1Layout {
  static constexpr size_t w2 = 0;
  static constexpr size_t w3 = w2 + (size_t)C1 * C2 * 2;
  static constexpr size_t st = w3 + (size_t)C2 * C3 * 2;
  static constexpr size_t y1 = st + (size_t)4 * (C1 + C2 + C3) * 4;
  static constexpr size_t y2 = y1 + (size_t)kRows * (C1 + 8) * 2;
  static constexpr size_t mx = y2 + (size_t)kRows * (C2 + 8) * 2;
  static constexpr size_t ts = mx + (size_t)(kRows / 8) * C3 * 4;
  static constexpr size_t red = ts + (size_t)(kRows / 8) * C3 * 4;
  static constexpr size_t bytes = red + (size_t)(C2 > C3 ? C2 : C3) * 4;
};

template <int C1, int C2, int C3>
__global__ void __launch_bounds__(kThreads) p1_rows_kernel(const P1Args a) {
  using L = P1Layout<C1, C2, C3>;
  using T2 = Tile<C2>;
  using T3 = Tile<C3>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem + L::w2);
  __nv_bfloat16* w3s = reinterpret_cast<__nv_bfloat16*>(smem + L::w3);
  float* sts = reinterpret_cast<float*>(smem + L::st);
  __nv_bfloat16* y1s = reinterpret_cast<__nv_bfloat16*>(smem + L::y1);
  __nv_bfloat16* y2s = reinterpret_cast<__nv_bfloat16*>(smem + L::y2);
  float* mx = reinterpret_cast<float*>(smem + L::mx);
  int* ts = reinterpret_cast<int*>(smem + L::ts);
  float* red = reinterpret_cast<float*>(smem + L::red);

  const int tid = threadIdx.x;
  for (int i = tid; i < C1 * C2 / 8; i += kThreads)
    reinterpret_cast<uint4*>(w2s)[i] = reinterpret_cast<const uint4*>(a.w2)[i];
  for (int i = tid; i < C2 * C3 / 8; i += kThreads)
    reinterpret_cast<uint4*>(w3s)[i] = reinterpret_cast<const uint4*>(a.w3)[i];
  for (int i = tid; i < 4 * (C1 + C2 + C3); i += kThreads) sts[i] = a.st[i];
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

  static_assert(T3::ACTIVE == kThreads, "every thread owns a tile of h3");
  const bool act2 = T2::active();
  const int rg2 = tid / T2::NCG, cg2 = tid % T2::NCG;
  const int rg3 = tid / T3::NCG, cg3 = tid % T3::NCG;
  const int k = a.k;
  const int tpc = tiles_per_center(k);
  const int cl3 = rg3 * T3::RPT / k;  // this thread's center in a tile
  unsigned long long* mc = reinterpret_cast<unsigned long long*>(mx);
  float vy[8], vm[8], vx[8], s3[8], ss3[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) vy[c] = vm[c] = vx[c] = s3[c] = ss3[c] = 0.0f;

  // a unit: one tile of whole centers, or the tiles of one center
  const long long units = a.rows / ((long long)kRows * tpc);
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    for (int i = tid; i < (kRows / 8) * C3; i += kThreads) {
      mx[i] = 0.0f;
      ts[i] = 0;
    }
    // pass 0 (only when a center spans several tiles) folds the center's
    // max and tie count; pass 1 does the work
    for (int pass = tpc > 1 ? 0 : 1; pass < 2; ++pass)
      for (int sub = 0; sub < tpc; ++sub) {
        const size_t row0 = ((size_t)u * tpc + sub) * kRows;
        load_y1<C1>(a.h1, row0, sc1, bi1, y1s);
        __syncthreads();

        // layer 2: left = [y2 | m2 | m2*x2], y2 to shared memory for layer 3
        if (act2) {
          float acc2[T2::RPT][8];
          product<C1, C2>(y1s, w2s, rg2, cg2, acc2);
#pragma unroll
          for (int i = 0; i < T2::RPT; ++i) {
            const int r = rg2 * T2::RPT + i;
            float y[8], m[8], x[8];
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const int ch = cg2 * 8 + c;
              const float z = bn_z(acc2[i][c], sc2[ch], bi2[ch]);
              y[c] = fmaxf(z, 0.0f);
              m[c] = z > 0.0f ? 1.0f : 0.0f;
              x[c] = __fmul_rn(m[c], xhat(acc2[i][c], rs2[ch], mrs2[ch]));
            }
            const uint4 yb = pack8(y);
            *reinterpret_cast<uint4*>(y2s + r * (C2 + 8) + cg2 * 8) = yb;
            if (pass == 0) continue;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              vy[c] += y[c];
              vm[c] += m[c];
              vx[c] += x[c];
            }
            __nv_bfloat16* lg = a.left + (row0 + r) * (3 * C2) + cg2 * 8;
            *reinterpret_cast<uint4*>(lg) = yb;
            *reinterpret_cast<uint4*>(lg + C2) = pack8(m);
            *reinterpret_cast<uint4*>(lg + 2 * C2) = pack8(x);
          }
        }
        __syncthreads();

        // layer 3 and the max-pool gradient: right = [dz3 | x3]
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
          merged_dz<T3::RPT>(dz3, dout_row, cg3, mc);  // z3 -> dz3
#pragma unroll
        for (int i = 0; i < T3::RPT; ++i) {
          const int r = rg3 * T3::RPT + i;
          float x[8];
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int ch = cg3 * 8 + c;
            x[c] = xhat(acc3[i][c], rs3[ch], mrs3[ch]);
            s3[c] += dz3[i][c];
            ss3[c] += dz3[i][c] * x[c];
          }
          __nv_bfloat16* rgp = a.right + (row0 + r) * (2 * C3) + cg3 * 8;
          *reinterpret_cast<uint4*>(rgp) = pack8(dz3[i]);
          *reinterpret_cast<uint4*>(rgp + C3) = pack8(x);
        }
        __syncthreads();
      }
  }
  flush_sum<C3>(s3, cg3, red, a.ps3);
  flush_sum<C3>(ss3, cg3, red, a.ps3 + C3);
  flush_sum<C2>(vy, cg2, red, a.vecs, act2);
  flush_sum<C2>(vm, cg2, red, a.vecs + C2, act2);
  flush_sum<C2>(vx, cg2, red, a.vecs + 2 * C2, act2);
}

template <int C1, int C2, int C3>
cudaError_t launch_p1(const P1Args& a, cudaStream_t stream) {
  constexpr size_t smem = P1Layout<C1, C2, C3>::bytes;
  static_assert(smem <= 227 * 1024, "shared memory of one block");
  auto rows_kernel = p1_rows_kernel<C1, C2, C3>;
  cudaError_t err = cudaFuncSetAttribute(
      rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = resident_blocks(
      rows_kernel, smem,
      a.rows / ((long long)kRows * tiles_per_center(a.k)), &blocks);
  if (err != cudaSuccess) return err;
  rows_kernel<<<blocks, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  return launch_mats<3 * C2, 2 * C3>(a.left, a.right, a.mats, a.rows,
                                     stream);
}

}  // namespace pcl

// Widths compiled: (32, 32, 64), (64, 64, 128), (64, 96, 128) and
// (128, 128, 256). k is 8, 16, 32 or a multiple of 64, and rows = B*M*k a
// multiple of 64. ps3, vecs and mats are zeroed by the caller; left and right are scratch of rows*3*C2 and
// rows*2*C3 bf16. Returns cudaGetLastError() of the launches.
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
