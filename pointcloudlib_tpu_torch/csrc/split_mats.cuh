// The split-row product of the backward passes 1 (fused_sa_bwd_p1.cu,
// edge2_bwd_p1.cu): mats [I, J] += left^T . right over all rows of two
// bf16 scratch arrays left [rows, I] and right [rows, J], f32 sums.
//
// A [I, J] f32 accumulator does not fit one block's registers, and the
// TPU kernels' sequential grid has no counterpart here, so each block
// owns a 64 x 128 tile of mats for one range of rows, sums 32-row chunks
// staged in shared memory, and adds its tile into mats (zeroed by the
// caller) with one atomicAdd per element. The sums are f32 in another
// order than the plain version's product.

#pragma once

#include "fused_sa_common.cuh"

namespace pcl {

// mats[I, J] += left[r0:r1, I]^T . right[r0:r1, J] for one 64 x 128 tile
// of mats per block (blockIdx.x, blockIdx.y) and one range of rows
// (blockIdx.z). Thread (ig, jg) owns rows ig*4..+4 and columns jg*8..+8.
constexpr int kMI = 64, kMJ = 128, kMR = 32;

template <int I, int J>
__global__ void __launch_bounds__(kThreads)
    p1_mats_kernel(const __nv_bfloat16* left, const __nv_bfloat16* right,
                   float* mats, long long rows, long long per_block) {
  __shared__ __align__(16) __nv_bfloat16 ls[kMR][kMI + 8];
  __shared__ __align__(16) __nv_bfloat16 rs[kMR][kMJ + 8];
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * kMI, j0 = blockIdx.y * kMJ;
  const int ig = tid / 16, jg = tid % 16;
  const long long r0 = blockIdx.z * per_block;
  const long long r1 = min(rows, r0 + per_block);
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;

  for (long long base = r0; base < r1; base += kMR) {
    // 32 rows x 64 left values = 256 uint4; 32 x 128 right = 512 uint4
    {
      const int r = tid / 8, v = tid % 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (base + r < r1 && i0 + v * 8 < I)
        val = *reinterpret_cast<const uint4*>(left + (base + r) * I + i0 +
                                              v * 8);
      *reinterpret_cast<uint4*>(&ls[r][v * 8]) = val;
    }
    for (int e = tid; e < kMR * kMJ / 8; e += kThreads) {
      const int r = e / 16, v = e % 16;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (base + r < r1)
        val = *reinterpret_cast<const uint4*>(right + (base + r) * J + j0 +
                                              v * 8);
      *reinterpret_cast<uint4*>(&rs[r][v * 8]) = val;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kMR; ++r) {
      const uint2 lv = *reinterpret_cast<const uint2*>(&ls[r][ig * 4]);
      const uint4 rv = *reinterpret_cast<const uint4*>(&rs[r][jg * 8]);
      const float l[4] = {bf_lo(lv.x), bf_hi(lv.x), bf_lo(lv.y), bf_hi(lv.y)};
      float w[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) w[c] = bf_at(rv, c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(l[i], w[c], acc[i][c]);
    }
    __syncthreads();
  }
  if (i0 + ig * 4 >= I) return;  // ragged last row of tiles (I % 4 == 0)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      atomicAdd(mats + (size_t)(i0 + ig * 4 + i) * J + j0 + jg * 8 + c,
                acc[i][c]);
}

// Launches the product on enough blocks to fill the card twice over,
// each range of rows a multiple of the 32-row chunk.
template <int I, int J>
cudaError_t launch_mats(const __nv_bfloat16* left, const __nv_bfloat16* right,
                        float* mats, long long rows, cudaStream_t stream) {
  static_assert(I % 8 == 0 && J % kMJ == 0, "mats tiling");
  auto kernel = p1_mats_kernel<I, J>;
  int resident = 0;
  cudaError_t err = resident_blocks(kernel, 0, 1LL << 40, &resident);
  if (err != cudaSuccess) return err;
  constexpr int ITILES = (I + kMI - 1) / kMI;
  const int tiles = ITILES * (J / kMJ);
  long long splits = (2LL * resident + tiles - 1) / tiles;
  long long per_block = (rows + splits - 1) / splits;
  per_block = (per_block + kMR - 1) / kMR * kMR;
  splits = (rows + per_block - 1) / per_block;
  const dim3 grid(ITILES, J / kMJ, (unsigned)splits);
  kernel<<<grid, kThreads, 0, stream>>>(left, right, mats, rows, per_block);
  return cudaGetLastError();
}

}  // namespace pcl
