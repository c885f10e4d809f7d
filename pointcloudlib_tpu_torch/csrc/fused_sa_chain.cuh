// The forward chain of the train-mode set abstraction on Hopper's tensor
// cores (sm_90a), shared by the forward tails (fused_sa_tail.cu) and the
// backward passes (fused_sa_bwd.cuh): the next h1 tile copied ahead by
// cp.async, the weights and y1 = bf16(relu(BN1(h1))) staged in the
// core-matrix layout of wgmma_tile.cuh, and one warpgroup's layer 2,
// h2 = y1 . W2 over all C2 columns, with y2 = bf16(relu(BN2(h2))) stored
// from the accumulator fragment straight into y2's core-matrix image.
// The functions that split a tile's rows or channels among threads take
// the number of threads that share the tile (NT) and the caller's index
// among them.

#pragma once

#include "fused_sa_common.cuh"
#include "wgmma_tile.cuh"

namespace pcl {

// Barrier of the NT threads that meet at named barrier id (0 is
// __syncthreads).
template <int NT>
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(NT) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts copying the kRows x C1 tile of h1 at row0 into raw (row-major,
// shared memory), by thread pt of NT.
template <int C1, int NT>
__device__ __forceinline__ void prefetch_h1(const __nv_bfloat16* h1,
                                            size_t row0, __nv_bfloat16* raw,
                                            int pt) {
  const __nv_bfloat16* src = h1 + row0 * C1;
  for (int e = pt; e < kRows * C1 / 8; e += NT)
    cp_async16(raw + e * 8, src + e * 8);
}

// Copies W [R, C] (row-major bf16, global) into a core-matrix tile, by
// every thread of a block of nthreads.
template <int R, int C>
__device__ __forceinline__ void stage_w(const __nv_bfloat16* w,
                                        __nv_bfloat16* ws, int nthreads) {
  for (int e = threadIdx.x; e < R * C / 8; e += nthreads) {
    const int r = e / (C / 8), c = (e % (C / 8)) * 8;
    *reinterpret_cast<uint4*>(ws + wg::cm(r, c, C)) =
        *reinterpret_cast<const uint4*>(w + (size_t)r * C + c);
  }
}

// The kRows x C1 tile of h1 (row-major, src: the tile in global memory
// or its prefetched copy) into shared memory in the core-matrix layout:
// y1 = bf16(relu(BN1(h1))) and, where h1s is not null, h1 itself; by
// thread pt of NT.
template <int C1, int NT>
__device__ __forceinline__ void stage_h1(const __nv_bfloat16* src,
                                         const float* sc1, const float* bi1,
                                         __nv_bfloat16* y1s,
                                         __nv_bfloat16* h1s, int pt) {
  for (int e = pt; e < kRows * (C1 / 8); e += NT) {
    const int r = e / (C1 / 8);
    const int c = (e % (C1 / 8)) * 8;
    const uint4 hv = *reinterpret_cast<const uint4*>(src + (size_t)r * C1 + c);
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = bn_relu(bf_at(hv, i), sc1[c + i], bi1[c + i]);
    *reinterpret_cast<uint4*>(y1s + wg::cm(r, c, C1)) = pack8(v);
    if (h1s) *reinterpret_cast<uint4*>(h1s + wg::cm(r, c, C1)) = hv;
  }
}

// Stores a pair of f32 values (columns c, c + 1 of row r) as bf16 into a
// core-matrix tile of width W.
template <int W>
__device__ __forceinline__ void put2(__nv_bfloat16* tile, int r, int c,
                                     float a, float b) {
  *reinterpret_cast<uint32_t*>(tile + wg::cm(r, c, W)) = pack2(a, b);
}

// Layer 2 of a tile by one warpgroup (its thread t): h2 = y1s . W2 over
// all C2 columns, then y2s = bf16(relu(h2*sc2 + bi2)) from the fragment.
// The caller fences and synchronizes before y2s is read.
template <int C1, int C2>
__device__ __forceinline__ void layer2_y2(const __nv_bfloat16* y1s,
                                          const __nv_bfloat16* w2s,
                                          const float* sc2, const float* bi2,
                                          __nv_bfloat16* y2s, int t) {
  float h2[C2 / 2];
  wg::product<C2, 0, 1, C1 / 16>(h2, wg::k_major(y1s, C1, 0, 0),
                                 wg::mn_major(w2s, C2, 0, 0));
  const int r0 = wg::frag_row(t, 0), r1 = wg::frag_row(t, 1);
#pragma unroll
  for (int n = 0; n < C2 / 8; ++n) {
    const int ch = wg::frag_col(t, n, 0);
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      y[e] = bn_relu(h2[4 * n + e], sc2[ch + (e & 1)], bi2[ch + (e & 1)]);
    put2<C2>(y2s, r0, ch, y[0], y[1]);
    put2<C2>(y2s, r1, ch, y[2], y[3]);
  }
}

}  // namespace pcl
