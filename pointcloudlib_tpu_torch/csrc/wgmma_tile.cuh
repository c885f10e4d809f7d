// Hopper warpgroup products (wgmma, sm_90a) for the set-abstraction
// backward passes (fused_sa_bwd_p1.cu, fused_sa_bwd_p2.cu).
//
// A warpgroup (four warps, 128 threads) issues
// wgmma.mma_async.m64nNk16 with both bf16 operands in shared memory and
// the f32 sums in its registers. Operands sit in the no-swizzle
// core-matrix layout: a bf16 tile [R, W] is cut into 8 x 8 core
// matrices of 128 contiguous bytes (8 rows of 16 bytes), the cores of a
// row group next to each other, row groups one after another
// (cm() below). The same tile serves as a K-major operand (its rows
// are M or N, its columns K) or, through the transpose bit, as an
// MN-major one (its columns are M or N, its rows K): W [C_in, C_out]
// is the B of h = y.W and, read the other way, of dy = dh.W^T, and a
// row tile [64, C] is the A of y.W and the A^T of the row contraction
// y^T.dh. A warp's stores of its fragment (8 rows x 4 lanes x 4 bytes
// for one 8-channel group) cover one whole core matrix, so fragment
// stores into this layout, in shared memory or in device memory, are
// free of bank conflicts and fully coalesced.
//
// Accumulator fragment of m64nN (PTX ISA, wgmma register fragments):
// thread t of the warpgroup, warp w = t / 32, lane l, holds for each
// 8-column group n the four values d[4n + 2i + j] at row
// 16w + l/4 + 8i and column 8n + 2(l%4) + j, i, j in {0, 1}.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace pcl {
namespace wg {

constexpr int kWGThreads = 128;

// Element offset of (r, c) in a core-matrix tile of width w.
__host__ __device__ __forceinline__ constexpr int cm(int r, int c, int w) {
  return (r >> 3) * 8 * w + (c >> 3) * 64 + (r & 7) * 8 + (c & 7);
}

// Shared-memory matrix descriptor, no swizzle: start address, leading
// and stride byte offsets in 16-byte units.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// An operand: the descriptor of its first k16 step and the increment of
// the start address (16-byte units) from one k16 step to the next.
struct Opnd {
  uint64_t d;
  uint32_t step;
};

// Rows [r0, r0 + 8 * groups) of a tile of width w as M or N, columns
// from c0 as K (K-major; transpose bit 0).
__device__ __forceinline__ Opnd k_major(const __nv_bfloat16* tile, int w,
                                        int r0, int c0) {
  return {desc(tile + cm(r0, c0, w), 128, 16 * w), 256 >> 4};
}
// Columns from c0 as M or N, rows from r0 as K (MN-major; transpose
// bit 1).
__device__ __forceinline__ Opnd mn_major(const __nv_bfloat16* tile, int w,
                                         int r0, int c0) {
  return {desc(tile + cm(r0, c0, w), 16 * w, 128), (32 * w) >> 4};
}

template <int N>
struct Mma;

template <>
struct Mma<16> {
  template <int TA, int TB>
  __device__ __forceinline__ static void run(float (&d)[8], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <>
struct Mma<32> {
  template <int TA, int TB>
  __device__ __forceinline__ static void run(float (&d)[16], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <>
struct Mma<48> {
  template <int TA, int TB>
  __device__ __forceinline__ static void run(float (&d)[24], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, %24, %25, p, 1, 1, %27, %28;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <>
struct Mma<64> {
  template <int TA, int TB>
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <>
struct Mma<96> {
  template <int TA, int TB>
  __device__ __forceinline__ static void run(float (&d)[48], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, %51, %52;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <>
struct Mma<128> {
  template <int TA, int TB>
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <>
struct Mma<144> {
  template <int TA, int TB>
  __device__ __forceinline__ static void run(float (&d)[72], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71"
        "}, %72, %73, p, 1, 1, %75, %76;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <>
struct Mma<192> {
  template <int TA, int TB>
  __device__ __forceinline__ static void run(float (&d)[96], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

// Keeps the compiler from moving accesses of the accumulators across
// the asynchronous product.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Generic stores to shared memory made visible to the products that
// read it; each writing thread calls it before the barrier.
__device__ __forceinline__ void fence_to_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void begin() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups are still running.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void commit_wait() {
  commit();
  wait<0>();
}

// d += A . B over KSTEPS k16 steps, issued without waiting; TA / TB
// are the transpose bits (1: MN-major). Between begin() and
// commit_wait(), with fence_regs() of d around them.
template <int N, int TA, int TB, int KSTEPS>
__device__ __forceinline__ void issue(float (&d)[N / 2], Opnd a, Opnd b) {
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s)
    Mma<N>::template run<TA, TB>(d, a.d + (uint64_t)(s * a.step),
                                 b.d + (uint64_t)(s * b.step));
}

// d = A . B (d zeroed first) or d += A . B, waited for.
template <int N, int TA, int TB, int KSTEPS>
__device__ __forceinline__ void product(float (&d)[N / 2], Opnd a, Opnd b,
                                        bool zero = true) {
  if (zero) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) d[i] = 0.0f;
  }
  fence_regs(d);
  begin();
  issue<N, TA, TB, KSTEPS>(d, a, b);
  commit_wait();
  fence_regs(d);
}

// Fragment coordinates of this thread in its warpgroup: row of i
// (0 or 1), column of (n, j).
__device__ __forceinline__ int frag_row(int t, int i) {
  return ((t >> 5) << 4) + ((t & 31) >> 2) + 8 * i;
}
__device__ __forceinline__ int frag_col(int t, int n, int j) {
  return 8 * n + 2 * (t & 3) + j;
}

// Sum and max over the eight lanes of a warp that share a column
// (lanes l, l^4, ..., l^28: eight consecutive rows).
__device__ __forceinline__ float rows8_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}
__device__ __forceinline__ float rows8_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
  return v;
}

// Reduce-scatter of eight values over the same eight lanes in seven
// shuffles: returns the sum (with MAX, the max) over the lanes of
// v[rows8_slot(lane)].
template <bool MAX = false>
__device__ __forceinline__ float rows8_scatter(const float (&v)[8],
                                               int lane) {
  auto op = [](float a, float b) { return MAX ? fmaxf(a, b) : a + b; };
  const bool b2 = lane & 4, b3 = lane & 8, b4 = lane & 16;
  float w[4], u[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = op(b2 ? v[i + 4] : v[i],
              __shfl_xor_sync(0xffffffffu, b2 ? v[i] : v[i + 4], 4));
#pragma unroll
  for (int i = 0; i < 2; ++i)
    u[i] = op(b3 ? w[i + 2] : w[i],
              __shfl_xor_sync(0xffffffffu, b3 ? w[i] : w[i + 2], 8));
  return op(b4 ? u[1] : u[0],
            __shfl_xor_sync(0xffffffffu, b4 ? u[0] : u[1], 16));
}
__device__ __forceinline__ int rows8_slot(int lane) {
  return ((lane >> 2) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 4) & 1);
}

}  // namespace wg
}  // namespace pcl
