// Farthest-point sampling for Hopper (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/fps.py
// (fps_pallas -> _fps_kernel). Same function: seed index 0, a running
// min-d2 cache, argmax with the lowest index on ties, points with
// |p|^2 <= 1e-3 never picked when skip is set. Indices are bit-identical
// to the plain version (ops/geometry.py farthest_point_sample).
//
// What bounds it: not bytes (a cloud is 12 bytes a point, read once) and
// not arithmetic (~10 flops a point a pick), but the latency of the chain
// of m - 1 dependent block-wide argmax steps: each pick needs the one
// before it. The design keeps one pick short. One block a cloud; each
// thread holds a strided share of the points and their min-d2 in
// registers (PPT a thread, unrolled), and the cloud is staged once in
// shared memory, so the picked point's coordinates are one shared load.
// A score maps to an order-preserving u32 key, so a warp's argmax is two
// redux.sync (the largest key, then the lowest index holding it) in place
// of a shuffle tree. Each warp writes its (key, index) into a slot of its
// own, double-buffered by the pick's parity, the block meets at one
// barrier, and then every warp reduces the few candidates itself (up to
// four in registers, more by redux): no serial stage in one warp, no
// second barrier. Few warps a cloud (the launcher's table, by
// measurement, PERF.md) keep that exchange short; a cloud of at most 256
// points runs in one warp with no barrier.
//
// Numerics: d2 = (dx*dx + dy*dy) + dz*dz with explicit round-to-nearest
// intrinsics. nvcc would otherwise contract into FMAs, which changes the
// last bit of d2 and with it argmax picks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pcl {

// Order-preserving u32 key of a score: >= 0, -1 (ineligible) or -inf (a
// slot past n). Non-negative floats order as their bits with the sign bit
// set; negative ones order reversed, so every bit is flipped.
__device__ __forceinline__ unsigned score_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : u | 0x80000000u;
}

// The warp's best (key, index): the largest key and the lowest index that
// holds it, in every lane.
__device__ __forceinline__ void warp_best(unsigned& key, unsigned& idx) {
  const unsigned best = __reduce_max_sync(0xffffffffu, key);
  idx = __reduce_min_sync(0xffffffffu, key == best ? idx : 0xffffffffu);
  key = best;
}

// The better of two (key, index) candidates into (key, idx).
__device__ __forceinline__ void better(unsigned& key, unsigned& idx,
                                       uint2 o) {
  if (o.x > key || (o.x == key && o.y < idx)) {
    key = o.x;
    idx = o.y;
  }
}

template <int PPT, int NW>
__global__ void __launch_bounds__(NW * 32)
    fps_kernel(const float* __restrict__ xyz, int* __restrict__ out, int n,
               int m, int skip) {
  constexpr int NT = NW * 32;
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + n;
  float* sz = sy + n;
  __shared__ uint2 cand[2][NW];  // (key, index) a warp, by pick parity

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const float* p = xyz + (size_t)b * n * 3;

  float px[PPT], py[PPT], pz[PPT], md[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int j = tid + i * NT;
    if (j < n) {
      px[i] = p[3 * j];
      py[i] = p[3 * j + 1];
      pz[i] = p[3 * j + 2];
      sx[j] = px[i];
      sy[j] = py[i];
      sz[j] = pz[i];
      const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(px[i], px[i]),
                                           __fmul_rn(py[i], py[i])),
                                 __fmul_rn(pz[i], pz[i]));
      // ineligible points sit at -1: min(-1, d2 >= 0) keeps them there
      md[i] = (!skip || r2 > 1e-3f) ? 1e10f : -1.0f;
    } else {
      px[i] = py[i] = pz[i] = 0.0f;
      md[i] = -INFINITY;  // slots past n never win
    }
  }
  if (tid == 0) out[(size_t)b * m] = 0;
  __syncthreads();
  float lx = sx[0], ly = sy[0], lz = sz[0];

  for (int s = 1; s < m; ++s) {
    float bv = -INFINITY;
    unsigned bi = 0xffffffffu;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const float dx = __fsub_rn(px[i], lx);
      const float dy = __fsub_rn(py[i], ly);
      const float dz = __fsub_rn(pz[i], lz);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                           __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      md[i] = fminf(md[i], d2);
      // indices rise with i: strict '>' keeps the lowest on ties
      if (md[i] > bv) {
        bv = md[i];
        bi = tid + i * NT;
      }
    }
    unsigned key = score_key(bv);
    warp_best(key, bi);
    if (NW > 1) {
      // a warp may run one pick ahead of the slowest: the other parity
      uint2* c = cand[s & 1];
      if (lane == 0) c[warp] = make_uint2(key, bi);
      __syncthreads();
      if (NW <= 4) {  // every lane reads the few candidates, in order
        key = c[0].x;
        bi = c[0].y;
#pragma unroll
        for (int w = 1; w < NW; ++w) better(key, bi, c[w]);
      } else {
        const uint2 o = lane < NW ? c[lane] : make_uint2(0u, 0xffffffffu);
        key = o.x;
        bi = o.y;
        warp_best(key, bi);
      }
    }
    if (tid == 0) out[(size_t)b * m + s] = (int)bi;
    lx = sx[bi];
    ly = sy[bi];
    lz = sz[bi];
  }
}

template <int PPT, int NW>
cudaError_t launch(const float* xyz, int* out, int b, int n, int m,
                   int skip, cudaStream_t stream) {
  const size_t smem = (size_t)3 * n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel<PPT, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  fps_kernel<PPT, NW><<<b, NW * 32, smem, stream>>>(xyz, out, n, m, skip);
  return cudaGetLastError();
}

}  // namespace pcl

// xyz [b, n, 3] f32 contiguous, out [b, m] i32. Returns the launch's
// cudaGetLastError() code (0 on success).
extern "C" int fps_launch(const void* xyz, void* out, int b, int n, int m,
                          int skip, void* stream) {
  if (b < 1 || n < 1 || m < 1 || n > 16 * 1024) return cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(xyz);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // points a thread and warps a cloud, by measurement (PERF.md)
  if (n <= 64) return pcl::launch<2, 1>(x, o, b, n, m, skip, s);
  if (n <= 256) return pcl::launch<8, 1>(x, o, b, n, m, skip, s);
  if (n <= 512) return pcl::launch<4, 4>(x, o, b, n, m, skip, s);
  if (n <= 1024) return pcl::launch<8, 4>(x, o, b, n, m, skip, s);
  if (n <= 2048) return pcl::launch<8, 8>(x, o, b, n, m, skip, s);
  if (n <= 4096) return pcl::launch<8, 16>(x, o, b, n, m, skip, s);
  return pcl::launch<16, 32>(x, o, b, n, m, skip, s);
}
