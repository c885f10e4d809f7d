// Farthest-point sampling for Hopper (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/fps.py
// (fps_pallas -> _fps_kernel). Same function: seed index 0, a running
// min-d2 cache, argmax with the lowest index on ties, points with
// |p|^2 <= 1e-3 never picked when skip is set. Indices are bit-identical
// to the plain version (ops/geometry.py farthest_point_sample).
//
// What bounds it: not bytes (a cloud is 12 bytes a point, read once) and
// not arithmetic (~10 flops a point an iteration), but the chain of m-1
// dependent block-wide argmax reductions — each pick needs the previous
// one. The design keeps that chain short: one block per cloud, each
// thread holds a strided share of the points and their min-d2 in
// registers (PPT per thread, unrolled), the cloud is staged once in
// shared memory so the picked point's coordinates are one shared load,
// and each iteration is one warp-shuffle argmax, one shared-memory
// exchange between warps and two barriers.
// Known limit: one block per cloud, so B=64 clouds fill 64 of the H100's
// 132 SMs.
//
// Numerics: d2 = (dx*dx + dy*dy) + dz*dz with explicit round-to-nearest
// intrinsics. nvcc would otherwise contract into FMAs, which changes the
// last bit of d2 and with it argmax picks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pcl {

constexpr int kWarp = 32;

__device__ __forceinline__ void better(float& bv, int& bi, float ov, int oi) {
  if (ov > bv || (ov == bv && oi < bi)) {
    bv = ov;
    bi = oi;
  }
}

template <int PPT>
__global__ void fps_kernel(const float* __restrict__ xyz,
                           int* __restrict__ out, int n, int m, int skip) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + n;
  float* sz = sy + n;
  __shared__ float wv[kWarp];
  __shared__ int wi[kWarp];
  __shared__ float last[3];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int nwarps = nt / kWarp;
  const float* p = xyz + (size_t)b * n * 3;

  float px[PPT], py[PPT], pz[PPT], md[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int j = tid + i * nt;
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
  if (tid == 0) {
    last[0] = sx[0];
    last[1] = sy[0];
    last[2] = sz[0];
  }
  __syncthreads();

  for (int s = 1; s < m; ++s) {
    const float lx = last[0], ly = last[1], lz = last[2];
    float bv = -INFINITY;
    int bi = 0x7fffffff;
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
        bi = tid + i * nt;
      }
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      better(bv, bi, ov, oi);
    }
    if (lane == 0) {
      wv[warp] = bv;
      wi[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? wv[lane] : -INFINITY;
      bi = lane < nwarps ? wi[lane] : 0x7fffffff;
#pragma unroll
      for (int off = kWarp / 2; off > 0; off /= 2) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        better(bv, bi, ov, oi);
      }
      if (lane == 0) {
        out[(size_t)b * m + s] = bi;
        last[0] = sx[bi];
        last[1] = sy[bi];
        last[2] = sz[bi];
      }
    }
    __syncthreads();
  }
}

template <int PPT>
cudaError_t launch(const float* xyz, int* out, int b, int n, int m,
                   int skip, cudaStream_t stream) {
  int threads = (n + PPT - 1) / PPT;
  threads = ((threads + kWarp - 1) / kWarp) * kWarp;
  const size_t smem = (size_t)3 * n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  fps_kernel<PPT><<<b, threads, smem, stream>>>(xyz, out, n, m, skip);
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
  // about 256 threads a cloud: a short per-iteration reduction, a few
  // points per thread in registers
  if (n <= 256) return pcl::launch<1>(x, o, b, n, m, skip, s);
  if (n <= 512) return pcl::launch<2>(x, o, b, n, m, skip, s);
  if (n <= 1024) return pcl::launch<4>(x, o, b, n, m, skip, s);
  if (n <= 2048) return pcl::launch<8>(x, o, b, n, m, skip, s);
  return pcl::launch<16>(x, o, b, n, m, skip, s);
}
