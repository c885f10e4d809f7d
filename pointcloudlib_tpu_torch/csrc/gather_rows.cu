// Row gather for Hopper (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/gather.py
// (gather_neighbors -> _gather_fwd_impl -> _gather_kernel):
//   out[b, r, :] = pts[b, idx[b, r], :]   for every row r of idx [B, R],
// pts [B, n, C] f32, out [B, R, C] f32 (R = M*K of a [B, M, K] index);
// an index outside [0, n) gives a zero row, as the TPU kernel's all-zero
// one-hot rows do.
//
// The TPU kernel builds a [mt*k, n] one-hot tile in VMEM and multiplies
// it with the cloud twice (a hi/lo bf16 split keeps ~2^-17 of f32),
// because its vector unit gathers narrow rows slowly. On this card a
// load is a load: the kernel copies. Two routes, chosen by the wrapper
// (ops/kernels/gather.py):
//
// * wide (C % 4 == 0, 16-byte aligned): threads walk the output in order,
//   grid-stride, one float4 a thread (16-byte loads and stores); each
//   thread reads its row's index and its piece of the source row.
// * narrow (every other C, e.g. 1 and 6): a grid of (row chunk, batch),
//   all index arithmetic in 32 bits within a batch. A block first copies
//   its batch's cloud (n*C*4 bytes: 24 KB at C = 6, n = 1024) into shared
//   memory by cp.async, where it fits, while its warps load their first
//   indices. A warp then takes 32 rows at a time: one index load a row
//   (the next group's already in flight), the lane's row read from
//   shared memory (or through L1/L2 by __ldg where the cloud was not
//   staged), assembled in the warp's shared buffer and written as
//   contiguous 16-byte stores (32 rows x 24 B = 768 B at C = 6). Rows
//   wider than 32 floats go out row by row, the lanes over channels.
//
// What bounds it: bytes. It writes B*R*C*4 and reads the index, B*R*4,
// and the source rows; the source cloud, B*n*C*4, counts once (rows
// that repeat hit shared memory or the caches). No arithmetic.
//
// Numerics: an exact copy, bit-identical to gather_neighbors_plain.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace pcl {

constexpr int kGrThreads = 256;              // wide route
constexpr int kGnThreads = 512;              // narrow route
constexpr int kGnWarps = kGnThreads / 32;
constexpr int kGnBlocksPerSm = 2;            // narrow blocks resident an SM
constexpr int kGnStageBytes = 64 * 1024;     // largest cloud staged
constexpr int kGnAssembleC = 32;             // widest row assembled in a buffer

// Wide route: one float4 a thread; c counts float4s.
__global__ void __launch_bounds__(kGrThreads)
    gather_rows_kernel(const float4* __restrict__ pts,
                       const int* __restrict__ idx, float4* __restrict__ out,
                       long long rows_per_batch, long long total, int n,
                       int c) {
  const long long step = (long long)gridDim.x * kGrThreads;
  for (long long e = (long long)blockIdx.x * kGrThreads + threadIdx.x;
       e < total; e += step) {
    const long long r = e / c;
    const int ch = (int)(e - r * c);
    const int t = __ldg(idx + r);
    float4 v;
    if (t >= 0 && t < n) {
      const long long b = r / rows_per_batch;
      v = __ldg(pts + ((size_t)b * n + t) * c + ch);
    } else {
      v = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    out[e] = v;
  }
}

__device__ __forceinline__ void cp_async(unsigned dst, const void* src,
                                         bool wide) {
  if (wide)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
}

// Narrow route. grid (chunks, B); each block takes groups [g0, g0 +
// groups) of 32 rows of batch blockIdx.y. CT: C at compile time (1), or 0
// for c. STAGED: the cloud in shared memory. flags: 1, the cloud's
// 16-byte units copied whole (n*C % 4 == 0, aligned); 2, 16-byte output
// stores (rows*C % 4 == 0, aligned).
template <int CT, bool STAGED>
__global__ void __launch_bounds__(kGnThreads)
    narrow_gather_rows_kernel(const float* __restrict__ pts,
                              const int* __restrict__ idx,
                              float* __restrict__ out, int rows, int n, int c,
                              int groups, int flags) {
  extern __shared__ float4 smem4[];
  const int C = CT ? CT : c;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const size_t b = blockIdx.y;
  const float* pb = pts + b * n * C;
  const int* ib = idx + b * rows;
  float* ob = out + b * rows * C;
  float* cloud = reinterpret_cast<float*>(smem4);
  float* buf = cloud + (STAGED ? (n * C + 3) / 4 * 4 : 0) + warp * 32 * C;
  if (STAGED) {
    const unsigned base = (unsigned)__cvta_generic_to_shared(cloud);
    if (flags & 1) {
      for (int i = threadIdx.x; i < n * C / 4; i += kGnThreads)
        cp_async(base + 16 * i, pb + 4 * i, true);
    } else {
      for (int i = threadIdx.x; i < n * C; i += kGnThreads)
        cp_async(base + 4 * i, pb + i, false);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  const int last = min((blockIdx.x + 1) * groups, (rows + 31) / 32);
  int grp = blockIdx.x * groups + warp;
  int r = grp * 32 + lane;
  int t = grp < last && r < rows ? __ldg(ib + r) : -1;
  if (STAGED) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
  const float* src = STAGED ? cloud : pb;
  for (; grp < last; grp += kGnWarps) {
    const int rn = (grp + kGnWarps) * 32 + lane;
    const int tn = grp + kGnWarps < last && rn < rows ? __ldg(ib + rn) : -1;
    const int count = min(32, rows - grp * 32);
    float* dst = ob + grp * 32 * C;
    const bool ok = (unsigned)t < (unsigned)n;
    const float* row = src + (ok ? t : 0) * C;
    if (CT == 1) {  // one float a row: the lanes' stores already coalesce
      if (lane < count) dst[lane] = ok ? (STAGED ? row[0] : __ldg(row)) : 0.f;
    } else if (C <= kGnAssembleC) {
      if (lane < count)
        for (int ch = 0; ch < C; ++ch)
          buf[lane * C + ch] =
              ok ? (STAGED ? row[ch] : __ldg(row + ch)) : 0.f;
      __syncwarp();
      if ((flags & 2) && count == 32) {
        for (int i = lane; i < 8 * C; i += 32)
          reinterpret_cast<float4*>(dst)[i] =
              reinterpret_cast<const float4*>(buf)[i];
      } else {
        for (int i = lane; i < count * C; i += 32) dst[i] = buf[i];
      }
      __syncwarp();
    } else {
      for (int i = 0; i < count; ++i) {
        const int ti = __shfl_sync(0xffffffffu, t, i);
        const bool oki = (unsigned)ti < (unsigned)n;
        const float* rowi = src + (oki ? ti : 0) * C;
        for (int ch = lane; ch < C; ch += 32)
          dst[i * C + ch] =
              oki ? (STAGED ? rowi[ch] : __ldg(rowi + ch)) : 0.f;
      }
    }
    t = tn;
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <int CT, bool STAGED>
cudaError_t launch_narrow_kernel(const float* pts, const int* idx,
                                 float* out, int b, int rows, int n, int c,
                                 cudaStream_t stream) {
  const int groups_a_batch = (rows + 31) / 32;
  // one wave of resident blocks over all batches, at least a group a warp
  const int by_wave = std::max(1, sm_count() * kGnBlocksPerSm / b);
  const int chunks =
      std::min(by_wave, (groups_a_batch + kGnWarps - 1) / kGnWarps);
  const int groups = (groups_a_batch + chunks - 1) / chunks;
  const size_t smem =
      (STAGED ? (size_t)(n * c + 3) / 4 * 16 : 0) +
      (c <= kGnAssembleC && c > 1 ? (size_t)kGnWarps * 32 * c * 4 : 0);
  auto kernel = narrow_gather_rows_kernel<CT, STAGED>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int flags =
      ((n * c) % 4 == 0 && reinterpret_cast<uintptr_t>(pts) % 16 == 0 ? 1
                                                                     : 0) |
      ((rows * c) % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 ? 2
                                                                        : 0);
  kernel<<<dim3((groups_a_batch + groups - 1) / groups, b, 1), kGnThreads,
           smem, stream>>>(pts, idx, out, rows, n, c, groups, flags);
  return cudaGetLastError();
}

template <int CT>
cudaError_t launch_narrow(const float* pts, const int* idx, float* out, int b,
                          int rows, int n, int c, cudaStream_t stream) {
  if ((long long)n * c * 4 <= kGnStageBytes)
    return launch_narrow_kernel<CT, true>(pts, idx, out, b, rows, n, c,
                                          stream);
  return launch_narrow_kernel<CT, false>(pts, idx, out, b, rows, n, c, stream);
}

}  // namespace pcl

// pts [b, n, c] f32, idx [b, rows] i32, out [b, rows, c] f32; all
// contiguous, rows * c and n * c below 2^31. narrow == 0 takes the wide
// route, which needs c % 4 == 0 and 16-byte aligned pts and out. Returns
// the launch's cudaError_t code, or cudaErrorInvalidValue for empty sizes
// or a wide launch it cannot make.
extern "C" int gather_rows_launch(const void* pts, const void* idx,
                                  void* out, int b, int rows, int n, int c,
                                  int narrow, void* stream) {
  if (b < 1 || rows < 1 || n < 1 || c < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pf = static_cast<const float*>(pts);
  const int* ix = static_cast<const int*>(idx);
  float* of = static_cast<float*>(out);
  if (narrow)
    return c == 1 ? pcl::launch_narrow<1>(pf, ix, of, b, rows, n, c, s)
                  : pcl::launch_narrow<0>(pf, ix, of, b, rows, n, c, s);
  if (c % 4 != 0 || reinterpret_cast<uintptr_t>(pts) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return cudaErrorInvalidValue;
  const long long total = (long long)b * rows * (c / 4);
  long long blocks = (total + pcl::kGrThreads - 1) / pcl::kGrThreads;
  blocks = std::min(blocks, (long long)pcl::sm_count() * 16);  // then stride
  pcl::gather_rows_kernel<<<(unsigned)blocks, pcl::kGrThreads, 0, s>>>(
      static_cast<const float4*>(pts), ix, static_cast<float4*>(out), rows,
      total, n, c / 4);
  return cudaGetLastError();
}
