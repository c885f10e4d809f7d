// Row scatter-add for Hopper (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/gather.py
// (scatter_rows -> _gather_bwd_impl -> _scatter_kernel), the backward
// pass of every row gather (three_interp's d_feats among them):
//   out[b, idx[b, r], :] += g[b, r, :]   for every row r of g [B, R, C];
// an index outside [0, n) adds nothing, as the TPU kernel's all-zero
// one-hot rows and the XLA route's mode="drop" do.
//
// The TPU kernel builds an [mt*k, n] one-hot tile and accumulates its
// transposed product with g across the sequential grid. Here blocks run
// in parallel, so rows meet in one target through atomics. Two routes,
// chosen by the wrapper from the size of out[b] (ops/kernels/gather.py):
//
// * narrow (out[b] fits a block's shared memory, e.g. C = 1 at n = 1024:
//   4 KB): a cluster of up to 8 blocks owns one batch; each block takes
//   a chunk of its rows and adds them into its own copy of out[b] in
//   shared memory (shared-memory atomics, a thread per element of g).
//   After cluster.sync() each block sums its 1/cluster slice of out[b]
//   over the cluster's copies through distributed shared memory and
//   stores it with plain 16-byte stores. Every element of out is written
//   exactly once, so out needs no zeroing.
// * wide: one batch's rows, as a flat run of units (16 bytes when C % 4
//   == 0, else 4), go to warps in rounds of 32 * kSrInFlight units, the
//   warps of four waves of resident blocks striding over the rounds; a
//   lane adds its units into out, zeroed by the wrapper, with 16-byte
//   vector reductions (RED.ADD.F32x4) or f32 ones, resolved in the L2
//   cache.
//
// Both routes keep several rows' loads in flight a thread before their
// adds: the parent kernel read a row's index, then its g, then added,
// one row at a time a warp, so a warp's rows stood in series (at C = 1,
// 31 of its 32 lanes idle).
//
// What bounds it: bytes. It reads B*R*C*4 + B*R*4 bytes and writes
// B*n*C*4, against one f32 add per element of g.
//
// Numerics: the order in which rows meet in one target changes from run
// to run, so the last bits of out do too. The narrow route fixes the
// order across a cluster's blocks (ranks summed 0, 1, ...), not within a
// block's shared-memory atomics. Any two orders of t rows differ by at
// most (t - 1) roundings of the running sum, each within 2^-24 of its
// magnitude; the interpolation backward gives a support point ~3M/n rows
// (12 on average at FP1 of part segmentation).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace pcl {

constexpr int kSrThreads = 256;       // wide route
constexpr int kSrNarrowThreads = 256; // narrow route
constexpr int kSrInFlight = 4;        // steps of loads issued before their adds
constexpr int kSrWideWaves = 4;       // waves of resident blocks, wide route
constexpr int kSrMaxCluster = 8;      // the portable cluster size
constexpr int kSrNarrowPerThread = 8; // elements of g a narrow thread takes

// A walk over the units u = row * w + j of consecutive rows: a thread
// starts at unit `first` past row r0 and advances `step` units at a time,
// with no division inside the loop.
struct Walk {
  int row, j, drow, dj;
  __device__ Walk(int r0, int first, int step, int w)
      : row(r0 + first / w), j(first % w), drow(step / w), dj(step % w) {}
  __device__ void next(int w) {
    row += drow;
    j += dj;
    if (j >= w) {
      j -= w;
      ++row;
    }
  }
};

__device__ __forceinline__ void add_to(float* p, float v) { atomicAdd(p, v); }
__device__ __forceinline__ void add_to(float4* p, float4 v) { atomicAdd(p, v); }

// Narrow route. grid (cluster, B), a cluster a batch; ONE: C == 1.
template <bool ONE>
__global__ void __launch_bounds__(kSrNarrowThreads)
    narrow_scatter_rows_kernel(const float* __restrict__ g,
                               const int* __restrict__ idx,
                               float* __restrict__ out, int rows, int n, int c,
                               int chunk) {
  extern __shared__ float4 acc4[];
  float* acc = reinterpret_cast<float*>(acc4);
  const int w = ONE ? 1 : c;
  const int nw = n * w;
  const int nw4 = (nw + 3) / 4;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cs = (int)cluster.num_blocks();
  for (int i = threadIdx.x; i < nw4; i += kSrNarrowThreads)
    acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const size_t b = blockIdx.y;
  const float* gb = g + b * rows * w;
  const int* ib = idx + b * rows;
  const int r1 = min(rows, (rank + 1) * chunk);
  Walk at(rank * chunk, threadIdx.x, kSrNarrowThreads, w);
  while (at.row < r1) {
    int t[kSrInFlight], j[kSrInFlight];
    float v[kSrInFlight];
#pragma unroll
    for (int k = 0; k < kSrInFlight; ++k) {
      const bool live = at.row < r1;
      t[k] = live ? __ldg(ib + at.row) : -1;
      v[k] = live ? __ldg(gb + at.row * w + at.j) : 0.f;
      j[k] = at.j;
      at.next(w);
    }
#pragma unroll
    for (int k = 0; k < kSrInFlight; ++k)
      if ((unsigned)t[k] < (unsigned)n) atomicAdd(acc + t[k] * w + j[k], v[k]);
  }
  cluster.sync();

  // this block's slice of out[b], summed over the cluster in rank order
  float* ob = out + b * nw;
  if (nw % 4 == 0) {
    const int per = (nw4 + cs - 1) / cs;
    const int end = min(nw4, (rank + 1) * per);
    for (int i = rank * per + threadIdx.x; i < end; i += kSrNarrowThreads) {
      float4 x[kSrMaxCluster];  // every peer's load in flight, then the sum
#pragma unroll
      for (int q = 0; q < kSrMaxCluster; ++q)
        if (q < cs) x[q] = cluster.map_shared_rank(acc4, q)[i];
      float4 s = x[0];
#pragma unroll
      for (int q = 1; q < kSrMaxCluster; ++q)
        if (q < cs) {
          s.x += x[q].x;
          s.y += x[q].y;
          s.z += x[q].z;
          s.w += x[q].w;
        }
      reinterpret_cast<float4*>(ob)[i] = s;
    }
  } else {
    const int per = (nw + cs - 1) / cs;
    const int end = min(nw, (rank + 1) * per);
    for (int i = rank * per + threadIdx.x; i < end; i += kSrNarrowThreads) {
      float x[kSrMaxCluster];
#pragma unroll
      for (int q = 0; q < kSrMaxCluster; ++q)
        if (q < cs) x[q] = cluster.map_shared_rank(acc, q)[i];
      float s = x[0];
#pragma unroll
      for (int q = 1; q < kSrMaxCluster; ++q)
        if (q < cs) s += x[q];
      ob[i] = s;
    }
  }
  cluster.sync();  // no block leaves while a peer still reads its copy
}

// Wide route. grid (blocks a batch, B); T is float4 (w = C / 4 units a
// row) or float (w = C). A batch's units u = row * w + j go in rounds of
// 32 * kSrInFlight a warp, the warps striding over the rounds.
template <typename T>
__global__ void __launch_bounds__(kSrThreads)
    scatter_rows_kernel(const T* __restrict__ g, const int* __restrict__ idx,
                        T* __restrict__ out, int rows, int n, int w) {
  constexpr int kRound = 32 * kSrInFlight;
  const int warps = gridDim.x * (kSrThreads / 32);
  const int units = rows * w;
  const size_t b = blockIdx.y;
  const T* gb = g + b * units;
  const int* ib = idx + b * rows;
  T* ob = out + b * n * w;
  for (int u0 = (blockIdx.x * (kSrThreads / 32) + threadIdx.x / 32) * kRound;
       u0 < units; u0 += warps * kRound) {
    Walk at(0, u0 + threadIdx.x % 32, 32, w);
    int t[kSrInFlight], j[kSrInFlight];
    T v[kSrInFlight];
#pragma unroll
    for (int k = 0; k < kSrInFlight; ++k) {
      const bool live = at.row < rows;
      t[k] = live ? __ldg(ib + at.row) : -1;
      v[k] = live ? __ldg(gb + at.row * w + at.j) : T{};
      j[k] = at.j;
      at.next(w);
    }
#pragma unroll
    for (int k = 0; k < kSrInFlight; ++k)
      if ((unsigned)t[k] < (unsigned)n) add_to(ob + t[k] * w + j[k], v[k]);
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

template <bool ONE>
cudaError_t launch_narrow(const float* g, const int* idx, float* out, int b,
                          int rows, int n, int c, cudaStream_t stream) {
  const long long units = (long long)rows * c;
  const long long per_block = (long long)kSrNarrowThreads * kSrNarrowPerThread;
  const int cs = (int)std::min<long long>(
      kSrMaxCluster,
      std::max<long long>(1, (units + per_block - 1) / per_block));
  const int chunk = (rows + cs - 1) / cs;
  const size_t smem = (size_t)((n * c + 3) / 4) * 16;
  auto kernel = narrow_scatter_rows_kernel<ONE>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, b, 1);
  cfg.blockDim = dim3(kSrNarrowThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kernel, g, idx, out, rows, n, c, chunk);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T>
cudaError_t launch_wide(const void* g, const int* idx, void* out, int b,
                        int rows, int n, int w, cudaStream_t stream) {
  static int per_sm = 0;  // resident blocks an SM
  if (per_sm == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, scatter_rows_kernel<T>, kSrThreads, 0);
  // the warps of all batches fill kSrWideWaves waves of resident blocks
  // (one wave measured up to 12 % slower at the largest path shapes), a
  // warp at most a round
  const int warps_a_block = kSrThreads / 32;
  const long long rounds =
      ((long long)rows * w + 32 * kSrInFlight - 1) / (32 * kSrInFlight);
  const long long wave_warps = std::max<long long>(
      1, (long long)kSrWideWaves * sm_count() * std::max(per_sm, 1) *
             warps_a_block / b);
  const int blocks = (int)((std::min(rounds, wave_warps) + warps_a_block -
                            1) / warps_a_block);
  scatter_rows_kernel<T><<<dim3(blocks, b, 1), kSrThreads, 0, stream>>>(
      static_cast<const T*>(g), idx, static_cast<T*>(out), rows, n, w);
  return cudaGetLastError();
}

}  // namespace pcl

// g [b, rows, c] f32, idx [b, rows] i32, out [b, n, c] f32; all
// contiguous, rows * c and n * c below 2^31. narrow != 0: the narrow
// route, which writes every element of out (out[b] must fit a block's
// shared memory); else the wide route, which adds into out, already
// zeroed. Returns the launch's cudaError_t code, or cudaErrorInvalidValue
// for empty sizes.
extern "C" int scatter_rows_launch(const void* g, const void* idx, void* out,
                                   int b, int rows, int n, int c, int narrow,
                                   void* stream) {
  if (b < 1 || rows < 1 || n < 1 || c < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const int* ix = static_cast<const int*>(idx);
  float* of = static_cast<float*>(out);
  if (narrow)
    return c == 1 ? pcl::launch_narrow<true>(gf, ix, of, b, rows, n, c, s)
                  : pcl::launch_narrow<false>(gf, ix, of, b, rows, n, c, s);
  const bool vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) return pcl::launch_wide<float4>(g, ix, out, b, rows, n, c / 4, s);
  return pcl::launch_wide<float>(g, ix, out, b, rows, n, c, s);
}
