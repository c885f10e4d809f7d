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
// load is a load: the kernel copies. Threads walk the output in order,
// grid-stride, one f32 a thread or, where C % 4 == 0 and both pointers
// are 16-byte aligned, one float4 (16-byte loads and stores); each
// thread reads its row's index (neighbouring threads share it through
// L1) and its piece of the source row. Output stores coalesce whatever
// C is, so narrow rows (C = 1 or 3) keep every lane busy.
//
// What bounds it: bytes. It writes B*R*C*4 and reads the index, B*R*4,
// and the source rows; the source cloud, B*n*C*4, counts once (rows
// that repeat hit the L2 cache). No arithmetic.
//
// Numerics: an exact copy, bit-identical to gather_neighbors_plain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace pcl {

constexpr int kGrThreads = 256;

// T is float (one channel a thread) or float4 (four); c counts T's.
template <typename T>
__global__ void __launch_bounds__(kGrThreads)
    gather_rows_kernel(const T* __restrict__ pts, const int* __restrict__ idx,
                       T* __restrict__ out, long long rows_per_batch,
                       long long total, int n, int c) {
  const long long step = (long long)gridDim.x * kGrThreads;
  for (long long e = (long long)blockIdx.x * kGrThreads + threadIdx.x;
       e < total; e += step) {
    const long long r = e / c;
    const int ch = (int)(e - r * c);
    const int t = __ldg(idx + r);
    T v;
    if (t >= 0 && t < n) {
      const long long b = r / rows_per_batch;
      v = __ldg(pts + ((size_t)b * n + t) * c + ch);
    } else {
      v = T{};
    }
    out[e] = v;
  }
}

template <typename T>
cudaError_t launch(const void* pts, const void* idx, void* out,
                   long long rows_per_batch, long long rows, int n, int c,
                   cudaStream_t stream) {
  const long long total = rows * c;
  long long blocks = (total + kGrThreads - 1) / kGrThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks an SM, then stride
  gather_rows_kernel<T><<<(unsigned)blocks, kGrThreads, 0, stream>>>(
      static_cast<const T*>(pts), static_cast<const int*>(idx),
      static_cast<T*>(out), rows_per_batch, total, n, c);
  return cudaGetLastError();
}

}  // namespace pcl

// pts [b, n, c] f32, idx [b, rows_per_batch] i32, out [b, rows_per_batch,
// c] f32; all contiguous. Returns the launch's cudaGetLastError() code, or
// cudaErrorInvalidValue for empty sizes.
extern "C" int gather_rows_launch(const void* pts, const void* idx,
                                  void* out, int b, long long rows_per_batch,
                                  int n, int c, void* stream) {
  if (b < 1 || rows_per_batch < 1 || n < 1 || c < 1)
    return cudaErrorInvalidValue;
  const long long rows = (long long)b * rows_per_batch;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(pts) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec)
    return pcl::launch<float4>(pts, idx, out, rows_per_batch, rows, n, c / 4,
                               s);
  return pcl::launch<float>(pts, idx, out, rows_per_batch, rows, n, c, s);
}
