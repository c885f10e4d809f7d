// Train-mode fused set abstraction, forward pass 1 from a given
// neighbour index, for Hopper (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/fused_sa.py
// (_call_f1 -> _k_f1). For every grouped row (b, center, slot), replicas
// included:
//   h1 = float(bf16 Q[b, idx[b, center, slot]]) - off[b, center]   (f32)
// writes h1 [B, M, k, C1] bf16 and adds [sum h1, sum h1^2] over all
// rows, taken on the f32 h1 before its rounding, into psum [2, C1]
// (zeroed by the caller).
//
// The TPU kernel gathers with a one-hot matmul; here a lane reads its 8
// channels of the indexed row directly. This is the ball-query pass-1
// kernel (fused_sa_bq_f1.cu) without the scan, and shares its write half
// (f1_center, fused_sa_f1.cuh); its walk over the centers (f1_idx_walk)
// is also the EdgeConv's given-index pass 1 (edge_f1.cu).
//
// What bounds it: bytes. It reads the gathered rows of q (rows*C1*2
// bytes, mostly from L2: a cloud's q is N*C1*2 bytes, 64-512 KB), idx and
// off, and writes h1 (rows*C1*2 bytes, 134-268 MB at the train shapes);
// 4 f32 operations per element. The design: one wave of resident blocks
// whose warps walk the centers, a center a warp: the warp reads the
// center's idx row with one vector load a lane into shared memory, then
// writes its rows with 16-byte gathers and stores; slots whose index
// equals slot 0's are copies of slot 0's row (exact for any input),
// stored without a gather.
// At N >= 4096 (where the JAX package runs the windowed _k_f1w) the
// batch is Hilbert-sorted, so a center's neighbours lie close in q and
// the gathers need no window.
//
// Numerics: one f32 subtraction and one rounding per element,
// bit-identical to the plain version; the sums are f32 in another order
// (registers, then atomics), within 1e-3 relative.

#include "fused_sa_f1.cuh"

namespace pcl {

template <int C1>
__global__ void __launch_bounds__(kThreads, kF1MinBlocks)
    f1_kernel(const __nv_bfloat16* q, const float* off, const int* idx,
              __nv_bfloat16* h1, float* psum, int n, int m, int k,
              long long centers) {
  f1_idx_walk<C1>(q, off, idx, h1, psum, n, m, k, centers);
}

}  // namespace pcl

// Widths compiled: C1 = 32, 64 and 128. Every idx must lie in [0, n).
// Returns the launch's cudaGetLastError() code, or cudaErrorInvalidValue
// for what it does not take.
extern "C" int sa_f1_launch(const void* q, const void* off, const void* idx,
                            void* h1, void* psum, int batch, int n, int m,
                            int c1, int k, void* stream) {
  if (batch < 1 || n < 1 || m < 1 || k < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c1 == 32)
    return pcl::launch_f1_idx<32>(pcl::f1_kernel<32>, q, off, idx, h1, psum,
                                  batch, n, m, k, s);
  if (c1 == 64)
    return pcl::launch_f1_idx<64>(pcl::f1_kernel<64>, q, off, idx, h1, psum,
                                  batch, n, m, k, s);
  if (c1 == 128)
    return pcl::launch_f1_idx<128>(pcl::f1_kernel<128>, q, off, idx, h1,
                                   psum, batch, n, m, k, s);
  return cudaErrorInvalidValue;
}
