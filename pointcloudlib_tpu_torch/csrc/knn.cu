// k nearest neighbours, for Hopper (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/neighbors.py
// (knn_pallas -> _knn_kernel). For query [B, M, C] and points [B, N, C]
// (f32):
//   d2 [B, M, k] f32, idx [B, M, k] i32   the k points with the smallest
//       d2 = max((|q|^2 - 2 q.p) + |p|^2, 0), ascending, the lower index
//       first on ties.
// DGCNN's EdgeConvs take it at N % 128 != 0 (query = points = the layer
// input), before the EdgeConv kernels that take a given index
// (edge_f1.cu, edge_eval.cu).
//
// The TPU kernel holds a [mt, N] distance tile in VMEM and runs k masked
// argmins over it, with an f32 cross term only under exact=True. Here the
// selection is knn_block (edge_knn.cuh): the points stream through shared
// memory in 64-point tiles, never the whole cloud (a 10,000-point cloud of
// 128 channels is 5 MB), so N has no limit but int; d2 is formed channel
// by channel in f32 without FMA, in the plain version's order, so idx and
// d2 are bit-identical to the plain version (ops/geometry.knn) and the
// TPU's exact flag changes nothing here. The lists' d2 come out of the
// merge beside their indices.
//
// What bounds it: operations, B*M*N pairs at 2*C + 3 f32 operations each
// (32 * 10^8 pairs a layer for DGCNN at B=32, N=10,000), against reading
// both clouds once and writing 8 bytes a neighbour. C is bounded by one
// block's shared memory (the query and candidate tiles take 512 bytes a
// channel): up to 379 channels at k = 40.

#include "edge_knn.cuh"

namespace pcl {

template <int KP>
__global__ void __launch_bounds__(kThreads)
    knn_kernel(const float* __restrict__ query, const float* __restrict__ pts,
               float* __restrict__ d2, int* __restrict__ idx, int m, int n,
               int c, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sm = reinterpret_cast<float*>(smem);
  float* nd = sm + knn_smem_words(c, k);  // [k][kKnnQ] d2 of the lists
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kKnnQ;
  const int* nbr = knn_block<KP>(query + (size_t)b * m * c, m,
                                 pts + (size_t)b * n * c, n, c, q0, k, sm,
                                 nd);
  const int nq = min(kKnnQ, m - q0);
  const size_t base = ((size_t)b * m + q0) * k;
  for (int e = threadIdx.x; e < nq * k; e += kThreads) {
    const int ql = e / k;
    const int s = (e - ql * k) * kKnnQ + ql;
    idx[base + e] = nbr[s];
    d2[base + e] = nd[s];
  }
}

template <int KP>
cudaError_t launch(const void* query, const void* pts, void* d2, void* idx,
                   int b, int m, int n, int c, int k, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      knn_kernel<KP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + kKnnQ - 1) / kKnnQ, b);
  knn_kernel<KP><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(query), static_cast<const float*>(pts),
      static_cast<float*>(d2), static_cast<int*>(idx), m, n, c, k);
  return cudaGetLastError();
}

}  // namespace pcl

// Shared memory bytes of one block for width c and k neighbours.
extern "C" long long knn_smem(int c, int k) {
  return 4LL * ((long long)pcl::knn_smem_words(c, k) +
                (long long)k * pcl::kKnnQ);
}

// query [b, m, c] f32, pts [b, n, c] f32; d2 [b, m, k] f32, idx [b, m, k]
// i32; all contiguous. Returns the launch's cudaGetLastError() code, or
// cudaErrorInvalidValue for sizes it does not take (k > n, k > 40, too
// much shared memory).
extern "C" int knn_launch(const void* query, const void* pts, void* d2,
                          void* idx, int b, int m, int n, int c, int k,
                          void* stream) {
  if (b < 1 || m < 1 || c < 1 || k < 1 || k > n || k > pcl::kKnnMaxK)
    return cudaErrorInvalidValue;
  const long long smem = knn_smem(c, k);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pcl::knn_list_length(k)) {
    case 8: return pcl::launch<8>(query, pts, d2, idx, b, m, n, c, k, smem, s);
    case 16: return pcl::launch<16>(query, pts, d2, idx, b, m, n, c, k, smem, s);
    case 24: return pcl::launch<24>(query, pts, d2, idx, b, m, n, c, k, smem, s);
    case 32: return pcl::launch<32>(query, pts, d2, idx, b, m, n, c, k, smem, s);
    case 40: return pcl::launch<40>(query, pts, d2, idx, b, m, n, c, k, smem, s);
    default: return cudaErrorInvalidValue;
  }
}
