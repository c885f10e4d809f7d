// Train-mode two-layer EdgeConv, the forward tails, for Hopper (sm_90a):
// one kernel templated on its stage.
//
// Replaces the TPU kernels pointcloudlib_tpu/ops/pallas/fused_edge.py
//   stats2: _e2_fwd / _e2_knn_fwd -> _ke2_stats2: [sum h2, sum h2^2]
//   out:    _e2_fwd / _e2_knn_fwd -> _ke2_out:    out = max_k leaky(z2)
// with h2 and z2 of every edge recomputed from the bf16 checkpoint
// h1 [B*M, k, C1] that edge_knn_f1.cu or edge_f1.cu wrote, and the folded
// BN rows of the layers already known (the chain of edge2.cuh).
//
// What bounds it: the product, 2*C1*C2 flops an edge (10.7 GFLOP a
// layer at B=16, N=2048, k=40), which this first version runs on the
// CUDA cores in f32, against reading h1 once (168 MB). Resident blocks
// walk tiles of 64 centers, one neighbour slot at a time (edge2.cuh); W2
// is staged once per block as bf16. The running max needs no traffic
// between threads; the sums reach global memory once per block and
// channel (atomicAdd: f32 in another order than the plain version).
//
// Numerics: y1 is bit-identical to the plain version; h2 sums in another
// order, so out agrees to f32 rounding of the product and the sums
// within 1e-3 of their largest element.

#include "edge2.cuh"

namespace pcl {

struct Edge2TailArgs {
  const __nv_bfloat16* h1;  // [centers, k, C1]
  const float* st;          // [4, C1] ++ [4, C2] (sc, bi, rs, mrs)
  const __nv_bfloat16* w2;  // [C1, C2]
  float* out;               // stats2: [2, C2] zeroed; out: [centers, C2]
  long long centers;
  int k;
  float slope;
};

template <int C1, int C2, bool OUT>
__global__ void __launch_bounds__(kThreads)
    edge2_tail_kernel(const Edge2TailArgs a) {
  using T2 = Tile<C2>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Edge2Smem<C1, C2> s(smem);
  stage_chain(s, a.w2, a.st);
  const int rg = threadIdx.x / T2::NCG, cg = threadIdx.x % T2::NCG;
  float acc[8] = {}, acc2[8] = {};  // stats2: this thread's sum, sum^2
  for (long long u = blockIdx.x; u < center_tiles(a.centers);
       u += gridDim.x) {
    const long long c0 = u * kRows;
    const int nc = (int)min((long long)kRows, a.centers - c0);
    float mx[T2::RPT][8];
#pragma unroll
    for (int i = 0; i < T2::RPT; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) mx[i][c] = -INFINITY;
    for (int kk = 0; kk < a.k; ++kk) {
      __syncthreads();  // the last slot's product is done with s.ys
      load_y1_slot(s, a.h1, c0, nc, a.k, kk, a.slope);
      __syncthreads();
      float h[T2::RPT][8];
      if (!OUT) {
        product<C1, C2>(s.ys, s.w2, rg, cg, h);
#pragma unroll
        for (int i = 0; i < T2::RPT; ++i) {
          if (rg * T2::RPT + i >= nc) continue;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            acc[c] += h[i][c];
            acc2[c] += h[i][c] * h[i][c];
          }
        }
      } else {
        chain_z2(s, rg, cg, h);
#pragma unroll
        for (int i = 0; i < T2::RPT; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            mx[i][c] = fmaxf(mx[i][c], leaky(h[i][c], a.slope));
      }
    }
    if (OUT) {
#pragma unroll
      for (int i = 0; i < T2::RPT; ++i) {
        const int r = rg * T2::RPT + i;
        if (r >= nc) continue;
        float* o = a.out + (size_t)(c0 + r) * C2 + cg * 8;
        *reinterpret_cast<float4*>(o) =
            make_float4(mx[i][0], mx[i][1], mx[i][2], mx[i][3]);
        *reinterpret_cast<float4*>(o + 4) =
            make_float4(mx[i][4], mx[i][5], mx[i][6], mx[i][7]);
      }
    }
  }
  if (!OUT) {
    flush_sum<C2>(acc, cg, s.red, a.out);
    flush_sum<C2>(acc2, cg, s.red, a.out + C2);
  }
}

template <int C1, int C2, bool OUT>
cudaError_t launch_tail2(const Edge2TailArgs& a, cudaStream_t stream) {
  constexpr size_t smem = Edge2Layout<C1, C2>::bytes;
  auto kernel = edge2_tail_kernel<C1, C2, OUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = resident_blocks(kernel, smem, center_tiles(a.centers), &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool OUT>
int tail2(const void* h1, const void* st, const void* w2, void* out,
          long long centers, int k, int c1, int c2, float slope,
          void* stream) {
  if (centers < 1 || k < 1) return cudaErrorInvalidValue;
  Edge2TailArgs a;
  a.h1 = static_cast<const __nv_bfloat16*>(h1);
  a.st = static_cast<const float*>(st);
  a.w2 = static_cast<const __nv_bfloat16*>(w2);
  a.out = static_cast<float*>(out);
  a.centers = centers;
  a.k = k;
  a.slope = slope;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PCL_LAUNCH(A, B) \
  if (c1 == A && c2 == B) return launch_tail2<A, B, OUT>(a, s);
  PCL_EDGE2_WIDTHS(PCL_LAUNCH)
#undef PCL_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace pcl

// h1 [centers, k, c1] bf16, st [4*c1 + 4*c2] f32 (the folded rows of both
// layers; stats2 reads only the first's), w2 [c1, c2] bf16, out [2, c2]
// f32 zeroed; all contiguous and 16-byte aligned. Returns the launch's
// cudaGetLastError() code, or cudaErrorInvalidValue for widths not
// compiled (PCL_EDGE2_WIDTHS) or an empty size.
extern "C" int edge2_stats2_launch(const void* h1, const void* st,
                                   const void* w2, void* out,
                                   long long centers, int k, int c1, int c2,
                                   float slope, void* stream) {
  return pcl::tail2<false>(h1, st, w2, out, centers, k, c1, c2, slope,
                           stream);
}

// As edge2_stats2_launch, with out [centers, c2] f32.
extern "C" int edge2_out_launch(const void* h1, const void* st,
                                const void* w2, void* out, long long centers,
                                int k, int c1, int c2, float slope,
                                void* stream) {
  return pcl::tail2<true>(h1, st, w2, out, centers, k, c1, c2, slope,
                          stream);
}
