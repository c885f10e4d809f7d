// The write half of forward pass 1, shared by the kernel with the ball
// query inside (fused_sa_bq_f1.cu), the one that takes a given idx
// (fused_sa_f1.cu) and the EdgeConv's pass 1 with the kNN inside
// (edge_knn_f1.cu) or from a given idx (edge_f1.cu), whose h is the same
// expression of its neighbour lists: one warp writes one center's h1
// rows,
//   h1[j] = bf16(float(bf16 Q[idx_j]) - off[center])   (one rounding),
// and keeps [sum h1, sum h1^2] of the f32 h1 in registers.
//
// The pass is bound by bytes: it writes h1 (67-268 MB at the train
// shapes) and gathers q rows from L2. So:
// - a lane owns 8 channels: one 16-byte gather of q and one 16-byte
//   store of h1 a row, C1/8 lanes a row and 32/(C1/8) rows a warp
//   instruction; its 8 off values stay in registers for the center;
// - the neighbour index is read once a row from shared memory, with no
//   division in the loop, and kF1Unroll gathers are in flight before the
//   first store;
// - a slot whose index equals slot 0's (the ball query's repeat-first
//   padding, or any repeat of idx[0]) is a copy of slot 0's row, which
//   the warp converts once: no gather, and its sums come in as a count
//   times slot 0's h and h^2;
// - a lane's sums stay in registers across all its rows and centers;
//   they fold inside the warp by __shfl_xor, go into shared memory once a
//   warp and into psum once a block and channel (f1_flush).

#pragma once

#include "fused_sa_common.cuh"

namespace pcl {

// Tuning constants, each timed against other values by
// tools/kernel_variants.py.
constexpr int kF1Unroll = 4;       // gathers in flight a lane
constexpr int kF1MinBlocks = 3;    // launch bounds: blocks an SM

template <int C1>
struct F1Lanes {
  static constexpr int L = C1 / 8;    // lanes a row
  static constexpr int RPW = 32 / L;  // rows a warp instruction
  static_assert(C1 % 8 == 0 && L <= 32 && 32 % L == 0, "8 channels a lane");
};

struct F1Sums {
  float s[8], ss[8];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int c = 0; c < 8; ++c) s[c] = ss[c] = 0.0f;
  }
  __device__ __forceinline__ void add(const float (&h)[8], float times) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      s[c] = fmaf(times, h[c], s[c]);
      ss[c] = fmaf(times, h[c] * h[c], ss[c]);
    }
  }
};

// h1's 16-byte stores carry the streaming hint (st.global.cs): h1 is
// written once and never fits the 50 MB L2, so its lines go first and
// the gathered q rows stay. Plain stores, and rows staged in shared
// memory for bulk asynchronous copies, were slower on the card
// (tools/kernel_variants.py: plain_store, bulk4k).
__device__ __forceinline__ void f1_store(__nv_bfloat16* p, const uint4& v) {
  __stcs(reinterpret_cast<uint4*>(p), v);
}

// Rows [j0, j1) of a center, this lane's 8 channels: row jj goes to
// dst + (jj - j0) * C1. first/p0: slot 0's index and packed row; a row
// whose index is first is stored as p0 and left out of the sums
// (f1_center adds them).
template <int C1>
__device__ __forceinline__ void f1_span(const __nv_bfloat16* qc,
                                        const float (&off)[8],
                                        const int* nbr, int first,
                                        const uint4& p0, int j0, int j1,
                                        int rr, __nv_bfloat16* dst,
                                        F1Sums& s) {
  constexpr int RPW = F1Lanes<C1>::RPW;
  for (int j = j0 + rr; j < j1; j += RPW * kF1Unroll) {
    int id[kF1Unroll];
    uint4 v[kF1Unroll];
#pragma unroll
    for (int u = 0; u < kF1Unroll; ++u) {
      const int jj = j + u * RPW;
      id[u] = jj < j1 ? nbr[jj] : first;
      v[u] = p0;
      if (id[u] != first)
        v[u] = __ldg(
            reinterpret_cast<const uint4*>(qc + (size_t)id[u] * C1));
    }
#pragma unroll
    for (int u = 0; u < kF1Unroll; ++u) {
      const int jj = j + u * RPW;
      if (jj >= j1) break;
      __nv_bfloat16* row = dst + (size_t)(jj - j0) * C1;
      if (id[u] == first) {
        f1_store(row, p0);
      } else {
        float h[8];
#pragma unroll
        for (int c = 0; c < 8; ++c)
          h[c] = __fsub_rn(bf_at(v[u], c), off[c]);
        s.add(h, 1.0f);
        f1_store(row, pack8(h));
      }
    }
  }
}

// One warp writes the k rows of one center: qg the cloud's q [N, C1],
// offc the center's off [C1], hc its h1 rows [k, C1], nbr its index row
// in shared memory (read only).
template <int C1>
__device__ __forceinline__ void f1_center(const __nv_bfloat16* qg,
                                          const float* offc,
                                          __nv_bfloat16* hc, const int* nbr,
                                          int k, int lane, F1Sums& s) {
  constexpr int L = F1Lanes<C1>::L;
  const int cg = lane % L, rr = lane / L;
  const float4 oa = reinterpret_cast<const float4*>(offc)[2 * cg];
  const float4 ob = reinterpret_cast<const float4*>(offc)[2 * cg + 1];
  const float off[8] = {oa.x, oa.y, oa.z, oa.w, ob.x, ob.y, ob.z, ob.w};
  const __nv_bfloat16* qc = qg + cg * 8;
  const int first = nbr[0];
  const uint4 q0 =
      __ldg(reinterpret_cast<const uint4*>(qc + (size_t)first * C1));
  float h0[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) h0[c] = __fsub_rn(bf_at(q0, c), off[c]);
  const uint4 p0 = pack8(h0);
  // slot 0 and its copies come into the sums as one count times slot
  // 0's h and h^2, added by the first lane of each channel group
  int reps = 0;
  for (int jb = 0; jb < k; jb += 32) {
    const int j = jb + lane;
    reps += __popc(__ballot_sync(0xffffffffu, j < k && nbr[j] == first));
  }
  if (rr == 0) s.add(h0, (float)reps);
  f1_span<C1>(qc, off, nbr, first, p0, 0, k, rr, hc + cg * 8, s);
}

// Every lane's sums into psum [2, C1]: folded over the lanes that share
// channels, added into red (2*C1 floats of shared memory, zeroed before
// a block barrier) by the first C1/8 lanes of each warp, then into psum
// once a channel. Every thread of the block calls it, after its last
// f1_center.
template <int C1>
__device__ __forceinline__ void f1_flush(F1Sums& s, int lane, float* red,
                                         float* psum) {
  constexpr int L = F1Lanes<C1>::L;
#pragma unroll
  for (int o = L; o < 32; o *= 2) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      s.s[c] += __shfl_xor_sync(0xffffffffu, s.s[c], o);
      s.ss[c] += __shfl_xor_sync(0xffffffffu, s.ss[c], o);
    }
  }
  if (lane < L) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      atomicAdd(red + lane * 8 + c, s.s[c]);
      atomicAdd(red + C1 + lane * 8 + c, s.ss[c]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * C1; i += blockDim.x)
    atomicAdd(psum + i, red[i]);
}

// The pass 1 that takes a given idx [centers, k]: the set abstraction's
// (fused_sa_f1.cu) and the EdgeConv's (edge_f1.cu). One wave of resident
// blocks whose warps walk the centers, a center a warp: the warp reads
// the center's idx row with one vector load a lane into shared memory,
// then writes its rows with f1_center. Each source wraps f1_idx_walk in
// a kernel of its own name, so that profiles tell the two apart.

// Dynamic shared memory: an index row a warp, the block's sums.
inline size_t f1_idx_smem(int k, int c1) {
  return (size_t)kWarps * ((k + 3) / 4 * 16) + (size_t)2 * c1 * 4;
}

// q [batch, n, C1] bf16, off [batch, m, C1], idx [batch, m, k] with
// every entry in [0, n), h1 [batch, m, k, C1]; psum [2, C1] zeroed by the
// caller. Every thread of the block calls it once.
template <int C1>
__device__ __forceinline__ void f1_idx_walk(const __nv_bfloat16* q,
                                            const float* off, const int* idx,
                                            __nv_bfloat16* h1, float* psum,
                                            int n, int m, int k,
                                            long long centers) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int kp = (k + 3) / 4 * 4;
  int* nbr = reinterpret_cast<int*>(smem) + warp * kp;
  float* red = reinterpret_cast<float*>(smem + (size_t)kWarps * kp * 4);
  for (int i = threadIdx.x; i < 2 * C1; i += kThreads) red[i] = 0.0f;
  __syncthreads();

  F1Sums s;
  s.zero();
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long center = (long long)blockIdx.x * kWarps + warp;
       center < centers; center += stride) {
    const int* ig = idx + center * k;
    if (k % 4 == 0) {
      for (int e = 4 * lane; e < k; e += 128)
        *reinterpret_cast<int4*>(nbr + e) =
            __ldg(reinterpret_cast<const int4*>(ig + e));
    } else {
      for (int e = lane; e < k; e += 32) nbr[e] = __ldg(ig + e);
    }
    __syncwarp();
    f1_center<C1>(q + (center / m) * n * C1, off + center * C1,
                  h1 + center * k * C1, nbr, k, lane, s);
    __syncwarp();  // before the next row overwrites nbr
  }
  f1_flush<C1>(s, lane, red, psum);
}

// Launches kernel, a __global__ wrapper of f1_idx_walk<C1> with launch
// bounds (kThreads, kF1MinBlocks), as one wave of resident blocks (never
// more blocks than a warp a center needs).
template <int C1, typename K>
cudaError_t launch_f1_idx(K kernel, const void* q, const void* off,
                          const void* idx, void* h1, void* psum, int batch,
                          int n, int m, int k, cudaStream_t stream) {
  const size_t smem = f1_idx_smem(k, C1);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  int wave = 0;
  cudaError_t err = wave_blocks(kernel, smem, &wave);
  if (err != cudaSuccess) return err;
  const long long centers = (long long)batch * m;
  const int blocks =
      (int)std::min<long long>(wave, (centers + kWarps - 1) / kWarps);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const float*>(off),
      static_cast<const int*>(idx), static_cast<__nv_bfloat16*>(h1),
      static_cast<float*>(psum), n, m, k, centers);
  return cudaGetLastError();
}

}  // namespace pcl
