// 3-NN inverse-distance interpolation for Hopper (sm_90a).
//
// Replaces the TPU kernel pointcloudlib_tpu/ops/pallas/neighbors.py
// (_three_interp_fwd_call -> _k_three_interp). For each query q of
// query [B, M, 3] against support points [B, N, 3] with features
// feats [B, N, C]:
//   idx [B, M, 3] i32 — the three smallest
//       d2 = max((|q|^2 - 2 q.p) + |p|^2, 0), ascending, the lower index
//       first on ties (three masked argmins);
//   w [B, M, 3] f32   — inv_j = 1 / (sum_c (q - p_j)^2 + 1e-8), the
//       distance recomputed exactly from the selected coordinates (a
//       query equal to a support point gets d2 = 0 and weight ~1: a hard
//       copy), normalized w_j = inv_j / ((inv_0 + inv_1) + inv_2);
//   out [B, M, C] f32 — (w_0 f_0 + w_1 f_1) + w_2 f_2.
//
// The TPU kernel selects with three argmin rounds over a [mt, N]
// distance tile and gathers through a [3 mt, N] one-hot matmul (bf16
// hi/lo splits), because gathers are slow on its vector unit. Here a
// block stages one batch element's support cloud in shared memory and
// takes kTiThreads / G of its queries, G lanes a query:
// - selection: each lane of a query's group walks every G-th support
//   point in index order and keeps its three smallest d2 with a strict
//   "<" (ties keep the earlier index ahead), then the group merges its
//   lanes' lists by __shfl_xor_sync in (d2, j) lexicographic order: the
//   three least of the union, which is what one walk over all points
//   keeps, so idx is the same;
// - output rows: the block's queries' rows are cut into units of 4
//   channels (1 where C % 4 != 0) shared by all its threads, kTiUnroll
//   units a thread at a time with their 3 * kTiUnroll row gathers in
//   flight before the first 16-byte store.
// G is chosen by the wrapper from the shapes (three_interp.py
// interp_group) so that the grid fills the card: 32 lanes a query at the
// coarsest decoder level (16 clouds of 64 queries), 2 at the finest (16
// clouds of 2,048).
//
// What bounds it: bytes. It reads B*(M+N)*12 + B*N*C*4 bytes and writes
// B*M*C*4 + B*M*24, against ~10 f32 operations for each of the B*M*N
// (query, point) pairs and 5 per output element. The walk is the other
// limit at the finest level (33.5 M pairs at B=16, M=2048, N=1024, ~12
// instructions a pair): with two lanes a query the card holds 16 warps
// an SM there, and the walk issues at about half the card's rate.
//
// Numerics: explicit round-to-nearest operations in the plain version's
// order (no FMA contraction), so idx is bit-identical to
// three_interp_plain and w and out agree with it to the last bits.

#include "fused_sa_common.cuh"

namespace pcl {

// Tuning constants, each timed against other values by
// tools/kernel_variants.py (--only interp).
constexpr int kTiThreads = 256;
constexpr int kTiUnroll = 4;     // output units a thread has in flight
constexpr int kTiMinBlocks = 3;  // launch bounds: blocks an SM
constexpr int kTiNone = 0x7fffffff;  // index of an empty list slot

// Three (d2, j) kept in lexicographic order.
struct Near3 {
  float d[3];
  int j[3];
};

__device__ __forceinline__ bool lex_less(float d, int j, float e, int i) {
  return d < e || (d == e && j < i);
}

// (d, j) into the list. The walk's step (Lex false) compares d2 alone
// with a strict "<": its j is above every index the list holds, so a tie
// keeps the earlier entry ahead, as in the sequential walk. The merge's
// step (Lex true) compares (d2, j) lexicographically.
template <bool Lex>
__device__ __forceinline__ void near3_insert(Near3& s, float d, int j) {
  auto less = [&](int r) {
    return Lex ? lex_less(d, j, s.d[r], s.j[r]) : d < s.d[r];
  };
  if (!less(2)) return;
  if (less(1)) {
    s.d[2] = s.d[1];
    s.j[2] = s.j[1];
    if (less(0)) {
      s.d[1] = s.d[0];
      s.j[1] = s.j[0];
      s.d[0] = d;
      s.j[0] = j;
    } else {
      s.d[1] = d;
      s.j[1] = j;
    }
  } else {
    s.d[2] = d;
    s.j[2] = j;
  }
}

// A lane's walk over support points first, first + G, ... in index
// order, each d2 formed by sq_dist (the plain order) and pushed.
template <int G>
__device__ __forceinline__ void near3_walk(Near3& s, const float4* ptss,
                                           int n, int first, float qx,
                                           float qy, float qz, float q2) {
#pragma unroll 4
  for (int j = first; j < n; j += G)
    near3_insert<false>(s, sq_dist(qx, qy, qz, q2, ptss[j]), j);
}

// (w0 a + w1 b) + w2 c, one rounding an operation
__device__ __forceinline__ float mix3(float w0, float a, float w1, float b,
                                      float w2, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b)),
                   __fmul_rn(w2, c));
}

// An output unit of V channels: 4 (16-byte loads and stores) or 1.
template <int V>
struct TiVec {
  using T = float;
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, const T& v) {
    *p = v;
  }
  static __device__ __forceinline__ T mix(float w0, const T& a, float w1,
                                          const T& b, float w2, const T& c) {
    return mix3(w0, a, w1, b, w2, c);
  }
};
template <>
struct TiVec<4> {
  using T = float4;
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void store(float* p, const T& v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  static __device__ __forceinline__ T mix(float w0, const T& a, float w1,
                                          const T& b, float w2, const T& c) {
    return make_float4(mix3(w0, a.x, w1, b.x, w2, c.x),
                       mix3(w0, a.y, w1, b.y, w2, c.y),
                       mix3(w0, a.z, w1, b.z, w2, c.z),
                       mix3(w0, a.w, w1, b.w, w2, c.w));
  }
};

// G lanes a query, kTiThreads / G queries a block; V channels an output
// unit (4: 16-byte loads and stores, C % 4 == 0).
template <int G, int V>
__global__ void __launch_bounds__(kTiThreads, kTiMinBlocks)
    three_interp_kernel(const float* __restrict__ query,
                        const float* __restrict__ pts,
                        const float* __restrict__ feats,
                        float* __restrict__ out, int* __restrict__ idx,
                        float* __restrict__ wout, int n, int m, int c) {
  constexpr int Q = kTiThreads / G;  // queries a block
  static_assert(G >= 2 && G <= 32 && (G & (G - 1)) == 0, "lane group");
  extern __shared__ __align__(16) unsigned char smem[];
  float4* ptss = reinterpret_cast<float4*>(smem);
  __shared__ int s_idx[Q][3];
  __shared__ float s_w[Q][3];

  const int b = blockIdx.y;
  const int m0 = blockIdx.x * Q;
  const int t = threadIdx.x;
  stage_cloud(pts + (size_t)b * n * 3, n, ptss, t, kTiThreads);
  __syncthreads();

  // selection: every lane of a group walks, then the group merges
  const int ql = t / G, gl = t % G;
  const int i = min(m0 + ql, m - 1);  // a group past m repeats the last
  const float* qp = query + ((size_t)b * m + i) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  const float q2 = sumsq3(qx, qy, qz);
  Near3 s;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    s.d[r] = INFINITY;
    s.j[r] = kTiNone;
  }
  near3_walk<G>(s, ptss, n, gl, qx, qy, qz, q2);
#pragma unroll
  for (int o = 1; o < G; o *= 2) {
    float pd[3];
    int pj[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      pd[r] = __shfl_xor_sync(0xffffffffu, s.d[r], o);
      pj[r] = __shfl_xor_sync(0xffffffffu, s.j[r], o);
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) near3_insert<true>(s, pd[r], pj[r]);
  }
  if (gl == 0 && m0 + ql < m) {
    // an empty slot (no d2 below +inf) takes index 0, as the sequential
    // walk's initial entries do
    int sel[3];
    float inv[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      sel[r] = s.j[r] == kTiNone ? 0 : s.j[r];
      const float4 p = ptss[sel[r]];
      const float e = sumsq3(__fsub_rn(qx, p.x), __fsub_rn(qy, p.y),
                             __fsub_rn(qz, p.z));
      inv[r] = __frcp_rn(__fadd_rn(e, 1e-8f));
    }
    const float denom = __fadd_rn(__fadd_rn(inv[0], inv[1]), inv[2]);
    const size_t row = (size_t)b * m + i;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float w = __fdiv_rn(inv[r], denom);
      s_idx[ql][r] = sel[r];
      s_w[ql][r] = w;
      idx[row * 3 + r] = sel[r];
      wout[row * 3 + r] = w;
    }
  }
  __syncthreads();

  // output rows: units of V channels shared by the whole block, a
  // thread's next unit kTiThreads further on (its row and column stepped
  // without a division)
  using Vec = TiVec<V>;
  const int cu = c / V;                 // units a row
  const int nq = min(Q, m - m0);
  const int sq = kTiThreads / cu, sc = kTiThreads - sq * cu;
  int qq = t / cu, ch = t - qq * cu;
  const float* fb = feats + (size_t)b * n * c;
  float* ob = out + ((size_t)b * m + m0) * c;
  while (qq < nq) {
    typename Vec::T f[kTiUnroll][3];
    int uq[kTiUnroll], uc[kTiUnroll];
#pragma unroll
    for (int u = 0; u < kTiUnroll; ++u) {
      uq[u] = qq;
      uc[u] = ch;
      if (qq < nq) {
#pragma unroll
        for (int r = 0; r < 3; ++r)
          f[u][r] = Vec::load(fb + (size_t)s_idx[qq][r] * c + ch * V);
      }
      qq += sq;
      ch += sc;
      if (ch >= cu) {
        ch -= cu;
        ++qq;
      }
    }
#pragma unroll
    for (int u = 0; u < kTiUnroll; ++u) {
      if (uq[u] >= nq) break;
      Vec::store(ob + (size_t)uq[u] * c + uc[u] * V,
                 Vec::mix(s_w[uq[u]][0], f[u][0], s_w[uq[u]][1], f[u][1],
                          s_w[uq[u]][2], f[u][2]));
    }
  }
}

template <int G>
cudaError_t launch_ti(const float* query, const float* pts,
                      const float* feats, float* out, int* idx, float* w,
                      int b, int n, int m, int c, cudaStream_t stream) {
  const size_t smem = (size_t)n * 16;
  auto kernel = c % 4 == 0 ? three_interp_kernel<G, 4>
                           : three_interp_kernel<G, 1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int Q = kTiThreads / G;
  const dim3 grid((m + Q - 1) / Q, b);
  kernel<<<grid, kTiThreads, smem, stream>>>(query, pts, feats, out, idx, w,
                                             n, m, c);
  return cudaGetLastError();
}

}  // namespace pcl

// query [b, m, 3], pts [b, n, 3], feats [b, n, c] f32 contiguous; out
// [b, m, c] f32, idx [b, m, 3] i32, w [b, m, 3] f32; group: lanes a
// query, 2, 4, 8, 16 or 32. Returns the launch's cudaGetLastError()
// code, or cudaErrorInvalidValue for what it does not take (n < 3, a
// cloud beyond one block's shared memory, another group).
extern "C" int three_interp_launch(const void* query, const void* pts,
                                   const void* feats, void* out, void* idx,
                                   void* w, int b, int n, int m, int c,
                                   int group, void* stream) {
  if (b < 1 || n < 3 || m < 1 || c < 1) return cudaErrorInvalidValue;
  // the cloud, beside idx and w of the largest block's 128 queries
  const size_t fixed = (sizeof(int) + sizeof(float)) * 3 * 128;
  if ((size_t)n * 16 + fixed > 227 * 1024) return cudaErrorInvalidValue;
  auto q = static_cast<const float*>(query);
  auto p = static_cast<const float*>(pts);
  auto f = static_cast<const float*>(feats);
  auto o = static_cast<float*>(out);
  auto ix = static_cast<int*>(idx);
  auto wt = static_cast<float*>(w);
  auto s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 2: return pcl::launch_ti<2>(q, p, f, o, ix, wt, b, n, m, c, s);
    case 4: return pcl::launch_ti<4>(q, p, f, o, ix, wt, b, n, m, c, s);
    case 8: return pcl::launch_ti<8>(q, p, f, o, ix, wt, b, n, m, c, s);
    case 16: return pcl::launch_ti<16>(q, p, f, o, ix, wt, b, n, m, c, s);
    case 32: return pcl::launch_ti<32>(q, p, f, o, ix, wt, b, n, m, c, s);
    default: return cudaErrorInvalidValue;
  }
}
