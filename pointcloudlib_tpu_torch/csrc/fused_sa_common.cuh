// Pieces shared by the ball-query and fused set-abstraction kernels
// (ball query, eval, f1, tails, backward passes): bf16 unpacking, the BN
// affine with explicit round-to-nearest steps, the 64-row register-tiled
// product over bf16 operands with f32 sums on CUDA cores (left to the
// two-layer EdgeConv kernels, edge2.cuh), the ball-query distance and
// its warp scan, the max-pool gradient
// (within one tile, or folded across the tiles of a center with more
// than 64 slots), and the per-channel block reduction into a global sum.
//
// Every row of a tile runs the same instruction sequence, whatever its
// position, so repeat-first padding rows (replicas of slot 0) come out
// bit-identical to slot 0: the max-pool's tie split depends on it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pcl {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;  // grouped rows per pass through the chain

__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ float bf_at(const uint4& v, int t) {
  const uint32_t w = word(v, t >> 1);
  return (t & 1) ? bf_hi(w) : bf_lo(w);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  uint4 pk;
  pk.x = pack2(v[0], v[1]);
  pk.y = pack2(v[2], v[3]);
  pk.z = pack2(v[4], v[5]);
  pk.w = pack2(v[6], v[7]);
  return pk;
}
// float -> bf16 -> float, round to nearest even
__device__ __forceinline__ float bf_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// z = h*sc + bi, one rounding per operation (no FMA contraction)
__device__ __forceinline__ float bn_z(float h, float sc, float bi) {
  return __fadd_rn(__fmul_rn(h, sc), bi);
}
__device__ __forceinline__ float bn_relu(float h, float sc, float bi) {
  return fmaxf(bn_z(h, sc, bi), 0.0f);
}
// x^ = h*rs - mu*rs
__device__ __forceinline__ float xhat(float h, float rs, float mrs) {
  return __fsub_rn(__fmul_rn(h, rs), mrs);
}
// train-mode BN backward of one row given the pre-divided sums
// u1 = sum(dz)/R, u2 = sum(dz*x^)/R: sc * ((dz - u1) - x^*u2)
__device__ __forceinline__ float bn_bwd(float dz, float xh, float sc,
                                        float u1, float u2) {
  return __fmul_rn(sc, __fsub_rn(__fsub_rn(dz, u1), __fmul_rn(xh, u2)));
}

// d2 = max((|c|^2 - 2 c.p) + |p|^2, 0), the plain square_distance's
// order of operations; p.w holds |p|^2.
__device__ __forceinline__ float sq_dist(float cx, float cy, float cz,
                                         float c2, const float4& p) {
  const float inner = __fadd_rn(
      __fadd_rn(__fmul_rn(cx, p.x), __fmul_rn(cy, p.y)), __fmul_rn(cz, p.z));
  return fmaxf(__fadd_rn(__fsub_rn(c2, __fmul_rn(2.0f, inner)), p.w), 0.0f);
}
__device__ __forceinline__ float sumsq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// One step of a warp's ball query for the center (cx, cy, cz): the
// points ptss[base, base + 128) (p.w holds |p|^2) with d2 < r2 take the
// ranks count, count + 1, ... in index order; those below k go to
// nbr[rank] (shared or global memory). Returns count plus the step's
// hits. Four 32-point sets are tested before their ranks are taken, so
// that their distances are in flight together.
__device__ __forceinline__ int bq_step(float cx, float cy, float cz,
                                       const float4* ptss, int n, int k,
                                       float r2, int lane, int* nbr, int base,
                                       int count) {
  const float c2 = sumsq3(cx, cy, cz);
  unsigned bal[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int j = base + 32 * s + lane;
    bal[s] = __ballot_sync(
        0xffffffffu, j < n && sq_dist(cx, cy, cz, c2, ptss[j]) < r2);
  }
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int rank = count + __popc(bal[s] & below);
    if ((bal[s] >> lane & 1u) && rank < k) nbr[rank] = base + 32 * s + lane;
    count += __popc(bal[s]);
  }
  return count;
}
constexpr int kScanStep = 128;  // points a bq_step tests

// One warp finds a center's neighbours: the first k points of
// ptss[0, n) in index order with d2 < r2 go to nbr[0, k). Returns the
// number of hits, all of them.
__device__ __forceinline__ int bq_scan(const float* center,
                                       const float4* ptss, int n, int k,
                                       float r2, int lane, int* nbr) {
  const float cx = center[0], cy = center[1], cz = center[2];
  int count = 0;
  for (int base = 0; base < n; base += kScanStep)
    count = bq_step(cx, cy, cz, ptss, n, k, r2, lane, nbr, base, count);
  return count;
}

// Repeat-first padding of a scanned row by its warp: slots past
// min(count, k) repeat slot 0, a row with no hit is all 0.
__device__ __forceinline__ void bq_fill(int* nbr, int count, int k,
                                        int lane) {
  __syncwarp();
  if (count == 0 && lane == 0) nbr[0] = 0;
  __syncwarp();
  const int live = count == 0 ? 1 : min(count, k);
  const int first = nbr[0];
  for (int j = live + lane; j < k; j += 32) nbr[j] = first;
}

// Stages a cloud [n, 3] in shared memory as (x, y, z, |p|^2), by thread
// first of stride threads, four points a thread in flight.
__device__ __forceinline__ void stage_cloud(const float* pg, int n,
                                            float4* ptss, int first,
                                            int stride) {
  int j = first;
  for (; j + 3 * stride < n; j += 4 * stride) {
    float v[4][3];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int d = 0; d < 3; ++d) v[s][d] = pg[3 * (j + s * stride) + d];
#pragma unroll
    for (int s = 0; s < 4; ++s)
      ptss[j + s * stride] = make_float4(v[s][0], v[s][1], v[s][2],
                                         sumsq3(v[s][0], v[s][1], v[s][2]));
  }
  for (; j < n; j += stride) {
    const float x = pg[3 * j], y = pg[3 * j + 1], z = pg[3 * j + 2];
    ptss[j] = make_float4(x, y, z, sumsq3(x, y, z));
  }
}

__host__ __device__ constexpr int pow2_floor(int x) {
  int p = 1;
  while (2 * p <= x) p *= 2;
  return p;
}

// Thread layout of a [kRows, CIN] x [CIN, COUT] product: thread
// (rg, cg) = (tid / NCG, tid % NCG) owns rows [rg*RPT, rg*RPT + RPT) and
// channels [cg*8, cg*8+8). Where COUT / 8 does not divide the block (96
// channels: 12 groups), only the first ACTIVE = NCG*NRG threads own a
// tile and the rest sit that product out.
template <int COUT>
struct Tile {
  static constexpr int NCG = COUT / 8;
  static constexpr int NRG = pow2_floor(kThreads / NCG);
  static constexpr int RPT = kRows / NRG;
  static constexpr int ACTIVE = NCG * NRG;
  static_assert(COUT % 8 == 0 && NCG <= kThreads, "channel tiling");
  static_assert(RPT >= 1 && RPT <= 8 && kRows % NRG == 0, "row tiling");
  __device__ static bool active() { return threadIdx.x < ACTIVE; }
};

// acc = Y[rows of this thread] . W[:, 8 channels of this thread].
// ys: bf16 [kRows, CIN + 8] in shared memory, ws: bf16 [CIN, COUT] in
// shared or global memory, 16-byte aligned.
template <int CIN, int COUT>
__device__ __forceinline__ void product(const __nv_bfloat16* ys,
                                        const __nv_bfloat16* ws, int rg,
                                        int cg,
                                        float (&acc)[Tile<COUT>::RPT][8]) {
  constexpr int RPT = Tile<COUT>::RPT;
  constexpr int YS = CIN + 8;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;
#pragma unroll 2
  for (int kk = 0; kk < CIN; kk += 8) {
    uint4 yv[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      yv[i] = *reinterpret_cast<const uint4*>(ys + (rg * RPT + i) * YS + kk);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const uint4 wv =
          *reinterpret_cast<const uint4*>(ws + (kk + t) * COUT + cg * 8);
      float w[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) w[c] = bf_at(wv, c);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float y = bf_at(yv[i], t);
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(y, w[c], acc[i][c]);
      }
    }
  }
}

// Adds each thread's per-channel partial sums v[8] (channels cg*8..+8)
// into red[C] in shared memory, then red into out[C] in global memory.
// Every thread of the block must call it, those that own no tile of the
// product (Tile::active() false) with active = false; red is scratch of
// C floats.
template <int C>
__device__ __forceinline__ void flush_sum(const float (&v)[8], int cg,
                                          float* red, float* out,
                                          bool active = true) {
  __syncthreads();
  for (int i = threadIdx.x; i < C; i += kThreads) red[i] = 0.0f;
  __syncthreads();
  if (active) {
#pragma unroll
    for (int c = 0; c < 8; ++c) atomicAdd(red + cg * 8 + c, v[c]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < C; i += kThreads) atomicAdd(out + i, red[i]);
}

// Per-row gradient at z3 = BN3(h3) of the max over each center's k slots,
// split evenly among the slots that reach the max (replicas included),
// then masked by z3 > 0. For this thread's rows and channels, in place:
// z[i][c] (z3) becomes dz3. mx/ts are [cpt, C3] shared arrays, zeroed
// before the call; cl is the thread's center in the tile, dout_row that
// center's output gradient. Contains two block barriers.
template <int RPT, int C3>
__device__ __forceinline__ void maxpool_dz(float (&z)[RPT][8],
                                           const float* dout_row, int cl,
                                           int cg, float* mx, int* ts) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float m = 0.0f;
#pragma unroll
    for (int i = 0; i < RPT; ++i) m = fmaxf(m, fmaxf(z[i][c], 0.0f));
    atomicMax(reinterpret_cast<int*>(mx + cl * C3 + cg * 8 + c),
              __float_as_int(m));
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float m = mx[cl * C3 + cg * 8 + c];
    int n = 0;
#pragma unroll
    for (int i = 0; i < RPT; ++i) n += fmaxf(z[i][c], 0.0f) == m;
    atomicAdd(ts + cl * C3 + cg * 8 + c, n);
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float m = mx[cl * C3 + cg * 8 + c];
    const float share =
        __fdiv_rn(dout_row[cg * 8 + c], (float)ts[cl * C3 + cg * 8 + c]);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      z[i][c] = (z[i][c] > 0.0f && fmaxf(z[i][c], 0.0f) == m) ? share : 0.0f;
  }
}

// The same gradient for a center whose k slots span several 64-row tiles
// (k a multiple of 64, one center per tile). A first pass over the
// center's tiles folds each thread's (max, tie count) of relu(z3) into
// mc[C3]: one 64-bit word per channel, the max's bits above the count
// (non-negative floats order as their bits), zeroed before the center.
// A second pass turns z3 into dz3 from the folded words.
template <int RPT>
__device__ __forceinline__ void tie_merge(const float (&z)[RPT][8], int cg,
                                          unsigned long long* mc) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float m = 0.0f;
#pragma unroll
    for (int i = 0; i < RPT; ++i) m = fmaxf(m, fmaxf(z[i][c], 0.0f));
    unsigned n = 0;
#pragma unroll
    for (int i = 0; i < RPT; ++i) n += fmaxf(z[i][c], 0.0f) == m;
    const unsigned mb = __float_as_uint(m);
    unsigned long long* slot = mc + cg * 8 + c;
    unsigned long long old = *slot;
    while (true) {
      const unsigned ob = (unsigned)(old >> 32);
      if (mb < ob) break;
      const unsigned long long next =
          mb > ob ? ((unsigned long long)mb << 32) | n : old + n;
      const unsigned long long seen = atomicCAS(slot, old, next);
      if (seen == old) break;
      old = seen;
    }
  }
}

template <int RPT>
__device__ __forceinline__ void merged_dz(float (&z)[RPT][8],
                                          const float* dout_row, int cg,
                                          const unsigned long long* mc) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const unsigned long long w = mc[cg * 8 + c];
    const float m = __uint_as_float((unsigned)(w >> 32));
    const float share =
        __fdiv_rn(dout_row[cg * 8 + c], (float)(unsigned)(w & 0xffffffffu));
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      z[i][c] = (z[i][c] > 0.0f && fmaxf(z[i][c], 0.0f) == m) ? share : 0.0f;
  }
}

// How a center's k slots meet the 64-row tiles: k divides 64 (cpt whole
// centers a tile) or is a multiple of it (tpc tiles a center).
__host__ __device__ __forceinline__ bool k_ok(int k) {
  return k >= 8 && k % 8 == 0 && (kRows % k == 0 || k % kRows == 0);
}
__host__ __device__ __forceinline__ int centers_per_tile(int k) {
  return k < kRows ? kRows / k : 1;
}
__host__ __device__ __forceinline__ int tiles_per_center(int k) {
  return k < kRows ? 1 : k / kRows;
}

// Width triples (C1, C2, C3) the train kernels are compiled for.
#define PCL_TRAIN_WIDTHS(X) \
  X(32, 32, 64)             \
  X(64, 64, 128)            \
  X(64, 96, 128)            \
  X(128, 128, 256)

// Blocks for a grid-stride loop: as many as fit on the card at once,
// never more than there is work.
template <typename K>
cudaError_t resident_blocks(K kernel, size_t smem, long long work,
                            int* blocks, int threads = kThreads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long b = (long long)sms * per_sm;
  *blocks = (int)(work < b ? work : b);
  return cudaSuccess;
}

}  // namespace pcl
