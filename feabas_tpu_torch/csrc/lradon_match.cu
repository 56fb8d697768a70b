// Rotation-exhaustive mutual-nearest LRadon descriptor matching for Hopper.
//
// Replaces feabas_tpu/ops/lradon.py:_match_body (with _variants), which XLA
// ran as a scan over the 2P rotation variants of d1, each a (K1, PB) x
// (PB, K0) product at Precision.HIGHEST into a running (K1, K0) plane in
// device memory, followed by five reductions over that plane:
//     S_r[n, m] = valid(n, m) ? sum_j d1[n, perm_r[j]] * d0[m, j] : -inf
//     best_rot  = the first r whose max(S_r) is strictly the largest
//     S = S_best_rot;   i0[n] = first argmax_m S[n, m];   top[n] = max_m S
//     second[n] = max_m S[n, m] with column i0[n] removed
//     back[m]   = first argmax_n S[n, m]
//     mutual[n] = back[i0[n]] == n && v1[n]
//     conf[n]   = top > 0 ? 1 - max(second, 0) / max(top, 1e-6) : 0
// A rotation variant is a fixed permutation of the PB descriptor entries
// (ops/lradon._variant_perms), so d1 is never copied. No similarity plane is
// written to memory at all.
//
// What bounds it on an H100: operations. 12 variants of 5000 x 5000 x 48
// cost 28.8 GFLOP (430 us at 67 TFLOP/s) against 2 MB of descriptors and
// O(K) results. The design is the simple one that is right:
//   * one register-tiled f32 product (64 x 64 tile, 256 threads, 4 x 4 per
//     thread, operands k-major in shared memory, FMA over j in ascending
//     order) used by two passes;
//   * pass 1 (grid: row tiles x variants) reduces max(S_r) with an
//     atomicMax on the order-preserving integer image of the float, which
//     no order of arrival can change;
//   * pass 2 (grid: row tiles) recomputes S for the winner. Every
//     reduction is a max over 64-bit keys (ordered value << 32 | ~index):
//     the largest key is the largest value at its smallest index, and keys
//     are distinct within a row or column, so the second-largest key of a
//     row carries `second` (equal to `top` when two columns tie). A block
//     owns its rows over all K0 columns, so row keys need no atomics; column
//     keys are reduced in shared memory and then with one atomicMax per
//     column, tile and block. The result does not depend on block order.
//   * pass 3 decodes the keys into the O(K) outputs.
//
// Plain C interface, loaded with ctypes. The entry point launches on the
// given stream, allocates nothing, and returns a cudaError_t (0 = launched).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;             // rows and columns of S per tile
constexpr int kLd = kTile + 4;        // shared-memory row stride (floats)
constexpr int kThreads = 256;         // 16 x 16, 4 x 4 outputs each
constexpr int kMaxSmem = 232448;
typedef unsigned long long u64;

// order-preserving map of a float onto an unsigned integer (-0 -> +0 first)
__device__ __forceinline__ unsigned ord(float v) {
  const unsigned u = __float_as_uint(v + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unord(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ u64 make_key(float v, int index) {
  return ((u64)ord(v) << 32) | (u64)(0xffffffffu - (unsigned)index);
}

// the first variant whose maximum is strictly above all earlier ones
__device__ __forceinline__ int best_variant(const unsigned* gmax, int nvar) {
  int best = 0;
  if (gmax == nullptr) return 0;
  unsigned m = ord(-INFINITY);
  for (int r = 0; r < nvar; ++r)
    if (gmax[r] > m) { m = gmax[r]; best = r; }
  return best;
}

// dst[j * kLd + r] = d[(row0 + r) * dlen + perm[j]] for r < kTile (0 past
// the last row)
__device__ __forceinline__ void load_tile(float* dst, const float* d,
                                          const int* perm, int row0,
                                          int nrows, int dlen) {
  for (int i = threadIdx.x; i < kTile * dlen; i += kThreads) {
    const int r = i / dlen, j = i - r * dlen;
    const int row = row0 + r;
    float v = 0.0f;
    if (row < nrows) v = d[(size_t)row * dlen + (perm ? perm[j] : j)];
    dst[j * kLd + r] = v;
  }
}

// acc[a][b] = sum_j As[j][ty * 4 + a] * Bs[j][tx * 4 + b], j ascending
__device__ __forceinline__ void tile_product(const float* As, const float* Bs,
                                             int dlen, int ty, int tx,
                                             float (&acc)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
  for (int j = 0; j < dlen; ++j) {
    const float4 av = *reinterpret_cast<const float4*>(As + j * kLd + ty * 4);
    const float4 bv = *reinterpret_cast<const float4*>(Bs + j * kLd + tx * 4);
    const float a4[4] = {av.x, av.y, av.z, av.w};
    const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(a4[a], b4[b], acc[a][b]);
  }
}

// pass 1: gmax[r] = max over valid (n, m) of S_r, as ord()
__global__ void __launch_bounds__(kThreads)
variant_max_kernel(const float* __restrict__ d0, const uint8_t* __restrict__ v0,
                   const float* __restrict__ d1, const uint8_t* __restrict__ v1,
                   const int* __restrict__ perms, unsigned* gmax, int K0,
                   int K1, int dlen) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float warp_max[kThreads / 32];
  float* As = smem;
  float* Bs = smem + (size_t)dlen * kLd;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int row0 = blockIdx.x * kTile;
  const int r = blockIdx.y;
  load_tile(As, d1, perms + (size_t)r * dlen, row0, K1, dlen);
  bool rv[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = row0 + ty * 4 + a;
    rv[a] = row < K1 && v1[row] != 0;
  }
  float m = -INFINITY;
  for (int col0 = 0; col0 < K0; col0 += kTile) {
    __syncthreads();
    load_tile(Bs, d0, nullptr, col0, K0, dlen);
    __syncthreads();
    float acc[4][4];
    tile_product(As, Bs, dlen, ty, tx, acc);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int col = col0 + tx * 4 + b;
      const bool cv = col < K0 && v0[col] != 0;
#pragma unroll
      for (int a = 0; a < 4; ++a)
        if (cv && rv[a]) m = fmaxf(m, acc[a][b]);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kThreads / 32; ++i) m = fmaxf(m, warp_max[i]);
    atomicMax(gmax + r, ord(m));
  }
}

__device__ __forceinline__ void push_key(u64 key, u64& k1, u64& k2) {
  if (key > k1) {
    k2 = k1;
    k1 = key;
  } else if (key > k2) {
    k2 = key;
  }
}

// pass 2: the two largest keys of every row and the largest of every column
// of the winning variant's S
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const float* __restrict__ d0, const uint8_t* __restrict__ v0,
              const float* __restrict__ d1, const uint8_t* __restrict__ v1,
              const int* __restrict__ perms, const unsigned* __restrict__ gmax,
              int nvar, u64* rowkey1, u64* rowkey2, u64* colkey, int K0,
              int K1, int dlen) {
  extern __shared__ __align__(16) float smem[];
  __shared__ u64 scol[kTile];
  float* As = smem;
  float* Bs = smem + (size_t)dlen * kLd;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int row0 = blockIdx.x * kTile;
  const int best = best_variant(gmax, nvar);
  load_tile(As, d1, perms + (size_t)best * dlen, row0, K1, dlen);
  bool rv[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = row0 + ty * 4 + a;
    rv[a] = row < K1 && v1[row] != 0;
  }
  u64 k1[4] = {0, 0, 0, 0}, k2[4] = {0, 0, 0, 0};
  for (int col0 = 0; col0 < K0; col0 += kTile) {
    __syncthreads();
    load_tile(Bs, d0, nullptr, col0, K0, dlen);
    if (threadIdx.x < kTile) scol[threadIdx.x] = 0;
    __syncthreads();
    float acc[4][4];
    tile_product(As, Bs, dlen, ty, tx, acc);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int col = col0 + tx * 4 + b;
      if (col >= K0) continue;
      const bool cv = v0[col] != 0;
      u64 cbest = 0;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int row = row0 + ty * 4 + a;
        if (row >= K1) continue;
        const float s = (cv && rv[a]) ? acc[a][b] : -INFINITY;
        push_key(make_key(s, col), k1[a], k2[a]);
        const u64 ck = make_key(s, row);
        cbest = ck > cbest ? ck : cbest;
      }
      if (cbest != 0) atomicMax(&scol[tx * 4 + b], cbest);
    }
    __syncthreads();
    if (threadIdx.x < kTile && col0 + threadIdx.x < K0
        && scol[threadIdx.x] != 0)
      atomicMax(colkey + col0 + threadIdx.x, scol[threadIdx.x]);
  }
  // merge the 16 column-slices of each row; the product buffers are free
  __syncthreads();
  u64* m1 = reinterpret_cast<u64*>(smem);          // [kTile][16]
  u64* m2 = m1 + kTile * 16;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m1[(ty * 4 + a) * 16 + tx] = k1[a];
    m2[(ty * 4 + a) * 16 + tx] = k2[a];
  }
  __syncthreads();
  if (threadIdx.x < kTile && row0 + threadIdx.x < K1) {
    u64 a1 = 0, a2 = 0;
    for (int i = 0; i < 16; ++i) {
      push_key(m1[threadIdx.x * 16 + i], a1, a2);
      push_key(m2[threadIdx.x * 16 + i], a1, a2);
    }
    rowkey1[row0 + threadIdx.x] = a1;
    rowkey2[row0 + threadIdx.x] = a2;
  }
}

// pass 3: keys -> i0, top, conf, mutual, best_rot
__global__ void finish_kernel(const u64* __restrict__ rowkey1,
                              const u64* __restrict__ rowkey2,
                              const u64* __restrict__ colkey,
                              const uint8_t* __restrict__ v1,
                              const unsigned* __restrict__ gmax, int nvar,
                              int* i0, float* top, float* conf,
                              uint8_t* mutual, int* best_rot, int K1) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n == 0) best_rot[0] = best_variant(gmax, nvar);
  if (n >= K1) return;
  const u64 a1 = rowkey1[n], a2 = rowkey2[n];
  const int idx = (int)(0xffffffffu - (unsigned)(a1 & 0xffffffffu));
  const float t = unord((unsigned)(a1 >> 32));
  const float s = a2 != 0 ? unord((unsigned)(a2 >> 32)) : -INFINITY;
  const int back = (int)(0xffffffffu - (unsigned)(colkey[idx] & 0xffffffffu));
  i0[n] = idx;
  top[n] = t;
  conf[n] = t > 0.0f ? 1.0f - fmaxf(s, 0.0f) / fmaxf(t, 1e-6f) : 0.0f;
  mutual[n] = (back == n && v1[n] != 0) ? 1 : 0;
}

size_t product_smem(int dlen) {
  const size_t prod = 2 * (size_t)dlen * kLd * sizeof(float);
  const size_t merge = 2 * (size_t)kTile * 16 * sizeof(u64);
  return prod > merge ? prod : merge;
}

}  // namespace

// d0: (K0, dlen) f32, d1: (K1, dlen) f32; v0, v1: validity bytes; perms:
// (nvar, dlen) int32, variant r of d1 is d1[:, perms[r]] (row 0 the
// identity); gmax: (nvar) uint32 scratch, zeroed; rowkey1, rowkey2: (K1)
// uint64 scratch; colkey: (K0) uint64 scratch, zeroed. Outputs: i0 (K1)
// int32, top, conf (K1) f32, mutual (K1) bytes, best_rot (1) int32. With
// nvar == 1 the rotation search is skipped (best_rot = 0).
extern "C" int lradon_match_f32(const float* d0, const uint8_t* v0,
                                const float* d1, const uint8_t* v1,
                                const int* perms, int nvar, unsigned* gmax,
                                u64* rowkey1, u64* rowkey2, u64* colkey,
                                int* i0, float* top, float* conf,
                                uint8_t* mutual, int* best_rot, int K0,
                                int K1, int dlen, cudaStream_t stream) {
  if (K0 < 1 || K1 < 1 || dlen < 1 || nvar < 1) return (int)cudaErrorInvalidValue;
  const size_t bytes = product_smem(dlen);
  if (bytes > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const int row_tiles = (K1 + kTile - 1) / kTile;
  cudaError_t err;
  if (nvar > 1) {
    err = cudaFuncSetAttribute(variant_max_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    variant_max_kernel<<<dim3(row_tiles, nvar), kThreads, bytes, stream>>>(
        d0, v0, d1, v1, perms, gmax, K0, K1, dlen);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned* g = nvar > 1 ? gmax : nullptr;
  err = cudaFuncSetAttribute(reduce_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  reduce_kernel<<<row_tiles, kThreads, bytes, stream>>>(
      d0, v0, d1, v1, perms, g, nvar, rowkey1, rowkey2, colkey, K0, K1, dlen);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finish_kernel<<<(K1 + 255) / 256, 256, 0, stream>>>(
      rowkey1, rowkey2, colkey, v1, g, nvar, i0, top, conf, mutual, best_rot,
      K1);
  return (int)cudaGetLastError();
}
