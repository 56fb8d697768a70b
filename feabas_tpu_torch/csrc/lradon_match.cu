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
// O(K) results. f32 FMA on the CUDA cores, no TF32: best_rot and i0 are
// argmaxes over 25 M-entry planes, where a near-tie decides the answer. The
// design:
//   * prep: d0 is transposed once per call into a k-major buffer padded to
//     whole column tiles (zeros past K0), so column tiles load as 16-byte
//     cp.async copies; the same launch zeroes the reduction scratch;
//   * one register-tiled product: a block computes 128 x 128 tiles of S
//     with 256 threads, 8 x 8 outputs each (4 LDS.128 feed 64 FFMA), from
//     k-major operands in shared memory; dlen is a template parameter (48
//     for the default 6 x 8 descriptors, unrolled by 16; 0 = any), FMA over
//     j in ascending order from 0, so every S value is the one a sequential
//     f32 dot product gives;
//   * pass 1 (grid: row tiles x groups of kVar variants x column chunks):
//     the block keeps its rows' kVar variants in shared memory and applies
//     each d0 tile, double-buffered with cp.async, to all of them, so d0
//     crosses once per kVar variants; max(S_r) over valid pairs goes to an
//     atomicMax on the order-preserving integer image of the float, which
//     no order of arrival can change;
//   * pass 2 (grid: row tiles x column chunks) recomputes S for the winner.
//     Every reduction is a max over 64-bit keys (ordered value << 32 |
//     ~index): the largest key is the largest value at its smallest index,
//     and keys are distinct within a row or column, so the second-largest
//     key of a row carries `second` (equal to `top` when two columns tie).
//     Each (row tile, chunk) block writes its rows' two largest keys to its
//     own scratch slot; column keys are reduced over the block by warp
//     shuffles and shared memory, then with one atomicMax per column, tile
//     and block;
//   * finish merges the chunks' row keys and decodes the O(K) outputs. The
//     result does not depend on block order.
//
// Plain C interface, loaded with ctypes. The entry point launches on the
// given stream, allocates nothing, and returns a cudaError_t (0 = launched).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kBM = 128;              // rows of S (d1) per tile
constexpr int kBN = 128;              // columns of S (d0) per tile
constexpr int kThreads = 256;         // 16 x 16 threads, 8 x 8 outputs each
constexpr int kVar = 2;               // variants per pass-1 block
constexpr int kMaxSmem = 232448;
constexpr int kStaticSmem = 64;      // the largest static array
constexpr int kMaxDevices = 64;
constexpr int kPrepRows = 32;         // rows of d0 per prep block
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

__device__ __forceinline__ void push_key(u64 key, u64& k1, u64& k2) {
  if (key > k1) {
    k2 = k1;
    k1 = key;
  } else if (key > k2) {
    k2 = key;
  }
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

// the row (a) and column (b) of S that output (a, b) of thread (ty, tx)
// holds within its tile: two groups of 4, 64 apart
__device__ __forceinline__ int sub(int t, int a) {
  return (a < 4 ? 0 : 64) + t * 4 + (a & 3);
}

// column tiles [first, last) of chunk c of n over `tiles`
__device__ __forceinline__ void chunk_tiles(int tiles, int n, int c,
                                            int& first, int& last) {
  first = (int)((long long)tiles * c / n);
  last = (int)((long long)tiles * (c + 1) / n);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// dst[k * kBN + c] = d0t[k * K0p + col0 + c], 16 bytes a copy
__device__ __forceinline__ void load_cols_async(float* dst, const float* d0t,
                                                int K0p, int col0, int dlen) {
  constexpr int kVec = kBN / 4;
  for (int i = threadIdx.x; i < dlen * kVec; i += kThreads) {
    const int k = i / kVec, c = (i - k * kVec) * 4;
    cp_async16(dst + k * kBN + c, d0t + (size_t)k * K0p + col0 + c);
  }
  cp_async_commit();
}

// dst[j * kBM + r] = d1[(row0 + r) * dlen + perm[j]] (0 past the last row)
__device__ __forceinline__ void load_rows(float* dst, const float* d1,
                                          const int* perm, int row0, int K1,
                                          int dlen) {
  for (int i = threadIdx.x; i < kBM * dlen; i += kThreads) {
    const int j = i / kBM, r = i - j * kBM;
    const int row = row0 + r;
    dst[i] = row < K1 ? __ldg(d1 + (size_t)row * dlen + __ldg(perm + j)) : 0.0f;
  }
}

// acc[a][b] = sum_j As[j][sub(ty, a)] * Bs[j][sub(tx, b)], j ascending
template <int DLEN>
__device__ __forceinline__ void tile_product(const float* __restrict__ As,
                                             const float* __restrict__ Bs,
                                             int dlen, int ty, int tx,
                                             float (&acc)[8][8]) {
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.0f;
  const int n = DLEN > 0 ? DLEN : dlen;
  // unrolled by 16, not fully: a fully unrolled 48-step body (~50 KB of
  // code per copy) measured 17% slower in pass 1, the instruction fetch
  // being its limit
#pragma unroll 16
  for (int j = 0; j < n; ++j) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + j * kBM + ty * 4);
    const float4 a1 =
        *reinterpret_cast<const float4*>(As + j * kBM + 64 + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + j * kBN + tx * 4);
    const float4 b1 =
        *reinterpret_cast<const float4*>(Bs + j * kBN + 64 + tx * 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
  }
}

// prep: d0t[k * K0p + m] = d0[m * dlen + k] (0 for m >= K0); zero gmax and
// colkey. Block b transposes rows [32 b, 32 b + 32) through shared memory.
__global__ void __launch_bounds__(kThreads)
prep_kernel(const float* __restrict__ d0, float* __restrict__ d0t,
            unsigned* gmax, int nvar, u64* colkey, int K0, int K0p,
            int dlen) {
  extern __shared__ float tile[];                 // [kPrepRows][dlen + 1]
  const int m0 = blockIdx.x * kPrepRows;
  const int ld = dlen + 1;
  for (int i = threadIdx.x; i < kPrepRows * dlen; i += kThreads) {
    const int r = i / dlen, k = i - r * dlen;
    const int m = m0 + r;
    tile[r * ld + k] = m < K0 ? d0[(size_t)m0 * dlen + i] : 0.0f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kPrepRows * dlen; i += kThreads) {
    const int k = i / kPrepRows, r = i - k * kPrepRows;
    d0t[(size_t)k * K0p + m0 + r] = tile[r * ld + k];
  }
  const int g = blockIdx.x * kThreads + threadIdx.x;
  for (int i = g; i < K0; i += gridDim.x * kThreads) colkey[i] = 0;
  if (g < nvar) gmax[g] = 0;
}

// pass 1: gmax[r] = max over valid (n, m) of S_r, as ord()
template <int DLEN>
__global__ void __launch_bounds__(kThreads, 2)
variant_max_kernel(const float* __restrict__ d0t,
                   const uint8_t* __restrict__ v0,
                   const float* __restrict__ d1,
                   const uint8_t* __restrict__ v1,
                   const int* __restrict__ perms, int nvar, unsigned* gmax,
                   int K0, int K1, int K0p, int dlen, int chunks) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float warp_max[kVar][kThreads / 32];
  const int n = DLEN > 0 ? DLEN : dlen;
  float* As = smem;                                    // [kVar][n][kBM]
  float* Bs = smem + (size_t)kVar * n * kBM;           // [2][n][kBN]
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int row0 = blockIdx.x * kBM;
  const int r0 = blockIdx.y * kVar;
  const int nv = min(kVar, nvar - r0);
  int first, last;
  chunk_tiles(K0p / kBN, chunks, blockIdx.z, first, last);
  if (first < last) load_cols_async(Bs, d0t, K0p, first * kBN, n);
  for (int v = 0; v < nv; ++v)
    load_rows(As + (size_t)v * n * kBM, d1, perms + (size_t)(r0 + v) * n,
              row0, K1, n);
  bool rv[8];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int row = row0 + sub(ty, a);
    rv[a] = row < K1 && v1[row] != 0;
  }
  float m[kVar];
#pragma unroll
  for (int v = 0; v < kVar; ++v) m[v] = -INFINITY;
  for (int t = first; t < last; ++t) {
    const int buf = (t - first) & 1;
    if (t + 1 < last) {
      load_cols_async(Bs + (size_t)(buf ^ 1) * n * kBN, d0t, K0p,
                      (t + 1) * kBN, n);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    bool cv[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int col = t * kBN + sub(tx, b);
      cv[b] = col < K0 && v0[col] != 0;
    }
    const float* B = Bs + (size_t)buf * n * kBN;
#pragma unroll
    for (int v = 0; v < kVar; ++v) {
      if (v < nv) {
        float acc[8][8];
        tile_product<DLEN>(As + (size_t)v * n * kBM, B, n, ty, tx, acc);
        float mv = m[v];
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b < 8; ++b)
            mv = fmaxf(mv, (rv[a] && cv[b]) ? acc[a][b] : -INFINITY);
        m[v] = mv;
      }
    }
    __syncthreads();      // the next tile's copy reuses this buffer
  }
#pragma unroll
  for (int v = 0; v < kVar; ++v) {
    float mv = m[v];
    for (int off = 16; off > 0; off >>= 1)
      mv = fmaxf(mv, __shfl_xor_sync(0xffffffffu, mv, off));
    if (threadIdx.x % 32 == 0) warp_max[v][threadIdx.x / 32] = mv;
  }
  __syncthreads();
  if (threadIdx.x < nv) {
    float mv = warp_max[threadIdx.x][0];
    for (int i = 1; i < kThreads / 32; ++i)
      mv = fmaxf(mv, warp_max[threadIdx.x][i]);
    atomicMax(gmax + r0 + threadIdx.x, ord(mv));
  }
}

// pass 2: per chunk, the two largest keys of every row of the winning
// variant's S (rowkeys[chunk][0 | 1][row]) and, over all chunks, the
// largest of every column (colkey, atomicMax). A thread meets its columns,
// and within a column its rows, in ascending order, so its running top two
// of a row (and largest of a column) are kept as (value, index) with strict
// float compares, which is what the 64-bit keys would give; keys are built
// only to merge across threads.
template <int DLEN>
__global__ void __launch_bounds__(kThreads, 2)
reduce_kernel(const float* __restrict__ d0t, const uint8_t* __restrict__ v0,
              const float* __restrict__ d1, const uint8_t* __restrict__ v1,
              const int* __restrict__ perms,
              const unsigned* __restrict__ gmax, int nvar, u64* rowkeys,
              u64* colkey, int K0, int K1, int K0p, int dlen, int chunks) {
  extern __shared__ __align__(16) float smem[];
  const int n = DLEN > 0 ? DLEN : dlen;
  float* As = smem;                                    // [n][kBM]
  float* Bs = smem + (size_t)n * kBM;                  // [2][n][kBN]
  u64* scol = reinterpret_cast<u64*>(Bs + (size_t)2 * n * kBN);  // [8][kBN]
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kBM;
  int first, last;
  chunk_tiles(K0p / kBN, chunks, blockIdx.y, first, last);
  if (first < last) load_cols_async(Bs, d0t, K0p, first * kBN, n);
  const int best = best_variant(gmax, nvar);
  load_rows(As, d1, perms + (size_t)best * n, row0, K1, n);
  const float kNone = __int_as_float(0x7fffffff);      // NaN: "no key yet"
  bool rin[8], rv[8];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int row = row0 + sub(ty, a);
    rin[a] = row < K1;
    rv[a] = rin[a] && v1[row] != 0;
  }
  float f1[8], f2[8];                       // a row's top two values
  int c1[8], c2[8];                         // and their columns
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    f1[a] = f2[a] = kNone;
    c1[a] = c2[a] = 0;
  }
  for (int t = first; t < last; ++t) {
    const int buf = (t - first) & 1;
    if (t + 1 < last) {
      load_cols_async(Bs + (size_t)(buf ^ 1) * n * kBN, d0t, K0p,
                      (t + 1) * kBN, n);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float acc[8][8];
    tile_product<DLEN>(As, Bs + (size_t)buf * n * kBN, n, ty, tx, acc);
    u64 ck[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int col = t * kBN + sub(tx, b);
      const bool cin = col < K0;
      const bool cv = cin && v0[col] != 0;
      float cf = kNone;
      int crow = 0;
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        if (!(cin && rin[a])) continue;
        const float s = (cv && rv[a]) ? acc[a][b] : -INFINITY;
        if (!(s <= f2[a])) {                 // above the second
          if (!(s <= f1[a])) {
            f2[a] = f1[a];
            c2[a] = c1[a];
            f1[a] = s;
            c1[a] = col;
          } else {
            f2[a] = s;
            c2[a] = col;
          }
        }
        if (!(s <= cf)) {                    // first row wins a tie
          cf = s;
          crow = row0 + sub(ty, a);
        }
      }
      ck[b] = cf == cf ? make_key(cf, crow) : 0;
    }
    // the two threads of a warp that share these columns, then the 8 warps
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const u64 o = __shfl_xor_sync(0xffffffffu, ck[b], 16);
      if (lane < 16) scol[warp * kBN + sub(tx, b)] = o > ck[b] ? o : ck[b];
    }
    __syncthreads();      // scol complete; the next copy reuses this buffer
    if (threadIdx.x < kBN) {
      const int col = t * kBN + threadIdx.x;
      u64 c = 0;
      for (int i = 0; i < kThreads / 32; ++i) {
        const u64 o = scol[i * kBN + threadIdx.x];
        c = o > c ? o : c;
      }
      if (col < K0 && c != 0) atomicMax(colkey + col, c);
    }
  }
  // merge the 16 column slices of each row; the product buffers are free
  __syncthreads();
  u64* m1 = reinterpret_cast<u64*>(smem);          // [kBM][16]
  u64* m2 = m1 + kBM * 16;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    m1[sub(ty, a) * 16 + tx] = f1[a] == f1[a] ? make_key(f1[a], c1[a]) : 0;
    m2[sub(ty, a) * 16 + tx] = f2[a] == f2[a] ? make_key(f2[a], c2[a]) : 0;
  }
  __syncthreads();
  if (threadIdx.x < kBM && row0 + threadIdx.x < K1) {
    u64 a1 = 0, a2 = 0;
    for (int i = 0; i < 16; ++i) {
      push_key(m1[threadIdx.x * 16 + i], a1, a2);
      push_key(m2[threadIdx.x * 16 + i], a1, a2);
    }
    u64* slot = rowkeys + (size_t)blockIdx.y * 2 * K1;
    slot[row0 + threadIdx.x] = a1;
    slot[K1 + row0 + threadIdx.x] = a2;
  }
}

// finish: the chunks' row keys, merged -> i0, top, conf, mutual, best_rot
__global__ void finish_kernel(const u64* __restrict__ rowkeys, int chunks,
                              const u64* __restrict__ colkey,
                              const uint8_t* __restrict__ v1,
                              const unsigned* __restrict__ gmax, int nvar,
                              int* i0, float* top, float* conf,
                              uint8_t* mutual, int* best_rot, int K1) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n == 0) best_rot[0] = best_variant(gmax, nvar);
  if (n >= K1) return;
  u64 a1 = 0, a2 = 0;
  for (int c = 0; c < chunks; ++c) {
    push_key(rowkeys[(size_t)c * 2 * K1 + n], a1, a2);
    push_key(rowkeys[(size_t)c * 2 * K1 + K1 + n], a1, a2);
  }
  const int idx = (int)(0xffffffffu - (unsigned)(a1 & 0xffffffffu));
  const float t = unord((unsigned)(a1 >> 32));
  const float s = a2 != 0 ? unord((unsigned)(a2 >> 32)) : -INFINITY;
  const int back = (int)(0xffffffffu - (unsigned)(colkey[idx] & 0xffffffffu));
  i0[n] = idx;
  top[n] = t;
  conf[n] = t > 0.0f ? 1.0f - fmaxf(s, 0.0f) / fmaxf(t, 1e-6f) : 0.0f;
  mutual[n] = (back == n && v1[n] != 0) ? 1 : 0;
}

size_t pass1_smem(int dlen) {
  return (size_t)(kVar + 2) * dlen * kBM * sizeof(float);
}

size_t pass2_smem(int dlen) {
  const size_t prod = (size_t)3 * dlen * kBM * sizeof(float)
                      + (size_t)(kThreads / 32) * kBN * sizeof(u64);
  const size_t merge = 2 * (size_t)kBM * 16 * sizeof(u64);
  return prod > merge ? prod : merge;
}

// Opt a kernel into all the dynamic shared memory its static arrays leave.
template <typename F>
cudaError_t opt_in(F* kernel) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxSmem - (int)a.sharedSizeBytes);
}

// The shared-memory opt-in of each kernel, set at the first launch on each
// device (under a lock: callers may launch from several host threads).
int setup_device() {
  static std::mutex lock;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> guard(lock);
  if (done[dev]) return 0;
  err = opt_in(variant_max_kernel<48>);
  if (err == cudaSuccess) err = opt_in(variant_max_kernel<0>);
  if (err == cudaSuccess) err = opt_in(reduce_kernel<48>);
  if (err == cudaSuccess) err = opt_in(reduce_kernel<0>);
  if (err != cudaSuccess) return (int)err;
  done[dev] = true;
  return 0;
}

template <int DLEN>
int launch(const float* d0t, const uint8_t* v0, const float* d1,
           const uint8_t* v1, const int* perms, int nvar, unsigned* gmax,
           u64* rowkeys, u64* colkey, int K0, int K1, int K0p, int dlen,
           int chunks1, int chunks2, cudaStream_t stream) {
  const int row_tiles = (K1 + kBM - 1) / kBM;
  cudaError_t err;
  if (nvar > 1) {
    variant_max_kernel<DLEN>
        <<<dim3(row_tiles, (nvar + kVar - 1) / kVar, chunks1), kThreads,
           pass1_smem(dlen), stream>>>(d0t, v0, d1, v1, perms, nvar, gmax,
                                       K0, K1, K0p, dlen, chunks1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  reduce_kernel<DLEN><<<dim3(row_tiles, chunks2), kThreads, pass2_smem(dlen),
                        stream>>>(d0t, v0, d1, v1, perms,
                                  nvar > 1 ? gmax : nullptr, nvar, rowkeys,
                                  colkey, K0, K1, K0p, dlen, chunks2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lradon_match_tile() { return kBN; }
int lradon_match_variants_per_block() { return kVar; }

// d0: (K0, dlen) f32, d1: (K1, dlen) f32; v0, v1: validity bytes; perms:
// (nvar, dlen) int32, variant r of d1 is d1[:, perms[r]] (row 0 the
// identity). Scratch: d0t (dlen, K0p) f32 with K0p = K0 rounded up to
// whole tiles; gmax (nvar) uint32; rowkeys (chunks2, 2, K1) uint64; colkey
// (K0) uint64 (the prep launch zeroes gmax and colkey). chunks1, chunks2:
// column chunks of passes 1 and 2 (1 .. K0p / tile). Outputs: i0 (K1)
// int32, top, conf (K1) f32, mutual (K1) bytes, best_rot (1) int32. With
// nvar == 1 the rotation search is skipped (best_rot = 0).
int lradon_match_f32(const float* d0, const uint8_t* v0, const float* d1,
                     const uint8_t* v1, const int* perms, int nvar,
                     float* d0t, unsigned* gmax, u64* rowkeys, u64* colkey,
                     int* i0, float* top, float* conf, uint8_t* mutual,
                     int* best_rot, int K0, int K1, int dlen, int chunks1,
                     int chunks2, cudaStream_t stream) {
  const int K0p = (K0 + kBN - 1) / kBN * kBN;
  if (K0 < 1 || K1 < 1 || dlen < 1 || nvar < 1 || chunks1 < 1
      || chunks2 < 1 || chunks1 > K0p / kBN || chunks2 > K0p / kBN
      || pass1_smem(dlen) > (size_t)kMaxSmem - kStaticSmem
      || pass2_smem(dlen) > (size_t)kMaxSmem - kStaticSmem)
    return (int)cudaErrorInvalidValue;
  int err = setup_device();
  if (err != 0) return err;
  prep_kernel<<<K0p / kPrepRows, kThreads,
                kPrepRows * (dlen + 1) * sizeof(float), stream>>>(
      d0, d0t, gmax, nvar, colkey, K0, K0p, dlen);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = dlen == 48
            ? launch<48>(d0t, v0, d1, v1, perms, nvar, gmax, rowkeys, colkey,
                         K0, K1, K0p, dlen, chunks1, chunks2, stream)
            : launch<0>(d0t, v0, d1, v1, perms, nvar, gmax, rowkeys, colkey,
                        K0, K1, K0p, dlen, chunks1, chunks2, stream);
  if (err != 0) return err;
  finish_kernel<<<(K1 + 255) / 256, 256, 0, stream>>>(
      rowkeys, chunks2, colkey, v1, nvar > 1 ? gmax : nullptr, nvar, i0, top,
      conf, mutual, best_rot, K1);
  return (int)cudaGetLastError();
}

}  // extern "C"
