// The general elastic solve's CG operator, for Hopper.
//
// Replaces the XLA program matvec_full of feabas_tpu/optimizer.py:1192 (the
// general path of SLM.optimize_linear, which Newton-Raphson runs for
// nonlinear materials and the grouped solve runs for tile groups), built
// there from fem.stiffness_matvec (feabas_tpu/ops/fem.py:174) and
// fem.crosslink_matvec (:508). One launch computes
//     y = free * (lam_s * K x + lam_c * C^T W^2 C x)
// x, y (NV, 2); K the sum of the per-element 6x6 blocks Ke (NT, 6, 6) over
// tris (NT, 3), several element groups concatenated; C the barycentric link
// rows (idx0, bary0) and (idx1, bary1) (L, 3), W = diag(weight); free (NV, 1).
// Plain version: ops/fem.elastic_operator_plain.
//
// What bounds it on an H100: bytes. Each element's block is read once (144
// bytes in f32), against 12 multiply-adds an element corner: about 0.5 FLOP
// a byte, far below the card's ~20 f32 FLOP a byte. At the path's systems
// (a few hundred to a thousand vertices, ~50 link entries a vertex) the
// bytes take well under a microsecond, and the chain of dependent loads
// (CSR entry -> element or link -> x) is all of a launch's time.
//
// Design:
//   * Gather, not scatter: a vertex sums what its entries give it, with no
//     atomics, so the sums run in a fixed order and two launches give the
//     same bits.
//   * Two CSR tables from ops/fem.operator_tables. The first lists
//     the vertex's (element, corner) pairs as t * 3 + c in ascending order;
//     a lane reads the element's three corners of x and only the two rows
//     of Ke its corner owns, so Ke is read once in all. The second lists
//     its (link, corner, side) entries as (l * 3 + k) * 2 + side, the sign
//     + for side 1, - for side 0.
//   * G lanes a vertex (G = 4, 8, 16 or 32, a template parameter; the
//     tables carry the G that ops/fem.operator_group chose from their mean
//     entries a vertex: about one entry a lane). Lane j sums the vertex's
//     element entries j, j + G, ... in ascending order, then its link
//     entries j, j + G, ...; so a window vertex's ~50 link entries take two
//     trips to memory, not fifty, and a small system still spreads over
//     the card's 132 SMs. The G partial sums meet in a fixed
//     __shfl_xor_sync butterfly (each step adds the same two values in
//     either lane, so every lane ends with the same bits).
//   * Each link entry recomputes its link's weighted residual
//     w^2 (bary1 . x[idx1] - bary0 . x[idx0]) itself: one launch and no
//     scratch. A pass writing the L residuals first was level or slower on
//     every system the align path gives the kernel, and faster only on a
//     synthetic 2M-DOF pair with one link to ten vertices (PERF.md §6).
//   * Read-only loads (__ldg), x and y as 2-vectors, each Ke row pair as
//     16-byte loads (the wrapper checks the alignment).
//   * Any NV, NT and L, L = 0 and a vertex that no element touches
//     included (its sums are zero); a vertex's group never straddles a
//     warp, and groups past NV take part in the butterfly with zeros.
//
// Plain C interface, loaded with ctypes. fem_operator_f32 / _f64 launch on
// the given stream, allocate nothing, and return a cudaError_t (0 =
// launched); fem_operator_attrs reports one instantiation's registers,
// local (spill) bytes, shared bytes and resident blocks a SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
// the tables' device pointers, in this order (ops/fem._TABLE_KEYS)
enum { kTris, kIncPtr, kIncEnt, kLnkPtr, kLnkEnt, kIdx0, kBary0, kIdx1,
       kBary1 };

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

template <typename T>
__device__ __forceinline__ typename Pair<T>::type ld2(const T* p) {
  return __ldg(reinterpret_cast<const typename Pair<T>::type*>(p));
}

// the 12 values of one corner's two rows of Ke (16-byte aligned)
__device__ __forceinline__ void load_rows(const float* p, float* r) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float4 a = __ldg(q + i);
    r[4 * i] = a.x;
    r[4 * i + 1] = a.y;
    r[4 * i + 2] = a.z;
    r[4 * i + 3] = a.w;
  }
}

__device__ __forceinline__ void load_rows(const double* p, double* r) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const double2 a = ld2(p + 2 * i);
    r[2 * i] = a.x;
    r[2 * i + 1] = a.y;
  }
}

// w^2 (bary1 . x[idx1] - bary0 . x[idx0]) of one link, as (x, y)
template <typename T>
__device__ __forceinline__ typename Pair<T>::type link_residual(
    const T* __restrict__ x, const int* __restrict__ idx0,
    const T* __restrict__ bary0, const int* __restrict__ idx1,
    const T* __restrict__ bary1, const T* __restrict__ weight, int64_t l) {
  using V = typename Pair<T>::type;
  T ax = 0, ay = 0, bx = 0, by = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const V p1 = ld2(x + 2 * static_cast<int64_t>(__ldg(idx1 + l * 3 + k)));
    const V p0 = ld2(x + 2 * static_cast<int64_t>(__ldg(idx0 + l * 3 + k)));
    const T b1 = __ldg(bary1 + l * 3 + k), b0 = __ldg(bary0 + l * 3 + k);
    ax += b1 * p1.x;
    ay += b1 * p1.y;
    bx += b0 * p0.x;
    by += b0 * p0.y;
  }
  const T w = __ldg(weight + l);
  const T w2 = w * w;
  V r;
  r.x = (ax - bx) * w2;
  r.y = (ay - by) * w2;
  return r;
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
operator_kernel(const T* __restrict__ x, const T* __restrict__ Ke,
                const int* __restrict__ tris,
                const int* __restrict__ inc_ptr,
                const int* __restrict__ inc_ent,
                const int* __restrict__ lnk_ptr,
                const int* __restrict__ lnk_ent,
                const int* __restrict__ idx0, const T* __restrict__ bary0,
                const int* __restrict__ idx1, const T* __restrict__ bary1,
                const T* __restrict__ weight, const T* __restrict__ free_,
                T lam_s, T lam_c, T* __restrict__ y, int nv) {
  static_assert(G >= 4 && G <= 32 && (G & (G - 1)) == 0, "G: 4 to 32");
  using V = typename Pair<T>::type;
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * kThreads
                      + threadIdx.x;
  const int64_t v = gid / G;
  const int lane = static_cast<int>(threadIdx.x) & (G - 1);
  const bool live = v < nv;
  // stiffness: rows 2c and 2c + 1 of each incident element's block
  T kx = 0, ky = 0;
  for (int e = (live ? __ldg(inc_ptr + v) : 0) + lane,
           end = live ? __ldg(inc_ptr + v + 1) : 0;
       e < end; e += G) {
    const int f = __ldg(inc_ent + e);
    const int64_t t = f / 3;
    const int c = f - static_cast<int>(t) * 3;
    T row[12];
    load_rows(Ke + t * 36 + c * 12, row);
    T u[6];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const V p = ld2(x + 2 * static_cast<int64_t>(__ldg(tris + t * 3 + j)));
      u[2 * j] = p.x;
      u[2 * j + 1] = p.y;
    }
    T s0 = 0, s1 = 0;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      s0 += row[j] * u[j];
      s1 += row[6 + j] * u[j];
    }
    kx += s0;
    ky += s1;
  }
  // links: +bary1 on side 1, -bary0 on side 0, times the link's weighted
  // residual
  T cx = 0, cy = 0;
  for (int e = (live ? __ldg(lnk_ptr + v) : 0) + lane,
           end = live ? __ldg(lnk_ptr + v + 1) : 0;
       e < end; e += G) {
    const int f = __ldg(lnk_ent + e);
    const int64_t lk = f >> 1;
    const int64_t l = lk / 3;
    const V r = link_residual(x, idx0, bary0, idx1, bary1, weight, l);
    const T coef = (f & 1) ? __ldg(bary1 + lk) : -__ldg(bary0 + lk);
    cx += coef * r.x;
    cy += coef * r.y;
  }
  // the fixed butterfly over the vertex's G lanes
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    kx += __shfl_xor_sync(kFull, kx, o);
    ky += __shfl_xor_sync(kFull, ky, o);
    cx += __shfl_xor_sync(kFull, cx, o);
    cy += __shfl_xor_sync(kFull, cy, o);
  }
  if (live && lane == 0) {
    const T fr = __ldg(free_ + v);
    V out;
    out.x = fr * (lam_s * kx + lam_c * cx);
    out.y = fr * (lam_s * ky + lam_c * cy);
    reinterpret_cast<V*>(y)[v] = out;
  }
}

template <typename T, int G>
cudaError_t run(const T* x, const T* Ke, const void* const* tb,
                const T* weight, const T* free_, T lam_s, T lam_c, T* y,
                int nv, cudaStream_t s) {
  const int64_t grid = (static_cast<int64_t>(nv) * G + kThreads - 1)
                       / kThreads;
  operator_kernel<T, G><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
      x, Ke, static_cast<const int*>(tb[kTris]),
      static_cast<const int*>(tb[kIncPtr]),
      static_cast<const int*>(tb[kIncEnt]),
      static_cast<const int*>(tb[kLnkPtr]),
      static_cast<const int*>(tb[kLnkEnt]),
      static_cast<const int*>(tb[kIdx0]), static_cast<const T*>(tb[kBary0]),
      static_cast<const int*>(tb[kIdx1]), static_cast<const T*>(tb[kBary1]),
      weight, free_, lam_s, lam_c, y, nv);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* Ke, const void* const* tables,
           const void* weight, const void* free_, double lam_s, double lam_c,
           void* y, int nv, int group, void* stream) {
  if (nv < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nv == 0) return 0;
  const T* xs = static_cast<const T*>(x);
  const T* k = static_cast<const T*>(Ke);
  const T* w = static_cast<const T*>(weight);
  const T* fr = static_cast<const T*>(free_);
  const T ls = static_cast<T>(lam_s), lc = static_cast<T>(lam_c);
  T* out = static_cast<T*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 4: return run<T, 4>(xs, k, tables, w, fr, ls, lc, out, nv, s);
    case 8: return run<T, 8>(xs, k, tables, w, fr, ls, lc, out, nv, s);
    case 16: return run<T, 16>(xs, k, tables, w, fr, ls, lc, out, nv, s);
    case 32: return run<T, 32>(xs, k, tables, w, fr, ls, lc, out, nv, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int G>
cudaError_t attrs(int* out4) {
  cudaFuncAttributes a;
  const auto fn = operator_kernel<T, G>;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return err;
  out4[0] = a.numRegs;
  out4[1] = static_cast<int>(a.localSizeBytes);
  out4[2] = static_cast<int>(a.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out4 + 3, fn,
                                                       kThreads, 0);
}

template <typename T>
cudaError_t attrs_of(int group, int* out4) {
  switch (group) {
    case 4: return attrs<T, 4>(out4);
    case 8: return attrs<T, 8>(out4);
    case 16: return attrs<T, 16>(out4);
    case 32: return attrs<T, 32>(out4);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// tables: the 9 tables' device pointers (tris, inc_ptr, inc_ent, lnk_ptr,
// lnk_ent, idx0, bary0, idx1, bary1); group: lanes a vertex, 4 to 32
#define FEM_OPERATOR_ARGS                                                    \
  const void *x, const void *Ke, const void *const *tables,                 \
      const void *weight, const void *free_, double lam_s, double lam_c,    \
      void *y, int nv, int group, void *stream

extern "C" int fem_operator_f32(FEM_OPERATOR_ARGS) {
  return launch<float>(x, Ke, tables, weight, free_, lam_s, lam_c, y, nv,
                       group, stream);
}

extern "C" int fem_operator_f64(FEM_OPERATOR_ARGS) {
  return launch<double>(x, Ke, tables, weight, free_, lam_s, lam_c, y, nv,
                        group, stream);
}

// out4: registers, local (spill) bytes, static shared bytes, resident
// blocks a SM of the kernel in f32 or f64 at G lanes a vertex
extern "C" int fem_operator_attrs(int f64, int group, int* out4) {
  return static_cast<int>(f64 ? attrs_of<double>(group, out4)
                              : attrs_of<float>(group, out4));
}
