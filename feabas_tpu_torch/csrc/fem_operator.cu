// The general elastic solve's CG operator, for Hopper.
//
// Replaces the XLA program matvec_full of feabas_tpu/optimizer.py:1192 (the
// general path of SLM.optimize_linear, which Newton-Raphson runs for
// nonlinear materials and the grouped solve runs for tile groups), built
// there from fem.stiffness_matvec (feabas_tpu/ops/fem.py:174) and
// fem.crosslink_matvec (:508). One call (two kernels, below) computes
//     y = free * (lam_s * K x + lam_c * C^T W^2 C x)
// x, y (NV, 2); K the sum of the per-element 6x6 blocks Ke (NT, 6, 6) over
// tris (NT, 3), several element groups concatenated; C the barycentric link
// rows (idx0, bary0) and (idx1, bary1) (L, 3), W = diag(weight); free (NV, 1).
// Plain version: ops/fem.elastic_operator_plain.
//
// What bounds it on an H100: bytes. Each element's block is read once (144
// bytes in f32), against 12 multiply-adds an element corner: about 0.5 FLOP
// a byte, far below the card's ~20 f32 FLOP a byte. At the path's meshes
// (a few hundred vertices) a launch is all of its cost.
//
// Design (first version: simple and deterministic):
//   * One thread a vertex, gathering instead of scattering: no atomics, so
//     the f32 sums run in a fixed order and two launches give the same bits.
//   * Two CSR tables from ops/fem.build_operator_tables. The first lists
//     the vertex's (element, corner) pairs as t * 3 + c in ascending order;
//     the thread reads the element's three corners of x and only the two
//     rows of Ke its corner owns, so Ke is read once in all and no
//     per-element intermediate is written. The second lists its (link,
//     corner, side) entries as (l * 3 + k) * 2 + side, the sign + for side
//     1, - for side 0.
//   * A first kernel, one thread a link, writes the L weighted residuals
//     w^2 (C x)_l to scratch; the vertex kernel reads them at its link
//     entries. A one-launch form, in which each entry recomputed its
//     link's residual (3x the link reads), measured slower on an H100 at
//     every shape of chip_smoke.py's phases 3 and 7 (PERF.md §6): a
//     vertex of a match pair has ~50 link entries and the recomputation
//     serialises them.
//   * Any NV, NT and L, L = 0 and a vertex that no element touches
//     included (its sums are zero).
//
// Plain C interface, loaded with ctypes. The entry points launch on the
// given stream, allocate nothing, and return a cudaError_t (0 = launched).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
residual_kernel(const T* __restrict__ x, const int* __restrict__ idx0,
                const T* __restrict__ bary0, const int* __restrict__ idx1,
                const T* __restrict__ bary1, const T* __restrict__ weight,
                T* __restrict__ rw, int nl) {
  const int64_t l = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (l >= nl) return;
  T ax = 0, ay = 0, bx = 0, by = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int64_t v1 = idx1[l * 3 + k], v0 = idx0[l * 3 + k];
    const T b1 = bary1[l * 3 + k], b0 = bary0[l * 3 + k];
    ax += b1 * x[v1 * 2];
    ay += b1 * x[v1 * 2 + 1];
    bx += b0 * x[v0 * 2];
    by += b0 * x[v0 * 2 + 1];
  }
  const T w = weight[l];
  const T w2 = w * w;
  rw[l * 2] = (ax - bx) * w2;
  rw[l * 2 + 1] = (ay - by) * w2;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
operator_kernel(const T* __restrict__ x, const T* __restrict__ Ke,
                const int* __restrict__ tris,
                const int* __restrict__ inc_ptr,
                const int* __restrict__ inc_ent,
                const int* __restrict__ lnk_ptr,
                const int* __restrict__ lnk_ent,
                const T* __restrict__ bary0, const T* __restrict__ bary1,
                const T* __restrict__ rw, const T* __restrict__ free_,
                T lam_s, T lam_c,
                T* __restrict__ y, int nv) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= nv) return;
  // stiffness: rows 2c and 2c + 1 of each incident element's block
  T kx = 0, ky = 0;
  for (int e = inc_ptr[v], end = inc_ptr[v + 1]; e < end; ++e) {
    const int64_t f = inc_ent[e];
    const int64_t t = f / 3;
    const int c = static_cast<int>(f - t * 3);
    T u[6];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int64_t w = tris[t * 3 + j];
      u[2 * j] = x[w * 2];
      u[2 * j + 1] = x[w * 2 + 1];
    }
    const T* row = Ke + t * 36 + c * 12;
    T s0 = 0, s1 = 0;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      s0 += row[j] * u[j];
      s1 += row[6 + j] * u[j];
    }
    kx += s0;
    ky += s1;
  }
  // links: +bary1 on side 1, -bary0 on side 0, times the weighted residual
  T cx = 0, cy = 0;
  for (int e = lnk_ptr[v], end = lnk_ptr[v + 1]; e < end; ++e) {
    const int64_t f = lnk_ent[e];
    const int64_t lk = f >> 1;
    const int64_t l = lk / 3;
    const T coef = (f & 1) ? bary1[lk] : -bary0[lk];
    cx += coef * rw[l * 2];
    cy += coef * rw[l * 2 + 1];
  }
  const T fr = free_[v];
  y[v * 2] = fr * (lam_s * kx + lam_c * cx);
  y[v * 2 + 1] = fr * (lam_s * ky + lam_c * cy);
}

template <typename T>
int launch(const void* x, const void* Ke, const void* tris,
           const void* inc_ptr, const void* inc_ent, const void* lnk_ptr,
           const void* lnk_ent, const void* idx0, const void* bary0,
           const void* idx1, const void* bary1, const void* weight,
           const void* free_, double lam_s, double lam_c, void* y,
           void* scratch, int nv, int nl, void* stream) {
  if (nv < 0 || nl < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nv == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xs = static_cast<const T*>(x);
  const T* w = static_cast<const T*>(weight);
  const int* i0 = static_cast<const int*>(idx0);
  const int* i1 = static_cast<const int*>(idx1);
  const T* b0 = static_cast<const T*>(bary0);
  const T* b1 = static_cast<const T*>(bary1);
  const int grid = (nv + kThreads - 1) / kThreads;
  T* rw = static_cast<T*>(scratch);
  if (nl > 0) {
    residual_kernel<T><<<(nl + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        xs, i0, b0, i1, b1, w, rw, nl);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  operator_kernel<T><<<grid, kThreads, 0, s>>>(
      xs, static_cast<const T*>(Ke), static_cast<const int*>(tris),
      static_cast<const int*>(inc_ptr), static_cast<const int*>(inc_ent),
      static_cast<const int*>(lnk_ptr), static_cast<const int*>(lnk_ent),
      b0, b1, rw, static_cast<const T*>(free_), static_cast<T>(lam_s),
      static_cast<T>(lam_c), static_cast<T*>(y), nv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define FEM_OPERATOR_ARGS                                                    \
  const void *x, const void *Ke, const void *tris, const void *inc_ptr,     \
      const void *inc_ent, const void *lnk_ptr, const void *lnk_ent,        \
      const void *idx0, const void *bary0, const void *idx1,                \
      const void *bary1, const void *weight, const void *free_,             \
      double lam_s, double lam_c, void *y, void *scratch, int nv, int nl,   \
      void *stream

extern "C" int fem_operator_f32(FEM_OPERATOR_ARGS) {
  return launch<float>(x, Ke, tris, inc_ptr, inc_ent, lnk_ptr, lnk_ent, idx0,
                       bary0, idx1, bary1, weight, free_, lam_s, lam_c, y,
                       scratch, nv, nl, stream);
}

extern "C" int fem_operator_f64(FEM_OPERATOR_ARGS) {
  return launch<double>(x, Ke, tris, inc_ptr, inc_ent, lnk_ptr, lnk_ent,
                        idx0, bary0, idx1, bary1, weight, free_, lam_s, lam_c,
                        y, scratch, nv, nl, stream);
}
