// Mesh raster + affine warp of output blocks for Hopper.
//
// Replaces feabas_tpu/ops/render.py:_raster_core_cells and _finish_raster
// (and the flat _raster_core, which is the same loop over the whole table):
// the XLA programs that rasterize a deformed triangle mesh over an output
// block, take the target->source affine of the winning triangle at every
// pixel and bilinear-sample the source there.
//
// One thread per output pixel. Each thread walks its 128-px cell's
// candidate rows (cands, ascending, so the first row in index order wins
// ties exactly as native/rasterize.cpp:57 does) or, with no candidate table,
// every row of the block's (Tp, 14) f32 coefficient table:
//     [l1x l1y l1c  l2x l2y l2c  axx ayx bx  axy ayy by  weight color]
// A row is inside when l1 >= -eps, l2 >= -eps and l1 + l2 <= 1 + eps, and
// takes the pixel on a strict weight > score. Padding rows carry
// weight = -inf and l1c < -1: they are never inside and never beat even the
// initial score of -inf. With geodesic masking every inside row ORs its fold
// sheet bit into a mask, and a pixel seen by two sheets is uncovered. The
// winning source coordinate is quantized to 1/32 px (rintf: round half to
// even, as jnp.round and torch.round), sampled bilinearly from a uint8 or
// f32 source (fill outside the source's real extents), replaced by fill
// where uncovered, and rounded and clipped to u8/u16 or kept f32. Each
// block's coverage flag is the OR over its pixels.
//
// Arithmetic is spelled out with __fmaf_rn/__fmul_rn/__fadd_rn/__fsub_rn,
// so nvcc contracts nothing on its own. Every affine row is evaluated as
// fma(a, x, b * y) + c -- the contraction XLA applies to the JAX package's
// a * x + b * y + c -- so the inside tests at triangle edges and the source
// coordinates agree bit for bit with the reference and with the plain
// PyTorch version (ops/render.py:raster_blocks_plain).
//
// What bounds it on an H100: the per-pixel candidate loop. Each candidate
// costs ~20 flops and one 56 B table row that every thread of a warp reads
// from the same address (an L1 broadcast), so the kernel is bound by
// instruction throughput, not by HBM: a 2048^2 block with ~8 candidates
// per cell reads 4 MB of source and writes 4 MB. A 32x8 thread block lies
// inside one 128-px cell, so the loop count is uniform across a warp and
// nothing diverges but the take branch.
//
// Plain C interface, loaded with ctypes. mesh_raster launches on the given
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-9f;
constexpr int kBx = 32;
constexpr int kBy = 8;

__device__ __forceinline__ float affine(float a, float b, float c, float x,
                                        float y) {
  return __fadd_rn(__fmaf_rn(a, x, __fmul_rn(b, y)), c);
}

template <typename T>
__device__ __forceinline__ float load_f32(const T* p) {
  return static_cast<float>(*p);
}

template <int OUT>
__device__ __forceinline__ void store(void* out, long long i, float v) {
  if (OUT == 0) {
    static_cast<uint8_t*>(out)[i] =
        static_cast<uint8_t>(fminf(fmaxf(rintf(v), 0.0f), 255.0f));
  } else if (OUT == 1) {
    static_cast<uint16_t*>(out)[i] =
        static_cast<uint16_t>(fminf(fmaxf(rintf(v), 0.0f), 65535.0f));
  } else {
    static_cast<float*>(out)[i] = v;
  }
}

// tables (B, Tp, 14); cands (B, NC, K) or null (flat: rows 0..Tp-1);
// src (H, W) shared (src_bstride 0) or (B, H, W) per block, row stride
// src_stride, real extents src_hw (B, 2) = (h, w); out (B, h, w).
template <typename S, int OUT>
__global__ void __launch_bounds__(kBx * kBy)
raster(const float* __restrict__ tables, int Tp,
       const int* __restrict__ cands, int K, int cell, int ncx,
       const S* __restrict__ src, long long src_bstride, int src_stride,
       const int* __restrict__ src_hw, float fillval, int h, int w,
       int geodesic, void* __restrict__ out, int* __restrict__ covered) {
  const int px = blockIdx.x * kBx + threadIdx.x;
  const int py = blockIdx.y * kBy + threadIdx.y;
  const int b = blockIdx.z;
  if (px >= w || py >= h) return;
  const float x = static_cast<float>(px);
  const float y = static_cast<float>(py);
  const float* tab = tables + static_cast<long long>(b) * Tp * 14;
  const int* cl = nullptr;
  int n = Tp;
  if (cands != nullptr) {
    const long long nc = static_cast<long long>(h / cell) * ncx;
    const long long c = (py / cell) * ncx + (px / cell);
    cl = cands + (static_cast<long long>(b) * nc + c) * K;
    n = K;
  }
  float score = -INFINITY, sx = 0.0f, sy = 0.0f;
  unsigned int smask = 0u;
  for (int k = 0; k < n; ++k) {
    const float* row = tab + static_cast<long long>(cl ? __ldg(cl + k) : k) * 14;
    const float l1 = affine(__ldg(row + 0), __ldg(row + 1), __ldg(row + 2), x, y);
    const float l2 = affine(__ldg(row + 3), __ldg(row + 4), __ldg(row + 5), x, y);
    const bool inside = (l1 >= -kEps) && (l2 >= -kEps) &&
                        (__fadd_rn(l1, l2) <= 1.0f + kEps);
    const float wt = __ldg(row + 12);
    if (inside && wt > score) {
      score = wt;
      sx = affine(__ldg(row + 6), __ldg(row + 7), __ldg(row + 8), x, y);
      sy = affine(__ldg(row + 9), __ldg(row + 10), __ldg(row + 11), x, y);
    }
    if (geodesic && inside) {
      const int color = static_cast<int>(__ldg(row + 13));
      if (color >= 0) smask |= 1u << color;
    }
  }
  bool cov = score != -INFINITY;
  if (geodesic) cov = cov && (__popc(smask) < 2);

  const float xs = __fmul_rn(rintf(__fmul_rn(sx, 32.0f)), 1.0f / 32.0f);
  const float ys = __fmul_rn(rintf(__fmul_rn(sy, 32.0f)), 1.0f / 32.0f);
  const int H = src_hw[2 * b], W = src_hw[2 * b + 1];
  const bool valid = (xs >= 0.0f) && (ys >= 0.0f) &&
                     (xs <= static_cast<float>(W - 1)) &&
                     (ys <= static_cast<float>(H - 1));
  const float x0 = fminf(fmaxf(floorf(xs), 0.0f), static_cast<float>(W - 2));
  const float y0 = fminf(fmaxf(floorf(ys), 0.0f), static_cast<float>(H - 2));
  const float fx = __fsub_rn(xs, x0);
  const float fy = __fsub_rn(ys, y0);
  const float gx = __fsub_rn(1.0f, fx);
  const float gy = __fsub_rn(1.0f, fy);
  const S* p = src + static_cast<long long>(b) * src_bstride +
               static_cast<long long>(y0) * src_stride + static_cast<long long>(x0);
  const float ia = load_f32(p), ib = load_f32(p + 1);
  const float ic = load_f32(p + src_stride), id = load_f32(p + src_stride + 1);
  float v = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(ia, gx), gy),
                                          __fmul_rn(__fmul_rn(ib, fx), gy)),
                                __fmul_rn(__fmul_rn(ic, gx), fy)),
                      __fmul_rn(__fmul_rn(id, fx), fy));
  if (!(valid && cov)) v = fillval;
  store<OUT>(out, (static_cast<long long>(b) * h + py) * w + px, v);
  if (cov) covered[b] = 1;   // every writer stores the same value
}

template <typename S, int OUT>
int launch(const float* tables, int Tp, const int* cands, int K, int cell,
           int ncx, const void* src, long long src_bstride, int src_stride,
           const int* src_hw, float fillval, int B, int h, int w,
           int geodesic, void* out, int* covered, cudaStream_t stream) {
  dim3 block(kBx, kBy);
  dim3 grid((w + kBx - 1) / kBx, (h + kBy - 1) / kBy, B);
  raster<S, OUT><<<grid, block, 0, stream>>>(
      tables, Tp, cands, K, cell, ncx, static_cast<const S*>(src),
      src_bstride, src_stride, src_hw, fillval, h, w, geodesic, out, covered);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src_kind: 0 uint8, 1 float32. out_kind: 0 uint8, 1 uint16, 2 float32.
extern "C" int mesh_raster(const float* tables, int Tp, const int* cands,
                           int K, int cell, int ncx, const void* src,
                           long long src_bstride, int src_stride, int src_kind,
                           const int* src_hw, float fillval, int B, int h,
                           int w, int geodesic, int out_kind, void* out,
                           int* covered, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MESH_RASTER_CASE(SK, ST, OK)                                         \
  if (src_kind == SK && out_kind == OK)                                      \
    return launch<ST, OK>(tables, Tp, cands, K, cell, ncx, src, src_bstride, \
                          src_stride, src_hw, fillval, B, h, w, geodesic,    \
                          out, covered, s);
  MESH_RASTER_CASE(0, uint8_t, 0)
  MESH_RASTER_CASE(0, uint8_t, 1)
  MESH_RASTER_CASE(0, uint8_t, 2)
  MESH_RASTER_CASE(1, float, 0)
  MESH_RASTER_CASE(1, float, 1)
  MESH_RASTER_CASE(1, float, 2)
#undef MESH_RASTER_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
