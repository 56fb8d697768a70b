// Mesh raster + affine warp of output blocks for Hopper.
//
// Replaces feabas_tpu/ops/render.py:_raster_core_cells and _finish_raster
// (and the flat _raster_core, which is the same loop over the whole table):
// the XLA programs that rasterize a deformed triangle mesh over an output
// block, take the target->source affine of the winning triangle at every
// pixel and bilinear-sample the source there.
//
// The function. Every pixel walks its 128-px cell's candidate rows (cands,
// ascending, so the first row in index order wins ties exactly as
// native/rasterize.cpp:57 does) or, with no candidate table, every row of
// the block's (Tp, 14) f32 coefficient table:
//     [l1x l1y l1c  l2x l2y l2c  axx ayx bx  axy ayy by  weight color]
// A row is inside when l1 >= -eps, l2 >= -eps and l1 + l2 <= 1 + eps, and
// takes the pixel on a strict weight > score. Padding rows carry
// weight = -inf and l1c < -1: they are never inside. With geodesic masking
// every inside row ORs its fold sheet bit into a mask, and a pixel seen by
// two sheets is uncovered. The winning source coordinate is quantized to
// 1/32 px (rintf: round half to even, as jnp.round and torch.round),
// sampled bilinearly from a uint8 or f32 source (fill outside the source's
// real extents), replaced by fill where uncovered, and rounded and clipped
// to u8/u16 or kept f32. Each block's coverage flag is the OR over its
// pixels.
//
// Arithmetic is spelled out with __fmaf_rn/__fmul_rn/__fadd_rn/__fsub_rn,
// so nvcc contracts nothing on its own. Every affine row is evaluated as
// fma(a, x, b * y) + c -- the contraction XLA applies to the JAX package's
// a * x + b * y + c -- so the inside tests at triangle edges and the source
// coordinates agree bit for bit with the reference and with the plain
// PyTorch version (ops/render.py:raster_blocks_plain).
//
// What bounds it on an H100: the SMs' arithmetic and load pipes, not HBM.
// A 2048^2 block reads ~10 MB of source and writes 4 MB (~4 us of HBM
// time), while the inside test costs ~12 operations per pixel and
// candidate row and the sample ~50 per pixel. A cell's table is padded to
// a power of two and lists every triangle whose bounding box touches the
// cell, so a pixel that walks all K rows spends over half the kernel on
// rows that cannot cover it; a coverage store per pixel sends 131,072
// warp stores of a 2048^2 block to one address (a quarter of the time);
// and one pixel per thread means 16,384 thread blocks, ~12 us even when
// empty. The design, part by part:
//   * A thread block owns a tile of 128 x 8 px inside one cell: one warp
//     spans a tile row, a thread computes 4 adjacent pixels in each of
//     kRows = 2 rows (4 warps). Of the block shapes timed (2, 4 and 8
//     warps by 1, 2, 4 and 8 rows) this one was fastest at every shape.
//   * The block's first threads each load one candidate row (seven 8-byte
//     loads) and test it against the tile: l1 and l2 as spelled are
//     monotone in x and in y (round-to-nearest is monotone), so their
//     extremes over the tile lie at its four corner pixels. A row whose
//     largest l1 or l2 is below -eps, or whose smallest l1 plus smallest l2
//     (a lower bound of every pixel's rounded sum) exceeds 1 + eps, is
//     inside at no pixel of the tile and is dropped; padding rows go the
//     same way. No margin is needed: the rule is exact for the arithmetic
//     as spelled (ops/render.py:tile_cull_plain states it in PyTorch).
//   * Survivors are compacted in ascending order (warp ballot + prefix
//     count) into shared memory, kThreads candidates at a time, so a table
//     of any length is walked in chunks and the first row still wins ties.
//   * The per-pixel loop reads a surviving row once from shared memory (a
//     broadcast) into registers and evaluates the thread's 8 pixels; b * y
//     is computed once per image row. It makes no global load.
//   * Four pixels leave as one 4-, 8- or 16-byte store where w % 4 == 0.
//   * The coverage flag is written by one thread per block, after
//     __syncthreads_or, and only when set; the flags are zeroed on the
//     stream by cudaMemsetAsync.
//   * The source is read with four cached loads per pixel. Dropping the
//     gather altogether shortens a 2048^2 block by 12%, and reading it
//     from a 2 KB window that never leaves L1 by nothing, so a copy of the
//     tile's source footprint into shared memory has nothing to win and is
//     not made.
//
// The Lanczos-4 mode (mesh_raster_lanczos4) shares the raster and the 1/32
// px grid, and replaces the bilinear tap by OpenCV's INTER_LANCZOS4 one:
// 8 x 8 source pixels from floor(x) - 3 to floor(x) + 4 (a 3 px halo
// before the tap origin and 4 after it), weighted by a (32, 8) table of
// normalised f32 weights, one row per 1/32 px fraction, that the caller
// passes (ops/render.py:lanczos4_table; OpenCV's interpolateLanczos4).
// A tap outside the source's real extents reads the fill value (OpenCV's
// BORDER_CONSTANT), and a coordinate whose whole window lies outside gives
// the fill. Each row of 8 is summed in order and the 8 rows weighted in
// order, every product and sum rounded on its own (__fmul_rn, __fadd_rn),
// as raster_blocks_plain spells it. There is no validity cut at the
// source's edge, unlike the bilinear tap. The output is quantized as the
// bilinear one: saturating to u8 / u16, f32 unclipped. The weight table
// sits in shared memory at a row stride of 9 floats, so the 32 fractions a
// warp may read fall in 32 different banks.
//
// Plain C interface, loaded with ctypes. mesh_raster and
// mesh_raster_lanczos4 launch on the given stream, allocate nothing, and
// return cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-9f;
constexpr int kTileW = 128;             // px: the cell edge
constexpr int kPx = 4;                  // adjacent pixels per thread in x
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;   // one warp spans a tile row
constexpr int kRows = 2;                // image rows per thread
constexpr int kTileH = kWarps * kRows;
static_assert(kTileW == 32 * kPx, "a warp spans the tile");
static_assert(kTileW % kTileH == 0, "a tile lies inside one cell");
constexpr int kLinear = 0;
constexpr int kLanczos4 = 1;
constexpr int kFrac = 32;               // the 1/32 px grid
constexpr int kTaps = 8;                // Lanczos-4 taps an axis
constexpr int kLzStride = kTaps + 1;    // shared row stride: no bank clash

__device__ __forceinline__ float affine(float a, float b, float c, float x,
                                        float y) {
  return __fadd_rn(__fmaf_rn(a, x, __fmul_rn(b, y)), c);
}

// a * x + by + c with by = b * y already rounded
__device__ __forceinline__ float affine_by(float a, float by, float c,
                                           float x) {
  return __fadd_rn(__fmaf_rn(a, x, by), c);
}

template <typename T>
__device__ __forceinline__ float load_f32(const T* p) {
  return static_cast<float>(__ldg(p));
}

template <int OUT>
__device__ __forceinline__ float quant(float v) {
  if (OUT == 0) return fminf(fmaxf(rintf(v), 0.0f), 255.0f);
  if (OUT == 1) return fminf(fmaxf(rintf(v), 0.0f), 65535.0f);
  return v;
}

template <int OUT>
__device__ __forceinline__ void store1(void* out, long long i, float v) {
  if (OUT == 0) {
    static_cast<uint8_t*>(out)[i] = static_cast<uint8_t>(v);
  } else if (OUT == 1) {
    static_cast<uint16_t*>(out)[i] = static_cast<uint16_t>(v);
  } else {
    static_cast<float*>(out)[i] = v;
  }
}

// a source tap: the pixel at column xx of row p, or the fill value where
// the row or the column lies outside the source's real extents
template <typename S>
__device__ __forceinline__ float tap(const S* p, bool row_in, int xx, int W,
                                     float fillval) {
  return (row_in && static_cast<unsigned>(xx) < static_cast<unsigned>(W))
             ? load_f32(p + xx)
             : fillval;
}

// Lanczos-4 sample of the (H, W) source at (xs, ys), both on the 1/32 px
// grid; lw is the (32, kLzStride) weight table
template <typename S>
__device__ __forceinline__ float lanczos4(const S* sb, int stride, int H,
                                          int W, float xs, float ys,
                                          const float* lw, float fillval) {
  if (!(xs >= -4.0f && xs < static_cast<float>(W + 3) && ys >= -4.0f &&
        ys < static_cast<float>(H + 3)))
    return fillval;
  const float x0 = floorf(xs);
  const float y0 = floorf(ys);
  const float* wx =
      lw + static_cast<int>(__fmul_rn(__fsub_rn(xs, x0), 32.0f)) * kLzStride;
  const float* wy =
      lw + static_cast<int>(__fmul_rn(__fsub_rn(ys, y0), 32.0f)) * kLzStride;
  const int ix = static_cast<int>(x0) - 3;
  const int iy = static_cast<int>(y0) - 3;
  float val = 0.0f;
#pragma unroll
  for (int r = 0; r < kTaps; ++r) {
    const int yy = iy + r;
    const bool row_in = static_cast<unsigned>(yy) < static_cast<unsigned>(H);
    const S* p = sb + static_cast<long long>(row_in ? yy : 0) * stride;
    float row = __fmul_rn(wx[0], tap(p, row_in, ix, W, fillval));
#pragma unroll
    for (int j = 1; j < kTaps; ++j)
      row = __fadd_rn(row, __fmul_rn(wx[j], tap(p, row_in, ix + j, W,
                                                fillval)));
    val = r == 0 ? __fmul_rn(wy[0], row)
                 : __fadd_rn(val, __fmul_rn(wy[r], row));
  }
  return val;
}

// four quantized pixels at element i (i % 4 == 0, base 16-byte aligned)
template <int OUT>
__device__ __forceinline__ void store4(void* out, long long i,
                                       const float (&v)[kPx]) {
  if (OUT == 0) {
    const uint32_t p = static_cast<uint32_t>(v[0]) |
                       (static_cast<uint32_t>(v[1]) << 8) |
                       (static_cast<uint32_t>(v[2]) << 16) |
                       (static_cast<uint32_t>(v[3]) << 24);
    *reinterpret_cast<uint32_t*>(static_cast<uint8_t*>(out) + i) = p;
  } else if (OUT == 1) {
    uint2 p;
    p.x = static_cast<uint32_t>(v[0]) | (static_cast<uint32_t>(v[1]) << 16);
    p.y = static_cast<uint32_t>(v[2]) | (static_cast<uint32_t>(v[3]) << 16);
    *reinterpret_cast<uint2*>(static_cast<uint16_t*>(out) + i) = p;
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + i) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

// tables (B, Tp, 14); cands (B, NC, K) or null (flat: rows 0..Tp-1);
// src (H, W) shared (src_bstride 0) or (B, H, W) per block, row stride
// src_stride, real extents src_hw (B, 2) = (h, w) or, where null,
// (src_h, src_w) for every block; out (B, h, w); covered (B,) bytes;
// lanczos (32, 8) weights (INTERP == kLanczos4) or null.
template <typename S, int OUT, bool GEO, int INTERP>
__global__ void __launch_bounds__(kThreads)
raster(const float* __restrict__ tables, int Tp,
       const int* __restrict__ cands, int K, int ncx,
       const S* __restrict__ src, long long src_bstride, int src_stride,
       const int* __restrict__ src_hw, int src_h, int src_w, float fillval,
       int h, int w, void* __restrict__ out,
       unsigned char* __restrict__ covered,
       const float* __restrict__ lanczos) {
  // surviving rows of the current chunk, ascending
  __shared__ float4 s_l1[kThreads];   // l1x l1y l1c weight
  __shared__ float4 s_l2[kThreads];   // l2x l2y l2c color
  __shared__ float4 s_ax[kThreads];   // axx ayx bx  axy
  __shared__ float2 s_ay[kThreads];   // ayy by
  __shared__ int s_count[kWarps];
  __shared__ float s_lw[INTERP == kLanczos4 ? kFrac * kLzStride : 1];

  const int tid = threadIdx.x;
  if (INTERP == kLanczos4) {
    for (int i = tid; i < kFrac * kTaps; i += kThreads)
      s_lw[(i / kTaps) * kLzStride + i % kTaps] = __ldg(lanczos + i);
    __syncthreads();
  }
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.z;
  const int tx0 = blockIdx.x * kTileW;
  const int ty0 = blockIdx.y * kTileH;
  // the tile's corner pixels, clipped to the block
  const float cx0 = static_cast<float>(tx0);
  const float cx1 = static_cast<float>(min(tx0 + kTileW, w) - 1);
  const float cy0 = static_cast<float>(ty0);
  const float cy1 = static_cast<float>(min(ty0 + kTileH, h) - 1);

  const float* tab = tables + static_cast<long long>(b) * Tp * 14;
  const int* cl = nullptr;
  int n = Tp;
  if (cands != nullptr) {
    const long long nc = static_cast<long long>(h / kTileW) * ncx;
    const long long c = static_cast<long long>(ty0 / kTileW) * ncx + blockIdx.x;
    cl = cands + (static_cast<long long>(b) * nc + c) * K;
    n = K;
  }

  const int px0 = tx0 + kPx * lane;
  float xf[kPx], yf[kRows];
#pragma unroll
  for (int i = 0; i < kPx; ++i) xf[i] = static_cast<float>(px0 + i);
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    yf[r] = static_cast<float>(ty0 + r * kWarps + warp);

  float score[kRows][kPx], sx[kRows][kPx], sy[kRows][kPx];
  unsigned int smask[kRows][kPx];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int i = 0; i < kPx; ++i) {
      score[r][i] = -INFINITY;
      sx[r][i] = 0.0f;
      sy[r][i] = 0.0f;
      smask[r][i] = 0u;
    }
  }

  for (int c0 = 0; c0 < n; c0 += kThreads) {
    // stage: one candidate row per thread, tested against the tile
    const int k = c0 + tid;
    bool keep = false;
    float2 v0, v1, v2, v3, v4, v5, v6;
    if (k < n) {
      const long long row = cl ? __ldg(cl + k) : k;
      const float2* p = reinterpret_cast<const float2*>(tab + row * 14);
      v0 = __ldg(p);      // l1x l1y
      v1 = __ldg(p + 1);  // l1c l2x
      v2 = __ldg(p + 2);  // l2y l2c
      v3 = __ldg(p + 3);  // axx ayx
      v4 = __ldg(p + 4);  // bx  axy
      v5 = __ldg(p + 5);  // ayy by
      v6 = __ldg(p + 6);  // weight color
      const float a00 = affine(v0.x, v0.y, v1.x, cx0, cy0);
      const float a10 = affine(v0.x, v0.y, v1.x, cx1, cy0);
      const float a01 = affine(v0.x, v0.y, v1.x, cx0, cy1);
      const float a11 = affine(v0.x, v0.y, v1.x, cx1, cy1);
      const float b00 = affine(v1.y, v2.x, v2.y, cx0, cy0);
      const float b10 = affine(v1.y, v2.x, v2.y, cx1, cy0);
      const float b01 = affine(v1.y, v2.x, v2.y, cx0, cy1);
      const float b11 = affine(v1.y, v2.x, v2.y, cx1, cy1);
      const bool hi1 = (a00 >= -kEps) || (a10 >= -kEps) || (a01 >= -kEps) ||
                       (a11 >= -kEps);
      const bool hi2 = (b00 >= -kEps) || (b10 >= -kEps) || (b01 >= -kEps) ||
                       (b11 >= -kEps);
      const float lo1 = fminf(fminf(a00, a10), fminf(a01, a11));
      const float lo2 = fminf(fminf(b00, b10), fminf(b01, b11));
      keep = hi1 && hi2 && (__fadd_rn(lo1, lo2) <= 1.0f + kEps);
    }
    const unsigned int ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();
    int base = 0, total = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const int cnt = s_count[i];
      if (i < warp) base += cnt;
      total += cnt;
    }
    if (keep) {
      const int slot = base + __popc(ballot & ((1u << lane) - 1u));
      s_l1[slot] = make_float4(v0.x, v0.y, v1.x, v6.x);
      s_l2[slot] = make_float4(v1.y, v2.x, v2.y, v6.y);
      s_ax[slot] = make_float4(v3.x, v3.y, v4.x, v4.y);
      s_ay[slot] = v5;
    }
    __syncthreads();

    for (int s = 0; s < total; ++s) {
      const float4 l1 = s_l1[s];
      const float4 l2 = s_l2[s];
      const float4 ax = s_ax[s];
      const float2 ay = s_ay[s];
      const float wt = l1.w;
      unsigned int bit = 0u;
      if (GEO) {
        const int color = static_cast<int>(l2.w);
        if (color >= 0) bit = 1u << color;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float by1 = __fmul_rn(l1.y, yf[r]);
        const float by2 = __fmul_rn(l2.y, yf[r]);
#pragma unroll
        for (int i = 0; i < kPx; ++i) {
          const float e1 = affine_by(l1.x, by1, l1.z, xf[i]);
          const float e2 = affine_by(l2.x, by2, l2.z, xf[i]);
          const bool inside = (e1 >= -kEps) && (e2 >= -kEps) &&
                              (__fadd_rn(e1, e2) <= 1.0f + kEps);
          if (GEO && inside) smask[r][i] |= bit;
          if (inside && wt > score[r][i]) {
            score[r][i] = wt;
            sx[r][i] = affine(ax.x, ax.y, ax.z, xf[i], yf[r]);
            sy[r][i] = affine(ax.w, ay.x, ay.y, xf[i], yf[r]);
          }
        }
      }
    }
    if (c0 + kThreads < n) __syncthreads();   // the next chunk overwrites
  }

  const int H = src_hw ? __ldg(src_hw + 2 * b) : src_h;
  const int W = src_hw ? __ldg(src_hw + 2 * b + 1) : src_w;
  const S* sb = src + static_cast<long long>(b) * src_bstride;
  const bool vec = (w % kPx == 0) && (px0 + kPx <= w);
  int anycov = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int py = ty0 + r * kWarps + warp;
    float v[kPx];
#pragma unroll
    for (int i = 0; i < kPx; ++i) {
      bool cov = score[r][i] != -INFINITY;
      if (GEO) cov = cov && (__popc(smask[r][i]) < 2);
      const float xs =
          __fmul_rn(rintf(__fmul_rn(sx[r][i], 32.0f)), 1.0f / 32.0f);
      const float ys =
          __fmul_rn(rintf(__fmul_rn(sy[r][i], 32.0f)), 1.0f / 32.0f);
      if (INTERP == kLanczos4) {
        const float val =
            cov ? lanczos4(sb, src_stride, H, W, xs, ys, s_lw, fillval)
                : fillval;
        v[i] = quant<OUT>(val);
        if (cov && py < h && px0 + i < w) anycov = 1;
        continue;
      }
      const bool valid = (xs >= 0.0f) && (ys >= 0.0f) &&
                         (xs <= static_cast<float>(W - 1)) &&
                         (ys <= static_cast<float>(H - 1));
      const float x0 =
          fminf(fmaxf(floorf(xs), 0.0f), static_cast<float>(W - 2));
      const float y0 =
          fminf(fmaxf(floorf(ys), 0.0f), static_cast<float>(H - 2));
      const float fx = __fsub_rn(xs, x0);
      const float fy = __fsub_rn(ys, y0);
      const float gx = __fsub_rn(1.0f, fx);
      const float gy = __fsub_rn(1.0f, fy);
      const S* p = sb + static_cast<long long>(y0) * src_stride +
                   static_cast<long long>(x0);
      const float ia = load_f32(p), ib = load_f32(p + 1);
      const float ic = load_f32(p + src_stride);
      const float id = load_f32(p + src_stride + 1);
      float val = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(ia, gx), gy),
                              __fmul_rn(__fmul_rn(ib, fx), gy)),
                    __fmul_rn(__fmul_rn(ic, gx), fy)),
          __fmul_rn(__fmul_rn(id, fx), fy));
      if (!(valid && cov)) val = fillval;
      v[i] = quant<OUT>(val);
      if (cov && py < h && px0 + i < w) anycov = 1;
    }
    if (py < h) {
      const long long o = (static_cast<long long>(b) * h + py) * w + px0;
      if (vec) {
        store4<OUT>(out, o, v);
      } else {
#pragma unroll
        for (int i = 0; i < kPx; ++i)
          if (px0 + i < w) store1<OUT>(out, o + i, v[i]);
      }
    }
  }
  // one coverage write per thread block, and only when set
  const int blockcov = __syncthreads_or(anycov);
  if (tid == 0 && blockcov) covered[b] = 1;
}

template <typename S, int OUT, bool GEO, int INTERP>
int launch(const float* tables, int Tp, const int* cands, int K, int ncx,
           const void* src, long long src_bstride, int src_stride,
           const int* src_hw, int src_h, int src_w, float fillval, int B,
           int h, int w, void* out, unsigned char* covered,
           const float* lanczos, cudaStream_t stream) {
  dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, B);
  raster<S, OUT, GEO, INTERP><<<grid, kThreads, 0, stream>>>(
      tables, Tp, cands, K, ncx, static_cast<const S*>(src), src_bstride,
      src_stride, src_hw, src_h, src_w, fillval, h, w, out, covered,
      lanczos);
  return static_cast<int>(cudaGetLastError());
}

template <int INTERP>
int dispatch(const float* tables, int Tp, const int* cands, int K, int cell,
             int ncx, const void* src, long long src_bstride, int src_stride,
             int src_kind, const int* src_hw, int src_h, int src_w,
             float fillval, int B, int h, int w, int geodesic, int out_kind,
             void* out, unsigned char* covered, const float* lanczos,
             cudaStream_t s) {
  if (cands != nullptr && cell != kTileW)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || h <= 0 || w <= 0 || B > 65535 ||
      (h + kTileH - 1) / kTileH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (INTERP == kLanczos4 && lanczos == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(covered, 0, B, s);
  if (err != cudaSuccess) return static_cast<int>(err);
#define MESH_RASTER_CASE(SK, ST, OK)                                          \
  if (src_kind == SK && out_kind == OK)                                       \
    return geodesic                                                           \
               ? launch<ST, OK, true, INTERP>(                                \
                     tables, Tp, cands, K, ncx, src, src_bstride, src_stride, \
                     src_hw, src_h, src_w, fillval, B, h, w, out, covered,    \
                     lanczos, s)                                              \
               : launch<ST, OK, false, INTERP>(                               \
                     tables, Tp, cands, K, ncx, src, src_bstride, src_stride, \
                     src_hw, src_h, src_w, fillval, B, h, w, out, covered,    \
                     lanczos, s);
  MESH_RASTER_CASE(0, uint8_t, 0)
  MESH_RASTER_CASE(0, uint8_t, 1)
  MESH_RASTER_CASE(0, uint8_t, 2)
  MESH_RASTER_CASE(1, float, 0)
  MESH_RASTER_CASE(1, float, 1)
  MESH_RASTER_CASE(1, float, 2)
#undef MESH_RASTER_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Tile height in px (the tile is 128 px wide): what tile_cull_plain takes.
extern "C" int mesh_raster_tile_h() { return kTileH; }

// src_kind: 0 uint8, 1 float32. out_kind: 0 uint8, 1 uint16, 2 float32.
// src_hw: (B, 2) int32 on the card, or null for (src_h, src_w) everywhere.
// covered: (B,) bytes, zeroed here on the stream and set to 1 per block.
extern "C" int mesh_raster(const float* tables, int Tp, const int* cands,
                           int K, int cell, int ncx, const void* src,
                           long long src_bstride, int src_stride, int src_kind,
                           const int* src_hw, int src_h, int src_w,
                           float fillval, int B, int h, int w, int geodesic,
                           int out_kind, void* out, unsigned char* covered,
                           void* stream) {
  return dispatch<kLinear>(tables, Tp, cands, K, cell, ncx, src, src_bstride,
                           src_stride, src_kind, src_hw, src_h, src_w,
                           fillval, B, h, w, geodesic, out_kind, out, covered,
                           nullptr, static_cast<cudaStream_t>(stream));
}

// mesh_raster's arguments and, before the stream, the (32, 8) f32 Lanczos-4
// weights on the card.
extern "C" int mesh_raster_lanczos4(const float* tables, int Tp,
                                    const int* cands, int K, int cell,
                                    int ncx, const void* src,
                                    long long src_bstride, int src_stride,
                                    int src_kind, const int* src_hw,
                                    int src_h, int src_w, float fillval,
                                    int B, int h, int w, int geodesic,
                                    int out_kind, void* out,
                                    unsigned char* covered,
                                    const float* lanczos, void* stream) {
  return dispatch<kLanczos4>(tables, Tp, cands, K, cell, ncx, src,
                             src_bstride, src_stride, src_kind, src_hw, src_h,
                             src_w, fillval, B, h, w, geodesic, out_kind, out,
                             covered, lanczos,
                             static_cast<cudaStream_t>(stream));
}
