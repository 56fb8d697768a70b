// Montage blend of one output block for Hopper.
//
// Replaces feabas_tpu/ops/montage_render.py:62 (montage_blend, per_cell
// :98): the XLA program that rasterizes every tile hitting an output block
// on the block's 64-px cells, samples the tiles and blends them (LINEAR, or
// two-band PYRAMID).
//
// The function. For each 64 x 64 cell, over its candidate tiles in order
// (cands, -1 padded): the tile's (R, 14) f32 table rows
//     [l1x l1y l1c  l2x l2y l2c  axx ayx bx  axy ayy by  weight color]
// are tested at every pixel: inside when l1 >= -eps, l2 >= -eps and
// l1 + l2 <= 1 + eps, and a pixel takes an inside row on a strict
// weight > score, so the first row wins ties. The winning row's affine
// gives the tile-local source (sx, sy), quantized to 1/32 px and sampled
// bilinearly from the packed-quad stack (one 4-byte word holds a pixel's
// 2x2 neighbourhood; 0 outside [0, W-1] x [0, H-1], clamped base, as
// ops/warp.py:bilinear_sample_packed), then gain * v + offset. The weight
// is clamp(min(sx, tw - sx, sy, th - sy) / margin, 0, 1) where covered.
// LINEAR accumulates acc += v * w, wacc += w; PYRAMID samples the low stack
// too, accumulates acc += low * w and, where w > best_w, takes
// best_hi = v - low. A pixel is acc / max(wacc, 1e-20) + best_hi where
// wacc > 0, else fillval, rounded to nearest even and clamped to uint8 (or
// kept f32). The block's covered flag is the OR of wacc > 0 over the cells.
//
// Arithmetic is spelled with __fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn in the plain version's order (every product and sum its own
// f32 op, as ops/montage_render.py:montage_blend_plain evaluates them), so
// nvcc contracts nothing and the output is bit-equal to the plain version.
// Products a * x and b * y of a row are formed once per pixel column and
// row and summed per pixel: the same rounded values, fewer instructions.
//
// What bounds it on an H100. The function needs, per output pixel, one byte
// out and one source byte per covering tile (two with PYRAMID), plus the
// tables: ~57 MB for a 4096^2 block with ~1.2 covering tiles, ~17 us of
// HBM. Its operations are the inside test of every table row that can
// touch a pixel's cell (13 FLOP each), the affine, sample, weight and blend
// of each covering tile (~55), the output (7): ~1.2 GFLOP, ~18 us at the
// f32 rate. The plain PyTorch version issues ~10 elementwise launches per
// table row and candidate over the whole block (111,116 launches and 3.4 s
// for the stitch path's six blocks). The design, first version:
//   * One thread block of 256 threads per cell (every cell of the block: a
//     cell without a candidate only writes fillval), 16 pixels per thread:
//     4 adjacent pixels in each of 4 rows, so 16 threads span a cell row
//     and one 4-byte (u8) or 16-byte (f32) store leaves per row.
//   * Per candidate, the tile's table streams through shared memory in
//     chunks of 256 rows: each thread loads one row (seven 8-byte loads)
//     and tests it against the cell's four corner pixels. l1 and l2 as
//     spelled are monotone in x and in y (each rounding is monotone), so
//     their extremes over the cell lie at its corners: a row whose largest
//     l1 or l2 is below -eps, or whose smallest l1 plus smallest l2 (no
//     pixel's rounded sum falls below their rounded sum) exceeds 1 + eps,
//     is inside at no pixel of the cell and is dropped; so is a row of
//     weight -inf, which never wins. The rule is exact for the arithmetic
//     as spelled (ops/montage_render.py:cell_cull_plain states it), so a
//     dropped row never changes a pixel. Survivors are compacted in order
//     (warp ballot + prefix count), so a table of any length keeps its
//     first-wins order, and walked from shared memory (a broadcast).
//   * A pixel that no row covers, or whose weight is 0, skips its sample
//     and blend: adding 0 * v and 0 changes no sum, so this is exact too.
//   * Uncovered padding candidates (-1) are skipped for the whole block.
//   * The covered flag is zeroed on the stream and written by one thread
//     of a block, after __syncthreads_or, only when set.
//
// Plain C interface, loaded with ctypes. montage_blend launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-9f;
constexpr int kCell = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPx = 4;                       // adjacent pixels per thread
constexpr int kCols = kCell / kPx;           // threads across a cell row
constexpr int kRowStep = kThreads / kCols;   // rows between a thread's rows
constexpr int kRows = kCell / kRowStep;      // rows per thread
static_assert(kCols * kRowStep == kThreads, "threads tile the cell");
static_assert(kRows * kRowStep == kCell, "rows tile the cell");

// a * x + b * y + c as three rounded ops, the plain version's order
__device__ __forceinline__ float lin(float a, float b, float c, float x,
                                     float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

// bilinear sample of a packed-quad plane: 0 outside [0, W-1] x [0, H-1],
// fractions against the clamped base (ops/warp.py:_bilinear_weights)
__device__ __forceinline__ float sample(const int32_t* __restrict__ p, int H,
                                        int W, float xs, float ys) {
  const bool valid = (xs >= 0.0f) && (ys >= 0.0f) &&
                     (xs <= static_cast<float>(W - 1)) &&
                     (ys <= static_cast<float>(H - 1));
  if (!valid) return 0.0f;
  const float x0 = fminf(fmaxf(floorf(xs), 0.0f), static_cast<float>(W - 2));
  const float y0 = fminf(fmaxf(floorf(ys), 0.0f), static_cast<float>(H - 2));
  const float fx = __fsub_rn(xs, x0);
  const float fy = __fsub_rn(ys, y0);
  const float gx = __fsub_rn(1.0f, fx);
  const float gy = __fsub_rn(1.0f, fy);
  const uint32_t q = static_cast<uint32_t>(__ldg(
      p + static_cast<long long>(y0) * W + static_cast<long long>(x0)));
  const float ia = static_cast<float>(q & 0xffu);
  const float ib = static_cast<float>((q >> 8) & 0xffu);
  const float ic = static_cast<float>((q >> 16) & 0xffu);
  const float id = static_cast<float>(q >> 24);
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(ia, gx), gy),
                          __fmul_rn(__fmul_rn(ib, fx), gy)),
                __fmul_rn(__fmul_rn(ic, gx), fy)),
      __fmul_rn(__fmul_rn(id, fx), fy));
}

// srcs / lows (N, H, W) packed quads; gmap (T,) slot -> plane; tables
// (T, R, 14); aux (T, 5) [tw th margin gain offset]; cands (C, K); out
// (ncy * 64, ncx * 64) u8 (OUT 0) or f32 (OUT 1); covered one byte.
template <bool PYR, int OUT>
__global__ void __launch_bounds__(kThreads)
blend_kernel(const int32_t* __restrict__ srcs, const int32_t* __restrict__ lows,
             int H, int W, const long long* __restrict__ gmap,
             const float* __restrict__ tables, int R,
             const float* __restrict__ aux, const long long* __restrict__ cands,
             int K, int ncx, float fillval, void* __restrict__ out,
             unsigned char* __restrict__ covered) {
  // surviving rows of the current chunk, in order
  __shared__ float4 s_l1[kThreads];   // l1x l1y l1c weight
  __shared__ float4 s_l2[kThreads];   // l2x l2y l2c -
  __shared__ float4 s_ax[kThreads];   // axx ayx bx  axy
  __shared__ float2 s_ay[kThreads];   // ayy by
  __shared__ int s_count[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cell = blockIdx.x;
  const int cx = (cell % ncx) * kCell;
  const int cy = (cell / ncx) * kCell;
  const int px0 = cx + kPx * (tid % kCols);
  const int py0 = cy + tid / kCols;
  float xf[kPx], yf[kRows];
#pragma unroll
  for (int i = 0; i < kPx; ++i) xf[i] = static_cast<float>(px0 + i);
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    yf[r] = static_cast<float>(py0 + r * kRowStep);
  // the cell's corner pixels
  const float cx0 = static_cast<float>(cx);
  const float cx1 = static_cast<float>(cx + kCell - 1);
  const float cy0 = static_cast<float>(cy);
  const float cy1 = static_cast<float>(cy + kCell - 1);
  const long long plane = static_cast<long long>(H) * W;

  float acc[kRows][kPx], wacc[kRows][kPx], best_w[kRows][kPx],
      best_hi[kRows][kPx];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int i = 0; i < kPx; ++i) {
      acc[r][i] = 0.0f;
      wacc[r][i] = 0.0f;
      best_w[r][i] = 0.0f;
      best_hi[r][i] = 0.0f;
    }
  }

  const long long* cl = cands + static_cast<long long>(cell) * K;
  for (int k = 0; k < K; ++k) {
    const long long t = __ldg(cl + k);
    if (t < 0) continue;                 // the same for every thread
    const float* tab = tables + t * R * 14;
    float score[kRows][kPx], sx[kRows][kPx], sy[kRows][kPx];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int i = 0; i < kPx; ++i) {
        score[r][i] = -INFINITY;
        sx[r][i] = 0.0f;
        sy[r][i] = 0.0f;
      }
    }
    for (int c0 = 0; c0 < R; c0 += kThreads) {
      // stage: one table row per thread, tested against the cell
      const int j = c0 + tid;
      bool keep = false;
      float2 v0, v1, v2, v3, v4, v5, v6;
      if (j < R) {
        const float2* p = reinterpret_cast<const float2*>(tab + j * 14);
        v0 = __ldg(p);      // l1x l1y
        v1 = __ldg(p + 1);  // l1c l2x
        v2 = __ldg(p + 2);  // l2y l2c
        v3 = __ldg(p + 3);  // axx ayx
        v4 = __ldg(p + 4);  // bx  axy
        v5 = __ldg(p + 5);  // ayy by
        v6 = __ldg(p + 6);  // weight color
        const float a00 = lin(v0.x, v0.y, v1.x, cx0, cy0);
        const float a10 = lin(v0.x, v0.y, v1.x, cx1, cy0);
        const float a01 = lin(v0.x, v0.y, v1.x, cx0, cy1);
        const float a11 = lin(v0.x, v0.y, v1.x, cx1, cy1);
        const float b00 = lin(v1.y, v2.x, v2.y, cx0, cy0);
        const float b10 = lin(v1.y, v2.x, v2.y, cx1, cy0);
        const float b01 = lin(v1.y, v2.x, v2.y, cx0, cy1);
        const float b11 = lin(v1.y, v2.x, v2.y, cx1, cy1);
        const bool hi1 = (a00 >= -kEps) || (a10 >= -kEps) ||
                         (a01 >= -kEps) || (a11 >= -kEps);
        const bool hi2 = (b00 >= -kEps) || (b10 >= -kEps) ||
                         (b01 >= -kEps) || (b11 >= -kEps);
        const float lo1 = fminf(fminf(a00, a10), fminf(a01, a11));
        const float lo2 = fminf(fminf(b00, b10), fminf(b01, b11));
        keep = hi1 && hi2 && (__fadd_rn(lo1, lo2) <= 1.0f + kEps) &&
               (v6.x > -INFINITY);
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
        s_l2[slot] = make_float4(v1.y, v2.x, v2.y, 0.0f);
        s_ax[slot] = make_float4(v3.x, v3.y, v4.x, v4.y);
        s_ay[slot] = v5;
      }
      __syncthreads();

      for (int s = 0; s < total; ++s) {
        const float4 l1 = s_l1[s];
        const float4 l2 = s_l2[s];
        float ax1[kPx], ax2[kPx];
#pragma unroll
        for (int i = 0; i < kPx; ++i) {
          ax1[i] = __fmul_rn(l1.x, xf[i]);
          ax2[i] = __fmul_rn(l2.x, xf[i]);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float by1 = __fmul_rn(l1.y, yf[r]);
          const float by2 = __fmul_rn(l2.y, yf[r]);
#pragma unroll
          for (int i = 0; i < kPx; ++i) {
            const float e1 = __fadd_rn(__fadd_rn(ax1[i], by1), l1.z);
            const float e2 = __fadd_rn(__fadd_rn(ax2[i], by2), l2.z);
            const bool inside = (e1 >= -kEps) && (e2 >= -kEps) &&
                                (__fadd_rn(e1, e2) <= 1.0f + kEps);
            if (inside && l1.w > score[r][i]) {
              const float4 ax = s_ax[s];
              const float2 ay = s_ay[s];
              score[r][i] = l1.w;
              sx[r][i] = lin(ax.x, ax.y, ax.z, xf[i], yf[r]);
              sy[r][i] = lin(ax.w, ay.x, ay.y, xf[i], yf[r]);
            }
          }
        }
      }
      __syncthreads();   // the next chunk or candidate overwrites the rows
    }

    // sample, weight and blend this candidate
    const float tw = __ldg(aux + t * 5);
    const float th = __ldg(aux + t * 5 + 1);
    const float margin = __ldg(aux + t * 5 + 2);
    const float gain = __ldg(aux + t * 5 + 3);
    const float offset = __ldg(aux + t * 5 + 4);
    const long long g = __ldg(gmap + t);
    const int32_t* sp = srcs + g * plane;
    const int32_t* lp = PYR ? lows + g * plane : nullptr;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int i = 0; i < kPx; ++i) {
        if (score[r][i] == -INFINITY) continue;
        const float x = sx[r][i], y = sy[r][i];
        const float d = fminf(fminf(x, __fsub_rn(tw, x)),
                              fminf(y, __fsub_rn(th, y)));
        const float w = fminf(fmaxf(__fdiv_rn(d, margin), 0.0f), 1.0f);
        if (!(w > 0.0f)) continue;
        const float xs = __fmul_rn(rintf(__fmul_rn(x, 32.0f)), 1.0f / 32.0f);
        const float ys = __fmul_rn(rintf(__fmul_rn(y, 32.0f)), 1.0f / 32.0f);
        const float v =
            __fadd_rn(__fmul_rn(sample(sp, H, W, xs, ys), gain), offset);
        if (PYR) {
          const float lv =
              __fadd_rn(__fmul_rn(sample(lp, H, W, xs, ys), gain), offset);
          if (w > best_w[r][i]) {
            best_w[r][i] = w;
            best_hi[r][i] = __fsub_rn(v, lv);
          }
          acc[r][i] = __fadd_rn(acc[r][i], __fmul_rn(lv, w));
        } else {
          acc[r][i] = __fadd_rn(acc[r][i], __fmul_rn(v, w));
        }
        wacc[r][i] = __fadd_rn(wacc[r][i], w);
      }
    }
  }

  const long long ow = static_cast<long long>(ncx) * kCell;
  int any = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float v[kPx];
#pragma unroll
    for (int i = 0; i < kPx; ++i) {
      float o = fillval;
      if (wacc[r][i] > 0.0f) {
        o = __fadd_rn(__fdiv_rn(acc[r][i], fmaxf(wacc[r][i], 1e-20f)),
                      best_hi[r][i]);
        any = 1;
      }
      v[i] = OUT == 0 ? fminf(fmaxf(rintf(o), 0.0f), 255.0f) : o;
    }
    const long long o = (static_cast<long long>(py0) + r * kRowStep) * ow + px0;
    if (OUT == 0) {
      const uint32_t p = static_cast<uint32_t>(v[0]) |
                         (static_cast<uint32_t>(v[1]) << 8) |
                         (static_cast<uint32_t>(v[2]) << 16) |
                         (static_cast<uint32_t>(v[3]) << 24);
      *reinterpret_cast<uint32_t*>(static_cast<uint8_t*>(out) + o) = p;
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + o) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  // one flag write per thread block, and only when set
  const int cellcov = __syncthreads_or(any);
  if (tid == 0 && cellcov) *covered = 1;
}

template <bool PYR, int OUT>
int launch(const int32_t* srcs, const int32_t* lows, int H, int W,
           const long long* gmap, const float* tables, int R, const float* aux,
           const long long* cands, int K, int C, int ncx, float fillval,
           void* out, unsigned char* covered, cudaStream_t stream) {
  blend_kernel<PYR, OUT><<<C, kThreads, 0, stream>>>(
      srcs, lows, H, W, gmap, tables, R, aux, cands, K, ncx, fillval, out,
      covered);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Cell edge in px: what ops/montage_render.py's CELL must equal.
extern "C" int montage_blend_cell() { return kCell; }

// out_kind: 0 uint8, 1 float32. covered: one byte, zeroed here on the
// stream and set to 1 where any pixel has weight.
extern "C" int montage_blend(const int32_t* srcs, const int32_t* lows, int H,
                             int W, const long long* gmap,
                             const float* tables, int R, const float* aux,
                             const long long* cands, int K, int ncy, int ncx,
                             float fillval, int pyramid, int out_kind,
                             void* out, unsigned char* covered, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H < 2 || W < 2 || R < 0 || K < 0 || ncy <= 0 || ncx <= 0 ||
      static_cast<long long>(ncy) * ncx > 0x7fffffffLL ||
      (pyramid && lows == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(covered, 0, 1, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int C = ncy * ncx;
#define MONTAGE_BLEND_CASE(P, O)                                            \
  if (static_cast<bool>(pyramid) == P && out_kind == O)                     \
    return launch<P, O>(srcs, lows, H, W, gmap, tables, R, aux, cands, K, C, \
                        ncx, fillval, out, covered, s);
  MONTAGE_BLEND_CASE(false, 0)
  MONTAGE_BLEND_CASE(false, 1)
  MONTAGE_BLEND_CASE(true, 0)
  MONTAGE_BLEND_CASE(true, 1)
#undef MONTAGE_BLEND_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
