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
// Two places compute the same value another way, each exactly: the
// bilinear tap (interp: every term is exact in f32) and the quotients
// d / margin and acc / wacc where they are known to be >= 1, <= 0 or acc
// itself.
//
// What bounds it on an H100. The function needs, per output pixel, one byte
// out and one source byte per covering tile (two with PYRAMID), plus the
// tables: ~37 MB for the stitch path's 4096^2 PYRAMID block of 4 x 146 rows
// (1.18 covering tiles a pixel), ~11 us of HBM. Its operations are the
// inside test of every row the cell cull keeps (13 FLOP a pixel), the
// affine, sample, weight and blend of each covering tile (52, 15 more for
// the low band) and the output (7): 1.94 GFLOP, 28.90 us at the f32 rate
// (chip_smoke.montage_bound counts both). FLOP-bound; bit-equality forbids
// contracting them into FMAs, so the card's issue rate is half that peak.
//
// Design (second version; the first, one block of 16 px a thread per cell,
// held one 256-thread block per SM and ran at 6% of the bound on the path's
// heaviest block):
//   * The work unit is half a cell, 64 x 32 px, and a thread carries 8 of
//     its pixels: columns lane and lane + 32 of rows warp + 8 j (j < 4). A
//     warp's access for one pixel slot is 32 adjacent pixels of one row, so
//     its source gathers fall on one or two 128-byte lines and its stores
//     are coalesced.
//   * Persistent grid: as many blocks as fit on the card (the occupancy
//     query: 3 a SM) walk the units in a strided order; each block loads
//     the next unit's first 32 candidates into a register while it works on
//     the current one, so the candidate list never waits.
//   * Raster and blend are split. The raster keeps, per pixel, only the
//     winning row's index in the tile's table and its weight (two
//     registers, not the first version's score / sx / sy); the blend
//     re-reads that row's six affine coefficients (L1-resident: a tile's
//     table is a few KB) and recomputes sx, sy with the same rounded ops,
//     which gives the same bits (ops/montage_render.py:winner_rows_plain
//     states the split).
//   * Per candidate, the tile's table streams in chunks of 256 rows: each
//     thread loads one row and tests it against the cell's four corner
//     pixels. l1 and l2 as spelled are monotone in x and in y (each rounding
//     is monotone), so their extremes over the cell lie at its corners: a
//     row whose largest l1 or l2 is below -eps, or whose smallest l1 plus
//     smallest l2 exceeds 1 + eps, is inside at no pixel of the cell and is
//     dropped; so is a row of weight -inf, which never wins. The rule is
//     exact for the arithmetic as spelled (ops/montage_render.py:
//     cell_cull_plain states it). Survivors are compacted in order (warp
//     ballot + prefix count), so any R keeps its first-wins order. Two
//     barriers a chunk: the next chunk's writes come after the next
//     chunk's first barrier, which every thread reaches only once it has
//     rastered the current one.
//   * A candidate whose cull kept no row skips its blend: it reads no aux,
//     gmap or source. In the blend, a thread computes the addresses of four
//     covered pixels at a time and issues their gathers (one or two a
//     pixel) together, then blends; an uncovered or zero-weight pixel takes
//     no sample (adding 0 * v and 0 changes no sum, so this is exact).
//   * The covered flag is zeroed on the stream and written by one thread
//     of a block, after __syncthreads_or over all its units, only when set.
//
// Budget (nvcc -Xptxas -v, CUDA 12.8, sm_90a): __launch_bounds__(256, 3)
// caps a thread at 80 registers, so 3 blocks (24 warps) fit a SM; static
// shared memory is 8.3 KB a block (256 survivors of 32 B, the candidate
// lists and counts). LINEAR spills nothing. PYRAMID keeps 32 accumulator
// registers and spills 140 bytes (80 reloaded) to a 40-byte stack frame.
// The layout measured without spills at 3 blocks a SM, PYRAMID units of
// a quarter cell (4 px a thread), ran 11-22% slower on the stitch path's
// blocks (twice the per-unit cull and barriers; PERF.md), so the spilling
// one stays. montage_blend_attrs reports the registers, local bytes,
// shared bytes and resident blocks a SM that the runtime sees.
//
// Plain C interface, loaded with ctypes. montage_blend launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr float kEps = 1e-9f;
constexpr int kCell = 64;
constexpr int kUnitH = 32;                   // rows of a unit: half a cell
constexpr int kUnits = kCell / kUnitH;       // units a cell
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSpanX = kCell / 32;           // columns a thread: lane + 32 h
constexpr int kSpanY = kUnitH / kWarps;      // rows a thread: warp + 8 j
constexpr int kPx = kSpanX * kSpanY;         // pixels a thread
constexpr int kBatch = 4;                    // pixels whose gathers fly together
constexpr int kGroup = 32;                   // candidates compacted at once
constexpr int kMinBlocks = 3;                // resident blocks a SM
constexpr int kMaxDevices = 64;
// cells a launch may hold: its units, plus a grid's stride, stay in 32 bits
constexpr long long kMaxCells = (1LL << 30) - 1;
static_assert(kSpanX * 32 == kCell && kSpanY * kWarps == kUnitH,
              "threads tile the unit");
static_assert(kPx % kBatch == 0, "batches tile a thread's pixels");

// a * x + b * y + c as three rounded ops, the plain version's order
__device__ __forceinline__ float lin(float a, float b, float c, float x,
                                     float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

// float of byte k of q
__device__ __forceinline__ float byte_f(uint32_t q, int k) {
  return static_cast<float>((q >> (8 * k)) & 255u);
}

// One bilinear tap of a packed-quad plane at the source (sx, sy), quantized
// to 1/32 px as rint(s * 32) / 32: ops/warp.py:_bilinear_weights (0 outside
// [0, W-1] x [0, H-1], fractions against the clamped base).
struct Tap {
  long long off;   // word of the clamped base, -1 when outside
  float fx, fy;
};

__device__ __forceinline__ Tap tap_of(int H, int W, float sx, float sy) {
  Tap t;
  const float vx = __fmul_rn(sx, 32.0f);
  const float vy = __fmul_rn(sy, 32.0f);
  const float xs = __fmul_rn(rintf(vx), 1.0f / 32.0f);
  const float ys = __fmul_rn(rintf(vy), 1.0f / 32.0f);
  const float fx0 = fminf(fmaxf(floorf(xs), 0.0f), static_cast<float>(W - 2));
  const float fy0 = fminf(fmaxf(floorf(ys), 0.0f), static_cast<float>(H - 2));
  t.fx = __fsub_rn(xs, fx0);
  t.fy = __fsub_rn(ys, fy0);
  const bool valid = (xs >= 0.0f) && (ys >= 0.0f) &&
                     (xs <= static_cast<float>(W - 1)) &&
                     (ys <= static_cast<float>(H - 1));
  t.off = valid ? static_cast<long long>(fy0) * W + static_cast<int>(fx0)
               : -1LL;
  return t;
}

// The bilinear value of a tap. Its fractions are multiples of 1/32 in
// [0, 1] (the tap is rint(s * 32) / 32 less an integer base; an outside tap
// has q = 0 and fractions 0), so each product of a byte and two weights and
// each partial sum is an integer below 2^18 over 1024: exact in f32. The
// plain version's rounded ops in its order and these FMAs in theirs give the
// same value, bit for bit.
__device__ __forceinline__ float interp(uint32_t q, float fx, float fy) {
  const float gx = __fsub_rn(1.0f, fx);
  const float gy = __fsub_rn(1.0f, fy);
  const float top = __fmaf_rn(byte_f(q, 1), fx, __fmul_rn(byte_f(q, 0), gx));
  const float bot = __fmaf_rn(byte_f(q, 3), fx, __fmul_rn(byte_f(q, 2), gx));
  return __fmaf_rn(bot, fy, __fmul_rn(top, gy));
}

// srcs / lows (N, H, W) packed quads; gmap (T,) slot -> plane; tables
// (T, R, 14); aux (T, 5) [tw th margin gain offset]; cands (C, K); out
// (ncy * 64, ncx * 64) u8 (OUT 0) or f32 (OUT 1); covered one byte.
template <bool PYR, int OUT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
blend_kernel(const int32_t* __restrict__ srcs, const int32_t* __restrict__ lows,
             int H, int W, const long long* __restrict__ gmap,
             const float* __restrict__ tables, int R,
             const float* __restrict__ aux, const long long* __restrict__ cands,
             int K, int ncx, unsigned int units, float fillval,
             void* __restrict__ out, unsigned char* __restrict__ covered) {
  // surviving rows of the current chunk, in order
  __shared__ float4 s_l1[kThreads];   // l1x l1y l1c weight
  __shared__ float4 s_l2[kThreads];   // l2x l2y l2c, row index (int bits)
  __shared__ int s_count[kWarps];
  // the real candidates of a group, in order; two buffers, by group parity
  __shared__ int s_live[2][kGroup];
  __shared__ int s_nlive[2];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long plane = static_cast<long long>(H) * W;
  const long long ow = static_cast<long long>(ncx) * kCell;
  const unsigned int stride = gridDim.x;
  const int kfirst = K < kGroup ? K : kGroup;
  int parity = 0;
  int any = 0;

  // the first group of candidates of this block's next unit, one a thread
  unsigned int u = blockIdx.x;
  long long next = -1;
  if (u < units && tid < kfirst)
    next = __ldg(cands + static_cast<long long>(u / kUnits) * K + tid);

  for (; u < units; u += stride) {
    const unsigned int cell = u / kUnits;
    const int cx = static_cast<int>(cell % ncx) * kCell;
    const int cy = static_cast<int>(cell / ncx) * kCell;
    const int uy = cy + static_cast<int>(u % kUnits) * kUnitH;
    float xf[kSpanX], yf[kSpanY];
#pragma unroll
    for (int h = 0; h < kSpanX; ++h)
      xf[h] = static_cast<float>(cx + lane + 32 * h);
#pragma unroll
    for (int j = 0; j < kSpanY; ++j)
      yf[j] = static_cast<float>(uy + warp + kWarps * j);
    // the cell's corner pixels
    const float cx0 = static_cast<float>(cx);
    const float cx1 = static_cast<float>(cx + kCell - 1);
    const float cy0 = static_cast<float>(cy);
    const float cy1 = static_cast<float>(cy + kCell - 1);

    float acc[kPx], wacc[kPx], best_w[kPx], best_hi[kPx];
#pragma unroll
    for (int p = 0; p < kPx; ++p) {
      acc[p] = 0.0f;
      wacc[p] = 0.0f;
      best_w[p] = 0.0f;
      best_hi[p] = 0.0f;
    }

    for (int k0 = 0; k0 < K; k0 += kGroup) {
      long long t;
      if (k0 == 0) {
        t = next;
        const unsigned int un = u + stride;
        next = (un < units && tid < kfirst)
                   ? __ldg(cands + static_cast<long long>(un / kUnits) * K + tid)
                   : -1;
      } else {
        t = (tid < K - k0 && tid < kGroup)
                ? __ldg(cands + static_cast<long long>(cell) * K + k0 + tid)
                : -1;
      }
      if (warp == 0) {
        const unsigned int live = __ballot_sync(0xffffffffu, t >= 0);
        if (t >= 0)
          s_live[parity][__popc(live & ((1u << lane) - 1u))] =
              static_cast<int>(t);
        if (lane == 0) s_nlive[parity] = __popc(live);
      }
      __syncthreads();
      const int nlive = s_nlive[parity];

      for (int c = 0; c < nlive; ++c) {
        const int tt = s_live[parity][c];
        const float* tab = tables + static_cast<long long>(tt) * R * 14;
        float score[kPx];
        int win[kPx];
#pragma unroll
        for (int p = 0; p < kPx; ++p) {
          score[p] = -INFINITY;
          win[p] = 0;
        }
        bool kept = false;
        for (int c0 = 0; c0 < R; c0 += kThreads) {
          // cull: one table row per thread, tested against the cell
          const int j = c0 + tid;
          bool keep = false;
          float4 r1, r2;
          if (j < R) {
            const float2* q = reinterpret_cast<const float2*>(tab + j * 14);
            const float2 v0 = __ldg(q);      // l1x l1y
            const float2 v1 = __ldg(q + 1);  // l1c l2x
            const float2 v2 = __ldg(q + 2);  // l2y l2c
            const float2 v6 = __ldg(q + 6);  // weight color
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
            r1 = make_float4(v0.x, v0.y, v1.x, v6.x);
            r2 = make_float4(v1.y, v2.x, v2.y, __int_as_float(j));
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
            s_l1[slot] = r1;
            s_l2[slot] = r2;
          }
          __syncthreads();
          kept = kept || total > 0;

          // raster: each pixel keeps its winning row and that row's weight
          for (int s = 0; s < total; ++s) {
            const float4 l1 = s_l1[s];
            const float4 l2 = s_l2[s];
            float ax1[kSpanX], ax2[kSpanX];
#pragma unroll
            for (int h = 0; h < kSpanX; ++h) {
              ax1[h] = __fmul_rn(l1.x, xf[h]);
              ax2[h] = __fmul_rn(l2.x, xf[h]);
            }
#pragma unroll
            for (int jy = 0; jy < kSpanY; ++jy) {
              const float by1 = __fmul_rn(l1.y, yf[jy]);
              const float by2 = __fmul_rn(l2.y, yf[jy]);
#pragma unroll
              for (int h = 0; h < kSpanX; ++h) {
                const int p = jy * kSpanX + h;
                const float e1 = __fadd_rn(__fadd_rn(ax1[h], by1), l1.z);
                const float e2 = __fadd_rn(__fadd_rn(ax2[h], by2), l2.z);
                const bool inside = (e1 >= -kEps) && (e2 >= -kEps) &&
                                    (__fadd_rn(e1, e2) <= 1.0f + kEps);
                if (inside && l1.w > score[p]) {
                  score[p] = l1.w;
                  win[p] = __float_as_int(l2.w);
                }
              }
            }
          }
        }
        if (!kept) continue;             // the same for every thread
#pragma unroll
        for (int p = 0; p < kPx; ++p)
          if (score[p] == -INFINITY) win[p] = -1;   // no row covers it

        // blend: the tile's constants, then every covered pixel's source
        // from its winning row, its gathers issued together
        const float tw = __ldg(aux + tt * 5);
        const float th = __ldg(aux + tt * 5 + 1);
        const float margin = __ldg(aux + tt * 5 + 2);
        const float gain = __ldg(aux + tt * 5 + 3);
        const float offset = __ldg(aux + tt * 5 + 4);
        const bool mpos = margin > 0.0f;
        const long long g = __ldg(gmap + tt);
        const uint32_t* sp = reinterpret_cast<const uint32_t*>(srcs + g * plane);
        const uint32_t* lp =
            PYR ? reinterpret_cast<const uint32_t*>(lows + g * plane) : nullptr;
#pragma unroll
        for (int p0 = 0; p0 < kPx; p0 += kBatch) {
          float w[kBatch], fx[kBatch], fy[kBatch];
          uint32_t qv[kBatch], ql[kBatch];
#pragma unroll
          for (int i = 0; i < kBatch; ++i) {
            const int p = p0 + i;
            w[i] = 0.0f;
            fx[i] = 0.0f;   // an outside tap keeps 0, 0 and q = 0: v = +0
            fy[i] = 0.0f;
            qv[i] = 0u;
            ql[i] = 0u;
            if (win[p] < 0) continue;
            const float x = xf[p % kSpanX], y = yf[p / kSpanX];
            const float2* q =
                reinterpret_cast<const float2*>(tab + win[p] * 14 + 6);
            const float2 m0 = __ldg(q);      // axx ayx
            const float2 m1 = __ldg(q + 1);  // bx  axy
            const float2 m2 = __ldg(q + 2);  // ayy by
            const float sx = lin(m0.x, m0.y, m1.x, x, y);
            const float sy = lin(m1.y, m2.x, m2.y, x, y);
            const float d = fminf(fminf(sx, __fsub_rn(tw, sx)),
                                  fminf(sy, __fsub_rn(th, sy)));
            // clamp(d / margin, 0, 1); with margin > 0 the quotient of
            // d >= margin rounds to >= 1 and of d <= 0 to <= 0
            w[i] = (mpos && d >= margin)    ? 1.0f
                   : (mpos && !(d > 0.0f)) ? 0.0f
                   : fminf(fmaxf(__fdiv_rn(d, margin), 0.0f), 1.0f);
            if (!(w[i] > 0.0f)) continue;
            const Tap tp = tap_of(H, W, sx, sy);
            if (tp.off < 0) continue;
            fx[i] = tp.fx;
            fy[i] = tp.fy;
            qv[i] = __ldg(sp + tp.off);
            if (PYR) ql[i] = __ldg(lp + tp.off);
          }
#pragma unroll
          for (int i = 0; i < kBatch; ++i) {
            const int p = p0 + i;
            if (!(w[i] > 0.0f)) continue;
            const float v = __fadd_rn(
                __fmul_rn(interp(qv[i], fx[i], fy[i]), gain), offset);
            if (PYR) {
              const float lv = __fadd_rn(
                  __fmul_rn(interp(ql[i], fx[i], fy[i]), gain), offset);
              if (w[i] > best_w[p]) {
                best_w[p] = w[i];
                best_hi[p] = __fsub_rn(v, lv);
              }
              acc[p] = __fadd_rn(acc[p], __fmul_rn(lv, w[i]));
            } else {
              acc[p] = __fadd_rn(acc[p], __fmul_rn(v, w[i]));
            }
            wacc[p] = __fadd_rn(wacc[p], w[i]);
          }
        }
      }
      parity ^= 1;
    }

    const long long at0 =
        (static_cast<long long>(uy) + warp) * ow + cx + lane;
#pragma unroll
    for (int p = 0; p < kPx; ++p) {
      float o = fillval;
      if (wacc[p] > 0.0f) {
        // x / 1 is x: the one-tile interior skips the division
        o = __fadd_rn(wacc[p] == 1.0f
                          ? acc[p]
                          : __fdiv_rn(acc[p], fmaxf(wacc[p], 1e-20f)),
                      best_hi[p]);
        any = 1;
      }
      const long long at = at0 + kWarps * (p / kSpanX) * ow + 32 * (p % kSpanX);
      if (OUT == 0)   // clamp, then round to nearest even
        static_cast<uint8_t*>(out)[at] = static_cast<uint8_t>(
            __float2int_rn(fminf(fmaxf(o, 0.0f), 255.0f)));
      else
        static_cast<float*>(out)[at] = o;
    }
  }
  // one flag write per thread block, and only when set
  const int cov = __syncthreads_or(any);
  if (tid == 0 && cov) *covered = 1;
}

template <bool PYR, int OUT>
cudaError_t attrs(int* regs, int* local_bytes, int* shared_bytes,
                  int* blocks_per_sm) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, blend_kernel<PYR, OUT>);
  if (err != cudaSuccess) return err;
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *shared_bytes = static_cast<int>(a.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, blend_kernel<PYR, OUT>, kThreads, 0);
}

// Blocks that fit the current device at once (its SMs times the resident
// blocks a SM of this instance), set at the first launch on each device
// under a lock: callers may launch from several host threads.
template <bool PYR, int OUT>
int grid_fit(long long* fit) {
  static std::mutex lock;
  static long long fit_of[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  std::lock_guard<std::mutex> guard(lock);
  if (fit_of[dev] == 0) {
    int n_sm = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, blend_kernel<PYR, OUT>, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    fit_of[dev] = static_cast<long long>(n_sm) * (per_sm > 0 ? per_sm : 1);
  }
  *fit = fit_of[dev];
  return 0;
}

template <bool PYR, int OUT>
int launch(const int32_t* srcs, const int32_t* lows, int H, int W,
           const long long* gmap, const float* tables, int R, const float* aux,
           const long long* cands, int K, long long C, int ncx, float fillval,
           void* out, unsigned char* covered, cudaStream_t stream) {
  long long fit = 0;
  const int err = grid_fit<PYR, OUT>(&fit);
  if (err != 0) return err;
  const unsigned int units = static_cast<unsigned int>(C * kUnits);
  const int grid = static_cast<int>(units < fit ? units : fit);
  blend_kernel<PYR, OUT><<<grid, kThreads, 0, stream>>>(
      srcs, lows, H, W, gmap, tables, R, aux, cands, K, ncx, units, fillval,
      out, covered);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Cell edge in px: what ops/montage_render.py's CELL must equal.
extern "C" int montage_blend_cell() { return kCell; }

// out4 = [registers a thread, local (spill) bytes a thread, static shared
// bytes a block, resident 256-thread blocks a SM] of one instantiation.
extern "C" int montage_blend_attrs(int pyramid, int out_kind, int* out4) {
  if (out_kind == 0)
    return static_cast<int>(pyramid ? attrs<true, 0>(out4, out4 + 1, out4 + 2,
                                                     out4 + 3)
                                    : attrs<false, 0>(out4, out4 + 1, out4 + 2,
                                                      out4 + 3));
  if (out_kind == 1)
    return static_cast<int>(pyramid ? attrs<true, 1>(out4, out4 + 1, out4 + 2,
                                                     out4 + 3)
                                    : attrs<false, 1>(out4, out4 + 1, out4 + 2,
                                                      out4 + 3));
  return static_cast<int>(cudaErrorInvalidValue);
}

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
      static_cast<long long>(ncy) * ncx > kMaxCells ||
      (pyramid && lows == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(covered, 0, 1, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long C = static_cast<long long>(ncy) * ncx;
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
