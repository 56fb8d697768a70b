// Difference-of-Gaussians band-pass and separable Gaussian blur for Hopper.
//
// Replaces feabas_tpu/ops/pallas_kernels.py:dog_filter (_dog_kernel :48,
// _blur1d :25), the TPU kernel that holds one whole (H, W) block in VMEM
// and chains two separable blurs:
//     f0 = blur(x), f1 = blur(f0), out = f0 - f1
// Each blur correlates rows, then columns, with the taps of
// ops/dog.gaussian_kernel1d (radius round(4 sigma)), 'nearest' edges
// (coordinates clamped to the image), accumulated in f32 in tap order. A
// uint8 input is widened to f32 on load. The second blur clamps f0, not x.
//
// What bounds it on an H100: about 170 FLOP per pixel at sigma 2.5 (4
// passes x 21 taps, one FMA each, plus the subtraction) against 8 bytes of
// HBM traffic (u8/f32 in, f32 out): the operation and byte bounds are
// close (42 us and 40 us for a (1024, 128, 128) f32 stack), so the design
// keeps both near their minimum:
//   * A unit of work reads its input from HBM once and writes its output
//     once; all four passes run in shared memory. Planes of up to 128x128
//     are held whole (several small planes packed to one unit); larger
//     planes are cut into output tiles of T x T (T = kTile, or the largest
//     below it whose buffers fit a block) whose units load the
//     input over (T + 4r)^2 (DoG) or (T + 2r)^2 (blur) and compute f0 over
//     (T + 2r)^2, so every f0 value a tile's second blur reads -- clamped
//     coordinates included -- is f0 of the image, never f0 of a clamped x.
//   * Every region is clamped to the image, and each pass clamps its window
//     to its source region. That equals clamping to the image for every
//     output kept, so a halo wider than the plane (4r = 56 > 24 at
//     sigma 3.5) needs no special case.
//   * Persistent blocks (as many as fit the SMs) walk the units; with an
//     f32 input the next unit's input is copied with cp.async into a
//     second buffer while the current unit computes.
//   * Register blocking: a thread computes a run of outputs from one
//     window held in registers (kRowRun along a row, kColRun down a
//     column), the runs' sums advancing tap by tap as independent FMA
//     chains, so a tap costs one FMA and a fraction of a shared-memory
//     load. A row pass gives neighbouring lanes neighbouring rows, and
//     shared-memory rows have odd strides, so a warp's window loads fall
//     on distinct banks and its lanes take the same (clamped or unclamped)
//     branch; a column pass gives each lane its own column.
//   * The taps are a kernel parameter (constant bank), never a global
//     array. The kernel is compiled for the radius buckets of dispatch(),
//     up to kMaxRadius = 24 taps on each side; a radius between buckets
//     runs in the next bucket with zero taps at both ends, which add
//     exactly 0 and keep the tap order. A larger radius is refused.
// chip_smoke.py (phase 3) times it against its bound at the paths' shapes.
//
// Plain C interface, loaded with ctypes. Every entry point launches on the
// given stream, allocates nothing, and returns a cudaError_t (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxRadius = 24;
constexpr int kThreads = 512;
constexpr int kRowRun = 13;
constexpr int kColRun = 12;
constexpr int kLoadRun = 8;         // global loads in flight per thread
constexpr int kPackPixels = 8192;   // whole small planes packed per block
constexpr int kMaxSmem = 232448;    // 227 KB, the most a block may use
constexpr int kWholePlanePx = 128 * 128;   // planes held whole
constexpr int kTile = 128;          // output tile side of larger planes
constexpr int kMaxDevices = 64;     // devices whose launch set-up is kept

struct Taps {
  float w[2 * kMaxRadius + 1];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// acc[v] = sum_k w[k] * win[v + k], taps summed in order. The V sums
// advance together, tap by tap, so a thread has V independent FMA chains.
template <int R, int V>
__device__ __forceinline__ void fir(const float (&win)[V + 2 * R],
                                    const Taps& t, float (&acc)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = fmaf(win[v + k], t.w[k], acc[v]);
  }
}

// dst[q][j] = sum_k w[k] * src[q][clamp(dc0 + j + k - R, sc0, sc1 - 1) - sc0]
// for buffer rows q < nrows and j < ncols. src rows hold image columns
// [sc0, sc1) with stride ss, dst rows have stride ds. Packed planes are
// whole, so their rows follow one another and q runs over all of them.
// Work items are (run of V outputs, row), rows fastest; a thread steps
// through them without dividing.
template <int R>
__device__ void row_pass(const float* src, int ss, int sc0, int sc1,
                         float* dst, int ds, int dc0, int nrows, int ncols,
                         const Taps& t) {
  constexpr int V = kRowRun, N = V + 2 * R;
  const int runs = (ncols + V - 1) / V;
  const int drun = blockDim.x / nrows, dq = blockDim.x - drun * nrows;
  int run = threadIdx.x / nrows, q = threadIdx.x - run * nrows;
  for (; run < runs; run += drun, q += dq) {
    if (q >= nrows) {
      q -= nrows;
      if (++run >= runs) break;
    }
    const int j0 = run * V;
    const float* sq = src + q * ss;
    float* d = dst + q * ds;
    const int c = dc0 + j0 - R;         // image column of win[0]
    float win[N];
    if (c >= sc0 && c + N <= sc1) {
      const float* s0 = sq + (c - sc0);
#pragma unroll
      for (int m = 0; m < N; ++m) win[m] = s0[m];
    } else {
#pragma unroll
      for (int m = 0; m < N; ++m) win[m] = sq[clampi(c + m, sc0, sc1 - 1) - sc0];
    }
    float acc[V];
    fir<R, V>(win, t, acc);
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (j0 + v < ncols) d[j0 + v] = acc[v];
  }
}

// Column pass over the same columns, for np tiles of nrows output rows:
//   acc[p][i][j] = sum_k w[k] * src[p][clamp(dr0 + i + k - R, sr0, sr1 - 1) - sr0][j]
// kMode 0 and 1: dst = acc (shared or global memory); kMode 2:
// dst = f0 - acc. src has row stride ss and tile stride src_cap; dst row
// stride ds and tile stride dst_cap; f0 row stride fs and tile stride
// f0_cap. Work items are (tile, run of V rows, column); neighbouring
// lanes take neighbouring columns.
template <int R, int kMode>
__device__ void col_pass(const float* src, int ss, int sr0, int sr1,
                         int src_cap, float* dst, int ds, long long dst_cap,
                         const float* f0, int fs, int f0_cap, int dr0,
                         int np, int nrows, int ncols, const Taps& t) {
  constexpr int V = kColRun, N = V + 2 * R;
  const int runs = (nrows + V - 1) / V;
  const int dq = blockDim.x / ncols, dj = blockDim.x - dq * ncols;
  int q = threadIdx.x / ncols, j = threadIdx.x - q * ncols;
  int p = q / runs, run = q - p * runs;
  for (;;) {
    while (run >= runs) {
      run -= runs;
      ++p;
    }
    if (p >= np) break;
    const int i0 = run * V;
    const float* s = src + p * src_cap + j;
    const int r = dr0 + i0 - R;         // image row of win[0]
    float win[N];
    if (r >= sr0 && r + N <= sr1) {
      const float* s0 = s + (r - sr0) * ss;
#pragma unroll
      for (int m = 0; m < N; ++m) win[m] = s0[m * ss];
    } else {
#pragma unroll
      for (int m = 0; m < N; ++m)
        win[m] = s[(clampi(r + m, sr0, sr1 - 1) - sr0) * ss];
    }
    float acc[V];
    fir<R, V>(win, t, acc);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (i0 + v < nrows) {
        const long long o = p * dst_cap + (long long)(i0 + v) * ds + j;
        if (kMode == 2)
          dst[o] = f0[p * f0_cap + (i0 + v) * fs + j] - acc[v];
        else
          dst[o] = acc[v];
      }
    }
    j += dj;
    run += dq;
    if (j >= ncols) {
      j -= ncols;
      ++run;
    }
  }
}

// One unit of work: ppb whole planes (ppb > 1 only when a tile covers its
// plane), or one output tile of one plane, with its output (o), f0 (f)
// and input (i) regions, each clamped to the image.
struct Unit {
  int plane0, np, oy0, oy1, ox0, ox1, fy0, fy1, fx0, fx1, iy0, iy1, ix0, ix1;
};

struct Geometry {
  int n, h, w, th, tw, tiles_y, tiles_x, ppb, cap0, cap1, units;
};

template <int R, bool kDog>
__device__ Unit unit_at(int u, const Geometry& g) {
  Unit t;
  int ty = 0, tx = 0;
  if (g.ppb > 1 || g.tiles_y * g.tiles_x == 1) {
    t.plane0 = u * g.ppb;
  } else {
    const int per_plane = g.tiles_y * g.tiles_x;
    t.plane0 = u / per_plane;
    const int k = u - t.plane0 * per_plane;
    ty = k / g.tiles_x;
    tx = k - ty * g.tiles_x;
  }
  t.np = min(g.ppb, g.n - t.plane0);
  t.oy0 = ty * g.th;
  t.oy1 = min(g.h, t.oy0 + g.th);
  t.ox0 = tx * g.tw;
  t.ox1 = min(g.w, t.ox0 + g.tw);
  t.fy0 = kDog ? max(0, t.oy0 - R) : t.oy0;
  t.fy1 = kDog ? min(g.h, t.oy1 + R) : t.oy1;
  t.fx0 = kDog ? max(0, t.ox0 - R) : t.ox0;
  t.fx1 = kDog ? min(g.w, t.ox1 + R) : t.ox1;
  t.iy0 = max(0, t.fy0 - R);
  t.iy1 = min(g.h, t.fy1 + R);
  t.ix0 = max(0, t.fx0 - R);
  t.ix1 = min(g.w, t.fx1 + R);
  return t;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// The unit's input region -> dst (f32, rows of odd stride xc | 1). Buffer
// row q (tile p's row i is q = p * xr + i; packed planes are whole, so
// xr = h) is image row q from the region's corner, and region element e
// sits at (q, j) = divmod(e, xc). kAsync: cp.async copies (f32 only) that
// complete at cp_async_wait_all; else loads with kLoadRun in flight per
// thread, widened to f32.
template <bool kAsync, typename T>
__device__ void load_region(const T* x, const Unit& t, const Geometry& g,
                            float* dst) {
  const int xr = t.iy1 - t.iy0, xc = t.ix1 - t.ix0, xs = xc | 1;
  const T* xp = x + t.plane0 * (long long)g.h * g.w +
                (long long)t.iy0 * g.w + t.ix0;
  const int total = t.np * xr * xc;
  const int dq = blockDim.x / xc, dj = blockDim.x - dq * xc;
  int q = threadIdx.x / xc, j = threadIdx.x - q * xc;
  for (int e0 = threadIdx.x; e0 < total; e0 += kLoadRun * blockDim.x) {
    float v[kLoadRun];
    int at[kLoadRun];
#pragma unroll
    for (int u = 0; u < kLoadRun; ++u) {
      if (e0 + u * (int)blockDim.x < total) {
        if constexpr (kAsync)
          cp_async4(dst + q * xs + j, xp + (long long)q * g.w + j);
        else
          v[u] = static_cast<float>(xp[(long long)q * g.w + j]);
        at[u] = q * xs + j;
      }
      j += dj;
      q += dq;
      if (j >= xc) {
        j -= xc;
        ++q;
      }
    }
    if constexpr (!kAsync) {
#pragma unroll
      for (int u = 0; u < kLoadRun; ++u)
        if (e0 + u * (int)blockDim.x < total) dst[at[u]] = v[u];
    }
  }
}

// The passes of one unit: x in xb (overwritten by f0), r1 the row-blurred
// x, then the row-blurred f0; out written once.
template <int R, bool kDog>
__device__ void filter_unit(const Unit& t, const Geometry& g, float* xb,
                            float* r1, float* __restrict__ out,
                            const Taps& taps) {
  const long long hw = (long long)g.h * g.w;
  const int xr = t.iy1 - t.iy0, xc = t.ix1 - t.ix0;
  const int fc = t.fx1 - t.fx0, oc = t.ox1 - t.ox0;
  // odd row strides: lanes on different rows of a pass use other banks
  const int xs = xc | 1, fs = fc | 1, os = oc | 1;
  row_pass<R>(xb, xs, t.ix0, t.ix1, r1, fs, t.fx0, t.np * xr, fc, taps);
  __syncthreads();
  float* op = out + t.plane0 * hw + (long long)t.oy0 * g.w + t.ox0;
  if (!kDog) {
    col_pass<R, 1>(r1, fs, t.iy0, t.iy1, g.cap1, op, g.w, hw, nullptr, 0, 0,
                   t.oy0, t.np, t.oy1 - t.oy0, oc, taps);
    return;
  }
  col_pass<R, 0>(r1, fs, t.iy0, t.iy1, g.cap1, xb, fs, g.cap0, nullptr, 0, 0,
                 t.fy0, t.np, t.fy1 - t.fy0, fc, taps);     // f0 -> xb
  __syncthreads();
  row_pass<R>(xb, fs, t.fx0, t.fx1, r1, os, t.ox0, t.np * (t.fy1 - t.fy0), oc,
              taps);
  __syncthreads();
  col_pass<R, 2>(r1, os, t.fy0, t.fy1, g.cap1, op, g.w, hw,
                 xb + (t.oy0 - t.fy0) * fs + (t.ox0 - t.fx0), fs, g.cap0,
                 t.oy0, t.np, t.oy1 - t.oy0, oc, taps);
}

// Persistent blocks walk the units. With an f32 input the next unit's
// input is copied (cp.async) into a second buffer while this unit
// computes, so the SM's HBM reads overlap its arithmetic; a u8 input is
// loaded between units.
template <int R, typename T, bool kDog>
__global__ void __launch_bounds__(kThreads)
dog_kernel(const T* __restrict__ x, float* __restrict__ out, const Geometry g,
           const Taps taps) {
  constexpr bool kAsync = std::is_same<T, float>::value;
  extern __shared__ float smem[];
  float* xa = smem;
  float* xb = smem + g.ppb * g.cap0;                 // prefetch (f32 only)
  float* r1 = smem + (kAsync ? 2 : 1) * g.ppb * g.cap0;
  int u = blockIdx.x;
  Unit t = unit_at<R, kDog>(u, g);
  load_region<kAsync>(x, t, g, xa);
  if constexpr (kAsync) cp_async_wait_all();
  __syncthreads();
  for (;;) {
    const int next = u + gridDim.x;
    Unit tn;
    if (next < g.units) {
      tn = unit_at<R, kDog>(next, g);
      if constexpr (kAsync) load_region<true>(x, tn, g, xb);
    }
    filter_unit<R, kDog>(t, g, xa, r1, out, taps);
    if (next >= g.units) break;
    __syncthreads();                    // xa and r1 free again
    if constexpr (kAsync) {
      cp_async_wait_all();
      float* sw = xa;
      xa = xb;
      xb = sw;
    } else {
      load_region<false>(x, tn, g, xa);
    }
    __syncthreads();
    u = next;
    t = tn;
  }
}

template <int R, typename T, bool kDog>
cudaError_t launch(const T* x, float* out, const float* taps, int radius,
                   int n, int h, int w, cudaStream_t s) {
  Taps t = {};
  for (int k = 0; k <= 2 * radius; ++k) t.w[R - radius + k] = taps[k];
  const int side = kDog ? 2 * R : R;    // input halo on each side
  constexpr int kX = std::is_same<T, float>::value ? 2 : 1;   // x buffers
  Geometry g;
  g.n = n;
  g.h = h;
  g.w = w;
  long long units, smem;
  if ((long long)h * w <= kWholePlanePx) {         // whole planes
    g.th = h;
    g.tw = w;
    g.tiles_y = g.tiles_x = 1;
    g.cap0 = g.cap1 = h * (w | 1);
    g.ppb = max(1, min(n, kPackPixels / (h * w)));
    units = (n + g.ppb - 1) / g.ppb;
    smem = (long long)g.ppb * (kX * g.cap0 + g.cap1) * sizeof(float);
  } else {
    // the largest tile side <= kTile whose buffers fit a block
    int tile = kTile + 8;
    for (;;) {
      tile -= 8;
      if (tile < 8) return cudaErrorInvalidValue;
      const int xr = min(h, tile + 2 * side), xc = min(w, tile + 2 * side);
      g.cap0 = xr * (xc | 1);
      g.cap1 = xr * (min(w, tile + (kDog ? 2 * R : 0)) | 1);
      smem = (kX * (long long)g.cap0 + g.cap1) * sizeof(float);
      if (smem <= kMaxSmem) break;
    }
    g.th = g.tw = tile;
    g.tiles_y = (h + tile - 1) / tile;
    g.tiles_x = (w + tile - 1) / tile;
    g.ppb = 1;
    units = (long long)n * g.tiles_y * g.tiles_x;
  }
  if (smem > kMaxSmem || units > 0x7fffffffLL) return cudaErrorInvalidValue;
  g.units = static_cast<int>(units);
  auto kernel = dog_kernel<R, T, kDog>;
  // The shared-memory opt-in above 48 KB and the SM count belong to a
  // device: both are set up at this kernel's first launch on each device
  // (sm_of[dev] > 0 once done), not on every launch, where the attribute
  // call adds host time to each call.
  static int sm_of[kMaxDevices] = {};
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && sm_of[dev] > 0) {
    sms = sm_of[dev];
  } else {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) sm_of[dev] = sms;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, static_cast<size_t>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = min(units, (long long)max(per_sm, 1) * sms);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(x, out, g, t);
  return cudaGetLastError();
}

// Radius buckets the kernel is compiled for; the largest is kMaxRadius.
template <typename T, bool kDog>
int dispatch(const T* x, float* out, const float* taps, int radius, int n,
             int h, int w, void* stream) {
  if (radius < 0 || radius > kMaxRadius) return cudaErrorInvalidValue;
  if (n <= 0 || h <= 0 || w <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FEABAS_BUCKET(B) \
  if (radius <= B) return launch<B, T, kDog>(x, out, taps, radius, n, h, w, s);
  FEABAS_BUCKET(3)
  FEABAS_BUCKET(5)
  FEABAS_BUCKET(7)
  FEABAS_BUCKET(10)
  FEABAS_BUCKET(12)
  FEABAS_BUCKET(14)
  FEABAS_BUCKET(16)
  FEABAS_BUCKET(20)
  FEABAS_BUCKET(24)
#undef FEABAS_BUCKET
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// taps: host array of 2 * radius + 1 floats. Planes of up to kWholePlanePx
// pixels are held whole, larger ones run in output tiles of kTile^2.
int dog_filter_max_radius() { return kMaxRadius; }

int dog_filter_f32(const float* x, float* out, const float* taps, int radius,
                   int n, int h, int w, void* stream) {
  return dispatch<float, true>(x, out, taps, radius, n, h, w, stream);
}

int dog_filter_u8(const uint8_t* x, float* out, const float* taps, int radius,
                  int n, int h, int w, void* stream) {
  return dispatch<uint8_t, true>(x, out, taps, radius, n, h, w, stream);
}

int gaussian_blur_f32(const float* x, float* out, const float* taps,
                      int radius, int n, int h, int w, void* stream) {
  return dispatch<float, false>(x, out, taps, radius, n, h, w, stream);
}

}  // extern "C"
