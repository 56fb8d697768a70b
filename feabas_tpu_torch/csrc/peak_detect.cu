// Local-maximum response plane of the thumbnail keypoint detector, for Hopper.
//
// Replaces the peak stage of feabas_tpu/ops/lradon.py:_detect_body (the two
// lax.reduce_window max-pools, the peak test and the masked response that
// lax.top_k reads), which XLA ran as separate passes over the plane:
//     a    = |f|
//     mx   = max of a over the size x size window [i - lo, i + hi] around
//            each pixel, lo = (size - 1) / 2, hi = size / 2 ('SAME' padding
//            of an even window puts the longer side after the pixel), with
//            -inf outside the image
//     resp = (a >= mx && a > 0 && mask > 0) ? a : -inf
// All comparisons are exact, so the result is bit-equal to the plain version
// (ops/lradon.peak_response_plain) in whatever order the maxima are taken.
//
// What bounds it on an H100: 8 bytes of HBM traffic a pixel (f32 in, f32
// out; 4 more with a mask), 10.02 us for the thumbnail path's 2048^2 plane,
// against about 2 * size comparisons a pixel: bytes, as long as the
// comparisons and the shared-memory traffic stay few.
//
// Design (second version; the first, 64 x 32 tiles with a 4-byte load and an
// integer division per window value and size shared-memory reads a pixel and
// pass, ~130 instructions a pixel by a count of its source, took 40.5 us
// there):
//   * A block owns a 64 x 32 output tile (2048 blocks on a 2048^2 plane, two
//     waves of up to 8 resident blocks a SM) and loads its (32 + size - 1) x
//     (64 + size - 1) window of |f| once into shared memory, -inf outside
//     the image, a warp a row: 16-byte loads where the plane's rows are
//     16-byte aligned (width a multiple of 4), else 4-byte loads. The plane
//     fits in L2, so the halo's re-reads cost L2, not HBM, traffic.
//   * The max along x, then along y, takes four adjacent outputs a thread:
//     the four windows share their middle, size - 3 values, whose max is
//     taken once; each window then adds its three edge values (size + 8
//     comparisons and size + 2 reads for four outputs; exact in any order).
//     Windows of 1 to 3 take the plain loop.
//   * The detector's window, 10, is compiled in: its window starts on a
//     16-byte column (lo = 4), so the window loads store 16 bytes at a time
//     and the x pass reads 16 bytes at a time from rows of an odd count of
//     16-byte words (conflict-free for eight lanes down the rows); every loop
//     unrolls. Other windows take the same code with the size at run time,
//     rows of an odd count of words.
//   * The mask is read only where it is given, into registers before the
//     window loads, so that its loads fly meanwhile.
//
// Plain C interface, loaded with ctypes. The entry point launches on the
// given stream, allocates nothing, and returns a cudaError_t (0 = launched).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 64;            // output tile, columns
constexpr int kTileH = 32;            // output tile, rows
constexpr int kMaxSize = 32;          // widest window
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kV = 4;                 // outputs a thread a pass
constexpr int kHld = kTileW + 4;      // row of the x-max: 16-byte words
constexpr int kYItems = kTileW * kTileH / kV / kThreads;   // y items a thread
constexpr int kPathSize = 10;         // the detector's window, compiled in
static_assert(kYItems * kV * kThreads == kTileW * kTileH, "threads tile");

// a row of the window in shared memory. A window known at compile time:
// whole 16-byte words, an odd count of them; else an odd count of floats
__host__ __device__ constexpr int in_ld(int size, bool fixed) {
  return fixed ? ((kTileW + size + 2) / 4 % 2 ? (kTileW + size + 2) / 4 * 4
                                              : (kTileW + size + 2) / 4 * 4 + 4)
               : (kTileW + size - 1) | 1;
}

// floats before the x-max: the window, rounded up to 16 bytes
__host__ __device__ constexpr int hmax_at(int size, bool fixed) {
  return ((kTileH + size - 1) * in_ld(size, fixed) + 3) / 4 * 4;
}

__host__ __device__ constexpr size_t smem_bytes(int size, bool fixed) {
  return sizeof(float) * (static_cast<size_t>(hmax_at(size, fixed)) +
                          static_cast<size_t>(kTileH + size - 1) * kHld);
}

// m[j] = max of p[j .. j + size - 1] (stride st) for j < 4; S > 0 fixes size
template <int S>
__device__ __forceinline__ void window4(const float* p, int st, int size,
                                        float m[kV]) {
  if (S) size = S;
  if (size >= kV) {
    const float a0 = p[0], a1 = p[st], a2 = p[2 * st];
    float core = p[3 * st];
#pragma unroll
    for (int k = kV; k < (S ? S : size); ++k) core = fmaxf(core, p[k * st]);
    const float b0 = p[size * st], b1 = p[(size + 1) * st],
                b2 = p[(size + 2) * st];
    m[0] = fmaxf(fmaxf(core, a0), fmaxf(a1, a2));
    m[1] = fmaxf(fmaxf(core, a1), fmaxf(a2, b0));
    m[2] = fmaxf(fmaxf(core, a2), fmaxf(b0, b1));
    m[3] = fmaxf(fmaxf(core, b0), fmaxf(b1, b2));
  } else {
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      float v = p[j * st];
      for (int k = 1; k < size; ++k) v = fmaxf(v, p[(j + k) * st]);
      m[j] = v;
    }
  }
}

// window4 along a 16-byte aligned row of a window of S >= 4, read 16 bytes
// at a time
template <int S>
__device__ __forceinline__ void window4_row(const float* p, float m[kV]) {
  constexpr int kN = (S + kV - 1 + 3) / 4;
  float v[4 * kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const float4 t = reinterpret_cast<const float4*>(p)[k];
    v[4 * k] = t.x;
    v[4 * k + 1] = t.y;
    v[4 * k + 2] = t.z;
    v[4 * k + 3] = t.w;
  }
  float core = v[3];
#pragma unroll
  for (int k = kV; k < S; ++k) core = fmaxf(core, v[k]);
  m[0] = fmaxf(fmaxf(core, v[0]), fmaxf(v[1], v[2]));
  m[1] = fmaxf(fmaxf(core, v[1]), fmaxf(v[2], v[S]));
  m[2] = fmaxf(fmaxf(core, v[2]), fmaxf(v[S], v[S + 1]));
  m[3] = fmaxf(fmaxf(core, v[S]), fmaxf(v[S + 1], v[S + 2]));
}

// S: the window compiled in (its lo a multiple of 4; rows 16-byte aligned),
// or 0 for a window given at run time. VEC: 16-byte loads of f.
template <int S, bool VEC, bool MASK>
__global__ void __launch_bounds__(kThreads)
peak_kernel(const float* __restrict__ f, const float* __restrict__ mask,
            float* __restrict__ resp, int h, int w, int size_arg) {
  constexpr bool kFixed = S != 0;
  static_assert(!kFixed || (VEC && S >= kV && (S - 1) / 2 % 4 == 0),
                "a compiled window starts on a 16-byte column");
  const int size = kFixed ? S : size_arg;
  extern __shared__ float4 smem4[];
  float* in = reinterpret_cast<float*>(smem4);
  const int ld = in_ld(size, kFixed);
  const int rows = kTileH + size - 1;
  float* hmax = in + hmax_at(size, kFixed);      // rows x kHld
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lo = (size - 1) / 2;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int xs = x0 - lo;                // image column of window column 0
  const int ys = y0 - lo;

  // the mask under this thread's outputs (the y pass's items)
  float mk[kYItems][kV];
  if (MASK) {
#pragma unroll
    for (int k = 0; k < kYItems; ++k) {
      const int i = tid + k * kThreads;
      const int x = x0 + i % kTileW;
      const int yb = y0 + (i / kTileW) * kV;
#pragma unroll
      for (int j = 0; j < kV; ++j)
        mk[k][j] = (x < w && yb + j < h)
                       ? __ldg(mask + (size_t)(yb + j) * w + x) : 0.0f;
    }
  }

  // the window of |f|, -inf outside the image
  if (kFixed) {
    const int nq = (kTileW + size - 1 + 3) / 4;   // xs is 16-byte aligned
    for (int r = warp; r < rows; r += kWarps) {
      const int y = ys + r;
      const bool yin = y >= 0 && y < h;
      for (int q = lane; q < nq; q += 32) {
        const int x = xs + 4 * q;
        float4 v = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
        if (yin && x >= 0 && x < w) {
          v = __ldg(reinterpret_cast<const float4*>(f + (size_t)y * w + x));
          v = make_float4(fabsf(v.x), fabsf(v.y), fabsf(v.z), fabsf(v.w));
        }
        reinterpret_cast<float4*>(in + r * ld)[q] = v;
      }
    }
  } else if (VEC) {
    // 16-byte loads from the aligned column xa <= xs; a word lies wholly
    // inside or outside the image, w being a multiple of 4
    const int xa = xs >= 0 ? xs & ~3 : -((-xs + 3) & ~3);
    const int sh = xs - xa;
    const int nq = (sh + kTileW + size - 1 + 3) / 4;
    for (int r = warp; r < rows; r += kWarps) {
      const int y = ys + r;
      const bool yin = y >= 0 && y < h;
      float* dst = in + r * ld - sh;
      for (int q = lane; q < nq; q += 32) {
        const int x = xa + 4 * q;
        float4 v = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
        if (yin && x >= 0 && x < w) {
          v = __ldg(reinterpret_cast<const float4*>(f + (size_t)y * w + x));
          v = make_float4(fabsf(v.x), fabsf(v.y), fabsf(v.z), fabsf(v.w));
        }
        const int c = 4 * q;
        if (c - sh >= 0 && c - sh < ld) dst[c] = v.x;
        if (c + 1 - sh >= 0 && c + 1 - sh < ld) dst[c + 1] = v.y;
        if (c + 2 - sh >= 0 && c + 2 - sh < ld) dst[c + 2] = v.z;
        if (c + 3 - sh >= 0 && c + 3 - sh < ld) dst[c + 3] = v.w;
      }
    }
  } else {
    const int cols = kTileW + size - 1;
    for (int r = warp; r < rows; r += kWarps) {
      const int y = ys + r;
      const bool yin = y >= 0 && y < h;
      for (int c = lane; c < cols; c += 32) {
        const int x = xs + c;
        float v = -INFINITY;
        if (yin && x >= 0 && x < w) v = fabsf(__ldg(f + (size_t)y * w + x));
        in[r * ld + c] = v;
      }
    }
  }
  __syncthreads();

  // max along x: four adjacent outputs of one row a thread, a warp's
  // threads down the rows
  for (int i = tid; i < rows * (kTileW / kV); i += kThreads) {
    const int r = i % rows;
    const int j = (i / rows) * kV;
    float m[kV];
    if (kFixed)
      window4_row<(kFixed ? S : kV)>(in + r * ld + j, m);
    else
      window4<0>(in + r * ld + j, 1, size, m);
    *reinterpret_cast<float4*>(hmax + r * kHld + j) =
        make_float4(m[0], m[1], m[2], m[3]);
  }
  __syncthreads();

  // max along y: four adjacent outputs of one column a thread, the test
  // and the response
#pragma unroll
  for (int k = 0; k < kYItems; ++k) {
    const int i = tid + k * kThreads;
    const int c = i % kTileW;
    const int r0 = (i / kTileW) * kV;
    const int x = x0 + c;
    if (x >= w) continue;
    float m[kV];
    window4<S>(hmax + r0 * kHld + c, kHld, size, m);
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int y = y0 + r0 + j;
      if (y >= h) break;
      const float v = in[(r0 + j + lo) * ld + c + lo];
      bool peak = (v >= m[j]) && (v > 0.0f);
      if (MASK) peak = peak && (mk[k][j] > 0.0f);
      resp[(size_t)y * w + x] = peak ? v : -INFINITY;
    }
  }
}

template <int S, bool VEC, bool MASK>
cudaError_t launch(const float* f, const float* mask, float* resp, int h,
                   int w, int size, cudaStream_t stream) {
  const size_t bytes = smem_bytes(size, S != 0);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        peak_kernel<S, VEC, MASK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(kMaxSize, false)));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  peak_kernel<S, VEC, MASK><<<grid, kThreads, bytes, stream>>>(
      f, mask, resp, h, w, size);
  return cudaGetLastError();
}

template <int S, bool VEC>
cudaError_t launch_mask(const float* f, const float* mask, float* resp, int h,
                        int w, int size, cudaStream_t stream) {
  return mask ? launch<S, VEC, true>(f, mask, resp, h, w, size, stream)
              : launch<S, VEC, false>(f, mask, resp, h, w, size, stream);
}

}  // namespace

extern "C" int peak_detect_max_size() { return kMaxSize; }

// f, resp: (h, w) f32; mask: (h, w) f32 or null; size: the window's side.
extern "C" int peak_detect_f32(const float* f, const float* mask, float* resp,
                               int h, int w, int size, cudaStream_t stream) {
  if (size < 1 || size > kMaxSize || h < 1 || w < 1)
    return (int)cudaErrorInvalidValue;
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(f) % 16 == 0;
  if (vec && size == kPathSize)
    return (int)launch_mask<kPathSize, true>(f, mask, resp, h, w, size,
                                             stream);
  if (vec)
    return (int)launch_mask<0, true>(f, mask, resp, h, w, size, stream);
  return (int)launch_mask<0, false>(f, mask, resp, h, w, size, stream);
}
