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
// (ops/lradon.peak_response_plain).
//
// What bounds it on an H100: 8 bytes of HBM traffic per pixel (f32 in, f32
// out, 4 more with a mask) against about 2 * size comparisons: bytes, by an
// order of magnitude. The design therefore reads each input pixel from HBM
// once per tile (plus the window's halo) and keeps both max passes in shared
// memory: a block loads a (kTileH + size - 1) x (kTileW + size - 1) window
// of |f| (-inf outside the image), takes the running max along x for every
// loaded row, then along y for the tile's rows, and writes the response.
// The max filter is separable, so a pixel costs 2 * size shared-memory reads.
//
// Plain C interface, loaded with ctypes. The entry point launches on the
// given stream, allocates nothing, and returns a cudaError_t (0 = launched).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kTileW = 64;
constexpr int kTileH = 32;
constexpr int kMaxSize = 32;          // widest window the buffers hold
constexpr int kThreads = 256;
constexpr int kInW = kTileW + kMaxSize - 1;
constexpr int kInH = kTileH + kMaxSize - 1;

__global__ void __launch_bounds__(kThreads)
peak_kernel(const float* __restrict__ f, const float* __restrict__ mask,
            float* __restrict__ resp, int h, int w, int size) {
  __shared__ float in[kInH][kInW + 1];         // |f|, -inf outside the image
  __shared__ float rowmax[kInH][kTileW + 1];   // max along x of each row
  const int lo = (size - 1) / 2;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int inw = kTileW + size - 1;
  const int inh = kTileH + size - 1;
  for (int i = threadIdx.x; i < inh * inw; i += kThreads) {
    const int r = i / inw, c = i - r * inw;
    const int y = y0 - lo + r, x = x0 - lo + c;
    float v = -INFINITY;
    if (y >= 0 && y < h && x >= 0 && x < w) v = fabsf(f[(size_t)y * w + x]);
    in[r][c] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < inh * kTileW; i += kThreads) {
    const int r = i / kTileW, c = i - r * kTileW;
    float m = in[r][c];
    for (int k = 1; k < size; ++k) m = fmaxf(m, in[r][c + k]);
    rowmax[r][c] = m;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
    const int r = i / kTileW, c = i - r * kTileW;
    const int y = y0 + r, x = x0 + c;
    if (y >= h || x >= w) continue;
    float m = rowmax[r][c];
    for (int k = 1; k < size; ++k) m = fmaxf(m, rowmax[r + k][c]);
    const float v = in[r + lo][c + lo];
    bool peak = (v >= m) && (v > 0.0f);
    if (mask != nullptr) peak = peak && (mask[(size_t)y * w + x] > 0.0f);
    resp[(size_t)y * w + x] = peak ? v : -INFINITY;
  }
}

}  // namespace

extern "C" int peak_detect_max_size() { return kMaxSize; }

// f, resp: (h, w) f32; mask: (h, w) f32 or null; size: the window's side.
extern "C" int peak_detect_f32(const float* f, const float* mask, float* resp,
                               int h, int w, int size, cudaStream_t stream) {
  if (size < 1 || size > kMaxSize || h < 1 || w < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  peak_kernel<<<grid, kThreads, 0, stream>>>(f, mask, resp, h, w, size);
  return (int)cudaGetLastError();
}
